"""TT payload checkpoints: the compressed wire format (paper Fig. 1, edge to
cloud) that both packages read and write.

Port of the TT-payload half of the JAX package's ``checkpoint/checkpoint.py``
(``CheckpointManager``, the training state's sharded steps, comes with the
train step: ROADMAP queue 1, item 9).  One directory holds

    tt_manifest.json  — per-leaf kind / shape / dtype / ranks / eps / crop
                        metadata, the model family, the storage format and a
                        sha256 of every array
    tt_payload.npz    — raw leaves and TT cores (float32, or int8 cores with
                        one float32 scale each)
    _COMMITTED        — the commit marker, written last

Leaf names (``layers/attn/wq``) and npz keys (``layers__attn__wq__core0``,
``__raw``, ``__core<k>__scale``) are the reference's letter for letter, and
the checksums hash the same bytes, so a payload written by either package
loads in the other equal bit for bit.  A save goes to ``<dir>.tmp`` and
swaps in through ``<dir>.old``, which a load falls back to: every crash
window leaves one loadable payload.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.core import tt_linear as _ttl
from repro_torch.core.compression import CompressedParam, is_compressed_param
from repro_torch.core.tt import TTTensor
from repro_torch.device import resolve_device, torch_dtype


class CheckpointCorrupt(RuntimeError):
    """A committed checkpoint failed integrity verification (truncated
    archive, bit-flipped array, missing leaf).  The message names the
    offending file or leaf."""


def _sha256(arr: np.ndarray) -> str:
    """Content hash of one array as stored: dtype + shape + raw bytes, so
    a reinterpreted (right bytes, wrong dtype) leaf also fails."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _load_npz(path: str):
    """``np.load`` with a corrupt archive (a truncated or bit-flipped zip
    raises BadZipFile, zlib.error or ValueError inside numpy) raised as
    ``CheckpointCorrupt``."""
    try:
        return np.load(path)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointCorrupt(
            f"{path}: unreadable archive ({type(e).__name__}: {e})") from e


def _get_array(data, key: str, path: str) -> np.ndarray:
    try:
        return data[key]
    except KeyError:
        raise CheckpointCorrupt(f"{path}: missing array {key!r}") from None
    except Exception as e:   # a member's CRC or zlib failure on decompress
        raise CheckpointCorrupt(
            f"{path}: array {key!r} unreadable "
            f"({type(e).__name__}: {e})") from e


def _verify_sums(data, sums: Dict[str, str], path: str) -> None:
    for key in sorted(sums):
        got = _sha256(_get_array(data, key, path))
        if got != sums[key]:
            raise CheckpointCorrupt(
                f"{path}: checksum mismatch for leaf {key!r} "
                f"(expected {sums[key][:12]}…, got {got[:12]}…) — shard is "
                f"truncated or bit-flipped")


def clean_stale_tmp(directory: str) -> List[str]:
    """Remove ``*.tmp`` directories left by saves that crashed before
    their rename.  Returns the paths removed.  Safe on an open checkpoint
    directory as long as no save is in flight."""
    removed = []
    for tmp in glob.glob(os.path.join(directory, "*.tmp")):
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
            removed.append(tmp)
    return removed


def _named(tree) -> List[Tuple[str, Any]]:
    """[(leaf name, leaf)]: keys joined by "/" (``_root`` for a bare leaf),
    the reference's ``_flatten_with_names``; a ``CompressedParam`` is one
    leaf."""
    return [("/".join(keys) or "_root", leaf) for keys, leaf in
            _tree.leaves_with_keys(tree, is_leaf=is_compressed_param)]


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` → ``bfloat16``)."""
    return str(dtype).removeprefix("torch.")


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def save_tt_payload(directory: str, payload, extra: Optional[Dict] = None,
                    family: Optional[str] = None,
                    quant: Optional[str] = None,
                    quant_calib: str = "absmax") -> str:
    """Write a ``TTCompressor`` payload (a params-shaped tree of
    ``CompressedParam`` leaves) to ``directory``; returns it.

    ``family`` (``cfg.family``) goes into the manifest, so a TT-native load
    can refuse a payload of another architecture.  ``quant`` (``"int8"``)
    stores every TT core quantized with one scale (``core/tt_linear.
    quantize_array``, the reference's float32 division and round-half-even
    to the integer grid) beside it as ``<key>__core<k>__scale``;
    ``load_tt_payload`` dequantizes back to the wide core dtype."""
    qdt = None if quant is None else _ttl.quant_dtype(quant)
    arrays: Dict[str, np.ndarray] = {}
    leaves = []
    for name, c in _named(payload):
        if not is_compressed_param(c):
            raise TypeError(f"{name}: not a CompressedParam leaf: {type(c)}")
        key = name.replace("/", "__")
        meta = {
            "name": name,
            "kind": c.kind,
            "orig_shape": list(c.orig_shape),
            "orig_dtype": _dtype_name(c.orig_dtype),
            "crop_dims": list(c.crop_dims) if c.crop_dims else None,
        }
        if c.kind == "tt":
            meta["tt"] = {
                "shape": list(c.tt.shape),
                "ranks": [int(r) for r in c.tt.ranks],
                "eps": float(c.tt.eps),
                "core_dtypes": [_dtype_name(g.dtype) for g in c.tt.cores],
            }
            if qdt is not None:
                meta["tt"]["quant"] = {"dtype": quant, "calib": quant_calib}
                for k, g in enumerate(c.tt.cores):
                    q, s = _ttl.quantize_array(g, dtype=qdt,
                                               calib=quant_calib)
                    arrays[f"{key}__core{k}"] = q.cpu().numpy()
                    arrays[f"{key}__core{k}__scale"] = _np32(s)
            else:
                for k, g in enumerate(c.tt.cores):
                    arrays[f"{key}__core{k}"] = _np32(g)
        else:
            # raw leaves go through float32 (numpy has no bf16 writer)
            arrays[f"{key}__raw"] = _np32(c.raw)
        leaves.append(meta)

    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "tt_payload.npz"), **arrays)
    manifest = {"time": time.time(), "leaves": leaves, "extra": extra or {},
                "family": family, "quant": quant,
                "sha256": {k: _sha256(v) for k, v in arrays.items()}}
    with open(os.path.join(tmp, "tt_manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    # the previous payload is parked at .old, not deleted, until the new one
    # is in place; load_tt_payload falls back to .old
    old = directory + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(directory):
        os.rename(directory, old)
    os.rename(tmp, directory)
    if os.path.exists(old):
        shutil.rmtree(old)
    return directory


def _committed(directory: str) -> str:
    """``directory``, or its ``.old`` swap when an interrupted save left
    only that one committed."""
    if not os.path.exists(os.path.join(directory, "_COMMITTED")):
        old = directory + ".old"        # an interrupted save's swap
        if os.path.exists(os.path.join(old, "_COMMITTED")):
            return old
        raise FileNotFoundError(f"no committed TT payload in {directory}")
    return directory


def read_manifest(directory: str) -> Dict:
    """The manifest of the committed payload in ``directory`` (its family,
    storage format and leaves), no array read."""
    with open(os.path.join(_committed(directory), "tt_manifest.json")) as f:
        return json.load(f)


def load_tt_payload(directory: str, like, verify: bool = True,
                    device=None) -> Tuple[Any, Dict]:
    """Restore a TT payload into the tree structure of ``like`` (the params
    the payload was compressed from, or any tree of the same structure),
    its tensors on ``device`` (None: the CUDA card).  Returns (payload,
    manifest).

    ``verify=True`` checks every array against the manifest's sha256 and
    raises ``CheckpointCorrupt`` naming the bad leaf; a manifest without
    checksums loads unverified.  Leaves resolve by name, so a payload and a
    tree that differ in a name raise ``ValueError``."""
    dev = resolve_device(device)
    directory = _committed(directory)
    manifest = read_manifest(directory)
    npz_path = os.path.join(directory, "tt_payload.npz")
    named = _named(like)
    by_name = {m["name"]: m for m in manifest["leaves"]}
    missing = set(by_name) ^ {n for n, _ in named}

    def tensor(a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    with _load_npz(npz_path) as data:
        if verify and manifest.get("sha256"):
            _verify_sums(data, manifest["sha256"], npz_path)
        if missing:
            raise ValueError(
                f"payload/tree structure mismatch: {sorted(missing)}")
        leaves = {}
        for name, _ in named:
            m = by_name[name]
            key = name.replace("/", "__")
            dtype = torch_dtype(m["orig_dtype"])
            crop = tuple(m["crop_dims"]) if m.get("crop_dims") else None
            if m["kind"] == "tt":
                quant = m["tt"].get("quant")
                cores = []
                for k, cd in enumerate(m["tt"]["core_dtypes"]):
                    arr = _get_array(data, f"{key}__core{k}", npz_path)
                    if quant is not None:
                        # back to the wide dtype: the values sit on the
                        # integer grid, so an absmax requantization at serve
                        # time gives the saved integers and scale again
                        arr = (np.asarray(arr, np.float32) * np.asarray(
                            _get_array(data, f"{key}__core{k}__scale",
                                       npz_path), np.float32))
                    cores.append(tensor(arr, torch_dtype(cd)))
                tt = TTTensor(cores=cores, shape=tuple(m["tt"]["shape"]),
                              ranks=tuple(m["tt"]["ranks"]),
                              eps=m["tt"]["eps"])
                leaves[name] = CompressedParam(
                    "tt", tt, None, tuple(m["orig_shape"]), dtype,
                    crop_dims=crop)
            else:
                raw = tensor(_get_array(data, f"{key}__raw", npz_path),
                             dtype)
                leaves[name] = CompressedParam(
                    "raw", None, raw, tuple(m["orig_shape"]), dtype,
                    crop_dims=crop)
    payload = _tree.map_with_keys(
        lambda keys, _leaf: leaves["/".join(keys) or "_root"], like,
        is_leaf=is_compressed_param)
    return payload, manifest
