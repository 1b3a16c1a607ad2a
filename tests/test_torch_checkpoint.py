"""TT payload checkpoints: the port's ``checkpoint/checkpoint.py`` against
the JAX package's, on reduced qwen1.5-0.5b (dense) and olmoe-1b-7b (MoE)
payloads in float32.

* a payload the reference writes loads in the port equal bit for bit to
  the reference's own load (cores, raw leaves, ranks, eps, shapes, crop
  dims, dtypes), in plain and int8 storage, and the reverse: a payload the
  port compresses and writes loads in the reference equal to the port's;
* the same payload written by either package gives the same manifest
  (leaves, family, storage format, extra) and the same sha256 of every
  array; the int8 cores and scales are the same integers and floats;
* a flipped byte, a rewritten array or a missing array raises the port's
  ``CheckpointCorrupt``; an interrupted save falls back to ``.old``;
  ``clean_stale_tmp`` removes what the reference's removes;
* ``serve --save-tt-checkpoint`` then ``--tt-checkpoint`` serves the same
  tokens without compressing, and a payload of another family is refused.

The reference compresses with its library SVD: its default two-phase HBD
keeps a full M×M U_B, 34 GB for a reduced expert bank (ROADMAP queue 3,
item 1).  The port compresses with its own default policy.
"""

import json
import os
import shutil
import struct
import zipfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.core import compression as jax_comp
from repro.core import tt_linear as jax_ttl
from repro.models.registry import build as jax_build
from repro_torch import tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression as comp
from repro_torch.core import tt_linear as ttl
from repro_torch.launch import serve as serve_mod

from _torch_port import f32_cfg, flat_numpy, no_tf32

ARCHS = ["qwen1.5-0.5b", "olmoe-1b-7b"]
QUANTS = [None, "int8"]
EPS = 0.2


@pytest.fixture(scope="module", params=ARCHS)
def case(request, tmp_path_factory):
    """The reference's decayed params and payload, the port's copy of the
    params and its own payload of them, and a scratch directory."""
    no_tf32()
    arch = request.param
    jcfg = f32_cfg(jax_get_config(arch))
    jparams = jax_ttl.spectral_decay_pytree(
        jax_build(jcfg).init(jax.random.PRNGKey(0)), alpha=1.0)
    jpay, _ = jax_comp.TTCompressor(jax_comp.CompressionPolicy(
        svd_method="library", eps=EPS, min_size=8192, plan="serial")
    ).compress(jparams)
    cfg = f32_cfg(get_config(arch))
    pparams = params_from_numpy(flat_numpy(jparams), cfg)
    ppay, _ = comp.TTCompressor(comp.CompressionPolicy(
        eps=EPS, min_size=8192)).compress(pparams)
    return {"family": cfg.family, "jparams": jparams, "jpay": jpay,
            "pparams": pparams, "ppay": ppay,
            "dir": tmp_path_factory.mktemp(arch)}


def _jax_leaves(payload) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        payload, is_leaf=lambda x: isinstance(x, jax_comp.CompressedParam))
    return {"/".join(jax_ckpt._key_str(k) for k in path): c
            for path, c in flat}


def _port_leaves(payload) -> dict:
    return {"/".join(keys): c for keys, c in tree.leaves_with_keys(
        payload, is_leaf=comp.is_compressed_param)}


def _bits(a) -> np.ndarray:
    """The stored bits of one array (bf16 compared through its 16 bits)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def _assert_same(port, ref):
    """Two loaded payloads, one per package, equal leaf for leaf."""
    p, r = _port_leaves(port), _jax_leaves(ref)
    assert sorted(p) == sorted(r)
    for name, c in p.items():
        j = r[name]
        assert c.kind == j.kind and tuple(c.orig_shape) == tuple(
            j.orig_shape), name
        assert str(c.orig_dtype).removeprefix("torch.") == np.dtype(
            j.orig_dtype).name, name
        assert (c.crop_dims or None) == (tuple(j.crop_dims) if j.crop_dims
                                         else None), name
        if c.kind == "tt":
            assert tuple(c.tt.ranks) == tuple(j.tt.ranks), name
            assert tuple(c.tt.shape) == tuple(j.tt.shape), name
            assert c.tt.eps == j.tt.eps, name
            assert len(c.tt.cores) == len(j.tt.cores), name
            for g, jg in zip(c.tt.cores, j.tt.cores):
                np.testing.assert_array_equal(_bits(g), _bits(jg))
        else:
            np.testing.assert_array_equal(_bits(c.raw), _bits(j.raw))


def _manifest(d) -> dict:
    with open(os.path.join(d, "tt_manifest.json")) as f:
        return json.load(f)


def _arrays(d) -> dict:
    with np.load(os.path.join(d, "tt_payload.npz")) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("quant", QUANTS, ids=["plain", "int8"])
def test_jax_payload_loads_in_port(case, quant):
    d = str(case["dir"] / f"jax-{quant}")
    jax_ckpt.save_tt_payload(d, case["jpay"], family=case["family"],
                             quant=quant)
    got, manifest = ckpt.load_tt_payload(d, like=case["pparams"],
                                         device="cpu")
    ref, jman = jax_ckpt.load_tt_payload(d, like=case["jparams"])
    assert manifest == jman
    _assert_same(got, ref)
    if quant is None:      # plain storage: the reference's payload itself
        _assert_same(got, case["jpay"])


@pytest.mark.parametrize("quant", QUANTS, ids=["plain", "int8"])
def test_port_payload_loads_in_jax(case, quant):
    assert any(c.kind == "tt" for c in _port_leaves(case["ppay"]).values())
    d = str(case["dir"] / f"port-{quant}")
    ckpt.save_tt_payload(d, case["ppay"], family=case["family"],
                         quant=quant)
    ref, jman = jax_ckpt.load_tt_payload(d, like=case["jparams"])
    got, manifest = ckpt.load_tt_payload(d, like=case["pparams"],
                                         device="cpu")
    assert manifest == jman and jman["family"] == case["family"]
    _assert_same(got, ref)
    if quant is None:
        _assert_same(case["ppay"], ref)


def _port_copy(case):
    """The reference's payload as the port loads it from a plain save."""
    d = str(case["dir"] / "jax-wide")
    if not os.path.exists(d):
        jax_ckpt.save_tt_payload(d, case["jpay"], family=case["family"])
    return ckpt.load_tt_payload(d, like=case["pparams"], device="cpu")[0]


@pytest.mark.parametrize("quant", QUANTS, ids=["plain", "int8"])
def test_both_packages_write_the_same_manifest(case, quant):
    """One payload written by the reference and by the port: manifests (bar
    the save time) and arrays equal; in int8 storage both packages
    quantize the same wide cores to the same integers and scales."""
    a, b = (str(case["dir"] / f"{side}-same-{quant}")
            for side in ("jax", "port"))
    extra = {"eps": EPS, "arch": case["family"]}
    jax_ckpt.save_tt_payload(a, case["jpay"], extra=extra,
                             family=case["family"], quant=quant)
    ckpt.save_tt_payload(b, _port_copy(case), extra=extra,
                         family=case["family"], quant=quant)
    ma, mb = _manifest(a), _manifest(b)
    assert set(ma) == set(mb) == {"time", "leaves", "extra", "family",
                                  "quant", "sha256"}
    for key in ("leaves", "extra", "family", "quant", "sha256"):
        assert ma[key] == mb[key], key
    xa, xb = _arrays(a), _arrays(b)
    assert list(xa) == list(xb) and set(xa) == set(ma["sha256"])
    for k in xa:
        assert xa[k].dtype == xb[k].dtype and xa[k].shape == xb[k].shape, k
        np.testing.assert_array_equal(xa[k], xb[k])
        assert ckpt._sha256(xb[k]) == jax_ckpt._sha256(xa[k])
    if quant is not None:
        assert any(v.dtype == np.int8 for v in xb.values())


def test_quantize_array_matches_jax():
    """The int8 storage's quantization: float32 division by the absmax
    scale, then round-half-even, bit for bit, also on values that land
    exactly halfway between two integers."""
    rng = np.random.default_rng(0)
    halves = (np.arange(-254, 255) / 2.0).astype(np.float32)   # amax 127
    for a in (rng.standard_normal((7, 33, 5)).astype(np.float32), halves,
              np.zeros((4, 4), np.float32)):
        q, s = ttl.quantize_array(torch.from_numpy(a))
        jq, js = jax_ttl.quantize_array(jax.numpy.asarray(a))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert s.shape == np.asarray(js).shape == ()


def _saved(case, name) -> str:
    d = str(case["dir"] / name)
    ckpt.save_tt_payload(d, case["ppay"], family=case["family"])
    return d


def _rewrite(d, fn):
    """Rewrite the archive's arrays with ``fn(arrays)`` (manifest kept)."""
    arrays = _arrays(d)
    fn(arrays)
    np.savez(os.path.join(d, "tt_payload.npz"), **arrays)


def _flip_byte(d):
    """Flip one byte in the middle of the first core's stored data."""
    path = os.path.join(d, "tt_payload.npz")
    with zipfile.ZipFile(path) as z:
        info = next(i for i in z.infolist() if "__core0" in i.filename)
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)       # the local header's lengths
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        pos = (info.header_offset + 30 + name_len + extra_len
               + info.file_size // 2)
        f.seek(pos)
        byte = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([byte ^ 0x10]))


def _change_value(arrays):
    k = next(k for k in arrays if "__core" in k)
    arrays[k] = arrays[k].copy()
    arrays[k].flat[3] += 1.0


def _drop_array(arrays):
    del arrays[next(k for k in arrays if "__raw" in k)]


@pytest.mark.parametrize("damage,match", [
    (_flip_byte, "unreadable|checksum"),
    (lambda d: _rewrite(d, _change_value), "checksum mismatch"),
    (lambda d: _rewrite(d, _drop_array), "missing array"),
], ids=["flipped-byte", "changed-value", "missing-array"])
def test_damaged_payload_raises(case, damage, match):
    d = _saved(case, f"damaged-{match[:7]}")
    damage(d)
    with pytest.raises(ckpt.CheckpointCorrupt, match=match):
        ckpt.load_tt_payload(d, like=case["pparams"], device="cpu")
    # the reference refuses the same archive
    with pytest.raises(jax_ckpt.CheckpointCorrupt):
        jax_ckpt.load_tt_payload(d, like=case["jparams"])


def test_old_fallback_and_stale_tmp(case, tmp_path):
    """A save interrupted between its two renames leaves only ``.old``
    committed: both packages load it.  ``clean_stale_tmp`` removes the
    ``*.tmp`` directories, and only those, as the reference's does."""
    d = _saved(case, "fallback")
    os.rename(d, d + ".old")
    got, _ = ckpt.load_tt_payload(d, like=case["pparams"], device="cpu")
    ref, _ = jax_ckpt.load_tt_payload(d, like=case["jparams"])
    _assert_same(got, ref)
    shutil.rmtree(d + ".old")
    with pytest.raises(FileNotFoundError, match="no committed"):
        ckpt.load_tt_payload(d, like=case["pparams"], device="cpu")

    removed = {}
    for side, clean in (("port", ckpt.clean_stale_tmp),
                        ("jax", jax_ckpt.clean_stale_tmp)):
        root = tmp_path / side
        for name in ("step_1.tmp", "payload.tmp", "step_2", "keep.tmpx"):
            (root / name).mkdir(parents=True)
        (root / "file.tmp").write_text("not a directory")
        removed[side] = sorted(os.path.basename(p)
                               for p in clean(str(root)))
        assert sorted(os.listdir(root)) == ["file.tmp", "keep.tmpx",
                                            "step_2"]
    assert removed["port"] == removed["jax"] == ["payload.tmp",
                                                 "step_1.tmp"]


def test_load_checks_the_tree(case):
    d = _saved(case, "structure")
    other = ("olmoe-1b-7b" if case["family"] == "dense" else "qwen1.5-0.5b")
    like = params_from_numpy(flat_numpy(jax_build(f32_cfg(jax_get_config(
        other))).init(jax.random.PRNGKey(0))), f32_cfg(get_config(other)))
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load_tt_payload(d, like=like, device="cpu")
    with pytest.raises(TypeError, match="not a CompressedParam"):
        ckpt.save_tt_payload(d, case["pparams"])


SERVE = ["--arch", "qwen1.5-0.5b", "--reduced", "--batch", "2",
         "--prompt-len", "5", "--gen", "4", "--device", "cpu"]


def test_serve_round_trip_through_a_checkpoint(tmp_path, capsys):
    """``--save-tt-checkpoint`` after the compression, then
    ``--tt-checkpoint``: no compression, the same ranks and tokens; the
    int8 run quantizes the loaded wide cores as it would its own."""
    d = str(tmp_path / "qwen")
    saved = serve_mod.serve(serve_mod.parse_args(
        SERVE + ["--weights", "tt", "--save-tt-checkpoint", d]))
    assert "TT payload saved to" in capsys.readouterr().out
    loaded = serve_mod.serve(serve_mod.parse_args(
        SERVE + ["--weights", "tt", "--tt-checkpoint", d]))
    out = capsys.readouterr().out
    assert "loaded from" in out and "compressed on" not in out
    assert loaded["info"]["compress_s"] is None
    assert loaded["info"]["ranks"] == saved["info"]["ranks"]
    assert loaded["info"]["payload_ratio"] == saved["info"]["payload_ratio"]
    np.testing.assert_array_equal(loaded["generated"], saved["generated"])
    torch.testing.assert_close(loaded["run"]["prompt_logits"],
                               saved["run"]["prompt_logits"], rtol=0, atol=0)
    int8 = serve_mod.serve(serve_mod.parse_args(
        SERVE + ["--weights", "tt-int8", "--tt-checkpoint", d]))
    memory = serve_mod.serve(serve_mod.parse_args(SERVE + [
        "--weights", "tt-int8"]), compressed=saved["info"]["compressed"])
    np.testing.assert_array_equal(int8["generated"], memory["generated"])


def test_serve_refuses_another_family(tmp_path):
    """A payload whose manifest names another family is refused, as the
    reference's serve refuses it (the family is not checksummed: the
    manifest is edited)."""
    d = str(tmp_path / "qwen")
    serve_mod.serve(serve_mod.parse_args(
        SERVE + ["--weights", "tt", "--no-verify", "--gen", "2",
                 "--save-tt-checkpoint", d]))
    manifest = _manifest(d)
    manifest["family"] = "moe"
    with open(os.path.join(d, "tt_manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="cannot serve arch family"):
        serve_mod.serve(serve_mod.parse_args(
            SERVE + ["--weights", "tt", "--tt-checkpoint", d]))
