"""Carry weights and TT payloads across from numpy.

Both take ``{dot-path: ...}`` dictionaries in the JAX package's path naming
(``models.common._path_str``: NamedTuple fields joined by dots, e.g.
``layers.attn.wq``), so the same numbers can be served by both packages:

  * ``params_from_numpy(flat, cfg, device)`` — ``{path: np.ndarray}`` →
    the port's ``TransformerParams`` in ``cfg.dtype``;
  * ``payload_from_numpy(flat, device)`` — ``{path: {"kind": "tt" |
    "raw", "cores": [np.ndarray, ...] | "raw": np.ndarray, "orig_shape",
    "orig_dtype", "eps"}}`` → a tree of ``CompressedParam`` shaped like the
    params, ready for ``models.common.tt_native_params``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.compression import CompressedParam
from repro_torch.core.tt import TTTensor
from repro_torch.device import torch_dtype
from repro_torch.models.attention import AttnParams
from repro_torch.models.mlp import MLPParams
from repro_torch.models.transformer import LayerParams, TransformerParams


def _assemble(flat: Mapping[str, Any], make: Callable[[Any], Any]):
    """Dense-family params skeleton with ``make(flat[path])`` at each path
    present in ``flat`` (absent optional leaves stay None)."""
    used = set()

    def get(path):
        if path not in flat:
            return None
        used.add(path)
        return make(flat[path])

    layers = LayerParams(
        attn=AttnParams(**{f: get(f"layers.attn.{f}")
                           for f in AttnParams._fields}),
        mlp=MLPParams(**{f: get(f"layers.mlp.{f}")
                         for f in MLPParams._fields}),
        ln1=get("layers.ln1"), ln2=get("layers.ln2"))
    params = TransformerParams(embed=get("embed"), layers=layers,
                               final_norm=get("final_norm"),
                               lm_head=get("lm_head"))
    unknown = sorted(set(flat) - used)
    if unknown:
        raise ValueError(f"paths not in the dense family's params: {unknown}")
    return params


def params_from_numpy(flat: Dict[str, np.ndarray], cfg,
                      device="cpu") -> TransformerParams:
    dt = torch_dtype(cfg.dtype)
    return _assemble(flat, lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device=device, dtype=dt))


def payload_from_numpy(flat: Dict[str, Mapping[str, Any]],
                       device="cpu") -> TransformerParams:
    def make(entry):
        shape = tuple(int(n) for n in entry["orig_shape"])
        odt = torch_dtype(entry["orig_dtype"])
        if entry["kind"] == "raw":
            raw = torch.from_numpy(np.array(
                entry["raw"], dtype=np.float32)).to(device=device, dtype=odt)
            return CompressedParam("raw", None, raw, shape, odt)
        cores = [torch.from_numpy(np.array(c, dtype=np.float32)
                                  ).to(device) for c in entry["cores"]]
        ranks = tuple([1] + [int(c.shape[2]) for c in cores])
        tt = TTTensor(cores=cores, shape=tuple(int(c.shape[1]) for c in cores),
                      ranks=ranks, eps=float(entry.get("eps", 0.0)))
        return CompressedParam("tt", tt, None, shape, odt)

    return _assemble(flat, make)
