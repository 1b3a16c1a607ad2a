"""Carry weights and TT payloads across from numpy.

Both take ``{dot-path: ...}`` dictionaries in the JAX package's path naming
(``models.common._path_str``: NamedTuple fields joined by dots, e.g.
``layers.attn.wq``), so the same numbers can be served by both packages:

  * ``params_from_numpy(flat, cfg, device)`` — ``{path: np.ndarray}`` →
    the port's params of ``cfg.family`` (``TransformerParams`` for the
    dense and MoE families, ``MambaParams``, ``GriffinParams``,
    ``EncDecParams``) in ``cfg.dtype`` (Λ and the SSM's ``a_log``,
    ``d_skip`` and ``dt_bias`` stay float32, as the reference keeps
    them); a layer's FFN subtree must be the one its config has (``mlp``, or ``moe`` when ``cfg.moe`` is set);
  * ``payload_from_numpy(flat, device)`` — ``{path: {"kind": "tt" |
    "raw", "cores": [np.ndarray, ...] | "raw": np.ndarray, "orig_shape",
    "orig_dtype", "eps"}}`` → a tree of ``CompressedParam`` shaped like the
    params (the family read off the top-level names), ready for
    ``models.common.tt_native_params``.

Optional subtrees (the hybrid ``tail``, an untied ``lm_head``, the FFN
kind a layer does not have) are ``None`` when ``flat`` has none of their
paths.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.compression import CompressedParam
from repro_torch.core.tt import TTTensor
from repro_torch.device import torch_dtype
from repro_torch import tree as _tree
from repro_torch.models.attention import AttnParams
from repro_torch.models.encdec import (
    DecLayerParams, EncDecParams, EncLayerParams,
)
from repro_torch.models.mamba2 import MambaLayerParams, MambaParams
from repro_torch.models.mlp import MLPParams, MoEParams
from repro_torch.models.rglru import (
    AttnLayerParams, GriffinParams, RGLRULayerParams, TripleParams,
)
from repro_torch.models.transformer import LayerParams, TransformerParams

# the NamedTuple of each subtree field: every other field is a leaf
_SUBTREES = {
    TransformerParams: {"layers": LayerParams},
    MambaParams: {"layers": MambaLayerParams},
    LayerParams: {"attn": AttnParams, "mlp": MLPParams, "moe": MoEParams},
    GriffinParams: {"triples": TripleParams, "tail": RGLRULayerParams},
    TripleParams: {"r1": RGLRULayerParams, "r2": RGLRULayerParams,
                   "at": AttnLayerParams},
    RGLRULayerParams: {"mlp": MLPParams},
    AttnLayerParams: {"attn": AttnParams, "mlp": MLPParams},
    EncDecParams: {"enc_layers": EncLayerParams,
                   "dec_layers": DecLayerParams},
    EncLayerParams: {"attn": AttnParams, "mlp": MLPParams},
    DecLayerParams: {"self_attn": AttnParams, "cross_attn": AttnParams,
                     "mlp": MLPParams},
}
_ROOTS = {"dense": TransformerParams, "moe": TransformerParams,
          "ssm": MambaParams, "hybrid": GriffinParams, "encdec": EncDecParams}
# float32 whatever the model's dtype
_F32_LEAVES = ("lam", "a_log", "d_skip", "dt_bias")


def _fits(cls, names) -> bool:
    """Whether a dot path (split into ``names``) ends at a leaf field of
    ``cls``'s skeleton."""
    head, rest = names[0], names[1:]
    if head not in cls._fields:
        return False
    kid = _SUBTREES.get(cls, {}).get(head)
    if kid is None:
        return not rest
    return bool(rest) and _fits(kid, rest)


def _root_of(flat: Mapping[str, Any]):
    """The params type whose skeleton holds every path of ``flat`` (the
    dense and SSM roots share their top-level names; their layers do
    not)."""
    for root in _ROOTS.values():
        if all(_fits(root, path.split(".")) for path in flat):
            return root
    top = sorted({path.split(".")[0] for path in flat})
    raise ValueError(f"paths under {top} fit no ported family")


def _assemble(flat: Mapping[str, Any], make: Callable[[str, Any], Any],
              root):
    """``root``'s skeleton with ``make(path, flat[path])`` at each path
    present in ``flat``; a subtree with none of its paths is None."""
    used = set()

    def node(cls, prefix):
        kids = _SUBTREES.get(cls, {})
        vals = {}
        for f in cls._fields:
            path = prefix + f
            if f in kids:
                sub = node(kids[f], path + ".")
                vals[f] = sub if _tree.leaves(sub) else None
            elif path in flat:
                used.add(path)
                vals[f] = make(path, flat[path])
            else:
                vals[f] = None
        return cls(**vals)

    params = node(root, "")
    unknown = sorted(set(flat) - used)
    if unknown:
        raise ValueError(f"paths not in {root.__name__}: {unknown}")
    return params


def params_from_numpy(flat: Dict[str, np.ndarray], cfg, device="cpu"):
    dt = torch_dtype(cfg.dtype)
    if cfg.family in ("dense", "moe"):
        absent = "layers.mlp." if cfg.moe else "layers.moe."
        foreign = sorted(p for p in flat if p.startswith(absent))
        if foreign:
            raise ValueError(f"paths not in a {cfg.family} model: {foreign}")

    def make(path, a):
        leaf_dt = (torch.float32 if path.split(".")[-1] in _F32_LEAVES
                   else dt)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=leaf_dt)

    return _assemble(flat, make, _ROOTS[cfg.family])


def payload_from_numpy(flat: Dict[str, Mapping[str, Any]], device="cpu"):
    def make(_path, entry):
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

    return _assemble(flat, make, _root_of(flat))
