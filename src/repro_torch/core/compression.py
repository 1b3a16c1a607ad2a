"""TTCompressor — compress a parameter tree into TT format and back.

Port of the JAX package's ``core/compression.py`` for its documented serial
plan: every parameter goes through ``compress_param`` in turn.

Policy (as the reference):
  * params with fewer than ``min_size`` elements are sent raw;
  * params with fewer than ``min_dims`` axes are re-tensorized with
    balanced factors (``tensorize_dims``); others keep their own axes;
  * a parameter stays in TT form only if it compresses (fewer TT params
    than dense elements), otherwise it is sent raw.

The batched planner (``plan="batched"``, the reference's default) is not
ported yet: asking for it raises (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.core import tt as _tt


@dataclass
class CompressionPolicy:
    eps: float = 0.05
    min_size: int = 4096            # below this, send raw
    max_factor: int = 64            # balanced tensorization factor cap
    min_dims: int = 3               # tensorize to at least this many dims
    max_rank: Optional[int] = None
    svd_method: str = "two_phase"
    hbd_impl: str = "unblocked"
    plan: str = "batched"           # "batched" | "serial" execution plan


@dataclass
class CompressedParam:
    kind: str                        # "tt" | "raw"
    tt: Optional[_tt.TTTensor]
    raw: Optional[torch.Tensor]
    orig_shape: Tuple[int, ...]
    orig_dtype: torch.dtype

    @property
    def payload_params(self) -> int:
        if self.kind == "tt":
            return self.tt.num_params
        return int(np.prod(self.orig_shape))


@dataclass
class CompressionReport:
    total_params: int
    payload_params: int
    per_param: Dict[str, Tuple[str, int, int]] = field(default_factory=dict)

    @property
    def ratio(self) -> float:
        return self.total_params / max(self.payload_params, 1)


def tensorize_dims(shape: Tuple[int, ...], policy) -> List[int]:
    """Policy dim selection (the reference's ``plan.tensorize_dims``)."""
    if len(shape) >= policy.min_dims:
        return list(shape)
    dims = _tt.tensorize_shape(shape, policy.max_factor)
    if len(dims) < policy.min_dims:
        dims = _tt.tensorize_shape(shape, max(8, policy.max_factor // 8))
    return dims


def is_compressed_param(x) -> bool:
    return isinstance(x, CompressedParam)


def compress_param(x: torch.Tensor, policy: CompressionPolicy
                   ) -> CompressedParam:
    shape = tuple(x.shape)
    size = int(np.prod(shape))
    if size < policy.min_size or min(shape or (1,)) == 0:
        return CompressedParam("raw", None, x, shape, x.dtype)
    dims = tensorize_dims(shape, policy)
    if len(dims) < 2:
        return CompressedParam("raw", None, x, shape, x.dtype)
    tt = _tt.ttd(x, eps=policy.eps, dims=dims, svd_method=policy.svd_method,
                 hbd_impl=policy.hbd_impl, max_rank=policy.max_rank)
    if tt.num_params >= size:                     # reject non-compressions
        return CompressedParam("raw", None, x, shape, x.dtype)
    return CompressedParam("tt", tt, None, shape, x.dtype)


def decompress_param(c: CompressedParam) -> torch.Tensor:
    if c.kind == "raw":
        return c.raw
    return _tt.tt_reconstruct(c.tt).reshape(c.orig_shape).to(c.orig_dtype)


class TTCompressor:
    """Compress/decompress trees of parameters (tensors on any device; the
    decomposition runs where each tensor lives)."""

    def __init__(self, policy: Optional[CompressionPolicy] = None):
        self.policy = policy or CompressionPolicy()

    def compress(self, params, plan: Optional[str] = None
                 ) -> Tuple[Any, CompressionReport]:
        mode = plan or self.policy.plan
        if mode == "batched":
            raise NotImplementedError(
                "plan='batched' (the bucketed planner and executor) is not "
                "ported yet (ROADMAP queue 1, item 5); use plan='serial'")
        if mode != "serial":
            raise ValueError(f"unknown compression plan: {mode!r}")
        report = CompressionReport(total_params=0, payload_params=0)

        def one(path, leaf):
            c = compress_param(torch.as_tensor(leaf), self.policy)
            size = int(np.prod(c.orig_shape))
            report.total_params += size
            report.payload_params += c.payload_params
            report.per_param[path] = (c.kind, size, c.payload_params)
            return c

        return _tree.map_with_path(one, params), report

    def decompress(self, compressed) -> Any:
        return _tree.map_leaves(decompress_param, compressed,
                                is_leaf=is_compressed_param)
