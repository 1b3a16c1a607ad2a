"""TTCompressor — compress a parameter tree into TT format and back.

Port of the JAX package's ``core/compression.py``.

Policy (as the reference):
  * params with fewer than ``min_size`` elements are sent raw;
  * params with fewer than ``min_dims`` axes are re-tensorized with
    balanced factors (``plan.tensorize_dims``); others keep their own axes;
  * a parameter stays in TT form only if it compresses (fewer TT params
    than dense elements), otherwise it is sent raw.

Execution plans: ``plan="batched"`` (the default) buckets the parameters by
(padded) tensorized shape (``core/plan.py``) and decomposes each bucket in
one batched pass (``core/batch_exec.py``); buckets whose padded work is too
large run the serial loop.  ``plan="serial"`` is the per-parameter loop,
kept as the equivalence oracle: same ε guarantee and, for exact-shape bucket
members, the same accept/reject decision and live ranks.  Padded members
(shapes merged into a larger bucket under ``pad_tolerance``) carry the
padded mode dims, so their payload can be up to ``pad_tolerance`` larger
than serial; ``crop_dims`` records the dims their reconstruction is cropped
back to.  ``pad_tolerance=0`` disables padding merges.

``hbd_impl="blocked"`` is the TT-Edge policy: phase 1 of every SVD runs as
a blocked QR on the TTD-engine kernels (``core/blocked.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.core import batch_exec as _exec
from repro_torch.core import plan as _plan
from repro_torch.core import tt as _tt
from repro_torch.core.plan import tensorize_dims


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
    pad_tolerance: float = 0.25     # max element overhead to join a bucket
    serial_cutoff_elems: int = 1 << 24   # padded-work bound for batching


@dataclass
class CompressedParam:
    kind: str                        # "tt" | "raw"
    tt: Optional[_tt.TTTensor]
    raw: Optional[torch.Tensor]
    orig_shape: Tuple[int, ...]
    orig_dtype: torch.dtype
    # set when the param was zero-padded into a larger bucket: the pre-pad
    # tensorized dims the reconstruction is cropped back to
    crop_dims: Optional[Tuple[int, ...]] = None

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
    plan_fingerprint: Optional[str] = None
    exec_stats: Optional[_exec.ExecStats] = None

    @property
    def ratio(self) -> float:
        return self.total_params / max(self.payload_params, 1)


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
    w = _tt.tt_reconstruct(c.tt)
    if c.crop_dims is not None and tuple(c.crop_dims) != tuple(c.tt.shape):
        w = w[tuple(slice(0, d) for d in c.crop_dims)]
    return w.reshape(c.orig_shape).to(c.orig_dtype)


def _account(report: CompressionReport, path: str, c: CompressedParam):
    size = int(np.prod(c.orig_shape))
    report.total_params += size
    report.payload_params += c.payload_params
    report.per_param[path] = (c.kind, size, c.payload_params)


def payload_report(payload) -> CompressionReport:
    """The totals and per-param entries of an existing payload (one loaded
    from a checkpoint: no plan fingerprint or executor statistics)."""
    report = CompressionReport(total_params=0, payload_params=0)
    for path, c in _tree.leaves_with_paths(payload,
                                           is_leaf=is_compressed_param):
        _account(report, path, c)
    return report


class TTCompressor:
    """Compress/decompress trees of parameters (tensors on any device; the
    decomposition runs where each tensor lives)."""

    def __init__(self, policy: Optional[CompressionPolicy] = None):
        self.policy = policy or CompressionPolicy()

    def compress(self, params, plan: Optional[str] = None
                 ) -> Tuple[Any, CompressionReport]:
        mode = plan or self.policy.plan
        if mode == "serial":
            return self._compress_serial(params)
        if mode != "batched":
            raise ValueError(f"unknown compression plan: {mode!r}")
        return self._compress_batched(params)

    # ---- the per-param loop: the equivalence oracle ----
    def _compress_serial(self, params) -> Tuple[Any, CompressionReport]:
        report = CompressionReport(total_params=0, payload_params=0)

        def one(path, leaf):
            c = compress_param(torch.as_tensor(leaf), self.policy)
            _account(report, path, c)
            return c

        return _tree.map_with_path(one, params), report

    # ---- the batched planner/executor path ----
    def _compress_batched(self, params) -> Tuple[Any, CompressionReport]:
        flat = _tree.leaves_with_paths(params)
        leaves = [torch.as_tensor(leaf) for _, leaf in flat]
        cplan = _plan.build_plan(
            params, self.policy, pad_tolerance=self.policy.pad_tolerance,
            serial_cutoff_elems=self.policy.serial_cutoff_elems)
        executor = _exec.BucketExecutor()
        results = executor.run(cplan, leaves, self.policy)

        out: List[CompressedParam] = [None] * len(leaves)
        for e in cplan.raw:
            x = leaves[e.index]
            out[e.index] = CompressedParam("raw", None, x, e.shape, x.dtype)
        for idx, (tt, pre_pad_dims) in results.items():
            x = leaves[idx]
            shape = tuple(x.shape)
            if tt.num_params >= int(np.prod(shape)):   # reject non-compressions
                out[idx] = CompressedParam("raw", None, x, shape, x.dtype)
            else:
                crop = (tuple(pre_pad_dims)
                        if tuple(pre_pad_dims) != tuple(tt.shape) else None)
                out[idx] = CompressedParam("tt", tt, None, shape, x.dtype,
                                           crop_dims=crop)

        report = CompressionReport(total_params=0, payload_params=0,
                                   plan_fingerprint=cplan.fingerprint,
                                   exec_stats=executor.stats)
        for (path, _), c in zip(flat, out):
            _account(report, path, c)
        by_path = {path: c for (path, _), c in zip(flat, out)}
        return _tree.map_with_path(lambda path, _: by_path[path],
                                   params), report

    def decompress(self, compressed) -> Any:
        return _tree.map_leaves(decompress_param, compressed,
                                is_leaf=is_compressed_param)
