"""Batched-compression planning: parameter tree → shape buckets → launch plan.

The port of the JAX package's ``core/plan.py``.  The planner walks the
parameter tree, applies the policy's raw/TT routing, and groups every
TT-bound parameter into a :class:`Bucket` keyed by its (padded) tensorized
shape, so the executor (``core/batch_exec.py``) can decompose each bucket in
one batched pass instead of ``len(bucket)`` serial ones.

Planning is a pure function of the tree's (paths, shapes) and the policy:
two calls on the same inputs give identical plans (``fingerprint``).  Paths
are the port's dot paths (``repro_torch.tree``) and indices its flatten
order, which for NamedTuples and dicts is the JAX package's order.

Bucketing with padding: two parameters share a bucket when their tensorized
dims are equal, or when the smaller can be zero-padded up to the larger's
dims at a bounded element overhead (``pad_tolerance``).  Padding leaves
‖W‖_F unchanged, so the padded decomposition keeps the ε guarantee, and
cropping the reconstruction back can only shrink the error.

Scheduling: buckets whose padded unfolding work (theoretical max ranks)
would dwarf the serial dynamic-rank path are scheduled ``serial``.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import tree as _tree
from repro_torch.core import tt as _tt


@dataclass(frozen=True)
class PlanEntry:
    """One parameter's routing decision."""

    name: str                        # dot path in the tree
    index: int                       # position in flatten order
    shape: Tuple[int, ...]           # original parameter shape
    dims: Tuple[int, ...]            # tensorized dims (pre-padding)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclass(frozen=True)
class Bucket:
    """A group of same-(padded)-shape TT targets = one batched launch."""

    dims: Tuple[int, ...]            # target dims every member pads up to
    members: Tuple[PlanEntry, ...]   # sorted by name — deterministic order
    execution: str                   # "batched" | "serial"

    @property
    def batch(self) -> int:
        return len(self.members)

    @property
    def padded_size(self) -> int:
        return math.prod(self.dims)


@dataclass(frozen=True)
class CompressionPlan:
    buckets: Tuple[Bucket, ...]
    raw: Tuple[PlanEntry, ...]       # passthrough (too small / unfactorable)
    num_leaves: int

    @property
    def tt_params(self) -> int:
        return sum(b.batch for b in self.buckets)

    @property
    def batched_launches(self) -> int:
        return sum(1 for b in self.buckets if b.execution == "batched")

    @property
    def fingerprint(self) -> str:
        """Stable content hash — equal iff the plans are identical."""
        h = hashlib.sha256()
        for b in self.buckets:
            h.update(repr((b.dims, b.execution,
                           [(m.name, m.index, m.shape, m.dims)
                            for m in b.members])).encode())
        h.update(repr([(e.name, e.index, e.shape) for e in self.raw]).encode())
        return h.hexdigest()

    def describe(self) -> str:
        lines = [f"plan: {self.tt_params} TT params in {len(self.buckets)} "
                 f"buckets, {len(self.raw)} raw"]
        for b in self.buckets:
            pads = sum(1 for m in b.members if m.dims != b.dims)
            lines.append(
                f"  bucket dims={b.dims} batch={b.batch} "
                f"exec={b.execution}" + (f" (padded members: {pads})"
                                         if pads else ""))
        return "\n".join(lines)


def tensorize_dims(shape: Tuple[int, ...], policy) -> List[int]:
    """Policy dim selection, shared by the planner and the serial
    compressor loop (one source of truth, so the two paths never route a
    shape differently)."""
    if len(shape) >= policy.min_dims:
        return list(shape)
    dims = _tt.tensorize_shape(shape, policy.max_factor)
    if len(dims) < policy.min_dims:
        dims = _tt.tensorize_shape(shape, max(8, policy.max_factor // 8))
    return dims


def padded_work_estimate(dims: Sequence[int], max_rank: Optional[int]) -> int:
    """Σ_k (rmax_{k-1}·n_k·tail_k) — elements touched by the padded sweep."""
    cap = max_rank if max_rank is not None else 1 << 30
    rmax = _tt.tt_max_ranks(dims, cap)
    return sum(rmax[k] * dims[k] * math.prod(dims[k + 1:])
               for k in range(len(dims) - 1))


def build_plan(params, policy, pad_tolerance: float = 0.25,
               serial_cutoff_elems: int = 1 << 24) -> CompressionPlan:
    """Deterministic planning pass over a parameter tree.

    pad_tolerance: a member may join a larger bucket if padding inflates its
      element count by at most this fraction (0 disables padding merges).
    serial_cutoff_elems: buckets whose per-member padded sweep would touch
      more elements than this are scheduled ``execution="serial"``.
    """
    flat = _tree.leaves_with_paths(params)
    raw: List[PlanEntry] = []
    tt_entries: List[PlanEntry] = []
    for idx, (name, leaf) in enumerate(flat):
        shape = tuple(int(d) for d in leaf.shape)
        entry = PlanEntry(name=name, index=idx, shape=shape,
                          dims=tuple(tensorize_dims(shape, policy)))
        if (entry.size < policy.min_size or min(shape or (1,)) == 0
                or len(entry.dims) < 2):
            raw.append(entry)
        else:
            tt_entries.append(entry)

    # ---- bucketing: group by ndim, greedily absorb pad-compatible dims ----
    by_ndim: Dict[int, Dict[Tuple[int, ...], List[PlanEntry]]] = {}
    for e in tt_entries:
        by_ndim.setdefault(len(e.dims), {}).setdefault(e.dims, []).append(e)

    buckets: List[Bucket] = []
    for ndim in sorted(by_ndim):
        groups = by_ndim[ndim]
        # largest target first; ties broken lexicographically
        order = sorted(groups, key=lambda d: (math.prod(d), d), reverse=True)
        absorbed: set = set()
        for target in order:
            if target in absorbed:
                continue
            members = list(groups[target])
            tsize = math.prod(target)
            for cand in order:
                if cand == target or cand in absorbed:
                    continue
                fits = all(c <= t for c, t in zip(cand, target))
                if fits and tsize / math.prod(cand) - 1.0 <= pad_tolerance:
                    members.extend(groups[cand])
                    absorbed.add(cand)
            members.sort(key=lambda m: (m.name, m.index))
            work = padded_work_estimate(target, policy.max_rank)
            buckets.append(Bucket(
                dims=target, members=tuple(members),
                execution="batched" if work <= serial_cutoff_elems
                else "serial"))
            absorbed.add(target)

    buckets.sort(key=lambda b: (len(b.dims), b.dims))
    raw.sort(key=lambda e: e.index)
    return CompressionPlan(buckets=tuple(buckets), raw=tuple(raw),
                           num_leaves=len(flat))
