"""Bucket execution on one card: one batched TT-SVD pass per bucket.

The port of the JAX package's ``core/batch_exec.py``.  Each bucket of the
:class:`~repro_torch.core.plan.CompressionPlan` is stacked (zero-padding the
members merged into a larger bucket) on the members' device and run through
``ttd_static_batched``, whose member k equals ``ttd_static`` of that member;
the padded cores are cropped to their live δ-ranks into the same compact
``TTTensor`` the serial loop produces.  Buckets the planner scheduled
``serial`` run the dynamic-rank ``ttd`` per member.

Differences from the reference, by design:

* no mesh: the port runs on one card, so every member is on device 0
  (``round_robin_chunks`` is kept, with one device, for the same order);
  sharding buckets over cards is ROADMAP queue 1, item 10;
* no executable cache: PyTorch runs eagerly, there is nothing to compile,
  so ``ExecStats.compiles`` and ``cache_hits`` stay 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from repro_torch.core import tt as _tt
from repro_torch.core.plan import Bucket, CompressionPlan

# Rank cap standing in for "uncapped" on the static path: tt_max_ranks takes
# the min with the theoretical ranks, so any large value means "exact".
_UNCAPPED = 1 << 30


@dataclass
class ExecStats:
    """Dispatch accounting for the batched vs serial execution paths."""

    bucket_launches: int = 0          # batched bucket passes run
    serial_params: int = 0            # params routed through the serial loop
    serial_dispatches: int = 0        # SVDs those serial params cost
    batched_params: int = 0           # params decomposed inside bucket passes
    serial_equiv_dispatches: int = 0  # what the all-serial loop would cost
    cache_hits: int = 0               # always 0: nothing is compiled
    compiles: int = 0                 # always 0: nothing is compiled
    per_bucket: List[Dict] = field(default_factory=list)

    @property
    def total_dispatches(self) -> int:
        return self.bucket_launches + self.serial_dispatches

    @property
    def dispatch_reduction(self) -> float:
        return self.serial_equiv_dispatches / max(self.total_dispatches, 1)


def round_robin_chunks(n: int, ndev: int) -> List[List[int]]:
    """Member indices per device under round-robin assignment: member i
    goes to device ``i % ndev``; chunks are padded with -1 to equal
    length."""
    ndev = max(1, ndev)
    chunks = [[i for i in range(n) if i % ndev == d] for d in range(ndev)]
    chunk_len = max((len(c) for c in chunks), default=0)
    for c in chunks:
        c.extend([-1] * (chunk_len - len(c)))
    return chunks


class BucketExecutor:
    """Runs a CompressionPlan's buckets; returns per-leaf TTTensors."""

    def __init__(self):
        self.stats = ExecStats()

    def run_bucket(self, bucket: Bucket, leaves: List[torch.Tensor], policy
                   ) -> List[Tuple[int, _tt.TTTensor, Tuple[int, ...]]]:
        """Decompose one bucket of ``leaves`` (the tree's tensors in flatten
        order); returns (leaf_index, tt, pre_pad_dims)."""
        d = len(bucket.dims)
        if bucket.execution == "serial" or d < 2:
            out = []
            for m in bucket.members:
                tt = _tt.ttd(leaves[m.index], eps=policy.eps,
                             dims=list(m.dims), svd_method=policy.svd_method,
                             hbd_impl=policy.hbd_impl,
                             max_rank=policy.max_rank)
                out.append((m.index, tt, m.dims))
            self.stats.serial_params += len(bucket.members)
            self.stats.serial_dispatches += len(bucket.members) * max(d - 1, 1)
            return out

        (order,) = round_robin_chunks(bucket.batch, 1)
        mats = []
        for i in order:
            m = bucket.members[i]
            x = leaves[m.index].to(torch.float32).reshape(m.dims)
            if m.dims != bucket.dims:
                pad = []
                for c, t in reversed(list(zip(m.dims, bucket.dims))):
                    pad += [0, t - c]
                x = torch.nn.functional.pad(x, pad)
            mats.append(x)
        batched = _tt.ttd_static_batched(
            torch.stack(mats), eps=float(policy.eps),
            max_rank=(policy.max_rank if policy.max_rank is not None
                      else _UNCAPPED),
            svd_method=policy.svd_method, hbd_impl=policy.hbd_impl)
        self.stats.bucket_launches += 1
        self.stats.batched_params += bucket.batch
        self.stats.per_bucket.append({
            "dims": bucket.dims, "batch": bucket.batch,
            "launch_batch": len(order), "devices": 1})

        ranks = batched.ranks.tolist()               # one host read
        out = []
        for pos, i in enumerate(order):
            m = bucket.members[i]
            tt = _tt.static_tt_crop(_tt.static_tt_member(batched, pos),
                                    eps=policy.eps, ranks=ranks[pos])
            out.append((m.index, tt, m.dims))
        return out

    def run(self, plan: CompressionPlan, leaves: List, policy):
        """Execute every bucket; returns {leaf_index: (tt, pre_pad_dims)}."""
        results: Dict[int, Tuple[_tt.TTTensor, Tuple[int, ...]]] = {}
        for bucket in plan.buckets:
            for idx, tt, pre_pad in self.run_bucket(bucket, leaves, policy):
                results[idx] = (tt, pre_pad)
            self.stats.serial_equiv_dispatches += (
                bucket.batch * max(len(bucket.dims) - 1, 1))
        return results
