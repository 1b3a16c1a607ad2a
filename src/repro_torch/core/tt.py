"""Tensor-Train Decomposition (paper Algorithm 1) and TT reconstruction.

Two execution paths, one algorithm, as in the JAX package:

* ``ttd``        — the offline path with dynamic δ-ranks.  The unfoldings
                   stay on the tensor's device; each step's rank comes from
                   the TRUNCATION kernel and is the one host read of the
                   step.
* ``ttd_static`` / ``ttd_static_batched`` — fixed max-rank cores with the
                   tails zero-masked and the live ranks kept as a tensor:
                   no host read until ``static_tt_crop``.  The batched form
                   decomposes a whole (B, n_1..n_N) bucket in one pass (one
                   batched SVD and one truncation launch per step).

``tt_reconstruct`` is eq. (1)/(2): a chain of matmul + reshape.
"""

from __future__ import annotations

from dataclasses import dataclass
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import truncation as _trunc
from repro_torch.core.svd import svd as _svd_fn
from repro_torch.core.svd import svd_batched as _svd_batched


@dataclass
class TTTensor:
    """A tensor in TT format: cores[k] has shape (r_{k-1}, n_k, r_k)."""

    cores: List[torch.Tensor]
    shape: Tuple[int, ...]           # original tensor shape (n_1..n_N)
    ranks: Tuple[int, ...]           # (r_0=1, r_1, ..., r_N=1)
    eps: float = 0.0

    @property
    def num_params(self) -> int:
        return int(sum(int(c.numel()) for c in self.cores))

    @property
    def live_params(self) -> int:
        r = self.ranks
        return int(sum(r[k] * n * r[k + 1] for k, n in enumerate(self.shape)))


def ttd(w: torch.Tensor, eps: float = 0.05,
        dims: Optional[Sequence[int]] = None, svd_method: str = "two_phase",
        hbd_impl: str = "unblocked", max_rank: Optional[int] = None
        ) -> TTTensor:
    """Paper Algorithm 1 — TT-SVD with dynamic δ-ranks, guaranteeing
    ||W - W_R||_F <= ε ||W||_F.  ``dims`` optionally re-tensorizes ``w``."""
    w = torch.as_tensor(w).to(torch.float32)
    if dims is not None:
        if int(np.prod(dims)) != w.numel():
            raise ValueError(f"dims {tuple(dims)} do not match {tuple(w.shape)}")
        w = w.reshape(tuple(dims))
    shape = tuple(int(n) for n in w.shape)
    d = len(shape)
    if d == 1:
        return TTTensor(cores=[w.reshape(1, -1, 1)], shape=shape,
                        ranks=(1, 1), eps=eps)

    frob = float(torch.linalg.vector_norm(w))
    delta = float(_trunc.delta_threshold(eps, d, frob))

    cores: List[torch.Tensor] = []
    ranks = [1]
    w_temp = w
    del w
    for k in range(d - 1):
        mat = w_temp.reshape(ranks[-1] * shape[k], -1)      # Reshape (line 7)
        res = _svd_fn(mat, method=svd_method, hbd_impl=hbd_impl)  # (8-9)
        # at full width an unfolding and each of its factors are GBs: drop
        # every one as soon as it is dead
        del mat, w_temp
        r = _trunc.truncation_rank(res.s, delta)            # δ-Trunc. (10)
        if max_rank is not None:
            r = min(r, max_rank)
        cores.append(res.u[:, :r].reshape(ranks[-1], shape[k], r).contiguous())
        w_temp = res.s[:r, None] * res.vt[:r, :]            # Σ_t V_tᵀ (11)
        del res
        ranks.append(r)
    cores.append(w_temp.reshape(ranks[-1], shape[-1], 1).contiguous())
    ranks.append(1)
    return TTTensor(cores=cores, shape=shape, ranks=tuple(ranks), eps=eps)


def tt_reconstruct(tt: TTTensor, dtype=None) -> torch.Tensor:
    """Eq. (1)/(2): W_R = G_1 ×₁ G_2 ×₁ … ×₁ G_N via matmul + reshape."""
    acc = tt.cores[0]
    for g in tt.cores[1:]:
        r = g.shape[0]
        acc = acc.reshape(-1, r) @ g.reshape(r, -1)
    out = acc.reshape(tt.shape)
    return out.to(dtype) if dtype is not None else out


# ---------------------------------------------------------------------------
# Static-shape TT-SVD
# ---------------------------------------------------------------------------

@dataclass
class StaticTT:
    """TT with cores padded to max ranks and the live ranks as a tensor.

    cores[k] is (rmax_{k-1}, n_k, rmax_k), or (B, …) for a batch; ranks is
    (N+1,) or (B, N+1) int32."""

    cores: List[torch.Tensor]
    ranks: torch.Tensor
    shape: Tuple[int, ...]


def tt_max_ranks(shape: Sequence[int], max_rank: int) -> List[int]:
    """Theoretical TT max ranks min(prod-left, prod-right), clipped."""
    d = len(shape)
    out = [1]
    for k in range(1, d):
        out.append(min(math.prod(shape[:k]), math.prod(shape[k:]), max_rank))
    out.append(1)
    return out


def ttd_static_batched(w: torch.Tensor, eps: float = 0.05, max_rank: int = 64,
                       svd_method: str = "library",
                       hbd_impl: str = "unblocked") -> StaticTT:
    """Algorithm 1 with static shapes over a (B, n_1..n_N) stack, in one
    pass: every step is one batched SVD (``svd_batched``) and one batched
    truncation launch, with δ per member on the device.  Cores are padded
    to max ranks with the tails zero-masked, so the padded reconstruction
    equals the dynamic-rank one; cores[k] is (B, rmax_{k-1}, n_k, rmax_k)
    and ranks (B, N+1).  Member k equals ``ttd_static(w[k])``."""
    w = torch.as_tensor(w)
    bsz, shape = w.shape[0], tuple(int(n) for n in w.shape[1:])
    d = len(shape)
    dev = w.device
    rmax = tt_max_ranks(shape, max_rank)
    w32 = w.to(torch.float32)
    frob = torch.linalg.vector_norm(w32.reshape(bsz, -1), dim=-1)
    delta = _trunc.delta_threshold(eps, d, frob)              # (B,)

    one = torch.ones(bsz, dtype=torch.int32, device=dev)
    cores: List[torch.Tensor] = []
    ranks = [one]
    w_temp = w32.reshape(bsz, 1, -1)            # (B, rmax_k, prod(shape[k:]))
    for k in range(d - 1):
        rows = rmax[k] * shape[k]
        tail = math.prod(shape[k + 1:])
        mat = w_temp.reshape(bsz, rows, tail)
        kdim = min(rows, tail)
        res = _svd_batched(mat, method=svd_method, hbd_impl=hbd_impl)
        u, s, vt, r = _trunc.truncate_masked(res.u, res.s, res.vt, delta)
        r = torch.clamp(r, max=rmax[k + 1])
        keep = (torch.arange(kdim, device=dev) < r[:, None]).to(u.dtype)
        u = u * keep[:, None, :]
        s = s * keep
        vt = vt * keep[:, :, None]
        rk1 = rmax[k + 1]
        if kdim >= rk1:
            u, s, vt = u[:, :, :rk1], s[:, :rk1], vt[:, :rk1, :]
        else:
            u = torch.nn.functional.pad(u, (0, rk1 - kdim))
            s = torch.nn.functional.pad(s, (0, rk1 - kdim))
            vt = torch.nn.functional.pad(vt, (0, 0, 0, rk1 - kdim))
        cores.append(u.reshape(bsz, rmax[k], shape[k], rk1))
        ranks.append(r.to(torch.int32))
        w_temp = s[:, :, None] * vt                   # (B, rmax_{k+1}, tail)
    cores.append(w_temp.reshape(bsz, rmax[d - 1], shape[d - 1], 1))
    ranks.append(one)
    return StaticTT(cores=cores, ranks=torch.stack(ranks, 1), shape=shape)


def ttd_static(w: torch.Tensor, eps: float = 0.05, max_rank: int = 64,
               svd_method: str = "library", hbd_impl: str = "unblocked"
               ) -> StaticTT:
    """Algorithm 1 with static shapes for one tensor: ``ttd_static_batched``
    with one member."""
    w = torch.as_tensor(w)
    return static_tt_member(ttd_static_batched(
        w[None], eps=eps, max_rank=max_rank, svd_method=svd_method,
        hbd_impl=hbd_impl), 0)


def static_tt_member(tt: StaticTT, i: int) -> StaticTT:
    """Member ``i`` of a batched StaticTT."""
    return StaticTT(cores=[c[i] for c in tt.cores], ranks=tt.ranks[i],
                    shape=tt.shape)


def static_tt_crop(tt: StaticTT, eps: float = 0.0,
                   ranks: Optional[Sequence[int]] = None) -> TTTensor:
    """Crop an (unbatched) StaticTT's zero-masked rank padding away: the
    live-rank slices reconstruct exactly the padded product.  ``ranks``
    (host integers) spares the read of ``tt.ranks`` when the caller has
    them already."""
    if ranks is None:
        ranks = tt.ranks.tolist()
    ranks = [int(r) for r in ranks]
    cores = [c[:ranks[k], :, :ranks[k + 1]].contiguous()
             for k, c in enumerate(tt.cores)]
    return TTTensor(cores=cores, shape=tuple(tt.shape), ranks=tuple(ranks),
                    eps=eps)


def static_tt_reconstruct(tt: StaticTT) -> torch.Tensor:
    """Eq. (1)/(2) on the padded cores of an unbatched StaticTT."""
    acc = tt.cores[0]
    for g in tt.cores[1:]:
        r = g.shape[0]
        acc = acc.reshape(-1, r) @ g.reshape(r, -1)
    return acc.reshape(tt.shape)


def auto_factorize(n: int, max_factor: int = 64) -> List[int]:
    """Split n into balanced factors ≤ max_factor (primes stay whole)."""
    if n <= max_factor:
        return [n]
    f = int(np.floor(np.sqrt(n)))
    for cand in range(f, 1, -1):
        if n % cand == 0:
            return (auto_factorize(cand, max_factor)
                    + auto_factorize(n // cand, max_factor))
    return [n]


def tensorize_shape(shape: Sequence[int], max_factor: int = 64) -> List[int]:
    dims: List[int] = []
    for n in shape:
        dims.extend(auto_factorize(int(n), max_factor))
    return dims
