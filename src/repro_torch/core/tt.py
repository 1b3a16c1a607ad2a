"""Tensor-Train Decomposition (paper Algorithm 1) and TT reconstruction.

``ttd`` is the offline TT-SVD with dynamic δ-ranks.  The unfoldings stay on
the tensor's device; the only host reads are the singular values each step
needs to pick its rank.  ``tt_reconstruct`` is eq. (1)/(2): a chain of
matmul + reshape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import truncation as _trunc
from repro_torch.core.svd import svd as _svd_fn


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
    for k in range(d - 1):
        mat = w_temp.reshape(ranks[-1] * shape[k], -1)      # Reshape (line 7)
        res = _svd_fn(mat, method=svd_method, hbd_impl=hbd_impl)  # (8-9)
        r = _trunc.truncation_rank(res.s, delta)            # δ-Trunc. (10)
        if max_rank is not None:
            r = min(r, max_rank)
        u, s, vt = res.u[:, :r], res.s[:r], res.vt[:r, :]
        w_temp = s[:, None] * vt                            # Σ_t V_tᵀ (11)
        cores.append(u.reshape(ranks[-1], shape[k], r).contiguous())
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
