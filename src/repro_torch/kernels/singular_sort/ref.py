"""Plain PyTorch version of the singular-value sort (its oracle).

The paper's Sorting_Basis contract, as the JAX package's
``kernels/singular_sort/ref.py`` and ``core/svd.sorting_basis`` compute
it: σ sorted descending and the index vector of a stable ``argsort(-σ)``
(ties keep index order), int64 for the gathers.  Rows are the last axis
of ``(..., n)``.
"""

from __future__ import annotations

import torch


def sort_desc_ref(s: torch.Tensor):
    """(sorted σ (..., n), index vector (..., n) int64)."""
    idx = torch.argsort(-s.float(), dim=-1, stable=True)
    return torch.take_along_dim(s, idx, dim=-1), idx


def permute_bases(u: torch.Tensor, s_sorted: torch.Tensor, vt: torch.Tensor,
                  idx: torch.Tensor):
    """Apply the index vector to U's columns and Vᵀ's rows (Alg. 1 line
    22); works on one (M, K)/(K, N) pair or a leading batch of them."""
    us = torch.take_along_dim(u, idx[..., None, :], dim=-1)
    vts = torch.take_along_dim(vt, idx[..., :, None], dim=-2)
    return us, s_sorted, vts


def sorting_basis_ref(u, s, vt):
    s_sorted, idx = sort_desc_ref(s)
    return permute_bases(u, s_sorted, vt, idx)
