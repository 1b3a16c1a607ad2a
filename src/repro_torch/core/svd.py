"""Two-phase SVD (paper §II-A2): Householder bidiagonalization, then
diagonalization of the small bidiagonal block.

    phase 1 (HBD)   A = U_B B V_Bᵀ      (``core/hbd.py``, or the blocked WY
                                        variant in ``core/blocked.py``)
    phase 2 (diag)  B = Q Σ Pᵀ          (``torch.linalg.svd`` on the N×N block
                                        in float64, as the reference uses
                                        jnp's SVD there; ``diagonalize``)

and U = U_B Q, Vᵀ = Pᵀ V_Bᵀ.  ``sorting_basis`` is the paper's
Sorting_Basis: σ descending, bases permuted by the same index vector, from
the SORTING kernel (``kernels/singular_sort``).  ``svd_batched`` runs the
same path over a (B, M, N) stack: one batched HBD loop, one batched phase
2, one sort launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import blocked as _blocked
from repro_torch.core.hbd import (
    householder_bidiagonalize, householder_bidiagonalize_batched,
)
from repro_torch.kernels.singular_sort import ops as _sort

HBD_IMPLS = ("unblocked", "blocked")


class SVDResult(NamedTuple):
    u: torch.Tensor
    s: torch.Tensor
    vt: torch.Tensor


def sorting_basis(u, s, vt) -> SVDResult:
    """Descending sort of σ with the index vector applied to U's columns
    and Vᵀ's rows; ties keep index order (the reference's stable argsort).
    Takes a leading batch."""
    return SVDResult(*_sort.sorting_basis(u, s, vt))


def diagonalize(b: torch.Tensor) -> SVDResult:
    """Phase 2: B = Q Σ Pᵀ of the N×N bidiagonal block (or a stack), computed
    in float64 and returned in float32, on every device.  float32
    ``torch.linalg.svd`` on a CUDA card (cuSOLVER) is ~3e-5·σ_max off
    float64 at the compressor's shapes, ~50× what float32 LAPACK, which
    the reference runs, gives there."""
    q, s, pt = torch.linalg.svd(b.double(), full_matrices=False)
    return SVDResult(q.float(), s.float(), pt.float())


def _svd(a: torch.Tensor, method: str, hbd_impl: str, panel: int
         ) -> SVDResult:
    """One (M, N) matrix or a (B, M, N) stack; a stack runs the batched HBD
    and the batched sort launch."""
    if method == "library":
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
        return sorting_basis(u, s, vt)
    if method != "two_phase":
        raise ValueError(f"unknown svd method: {method}")
    if hbd_impl not in HBD_IMPLS:
        raise ValueError(f"unknown hbd_impl: {hbd_impl}")
    m, n = a.shape[-2:]
    if m < n:
        # HBD expects tall matrices; SVD(A) = SVD(Aᵀ) with factors swapped
        r = _svd(a.transpose(-1, -2), method, hbd_impl, panel)
        return SVDResult(u=r.vt.transpose(-1, -2), s=r.s,
                         vt=r.u.transpose(-1, -2))
    orig = a.dtype
    a32 = a.to(torch.float32)
    if hbd_impl == "blocked":
        fn = (_blocked.blocked_bidiagonalize_batched if a.ndim == 3
              else _blocked.blocked_bidiagonalize)
        u_b, b, v_bt = fn(a32, panel=panel)
    elif a.ndim == 3:
        u_b, b, v_bt = householder_bidiagonalize_batched(a32)
    else:
        u_b, b, v_bt = householder_bidiagonalize(a32)
    q, s, pt = diagonalize(b)                                # phase 2, N×N
    # the sort's index vector permutes the small phase-2 factors: U_B (Q P)
    # is (U_B Q) P, without a second M×N copy of the big one
    q, s, pt = sorting_basis(q, s, pt)
    return SVDResult(u=(u_b @ q).to(orig), s=s.to(orig),
                     vt=(pt @ v_bt).to(orig))


def svd(a: torch.Tensor, method: str = "two_phase",
        hbd_impl: str = "unblocked", panel: int = 32) -> SVDResult:
    """Thin, descending-sorted SVD: u (M,K), s (K,), vt (K,N), K = min(M,N).

    method: "two_phase" (the paper's HBD + diagonalization) or "library"
    (``torch.linalg.svd``).  hbd_impl: "unblocked" (paper Algorithm 2) or
    "blocked" (QR by WY blocks of ``panel`` columns through the TTD-engine
    kernels, then the unblocked HBD of the small R)."""
    if a.ndim != 2:
        raise ValueError(f"svd expects (M, N), got {tuple(a.shape)}")
    return _svd(a, method, hbd_impl, panel)


def svd_batched(a: torch.Tensor, method: str = "two_phase",
                hbd_impl: str = "unblocked", panel: int = 32) -> SVDResult:
    """``svd`` of every member of a (B, M, N) stack in one pass: u (B, M, K),
    s (B, K), vt (B, K, N).  Member k equals ``svd(a[k], ...)``."""
    if a.ndim != 3:
        raise ValueError(f"svd_batched expects (B, M, N), got {tuple(a.shape)}")
    return _svd(a, method, hbd_impl, panel)
