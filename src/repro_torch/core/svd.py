"""Two-phase SVD (paper §II-A2): Householder bidiagonalization, then
diagonalization of the small bidiagonal block.

    phase 1 (HBD)   A = U_B B V_Bᵀ      (``core/hbd.py``)
    phase 2 (diag)  B = Q Σ Pᵀ          (``torch.linalg.svd`` on the N×N block,
                                        as the reference uses jnp's SVD there)

and U = U_B Q, Vᵀ = Pᵀ V_Bᵀ.  ``sorting_basis`` is the paper's
Sorting_Basis: σ descending, bases permuted by the same index vector.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hbd import householder_bidiagonalize


class SVDResult(NamedTuple):
    u: torch.Tensor
    s: torch.Tensor
    vt: torch.Tensor


def sorting_basis(u, s, vt) -> SVDResult:
    """Descending sort of σ (stable, as the reference's argsort) with the
    index vector applied to U's columns and Vᵀ's rows."""
    ind = torch.argsort(-s, stable=True)
    return SVDResult(u=u[:, ind], s=s[ind], vt=vt[ind, :])


def svd(a: torch.Tensor, method: str = "two_phase",
        hbd_impl: str = "unblocked") -> SVDResult:
    """Thin, descending-sorted SVD: u (M,K), s (K,), vt (K,N), K = min(M,N).

    method: "two_phase" (the paper's HBD + diagonalization) or "library"
    (``torch.linalg.svd``).  hbd_impl: "unblocked" (paper Algorithm 2); the
    blocked WY variant is not ported yet (ROADMAP queue 1)."""
    m, n = a.shape
    if method == "library":
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
        return sorting_basis(u, s, vt)
    if method != "two_phase":
        raise ValueError(f"unknown svd method: {method}")
    if hbd_impl == "blocked":
        raise NotImplementedError(
            "hbd_impl='blocked' is not ported yet (ROADMAP queue 1, item 5)")
    if hbd_impl != "unblocked":
        raise ValueError(f"unknown hbd_impl: {hbd_impl}")
    if m < n:
        r = svd(a.T, method=method, hbd_impl=hbd_impl)
        return SVDResult(u=r.vt.T, s=r.s, vt=r.u.T)

    orig = a.dtype
    u_b, b, v_bt = householder_bidiagonalize(a.to(torch.float32))
    q, s, pt = torch.linalg.svd(b, full_matrices=False)
    res = sorting_basis(u_b @ q, s, pt @ v_bt)
    return SVDResult(u=res.u.to(orig), s=res.s.to(orig), vt=res.vt.to(orig))
