"""Householder bidiagonalization (paper Algorithm 2) in PyTorch.

Same arithmetic as the JAX package's ``core/hbd.py``: HOUSE builds the
reflector ``v`` and pivot ``q = -sign(x_1)·||x||``; HOUSE_MM_UPDATE applies
it as two GEMM-shaped steps, ``sub += (v/β) ⊗ (vᵀ·sub)`` with
``β = v_1·q``; the reduction loop retains the reflectors in place in A, and
the accumulation loop rebuilds U_B and V_Bᵀ from them, last reflector
first.

Two deliberate differences, neither of which changes a value:

* Updates touch only the active sub-block ``A[i:, i+1:]`` (views updated
  in place) instead of masking full-size copies.  XLA needs the masks for
  static shapes; PyTorch runs eagerly.
* U_B is accumulated thin, ``M × N``, not ``M × M``.  ``svd`` reads only
  its first N columns, and backward accumulation never mixes the columns
  past N into those, so they are the same numbers.  For a tall unfolding
  of a full-width weight (1,048,576 × 24 for qwen1.5-0.5b's wq) the full
  M × M form would take 4 TB.

Scalars stay on the device (no host read per step), so on a GPU the loop
only enqueues work.  Every step carries a leading batch dimension: one
loop bidiagonalizes a whole bucket of same-shape unfoldings
(``householder_bidiagonalize_batched``), and the single-matrix form is
that loop with one member.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class HouseResult(NamedTuple):
    q: torch.Tensor   # pivot value -sign(x1)·||x||, one per member
    v: torch.Tensor   # Householder vector (unnormalized), (..., len)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with sign(0) := 1 (LAPACK convention)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def house(x: torch.Tensor) -> HouseResult:
    """Paper HOUSE on the active vector(s) x (..., len), x[..., 0] = x_1."""
    norm = torch.linalg.vector_norm(x, dim=-1)
    s = _sign(x[..., 0])
    v = x.clone()
    v[..., 0] = v[..., 0] + s * norm
    return HouseResult(q=-s * norm, v=v)


def _inv_beta(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """1/β with β = v_1·q; 0 when the active vector is zero (H = I)."""
    beta = v[..., 0] * q
    safe = beta.abs() > 0
    return torch.where(safe, 1.0 / torch.where(safe, beta, 1.0), 0.0)


def house_mm_update(q, v, sub: torch.Tensor, order: int) -> None:
    """Paper HOUSE_MM_UPDATE, in place on the active block(s) ``sub``
    (..., rows, cols), one reflector per member.

    order 0 (left):  sub += (v/β) ⊗ (vᵀ·sub)
    order 1 (right): sub += (sub·v) ⊗ (v/β)
    """
    if sub.numel() == 0:
        return
    ib = _inv_beta(q, v)[..., None]
    if order == 0:
        sub.baddbmm_((v * ib)[..., :, None], v[..., None, :] @ sub)
    elif order == 1:
        sub.baddbmm_(sub @ v[..., :, None], (v * ib)[..., None, :])
    else:
        raise ValueError(f"order must be 0 (left) or 1 (right), got {order}")


def householder_bidiagonalize_batched(
        a: torch.Tensor, compute_uv: bool = True
) -> Tuple[Optional[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
    """Paper Algorithm 2 over a (B, M, N) stack (M >= N), one reduction loop
    for every member: member k equals ``householder_bidiagonalize(a[k])``.

    Returns the thin U_B (B, M, N), B as (B, N, N) upper-bidiagonal blocks
    (the reference's M×N B is zero below row N), and V_Bᵀ (B, N, N).  With
    ``compute_uv=False`` the two bases are ``None``.  Computes in f32 (in
    f64 for f64 input: the tests' rounding-free comparison) and returns the
    input's dtype.
    """
    if a.ndim != 3:
        raise ValueError(f"expected (B, M, N), got {tuple(a.shape)}")
    bsz, m, n = a.shape
    if m < n:
        raise ValueError(f"HBD expects M >= N, got {tuple(a.shape[1:])}; "
                         f"transpose first")
    orig_dtype = a.dtype
    dev = a.device
    wide = torch.promote_types(orig_dtype, torch.float32)
    a = a.to(wide).clone()
    diag = torch.zeros((bsz, n), dtype=wide, device=dev)
    sup = torch.zeros((bsz, n), dtype=wide, device=dev)

    # ---- reduction loop: reflectors retained in A's reduced wings ----
    for i in range(n):
        q, v_l = house(a[:, i:, i])
        diag[:, i] = q
        house_mm_update(q, v_l, a[:, i:, i + 1:], 0)
        a[:, i:, i] = v_l
        if i < n - 1:
            qr, v_r = house(a[:, i, i + 1:])
            sup[:, i] = qr
            house_mm_update(qr, v_r, a[:, i + 1:, i + 1:], 1)
            a[:, i, i + 1:] = v_r

    b = torch.diag_embed(diag)
    if n > 1:
        b = b + torch.diag_embed(sup[:, :-1], 1)
    if not compute_uv:
        return None, b.to(orig_dtype), None

    # ---- accumulation loop, i = N-1..0 (thin U_B) ----
    u_b = torch.zeros((bsz, m, n), dtype=wide, device=dev)
    idx = torch.arange(n, device=dev)
    u_b[:, idx, idx] = 1.0
    v_bt = torch.eye(n, dtype=wide, device=dev).repeat(bsz, 1, 1)
    for i in range(n - 1, -1, -1):
        house_mm_update(diag[:, i], a[:, i:, i], u_b[:, i:, i:], 0)
        if i < n - 1:
            house_mm_update(sup[:, i], a[:, i, i + 1:],
                            v_bt[:, i + 1:, i + 1:], 1)
    return u_b.to(orig_dtype), b.to(orig_dtype), v_bt.to(orig_dtype)


def householder_bidiagonalize(a: torch.Tensor, compute_uv: bool = True
                              ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                         Optional[torch.Tensor]]:
    """Paper Algorithm 2: A (M×N, M≥N) → (U_B, B, V_Bᵀ) with A = U_B B V_Bᵀ.

    Returns the thin U_B (M×N), B as the N×N upper-bidiagonal block (the
    reference's M×N B is zero below row N), and V_Bᵀ (N×N).  With
    ``compute_uv=False`` the two bases are ``None``.  Computes in f32 (f64
    for f64 input) and returns the input's dtype.  The batched loop with
    one member.
    """
    if a.ndim != 2:
        raise ValueError(f"expected (M, N), got {tuple(a.shape)}")
    u, b, vt = householder_bidiagonalize_batched(a[None], compute_uv)
    return (None if u is None else u[0], b[0], None if vt is None else vt[0])
