"""Plain PyTorch version of the Householder panel factorization (its
oracle), and the compact-WY T factor.

``panel_factor_ref`` is the JAX package's ``kernels/householder/ref.py``
(and the TPU kernel's ``_panel_body``) in PyTorch: an unblocked
Householder QR of an (M, b) panel, returning V (M, b) unit-lower
reflectors (v_j[j] = 1, zero above), τ (b,) and R (b, b) upper triangular
with (I − τ_b v_b v_bᵀ)···(I − τ_1 v_1 v_1ᵀ) A = [R; 0].  A zero column
takes the ``safe`` branch: τ = 0 and v = 0, so H = I.  It takes a leading
batch, ``(..., M, b)``, and panels shorter than they are wide (M < b: the
columns past M get τ = 0 and zero rows of R).
"""

from __future__ import annotations

import torch


def panel_factor_ref(a_panel: torch.Tensor):
    """(V (..., M, b), τ (..., b), R (..., b, b)), float32."""
    acc = a_panel.float().clone()
    *lead, m, b = acc.shape
    dev = acc.device
    vs = torch.zeros_like(acc)
    taus = torch.zeros((*lead, b), dtype=torch.float32, device=dev)
    rows = torch.arange(m, device=dev)
    for j in range(b):
        mask = (rows >= j).to(acc.dtype)
        x = acc[..., :, j] * mask
        norm = torch.linalg.vector_norm(x, dim=-1)
        x1 = (acc[..., j, j] if j < m
              else torch.zeros(lead, dtype=acc.dtype, device=dev))
        s = torch.where(x1 >= 0, 1.0, -1.0).to(acc.dtype)
        pivot = -s * norm
        v1 = x1 + s * norm
        safe = v1.abs() > 0
        v = x / torch.where(safe, v1, 1.0)[..., None]
        if j < m:
            v[..., j] = safe.to(acc.dtype)
        tau = torch.where(safe, s * v1 / torch.where(norm == 0, 1.0, norm),
                          0.0)
        w = (v[..., None, :] @ acc)[..., 0, :]                 # vᵀ A
        acc = acc - (tau[..., None] * v)[..., :, None] * w[..., None, :]
        if j < m:
            acc[..., j, j] = pivot
        vs[..., :, j] = v
        taus[..., j] = tau
    r = torch.zeros((*lead, b, b), dtype=acc.dtype, device=dev)
    k = min(m, b)
    r[..., :k, :] = torch.triu(acc[..., :k, :])
    return vs, taus, r


def build_t(vs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY T (forward, columnwise, LAPACK's LARFT):
    H_1 … H_b = I − V T Vᵀ.  Takes a leading batch."""
    b = taus.shape[-1]
    vtv = vs.transpose(-1, -2) @ vs
    t = torch.zeros((*taus.shape[:-1], b, b), dtype=vs.dtype,
                    device=vs.device)
    for j in range(b):
        tj = taus[..., j]
        col = -tj[..., None] * (t[..., :, :j] @ vtv[..., :j, j:j + 1])[..., 0]
        t[..., :j, j] = col[..., :j]
        t[..., j, j] = tj
    return t
