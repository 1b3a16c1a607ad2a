"""Blocked (WY) Householder bidiagonalization — the TTD-engine variant of
phase 1, as the JAX package's ``core/blocked.py``.

QR by blocks of ``panel`` columns (the panel factor on the HBD-ACC kernel,
the trailing update in compact-WY form on the GEMM kernel), then the
unblocked paper HBD on the small N×N R:

    A = Q R,   R = U_r B V_Bᵀ   ⇒   A = (Q U_r) B V_Bᵀ.

For tall unfoldings (M ≫ N, the usual TT-SVD case) this moves almost all of
phase 1's work into the two kernels, and the unblocked loop runs on N×N
instead of M×N.  U_B is thin (M×N) and N is padded with zero columns to a
multiple of ``panel`` inside the QR and cropped back, as the reference does.
The QR itself is ``kernels/householder/ops.qr_blocked``: it hands the panel
kernel the active sub-view ``A[c0:, c0:c0+panel]`` and updates
``A[c0:, c0+panel:]``.
"""

from __future__ import annotations

import torch

from repro_torch.core import hbd as _hbd
from repro_torch.kernels.householder import ops as _hh


def blocked_qr(a: torch.Tensor, panel: int = 32):
    """Blocked Householder QR A = Q R: (q (M, N) thin, r (N, N)); takes a
    leading batch."""
    return _hh.qr_blocked(a, panel=panel)


def blocked_bidiagonalize(a: torch.Tensor, panel: int = 32):
    """QR-first bidiagonalization of one (M, N) matrix, M >= N: (U_B (M, N),
    B (N, N), V_Bᵀ (N, N)), the contract of
    ``hbd.householder_bidiagonalize``."""
    q, r = blocked_qr(a, panel=panel)
    u_r, b, v_bt = _hbd.householder_bidiagonalize(r)
    return q @ u_r, b, v_bt


def blocked_bidiagonalize_batched(a: torch.Tensor, panel: int = 32):
    """``blocked_bidiagonalize`` of every member of a (B, M, N) stack: one
    panel launch and one WY update per panel for the whole batch."""
    if a.ndim != 3:
        raise ValueError(f"expected (B, M, N), got {tuple(a.shape)}")
    q, r = blocked_qr(a, panel=panel)
    u_r, b, v_bt = _hbd.householder_bidiagonalize_batched(r)
    return q @ u_r, b, v_bt
