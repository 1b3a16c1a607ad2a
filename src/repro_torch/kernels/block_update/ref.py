"""Plain PyTorch versions of the WY trailing update (its oracle).

As the JAX package's ``kernels/block_update/ref.py``:
A_out = A − V Tᵀ Vᵀ A = (I − V T Vᵀ)ᵀ A in float32, and the kernel's two
passes on their own: Y = Vᵀ A and A − V W (W = Tᵀ Y).  Each takes one
matrix or a leading batch of them.
"""

from __future__ import annotations

import torch


def vta_ref(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Pass 1: Y = Vᵀ A, (..., b, N)."""
    return v.float().transpose(-1, -2) @ a.float()


def apply_ref(a: torch.Tensor, v: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """Pass 2: A − V W, (..., M, N)."""
    return a.float() - v.float() @ w.float()


def wy_update_ref(a: torch.Tensor, v: torch.Tensor, t: torch.Tensor
                  ) -> torch.Tensor:
    """A − V Tᵀ Vᵀ A in float32, cast back to A's dtype."""
    y = vta_ref(v, a)
    return apply_ref(a, v, t.float().transpose(-1, -2) @ y).to(a.dtype)
