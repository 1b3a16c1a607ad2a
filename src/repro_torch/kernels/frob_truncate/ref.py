"""Plain PyTorch version of the δ-truncation kernel (its oracle).

Same rule as the JAX package's ``core/truncation.py``
(``tail_norms`` and ``truncation_rank_static``): tail norms
t[i] = ‖σ[i:]‖₂ from a reverse cumulative sum of σ², and the kept rank is
the smallest 1-indexed i with t[i] < δ, else n, clipped to [1, n].  Every
function takes a leading batch of rows, ``(..., n)``, with δ broadcast
against the batch shape.
"""

from __future__ import annotations

import torch


def tail_norms_ref(s: torch.Tensor) -> torch.Tensor:
    """t[..., i] = ‖s[..., i:]‖₂, float32."""
    s = s.float()
    return torch.sqrt(torch.flip(torch.cumsum(torch.flip(s * s, [-1]), -1),
                                 [-1]))


def frob_truncate_ref(s: torch.Tensor, delta):
    """(tail norms (..., n) float32, ranks (...) int32)."""
    tail = tail_norms_ref(s)
    n = s.shape[-1]
    delta = torch.as_tensor(delta, dtype=torch.float32, device=s.device)
    cond = tail < delta[..., None]
    first = torch.argmax(cond.to(torch.int32), dim=-1)
    rank = torch.where(cond.any(-1), torch.clamp(first + 1, min=1),
                       torch.full_like(first, n))
    return tail, torch.clamp(rank, 1, n).to(torch.int32)
