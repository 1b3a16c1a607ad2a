"""δ-Truncation (paper Alg. 1 lines 27-31).

The rule (1-indexed): keep k columns where
    k = min { i : ||Σ_s[i:rank]||_F < δ },
the smallest leading block whose inclusive tail already fits under δ; if no
i satisfies the bound, everything is kept.

* ``truncation_rank``          — concrete rank (host integer), used by the
                                 offline compressor.
* ``truncation_rank_static`` / ``truncate_masked`` — the rank as a tensor
                                 and the factors zero-masked past it, with
                                 shapes left at full extent.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def delta_threshold(eps: float, num_dims: int, frob_norm):
    """δ = ε/√(d-1) · ||W||_F  (Alg. 1 line 5)."""
    return eps / np.sqrt(max(num_dims - 1, 1)) * frob_norm


def tail_norms(s: torch.Tensor) -> torch.Tensor:
    """t[i] = ||s[i:]||_2 — the reverse-Frobenius scan."""
    return torch.sqrt(torch.flip(torch.cumsum(torch.flip(s * s, [0]), 0), [0]))


def truncation_rank(s, delta: float) -> int:
    """Concrete-rank δ-truncation; ``s`` is read on the host."""
    s = np.asarray(s.detach().cpu() if isinstance(s, torch.Tensor) else s)
    t = np.sqrt(np.cumsum((s * s)[::-1])[::-1])
    hits = np.nonzero(t < delta)[0]
    if hits.size == 0:
        return int(s.shape[0])
    return max(int(hits[0]) + 1, 1) if hits[0] > 0 else 1


def truncation_rank_static(s: torch.Tensor, delta) -> torch.Tensor:
    """The same rule as a tensor (no host read)."""
    cond = tail_norms(s) < delta
    first = torch.argmax(cond.to(torch.int32))
    rank = torch.where(cond.any(), torch.clamp(first + 1, min=1),
                       torch.tensor(s.shape[0], device=s.device))
    return torch.clamp(rank, 1, s.shape[0]).to(torch.int32)


def truncate_masked(u, s, vt, delta
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """(U_t, Σ_t, V_t^T, rank) with entries past ``rank`` zeroed."""
    rank = truncation_rank_static(s, delta)
    keep = torch.arange(s.shape[0], device=s.device) < rank
    return (u * keep[None, :].to(u.dtype), s * keep.to(s.dtype),
            vt * keep[:, None].to(vt.dtype), rank)
