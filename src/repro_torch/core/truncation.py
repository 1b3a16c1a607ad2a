"""δ-Truncation (paper Alg. 1 lines 27-31).

The rule (1-indexed): keep k columns where
    k = min { i : ||Σ_s[i:rank]||_F < δ },
the smallest leading block whose inclusive tail already fits under δ; if no
i satisfies the bound, everything is kept.

Every face goes through the TRUNCATION kernel (``kernels/frob_truncate``:
the CUDA kernel on the card, its plain version on the CPU):

* ``truncation_rank``          — the rank as a host integer (one host read),
                                 used by the offline compressor.
* ``truncation_rank_static`` / ``truncate_masked`` — the rank as a tensor
                                 (no host read) and the factors zero-masked
                                 past it, shapes left at full extent; both
                                 take a leading batch with δ per member.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.frob_truncate import ops as _ops


def delta_threshold(eps: float, num_dims: int, frob_norm):
    """δ = ε/√(d-1) · ||W||_F  (Alg. 1 line 5)."""
    return eps / np.sqrt(max(num_dims - 1, 1)) * frob_norm


def _rank_and_tails(s: torch.Tensor, delta):
    s = torch.as_tensor(s)
    if s.ndim == 1:
        tail, rank = _ops.delta_truncate(s, delta)
    else:
        flat = s.reshape(-1, s.shape[-1])
        d = delta
        if isinstance(delta, torch.Tensor) and delta.ndim:
            d = delta.reshape(-1)
        tail, rank = _ops.delta_truncate_batched(flat, d)
        tail, rank = tail.reshape(s.shape), rank.reshape(s.shape[:-1])
    return tail, rank


def tail_norms(s: torch.Tensor) -> torch.Tensor:
    """t[i] = ||s[i:]||_2 — the reverse-Frobenius scan."""
    return _rank_and_tails(s, 0.0)[0]


def truncation_rank(s, delta: float) -> int:
    """Concrete-rank δ-truncation: the kernel's rank, read on the host."""
    return int(truncation_rank_static(s, delta))


def truncation_rank_static(s: torch.Tensor, delta) -> torch.Tensor:
    """The same rule as an int32 tensor (no host read); ``s`` may carry a
    leading batch with ``delta`` one per member."""
    return _rank_and_tails(s, delta)[1]


def truncate_masked(u, s, vt, delta
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """(U_t, Σ_t, V_t^T, rank) with entries past ``rank`` zeroed; takes a
    leading batch on all three factors."""
    rank = truncation_rank_static(s, delta)
    keep = torch.arange(s.shape[-1], device=s.device) < rank[..., None]
    return (u * keep[..., None, :].to(u.dtype), s * keep.to(s.dtype),
            vt * keep[..., :, None].to(vt.dtype), rank)
