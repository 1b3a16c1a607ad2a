"""Plain PyTorch versions of the flash-attention kernel (its oracles).

``attention_ref`` is the JAX package's ``kernels/flash_attention/ref.py``
on (BH, S, D): the dense softmax with the causal mask ``q_pos >= k_pos``
and the window mask ``q_pos - k_pos < window``, masked scores -1e30.
``mha_ref`` is the same function on the kernel's layout, q (B, S, Hq, D)
against k, v (B, S, Hkv, D), where Q head h reads KV head h // (Hq/Hkv)
without repeating the KV heads.  Both materialize the (S, S) scores.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def band_mask(s: int, causal: bool, window: Optional[int],
              device) -> torch.Tensor:
    """(S, S) bool, True where query row q may attend to key column k."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: Optional[float] = None, causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q, k, v (BH, S, D) → (BH, S, D) in q's dtype."""
    _, s, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    scores = torch.where(band_mask(s, causal, window, q.device)[None],
                         scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, Hq, D), k, v (B, S, Hkv, D) → (B, S, Hq, D) in q's dtype."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) * d ** -0.5
    scores = torch.where(band_mask(s, causal, window, q.device),
                         scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)
