"""Plain PyTorch versions of the flash-attention kernel (its oracles).

``attention_ref`` is the JAX package's ``kernels/flash_attention/ref.py``
on (BH, S, D): the dense softmax with the causal mask ``q_pos >= k_pos``
and the window mask ``q_pos - k_pos < window``, masked scores -1e30.
``mha_ref`` is the same function on the kernel's layout, q (B, S, Hq, D)
against k, v (B, S, Hkv, D), where Q head h reads KV head h // (Hq/Hkv)
without repeating the KV heads.  Both materialize the (S, S) scores.
``mha_tiled`` walks the tensor-core route's tiles instead (used by tests):
its 128-row blocks, 16-row warp slices and 64-key tiles (the kernel's
``kMmaRows`` and ``kBK``), the skipped tiles, the -1e30 masking, float32
state in the base-2 domain and P rounded to q's dtype before P V.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
# the tensor-core route's tiles: query rows per block and per warp, keys
BLOCK_ROWS, WARP_ROWS, BLOCK_KEYS = 128, 16, 64


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


def mha_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """The mma route's arithmetic in plain torch: q (B, S, Hq, D), k, v
    (B, S, Hkv, D) → (B, S, Hq, D) in float32, before the output rounding.

    Each block of ``BLOCK_ROWS`` query rows visits the key tiles of
    ``BLOCK_KEYS`` rows that can be live for it; each ``WARP_ROWS`` slice of
    the block skips the tiles wholly masked for its rows.  Scores are scaled
    by D^-1/2·log2(e) in float32, masked to -1e30 (keys past S are dropped,
    as the kernel's -inf weighs nothing), and fed to an online softmax in
    base 2; P is rounded to q's dtype for P V while l sums the float32 p."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    scale = d ** -0.5 * math.log2(math.e)
    qf = q.float().reshape(b, s, hkv, hq // hkv, d)
    kf, vf = k.float(), v.float()
    out = torch.zeros((b, s, hkv, hq // hkv, d), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, s, BLOCK_ROWS):
        q_last = min(q0 + BLOCK_ROWS, s) - 1
        kv_end = q_last + 1 if causal else s
        kv_begin = max(0, q0 - window + 1) if window else 0
        tiles = range(kv_begin // BLOCK_KEYS, -(-kv_end // BLOCK_KEYS))
        for w0 in range(q0, q_last + 1, WARP_ROWS):
            rows = torch.arange(w0, min(w0 + WARP_ROWS, s), device=q.device)
            qw = qf[:, rows]                                  # (b, r, h, g, d)
            m = torch.full((b, hkv, hq // hkv, len(rows)), NEG_INF,
                           device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((*m.shape, d), device=q.device)
            for t in tiles:
                k0 = t * BLOCK_KEYS
                if (causal and k0 > w0 + WARP_ROWS - 1) or (
                        window and w0 - (k0 + BLOCK_KEYS - 1) >= window):
                    continue
                keys = torch.arange(k0, min(k0 + BLOCK_KEYS, s),
                                    device=q.device)
                sc = torch.einsum("brhgd,bthd->bhgrt", qw, kf[:, keys]) * scale
                live = torch.ones((len(rows), len(keys)), dtype=torch.bool,
                                  device=q.device)
                if causal:
                    live &= rows[:, None] >= keys[None, :]
                if window:
                    live &= rows[:, None] - keys[None, :] < window
                sc = torch.where(live, sc, NEG_INF)
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp2(sc - m_new[..., None])
                alpha = torch.exp2(m - m_new)
                l = l * alpha + p.sum(-1)
                pv = torch.einsum("bhgrt,bthd->bhgrd", p.to(q.dtype).float(),
                                  vf[:, keys])
                acc = acc * alpha[..., None] + pv
                m = m_new
            l = torch.where(l == 0, torch.ones_like(l), l)
            out[:, rows] = (acc / l[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, hq, d)
