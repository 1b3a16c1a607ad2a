"""Plain PyTorch versions of the flash-attention kernel (its oracles).

``attention_ref`` is the JAX package's ``kernels/flash_attention/ref.py``
on (BH, S, D): the dense softmax with the causal mask ``q_pos >= k_pos``
and the window mask ``q_pos - k_pos < window``, masked scores -1e30.
``mha_ref`` is the same function on the kernel's layout, q (B, S, Hq, D)
against k, v (B, S, Hkv, D), where Q head h reads KV head h // (Hq/Hkv)
without repeating the KV heads.  Both materialize the (S, S) scores.
``mha_tiled`` walks the bf16 route's tiles instead (used by tests): its
128-row blocks, 16-row warp slices and 64-key tiles (the kernel's
``kMmaRows`` and ``kBK``), the skipped tiles, the -1e30 masking, float32
state in the base-2 domain and P rounded to q's dtype before P V.
``mha_tf32x3`` walks the float32 route's tiles (``f32_tiles``: 64-row
blocks and 32-key tiles, 128 and 16 at D = 256; 16-row warps) with its
products: every operand split into two TF32
parts (``split_tf32``, rounded as ``tf32_rna``), hi·hi + hi·lo + lo·hi.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
# the bf16 route's tiles: query rows per block and per warp, keys
BLOCK_ROWS, WARP_ROWS, BLOCK_KEYS = 128, 16, 64


def f32_tiles(d: int):
    """The float32 route's tiles at head dim d: (query rows per block, keys
    per tile), 16 rows a warp (the kernel's ``F32Tile``)."""
    return (128, 16) if d == 256 else (64, 32)


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
    """q (B, S, Hq, D), k, v (B, S, Hkv, D) → (B, S, Hq, D) in q's dtype,
    computed in float32 (float64 for float64 inputs: the oracle of the
    float32 route)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    wide = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(wide).reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.to(wide)) * d ** -0.5
    scores = torch.where(band_mask(s, causal, window, q.device),
                         scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.to(wide))
    return out.reshape(b, s, hq, d).to(q.dtype)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x in float32 rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``: add half a TF32 ulp to the
    bits, then clear the 13 low ones."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo), both TF32: hi = rna(x), lo = rna(x - hi); x - hi - lo is
    below 2^-22·|x|."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def _walk(q, k, v, causal, window, block_rows, block_keys, scores, pv):
    """The routes' shared tile walk: q (B, S, Hq, D), k, v (B, S, Hkv, D)
    → (B, S, Hq, D) float32.  Each block of ``block_rows`` query rows visits
    the key tiles of ``block_keys`` rows that can be live for it; each
    ``WARP_ROWS`` slice skips the tiles wholly masked for its rows.
    ``scores(qw, kt)`` gives the slice's scores against a tile,
    ``pv(p, vt)`` its P V; scores are scaled by D^-1/2·log2(e), masked to
    -1e30 (keys past S are dropped, as the kernels' -inf weighs nothing)
    and fed to an online softmax in base 2, l summing the float32 p."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    scale = d ** -0.5 * math.log2(math.e)
    qf = q.float().reshape(b, s, hkv, hq // hkv, d)
    kf, vf = k.float(), v.float()
    out = torch.zeros((b, s, hkv, hq // hkv, d), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, s, block_rows):
        q_last = min(q0 + block_rows, s) - 1
        kv_end = q_last + 1 if causal else s
        kv_begin = max(0, q0 - window + 1) if window else 0
        tiles = range(kv_begin // block_keys, -(-kv_end // block_keys))
        for w0 in range(q0, q_last + 1, WARP_ROWS):
            rows = torch.arange(w0, min(w0 + WARP_ROWS, s), device=q.device)
            qw = qf[:, rows]                                  # (b, r, h, g, d)
            m = torch.full((b, hkv, hq // hkv, len(rows)), NEG_INF,
                           device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((*m.shape, d), device=q.device)
            for t in tiles:
                k0 = t * block_keys
                if (causal and k0 > w0 + WARP_ROWS - 1) or (
                        window and w0 - (k0 + block_keys - 1) >= window):
                    continue
                keys = torch.arange(k0, min(k0 + block_keys, s),
                                    device=q.device)
                sc = scores(qw, kf[:, keys]) * scale
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
                acc = acc * alpha[..., None] + pv(p, vf[:, keys])
                m = m_new
            l = torch.where(l == 0, torch.ones_like(l), l)
            out[:, rows] = (acc / l[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, hq, d)


_QK = "brhgd,bthd->bhgrt"
_PV = "bhgrt,bthd->bhgrd"


def mha_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """The bf16 route's arithmetic in plain torch: q (B, S, Hq, D), k, v
    (B, S, Hkv, D) → (B, S, Hq, D) in float32, before the output rounding.
    ``BLOCK_ROWS``-row blocks, ``BLOCK_KEYS``-key tiles (``_walk``); the
    scores in float32; P is rounded to q's dtype for P V."""
    return _walk(q, k, v, causal, window, BLOCK_ROWS, BLOCK_KEYS,
                 lambda qw, kt: torch.einsum(_QK, qw, kt),
                 lambda p, vt: torch.einsum(_PV, p.to(q.dtype).float(), vt))


def mha_tf32x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True, window: Optional[int] = None
               ) -> torch.Tensor:
    """The float32 route's arithmetic in plain torch, float32 inputs →
    (B, S, Hq, D) float32.  The blocks and key tiles of ``f32_tiles``
    (``_walk``); each product of Q Kᵀ and of
    P V is hi·hi + hi·lo + lo·hi of the ``split_tf32`` parts, each term a
    float32 product (exact: 11 by 11 significant bits), summed in float32;
    Q Kᵀ adds hi·hi and the two small terms apart, then together."""
    def dot3(eq, a, b):
        (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
        return torch.einsum(eq, ah, bh), (torch.einsum(eq, al, bh)
                                          + torch.einsum(eq, ah, bl))

    def scores(qw, kt):
        big, small = dot3(_QK, qw, kt)
        return big + small

    def pv(p, vt):
        big, small = dot3(_PV, p, vt)
        return small + big

    return _walk(q, k, v, causal, window, *f32_tiles(q.shape[-1]), scores,
                 pv)
