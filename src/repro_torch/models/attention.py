"""Attention for single-token decode: QKV projection (with bias and
qk-norm), the KV-cache write, and LSE-style attention over the cache.

Port of the decode part of the JAX package's ``models/attention.py``.  The
attention itself is plain PyTorch, as the reference's ``decode_attend`` is
plain jnp.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import common

NEG_INF = -2.0e38


class AttnParams(NamedTuple):
    """Per layer (stack a leading L axis): wq (D, Hq, Dh), wk/wv (D, Hkv, Dh),
    wo (Hq, Dh, D), optional biases (H, Dh) and qk-norm scales (Dh,)."""
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None
    q_norm: Optional[torch.Tensor] = None
    k_norm: Optional[torch.Tensor] = None


def init_attn(gen: torch.Generator, cfg, layers: int, device) -> AttnParams:
    d, hq, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)

    def mk(shape, in_axis=0):
        return torch.stack([common.dense_init(gen, shape, in_axis, dt, device)
                            for _ in range(layers)])

    def zeros(shape):
        return torch.zeros((layers, *shape), dtype=dt, device=device)

    return AttnParams(
        wq=mk((d, hq, dh)), wk=mk((d, hkv, dh)), wv=mk((d, hkv, dh)),
        wo=mk((hq, dh, d)),
        bq=zeros((hq, dh)) if cfg.qkv_bias else None,
        bk=zeros((hkv, dh)) if cfg.qkv_bias else None,
        bv=zeros((hkv, dh)) if cfg.qkv_bias else None,
        q_norm=zeros((dh,)) if cfg.qk_norm else None,
        k_norm=zeros((dh,)) if cfg.qk_norm else None,
    )


def qkv_project(x, p: AttnParams, cfg, positions):
    q = common.dense_apply(x, p.wq)
    k = common.dense_apply(x, p.wk)
    v = common.dense_apply(x, p.wv)
    if p.bq is not None:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if p.q_norm is not None:
        q = common.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = common.rms_norm(k, p.k_norm, cfg.norm_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k):
    """(B,S,Hq,D) x (B,T,Hkv,D) -> (B,Hkv,G,S,T) without repeating KV."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    return torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())


def _gqa_out(p, v):
    """(B,Hkv,G,S,T) x (B,T,Hkv,D) -> (B,S,Hq,D)."""
    b, hkv, g, s, t = p.shape
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return out.reshape(b, s, hkv * g, -1)


def decode_attend(q, k_cache, v_cache, pos, cfg,
                  window: Optional[int] = None, is_global=False):
    """Single-token attention over the cache; ``pos`` is per-slot (B,) or
    shared ()."""
    b, _, hq, dh = q.shape
    t = k_cache.shape[1]
    scale = dh ** -0.5
    k_pos = torch.arange(t, device=q.device)
    posc = pos.reshape(-1, 1)
    valid = k_pos[None, :] <= posc
    if window is not None:
        valid = valid & ((k_pos[None, :] > posc - window) | bool(is_global))
    scores = _gqa_scores(q, k_cache) * scale             # (B,Hkv,G,1,T)
    scores = torch.where(valid[:, None, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    num = _gqa_out(e, v_cache)                           # (B,1,Hq,Dh) f32
    den = e.sum(dim=-1).reshape(b, 1, hq, 1)
    return (num / torch.clamp(den, min=1e-30)).to(q.dtype)


def cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Write the new token's K/V at ``pos`` (per-slot (B,) or shared ()),
    clamped at the cache edge.  Updates the caches in place and returns
    them."""
    b, t = k_cache.shape[:2]
    p = pos.reshape(-1).expand(b).clamp(0, t - 1)
    bidx = torch.arange(b, device=k_cache.device)
    k_cache[bidx, p] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, p] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
