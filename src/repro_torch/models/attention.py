"""Attention: QKV projection (with bias and qk-norm), causal prefill
attention (``causal_attend``), and single-token decode (the KV-cache write
and LSE-style attention over the cache).

Port of the JAX package's ``models/attention.py``.  ``causal_attend`` has
the reference's two implementations: ``impl="xla"``, the plain chunked
path, and ``impl="pallas"``, which goes to the hand-written flash kernel
(``kernels/flash_attention``).  The reference's TPU-mesh tuning knobs
(``opt_bf16_scores``, ``opt_bf16_probs``, ``opt_causal_unroll``,
``opt_attn_remat``) are not ported (ROADMAP queue 1).  Decode attention is
plain PyTorch, as the reference's ``decode_attend`` is plain jnp.
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


def causal_attend(q, k, v, cfg, window: Optional[int] = None,
                  is_global=False, chunk: int = 1024, impl: str = "xla"):
    """Causal (optionally windowed) self-attention: q (B, S, Hq, Dh) against
    k, v (B, S, Hkv, Dh) → (B, S, Hq, Dh) in q's dtype.

    ``impl="pallas"`` runs the flash kernel when ``is_global`` is a Python
    bool, as the reference takes its Pallas kernel only when the flag is
    not traced; the window is dropped for a global layer.  Otherwise the
    plain path attends in query chunks of ``chunk`` rows (O(S·chunk)
    scores), with ``is_global`` widening the window to the whole prefix."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "pallas" and not isinstance(is_global, torch.Tensor):
        from repro_torch.kernels.flash_attention.ops import mha_flash
        win = None if (window is None or is_global) else window
        return mha_flash(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=True, window=win).to(q.dtype)

    s = q.shape[1]
    scale = q.shape[-1] ** -0.5
    if s <= chunk:
        return _attend_block(q, k, v, torch.arange(s, device=q.device),
                             window, is_global, scale)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"attention chunk {chunk}")
    return torch.cat([
        _attend_block(q[:, i:i + chunk], k, v,
                      torch.arange(i, i + chunk, device=q.device),
                      window, is_global, scale)
        for i in range(0, s, chunk)], dim=1)


def _attend_block(qblk, k, v, q_pos, window, is_global, scale):
    """One query block against the whole k, v, masked by position."""
    k_pos = torch.arange(k.shape[1], device=k.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        in_window = q_pos[:, None] - k_pos[None, :] < window
        mask = mask & (in_window | torch.as_tensor(is_global,
                                                   device=k.device))
    scores = _gqa_scores(qblk, k) * scale
    scores = torch.where(mask, scores, torch.tensor(NEG_INF,
                                                     device=k.device))
    return _gqa_out(torch.softmax(scores, dim=-1), v).to(qblk.dtype)


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
