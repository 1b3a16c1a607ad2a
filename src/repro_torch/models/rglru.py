"""RecurrentGemma (Griffin): RG-LRU recurrent blocks + local MQA attention,
pattern (rglru, rglru, attn) — port of the JAX package's ``models/rglru.py``.

The layer stack is 26 = 8 × the 3-layer pattern plus 2 trailing rglru
layers: params hold the triples stacked (n_triples, ...) and the tail
stacked (n_tail, ...) (``plan``); layers run as a Python loop over
``common.layer_at`` views, so TT leaves select their lead row and share
their cores.

RG-LRU recurrence (per channel, float32):
    r_t = σ(W_rg x_t + b_rg)           recurrence gate
    i_t = σ(W_ig x_t + b_ig)           input gate
    log a_t = -c · softplus(Λ) · r_t   (c = 8)
    h_t = a_t · h_{t-1} + √(1 − a_t²) · (i_t · x_t)
Prefill computes it with a log-depth doubling scan over the sequence
(``rg_lru_scan``); decode as one multiply-add per step, with the recurrent
state, the conv history and a window-sized ring KV cache for the attention
layers (``GriffinCache``), all updated in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import mlp as mlp_mod

RG_C = 8.0
CONV_W = 4


class RGLRULayerParams(NamedTuple):
    ln1: torch.Tensor             # (D,)
    w_x: torch.Tensor             # (D, R) main branch
    w_gate: torch.Tensor          # (D, R) multiplicative branch
    conv_w: torch.Tensor          # (W, R)
    conv_b: torch.Tensor          # (R,)
    lam: torch.Tensor             # (R,) Λ, float32 in every dtype
    w_rg: torch.Tensor            # (R, R)
    b_rg: torch.Tensor            # (R,)
    w_ig: torch.Tensor            # (R, R)
    b_ig: torch.Tensor            # (R,)
    w_out: torch.Tensor           # (R, D)
    ln2: torch.Tensor             # (D,)
    mlp: mlp_mod.MLPParams


class AttnLayerParams(NamedTuple):
    ln1: torch.Tensor
    attn: attn.AttnParams
    ln2: torch.Tensor
    mlp: mlp_mod.MLPParams


class TripleParams(NamedTuple):
    r1: RGLRULayerParams
    r2: RGLRULayerParams
    at: AttnLayerParams


class GriffinParams(NamedTuple):
    embed: torch.Tensor
    triples: TripleParams                 # stacked (n_triples, ...)
    tail: Optional[RGLRULayerParams]      # stacked (n_tail, ...)
    final_norm: torch.Tensor


def _r(cfg) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def plan(cfg) -> Tuple[int, int]:
    """(n_triples, n_tail_rglru) for the layer budget."""
    n_triples = cfg.num_layers // 3
    return n_triples, cfg.num_layers - 3 * n_triples


def _init_rglru(gen, cfg, layers: int, device) -> RGLRULayerParams:
    d, r = cfg.d_model, _r(cfg)
    dt = torch_dtype(cfg.dtype)

    def mk(shape):
        return torch.stack([common.dense_init(gen, shape, 0, dt, device)
                            for _ in range(layers)])

    def zeros(n):
        return torch.zeros((layers, n), dtype=dt, device=device)

    # Λ so that a^c spans ~(0.9, 0.999), as the reference draws it
    lam0 = np.random.RandomState(7).uniform(0.3, 1.5, (layers, r))
    conv_w = torch.randn((layers, CONV_W, r), generator=gen, device=device)
    return RGLRULayerParams(
        ln1=zeros(d), w_x=mk((d, r)), w_gate=mk((d, r)),
        conv_w=(conv_w * 0.1).to(dt), conv_b=zeros(r),
        lam=torch.as_tensor(lam0, dtype=torch.float32, device=device),
        w_rg=mk((r, r)), b_rg=zeros(r), w_ig=mk((r, r)), b_ig=zeros(r),
        w_out=mk((r, d)), ln2=zeros(d),
        mlp=mlp_mod.init_mlp(gen, cfg, layers, device))


def _init_attn_layer(gen, cfg, layers: int, device) -> AttnLayerParams:
    dt = torch_dtype(cfg.dtype)
    return AttnLayerParams(
        ln1=torch.zeros((layers, cfg.d_model), dtype=dt, device=device),
        attn=attn.init_attn(gen, cfg, layers, device),
        ln2=torch.zeros((layers, cfg.d_model), dtype=dt, device=device),
        mlp=mlp_mod.init_mlp(gen, cfg, layers, device))


def init(seed: int, cfg, device) -> GriffinParams:
    """Random weights from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_triples, n_tail = plan(cfg)
    dt = torch_dtype(cfg.dtype)
    triples = TripleParams(
        r1=_init_rglru(gen, cfg, n_triples, device),
        r2=_init_rglru(gen, cfg, n_triples, device),
        at=_init_attn_layer(gen, cfg, n_triples, device))
    return GriffinParams(
        embed=common.embed_init(gen, (cfg.padded_vocab_size, cfg.d_model),
                                dt, device),
        triples=triples,
        tail=_init_rglru(gen, cfg, n_tail, device) if n_tail else None,
        final_norm=torch.zeros((cfg.d_model,), dtype=dt, device=device))


def _embed(params: GriffinParams, tokens, cfg) -> torch.Tensor:
    """Embedding rows times √d_model, the factor rounded to the embedding
    dtype as the reference rounds it."""
    x = params.embed[tokens].to(torch_dtype(cfg.dtype))
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


# ---------------------------------------------------------------------------
# Prefill / training shapes
# ---------------------------------------------------------------------------

def rg_lru_scan(x, gates_r, gates_i, lam) -> torch.Tensor:
    """x, gates (B, S, R) float32 → h (B, S, R): the linear recurrence as a
    Hillis–Steele doubling scan over S (⌈log2 S⌉ passes), combining
    (a1, b1) then (a2, b2) into (a1·a2, a2·b1 + b2) as the reference's
    associative scan does.  Products of a underflow to 0 where the true
    value is below float32's range; a cumprod/divide form would divide by
    them."""
    log_a = -RG_C * F.softplus(lam)[None, None, :] * gates_r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (gates_i * x)
    off, s = 1, a.shape[1]
    while off < s:
        b = torch.cat([b[:, :off],
                       torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def _conv1d(x, w, b):
    """Causal depthwise conv over S: x (B, S, R), w (W, R), b (R,), in x's
    dtype (the taps summed in order, as the reference)."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + xp[:, i: i + s, :] * w[i]
    return out + b


def _rglru_block(x, lp: RGLRULayerParams, cfg):
    h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
    main = common.dense_apply(h, lp.w_x)
    gate = common.activate(common.dense_apply(h, lp.w_gate).float(), "gelu")
    conv = _conv1d(main, lp.conv_w, lp.conv_b).float()
    # float32 activations: dense_apply promotes the gate weights to match
    gr = torch.sigmoid(common.dense_apply(conv, lp.w_rg) + lp.b_rg.float())
    gi = torch.sigmoid(common.dense_apply(conv, lp.w_ig) + lp.b_ig.float())
    hseq = rg_lru_scan(conv, gr, gi, lp.lam)
    y = (hseq * gate).to(x.dtype)
    x = x + common.dense_apply(y, lp.w_out)
    h = common.rms_norm(x, lp.ln2, cfg.norm_eps)
    return (x + mlp_mod.mlp_apply(h, lp.mlp, cfg.act)).to(x.dtype)


def _attn_block(x, lp: AttnLayerParams, cfg, positions, impl: str):
    h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
    q, k, v = attn.qkv_project(h, lp.attn, cfg, positions)
    o = attn.causal_attend(q, k, v, cfg, window=cfg.hybrid.window, impl=impl)
    x = x + common.dense_apply(o, lp.attn.wo, in_ndim=2)
    h = common.rms_norm(x, lp.ln2, cfg.norm_eps)
    return (x + mlp_mod.mlp_apply(h, lp.mlp, cfg.act)).to(x.dtype)


def forward(params: GriffinParams, tokens, cfg, impl: str = "xla"):
    """tokens (B, S) → final-normed hidden states (B, S, D)."""
    x = _embed(params, tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    n_triples, n_tail = plan(cfg)
    for l in range(n_triples):
        tp = common.layer_at(params.triples, l)
        x = _rglru_block(x, tp.r1, cfg)
        x = _rglru_block(x, tp.r2, cfg)
        x = _attn_block(x, tp.at, cfg, positions, impl)
    if params.tail is not None:
        for l in range(n_tail):
            x = _rglru_block(x, common.layer_at(params.tail, l), cfg)
    return common.rms_norm(x, params.final_norm, cfg.norm_eps)


def loss_fn(params, batch, cfg, impl: str = "xla"):
    hidden = forward(params, batch["tokens"], cfg, impl=impl)
    logits = common.unembed(hidden, params.embed, cfg.logit_softcap,
                            real_vocab=cfg.vocab_size)
    loss = common.cross_entropy_loss(logits, batch["labels"],
                                     batch.get("mask"))
    return loss, {"loss": loss}


def prefill(params, tokens, cfg, impl: str = "xla"):
    """Last-position logits (B, V) of the whole prompt."""
    hidden = forward(params, tokens, cfg, impl=impl)
    logits = common.unembed(hidden[:, -1:, :], params.embed,
                            cfg.logit_softcap, real_vocab=cfg.vocab_size)
    return logits[:, 0, :]


# ---------------------------------------------------------------------------
# Decode: O(1) recurrent state + ring-buffer window cache
# ---------------------------------------------------------------------------

class GriffinCache(NamedTuple):
    h1: torch.Tensor              # (n_triples, B, R) float32 recurrent state
    h2: torch.Tensor
    ht: torch.Tensor              # (max(n_tail, 1), B, R)
    conv1: torch.Tensor           # (n_triples, B, W-1, R) conv history
    conv2: torch.Tensor
    convt: torch.Tensor
    k: torch.Tensor               # (n_triples, B, window, Hkv, Dh) ring
    v: torch.Tensor
    pos: torch.Tensor             # (B,) int64 per-slot position


def init_cache(cfg, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> GriffinCache:
    nt, ntail = plan(cfg)
    r = _r(cfg)
    win = min(cfg.hybrid.window, max_len)
    kvshape = (nt, batch, win, cfg.num_kv_heads, cfg.resolved_head_dim)

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return GriffinCache(
        h1=z((nt, batch, r), torch.float32),
        h2=z((nt, batch, r), torch.float32),
        ht=z((max(ntail, 1), batch, r), torch.float32),
        conv1=z((nt, batch, CONV_W - 1, r), dtype),
        conv2=z((nt, batch, CONV_W - 1, r), dtype),
        convt=z((max(ntail, 1), batch, CONV_W - 1, r), dtype),
        k=z(kvshape, dtype), v=z(kvshape, dtype),
        pos=z((batch,), torch.int64))


def _rglru_step(x, lp: RGLRULayerParams, cfg, h_state, conv_state):
    """x (B, 1, D) → (out, h_state', conv_state')."""
    h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
    main = common.dense_apply(h, lp.w_x)[:, 0]                   # (B, R)
    gate = common.activate(common.dense_apply(h, lp.w_gate)[:, 0].float(),
                           "gelu")
    hist = torch.cat([conv_state, main[:, None, :].to(conv_state.dtype)],
                     dim=1)                                      # (B, W, R)
    conv = (torch.einsum("bwr,wr->br", hist.float(), lp.conv_w.float())
            + lp.conv_b.float())
    gr = torch.sigmoid(common.dense_apply(conv, lp.w_rg) + lp.b_rg.float())
    gi = torch.sigmoid(common.dense_apply(conv, lp.w_ig) + lp.b_ig.float())
    log_a = -RG_C * F.softplus(lp.lam)[None, :] * gr
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    h_new = a * h_state + beta * (gi * conv)
    y = (h_new * gate).to(x.dtype)[:, None, :]
    x = x + common.dense_apply(y, lp.w_out)
    hn = common.rms_norm(x, lp.ln2, cfg.norm_eps)
    out = (x + mlp_mod.mlp_apply(hn, lp.mlp, cfg.act)).to(x.dtype)
    return out, h_new, hist[:, 1:, :]


def _attn_step(x, lp: AttnLayerParams, cfg, k_c, v_c, pos):
    """Ring-buffer windowed MQA decode step; ``k_c``/``v_c`` (B, window,
    Hkv, Dh) are written in place at slot pos % window.  ``pos`` is
    per-slot (B,) or shared (): each row keeps its own write slot and
    validity horizon."""
    b, win = x.shape[0], k_c.shape[1]
    h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
    positions = pos.reshape(-1, 1).expand(b, 1)
    q, k_new, v_new = attn.qkv_project(h, lp.attn, cfg, positions)
    slot = torch.remainder(pos, win).reshape(-1, 1)              # (B|1, 1)
    bidx = torch.arange(b, device=x.device)
    k_c[bidx, slot[:, 0].expand(b)] = k_new[:, 0].to(k_c.dtype)
    v_c[bidx, slot[:, 0].expand(b)] = v_new[:, 0].to(v_c.dtype)
    # ring validity: slots hold positions (pos-win, pos]; all valid once full
    slots = torch.arange(win, device=x.device)
    age = torch.remainder(slot - slots[None, :], win)            # 0 = newest
    valid = age <= torch.clamp(pos.reshape(-1, 1), max=win - 1)
    scores = attn._gqa_scores(q, k_c) * q.shape[-1] ** -0.5
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.tensor(attn.NEG_INF, device=x.device))
    o = attn._gqa_out(torch.softmax(scores, dim=-1), v_c).to(x.dtype)
    x = x + common.dense_apply(o, lp.attn.wo, in_ndim=2)
    hn = common.rms_norm(x, lp.ln2, cfg.norm_eps)
    return (x + mlp_mod.mlp_apply(hn, lp.mlp, cfg.act)).to(x.dtype)


def decode_step(params: GriffinParams, cache: GriffinCache, tokens, cfg):
    """One token per slot in (B, 1), logits (B, V) out; the cache's state,
    conv history and ring rows are updated in place."""
    x = _embed(params, tokens, cfg)
    pos = cache.pos
    n_triples, n_tail = plan(cfg)
    for l in range(n_triples):
        tp = common.layer_at(params.triples, l)
        x, cache.h1[l], cache.conv1[l] = _rglru_step(
            x, tp.r1, cfg, cache.h1[l], cache.conv1[l])
        x, cache.h2[l], cache.conv2[l] = _rglru_step(
            x, tp.r2, cfg, cache.h2[l], cache.conv2[l])
        x = _attn_step(x, tp.at, cfg, cache.k[l], cache.v[l], pos)
    if params.tail is not None:
        for l in range(n_tail):
            x, cache.ht[l], cache.convt[l] = _rglru_step(
                x, common.layer_at(params.tail, l), cfg, cache.ht[l],
                cache.convt[l])
    hidden = common.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = common.unembed(hidden, params.embed, cfg.logit_softcap,
                            real_vocab=cfg.vocab_size)
    return logits[:, 0, :], cache._replace(pos=pos + 1)


# TT-native serving rules: the RG-LRU projections (main/gate/recurrence/
# input-gate/out) and the attention+MLP weights of both the scanned triples
# and the tail layers.  Conv and Λ params are tiny and stay raw.
_RGLRU_W = r"(w_x|w_gate|w_rg|w_ig|w_out)"
common.register_tt_serve_rules("hybrid", [
    common.TTServeRule(rf"^triples\.(r1|r2)\.{_RGLRU_W}$", in_ndim=1),
    common.TTServeRule(r"^triples\.(r1|r2)\.mlp\.w_(gate|up|down)$",
                       in_ndim=1),
    common.TTServeRule(r"^triples\.at\.attn\.w[qkv]$", in_ndim=1),
    common.TTServeRule(r"^triples\.at\.attn\.wo$", in_ndim=2),
    common.TTServeRule(r"^triples\.at\.mlp\.w_(gate|up|down)$", in_ndim=1),
    common.TTServeRule(rf"^tail\.{_RGLRU_W}$", in_ndim=1),
    common.TTServeRule(r"^tail\.mlp\.w_(gate|up|down)$", in_ndim=1),
])
