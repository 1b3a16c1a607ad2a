"""Encoder-decoder backbone (seamless-m4t-large-v2) — port of the JAX
``models/encdec.py``.

The multimodal frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings (B, S_enc, D) as the encoder input, and a
serving request's source tokens embed through the tied decoder table to
stand in for them.  Encoder: bidirectional self-attention layers
(``attention.cross_attend``, no mask).  Decoder: causal self-attention
(``attention.causal_attend``: under ``impl="pallas"`` the flash kernel)
and attention to the encoder memory.  Layers run as a Python loop over the
stacked params (``common.layer_at``): TT leaves select their lead row and
share their cores.

Decode keeps a self-attention KV cache and the encoder memory's projected
cross-attention K/V per slot (``EncDecCache``): ``populate_memory`` fills
every row (a uniform batch), ``admit_memory`` one slot (the engine's
admission), and ``mem_len`` masks each slot's unused memory rows.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import mlp as mlp_mod


class EncLayerParams(NamedTuple):
    ln1: torch.Tensor
    attn: attn.AttnParams
    ln2: torch.Tensor
    mlp: mlp_mod.MLPParams


class DecLayerParams(NamedTuple):
    ln1: torch.Tensor
    self_attn: attn.AttnParams
    ln_x: torch.Tensor
    cross_attn: attn.AttnParams
    ln2: torch.Tensor
    mlp: mlp_mod.MLPParams


class EncDecParams(NamedTuple):
    embed: torch.Tensor               # (V, D) decoder token embeddings
    enc_layers: EncLayerParams        # stacked (Le, ...)
    enc_norm: torch.Tensor
    dec_layers: DecLayerParams        # stacked (Ld, ...)
    final_norm: torch.Tensor


def init(seed: int, cfg, device) -> EncDecParams:
    """Random weights from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch_dtype(cfg.dtype)
    le, ld, d = cfg.enc_layers, cfg.num_layers, cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    enc = EncLayerParams(
        ln1=zeros(le, d), attn=attn.init_attn(gen, cfg, le, device),
        ln2=zeros(le, d), mlp=mlp_mod.init_mlp(gen, cfg, le, device))
    dec = DecLayerParams(
        ln1=zeros(ld, d), self_attn=attn.init_attn(gen, cfg, ld, device),
        ln_x=zeros(ld, d), cross_attn=attn.init_attn(gen, cfg, ld, device),
        ln2=zeros(ld, d), mlp=mlp_mod.init_mlp(gen, cfg, ld, device))
    return EncDecParams(
        embed=common.embed_init(gen, (cfg.padded_vocab_size, d), dt, device),
        enc_layers=enc, enc_norm=zeros(d), dec_layers=dec,
        final_norm=zeros(d))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def encode(params: EncDecParams, frames: torch.Tensor, cfg,
           impl: str = "xla") -> torch.Tensor:
    """frames (B, S_enc, D), the frontend's embeddings → the encoder memory
    (B, S_enc, D).  The encoder attends with ``cross_attend`` under either
    ``impl``, as the reference's does."""
    del impl
    x = frames.to(torch_dtype(cfg.dtype))
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for l in range(cfg.enc_layers):
        lp = common.layer_at(params.enc_layers, l)
        h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
        q, k, v = attn.qkv_project(h, lp.attn, cfg, positions)
        o = attn.cross_attend(q, k, v, cfg)       # full bidirectional
        x = x + common.dense_apply(o, lp.attn.wo, in_ndim=2)
        h = common.rms_norm(x, lp.ln2, cfg.norm_eps)
        x = (x + mlp_mod.mlp_apply(h, lp.mlp, cfg.act)).to(x.dtype)
    return common.rms_norm(x, params.enc_norm, cfg.norm_eps)


def _dec_block(x, lp: DecLayerParams, memory, cfg, positions, impl: str):
    h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
    q, k, v = attn.qkv_project(h, lp.self_attn, cfg, positions)
    o = attn.causal_attend(q, k, v, cfg, impl=impl)
    x = x + common.dense_apply(o, lp.self_attn.wo, in_ndim=2)
    # attention to the encoder memory
    h = common.rms_norm(x, lp.ln_x, cfg.norm_eps)
    q = common.dense_apply(h, lp.cross_attn.wq)
    km = common.dense_apply(memory, lp.cross_attn.wk)
    vm = common.dense_apply(memory, lp.cross_attn.wv)
    o = attn.cross_attend(q, km, vm, cfg)
    x = x + common.dense_apply(o, lp.cross_attn.wo, in_ndim=2)
    h = common.rms_norm(x, lp.ln2, cfg.norm_eps)
    return (x + mlp_mod.mlp_apply(h, lp.mlp, cfg.act)).to(x.dtype)


def decode_train(params: EncDecParams, tokens: torch.Tensor, memory, cfg,
                 impl: str = "xla") -> torch.Tensor:
    """tokens (B, S) against the encoder memory → final-normed hidden
    states (B, S, D)."""
    x = params.embed[tokens].to(torch_dtype(cfg.dtype))
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for l in range(cfg.num_layers):
        x = _dec_block(x, common.layer_at(params.dec_layers, l), memory, cfg,
                       positions, impl)
    return common.rms_norm(x, params.final_norm, cfg.norm_eps)


def _logits(params: EncDecParams, hidden: torch.Tensor, cfg):
    return common.unembed(hidden, params.embed, cfg.logit_softcap,
                          real_vocab=cfg.vocab_size)


def loss_fn(params: EncDecParams, batch: Dict[str, torch.Tensor], cfg,
            impl: str = "xla") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (masked by ``batch["mask"]``), conditioned on
    ``batch["frames"]``."""
    memory = encode(params, batch["frames"], cfg, impl=impl)
    hidden = decode_train(params, batch["tokens"], memory, cfg, impl=impl)
    loss = common.cross_entropy_loss(_logits(params, hidden, cfg),
                                     batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


def prefill(params: EncDecParams, batch: Dict[str, torch.Tensor], cfg,
            impl: str = "xla") -> torch.Tensor:
    """Last-position logits (B, V) of ``batch["tokens"]`` conditioned on
    ``batch["frames"]``."""
    memory = encode(params, batch["frames"], cfg, impl=impl)
    hidden = decode_train(params, batch["tokens"], memory, cfg, impl=impl)
    return _logits(params, hidden[:, -1:, :], cfg)[:, 0, :]


# ---------------------------------------------------------------------------
# Decode with a cache: self-attention KV cache + projected memory K/V
# ---------------------------------------------------------------------------

class EncDecCache(NamedTuple):
    k: torch.Tensor                   # (Ld, B, S_max, Hkv, Dh) self-attn
    v: torch.Tensor
    mem_k: torch.Tensor               # (Ld, B, S_enc, Hkv, Dh) memory K/V
    mem_v: torch.Tensor
    mem_len: torch.Tensor             # (B,) int64 valid memory rows a slot
    pos: torch.Tensor                 # (B,) int64 per-slot next write


def init_cache(cfg, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> EncDecCache:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    mshape = (cfg.num_layers, batch, cfg.frontend_len, cfg.num_kv_heads,
              cfg.resolved_head_dim)

    def zeros(s):
        return torch.zeros(s, dtype=dtype, device=device)

    return EncDecCache(
        k=zeros(shape), v=zeros(shape), mem_k=zeros(mshape),
        mem_v=zeros(mshape),
        # every row valid by default: zero memory under a full mask attends
        # uniformly over zero V rows, which gives exactly zero
        mem_len=torch.full((batch,), cfg.frontend_len, dtype=torch.int64,
                           device=device),
        pos=torch.zeros((batch,), dtype=torch.int64, device=device))


def project_memory_kv(params: EncDecParams, memory: torch.Tensor, cfg):
    """Each decoder layer's cross-attention K/V of an encoder memory
    (B, S, D): a pair of (Ld, B, S, Hkv, Dh), the one projection every
    memory-filling path shares."""
    kms, vms = [], []
    for l in range(cfg.num_layers):
        lp = common.layer_at(params.dec_layers, l)
        kms.append(common.dense_apply(memory, lp.cross_attn.wk))
        vms.append(common.dense_apply(memory, lp.cross_attn.wv))
    return torch.stack(kms), torch.stack(vms)


def precompute_memory_cache(params: EncDecParams, memory: torch.Tensor, cfg,
                            cache: EncDecCache) -> EncDecCache:
    """The cache with its memory rows replaced by ``memory``'s projected
    K/V (every row valid)."""
    km, vm = project_memory_kv(params, memory, cfg)
    return cache._replace(
        mem_k=km.to(cache.mem_k.dtype), mem_v=vm.to(cache.mem_v.dtype),
        mem_len=torch.full((memory.shape[0],), memory.shape[1],
                           dtype=torch.int64, device=memory.device))


def encode_memory(params: EncDecParams, src_tokens: torch.Tensor, cfg):
    """Source tokens (B, S_src) → the per-layer memory K/V pair, each
    (Ld, B, S_src, Hkv, Dh): the tokens embed through the tied decoder
    table (the frontend stub) and run the encoder."""
    frames = params.embed[src_tokens].to(torch_dtype(cfg.dtype))
    return project_memory_kv(params, encode(params, frames, cfg), cfg)


def populate_memory(params: EncDecParams, cache: EncDecCache,
                    src_tokens: torch.Tensor, cfg) -> EncDecCache:
    """Every row encodes its own source (a uniform batch, ``generate``);
    rows past S_src keep their zeros and are masked by ``mem_len``.  The
    cache's memory leaves are written in place."""
    km, vm = encode_memory(params, src_tokens, cfg)
    s = km.shape[2]
    cache.mem_k[:, :, :s] = km.to(cache.mem_k.dtype)
    cache.mem_v[:, :, :s] = vm.to(cache.mem_v.dtype)
    cache.mem_len.fill_(s)
    return cache


def admit_memory(params: EncDecParams, cache: EncDecCache, slot: int,
                 src_tokens: torch.Tensor, cfg) -> EncDecCache:
    """One slot's encoder memory at admission: encode the request's source
    (S_src,) as a batch of one and write only that slot's memory rows and
    ``mem_len``, in place (the engine zeroes the slot first)."""
    km, vm = encode_memory(params, src_tokens[None, :], cfg)
    s = km.shape[2]
    cache.mem_k[:, slot, :s] = km[:, 0].to(cache.mem_k.dtype)
    cache.mem_v[:, slot, :s] = vm[:, 0].to(cache.mem_v.dtype)
    cache.mem_len[slot].fill_(s)
    return cache


def decode_step(params: EncDecParams, cache: EncDecCache,
                tokens: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, EncDecCache]:
    """One token per slot in (B, 1), logits (B, V) out; the self-attention
    cache rows at ``cache.pos`` are written in place."""
    x = params.embed[tokens].to(torch_dtype(cfg.dtype))
    b = x.shape[0]
    pos = cache.pos
    positions = pos.reshape(-1, 1).expand(b, 1)
    for l in range(cfg.num_layers):
        lp = common.layer_at(params.dec_layers, l)
        h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
        q, k_new, v_new = attn.qkv_project(h, lp.self_attn, cfg, positions)
        k_c, v_c = attn.cache_update(cache.k[l], cache.v[l], k_new, v_new,
                                     pos)
        o = attn.decode_attend(q, k_c, v_c, pos, cfg)
        x = x + common.dense_apply(o, lp.self_attn.wo, in_ndim=2)
        h = common.rms_norm(x, lp.ln_x, cfg.norm_eps)
        q = common.dense_apply(h, lp.cross_attn.wq)
        o = attn.cross_attend(q, cache.mem_k[l], cache.mem_v[l], cfg,
                              mem_len=cache.mem_len)
        x = x + common.dense_apply(o, lp.cross_attn.wo, in_ndim=2)
        h = common.rms_norm(x, lp.ln2, cfg.norm_eps)
        x = (x + mlp_mod.mlp_apply(h, lp.mlp, cfg.act)).to(x.dtype)
    hidden = common.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = _logits(params, hidden, cfg)
    return logits[:, 0, :], cache._replace(pos=pos + 1)


# TT-native serving rules: every encoder and decoder matmul weight (self-
# and cross-attention projections, both MLP stacks) serves from its cores.
common.register_tt_serve_rules("encdec", [
    common.TTServeRule(r"^enc_layers\.attn\.w[qkv]$", in_ndim=1),
    common.TTServeRule(r"^enc_layers\.attn\.wo$", in_ndim=2),
    common.TTServeRule(r"^enc_layers\.mlp\.w_(gate|up|down)$", in_ndim=1),
    common.TTServeRule(r"^dec_layers\.(self|cross)_attn\.w[qkv]$",
                       in_ndim=1),
    common.TTServeRule(r"^dec_layers\.(self|cross)_attn\.wo$", in_ndim=2),
    common.TTServeRule(r"^dec_layers\.mlp\.w_(gate|up|down)$", in_ndim=1),
])
