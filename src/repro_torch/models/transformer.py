"""Decoder-only transformer LM, dense and MoE families: init, the
whole-sequence ``forward`` (``prefill``, ``loss_fn``), KV cache and the
single-token ``decode_step`` — port of the JAX ``models/transformer.py``.
A layer's FFN is the gated MLP (dense) or the MoE block (``cfg.moe`` set).
Layers run as a Python loop over the stacked params (``common.layer_at``):
TT leaves select their lead row (an expert bank its (E, r_s) lead block),
and their cores stay shared by every layer.

The reference scans the layers with ``is_global`` as scan input, so the flag
reaches ``causal_attend`` as a tracer and ``impl="pallas"`` never takes the
flash kernel in these families (ROADMAP queue 3, item 7).  ``forward``
mirrors that by passing the flag as a tensor: both impls run the plain
chunked attention path.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import mlp as mlp_mod


class LayerParams(NamedTuple):
    attn: attn.AttnParams
    mlp: Optional[mlp_mod.MLPParams]      # dense family
    moe: Optional[mlp_mod.MoEParams]      # MoE family
    ln1: torch.Tensor
    ln2: torch.Tensor


class TransformerParams(NamedTuple):
    embed: torch.Tensor                   # (V, D)
    layers: LayerParams                   # stacked (L, ...)
    final_norm: torch.Tensor              # (D,)
    lm_head: Optional[torch.Tensor]       # (V, D) when untied


def init(seed: int, cfg, device) -> TransformerParams:
    """Random weights from ``seed`` on ``device`` (a ``torch.Generator`` on
    that device makes every draw)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    l = cfg.num_layers
    dt = torch_dtype(cfg.dtype)
    layers = LayerParams(
        attn=attn.init_attn(gen, cfg, l, device),
        mlp=None if cfg.moe else mlp_mod.init_mlp(gen, cfg, l, device),
        moe=mlp_mod.init_moe(gen, cfg, l, device) if cfg.moe else None,
        ln1=torch.zeros((l, cfg.d_model), dtype=dt, device=device),
        ln2=torch.zeros((l, cfg.d_model), dtype=dt, device=device),
    )
    vocab_shape = (cfg.padded_vocab_size, cfg.d_model)
    return TransformerParams(
        embed=common.embed_init(gen, vocab_shape, dt, device),
        layers=layers,
        final_norm=torch.zeros((cfg.d_model,), dtype=dt, device=device),
        lm_head=(None if cfg.tie_embeddings
                 else common.embed_init(gen, vocab_shape, dt, device)),
    )


def _layer_flags(cfg) -> list:
    """Per-layer is_global flag: every ``global_every``-th layer is global,
    all-global when no window is configured."""
    if cfg.window is None or cfg.global_every is None:
        return [True] * cfg.num_layers
    return [(i + 1) % cfg.global_every == 0 for i in range(cfg.num_layers)]


def _scaled_embed(cfg) -> bool:
    """The reference scales a dense gemma model's embedding by √d_model."""
    return cfg.family == "dense" and cfg.name.startswith("gemma")


def _block(x, lp: LayerParams, is_global: torch.Tensor, cfg, positions,
           impl: str):
    h = common.rms_norm(x, lp.ln1, cfg.norm_eps)
    q, k, v = attn.qkv_project(h, lp.attn, cfg, positions)
    o = attn.causal_attend(q, k, v, cfg, window=cfg.window,
                           is_global=is_global, impl=impl)
    x = x + common.dense_apply(o, lp.attn.wo, in_ndim=2)
    h = common.rms_norm(x, lp.ln2, cfg.norm_eps)
    if cfg.moe is not None:
        f = mlp_mod.moe_apply(h, lp.moe, cfg)
    else:
        f = mlp_mod.mlp_apply(h, lp.mlp, cfg.act)
    return (x + f).to(x.dtype)


def forward(params: TransformerParams, tokens: torch.Tensor, cfg,
            prefix_embeds: Optional[torch.Tensor] = None,
            impl: str = "xla") -> torch.Tensor:
    """tokens (B, S) → final-normed hidden states (B, P + S, D), the
    frontend's precomputed ``prefix_embeds`` (B, P, D) first."""
    x = common.embed_tokens(params.embed, tokens, cfg, _scaled_embed(cfg))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for l, is_global in enumerate(_layer_flags(cfg)):
        # a tensor flag, as the reference's scanned one is a tracer
        flag = torch.tensor(is_global, device=x.device)
        x = _block(x, common.layer_at(params.layers, l), flag, cfg,
                   positions, impl)
    return common.rms_norm(x, params.final_norm, cfg.norm_eps)


class DecodeCache(NamedTuple):
    k: torch.Tensor                       # (L, B, S_max, Hkv, Dh)
    v: torch.Tensor
    pos: torch.Tensor                     # (B,) int64 — per-slot next write


def init_cache(cfg, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> DecodeCache:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return DecodeCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.zeros((batch,), dtype=torch.int64, device=device),
    )


def logits_fn(params: TransformerParams, hidden: torch.Tensor, cfg):
    table = params.lm_head if params.lm_head is not None else params.embed
    return common.unembed(hidden, table, cfg.logit_softcap,
                          real_vocab=cfg.vocab_size)


def loss_fn(params: TransformerParams, batch: Dict[str, torch.Tensor], cfg,
            impl: str = "xla") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy over ``batch["labels"]`` (masked by
    ``batch["mask"]``); the prefix positions carry no loss."""
    prefix = batch.get("prefix_embeds")
    hidden = forward(params, batch["tokens"], cfg, prefix_embeds=prefix,
                     impl=impl)
    if prefix is not None:
        hidden = hidden[:, prefix.shape[1]:, :]
    logits = logits_fn(params, hidden, cfg)
    loss = common.cross_entropy_loss(logits, batch["labels"],
                                     batch.get("mask"))
    return loss, {"loss": loss}


def prefill(params: TransformerParams, tokens: torch.Tensor, cfg,
            prefix_embeds: Optional[torch.Tensor] = None,
            impl: str = "xla") -> torch.Tensor:
    """Last-position logits (B, V) of the whole prompt (the reference's
    prefill fills no cache either: its cost is the forward)."""
    hidden = forward(params, tokens, cfg, prefix_embeds=prefix_embeds,
                     impl=impl)
    return logits_fn(params, hidden[:, -1:, :], cfg)[:, 0, :]


def decode_step(params: TransformerParams, cache: DecodeCache,
                tokens: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, DecodeCache]:
    """One token per slot in (B, 1), logits (B, V) out; the cache rows at
    ``cache.pos`` are written in place."""
    x = common.embed_tokens(params.embed, tokens, cfg, _scaled_embed(cfg))
    b = x.shape[0]
    pos = cache.pos
    positions = pos.reshape(-1, 1).expand(b, 1)
    for l, is_global in enumerate(_layer_flags(cfg)):
        lp = common.layer_at(params.layers, l)
        hh = common.rms_norm(x, lp.ln1, cfg.norm_eps)
        q, k_new, v_new = attn.qkv_project(hh, lp.attn, cfg, positions)
        k_c, v_c = attn.cache_update(cache.k[l], cache.v[l], k_new, v_new,
                                     pos)
        o = attn.decode_attend(q, k_c, v_c, pos, cfg, window=cfg.window,
                               is_global=is_global)
        x = x + common.dense_apply(o, lp.attn.wo, in_ndim=2)
        hh = common.rms_norm(x, lp.ln2, cfg.norm_eps)
        if cfg.moe is not None:
            f = mlp_mod.moe_apply(hh, lp.moe, cfg)
        else:
            f = mlp_mod.mlp_apply(hh, lp.mlp, cfg.act)
        x = (x + f).to(x.dtype)
    hidden = common.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = logits_fn(params, hidden, cfg)
    return logits[:, 0, :], DecodeCache(k=cache.k, v=cache.v, pos=pos + 1)


# TT-native serving rules (registered beside the model, per family).  MoE
# expert banks (L, E, D, F) use stack=2, experts=1: both leading axes fold
# into the lead table, the expert mode stays a batch axis, served by the
# expert-batched chain through ``common.expert_apply``.
_TT_RULES = [
    common.TTServeRule(r"^layers\.attn\.w[qkv]$", in_ndim=1),
    common.TTServeRule(r"^layers\.attn\.wo$", in_ndim=2),
    common.TTServeRule(r"^layers\.mlp\.w_(gate|up|down)$", in_ndim=1),
    common.TTServeRule(r"^layers\.moe\.w_(gate|up|down)$", in_ndim=1,
                       stack=2, experts=1),
]
for _fam in ("dense", "moe"):
    common.register_tt_serve_rules(_fam, _TT_RULES)
