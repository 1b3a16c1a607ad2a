"""Model API of the port: ``build(cfg, device)`` returns a ``Model`` with

  init(seed) -> params
  prefill(params, batch, impl) -> last-position logits   [prefill shapes]
  loss_fn(params, batch, impl) -> (loss, metrics)        [train shapes]
  init_cache(batch, max_len) -> cache
  decode_step(params, cache, tokens) -> (logits, cache)

for the dense, MoE, SSM, hybrid and encoder-decoder families (the SSM
family has no attention: ``impl`` changes nothing there).  ``impl`` is the
reference's: ``"xla"`` runs the plain attention path, ``"pallas"`` the
hand-written flash kernel where the reference's would (the hybrid family's
attention layers and the encoder-decoder's decoder self-attention; the
dense and MoE forward keep to the plain path under both, as the
reference's scanned layer flag does).  A dense or MoE batch may carry
``prefix_embeds`` (B, P, D), a frontend's embeddings put before the
tokens; an encoder-decoder batch carries ``frames`` (B, S_enc, D), the
encoder's input.

The encoder-decoder family also has the two encoder-memory hooks (None for
every other family, which takes token-only input):

  populate_memory(params, cache, src_tokens (B, S_src)) -> cache
  admit_memory(params, cache, slot, src_row (S_src,)) -> cache
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import transformer as tfm


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    prefill: Callable
    loss_fn: Callable
    init_cache: Callable
    decode_step: Callable
    # encoder-memory hooks (encdec only; the serving layer keys "does this
    # family take encoder input" off their presence)
    populate_memory: Optional[Callable] = None
    admit_memory: Optional[Callable] = None


def _build_transformer(cfg: ModelConfig, device: torch.device) -> Model:
    return Model(
        cfg=cfg, device=device,
        init=lambda seed: tfm.init(seed, cfg, device),
        prefill=lambda p, b, impl="xla": tfm.prefill(
            p, b["tokens"], cfg, prefix_embeds=b.get("prefix_embeds"),
            impl=impl),
        loss_fn=lambda p, b, impl="xla": tfm.loss_fn(p, b, cfg, impl=impl),
        # bf16 cache whatever the weights' dtype, as the reference's
        init_cache=lambda batch, max_len: tfm.init_cache(
            cfg, batch, max_len, device),
        decode_step=lambda p, c, t: tfm.decode_step(p, c, t, cfg),
    )


def _build_mamba(cfg: ModelConfig, device: torch.device) -> Model:
    return Model(
        cfg=cfg, device=device,
        init=lambda seed: mamba_mod.init(seed, cfg, device),
        prefill=lambda p, b, impl="xla": mamba_mod.prefill(
            p, b["tokens"], cfg, impl=impl),
        loss_fn=lambda p, b, impl="xla": mamba_mod.loss_fn(
            p, b, cfg, impl=impl),
        # bf16 conv history whatever the weights' dtype, as the reference's
        init_cache=lambda batch, max_len: mamba_mod.init_cache(
            cfg, batch, max_len, device),
        decode_step=lambda p, c, t: mamba_mod.decode_step(p, c, t, cfg),
    )


def _build_griffin(cfg: ModelConfig, device: torch.device) -> Model:
    return Model(
        cfg=cfg, device=device,
        init=lambda seed: rglru_mod.init(seed, cfg, device),
        prefill=lambda p, b, impl="xla": rglru_mod.prefill(
            p, b["tokens"], cfg, impl=impl),
        loss_fn=lambda p, b, impl="xla": rglru_mod.loss_fn(
            p, b, cfg, impl=impl),
        # bf16 cache whatever the weights' dtype, as the reference's
        init_cache=lambda batch, max_len: rglru_mod.init_cache(
            cfg, batch, max_len, device),
        decode_step=lambda p, c, t: rglru_mod.decode_step(p, c, t, cfg),
    )


def _build_encdec(cfg: ModelConfig, device: torch.device) -> Model:
    return Model(
        cfg=cfg, device=device,
        init=lambda seed: encdec_mod.init(seed, cfg, device),
        prefill=lambda p, b, impl="xla": encdec_mod.prefill(
            p, b, cfg, impl=impl),
        loss_fn=lambda p, b, impl="xla": encdec_mod.loss_fn(
            p, b, cfg, impl=impl),
        # bf16 cache whatever the weights' dtype, as the reference's
        init_cache=lambda batch, max_len: encdec_mod.init_cache(
            cfg, batch, max_len, device),
        decode_step=lambda p, c, t: encdec_mod.decode_step(p, c, t, cfg),
        populate_memory=lambda p, c, s: encdec_mod.populate_memory(
            p, c, s, cfg),
        admit_memory=lambda p, c, i, s: encdec_mod.admit_memory(
            p, c, i, s, cfg),
    )


_BUILDERS = {"dense": _build_transformer, "moe": _build_transformer,
             "ssm": _build_mamba, "hybrid": _build_griffin,
             "encdec": _build_encdec}


def build(cfg: ModelConfig, device=None) -> Model:
    """``device`` None means CUDA (raises without a card)."""
    try:
        builder = _BUILDERS[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1)"
        ) from None
    return builder(cfg, resolve_device(device))
