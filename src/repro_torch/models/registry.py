"""Model API of the port: ``build(cfg, device)`` returns a ``Model`` with

  init(seed) -> params
  prefill(params, batch, impl) -> last-position logits   [prefill shapes]
  loss_fn(params, batch, impl) -> (loss, metrics)        [train shapes]
  init_cache(batch, max_len) -> cache
  decode_step(params, cache, tokens) -> (logits, cache)

for the dense and MoE families (decode only: their ``forward`` is a later
slice) and the hybrid family (all five).  ``impl`` is the reference's: ``"xla"`` runs
the plain attention path, ``"pallas"`` the hand-written flash kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
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


def _build_transformer(cfg: ModelConfig, device: torch.device) -> Model:
    def not_ported(*_args, **_kwargs):
        raise NotImplementedError(
            f"the {cfg.family} family's forward (prefill and loss) is not "
            f"ported yet (ROADMAP queue 1, item 7)")

    return Model(
        cfg=cfg, device=device,
        init=lambda seed: tfm.init(seed, cfg, device),
        prefill=not_ported, loss_fn=not_ported,
        # bf16 cache whatever the weights' dtype, as the reference's
        init_cache=lambda batch, max_len: tfm.init_cache(
            cfg, batch, max_len, device),
        decode_step=lambda p, c, t: tfm.decode_step(p, c, t, cfg),
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


_BUILDERS = {"dense": _build_transformer, "moe": _build_transformer,
             "hybrid": _build_griffin}


def build(cfg: ModelConfig, device=None) -> Model:
    """``device`` None means CUDA (raises without a card)."""
    try:
        builder = _BUILDERS[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1)"
        ) from None
    return builder(cfg, resolve_device(device))
