"""Model API of the port: ``build(cfg, device)`` returns a ``Model`` with

  init(seed) -> params
  init_cache(batch, max_len) -> cache
  decode_step(params, cache, tokens) -> (logits, cache)

for ``family="dense"``; the other families come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    init_cache: Callable
    decode_step: Callable


def _build_transformer(cfg: ModelConfig, device: torch.device) -> Model:
    return Model(
        cfg=cfg, device=device,
        init=lambda seed: tfm.init(seed, cfg, device),
        # bf16 cache whatever the weights' dtype, as the reference's
        init_cache=lambda batch, max_len: tfm.init_cache(
            cfg, batch, max_len, device),
        decode_step=lambda p, c, t: tfm.decode_step(p, c, t, cfg),
    )


_BUILDERS = {"dense": _build_transformer}


def build(cfg: ModelConfig, device=None) -> Model:
    """``device`` None means CUDA (raises without a card)."""
    try:
        builder = _BUILDERS[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1)"
        ) from None
    return builder(cfg, resolve_device(device))
