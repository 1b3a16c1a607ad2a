"""Gated (SwiGLU/GeGLU) dense FFN — port of the JAX ``models/mlp.py``
dense part (the MoE block comes with its own slice)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import common


class MLPParams(NamedTuple):
    w_gate: torch.Tensor          # (D, F)
    w_up: torch.Tensor            # (D, F)
    w_down: torch.Tensor          # (F, D)


def init_mlp(gen: torch.Generator, cfg, layers: int, device) -> MLPParams:
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)

    def mk(shape):
        return torch.stack([common.dense_init(gen, shape, 0, dt, device)
                            for _ in range(layers)])

    return MLPParams(w_gate=mk((d, f)), w_up=mk((d, f)), w_down=mk((f, d)))


def mlp_apply(x: torch.Tensor, p: MLPParams, act: str) -> torch.Tensor:
    """Gated FFN; every weight goes through ``common.dense_apply``."""
    g = common.activate(common.dense_apply(x, p.w_gate), act)
    u = common.dense_apply(x, p.w_up)
    return common.dense_apply(g * u, p.w_down)
