"""Serve-shape step builders — port of ``make_prefill_step`` and
``make_eval_step`` of the JAX package's ``train/steps.py``.  The train step
and its optimizer come with a later slice (ROADMAP queue 1, item 9).

Each step runs under ``torch.inference_mode``: no autograd state is kept.
"""

from __future__ import annotations

from typing import Callable

import torch


def make_prefill_step(model, impl: str = "xla") -> Callable:
    """prefill_step(params, batch) -> last-position logits (B, V)."""
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch, impl=impl)
    return prefill_step


def make_eval_step(model, impl: str = "xla") -> Callable:
    """eval_step(params, batch) -> metrics ({"loss": ...})."""
    def eval_step(params, batch):
        with torch.inference_mode():
            _, metrics = model.loss_fn(params, batch, impl=impl)
        return metrics
    return eval_step
