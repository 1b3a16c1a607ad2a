"""MLP blocks: the gated (SwiGLU/GeGLU) dense FFN and the MoE block — port
of the JAX ``models/mlp.py``.

MoE routes each token to its top-k experts with a static per-expert
capacity, gathers the tokens into per-expert buffers, runs the expert FFN
on the whole bank (``common.expert_apply``: one einsum for a raw bank, one
expert-batched TT chain for a TT-native one) and combines the outputs with
the renormalized router weights.  The reference's TPU-mesh branches
(``moe_apply_a2a``, the ``opt_moe_ep`` layout pins) and the training-side
``router_aux_stats`` are not ported (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import torch_dtype
from repro_torch.models import common


class MLPParams(NamedTuple):
    w_gate: torch.Tensor          # (D, F)
    w_up: torch.Tensor            # (D, F)
    w_down: torch.Tensor          # (F, D)


def _stacked(gen, shape, in_axis, dt, layers, device):
    return torch.stack([common.dense_init(gen, shape, in_axis, dt, device)
                        for _ in range(layers)])


def init_mlp(gen: torch.Generator, cfg, layers: int, device) -> MLPParams:
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)

    def mk(shape):
        return _stacked(gen, shape, 0, dt, layers, device)

    return MLPParams(w_gate=mk((d, f)), w_up=mk((d, f)), w_down=mk((f, d)))


def mlp_apply(x: torch.Tensor, p: MLPParams, act: str) -> torch.Tensor:
    """Gated FFN; every weight goes through ``common.dense_apply``."""
    g = common.activate(common.dense_apply(x, p.w_gate), act)
    u = common.dense_apply(x, p.w_up)
    return common.dense_apply(g * u, p.w_down)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

class MoEParams(NamedTuple):
    router: torch.Tensor          # (D, E)
    w_gate: torch.Tensor          # (E, D, F)
    w_up: torch.Tensor            # (E, D, F)
    w_down: torch.Tensor          # (E, F, D)


def init_moe(gen: torch.Generator, cfg, layers: int, device) -> MoEParams:
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff
    dt = torch_dtype(cfg.dtype)

    def mk(shape, in_axis):
        return _stacked(gen, shape, in_axis, dt, layers, device)

    return MoEParams(router=mk((d, e), 0), w_gate=mk((e, d, f), 1),
                     w_up=mk((e, d, f), 1), w_down=mk((e, f, d), 1))


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, descending,
    ties to the lower index as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order among ties; a stable descending sort does)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_and_fill(xf: torch.Tensor, router, e: int, k: int, cap: int,
                    dtype: torch.dtype):
    """Router, slot assignment, and the scatter into per-expert buffers.

    xf (n, d) tokens.  Returns buf (e·cap, d), slot (n·k,), keep (n·k,)
    and the renormalized top-k probabilities topk_p (n, k)."""
    n, d = xf.shape
    logits = common.dense_apply(xf.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_e = _top_k(probs, k)                     # (n, k)
    topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)

    # each (token, k) pair's rank among the pairs routed to its expert;
    # capacity drops the pairs ranked cap and later
    flat_e = topk_e.reshape(-1)                           # (n·k,)
    order = torch.argsort(flat_e, stable=True)            # group by expert
    grouped = flat_e[order]
    ranks_sorted = (torch.arange(n * k, device=xf.device)
                    - torch.searchsorted(grouped, grouped, right=False))
    rank = ranks_sorted[torch.argsort(order)]
    keep = rank < cap
    slot = flat_e * cap + torch.clamp(rank, max=cap - 1)

    # a dropped pair adds zero into the slot of a kept one: index_add_, not
    # an assignment that could overwrite it (adding 0.0 is exact)
    src = xf.repeat_interleave(k, dim=0)
    buf = torch.zeros((e * cap, d), dtype=dtype, device=xf.device)
    buf.index_add_(0, slot, torch.where(keep[:, None], src,
                                        torch.zeros_like(src)).to(dtype))
    return buf, slot, keep, topk_p


def moe_apply(x: torch.Tensor, p: MoEParams, cfg,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """Top-k routing with static per-expert capacity; x (B, S, D) → the
    combined expert outputs (B, S, D).

    Capacity couples the batch rows, as in the reference: a token's rank
    among the tokens routed to an expert, and so whether it is dropped,
    depends on the other rows of the batch (at decode B = 4 with 64
    experts, top-8, the capacity is one token per expert)."""
    b, s, d = x.shape
    e = cfg.moe.num_experts
    k = cfg.moe.num_experts_per_tok
    n = b * s
    cap = int(np.ceil(n * k / e * capacity_factor))
    cap = max(min(cap, n), 1)

    xf = x.reshape(n, d)
    buf, slot, keep, topk_p = _route_and_fill(xf, p.router, e, k, cap,
                                              x.dtype)
    h = buf.reshape(e, cap, d)
    g = common.activate(common.expert_apply(h, p.w_gate), cfg.act)
    u = common.expert_apply(h, p.w_up)
    out = common.expert_apply(g * u, p.w_down).reshape(e * cap, d)

    per_slot = out[slot]                                  # (n·k, d)
    w = (topk_p.reshape(-1) * keep).float()[:, None]
    combined = (per_slot.float() * w).reshape(n, k, d).sum(1)
    return combined.reshape(b, s, d).to(x.dtype)
