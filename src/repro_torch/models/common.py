"""Shared model machinery: building blocks, TT-serving registry, decode driver.

Port of the serving subset of the JAX package's ``models/common.py``:

  * building blocks — ``rms_norm``, ``apply_rope``, ``activate``,
    initializers, ``unembed``, ``cross_entropy_loss``, and ``dense_apply``
    / ``expert_apply``, the raw-vs-TT weight dispatch points every
    projection and every expert bank goes through;
  * TT-native serving — the per-family rule registry and
    ``tt_native_params``, plus ``layer_at`` (a layer's view of stacked
    params: TT leaves select their lead row, cores stay shared);
  * the greedy decode driver — ``GenState``/``gen_init``/``gen_step``: one
    step over every slot with prompt consumption, argmax and append all on
    the device, so a loop of steps never reads the device from the host.

Parameters are NamedTuples of tensors stacked on a leading layer axis.
The KV cache is updated in place (saves a copy of the cache per step).
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as _tree
from repro_torch.core import compression as _comp
from repro_torch.core import tt_linear as _ttl


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S)."""
    d = x.shape[-1]
    freqs = torch.from_numpy(
        np.asarray(rope_frequencies(d, theta), np.float32)).to(x.device)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    if act == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {act}")


def dense_apply(x: torch.Tensor, w, in_ndim: int = 1) -> torch.Tensor:
    """THE weight application point: ``w`` is a raw tensor of shape
    (*in_dims, *out_dims) or a ``TTLinear``, whose chain runs through the
    TT-contraction kernels without materializing the dense matrix.
    Mismatched dtypes promote, as the reference's dot does."""
    if _ttl.is_tt_linear(w):
        return _ttl.tt_apply(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.tensordot(x.to(dt), w.to(dt), dims=in_ndim)


def expert_apply(x: torch.Tensor, w) -> torch.Tensor:
    """Expert-banked weight application: x (E, C, IN) against w
    (E, IN, OUT), the MoE FFN's batched matmul.  A raw bank is one
    einsum (as the reference's, outside any kernel); an expert-axis
    ``TTLinear`` runs the whole bank as one expert-batched chain
    (``tt_apply_experts``)."""
    if _ttl.is_tt_linear(w):
        return _ttl.tt_apply_experts(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum("eci,eio->eco", x.to(dt), w.to(dt))


# ---------------------------------------------------------------------------
# TT-native serving: per-family rule registry
# ---------------------------------------------------------------------------

class TTServeRule(NamedTuple):
    """One eligible-weight pattern: regex over the dot path of the weight,
    the matmul input axes after the stack axes, the stack axes, and how
    many trailing stack axes form an expert bank (kept as a batch axis at
    apply time and served by the expert-batched chain)."""
    pattern: "re.Pattern[str]"
    in_ndim: int
    stack: int = 1
    experts: int = 0


_TT_SERVE_REGISTRY: dict = {}


def register_tt_serve_rules(family: str, rules) -> None:
    compiled = []
    for r in rules:
        if not isinstance(r, TTServeRule):
            r = TTServeRule(*r)
        if isinstance(r.pattern, str):
            r = r._replace(pattern=re.compile(r.pattern))
        compiled.append(r)
    _TT_SERVE_REGISTRY[family] = tuple(compiled)


def tt_serve_rules(family: Optional[str] = None):
    """Rules for one family, or the union over every registered family."""
    from repro_torch.models import registry as _registry  # noqa: F401
    # (importing the registry imports the model modules, which register)
    if family is not None:
        return _TT_SERVE_REGISTRY.get(family, ())
    out = []
    for fam in sorted(_TT_SERVE_REGISTRY):
        out.extend(_TT_SERVE_REGISTRY[fam])
    return tuple(out)


def layer_at(layers, idx: int):
    """Layer ``idx``'s params from a stacked tree (clamped, as the
    reference pins): raw leaves index their first axis, TT leaves select
    their lead row."""
    def sel(leaf):
        if _ttl.is_tt_linear(leaf):
            return _ttl.select_layer(leaf, idx)
        return leaf[min(max(int(idx), 0), leaf.shape[0] - 1)]
    return _tree.map_leaves(sel, layers, is_leaf=_ttl.is_tt_linear)


def tt_native_params(compressed, core_dtype=None, family: Optional[str] = None,
                     quant: Optional[str] = None, quant_calib: str = "absmax"):
    """Compressor payload → TT-native serving params.

    Weights matching the family's rules become ``TTLinear`` leaves served
    straight from cores; everything else is reconstructed.  ``core_dtype``
    None stores each leaf's cores in its original weight dtype.  ``quant``
    ("int8") quantizes every TTLinear leaf after conversion."""
    rules = tt_serve_rules(family)
    qdt = None if quant is None else _ttl.quant_dtype(quant)

    def one(name, c):
        leaf = None
        if _comp.is_compressed_param(c) and c.kind == "tt" \
                and c.crop_dims is None:
            for rule in rules:
                if rule.pattern.search(name):
                    leaf = _ttl.tt_linear_from_tt(
                        c.tt, c.orig_shape, stack=rule.stack,
                        in_ndim=rule.in_ndim, dtype=c.orig_dtype,
                        core_dtype=(c.orig_dtype if core_dtype is None
                                    else core_dtype),
                        experts=rule.experts)
                    break
        if leaf is None:
            return _comp.decompress_param(c) if _comp.is_compressed_param(c) else c
        if qdt is not None:
            leaf = _ttl.quantize_tt(leaf, dtype=qdt, calib=quant_calib)
        return leaf

    return _tree.map_with_path(one, compressed,
                               is_leaf=_comp.is_compressed_param)


def logit_parity(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[float, float, float]:
    """(max|a−b|, |b| scale, argmax agreement).  The accepted bound for
    same-cores comparisons is ``max_diff <= max(0.05 * scale, 1e-3)``."""
    a = torch.as_tensor(a).float()
    b = torch.as_tensor(b).float().to(a.device)
    d = float((a - b).abs().max())
    scale = float(b.abs().max()) + 1e-9
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    return d, scale, agree


def parity_bound(scale: float) -> float:
    return max(0.05 * scale, 1e-3)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    """Scaled-normal init truncated at 3σ, σ = 1/√fan_in."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * shape[in_axis] ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16,
               device="cpu") -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * 0.02).to(dtype)


def unembed(x: torch.Tensor, embed: torch.Tensor,
            softcap: Optional[float] = None,
            real_vocab: Optional[int] = None) -> torch.Tensor:
    """Logits = x @ Eᵀ in f32, optional tanh softcap; with a padded table
    (``real_vocab`` < rows) the padding rows' logits are -1e30."""
    logits = torch.einsum("...d,vd->...v", x.float(), embed.float())
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    if real_vocab is not None and real_vocab < embed.shape[0]:
        logits[..., real_vocab:] = -1e30
    return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token negative log-likelihood in f32: logits (B, S, V), labels
    (B, S); with ``mask`` the mean over the masked-in tokens."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(lp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Greedy decode driver
# ---------------------------------------------------------------------------

class GenState(NamedTuple):
    """Per-slot generation state.

    tokens        (B, T_max) prompt tokens up front, generated tokens
                  appended at each slot's position;
    prompt_len    (B,) per-slot prompt length;
    total_len     (B,) per-slot prompt_len + gen budget;
    active        (B,) slots still consuming/producing;
    prompt_logits (B, V) f32 logits after each slot's last prompt token.
    """
    cache: object
    tokens: torch.Tensor
    prompt_len: torch.Tensor
    total_len: torch.Tensor
    active: torch.Tensor
    prompt_logits: torch.Tensor


def gen_init(cache, tokens, prompt_len, total_len, vocab: int,
             active=None) -> GenState:
    tokens = torch.as_tensor(tokens, dtype=torch.int64)
    dev = tokens.device
    b = tokens.shape[0]

    def per_slot(v, dtype):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(b).clone()

    return GenState(
        cache=cache, tokens=tokens,
        prompt_len=per_slot(prompt_len, torch.int64),
        total_len=per_slot(total_len, torch.int64),
        active=per_slot(True if active is None else active, torch.bool),
        prompt_logits=torch.zeros((b, vocab), dtype=torch.float32,
                                  device=dev),
    )


def gen_step(decode_step, params, state: GenState) -> GenState:
    """One greedy decode step over every slot.

    A slot at position p consumes tokens[p] (a prompt token while
    p < prompt_len, its own previous sample after) and writes the argmax
    for p+1.  Inactive slots keep their cache position.  Every update is a
    masked select on the device."""
    cache = state.cache
    pos = cache.pos
    t_max = state.tokens.shape[1]
    cur = torch.gather(state.tokens, 1, pos.clamp(0, t_max - 1)[:, None])
    logits, cache = decode_step(params, cache, cur)
    adv = state.active
    cache = cache._replace(pos=torch.where(adv, cache.pos, pos))
    newpos = cache.pos
    nxt = logits.argmax(dim=-1)
    widx = newpos.clamp(0, t_max - 1)
    write = adv & (newpos >= state.prompt_len) & (newpos < state.total_len)
    bidx = torch.arange(state.tokens.shape[0], device=pos.device)
    tokens = state.tokens.clone()
    tokens[bidx, widx] = torch.where(write, nxt, state.tokens[bidx, widx])
    at_prompt_end = adv & (pos == state.prompt_len - 1)
    prompt_logits = torch.where(at_prompt_end[:, None], logits.float(),
                                state.prompt_logits)
    active = adv & (newpos <= state.total_len - 2)
    return state._replace(cache=cache, tokens=tokens, active=active,
                          prompt_logits=prompt_logits)
