"""Shared model machinery: building blocks, TT-serving registry, decode driver.

Port of the serving subset of the JAX package's ``models/common.py``:

  * building blocks — ``rms_norm``, ``apply_rope``, ``activate``,
    ``causal_conv``, initializers, ``embed_tokens``, ``unembed``,
    ``cross_entropy_loss``, and ``dense_apply``
    / ``expert_apply``, the raw-vs-TT weight dispatch points every
    projection and every expert bank goes through;
  * TT-native serving — the per-family rule registry and
    ``tt_native_params``, plus ``layer_at`` (a layer's view of stacked
    params: TT leaves select their lead row, cores stay shared);
  * the decode driver — ``GenState``/``gen_init``/``gen_step``/``gen_scan``:
    one step over every slot with prompt consumption, sampling (greedy, or
    temperature/top-k under per-slot threefry streams, ``repro_torch.prng``)
    and append all on the device, so a loop of steps never reads the device
    from the host; plus the slot machinery the continuous-batching engine
    schedules with: per-slot sampling params, the device queue requests are
    admitted from (``ScanQueue``), the retired-slot buffer (``DoneBuf``) and
    the NaN/Inf guard.

Parameters are NamedTuples of tensors stacked on a leading layer axis.
The KV cache is updated in place (saves a copy of the cache per step).
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch import tree as _tree
from repro_torch.core import compression as _comp
from repro_torch.core import tt_linear as _ttl
from repro_torch.device import torch_dtype


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


_ROPE_FREQS: dict = {}


def _rope_freqs(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` on ``device``, copied there once: a decode
    step makes no host-to-device copy (a copy would sync the host)."""
    key = (d, float(theta), str(device))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        freqs = _ROPE_FREQS[key] = torch.from_numpy(
            np.asarray(rope_frequencies(d, theta), np.float32)).to(device)
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S)."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)
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


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along axis 1 (the hybrid and SSM blocks'):
    x (B, S, C), w (W, C), b (C,).  The taps are summed in order in the
    promoted dtype of x and w, as the reference sums them."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + xp[:, i: i + s, :] * w[i]
    return out + b


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


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, cfg,
                 scaled: bool) -> torch.Tensor:
    """The rows of ``tokens`` in the activation dtype; ``scaled`` (the
    gemma models): times √d_model, the factor rounded to that dtype first,
    as the reference rounds it (bf16 at d_model 1,152: 34.0, not 33.94)."""
    x = table[tokens].to(torch_dtype(cfg.dtype))
    if scaled:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(x: torch.Tensor, embed: torch.Tensor,
            softcap: Optional[float] = None,
            real_vocab: Optional[int] = None) -> torch.Tensor:
    """Logits = x @ Eᵀ in f32, optional tanh softcap; with a padded table
    (``real_vocab`` < rows) the padding rows' logits are -1e30.

    x (B, 1, D), one position a row (decode, and prefill's last logits),
    takes one matrix-vector product a row: a product of B rows rounds other
    bits than one of a single row (cuBLAS and the CPU's BLAS choose their
    kernel by the row count), and a request's logits must not depend on the
    requests beside it, or near-tied tokens flip between a staggered and an
    isolated run (``attention._gqa_scores`` / ``_gqa_out`` do the same)."""
    if x.ndim == 3 and x.shape[1] == 1:
        table, rows = embed.float(), x[:, 0].float()
        logits = torch.stack([table @ rows[i] for i in range(x.shape[0])]
                             )[:, None, :]
    else:
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
# Decode driver: sampling, per-slot state, admission and harvest
# ---------------------------------------------------------------------------

class Sampling(NamedTuple):
    """Sampling configuration of the decode drivers.

    temperature — 0.0 selects the greedy argmax (no PRNG work at all); > 0
                  scales the logits by 1/temperature before categorical
                  sampling.
    top_k       — keep only the k highest logits before sampling (ties at
                  the k-th value are all kept); None disables the filter.
    per_slot    — ignore the two fields and sample each slot under its own
                  ``GenState.temp``/``GenState.topk`` (the per-request
                  params the engine writes at admission); slots with
                  ``temp == 0`` take the greedy argmax.
    """
    temperature: float = 0.0
    top_k: Optional[int] = None
    per_slot: bool = False


GREEDY = Sampling()
PER_SLOT = Sampling(per_slot=True)


def make_sampling(temperature: float, top_k: Optional[int]) -> Sampling:
    """Validated Sampling for the serving front doors: a negative
    temperature would sample an inverted distribution and ``top_k <= 0``
    keeps nothing, so both are refused here."""
    temperature = float(temperature)
    if temperature < 0.0:
        raise ValueError(
            f"temperature must be >= 0 (0 = greedy), got {temperature}")
    if top_k is not None:
        top_k = int(top_k)
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1 (or None), got {top_k}")
    return Sampling(temperature, top_k)


def slot_keys(seed: int, b: int, device=None) -> torch.Tensor:
    """Per-row base keys (b, 2) of a ``b``-row generation: row ``r`` gets
    ``fold_in(PRNGKey(seed), r)``.  The engine gives a request the row-0
    key of its own seed, so it samples the same stream isolated (batch row
    0) or in any slot."""
    rows = torch.arange(b, dtype=torch.int64, device=device)
    return prng.fold_in(prng.PRNGKey(seed, device=device), rows)


def _neg_mask(scaled: torch.Tensor, kth: torch.Tensor) -> torch.Tensor:
    return torch.where(scaled >= kth, scaled, -1e30)


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  sampling: Sampling) -> torch.Tensor:
    """Temperature/top-k sample one token per row (temperature > 0; greedy
    is the caller's branch).  logits (B, V) are divided by the temperature
    in float32, optionally top-k masked to -1e30 below the k-th largest
    value, then drawn by ``prng.categorical`` under each row's key."""
    assert sampling.temperature > 0.0, "greedy path must not sample"
    lf = logits.float()
    # a device tensor, not a scalar: CUDA turns x / scalar into x·(1/scalar)
    t = torch.full_like(lf[:, :1], sampling.temperature)
    scaled = lf / t
    if sampling.top_k is not None and sampling.top_k < lf.shape[-1]:
        kth = torch.topk(scaled, sampling.top_k, dim=-1).values[:, -1:]
        scaled = _neg_mask(scaled, kth)
    return prng.categorical(keys, scaled)


def sample_tokens_per_slot(logits: torch.Tensor, keys: torch.Tensor,
                           temperature: torch.Tensor,
                           top_k: torch.Tensor) -> torch.Tensor:
    """Per-slot sampling: slot ``i`` samples under ``(temperature[i],
    top_k[i])`` (``top_k == 0``: no filter) with the same scaling, k-th
    largest threshold (ties kept) and keys as ``sample_tokens``, so a
    request in a mixed pool draws what its isolated run draws; slots with
    ``temperature == 0`` take the argmax of the raw logits."""
    v = logits.shape[-1]
    lf = logits.float()
    greedy = lf.argmax(dim=-1)
    safe_t = torch.where(temperature > 0.0, temperature,
                         torch.ones_like(temperature))
    scaled = lf / safe_t[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, v).to(torch.int64)
    kth = torch.gather(srt, 1, (k - 1).clamp(0, v - 1)[:, None])
    sampled = prng.categorical(keys, _neg_mask(scaled, kth))
    return torch.where(temperature > 0.0, sampled, greedy)


class ScanQueue(NamedTuple):
    """The pending requests of one engine chunk, on the device.

    One row a request: tokens (Q, T_max) int64, prompt_len / total_len (Q,)
    int64, rng (Q, 2) int64 keys, temp (Q,) float32, topk (Q,) int64 — the
    values ``_scan_admit`` copies into a slot.  The host uploads the whole
    window once before the chunk and keeps the FIFO's head itself: it
    mirrors every admission (FIFO order, lowest free slot first), so the
    steps need no device read to know which row goes where.
    """
    tokens: torch.Tensor
    prompt_len: torch.Tensor
    total_len: torch.Tensor
    rng: torch.Tensor
    temp: torch.Tensor
    topk: torch.Tensor


class DoneBuf(NamedTuple):
    """Retired slots' output rows, written inside a chunk.

    A slot may retire and be admitted again within one chunk, so the step
    that retires it first copies its tokens, prompt logits and NaN/Inf flag
    here, at the row the host assigned (retirement order); the host reads
    the buffer once after the chunk."""
    tokens: torch.Tensor          # (D, T_max) int64
    prompt_logits: torch.Tensor   # (D, V) float32
    bad: torch.Tensor             # (D,) bool


def make_scan_queue(capacity: int, t_max: int, device) -> ScanQueue:
    """An empty device queue (every row a 1-token no-op)."""
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ScanQueue(
        tokens=z((capacity, t_max), torch.int64),
        prompt_len=torch.ones((capacity,), dtype=torch.int64, device=device),
        total_len=torch.ones((capacity,), dtype=torch.int64, device=device),
        rng=z((capacity, 2), torch.int64), temp=z((capacity,), torch.float32),
        topk=z((capacity,), torch.int64))


def make_done_buf(capacity: int, t_max: int, vocab: int, device) -> DoneBuf:
    """An empty retired-slot output buffer."""
    return DoneBuf(
        tokens=torch.zeros((capacity, t_max), dtype=torch.int64,
                           device=device),
        prompt_logits=torch.zeros((capacity, vocab), dtype=torch.float32,
                                  device=device),
        bad=torch.zeros((capacity,), dtype=torch.bool, device=device))


def zero_slot_leaf(leaf: torch.Tensor, i: int) -> torch.Tensor:
    """Zero slot ``i``'s rows of a cache leaf in place.  Convention (every
    family): the only 1-D leaves are the per-slot counters ``pos`` and the
    encoder-decoder's ``mem_len``; every other leaf stacks (L, B, ...) with
    the slot on axis 1 (``transformer.DecodeCache`` K/V,
    ``mamba2.MambaCache`` SSM state and conv history,
    ``rglru.GriffinCache`` state, conv history and ring,
    ``encdec.EncDecCache`` K/V and memory K/V).  Zeroing an encoder-decoder
    slot leaves ``mem_len`` at 0, every memory row masked: it decodes as
    the zeroed memory rows would (zero output), so a token-only request
    admitted after a request with a source never sees its memory;
    ``encdec.admit_memory`` then writes the rows and ``mem_len`` of a
    request that has a source."""
    # fill_, not ``leaf[i] = 0``: assigning a Python number copies it from
    # the host, which syncs
    if leaf.ndim == 1:
        leaf[i].fill_(0)
    else:
        leaf[:, i].fill_(0)
    return leaf


class GenState(NamedTuple):
    """Per-slot generation state.

    tokens        (B, T_max) prompt tokens up front, generated tokens
                  appended at each slot's position;
    prompt_len    (B,) per-slot prompt length;
    total_len     (B,) per-slot prompt_len + gen budget;
    active        (B,) slots still consuming/producing (free slots idle
                  with a frozen ``cache.pos``; their lockstep rows are
                  discarded);
    prompt_logits (B, V) f32 logits after each slot's last prompt token;
    rng           (B, 2) per-slot base keys.  Never changed by a step: the
                  key of a slot's t-th generated token is
                  ``fold_in(rng[slot], t)``, a function of the slot's own
                  progress, so a request samples alike isolated or in any
                  slot at any step;
    temp / topk   (B,) per-slot sampling params read under ``PER_SLOT``
                  (``topk == 0``: no filter); None on the uniform batch;
    queue / done  the engine's device queue and retired-slot buffer under
                  scan admission; None elsewhere;
    bad           (B,) NaN/Inf guard: set once a slot's logits go
                  non-finite, cleared at admission; the slot still retires
                  at its scheduled step (the host's schedule must not
                  depend on the values), and the flag leaves with its
                  tokens.  None on the uniform batch.
    """
    cache: object
    tokens: torch.Tensor
    prompt_len: torch.Tensor
    total_len: torch.Tensor
    active: torch.Tensor
    prompt_logits: torch.Tensor
    rng: torch.Tensor
    temp: Optional[torch.Tensor] = None
    topk: Optional[torch.Tensor] = None
    queue: Optional[ScanQueue] = None
    done: Optional[DoneBuf] = None
    bad: Optional[torch.Tensor] = None


def gen_init(cache, tokens, prompt_len, total_len, vocab: int,
             active=None, rng=None, temp=None, topk=None,
             queue: Optional[ScanQueue] = None,
             done: Optional[DoneBuf] = None, bad=None) -> GenState:
    """Pack a slot pool into a GenState (per-slot lengths may differ).
    ``temp``/``topk`` attach per-slot sampling params, ``queue``/``done``
    the scan-admission buffers, ``bad`` the NaN/Inf guard; the uniform
    batch of ``generate`` carries none of them."""
    tokens = torch.as_tensor(tokens, dtype=torch.int64)
    dev = tokens.device
    b = tokens.shape[0]

    def per_slot(v, dtype):
        if v is None:
            return None
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(b).clone()

    return GenState(
        cache=cache, tokens=tokens,
        prompt_len=per_slot(prompt_len, torch.int64),
        total_len=per_slot(total_len, torch.int64),
        active=per_slot(True if active is None else active, torch.bool),
        prompt_logits=torch.zeros((b, vocab), dtype=torch.float32,
                                  device=dev),
        rng=(torch.zeros((b, 2), dtype=torch.int64, device=dev) if rng is None
             else torch.as_tensor(rng, dtype=torch.int64, device=dev)),
        temp=per_slot(temp, torch.float32),
        topk=per_slot(topk, torch.int64),
        queue=queue, done=done, bad=per_slot(bad, torch.bool),
    )


def _scan_admit(state: GenState, admits) -> GenState:
    """Admit queue rows into free slots at the top of a step: for each
    ``(slot, row)`` of ``admits`` (host ints, mirrored by the engine) zero
    the slot's cache rows, copy the row's prompt, lengths, key and sampling
    params, clear its prompt logits and guard, and activate it; the slot
    consumes its first prompt token in this very step.  Device-to-device
    copies at host-known indices: no read of the device."""
    q = state.queue
    for i, j in admits:
        for leaf in _tree.leaves(state.cache):
            zero_slot_leaf(leaf, i)
        state.tokens[i] = q.tokens[j]
        state.prompt_len[i] = q.prompt_len[j]
        state.total_len[i] = q.total_len[j]
        state.rng[i] = q.rng[j]
        state.temp[i] = q.temp[j]
        state.topk[i] = q.topk[j]
        state.prompt_logits[i].fill_(0.0)
        state.active[i].fill_(True)
        state.bad[i].fill_(False)
    return state


def _scan_harvest(state: GenState, harvest) -> GenState:
    """Copy each ``(slot, row)`` of ``harvest`` — the slots this step
    retired, in slot order, at the done-buffer rows the host assigned —
    before a later admission can overwrite the slot."""
    d = state.done
    for i, w in harvest:
        d.tokens[w] = state.tokens[i]
        d.prompt_logits[w] = state.prompt_logits[i]
        d.bad[w] = state.bad[i]
    return state


def gen_step(decode_step, params, state: GenState,
             sampling: Sampling = GREEDY, admit=(), harvest=()) -> GenState:
    """One decode step over every slot.

    A slot at position p consumes tokens[p] (a prompt token while
    p < prompt_len, its own previous sample after) and writes the token
    for p+1: the argmax, or a sample under ``fold_in(rng[slot], t)`` for
    its t-th generated token (per-slot params under ``PER_SLOT``).
    Inactive slots keep their cache position.  Every update is a masked
    select on the device.  ``admit`` / ``harvest``: the ``(slot, row)``
    pairs of the engine's scan admission (``_scan_admit`` before the step,
    ``_scan_harvest`` after it)."""
    if admit:
        state = _scan_admit(state, admit)
    cache = state.cache
    pos = cache.pos
    t_max = state.tokens.shape[1]
    cur = torch.gather(state.tokens, 1, pos.clamp(0, t_max - 1)[:, None])
    logits, cache = decode_step(params, cache, cur)
    adv = state.active
    cache = cache._replace(pos=torch.where(adv, cache.pos, pos))
    newpos = cache.pos
    if sampling.per_slot or sampling.temperature > 0.0:
        keys = prng.fold_in(state.rng, (newpos - state.prompt_len).clamp(
            min=0))
        if sampling.per_slot:
            nxt = sample_tokens_per_slot(logits, keys, state.temp,
                                         state.topk)
        else:
            nxt = sample_tokens(logits, keys, sampling)
    else:
        nxt = logits.argmax(dim=-1)
    widx = newpos.clamp(0, t_max - 1)
    write = adv & (newpos >= state.prompt_len) & (newpos < state.total_len)
    bidx = torch.arange(state.tokens.shape[0], device=pos.device)
    tokens = state.tokens.clone()
    tokens[bidx, widx] = torch.where(write, nxt, state.tokens[bidx, widx])
    at_prompt_end = adv & (pos == state.prompt_len - 1)
    prompt_logits = torch.where(at_prompt_end[:, None], logits.float(),
                                state.prompt_logits)
    # the step that writes a slot's last token (index total_len-1) retires it
    active = adv & (newpos <= state.total_len - 2)
    bad = state.bad
    if bad is not None:
        bad = bad | (adv & ~torch.isfinite(logits.float()).all(dim=-1))
    state = state._replace(cache=cache, tokens=tokens, active=active,
                           prompt_logits=prompt_logits, bad=bad)
    if harvest:
        state = _scan_harvest(state, harvest)
    return state


def gen_scan(decode_step, params, state: GenState, n_steps: int,
             sampling: Sampling = GREEDY, schedule=None) -> GenState:
    """``n_steps`` decode steps; ``schedule[t]`` is step t's ``(admit,
    harvest)`` (scan admission), None for none."""
    for t in range(n_steps):
        admit, harvest = schedule[t] if schedule is not None else ((), ())
        state = gen_step(decode_step, params, state, sampling, admit,
                         harvest)
    return state
