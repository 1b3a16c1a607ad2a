"""Mamba-2 (SSD — state-space duality) language model — port of the JAX
package's ``models/mamba2.py``.

Chunked SSD (Dao & Gu 2024): an intra-chunk quadratic "attention-like"
term plus an inter-chunk linear recurrence over chunk states; the scan
carries an (H, N, P) state a head, which is what makes decode O(1) in
sequence length.

Block structure (simplified n_groups=1 Mamba-2):
  in_proj → [z (gate) | x | B | C | dt] → causal depthwise conv on (x,B,C)
  → SiLU → SSD → RMSNorm(gated) → out_proj

Layers run as a Python loop over ``common.layer_at`` views, so TT leaves
(``w_in``, ``w_out``) select their lead row and share their cores.  The
decay rates ``a_log``, the skip ``d_skip`` and ``dt_bias`` stay float32 in
every dtype, as the reference keeps them; the SSD runs in float32.

Decode keeps, a layer, the SSM state and the last W-1 conv inputs
(``MambaCache``), updated in place.  The products of a decode step that
sum over a row's own elements (the conv taps, y = c · h) are taken one
batch row at a time or tap by tap, so a request's logits do not depend on
the requests beside it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.models import common


class MambaLayerParams(NamedTuple):
    w_in: torch.Tensor            # (D, 2*Di + 2*N + H)
    conv_w: torch.Tensor          # (W, Di + 2*N)  depthwise
    conv_b: torch.Tensor          # (Di + 2*N,)
    a_log: torch.Tensor           # (H,) float32 in every dtype
    d_skip: torch.Tensor          # (H,) float32
    dt_bias: torch.Tensor         # (H,) float32
    gate_norm: torch.Tensor       # (Di,)
    w_out: torch.Tensor           # (Di, D)
    ln: torch.Tensor              # (D,)


class MambaParams(NamedTuple):
    embed: torch.Tensor
    layers: MambaLayerParams      # stacked (L, ...)
    final_norm: torch.Tensor


def _dims(cfg):
    di = cfg.ssm.expand * cfg.d_model
    h = di // cfg.ssm.head_dim
    return di, h, cfg.ssm.state_dim, cfg.ssm.conv_width


def init(seed: int, cfg, device) -> MambaParams:
    """Random weights from ``seed`` on ``device``; ``dt_bias`` and
    ``a_log`` from the reference's fixed numpy draws."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model
    di, h, n, w = _dims(cfg)
    l = cfg.num_layers
    dt = torch_dtype(cfg.dtype)

    def per_layer(shape):
        return torch.stack([common.dense_init(gen, shape, 0, dt, device)
                            for _ in range(l)])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # dt bias ~ log-uniform dt init (the mamba convention)
    dt0 = np.exp(np.random.RandomState(0).uniform(
        np.log(1e-3), np.log(1e-1), (l, h))).astype(np.float32)
    a0 = np.random.RandomState(1).uniform(1.0, 16.0, (l, h)).astype(
        np.float32)
    conv_w = torch.randn((l, w, di + 2 * n), generator=gen, device=device)
    layers = MambaLayerParams(
        w_in=per_layer((d, 2 * di + 2 * n + h)),
        conv_w=(conv_w * 0.1).to(dt),
        conv_b=torch.zeros((l, di + 2 * n), dtype=dt, device=device),
        a_log=f32(np.log(a0)),
        d_skip=torch.ones((l, h), dtype=torch.float32, device=device),
        dt_bias=f32(np.log(np.expm1(dt0))),
        gate_norm=torch.zeros((l, di), dtype=dt, device=device),
        w_out=per_layer((di, d)),
        ln=torch.zeros((l, d), dtype=dt, device=device))
    return MambaParams(
        embed=common.embed_init(gen, (cfg.padded_vocab_size, d), dt, device),
        layers=layers,
        final_norm=torch.zeros((d,), dtype=dt, device=device))


def _split_proj(xz, cfg):
    """[z | x | B | C | dt] along the last axis (the reference splits at
    indices di, 2di, 2di+N, 2di+2N)."""
    di, h, n, _ = _dims(cfg)
    return torch.split(xz, [di, di, n, n, h], dim=-1)


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int) -> torch.Tensor:
    """Chunked SSD in float32: x (B, S, H, P), dt (B, S, H) positive, a
    (H,) negative decay rates, b_mat / c_mat (B, S, N) → y (B, S, H, P)
    for h_t = exp(a·dt_t) h_{t-1} + dt_t · b_t x_tᵀ, y_t = c_t · h_t.

    A tail of S % chunk rows is padded with zeros and cut from y
    (causality keeps the earlier rows exact).  Per chunk of Q rows, with
    cum the running sum of a·dt inside the chunk: the intra-chunk term
    Σ_j≤i exp(cum_i − cum_j) dt_j (c_i·b_j) x_j, and the state a chunk
    starts from (the scan emits the state *before* each chunk) read out
    as exp(cum_i) c_i · R.  Above the diagonal cum_i − cum_j is positive
    and its exp may overflow: it is masked by selection, never by a
    product with the mask (inf·0 is NaN)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if s % chunk:
        pad = chunk - s % chunk
        y = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                        F.pad(dt, (0, 0, 0, pad)), a,
                        F.pad(b_mat, (0, 0, 0, pad)),
                        F.pad(c_mat, (0, 0, 0, pad)), chunk)
        return y[:, :s]
    nc = s // chunk
    # heads ahead of the chunk rows: (B, nc, H, Q, ...) for the products
    xc = x.float().reshape(bsz, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    dtc = dt.float().reshape(bsz, nc, chunk, h).transpose(2, 3)
    bc = b_mat.float().reshape(bsz, nc, chunk, n)
    cc = c_mat.float().reshape(bsz, nc, chunk, n)
    cum = torch.cumsum(dtc * a.float()[:, None], dim=-1)     # (B,nc,H,Q)

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    l_mat = torch.where(causal, torch.exp(cum[..., :, None]
                                          - cum[..., None, :]), 0.0)
    cb = torch.matmul(cc, bc.transpose(-1, -2))              # (B,nc,Q,Q)
    mix = l_mat.mul_(cb[:, :, None]).mul_(dtc[..., None, :])  # (B,nc,H,Q,Q)
    y = torch.matmul(mix, xc)                                # (B,nc,H,Q,P)
    del l_mat, mix

    # chunk states: S_c = Σ_j exp(cum_Q - cum_j) dt_j b_j x_jᵀ
    w_end = torch.exp(cum[..., -1:] - cum) * dtc             # (B,nc,H,Q)
    sb = bc.transpose(-1, -2)[:, :, None] * w_end[..., None, :]
    s_chunk = torch.matmul(sb, xc)                           # (B,nc,H,N,P)
    del sb

    # inter-chunk recurrence; the state before chunk c is R_{c-1}
    chunk_decay = torch.exp(cum[..., -1])                    # (B,nc,H)
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + s_chunk[:, ci]
    prev_states = torch.stack(prev, 1)                       # (B,nc,H,N,P)

    # inter-chunk output: exp(cum_i) c_i · R_{c-1}
    y_inter = torch.matmul(cc[:, :, None], prev_states) \
        * torch.exp(cum)[..., None]
    y = y + y_inter
    return y.permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)


def _mamba_mixer(x, lp: MambaLayerParams, cfg):
    di, h, n, _ = _dims(cfg)
    p = cfg.ssm.head_dim
    xz = common.dense_apply(x, lp.w_in)
    z, xi, b, c, dt = _split_proj(xz, cfg)
    conv_in = torch.cat([xi, b, c], dim=-1)
    conv_out = F.silu(common.causal_conv(conv_in, lp.conv_w,
                                         lp.conv_b).float())
    xi, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    dtp = F.softplus(dt.float() + lp.dt_bias)
    a = -torch.exp(lp.a_log)
    xh = xi.reshape(*xi.shape[:2], h, p)
    y = ssd_chunked(xh, dtp, a, b, c, cfg.ssm.chunk)
    y = y + lp.d_skip[None, None, :, None] * xh
    y = y.reshape(*x.shape[:2], di)
    y = common.rms_norm((y * F.silu(z.float())).to(x.dtype), lp.gate_norm,
                        cfg.norm_eps)
    return common.dense_apply(y, lp.w_out)


def forward(params: MambaParams, tokens, cfg, impl: str = "xla"):
    """tokens (B, S) → final-normed hidden states (B, S, D).  ``impl`` is
    accepted for the Model API; the family has no attention."""
    x = params.embed[tokens].to(torch_dtype(cfg.dtype))
    for l in range(cfg.num_layers):
        lp = common.layer_at(params.layers, l)
        h2 = common.rms_norm(x, lp.ln, cfg.norm_eps)
        x = (x + _mamba_mixer(h2, lp, cfg)).to(x.dtype)
    return common.rms_norm(x, params.final_norm, cfg.norm_eps)


def loss_fn(params, batch, cfg, impl: str = "xla"):
    hidden = forward(params, batch["tokens"], cfg, impl=impl)
    logits = common.unembed(hidden, params.embed, cfg.logit_softcap,
                            real_vocab=cfg.vocab_size)
    loss = common.cross_entropy_loss(logits, batch["labels"],
                                     batch.get("mask"))
    return loss, {"loss": loss}


def prefill(params, tokens, cfg, impl: str = "xla"):
    """Last-position logits (B, V) of the whole prompt."""
    hidden = forward(params, tokens, cfg, impl=impl)
    logits = common.unembed(hidden[:, -1:, :], params.embed,
                            cfg.logit_softcap, real_vocab=cfg.vocab_size)
    return logits[:, 0, :]


# ---------------------------------------------------------------------------
# Decode: O(1) state per layer
# ---------------------------------------------------------------------------

class MambaCache(NamedTuple):
    """Per-slot decode state, in ``common.zero_slot_leaf``'s convention
    (the slot on axis 1 of every stacked leaf; ``pos`` the only 1-D one):

    ssm_state  (L, B, H, N, P) float32;
    conv_state (L, B, W-1, Di + 2N) the last W-1 conv inputs;
    pos        (B,) int64 per-slot step counter.

    Every slot's state advances in each step, free slots' too (their rows
    are discarded), until an admission zeroes the slot, as the
    reference's."""
    ssm_state: torch.Tensor
    conv_state: torch.Tensor
    pos: torch.Tensor


def init_cache(cfg, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> MambaCache:
    """``max_len`` is accepted for the Model API: the state does not grow
    with the sequence.  A bf16 conv history by default, as the reference's
    and the other families' caches."""
    di, h, n, w = _dims(cfg)
    l, p = cfg.num_layers, cfg.ssm.head_dim
    return MambaCache(
        ssm_state=torch.zeros((l, batch, h, n, p), dtype=torch.float32,
                              device=device),
        conv_state=torch.zeros((l, batch, w - 1, di + 2 * n), dtype=dtype,
                               device=device),
        pos=torch.zeros((batch,), dtype=torch.int64, device=device))


def _mamba_step(x, lp: MambaLayerParams, cfg, s_state, c_state):
    """x (B, 1, D) → (out, ssm state', conv history')."""
    di, h, n, w = _dims(cfg)
    p = cfg.ssm.head_dim
    hh = common.rms_norm(x, lp.ln, cfg.norm_eps)
    xz = common.dense_apply(hh, lp.w_in)
    z, xi, b, c, dt = _split_proj(xz, cfg)
    conv_in = torch.cat([xi, b, c], dim=-1)                  # (B, 1, C)
    # the history in the promoted dtype for this step's taps, stored back
    # in the cache's, as the reference's concatenate does
    cat_dt = torch.promote_types(c_state.dtype, conv_in.dtype)
    hist = torch.cat([c_state.to(cat_dt), conv_in.to(cat_dt)], dim=1)
    histf, wf = hist.float(), lp.conv_w.float()
    conv = histf[:, 0] * wf[0]
    for i in range(1, w):
        conv = conv + histf[:, i] * wf[i]
    conv = F.silu(conv + lp.conv_b.float())                  # (B, C)
    xi1, b1, c1 = torch.split(conv, [di, n, n], dim=-1)
    dtp = F.softplus(dt[:, 0].float() + lp.dt_bias)          # (B, H)
    a = -torch.exp(lp.a_log)
    g = torch.exp(dtp * a)
    xh = xi1.reshape(-1, h, p)
    # state update: s ← g s + dt · b xᵀ
    outer = b1[:, None, :, None] * xh[:, :, None, :] * dtp[..., None, None]
    s_new = s_state * g[..., None, None] + outer
    y = torch.stack([torch.matmul(c1[i], s_new[i])
                     for i in range(s_new.shape[0])])       # (B, H, P)
    y = y + lp.d_skip[None, :, None] * xh
    y = y.reshape(-1, 1, di)
    y = common.rms_norm((y * F.silu(z.float())).to(x.dtype), lp.gate_norm,
                        cfg.norm_eps)
    out = x + common.dense_apply(y, lp.w_out)
    return out.to(x.dtype), s_new, hist[:, 1:].to(c_state.dtype)


def decode_step(params: MambaParams, cache: MambaCache, tokens, cfg):
    """One token per slot in (B, 1), logits (B, V) out; the cache's state
    and conv history are updated in place."""
    x = params.embed[tokens].to(torch_dtype(cfg.dtype))      # (B, 1, D)
    for l in range(cfg.num_layers):
        x, cache.ssm_state[l], cache.conv_state[l] = _mamba_step(
            x, common.layer_at(params.layers, l), cfg, cache.ssm_state[l],
            cache.conv_state[l])
    hidden = common.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = common.unembed(hidden, params.embed, cfg.logit_softcap,
                            real_vocab=cfg.vocab_size)
    return logits[:, 0, :], cache._replace(pos=cache.pos + 1)


# TT-native serving rules: the block's two big matmuls.  The fused
# in-projection (D, 2Di+2N+H) and out-projection (Di, D) hold the layer's
# weight bytes; conv, gate and decay params are small and stay raw.
common.register_tt_serve_rules("ssm", [
    common.TTServeRule(r"^layers\.w_in$", in_ndim=1),
    common.TTServeRule(r"^layers\.w_out$", in_ndim=1),
])
