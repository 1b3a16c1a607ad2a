"""The port's SSM family (mamba2-1.3b) against the JAX package.

Reduced mamba2-1.3b in float32 (2 layers, d_model 128, SSMConfig(state
16, head 16, chunk 32): 16 heads, d_inner 256, vocab 512), norms and conv
bias bumped off zero: the same numpy weights and tokens go through both
packages' causal conv, ``ssd_chunked`` (S 32, 64 and 100, the last
padded to a whole chunk), the mixer, ``forward``, ``prefill``, ``loss_fn``
(masked too) and 40 ``decode_step``s; ``ssd_chunked`` also against a
per-step float64 recurrence written here.  Then TT-native prefill and
greedy ``generate`` on a payload the reference compresses, the ``Engine``
under both admission modes against the port's isolated runs and the JAX
``Engine``, the serve CLI and a ``family="ssm"`` checkpoint in both
packages.

Tolerances, float32 with TF32 off: 1e-5 of the reference's max |value| for
the conv and the SSD (summation order only); 1e-4 of scale for the
model's logits and hidden states (inside the reference's own
``logit_parity`` bound, max(0.05·scale, 1e-3)); losses 1e-5 relative;
tokens equal.

The reference compresses with its library SVD: its default two-phase
policy keeps a full M×M U_B, which runs the suite's workers out of memory
on mamba2's tall unfoldings (ROADMAP queue 3, item 1).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.core import compression as jax_comp
from repro.core.tt_linear import spectral_decay_pytree as jax_decay
from repro.launch import engine as jax_engine
from repro.models import common as jax_common
from repro.models import mamba2 as jax_mamba
from repro.models.registry import build as jax_build
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.convert import _root_of, params_from_numpy, payload_from_numpy
from repro_torch.core import compression as comp
from repro_torch.core.tt_linear import is_tt_linear
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.engine import Engine, generate
from repro_torch.models import common
from repro_torch.models import mamba2
from repro_torch.models.registry import build
from repro_torch.train.steps import make_eval_step, make_prefill_step

from _torch_port import (
    assert_close_scaled, flat_numpy, flat_payload, no_tf32, to_np,
)
from test_torch_checkpoint import _assert_same

ARCH = "mamba2-1.3b"
S = 100          # three chunks of 32 and a padded tail
PIECE_TOL = 1e-5
MODEL_TOL = 1e-4
EPS = 0.2
REQS = [(5, 4), (3, 7), (9, 3), (2, 5)]     # tests/test_decode_driver.py


@pytest.fixture(scope="module")
def pair():
    """Both packages' models, the reference's params with bumped norms and
    conv bias carried to the port through numpy, and tokens."""
    no_tf32()
    jcfg = jax_get_config(ARCH).reduced(dtype="float32")
    cfg = get_config(ARCH).reduced(dtype="float32")
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    bumped = []
    for path, leaf in flat:
        name = jax_common._path_str(path)
        if name.endswith(("ln", "gate_norm", "final_norm", "conv_b")):
            leaf = leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        bumped.append(jnp.asarray(leaf))
    params = jax.tree_util.tree_unflatten(treedef, bumped)
    model = build(cfg, device="cpu")
    pparams = params_from_numpy(flat_numpy(params), cfg)
    tokens = rng.integers(0, cfg.vocab_size, (2, S), dtype=np.int32)
    return jmodel, params, model, pparams, tokens


@pytest.fixture(scope="module")
def tt_pair(pair):
    """One payload of the decayed weights, compressed by the reference, as
    TT-native params of both packages; and the port's own compression of
    the same weights."""
    jmodel, params, model, _, _ = pair
    decayed = jax_decay(params, alpha=1.0)
    payload, _ = jax_comp.TTCompressor(jax_comp.CompressionPolicy(
        eps=EPS, min_size=8192, svd_method="library", plan="serial")
    ).compress(decayed)
    jtt = jax_common.tt_native_params(payload, family="ssm")
    ppay = payload_from_numpy(flat_payload(payload))
    ptt = common.tt_native_params(ppay, family="ssm")
    own, _ = comp.TTCompressor(comp.CompressionPolicy(
        eps=EPS, min_size=8192)).compress(
            params_from_numpy(flat_numpy(decayed), model.cfg))
    return {"payload": payload, "jtt": jtt, "ptt": ptt, "own": own,
            "decayed": decayed}


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64 if a.dtype.kind in "iu"
                                     else np.float32))


def test_config_and_params_carry_across(pair):
    _, params, model, pparams, _ = pair
    full = get_config(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.vocab_size,
            full.tie_embeddings, full.ssm.state_dim, full.ssm.head_dim,
            full.ssm.expand, full.ssm.conv_width, full.ssm.chunk) == (
        "ssm", 48, 2048, 50_280, True, 128, 64, 2, 4, 256)
    cfg = model.cfg
    assert (cfg.num_layers, cfg.d_model, cfg.ssm.state_dim,
            cfg.ssm.head_dim, cfg.ssm.chunk) == (2, 128, 16, 16, 32)
    assert get_config("qwen1.5-0.5b").reduced().ssm is None
    with pytest.raises(ValueError, match="not ported"):
        get_config("pixtral-12b")
    assert isinstance(pparams, mamba2.MambaParams)
    assert pparams.layers.w_in.shape == (2, 128, 2 * 256 + 2 * 16 + 16)
    assert pparams.layers.conv_w.shape == (2, 4, 256 + 2 * 16)
    # the SSM's dense and the transformer's roots share their top-level
    # names: the family is read off the layers' paths
    flat = flat_numpy(params)
    assert _root_of(flat) is mamba2.MambaParams
    # a_log, d_skip and dt_bias stay float32 in a bf16 model
    bf = params_from_numpy(flat, get_config(ARCH).reduced())
    assert bf.layers.w_in.dtype == torch.bfloat16
    for name in ("a_log", "d_skip", "dt_bias"):
        leaf = getattr(bf.layers, name)
        assert leaf.dtype == torch.float32, name
        np.testing.assert_array_equal(leaf.numpy(), flat[f"layers.{name}"])
    own = model.init(0)
    assert own.layers.a_log.dtype == torch.float32
    np.testing.assert_array_equal(own.layers.a_log.numpy(),
                                  flat["layers.a_log"])
    np.testing.assert_array_equal(own.layers.dt_bias.numpy(),
                                  flat["layers.dt_bias"])


def _ssd_inputs(s, seed, dt_shift=-3.0):
    rng = np.random.default_rng(seed)
    b, h, p, n = 2, 16, 16, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)) + dt_shift, 0.0
                      ).astype(np.float32)
    a = -rng.uniform(1.0, 16.0, (h,)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    return x, dt, a, bm, cm


@pytest.mark.parametrize("s", [32, 64, 100])
def test_causal_conv_matches_jax(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 48)).astype(np.float32)
    w = (0.1 * rng.standard_normal((4, 48))).astype(np.float32)
    b = rng.standard_normal((48,)).astype(np.float32)
    ref = np.asarray(jax_mamba._causal_conv(*map(jnp.asarray, (x, w, b))))
    got = common.causal_conv(*map(torch.from_numpy, (x, w, b)))
    assert_close_scaled(got, ref, PIECE_TOL)


@pytest.mark.parametrize("s", [32, 64, 100])
def test_ssd_chunked_matches_jax(s):
    ins = _ssd_inputs(s, seed=s)
    ref = np.asarray(jax.jit(jax_mamba.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, ins), 32))
    got = mamba2.ssd_chunked(*map(torch.from_numpy, ins), 32)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert_close_scaled(got, ref, PIECE_TOL)


def _recurrence(x, dt, a, bm, cm):
    """h_t = exp(a·dt_t) h_{t-1} + dt_t · b_t x_tᵀ, y_t = c_t · h_t, step
    by step in float64."""
    x, dt, a, bm, cm = (np.asarray(v, np.float64) for v in (x, dt, a, bm,
                                                           cm))
    b, s, h, p = x.shape
    state = np.zeros((b, h, bm.shape[-1], p))
    y = np.zeros_like(x)
    for t in range(s):
        g = np.exp(a[None, :] * dt[:, t])                       # (B, H)
        state = state * g[..., None, None] + dt[:, t, :, None, None] * (
            bm[:, t, None, :, None] * x[:, t, :, None, :])
        y[:, t] = np.einsum("bn,bhnp->bhp", cm[:, t], state)
    return y


@pytest.mark.parametrize("dt_shift", [-3.0, 3.0],
                         ids=["model_dt", "exp_overflows_above_diagonal"])
def test_ssd_chunked_matches_recurrence(dt_shift):
    """An independent oracle; with dt ~ 3 to 6 the exponent above the
    diagonal passes float32's range, which a product with the causal mask
    would turn into NaN."""
    ins = _ssd_inputs(S, seed=11, dt_shift=dt_shift)
    got = mamba2.ssd_chunked(*map(torch.from_numpy, ins), 32)
    assert bool(torch.isfinite(got).all())
    assert_close_scaled(got, _recurrence(*ins), PIECE_TOL)


def test_mixer_matches_jax(pair):
    jmodel, params, model, pparams, _ = pair
    x = np.random.default_rng(3).standard_normal(
        (2, S, model.cfg.d_model)).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[0], params.layers)
    ref = jax.jit(lambda lp, v: jax_mamba._mamba_mixer(v, lp, jmodel.cfg))(
        jlp, jnp.asarray(x))
    got = mamba2._mamba_mixer(torch.from_numpy(x),
                              common.layer_at(pparams.layers, 0), model.cfg)
    assert_close_scaled(got, np.asarray(ref), MODEL_TOL)


def test_forward_prefill_loss_match_jax(pair):
    jmodel, params, model, pparams, tokens = pair
    jt, pt = jnp.asarray(tokens), _t(tokens)
    ref = jax.jit(lambda p, t: jax_mamba.forward(p, t, jmodel.cfg))(
        params, jt)
    got = mamba2.forward(pparams, pt, model.cfg)
    assert_close_scaled(got, np.asarray(ref), MODEL_TOL)
    ref = jax.jit(jmodel.prefill)(params, {"tokens": jt})
    got = make_prefill_step(model)(pparams, {"tokens": pt})
    assert got.shape == (2, model.cfg.vocab_size)
    assert_close_scaled(got, np.asarray(ref), MODEL_TOL)
    labels = np.roll(tokens, -1, axis=1)
    mask = (np.arange(S)[None, :] < np.array([[S], [S // 2]])).astype(
        np.float32)
    for m in (None, mask):
        jb = {"tokens": jt, "labels": jnp.asarray(labels)}
        pb = {"tokens": pt, "labels": _t(labels)}
        if m is not None:
            jb["mask"], pb["mask"] = jnp.asarray(m), _t(m)
        jloss, _ = jax.jit(jmodel.loss_fn)(params, jb)
        loss = float(make_eval_step(model)(pparams, pb)["loss"])
        assert abs(loss - float(jloss)) <= 1e-5 * float(jloss)


def test_decode_steps_match_jax(pair):
    """40 steps from float32 caches on both sides, logits each step."""
    jmodel, params, model, pparams, tokens = pair
    jcfg, cfg = jmodel.cfg, model.cfg
    jc = jax_mamba.init_cache(jcfg, 2, 40, dtype=jnp.float32)
    pc = mamba2.init_cache(cfg, 2, 40, "cpu", dtype=torch.float32)
    assert pc.ssm_state.shape == (2, 2, 16, 16, 16)
    assert pc.conv_state.shape == (2, 2, 3, 288)
    step = jax.jit(lambda p, c, t: jax_mamba.decode_step(p, c, t, jcfg))
    with torch.inference_mode():
        for t in range(40):
            jl, jc = step(params, jc, jnp.asarray(tokens[:, t:t + 1]))
            pl, pc = model.decode_step(pparams, pc, _t(tokens[:, t:t + 1]))
            assert_close_scaled(pl, np.asarray(jl), MODEL_TOL)
    assert pc.pos.tolist() == [40, 40]
    assert_close_scaled(pc.ssm_state, np.asarray(jc.ssm_state), MODEL_TOL)
    assert_close_scaled(pc.conv_state, np.asarray(jc.conv_state), MODEL_TOL)
    # the model's own cache: a bf16 conv history, a float32 state
    c = model.init_cache(2, 8)
    assert (c.conv_state.dtype, c.ssm_state.dtype) == (torch.bfloat16,
                                                       torch.float32)


def test_prefill_equals_stepped_decode(pair):
    """Every position's logits of the chunked prefill (S = 70: two chunks
    and a padded tail) against the decode cache stepped through them."""
    _, _, model, pparams, tokens = pair
    cfg = model.cfg
    s = 70
    with torch.inference_mode():
        hidden = mamba2.forward(pparams, _t(tokens[:, :s]), cfg)
        want = common.unembed(hidden, pparams.embed, None,
                              real_vocab=cfg.vocab_size)
        cache = mamba2.init_cache(cfg, 2, s, "cpu", dtype=torch.float32)
        for t in range(s):
            got, cache = model.decode_step(pparams, cache,
                                           _t(tokens[:, t:t + 1]))
            assert_close_scaled(got, want[:, t], MODEL_TOL)


# -- TT-native serving -----------------------------------------------------

def test_tt_native_params_and_ranks(pair, tt_pair):
    """w_in and w_out serve from cores, everything else is reconstructed;
    the port's own compression gives the reference's ranks."""
    ptt, jtt = tt_pair["ptt"], tt_pair["jtt"]
    for name in ("w_in", "w_out"):
        leaf, jleaf = getattr(ptt.layers, name), getattr(jtt.layers, name)
        assert is_tt_linear(leaf)
        assert leaf.split == jleaf.split
        assert [tuple(c.shape) for c in leaf.cores] == [
            tuple(c.shape) for c in jleaf.cores]
    assert not is_tt_linear(ptt.layers.conv_w)
    assert not is_tt_linear(ptt.embed)
    own = {p: tuple(c.tt.ranks) for p, c in _port_items(tt_pair["own"])
           if c.kind == "tt"}
    assert own == _ranks_jax(tt_pair["payload"]) and "layers.w_in" in own


def _ranks_jax(payload) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        payload, is_leaf=lambda x: isinstance(x, jax_comp.CompressedParam))
    return {jax_common._path_str(p): tuple(c.tt.ranks) for p, c in flat
            if c.kind == "tt"}


def _port_items(payload):
    from repro_torch import tree
    return tree.leaves_with_paths(payload, is_leaf=comp.is_compressed_param)


def test_tt_native_prefill_and_decode_match_jax(pair, tt_pair):
    jmodel, _, model, _, tokens = pair
    jtt, ptt = tt_pair["jtt"], tt_pair["ptt"]
    ref = jmodel.prefill(jtt, {"tokens": jnp.asarray(tokens)})
    got = model.prefill(ptt, {"tokens": _t(tokens)})
    assert_close_scaled(got, np.asarray(ref), MODEL_TOL)
    jc = jax_mamba.init_cache(jmodel.cfg, 2, 8, dtype=jnp.float32)
    pc = mamba2.init_cache(model.cfg, 2, 8, "cpu", dtype=torch.float32)
    with torch.inference_mode():
        for t in range(4):
            jl, jc = jax_mamba.decode_step(jtt, jc,
                                           jnp.asarray(tokens[:, t:t + 1]),
                                           jmodel.cfg)
            pl, pc = model.decode_step(ptt, pc, _t(tokens[:, t:t + 1]))
            assert_close_scaled(pl, np.asarray(jl), MODEL_TOL)


def test_generate_tt_matches_jax(pair, tt_pair):
    """Greedy generation on the TT-native params: both drivers give the
    reference's tokens, prompt logits within 1e-4 of scale."""
    jmodel, _, model, _, tokens = pair
    prompts = tokens[:, :6]
    ref = jax_engine.generate(jmodel, tt_pair["jtt"], prompts, 6)
    for driver in ("fused", "python"):
        got = generate(model, tt_pair["ptt"], prompts, 6, driver=driver)
        np.testing.assert_array_equal(got["gen"], np.asarray(ref["gen"]))
        assert_close_scaled(got["prompt_logits"],
                            np.asarray(ref["prompt_logits"]), MODEL_TOL)


# -- the Engine ------------------------------------------------------------

def test_engine_matches_isolated_and_the_jax_engine(pair):
    """REQS through a 2-slot pool (chunks of 3) under both admission modes:
    every completion equal to the port's isolated run and to the JAX
    ``Engine``'s completion on the same stream; scan == boundary byte for
    byte (a freed slot's state runs on until admission zeroes it)."""
    jmodel, params, model, pparams, _ = pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.cfg.vocab_size, (p,), np.int32)
               for p, _ in REQS]
    jeng = jax_engine.Engine(jmodel, params, slots=2, max_len=24,
                             chunk_steps=3)
    for i, (p, (_, g)) in enumerate(zip(prompts, REQS)):
        jeng.submit(p, g, seed=i)
    want = {c.uid: c for c in jeng.run()}
    outs = {}
    for admission in ("scan", "boundary"):
        eng = Engine(model, pparams, slots=2, max_len=24, chunk_steps=3,
                     admission=admission)
        assert eng.admission == admission
        uids = [eng.submit(p, g, seed=i)
                for i, (p, (_, g)) in enumerate(zip(prompts, REQS))]
        done = {c.uid: c for c in eng.run()}
        outs[admission] = [done[u] for u in uids]
        for i, (p, (_, g)) in enumerate(zip(prompts, REQS)):
            iso = generate(model, pparams, p[None], g, seed=i)
            np.testing.assert_array_equal(
                done[uids[i]].tokens, iso["gen"][0],
                err_msg=f"{admission} uid={uids[i]}")
            np.testing.assert_array_equal(
                done[uids[i]].tokens, np.asarray(want[uids[i]].tokens),
                err_msg=f"{admission} uid={uids[i]} vs the JAX Engine")
    for a, b in zip(outs["scan"], outs["boundary"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.prompt_logits, b.prompt_logits)
    with pytest.raises(ValueError, match="token-only"):
        eng.submit(prompts[0], 2, src_tokens=np.zeros((3,), np.int32))


# -- serve and the checkpoint ----------------------------------------------

def test_serve_cli_and_checkpoint(tmp_path):
    """``serve --arch mamba2-1.3b --reduced --weights tt`` compresses,
    saves its payload (the manifest naming the family ``ssm``) and
    verifies against reconstruct; a second run from the checkpoint gives
    the same tokens; a dense arch refuses the checkpoint."""
    ckpt_dir = str(tmp_path / "ckpt")
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen", "4", "--weights", "tt"]
    out = serve_mod.serve(serve_mod.parse_args(
        base + ["--save-tt-checkpoint", ckpt_dir]))
    assert out["src"] is None and out["generated"].shape == (2, 4)
    assert set(out["info"]["chains"]) == {"layers.w_in", "layers.w_out"}
    v = out["verify"]
    assert v["max_diff"] <= v["bound"] and v["agree"] == 1.0
    with open(os.path.join(ckpt_dir, "tt_manifest.json")) as f:
        assert json.load(f)["family"] == "ssm"
    again = serve_mod.serve(serve_mod.parse_args(
        base + ["--tt-checkpoint", ckpt_dir, "--no-verify"]))
    np.testing.assert_array_equal(again["generated"], out["generated"])
    dense = ["--arch", "qwen1.5-0.5b"] + base[2:]
    with pytest.raises(ValueError, match="family 'ssm'"):
        serve_mod.serve(serve_mod.parse_args(
            dense + ["--tt-checkpoint", ckpt_dir]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ssm_checkpoint_in_both_packages(pair, tt_pair, tmp_path, writer):
    """A ``family="ssm"`` payload saved by either package loads in both
    bit for bit, with the family in the manifest."""
    _, _, model, _, _ = pair
    d = str(tmp_path / writer)
    if writer == "port":
        ckpt.save_tt_payload(d, tt_pair["own"], family="ssm")
    else:
        jax_ckpt.save_tt_payload(d, tt_pair["payload"], family="ssm")
    like = params_from_numpy(flat_numpy(tt_pair["decayed"]), model.cfg)
    got, manifest = ckpt.load_tt_payload(d, like=like, device="cpu")
    ref, jman = jax_ckpt.load_tt_payload(d, like=tt_pair["decayed"])
    assert manifest["family"] == jman["family"] == "ssm"
    _assert_same(got, ref)
