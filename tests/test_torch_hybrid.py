"""The port's hybrid family (recurrentgemma-2b) against the JAX package.

Reduced recurrentgemma in float32 with 5 layers (one (rglru, rglru, attn)
triple plus a 2-layer rglru tail), window 32, S = 128 > window: the same
numpy weights (norms and biases bumped off zero) and tokens go through both
packages' pieces (``rg_lru_scan``, ``_conv1d``, ``_rglru_block``,
``causal_attend``), the whole model (``forward``, ``prefill``,
``loss_fn``) under both ``impl`` values, TT-native prefill from one
payload, and ``decode_step`` past the ring buffer's wrap.

Tolerances, all in float32 with TF32 off:
  * 1e-5 of the reference's max |value| for one block or piece: the two
    sides differ in summation order only (the port's scan is a doubling
    scan, the reference's an odd-even associative scan);
  * 1e-4 of scale for the whole model's logits, loss and hidden states:
    the same rounding through 5 layers and a 512-way unembed;
  * 1e-4 of scale for TT-native logits: the chain contracts in another
    order in each package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import compression as jax_comp
from repro.core.tt_linear import spectral_decay_pytree as jax_decay
from repro.launch import engine as jax_engine
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import rglru as jax_rglru
from repro.models.registry import build as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, payload_from_numpy
from repro_torch.core.tt_linear import is_tt_linear
from repro_torch.launch import engine
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import rglru
from repro_torch.models.registry import build
from repro_torch.train.steps import make_eval_step, make_prefill_step

from _torch_port import (
    assert_close_scaled, flat_numpy, flat_payload, no_tf32, to_np,
)

ARCH = "recurrentgemma-2b"
S = 128
PIECE_TOL = 1e-5
MODEL_TOL = 1e-4


def _cfgs(**kw):
    over = dict(num_layers=5, dtype="float32", **kw)
    return (jax_get_config(ARCH).reduced(**over),
            get_config(ARCH).reduced(**over))


@pytest.fixture(scope="module")
def pair():
    """Both packages' models and the reference's params with non-trivial
    norms and biases, carried to the port through numpy."""
    no_tf32()
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    bumped = []
    for path, leaf in flat:
        name = jax_common._path_str(path)
        if name.endswith(("ln1", "ln2", "final_norm", "conv_b", "b_rg",
                          "b_ig")):
            leaf = leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        bumped.append(jnp.asarray(leaf))
    params = jax.tree_util.tree_unflatten(treedef, bumped)
    model = build(cfg, device="cpu")
    pparams = params_from_numpy(flat_numpy(params), cfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, S),
                                               dtype=np.int32)
    return jmodel, params, model, pparams, tokens


def test_params_carry_across(pair):
    _, _, model, pparams, _ = pair
    assert rglru.plan(model.cfg) == (1, 2)
    assert pparams.tail is not None and pparams.tail.w_x.shape[0] == 2
    assert pparams.triples.r1.lam.dtype == torch.float32
    assert pparams.triples.at.attn.wq.shape == (1, 128, 4, 32)


def test_rg_lru_scan_matches_jax():
    rng = np.random.default_rng(3)
    x, gr, gi = (rng.standard_normal((2, S, 16)).astype(np.float32)
                 for _ in range(3))
    gr, gi = 1 / (1 + np.exp(-gr)), 1 / (1 + np.exp(-gi))
    lam = rng.uniform(0.3, 1.5, 16).astype(np.float32)
    ref = jax.jit(jax_rglru.rg_lru_scan)(
        *(jnp.asarray(a) for a in (x, gr, gi, lam)))
    got = rglru.rg_lru_scan(*(torch.from_numpy(a) for a in (x, gr, gi, lam)))
    assert_close_scaled(got, np.asarray(ref), PIECE_TOL)


def test_conv1d_and_rglru_block_match_jax(pair):
    jmodel, params, model, pparams, _ = pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, 128)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], params.triples.r1)
    lp = common.layer_at(pparams.triples.r1, 0)
    ref = jax_rglru._conv1d(jnp.asarray(x), jlp.conv_w, jlp.conv_b)
    got = rglru._conv1d(torch.from_numpy(x), lp.conv_w, lp.conv_b)
    assert_close_scaled(got, np.asarray(ref), PIECE_TOL)
    ref = jax.jit(lambda xx, lp: jax_rglru._rglru_block(xx, lp, jmodel.cfg))(
        jnp.asarray(x), jlp)
    got = rglru._rglru_block(torch.from_numpy(x), lp, model.cfg)
    assert_close_scaled(got, np.asarray(ref), PIECE_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("chunk", [S, 32], ids=["s<=chunk", "s>chunk"])
@pytest.mark.parametrize("window", [32, None])
def test_causal_attend_matches_jax(pair, impl, chunk, window):
    jmodel, _, model, _, _ = pair
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, S, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 1, 32)).astype(np.float32)
            for _ in range(2))
    ref = jax_attn.causal_attend(*(jnp.asarray(a) for a in (q, k, v)),
                                 jmodel.cfg, window=window, chunk=chunk,
                                 impl=impl)
    got = attn.causal_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                             model.cfg, window=window, chunk=chunk,
                             impl=impl)
    assert_close_scaled(got, np.asarray(ref), PIECE_TOL)


def test_causal_attend_global_flag_drops_the_window(pair):
    _, _, model, _, _ = pair
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 2, 32)).astype(
        np.float32)) for _ in range(3))
    full = attn.causal_attend(q, k, v, model.cfg, window=None)
    for impl in ("xla", "pallas"):
        got = attn.causal_attend(q, k, v, model.cfg, window=8,
                                 is_global=True, impl=impl)
        assert_close_scaled(got, full, PIECE_TOL)
    with pytest.raises(ValueError, match="impl"):
        attn.causal_attend(q, k, v, model.cfg, impl="triton")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_prefill_loss_match_jax(pair, impl):
    jmodel, params, model, pparams, tokens = pair
    jt = jnp.asarray(tokens)
    pt = torch.from_numpy(tokens.astype(np.int64))
    labels = np.roll(tokens, -1, axis=1)
    ref_h = jax_rglru.forward(params, jt, jmodel.cfg, impl=impl)
    got_h = rglru.forward(pparams, pt, model.cfg, impl=impl)
    assert_close_scaled(got_h, np.asarray(ref_h), MODEL_TOL)

    ref = jmodel.prefill(params, {"tokens": jt}, impl=impl)
    got = make_prefill_step(model, impl=impl)(pparams, {"tokens": pt})
    assert got.shape == (2, model.cfg.vocab_size)
    assert_close_scaled(got, np.asarray(ref), MODEL_TOL)

    jloss, _ = jmodel.loss_fn(params, {"tokens": jt,
                                       "labels": jnp.asarray(labels)},
                              impl=impl)
    metrics = make_eval_step(model, impl=impl)(
        pparams, {"tokens": pt, "labels": torch.from_numpy(labels)})
    assert abs(float(metrics["loss"]) - float(jloss)) <= MODEL_TOL * float(
        jloss)


def test_tt_native_prefill_matches_jax(pair):
    """One payload, compressed by the reference with its library SVD (its
    default two-phase policy accumulates an M×M U_B; ROADMAP queue 3, item
    1), served TT-native by both packages under both impls."""
    jmodel, params, model, _, tokens = pair
    payload, _ = jax_comp.TTCompressor(jax_comp.CompressionPolicy(
        eps=0.2, min_size=8192, svd_method="library", plan="serial")
    ).compress(jax_decay(params, alpha=1.0))
    jtt = jax_common.tt_native_params(payload, family="hybrid")
    ptt = common.tt_native_params(payload_from_numpy(flat_payload(payload)),
                                  family="hybrid")
    for leaf in (ptt.triples.r1.w_x, ptt.triples.r2.mlp.w_down,
                 ptt.triples.at.attn.wq, ptt.triples.at.attn.wo,
                 ptt.tail.w_gate):
        assert is_tt_linear(leaf)
    jt = jnp.asarray(tokens)
    pt = torch.from_numpy(tokens.astype(np.int64))
    for impl in ("xla", "pallas"):
        ref = jmodel.prefill(jtt, {"tokens": jt}, impl=impl)
        got = model.prefill(ptt, {"tokens": pt}, impl=impl)
        assert_close_scaled(got, np.asarray(ref), MODEL_TOL)


STEPS = 40          # past the window (32): the ring buffer wraps


def test_decode_steps_match_jax_and_prefill(pair):
    jmodel, params, model, pparams, tokens = pair
    jcache = jmodel.init_cache(2, STEPS, dtype=jnp.float32)
    jdecode = jax.jit(jmodel.decode_step)
    cache = rglru.init_cache(model.cfg, 2, STEPS, "cpu", dtype=torch.float32)
    assert cache.k.shape[2] == 32
    with torch.inference_mode():
        for t in range(STEPS):
            tok = tokens[:, t:t + 1]
            jl, jcache = jdecode(params, jcache, jnp.asarray(tok))
            pl, cache = model.decode_step(
                pparams, cache, torch.from_numpy(tok.astype(np.int64)))
            assert_close_scaled(pl, np.asarray(jl), MODEL_TOL)
            assert int(cache.pos[0]) == t + 1
    for name in ("h1", "ht", "conv2", "k"):
        assert_close_scaled(getattr(cache, name),
                            np.asarray(getattr(jcache, name)), MODEL_TOL)
    pt = torch.from_numpy(tokens[:, :STEPS].astype(np.int64))
    for impl in ("xla", "pallas"):
        last = model.prefill(pparams, {"tokens": pt}, impl=impl)
        assert_close_scaled(last, pl, MODEL_TOL)


def test_generate_drives_the_griffin_cache(pair):
    """``gen_step``/``generate`` drive ``GriffinCache`` unchanged: both
    drivers give the reference's greedy tokens."""
    jmodel, params, model, pparams, tokens = pair
    prompts = tokens[:, :6]
    ref = jax_engine.generate(jmodel, params, prompts, 5, driver="python")
    for driver in engine.DRIVERS:
        out = engine.generate(model, pparams, prompts, 5, driver=driver)
        np.testing.assert_array_equal(out["gen"], np.asarray(ref["gen"]))
        assert_close_scaled(out["prompt_logits"],
                            np.asarray(ref["prompt_logits"]), MODEL_TOL)


def test_dense_family_has_no_forward_yet():
    model = build(get_config("qwen1.5-0.5b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1"):
        model.prefill(None, {"tokens": None})
    with pytest.raises(NotImplementedError, match="queue 1"):
        make_eval_step(model)(None, {"tokens": None, "labels": None})


@pytest.mark.parametrize("weights", ["dense", "tt"])
def test_serve_cli_on_cpu(weights, capsys):
    serve_mod.main(["--arch", ARCH, "--reduced", "--batch", "2",
                    "--prompt-len", "5", "--gen", "4", "--weights", weights,
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] sample generation:" in out
    assert "tok/s" in out
    if weights == "tt":
        assert "TT-native mode" in out and "verify vs reconstruct" in out
