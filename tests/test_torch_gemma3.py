"""The port's gemma3-1b (dense, 5:1 local:global windows, √d_model
embedding) against the JAX package.

Reduced gemma3-1b in float32 with TF32 off: 6 layers (plain ``reduced()``
keeps 2, and with ``global_every=6`` no layer of 2 is global; of 6, layer
6 is), window 8, d_model 128, 4 Q heads and 1 KV head of 32, gelu,
qk-norm, vocab 512 tied.  Norms and qk-norm scales are bumped off zero,
and the same numpy weights and tokens go through both packages at S 40,
past the window: ``forward``, ``prefill``, ``loss_fn`` (masked too), 40
``decode_step``s and prefill against stepped decode; the embedding's scale
bit for bit in bf16; the window changing the output; TT-native prefill
and greedy ``generate`` on a payload the reference compresses; the
``Engine`` in both admission modes with a request that crosses the window,
against the port's isolated runs and the JAX ``Engine``; the serve CLI
and a gemma3 checkpoint written by either package and read by the other.

Tolerances, float32: 1e-4 of the reference's max |value| for hidden states
and logits (inside the reference's own ``logit_parity`` bound, max(0.05 ·
scale, 1e-3)); losses 1e-5 relative; tokens equal.

The reference compresses with its library SVD: its default two-phase
policy keeps a full M×M U_B, which runs the suite's workers out of memory
(ROADMAP queue 3, item 1).
"""

import dataclasses
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
from repro.core.tt_linear import is_tt_linear as jax_is_tt
from repro.core.tt_linear import spectral_decay_pytree as jax_decay
from repro.launch import engine as jax_engine
from repro.models import common as jax_common
from repro.models import transformer as jax_tfm
from repro.models.registry import build as jax_build
from repro_torch import tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, payload_from_numpy
from repro_torch.core import compression as comp
from repro_torch.core.tt_linear import is_tt_linear
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.engine import Engine, generate
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import build
from repro_torch.train.steps import make_eval_step, make_prefill_step

from _torch_port import (
    assert_close_scaled, flat_numpy, flat_payload, no_tf32,
)
from test_torch_checkpoint import _assert_same

ARCH = "gemma3-1b"
LAYERS, WINDOW = 6, 8
S = 40           # five windows
MODEL_TOL = 1e-4
EPS = 0.2
BUMPED = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
# (prompt, gen): the last request runs to position 17, past the window of
# 8, while the others stay inside it or just reach it
REQS = [(5, 3), (3, 5), (2, 4), (12, 6)]
TT_LEAVES = {"layers.attn.wq", "layers.attn.wk", "layers.attn.wv",
             "layers.attn.wo", "layers.mlp.w_gate", "layers.mlp.w_up",
             "layers.mlp.w_down"}


def _reduced(get):
    return get(ARCH).reduced(dtype="float32", num_layers=LAYERS,
                             window=WINDOW)


@pytest.fixture(scope="module")
def pair():
    """Both packages' models, the reference's params with bumped norms and
    qk-norm scales carried to the port through numpy, and tokens."""
    no_tf32()
    jcfg, cfg = _reduced(jax_get_config), _reduced(get_config)
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    bumped = []
    for path, leaf in flat:
        if jax_common._path_str(path).split(".")[-1] in BUMPED:
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
    jtt = jax_common.tt_native_params(payload)
    ptt = common.tt_native_params(payload_from_numpy(flat_payload(payload)))
    own, _ = comp.TTCompressor(comp.CompressionPolicy(
        eps=EPS, min_size=8192)).compress(
            params_from_numpy(flat_numpy(decayed), model.cfg))
    return {"payload": payload, "jtt": jtt, "ptt": ptt, "own": own,
            "decayed": decayed}


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64 if a.dtype.kind in "iu"
                                     else np.float32))


def test_config_matches_jax():
    """Every field the port's config has equals the reference's, full size
    and reduced; the reduced model has local and global layers."""
    full = get_config(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.resolved_head_dim, full.d_ff, full.act,
            full.qk_norm, full.window, full.global_every, full.rope_theta,
            full.vocab_size, full.tie_embeddings) == (
        "dense", 26, 1152, 4, 1, 256, 6912, "gelu", True, 512, 6, 1e6,
        262_144, True)
    for cfg, jc in ((full, jax_get_config(ARCH)),
                    (get_config(ARCH).reduced(),
                     jax_get_config(ARCH).reduced()),
                    (_reduced(get_config), _reduced(jax_get_config))):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jc, f.name), f.name
    flags = tfm._layer_flags(_reduced(get_config))
    assert flags == [bool(f) for f in jax_tfm._layer_flags(
        _reduced(jax_get_config))] == [False] * 5 + [True]
    assert tfm._layer_flags(full).count(True) == 4     # layers 6, 12, 18, 24


@pytest.mark.parametrize("dtype,factor", [
    ("bfloat16", 11.3125), ("float32", float(np.float32(128 ** 0.5)))])
def test_embedding_scale_matches_jax(pair, monkeypatch, dtype, factor):
    """The scaled embedding rows against the reference's forward with its
    layers and final norm skipped: bit for bit, the factor √128 rounded to
    the activation dtype first (bf16 11.3125, float32 11.3137)."""
    jmodel, params, _, pparams, tokens = pair
    jcfg = dataclasses.replace(jmodel.cfg, dtype=dtype)
    cfg = _reduced(get_config)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    monkeypatch.setattr(jax_common, "tt_scan",
                        lambda body, x, *a, **k: (x, None))
    monkeypatch.setattr(jax_common, "rms_norm", lambda x, *a: x)
    ref = np.asarray(jax_tfm.forward(params, jnp.asarray(tokens), jcfg
                                     ).astype(jnp.float32))
    got = common.embed_tokens(pparams.embed, _t(tokens), cfg,
                              tfm._scaled_embed(cfg))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    # each row times the rounded factor, exact in float64, rounded once
    rows = pparams.embed[_t(tokens)].to(got.dtype).double()
    assert torch.equal(got, (rows * factor).to(got.dtype))
    assert round(factor, 4) == (11.3125 if dtype == "bfloat16" else 11.3137)
    # the other dense configs keep their rows unscaled
    qcfg = get_config("qwen1.5-0.5b").reduced(dtype=dtype)
    assert not tfm._scaled_embed(qcfg)
    assert not tfm._scaled_embed(get_config("recurrentgemma-2b"))


def test_forward_prefill_loss_match_jax(pair):
    jmodel, params, model, pparams, tokens = pair
    jt, pt = jnp.asarray(tokens), _t(tokens)
    ref = jax.jit(lambda p, t: jax_tfm.forward(p, t, jmodel.cfg))(params, jt)
    got = tfm.forward(pparams, pt, model.cfg)
    assert got.shape == (2, S, model.cfg.d_model)
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


def test_window_is_live(pair):
    """The same forward with no window (every layer global) differs by far
    more than the parity tolerance: the local layers' mask is in effect."""
    _, _, model, pparams, tokens = pair
    windowed = tfm.forward(pparams, _t(tokens), model.cfg)
    open_cfg = dataclasses.replace(model.cfg, window=None)
    assert tfm._layer_flags(open_cfg) == [True] * LAYERS
    wide = tfm.forward(pparams, _t(tokens), open_cfg)
    # inside the first window both masks are the same
    assert_close_scaled(wide[:, :WINDOW], windowed[:, :WINDOW], 1e-6)
    scale = float(windowed.abs().max())
    assert float((wide - windowed).abs().max()) > 1e-3 * scale


def test_decode_steps_match_jax(pair):
    """40 steps from float32 caches on both sides, logits each step (the
    local layers' window slides past the first keys from step 9)."""
    jmodel, params, model, pparams, tokens = pair
    jcfg, cfg = jmodel.cfg, model.cfg
    jc = jax_tfm.init_cache(jcfg, 2, S, dtype=jnp.float32)
    pc = tfm.init_cache(cfg, 2, S, "cpu", dtype=torch.float32)
    step = jax.jit(lambda p, c, t: jax_tfm.decode_step(p, c, t, jcfg))
    with torch.inference_mode():
        for t in range(S):
            jl, jc = step(params, jc, jnp.asarray(tokens[:, t:t + 1]))
            pl, pc = model.decode_step(pparams, pc, _t(tokens[:, t:t + 1]))
            assert_close_scaled(pl, np.asarray(jl), MODEL_TOL)
    assert pc.pos.tolist() == [S, S]
    assert_close_scaled(pc.k, np.asarray(jc.k), MODEL_TOL)
    assert_close_scaled(pc.v, np.asarray(jc.v), MODEL_TOL)


def test_prefill_equals_stepped_decode(pair):
    """Every position's logits of the whole-sequence forward against the
    KV cache stepped through the same tokens."""
    _, _, model, pparams, tokens = pair
    cfg = model.cfg
    with torch.inference_mode():
        want = tfm.logits_fn(pparams, tfm.forward(pparams, _t(tokens), cfg),
                             cfg)
        cache = tfm.init_cache(cfg, 2, S, "cpu", dtype=torch.float32)
        for t in range(S):
            got, cache = model.decode_step(pparams, cache,
                                           _t(tokens[:, t:t + 1]))
            assert_close_scaled(got, want[:, t], MODEL_TOL)


# -- TT-native serving -----------------------------------------------------

def _ranks(items) -> dict:
    return {p: tuple(c.tt.ranks) for p, c in items if c.kind == "tt"}


def test_tt_native_params_and_ranks(tt_pair):
    """The seven projections serve from cores (the reference counts the
    same seven), the embedding and norms do not; the port's own
    compression gives the reference's ranks."""
    ptt, jtt = tt_pair["ptt"], tt_pair["jtt"]
    served = {p for p, leaf in tree.leaves_with_paths(
        ptt, is_leaf=is_tt_linear) if is_tt_linear(leaf)}
    assert served == TT_LEAVES
    assert len([x for x in jax.tree.leaves(jtt, is_leaf=jax_is_tt)
                if jax_is_tt(x)]) == len(TT_LEAVES)
    assert not is_tt_linear(ptt.embed)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tt_pair["payload"],
        is_leaf=lambda x: isinstance(x, jax_comp.CompressedParam))
    want = _ranks((jax_common._path_str(p), c) for p, c in flat)
    got = _ranks(tree.leaves_with_paths(tt_pair["own"],
                                        is_leaf=comp.is_compressed_param))
    assert got == want and TT_LEAVES <= set(got)


def test_tt_native_prefill_and_decode_match_jax(pair, tt_pair):
    jmodel, _, model, _, tokens = pair
    jtt, ptt = tt_pair["jtt"], tt_pair["ptt"]
    ref = jax.jit(jmodel.prefill)(jtt, {"tokens": jnp.asarray(tokens)})
    got = model.prefill(ptt, {"tokens": _t(tokens)})
    assert_close_scaled(got, np.asarray(ref), MODEL_TOL)
    jc = jax_tfm.init_cache(jmodel.cfg, 2, 12, dtype=jnp.float32)
    pc = tfm.init_cache(model.cfg, 2, 12, "cpu", dtype=torch.float32)
    step = jax.jit(lambda p, c, t: jax_tfm.decode_step(p, c, t, jmodel.cfg))
    with torch.inference_mode():
        for t in range(12):
            jl, jc = step(jtt, jc, jnp.asarray(tokens[:, t:t + 1]))
            pl, pc = model.decode_step(ptt, pc, _t(tokens[:, t:t + 1]))
            assert_close_scaled(pl, np.asarray(jl), MODEL_TOL)


def test_generate_tt_matches_jax(pair, tt_pair):
    """Greedy generation on the TT-native params past the window (prompt
    6, gen 6): both drivers give the reference's tokens, prompt logits
    within 1e-4 of scale."""
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
    """REQS through a 2-slot pool (chunks of 3) under both admission modes,
    one request crossing the window while its neighbours do not: every
    completion equal to the port's isolated run and to the JAX ``Engine``'s
    completion on the same stream; scan == boundary byte for byte."""
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


# -- serve and the checkpoint ----------------------------------------------

def test_serve_cli_and_checkpoint(tmp_path):
    """``serve --arch gemma3-1b --reduced --weights tt`` compresses, saves
    its payload (the manifest naming the family ``dense``), serves the
    seven projections from cores and verifies against reconstruct; a
    second run from the checkpoint gives the same tokens."""
    ckpt_dir = str(tmp_path / "ckpt")
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen", "4", "--weights", "tt"]
    out = serve_mod.serve(serve_mod.parse_args(
        base + ["--save-tt-checkpoint", ckpt_dir]))
    assert out["generated"].shape == (2, 4)
    assert set(out["info"]["chains"]) == TT_LEAVES
    v = out["verify"]
    assert v["max_diff"] <= v["bound"] and v["agree"] == 1.0
    with open(os.path.join(ckpt_dir, "tt_manifest.json")) as f:
        assert json.load(f)["family"] == "dense"
    again = serve_mod.serve(serve_mod.parse_args(
        base + ["--tt-checkpoint", ckpt_dir, "--no-verify"]))
    np.testing.assert_array_equal(again["generated"], out["generated"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gemma3_checkpoint_in_both_packages(pair, tt_pair, tmp_path,
                                            writer):
    """A gemma3 payload saved by either package loads in both bit for
    bit."""
    _, _, model, _, _ = pair
    d = str(tmp_path / writer)
    if writer == "port":
        ckpt.save_tt_payload(d, tt_pair["own"], family="dense")
    else:
        jax_ckpt.save_tt_payload(d, tt_pair["payload"], family="dense")
    like = params_from_numpy(flat_numpy(tt_pair["decayed"]), model.cfg)
    got, manifest = ckpt.load_tt_payload(d, like=like, device="cpu")
    ref, jman = jax_ckpt.load_tt_payload(d, like=tt_pair["decayed"])
    assert manifest["family"] == jman["family"] == "dense"
    _assert_same(got, ref)
