"""The port's encoder-decoder family (seamless-m4t-large-v2) against the JAX
package.

Reduced seamless in float32 (2 encoder and 2 decoder layers, d_model 128,
4 heads of 32, d_ff 256, vocab 512, 8 memory rows), norms bumped off zero:
the same numpy weights, frames and tokens go through both packages'
``cross_attend`` (mask none, partial, empty), ``encode``, ``prefill`` and
``loss_fn`` under both ``impl`` values (the reference's flash kernel in
interpret mode), ``decode_step`` against a populated memory, greedy
``generate(src_tokens=...)``, ``populate_memory`` / ``admit_memory`` and
the memory K/V of TT-native layers; then the ``Engine``'s encoder memory
at admission.

Tolerances, float32 with TF32 off: 1e-5 of the reference's max |value| for
one attention call or one memory projection (summation order only); 1e-4
of scale for the model's logits and hidden states (well inside the
reference's own ``logit_parity`` bound, max(0.05·scale, 1e-3)); losses
1e-5 relative; tokens equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

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
from repro.models import encdec as jax_encdec
from repro.models.registry import build as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import (
    _root_of, params_from_numpy, payload_from_numpy,
)
from repro_torch.core.tt_linear import is_tt_linear
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.engine import Engine, InvalidRequest, generate
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import encdec
from repro_torch.models.registry import build
from repro_torch.train.steps import make_eval_step, make_prefill_step

from _torch_port import (
    assert_close_scaled, flat_numpy, flat_payload, no_tf32, to_np,
)

ARCH = "seamless-m4t-large-v2"
S = 128          # decoder tokens: the flash kernel's block
PIECE_TOL = 1e-5
MODEL_TOL = 1e-4
REPO = Path(__file__).resolve().parent.parent


def _cfgs():
    return (jax_get_config(ARCH).reduced(dtype="float32"),
            get_config(ARCH).reduced(dtype="float32"))


@pytest.fixture(scope="module")
def pair():
    """Both packages' models, the reference's params with bumped norms
    carried to the port through numpy, frames and tokens."""
    no_tf32()
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    bumped = []
    for path, leaf in flat:
        name = jax_common._path_str(path)
        if name.endswith(("ln1", "ln2", "ln_x", "enc_norm", "final_norm")):
            leaf = leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        bumped.append(jnp.asarray(leaf))
    params = jax.tree_util.tree_unflatten(treedef, bumped)
    model = build(cfg, device="cpu")
    pparams = params_from_numpy(flat_numpy(params), cfg)
    frames = rng.standard_normal((2, cfg.frontend_len, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, S), dtype=np.int32)
    return jmodel, params, model, pparams, frames, tokens


@pytest.fixture(scope="module")
def tt_pair(pair):
    """One payload, compressed by the reference with its library SVD (its
    default two-phase policy accumulates an M×M U_B; ROADMAP queue 3, item
    1), as TT-native params of both packages."""
    jmodel, params, model, _, _, _ = pair
    payload, _ = jax_comp.TTCompressor(jax_comp.CompressionPolicy(
        eps=0.2, min_size=8192, svd_method="library", plan="serial")
    ).compress(jax_decay(params, alpha=1.0))
    jtt = jax_common.tt_native_params(payload, family="encdec")
    ptt = common.tt_native_params(payload_from_numpy(flat_payload(payload)),
                                  family="encdec")
    return jtt, ptt


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(
        np.int64 if np.asarray(a).dtype.kind in "iu" else np.float32))


def test_config_and_params_carry_across(pair):
    _, _, model, pparams, _, _ = pair
    full = get_config(ARCH)
    assert (full.family, full.num_layers, full.enc_layers, full.d_model,
            full.num_heads, full.num_kv_heads, full.resolved_head_dim,
            full.d_ff, full.vocab_size, full.act, full.frontend,
            full.frontend_len, full.tie_embeddings) == (
        "encdec", 24, 24, 1024, 16, 16, 64, 8192, 256_206, "relu",
        "frames", 1024, True)
    cfg = model.cfg
    assert (cfg.enc_layers, cfg.frontend_len, cfg.num_layers) == (2, 8, 2)
    assert get_config("qwen1.5-0.5b").reduced().frontend_len == 0
    assert isinstance(pparams, encdec.EncDecParams)
    assert pparams.dec_layers.cross_attn.wq.shape == (2, 128, 4, 32)
    assert pparams.enc_layers.mlp.w_down.shape == (2, 256, 128)
    # the family is read off the top-level names: not the transformer's
    flat = flat_numpy(pair[1])
    assert _root_of(flat) is encdec.EncDecParams
    assert _root_of({"embed": 0, "layers.attn.wq": 0}).__name__ == (
        "TransformerParams")


@pytest.mark.parametrize("mem_len", [None, [5, 8], [0, 3], 0],
                         ids=["none", "partial", "one_empty", "all_empty"])
@pytest.mark.parametrize("s", [1, 6])
def test_cross_attend_matches_jax(pair, mem_len, s):
    jmodel, _, model, _, _, _ = pair
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, s, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
            for _ in range(2))
    jm = None if mem_len is None else jnp.asarray(mem_len, jnp.int32)
    pm = None if mem_len is None else torch.as_tensor(mem_len)
    ref = np.asarray(jax_attn.cross_attend(
        *(jnp.asarray(a) for a in (q, k, v)), jmodel.cfg, mem_len=jm))
    got = attn.cross_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                            model.cfg, mem_len=pm)
    assert bool(torch.isfinite(got).all())
    assert_close_scaled(got, ref, PIECE_TOL)
    if mem_len is not None:
        for row, n in enumerate(np.broadcast_to(mem_len, (2,))):
            if n == 0:       # uniform softmax over zero V rows: exactly 0
                zero_v = torch.zeros_like(torch.from_numpy(v))
                out = attn.cross_attend(torch.from_numpy(q),
                                        torch.from_numpy(k), zero_v,
                                        model.cfg, mem_len=pm)
                assert bool((out[row] == 0).all())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_encode_prefill_loss_match_jax(pair, impl, monkeypatch):
    jmodel, params, model, pparams, frames, tokens = pair
    from repro_torch.kernels.flash_attention import ops as fa_ops
    calls = []
    real = fa_ops.mha_flash
    monkeypatch.setattr(fa_ops, "mha_flash",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jf, jt = jnp.asarray(frames), jnp.asarray(tokens)
    pf, pt = _t(frames), _t(tokens)
    ref_mem = jax.jit(lambda p, f: jax_encdec.encode(p, f, jmodel.cfg))(
        params, jf)
    got_mem = encdec.encode(pparams, pf, model.cfg, impl=impl)
    assert_close_scaled(got_mem, np.asarray(ref_mem), MODEL_TOL)

    ref = jax.jit(lambda p, b: jmodel.prefill(p, b, impl=impl))(
        params, {"tokens": jt, "frames": jf})
    got = make_prefill_step(model, impl=impl)(
        pparams, {"tokens": pt, "frames": pf})
    assert got.shape == (2, model.cfg.vocab_size)
    assert_close_scaled(got, np.asarray(ref), MODEL_TOL)
    # the flash kernel runs once a decoder layer, never in the encoder
    assert len(calls) == (model.cfg.num_layers if impl == "pallas" else 0)

    labels = np.roll(tokens, -1, axis=1)
    mask = (np.arange(S)[None, :] < np.array([[S], [S // 2]])).astype(
        np.float32)
    jloss, _ = jax.jit(lambda p, b: jmodel.loss_fn(p, b, impl=impl))(
        params, {"tokens": jt, "frames": jf, "labels": jnp.asarray(labels),
                 "mask": jnp.asarray(mask)})
    metrics = make_eval_step(model, impl=impl)(
        pparams, {"tokens": pt, "frames": pf, "labels": _t(labels),
                  "mask": _t(mask)})
    assert abs(float(metrics["loss"]) - float(jloss)) <= 1e-5 * float(jloss)


def _jax_cache(jcfg, b, max_len):
    return jax_encdec.init_cache(jcfg, b, max_len, dtype=jnp.float32)


def _cache(cfg, b, max_len):
    return encdec.init_cache(cfg, b, max_len, "cpu", dtype=torch.float32)


def _src(cfg, shape, seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("src_len", [8, 5])
def test_decode_steps_match_jax(pair, src_len):
    """``populate_memory`` then 6 decode steps, logits each step, against
    the reference; the port's per-slot ``mem_len`` masks the rows past a
    5-token source."""
    jmodel, params, model, pparams, _, tokens = pair
    jcfg, cfg = jmodel.cfg, model.cfg
    src = _src(cfg, (2, src_len))
    jc = jax_encdec.populate_memory(params, _jax_cache(jcfg, 2, 8),
                                    jnp.asarray(src), jcfg)
    with torch.inference_mode():
        pc = encdec.populate_memory(pparams, _cache(cfg, 2, 8), _t(src), cfg)
    assert pc.mem_len.tolist() == [src_len] * 2
    assert_close_scaled(pc.mem_k, np.asarray(jc.mem_k), PIECE_TOL)
    step = jax.jit(lambda p, c, t: jax_encdec.decode_step(p, c, t, jcfg))
    for t in range(6):
        jl, jc = step(params, jc, jnp.asarray(tokens[:, t:t + 1]))
        with torch.inference_mode():
            pl, pc = model.decode_step(pparams, pc, _t(tokens[:, t:t + 1]))
        assert_close_scaled(pl, np.asarray(jl), MODEL_TOL)


def test_prefill_equals_decode_on_a_cache(pair):
    """The port's prefill (memory from the encoder) and its decode cache
    (``precompute_memory_cache`` of the same memory) give the same last
    logits."""
    _, _, model, pparams, frames, tokens = pair
    cfg = model.cfg
    pf, pt = _t(frames), _t(tokens[:, :6])
    with torch.inference_mode():
        want = model.prefill(pparams, {"tokens": pt, "frames": pf})
        mem = encdec.encode(pparams, pf, cfg)
        cache = encdec.precompute_memory_cache(pparams, mem, cfg,
                                               _cache(cfg, 2, 8))
        for t in range(6):
            got, cache = model.decode_step(pparams, cache, pt[:, t:t + 1])
    assert_close_scaled(got, want, MODEL_TOL)


def test_generate_with_sources_matches_jax(pair):
    jmodel, params, model, pparams, _, tokens = pair
    cfg = model.cfg
    prompts = tokens[:, :4]
    src = _src(cfg, (2, 6), seed=8)
    ref = jax_engine.generate(jmodel, params, prompts, 6, src_tokens=src)
    for driver in ("fused", "python"):
        got = generate(model, pparams, prompts, 6, driver=driver,
                       src_tokens=src)
        np.testing.assert_array_equal(got["gen"], np.asarray(ref["gen"]))
        assert_close_scaled(got["prompt_logits"],
                            np.asarray(ref["prompt_logits"]), MODEL_TOL)
    # a 1-D source is every row's
    one = generate(model, pparams, prompts, 4, src_tokens=src[0])
    both = generate(model, pparams, prompts, 4,
                    src_tokens=np.stack([src[0], src[0]]))
    np.testing.assert_array_equal(one["gen"], both["gen"])
    with pytest.raises(ValueError, match="needs 9 encoder positions"):
        generate(model, pparams, prompts, 2,
                 src_tokens=_src(cfg, (2, cfg.frontend_len + 1)))


def test_populate_and_admit_memory(pair):
    """``admit_memory`` writes one slot as ``populate_memory`` writes every
    row (each slot against the row of the same source), and both match the
    reference's; the other slots stay untouched."""
    jmodel, params, model, pparams, _, _ = pair
    jcfg, cfg = jmodel.cfg, model.cfg
    src = _src(cfg, (3, 5), seed=9)
    with torch.inference_mode():
        full = encdec.populate_memory(pparams, _cache(cfg, 3, 4), _t(src),
                                      cfg)
        slots = _cache(cfg, 3, 4)
        slots.mem_len.fill_(0)
        for i in (2, 0):
            encdec.admit_memory(pparams, slots, i, _t(src[i]), cfg)
    jslots = _jax_cache(jcfg, 3, 4)
    for i in (2, 0):
        jslots = jax_encdec.admit_memory(params, jslots, i,
                                         jnp.asarray(src[i]), jcfg)
    assert slots.mem_len.tolist() == [5, 0, 5]
    for i in (0, 2):
        for a, b in ((slots.mem_k, full.mem_k), (slots.mem_v, full.mem_v)):
            assert_close_scaled(a[:, i], b[:, i], PIECE_TOL)
        assert_close_scaled(slots.mem_k[:, i], np.asarray(jslots.mem_k)[:, i],
                            PIECE_TOL)
    assert bool((slots.mem_k[:, 1] == 0).all())
    assert bool((full.mem_k[:, :, 5:] == 0).all())


def test_tt_native_memory_and_prefill_match_jax(pair, tt_pair):
    """The memory K/V projected by TT-native layers (the Python loop over
    ``layer_at`` against the reference's ``lax.map``) and TT-native prefill
    under both impls."""
    jmodel, _, model, _, frames, tokens = pair
    jtt, ptt = tt_pair
    for leaf in (ptt.dec_layers.cross_attn.wk, ptt.dec_layers.self_attn.wo,
                 ptt.enc_layers.attn.wq, ptt.enc_layers.mlp.w_down):
        assert is_tt_linear(leaf)
    jcfg, cfg = jmodel.cfg, model.cfg
    mem = np.random.default_rng(10).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    jc = jax_encdec.precompute_memory_cache(
        jtt, jnp.asarray(mem), jcfg, _jax_cache(jcfg, 2, 4))
    pc = encdec.precompute_memory_cache(ptt, _t(mem), cfg, _cache(cfg, 2, 4))
    assert pc.mem_k.shape == (2, 2, 8, 4, 32)
    assert_close_scaled(pc.mem_k, np.asarray(jc.mem_k), MODEL_TOL)
    assert_close_scaled(pc.mem_v, np.asarray(jc.mem_v), MODEL_TOL)
    jf, jt = jnp.asarray(frames), jnp.asarray(tokens)
    for impl in ("xla", "pallas"):
        ref = jmodel.prefill(jtt, {"tokens": jt, "frames": jf}, impl=impl)
        got = model.prefill(ptt, {"tokens": _t(tokens), "frames": _t(frames)},
                            impl=impl)
        assert_close_scaled(got, np.asarray(ref), MODEL_TOL)


# -- the Engine: encoder memory at admission --------------------------------

def test_engine_memory_at_admission(pair):
    """A request's memory is encoded at admission into its slot: the
    Engine's tokens equal its isolated run's beside requests with other
    sources, its prompt logits too (to 1e-4 of scale: on the CPU a dense
    projection of 2 pool rows may round otherwise than one of 1; the card
    check is bit for bit), and differ from a run with no memory."""
    _, _, model, pparams, _, _ = pair
    cfg = model.cfg
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg.vocab_size, (p,), np.int32),
             rng.integers(0, cfg.vocab_size, (s,), np.int32), g)
            for p, s, g in ((3, 6, 5), (5, 8, 3), (2, 1, 6), (4, 4, 4))]
    eng = Engine(model, pparams, slots=2, max_len=12, chunk_steps=3)
    assert eng.admission == "boundary" and eng.src_capacity == 8
    uids = [eng.submit(p, g, src_tokens=s) for p, s, g in reqs]
    done = {c.uid: c for c in eng.run()}
    for uid, (p, s, g) in zip(uids, reqs):
        iso = generate(model, pparams, p[None], g, max_len=12,
                       src_tokens=s[None])
        np.testing.assert_array_equal(done[uid].tokens, iso["gen"][0])
        assert_close_scaled(done[uid].prompt_logits,
                            iso["prompt_logits"][0], MODEL_TOL)
    p, s, g = reqs[0]
    zero = generate(model, pparams, p[None], g, max_len=12)
    gap = np.abs(to_np(zero["prompt_logits"][0])
                 - done[uids[0]].prompt_logits).max()
    assert gap > 100 * MODEL_TOL * np.abs(done[uids[0]].prompt_logits).max()


def test_recycled_slot_no_stale_memory(pair):
    """A token-only request in a slot whose last occupant had a source sees
    no memory: logits equal to its isolated run (no memory at all)."""
    _, _, model, pparams, _, _ = pair
    cfg = model.cfg
    rng = np.random.default_rng(6)
    src = rng.integers(0, cfg.vocab_size, (7,), np.int32)
    p1 = rng.integers(0, cfg.vocab_size, (4,), np.int32)
    p2 = rng.integers(0, cfg.vocab_size, (3,), np.int32)
    eng = Engine(model, pparams, slots=1, max_len=16)
    u1 = eng.submit(p1, 4, src_tokens=src)      # takes the one slot first
    u2 = eng.submit(p2, 4)                      # token-only, recycles it
    done = {c.uid: c for c in eng.run()}
    assert u1 in done
    iso = generate(model, pparams, p2[None], 4, max_len=16)
    np.testing.assert_array_equal(done[u2].tokens, iso["gen"][0])
    a = done[u2].prompt_logits
    b = to_np(iso["prompt_logits"][0])
    assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max() + 1e-5, (
        "stale cross-attention memory leaked into the recycled slot")
    assert eng.state.cache.mem_len.tolist() == [0]


def test_engine_capacity_error_covers_encoder_positions(pair):
    _, _, model, pparams, _, _ = pair
    cfg = model.cfg
    eng = Engine(model, pparams, slots=2, max_len=16)
    with pytest.raises(InvalidRequest) as ei:
        eng.submit(np.zeros((3,), np.int32), 4,
                   src_tokens=np.zeros((cfg.frontend_len + 1,), np.int32))
    msg = str(ei.value)
    assert "encoder" in msg and str(cfg.frontend_len) in msg
    with pytest.raises(InvalidRequest, match="decoder"):
        eng.submit(np.zeros((20,), np.int32), 4)
    for bad in (np.zeros((0,), np.int32), np.asarray([cfg.vocab_size])):
        with pytest.raises(InvalidRequest, match="src_tokens"):
            eng.validate(np.zeros((3,), np.int32), 2, src_tokens=bad)


def test_scan_admission_rejected_for_encdec(pair):
    _, _, model, pparams, _, _ = pair
    with pytest.raises(ValueError, match="boundary"):
        Engine(model, pparams, slots=2, max_len=16, admission="scan")
    assert Engine(model, pparams, slots=2, max_len=16,
                  admission="auto").admission == "boundary"


def test_engine_rejects_src_on_token_only_family():
    cfg = get_config("qwen1.5-0.5b").reduced(dtype="float32")
    model = build(cfg, device="cpu")
    params = model.init(0)
    assert model.populate_memory is None and model.admit_memory is None
    eng = Engine(model, params, slots=2, max_len=16)
    assert eng.admission == "scan" and eng.src_capacity == 0
    with pytest.raises(ValueError, match="token-only"):
        eng.submit(np.zeros((3,), np.int32), 4,
                   src_tokens=np.zeros((4,), np.int32))
    with pytest.raises(ValueError, match="token-only"):
        generate(model, params, np.zeros((1, 3), np.int32), 2,
                 src_tokens=np.zeros((4,), np.int32))


def test_serve_cli_and_checkpoint(tmp_path):
    """``serve --arch seamless-m4t-large-v2 --reduced --weights tt``
    compresses, saves its payload (the manifest naming the family) and
    verifies against reconstruct; a second run from the checkpoint gives
    the same tokens; a manifest naming another family is refused."""
    ckpt = str(tmp_path / "ckpt")
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen", "4", "--weights", "tt"]
    out = serve_mod.serve(serve_mod.parse_args(
        base + ["--save-tt-checkpoint", ckpt]))
    assert out["src"].shape == (2, 8)
    assert out["generated"].shape == (2, 4)
    v = out["verify"]
    assert v["max_diff"] <= v["bound"] and v["agree"] == 1.0
    again = serve_mod.serve(serve_mod.parse_args(
        base + ["--tt-checkpoint", ckpt, "--no-verify"]))
    np.testing.assert_array_equal(again["generated"], out["generated"])
    path = os.path.join(ckpt, "tt_manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    assert manifest["family"] == "encdec"
    manifest["family"] = "dense"
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="cannot serve arch family"):
        serve_mod.serve(serve_mod.parse_args(
            base + ["--tt-checkpoint", ckpt]))


def test_encdec_module_imports_no_jax():
    """``repro_torch.models.encdec`` loads neither JAX nor the JAX package
    (a fresh interpreter: this test process has both loaded)."""
    code = ("import sys; import repro_torch.models.encdec; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad); assert not bad")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert r.returncode == 0, r.stdout + r.stderr
