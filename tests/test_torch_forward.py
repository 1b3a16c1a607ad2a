"""The port's dense and MoE forward (``forward``, ``prefill``, ``loss_fn``)
against the JAX package.

Reduced qwen1.5-0.5b (QKV bias), qwen3-8b and qwen3-32b (GQA, qk-norm,
head_dim 32, untied), olmoe-1b-7b (MoE, qk-norm) and dbrx-132b (MoE, GQA),
2 layers each, in float32 with TF32 off: the same numpy weights (norms,
qk-norm scales and biases bumped off zero) and tokens go through both
packages under both ``impl`` values, with and without a frontend prefix,
TT-native from one payload, and through ``make_prefill_step`` /
``make_eval_step``.  The reference's scanned layer flag keeps
``impl="pallas"`` off the flash kernel; the port's forward must too.

Tolerances: ``MODEL_TOL`` = 1e-4 of the reference's scale for hidden states
and logits (the same float32 rounding through 2 layers and a 512-way
unembed, summed in another order), losses within 1e-4 relative; the MoE
routing is the same on both sides (no near-tie at these seeds), so its
outputs are held to the same bound.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import compression as jax_comp
from repro.core.tt_linear import spectral_decay_pytree as jax_decay
from repro.models import common as jax_common
from repro.models import transformer as jax_tfm
from repro.models.registry import build as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, payload_from_numpy
from repro_torch.core.tt_linear import is_tt_linear
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import build
from repro_torch.train.steps import make_eval_step, make_prefill_step

from _torch_port import (
    assert_close_scaled, f32_cfg, flat_numpy, flat_payload, no_tf32,
)

ARCHS = ["qwen1.5-0.5b", "qwen3-8b", "qwen3-32b", "olmoe-1b-7b",
         "dbrx-132b"]
IMPLS = ["xla", "pallas"]
B, S, P = 2, 48, 8
MODEL_TOL = 1e-4
BUMPED = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "bq", "bk", "bv")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Both packages' models, the reference's params with non-trivial norms,
    qk-norm scales and biases, the port's copy, and tokens, labels, a mask
    and a prefix."""
    no_tf32()
    arch = request.param
    jcfg = f32_cfg(jax_get_config(arch))
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
    model = build(f32_cfg(get_config(arch)), device="cpu")
    pparams = params_from_numpy(flat_numpy(params), model.cfg)
    data = np.random.default_rng(2)
    tokens = data.integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "mask": (data.random((B, S)) < 0.7).astype(np.float32),
             "prefix_embeds": data.standard_normal(
                 (B, P, jcfg.d_model)).astype(np.float32)}
    return {"arch": arch, "jmodel": jmodel, "jcfg": jcfg, "params": params,
            "model": model, "pparams": pparams, "batch": batch}


def _jax_batch(batch, *keys):
    return {k: jnp.asarray(batch[k]) for k in keys}


def _torch_batch(batch, *keys):
    return {k: torch.from_numpy(batch[k].astype(
        np.int64 if batch[k].dtype == np.int32 else batch[k].dtype))
        for k in keys}


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts calls of the flash kernel's wrapper (on the CPU it runs the
    plain version and counts no launch)."""
    calls = []
    real = fa_ops.mha_flash

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(fa_ops, "mha_flash", counted)
    return calls


def test_reduced_configs_match_jax():
    """Every field the port's config has equals the reference's, full size
    and reduced."""
    for arch in ARCHS:
        ref_full, ref = jax_get_config(arch), jax_get_config(arch).reduced()
        for cfg, jc in ((get_config(arch), ref_full),
                        (get_config(arch).reduced(), ref)):
            for f in dataclasses.fields(cfg):
                got, want = getattr(cfg, f.name), getattr(jc, f.name)
                if f.name in ("moe", "hybrid") and want is not None:
                    got, want = dataclasses.asdict(got), dataclasses.asdict(
                        want)
                assert got == want, (arch, f.name, got, want)
            assert cfg.padded_vocab_size == jc.padded_vocab_size
            assert cfg.resolved_head_dim == jc.resolved_head_dim


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(pair, impl, flash_calls):
    jcfg, model = pair["jcfg"], pair["model"]
    tokens = pair["batch"]["tokens"]
    ref = jax.jit(lambda p, t: jax_tfm.forward(p, t, jcfg, impl=impl))(
        pair["params"], jnp.asarray(tokens))
    got = tfm.forward(pair["pparams"], torch.from_numpy(
        tokens.astype(np.int64)), model.cfg, impl=impl)
    assert got.shape == (B, S, jcfg.d_model)
    assert_close_scaled(got, np.asarray(ref), MODEL_TOL)
    # the scanned layer flag keeps both impls on the plain attention path
    assert not flash_calls


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_jax(pair, impl, flash_calls):
    jmodel, model = pair["jmodel"], pair["model"]
    ref = jax.jit(lambda p, b: jmodel.prefill(p, b, impl=impl))(
        pair["params"], _jax_batch(pair["batch"], "tokens"))
    got = make_prefill_step(model, impl=impl)(
        pair["pparams"], _torch_batch(pair["batch"], "tokens"))
    assert got.shape == (B, model.cfg.vocab_size)
    assert_close_scaled(got, np.asarray(ref), MODEL_TOL)
    assert not flash_calls


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_loss_matches_jax(pair, impl, masked, flash_calls):
    jmodel, model = pair["jmodel"], pair["model"]
    keys = ("tokens", "labels") + (("mask",) if masked else ())
    jloss, _ = jax.jit(lambda p, b: jmodel.loss_fn(p, b, impl=impl))(
        pair["params"], _jax_batch(pair["batch"], *keys))
    loss, metrics = model.loss_fn(pair["pparams"],
                                  _torch_batch(pair["batch"], *keys),
                                  impl=impl)
    evaluated = make_eval_step(model, impl=impl)(
        pair["pparams"], _torch_batch(pair["batch"], *keys))
    assert float(evaluated["loss"]) == float(loss) == float(metrics["loss"])
    assert abs(float(loss) - float(jloss)) <= MODEL_TOL * abs(float(jloss))
    assert not flash_calls


def test_prefix_embeds_match_jax(pair):
    """A frontend's embeddings put before the tokens: hidden states over
    P + S positions, prefill's logits, and a loss over the tokens only."""
    jcfg, jmodel, model = pair["jcfg"], pair["jmodel"], pair["model"]
    jb = _jax_batch(pair["batch"], "tokens", "labels", "prefix_embeds")
    tb = _torch_batch(pair["batch"], "tokens", "labels", "prefix_embeds")
    ref = jax_tfm.forward(pair["params"], jb["tokens"], jcfg,
                          prefix_embeds=jb["prefix_embeds"])
    got = tfm.forward(pair["pparams"], tb["tokens"], model.cfg,
                      prefix_embeds=tb["prefix_embeds"])
    assert got.shape == (B, P + S, jcfg.d_model)
    assert_close_scaled(got, np.asarray(ref), MODEL_TOL)
    assert_close_scaled(model.prefill(pair["pparams"], tb),
                        np.asarray(jmodel.prefill(pair["params"], jb)),
                        MODEL_TOL)
    jloss, _ = jmodel.loss_fn(pair["params"], jb)
    loss, _ = model.loss_fn(pair["pparams"], tb)
    assert abs(float(loss) - float(jloss)) <= MODEL_TOL * abs(float(jloss))


def test_tt_native_prefill_matches_jax(pair, flash_calls):
    """One payload, compressed by the reference with its library SVD (its
    default two-phase policy keeps an M×M U_B; ROADMAP queue 3, item 1),
    served TT-native by both packages: prefill's logits and the loss."""
    jmodel, model, family = pair["jmodel"], pair["model"], pair["jcfg"].family
    payload, _ = jax_comp.TTCompressor(jax_comp.CompressionPolicy(
        eps=0.2, min_size=8192, svd_method="library", plan="serial")
    ).compress(jax_decay(pair["params"], alpha=1.0))
    jtt = jax_common.tt_native_params(payload, family=family)
    ptt = common.tt_native_params(payload_from_numpy(flat_payload(payload)),
                                  family=family)
    ffn = ptt.layers.moe if family == "moe" else ptt.layers.mlp
    for leaf in (ptt.layers.attn.wq, ptt.layers.attn.wo, ffn.w_gate,
                 ffn.w_down):
        assert is_tt_linear(leaf)
    jb = _jax_batch(pair["batch"], "tokens", "labels")
    tb = _torch_batch(pair["batch"], "tokens", "labels")
    for impl in IMPLS:
        ref = jmodel.prefill(jtt, jb, impl=impl)
        got = make_prefill_step(model, impl=impl)(ptt, tb)
        assert_close_scaled(got, np.asarray(ref), MODEL_TOL)
    jloss, _ = jmodel.loss_fn(jtt, jb)
    loss = make_eval_step(model)(ptt, tb)["loss"]
    assert abs(float(loss) - float(jloss)) <= MODEL_TOL * abs(float(jloss))
    assert not flash_calls


def test_prefill_matches_decode_steps(pair, monkeypatch):
    """Prefill's last logits equal the KV cache stepped through the same
    tokens (the port against itself, float32 cache).  An MoE block's
    capacity couples the tokens routed together (B·S at prefill, B at
    decode), so there it gets room for every token: nothing is dropped on
    either side."""
    model, pparams = pair["model"], pair["pparams"]
    moe = model.cfg.moe
    if moe is not None:
        monkeypatch.setattr(tfm.mlp_mod, "moe_apply", functools.partial(
            tfm.mlp_mod.moe_apply,
            capacity_factor=moe.num_experts / moe.num_experts_per_tok))
    tokens = torch.from_numpy(pair["batch"]["tokens"].astype(np.int64))
    last = model.prefill(pparams, {"tokens": tokens})
    cache = tfm.init_cache(model.cfg, B, S, "cpu", dtype=torch.float32)
    with torch.inference_mode():
        for t in range(S):
            stepped, cache = model.decode_step(pparams, cache,
                                               tokens[:, t:t + 1])
    assert_close_scaled(stepped, last, MODEL_TOL)


def test_logits_fn_masks_padding_rows():
    """``logits_fn`` passes the real vocabulary, as the reference's: rows of
    a padded table past it score -1e30."""
    cfg = get_config("qwen3-8b").reduced(dtype="float32")
    params = build(cfg, device="cpu").init(0)
    pad = torch.randn(3, cfg.d_model)
    padded = params._replace(lm_head=torch.cat([params.lm_head, pad]))
    h = torch.randn(2, 5, cfg.d_model)
    logits = tfm.logits_fn(padded, h, cfg)
    assert logits.shape == (2, 5, cfg.vocab_size + 3)
    assert bool((logits[..., cfg.vocab_size:] == -1e30).all())
    torch.testing.assert_close(logits[..., :cfg.vocab_size],
                               tfm.logits_fn(params, h, cfg))
