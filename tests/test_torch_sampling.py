"""Port parity: sampling.  ``repro_torch.prng`` against ``jax.random``
(JAX 0.9, ``jax_threefry_partitionable`` on), the port's samplers against
the JAX package's on identical numpy logits, and sampled ``generate`` on
reduced qwen1.5-0.5b (float32, the same weights in both packages).

* ``PRNGKey``, ``fold_in``, the threefry bits, ``uniform``: equal bit for
  bit, several seeds (negative ones too) and shapes (odd sizes, 2-D);
* ``gumbel``: within 4 float32 ulps of max(|g|, 1) — the port takes each
  log in float64 and rounds, JAX's float32 log may be a place off;
* ``sample_tokens`` / ``sample_tokens_per_slot``: the same tokens as the
  jitted JAX functions at several temperatures and top-k, on logits with
  ties at the k-th value;
* ``make_sampling`` refuses what the reference refuses;
* ``generate(..., temperature, top_k, seed)``: the fused and python
  drivers give the JAX package's tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import engine as jax_engine
from repro.models import common as jax_common
from repro.models.registry import build as jax_build
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import engine
from repro_torch.models import common
from repro_torch.models.registry import build

from _torch_port import f32_cfg, flat_numpy, no_tf32

SEEDS = [0, 1, 42, 2 ** 31 - 1, -1, -7]
SHAPES = [(1,), (7,), (151,), (1000,), (3, 5)]


def _jkey(seed, fold=None):
    k = jax.random.PRNGKey(seed)
    return k if fold is None else jax.random.fold_in(k, np.uint32(fold))


def _pkey(seed, fold=None):
    k = prng.PRNGKey(seed)
    return k if fold is None else prng.fold_in(k, fold)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_fold_in_equal_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _u32(jax.random.PRNGKey(seed)))
    for data in (0, 1, 5, 2 ** 20, 2 ** 32 - 1):
        np.testing.assert_array_equal(_pkey(seed, data).numpy(),
                                      _u32(_jkey(seed, data)))
    rows = torch.arange(9)
    want = jax.vmap(lambda r: jax.random.fold_in(_jkey(seed), r))(
        jnp.arange(9))
    np.testing.assert_array_equal(prng.fold_in(_pkey(seed), rows).numpy(),
                                  _u32(want))
    np.testing.assert_array_equal(common.slot_keys(seed, 9).numpy(),
                                  _u32(jax_common.slot_keys(seed, 9)))


def test_prngkey_rejects_seeds_past_32_bits():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 31)


def test_threefry_block_equals_jax():
    from jax._src import prng as jprng
    rng = np.random.default_rng(0)
    k1, k2, x1, x2 = (rng.integers(0, 2 ** 32, 64, dtype=np.uint64)
                      .astype(np.uint32) for _ in range(4))
    want = jprng.threefry2x32_p.bind(*(jnp.asarray(a) for a in
                                       (k1, k2, x1, x2)))
    got = prng.threefry2x32(*(torch.from_numpy(a.astype(np.int64))
                              for a in (k1, k2, x1, x2)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _u32(w))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_and_uniform_equal_jax(seed, shape):
    jk, pk = _jkey(seed, 3), _pkey(seed, 3)
    np.testing.assert_array_equal(
        prng.random_bits(pk, shape).numpy(),
        _u32(jax.random.bits(jk, shape, dtype=jnp.uint32)))
    np.testing.assert_array_equal(prng.uniform(pk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))


def test_bits_batched_keys_draw_rows_as_vmap():
    keys = common.slot_keys(11, 4)
    want = jax.vmap(lambda k: jax.random.bits(k, (33,), dtype=jnp.uint32))(
        jax_common.slot_keys(11, 4))
    np.testing.assert_array_equal(prng.random_bits(keys, (33,)).numpy(),
                                  _u32(want))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_gumbel_within_four_ulps(seed):
    n = 200_000
    got = prng.gumbel(_pkey(seed), (n,)).numpy()
    want = np.asarray(jax.random.gumbel(_jkey(seed), (n,)))
    ulp = 2.0 ** -23 * np.maximum(np.abs(want), 1.0)
    assert np.all(np.abs(got - want) <= 4 * ulp)
    assert np.mean(got == want) > 0.5


def _logits(b, v, seed, ties=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    if ties:       # quantized values: many ties, at the k-th value too
        x = np.round(x).astype(np.float32)
    return x


@pytest.mark.parametrize("temperature,top_k", [
    (1.0, None), (0.7, None), (0.9, 16), (1.3, 1), (0.5, 5), (2.0, 999)])
@pytest.mark.parametrize("ties", [False, True])
def test_sample_tokens_equal_jax(temperature, top_k, ties):
    b, v = 6, 301
    x = _logits(b, v, seed=top_k or 0, ties=ties)
    s = common.make_sampling(temperature, top_k)
    js = jax_common.make_sampling(temperature, top_k)
    for step in range(4):
        pkeys = prng.fold_in(common.slot_keys(5, b), step)
        jkeys = jax.vmap(jax.random.fold_in)(
            jax_common.slot_keys(5, b), jnp.full((b,), step, jnp.int32))
        want = jax.jit(jax_common.sample_tokens, static_argnums=2)(
            jnp.asarray(x), jkeys, js)
        got = common.sample_tokens(torch.from_numpy(x), pkeys, s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ties", [False, True])
def test_sample_tokens_per_slot_equal_jax(ties):
    b, v = 6, 301
    x = _logits(b, v, seed=9, ties=ties)
    temp = np.asarray([0.0, 0.7, 1.1, 0.9, 1.0, 0.3], np.float32)
    topk = np.asarray([0, 0, 16, 1, 5, 301], np.int32)
    for step in range(3):
        pkeys = prng.fold_in(common.slot_keys(2, b), step)
        jkeys = jax.vmap(jax.random.fold_in)(
            jax_common.slot_keys(2, b), jnp.full((b,), step, jnp.int32))
        want = jax.jit(jax_common.sample_tokens_per_slot)(
            jnp.asarray(x), jkeys, jnp.asarray(temp), jnp.asarray(topk))
        got = common.sample_tokens_per_slot(
            torch.from_numpy(x), pkeys, torch.from_numpy(temp),
            torch.from_numpy(topk.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # a slot at (t, k) draws what the static sampler draws at (t, k)
        for i in range(1, b):
            k = int(topk[i]) or None
            one = common.sample_tokens(
                torch.from_numpy(x[i:i + 1]), pkeys[i:i + 1],
                common.make_sampling(float(temp[i]), k))
            assert int(one[0]) == int(got[i]), i
    assert int(got[0]) == int(np.argmax(x[0]))      # temp 0: argmax


@pytest.mark.parametrize("temperature,top_k", [
    (-0.5, None), (1.0, 0), (1.0, -3), (0.5, -1)])
def test_make_sampling_rejects_what_the_reference_rejects(temperature,
                                                          top_k):
    with pytest.raises(ValueError) as ours:
        common.make_sampling(temperature, top_k)
    with pytest.raises(ValueError) as theirs:
        jax_common.make_sampling(temperature, top_k)
    assert str(ours.value) == str(theirs.value)


def test_make_sampling_accepts_greedy_and_normalizes():
    assert common.make_sampling(0, None) == common.GREEDY
    assert common.make_sampling(0.5, 3.0) == common.Sampling(0.5, 3)
    assert tuple(common.make_sampling(0.5, 3)) == tuple(
        jax_common.make_sampling(0.5, 3))


@pytest.fixture(scope="module")
def pair():
    no_tf32()
    jcfg = f32_cfg(jax_get_config("qwen1.5-0.5b"))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build(f32_cfg(get_config("qwen1.5-0.5b")), device="cpu")
    return jmodel, jparams, model, params_from_numpy(flat_numpy(jparams),
                                                     model.cfg)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.9, top_k=16, seed=3),
    dict(temperature=1.2, seed=42),
    dict(temperature=0.6, top_k=1, seed=7),
], ids=str)
def test_sampled_generate_equals_jax(pair, kw):
    jmodel, jparams, model, params = pair
    prompts = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 4), np.int32)
    want = jax_engine.generate(jmodel, jparams, prompts, 6, driver="fused",
                               **kw)["gen"]
    for driver in engine.DRIVERS:
        got = engine.generate(model, params, prompts, 6, driver=driver,
                              **kw)["gen"]
        np.testing.assert_array_equal(got, want, err_msg=driver)


def test_greedy_generate_ignores_the_seed(pair):
    _, _, model, params = pair
    prompts = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (2, 4), np.int32)
    base = engine.generate(model, params, prompts, 5)
    for seed in (0, 9):
        out = engine.generate(model, params, prompts, 5, temperature=0.0,
                              seed=seed)
        np.testing.assert_array_equal(out["gen"], base["gen"])
        assert torch.equal(out["prompt_logits"], base["prompt_logits"])


def test_rows_sample_independent_streams(pair):
    _, _, model, params = pair
    same = np.tile(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (1, 4), np.int32), (2, 1))
    out = engine.generate(model, params, same, 8, temperature=1.2, seed=3)
    assert not np.array_equal(out["gen"][0], out["gen"][1])
