"""Port parity: ``decode_step`` on reduced qwen1.5-0.5b (float32) with the
same weights and the same TT cores in both packages — dense, ``tt`` and
``tt-int8`` leaves.  Logits must sit within the reference's own
``logit_parity`` bound, max(0.05·scale, 1e-3); the greedy tokens agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import compression as jax_comp
from repro.core.tt_linear import spectral_decay_pytree as jax_decay
from repro.models import common as jax_common
from repro.models.registry import build as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, payload_from_numpy
from repro_torch.models import common
from repro_torch.models.registry import build

from _torch_port import f32_cfg, flat_numpy, flat_payload, no_tf32, to_np

ARCH = "qwen1.5-0.5b"
STEPS = 4


@pytest.fixture(scope="module")
def pair():
    """Both packages' models and the reference's params with non-trivial
    norms and biases, carried to the port through numpy."""
    no_tf32()
    jcfg = f32_cfg(jax_get_config(ARCH))
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    bumped = []
    for (path, leaf) in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = jax_common._path_str(path)
        if name.endswith(("ln1", "ln2", "final_norm", "bq", "bk", "bv")):
            leaf = leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        bumped.append(jnp.asarray(leaf))
    params = jax.tree_util.tree_unflatten(treedef, bumped)
    model = build(f32_cfg(get_config(ARCH)), device="cpu")
    return jmodel, params, model


def _decode_both(jmodel, jparams, model, pparams, tokens):
    b = tokens.shape[0]
    jcache = jmodel.init_cache(b, STEPS + 2)
    pcache = model.init_cache(b, STEPS + 2)
    for t in range(STEPS):
        tok = tokens[:, t:t + 1]
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok))
        pl, pcache = model.decode_step(pparams, pcache, torch.from_numpy(
            tok.astype(np.int64)))
        d, scale, agree = jax_common.logit_parity(
            jnp.asarray(to_np(pl)), jl)
        assert d <= max(0.05 * scale, 1e-3), (t, d, scale)
        assert agree == 1.0, t
        assert int(pcache.pos[0]) == t + 1
    return d, scale


def test_decode_step_dense_matches_jax(pair):
    jmodel, jparams, model = pair
    pparams = params_from_numpy(flat_numpy(jparams), model.cfg)
    tokens = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (3, STEPS), dtype=np.int32)
    d, scale = _decode_both(jmodel, jparams, model, pparams, tokens)
    assert d <= 1e-4 * scale       # same weights, f32: rounding only


@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_step_tt_matches_jax(pair, quant):
    jmodel, jparams, model = pair
    decayed = jax_decay(jparams, alpha=1.0)
    payload, _ = jax_comp.TTCompressor(jax_comp.CompressionPolicy(
        eps=0.2, min_size=8192, svd_method="library", plan="serial")
    ).compress(decayed)
    jtt = jax_common.tt_native_params(payload, family="dense", quant=quant)
    ptt = common.tt_native_params(payload_from_numpy(flat_payload(payload)),
                                  family="dense", quant=quant)
    from repro_torch.core.tt_linear import is_tt_linear
    assert is_tt_linear(ptt.layers.attn.wq) and is_tt_linear(
        ptt.layers.mlp.w_down)
    assert ptt.layers.attn.wq.quantized == (quant is not None)
    tokens = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (2, STEPS), dtype=np.int32)
    _decode_both(jmodel, jtt, model, ptt, tokens)


def test_layer_at_clamps_and_selects(pair):
    _, jparams, model = pair
    pparams = params_from_numpy(flat_numpy(jparams), model.cfg)
    lp = common.layer_at(pparams.layers, 99)
    assert torch.equal(lp.ln1, pparams.layers.ln1[-1])


def test_convert_rejects_foreign_paths(pair):
    _, jparams, model = pair
    flat = flat_numpy(jparams)
    flat["layers.moe.router"] = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="moe"):
        params_from_numpy(flat, model.cfg)
