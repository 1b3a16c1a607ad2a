"""The port's first slice end to end against the JAX package: the same
numpy weights go through TT compression (serial plan), ``tt_native_params``
and greedy ``generate`` with both drivers in both packages.  The TT ranks
are equal and every driver emits the same tokens.  Also the port's
``serve`` entry point on the CPU.

The port compresses with its own default, the two-phase SVD (the path the
card runs).  The reference compresses with its library SVD: its two-phase
HBD accumulates a full M×M U_B, about 4 GB for the 32768×2 MLP unfolding
here (ROADMAP queue 3, fault 1).  Both give the same singular values, so
the δ-ranks are equal; HBD parity itself is held in ``test_torch_svd.py``.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import compression as jax_comp
from repro.core.tt_linear import spectral_decay_pytree as jax_decay
from repro.launch import engine as jax_engine
from repro.models import common as jax_common
from repro.models.registry import build as jax_build
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression as comp
from repro_torch.launch import engine
from repro_torch.launch import serve as serve_mod
from repro_torch.models import common
from repro_torch.models.registry import build

from _torch_port import f32_cfg, flat_numpy, no_tf32, to_np

ARCH = "qwen1.5-0.5b"
EPS = 0.2


def test_slice_compress_convert_generate_matches_jax():
    no_tf32()
    jcfg = f32_cfg(jax_get_config(ARCH))
    jmodel = jax_build(jcfg)
    jparams = jax_decay(jmodel.init(jax.random.PRNGKey(0)), alpha=1.0)
    model = build(f32_cfg(get_config(ARCH)), device="cpu")
    pparams = params_from_numpy(flat_numpy(jparams), model.cfg)

    policy = dict(eps=EPS, min_size=8192, plan="serial")
    jpay, _ = jax_comp.TTCompressor(jax_comp.CompressionPolicy(
        svd_method="library", **policy)).compress(jparams)
    ppay, _ = comp.TTCompressor(comp.CompressionPolicy(**policy)).compress(
        pparams)

    jflat = {jax_common._path_str(p): c for p, c in
             jax.tree_util.tree_flatten_with_path(
                 jpay, is_leaf=lambda x: isinstance(
                     x, jax_comp.CompressedParam))[0]}
    pflat = dict(tree.leaves_with_paths(ppay,
                                        is_leaf=comp.is_compressed_param))
    assert set(pflat) == set(jflat)
    n_tt = 0
    for path, c in pflat.items():
        assert c.kind == jflat[path].kind, path
        if c.kind == "tt":
            n_tt += 1
            assert c.tt.ranks == jflat[path].tt.ranks, path
    assert n_tt >= 7        # embed + the seven projections

    jtt = jax_common.tt_native_params(jpay, family="dense")
    ptt = common.tt_native_params(ppay, family="dense")
    prompts = np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (2, 5), dtype=np.int32)
    outs = {}
    for driver in engine.DRIVERS:
        outs[("jax", driver)] = jax_engine.generate(
            jmodel, jtt, prompts, 5, driver=driver)
        outs[("torch", driver)] = engine.generate(
            model, ptt, prompts, 5, driver=driver)
    ref = outs[("jax", "python")]
    for key, out in outs.items():
        np.testing.assert_array_equal(np.asarray(out["gen"]), ref["gen"],
                                      err_msg=str(key))
        d, scale, _ = jax_common.logit_parity(
            np.asarray(to_np(out["prompt_logits"])), ref["prompt_logits"])
        assert d <= max(0.05 * scale, 1e-3), key


@pytest.mark.parametrize("weights", ["tt", "tt-int8"])
def test_serve_entry_point_on_cpu(weights):
    out = serve_mod.serve(serve_mod.parse_args([
        "--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "5",
        "--gen", "4", "--weights", weights, "--device", "cpu"]))
    assert out["generated"].shape == (2, 4)
    ver = out["verify"]
    if weights == "tt":
        assert ver["max_diff"] <= ver["bound"]
    else:
        assert ver["tie_agree"] >= 0.99
    assert out["info"]["ranks"]["layers.attn.wq"][0] == 1
    assert out["info"]["tt_bytes"] < out["info"]["dense_bytes"]


def test_generate_rejects_sampling_and_unknown_driver():
    """Sampling is ported: invalid sampling params (a negative temperature,
    top_k below 1) and an unknown driver raise; a valid draw runs."""
    model = build(get_config(ARCH).reduced(), device="cpu")
    params = model.init(0)
    prompts = np.zeros((1, 3), np.int32)
    with pytest.raises(ValueError, match="temperature"):
        engine.generate(model, params, prompts, 2, temperature=-0.7)
    with pytest.raises(ValueError, match="top_k"):
        engine.generate(model, params, prompts, 2, temperature=0.7, top_k=0)
    with pytest.raises(ValueError):
        engine.generate(model, params, prompts, 2, driver="bogus")
    out = engine.generate(model, params, prompts, 2, temperature=0.7,
                          top_k=5, seed=1)
    assert out["gen"].shape == (1, 2)
