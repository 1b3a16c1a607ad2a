"""Port parity: TT-SVD (``ttd``), the serial ``TTCompressor``, the int8
quantizer and the TT-native linear layer, against the JAX package on the
same numpy tensors.

ttd/compression: δ-ranks equal, reconstructions within 1e-4 relative, each
tensor's error <= ε.  TT apply: 1e-5·max|ref| + 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jax_comp
from repro.core import tt as jax_tt
from repro.core import tt_linear as jax_ttl
from repro_torch.core import compression as comp
from repro_torch.core import tt as tt_mod
from repro_torch.core import tt_linear as ttl

from _torch_port import assert_close_scaled


def _decayed(rng, shape, alpha=1.5):
    """A tensor whose (-1, last) matricization has σ_i ∝ i^-α."""
    mat = rng.standard_normal((int(np.prod(shape[:-1])), shape[-1]))
    u, s, vt = np.linalg.svd(mat, full_matrices=False)
    s = s[0] * np.arange(1, s.size + 1.0) ** -alpha
    return ((u * s) @ vt).reshape(shape).astype(np.float32)


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("shape,dims,eps", [
    ((8, 16, 12), None, 0.1),
    ((4, 6, 5, 7), None, 0.3),
    ((24, 40), [4, 6, 5, 8], 0.2),
    ((3, 32, 2, 16), None, 0.05),
])
def test_ttd_matches_jax(rng, shape, dims, eps):
    w = _decayed(rng, shape)
    ref = jax_tt.ttd(w, eps=eps, dims=dims)
    got = tt_mod.ttd(torch.from_numpy(w), eps=eps, dims=dims)
    assert got.ranks == ref.ranks
    assert got.shape == tuple(ref.shape)
    rec = tt_mod.tt_reconstruct(got).numpy()
    ref_rec = np.asarray(jax_tt.tt_reconstruct(ref))
    assert _rel_err(rec, ref_rec) <= 1e-4
    assert _rel_err(rec, w.reshape(rec.shape)) <= eps
    assert got.num_params == ref.num_params
    assert got.live_params == ref.live_params


def test_ttd_vector_and_shape_check(rng):
    v = rng.standard_normal(7).astype(np.float32)
    tt = tt_mod.ttd(torch.from_numpy(v))
    assert tt.ranks == (1, 1)
    np.testing.assert_array_equal(tt_mod.tt_reconstruct(tt).numpy(), v)
    with pytest.raises(ValueError):
        tt_mod.ttd(torch.zeros(4, 4), dims=[3, 5])


@pytest.mark.parametrize("shape", [(151_936, 1024), (1024, 2816), (24, 96),
                                   (7, 8, 9), (4099,)])
def test_tensorize_dims_match_jax(shape):
    pol, jpol = comp.CompressionPolicy(), jax_comp.CompressionPolicy()
    assert comp.tensorize_dims(shape, pol) == list(
        jax_comp._tensorize_dims(shape, jpol))


def _tree(rng):
    return {
        "w": _decayed(rng, (2, 32, 24)),
        "mat": _decayed(rng, (48, 64)),
        "small": rng.standard_normal((4, 8)).astype(np.float32),
        "flat": rng.standard_normal((9000,)).astype(np.float32),
    }


def test_compressor_serial_matches_jax(rng):
    tree = _tree(rng)
    eps = 0.2
    jc = jax_comp.TTCompressor(jax_comp.CompressionPolicy(
        eps=eps, min_size=1024, plan="serial"))
    pc = comp.TTCompressor(comp.CompressionPolicy(
        eps=eps, min_size=1024, plan="serial"))
    jpay, jrep = jc.compress({k: jnp.asarray(v) for k, v in tree.items()})
    ppay, prep = pc.compress({k: torch.from_numpy(v)
                              for k, v in tree.items()})
    assert prep.total_params == jrep.total_params
    assert prep.payload_params == jrep.payload_params
    jrec, prec = jc.decompress(jpay), pc.decompress(ppay)
    for k, w in tree.items():
        assert ppay[k].kind == jpay[k].kind, k
        if ppay[k].kind == "tt":
            assert ppay[k].tt.ranks == jpay[k].tt.ranks, k
            assert _rel_err(prec[k].numpy(), w) <= eps
        assert _rel_err(prec[k].numpy(), np.asarray(jrec[k])) <= 1e-4, k
    assert {ppay[k].kind for k in tree} == {"tt", "raw"}


def test_compressor_batched_plan_not_ported(rng):
    """The default policy (``plan="batched"``) compresses; an unknown plan
    still raises."""
    w = _decayed(rng, (8, 16, 32))
    payload, report = comp.TTCompressor().compress({"w": torch.from_numpy(w)})
    assert payload["w"].kind == "tt"
    assert report.plan_fingerprint and report.exec_stats.bucket_launches == 1
    rec = comp.TTCompressor().decompress(payload)["w"].numpy()
    assert _rel_err(rec, w) <= comp.CompressionPolicy().eps
    with pytest.raises(ValueError):
        comp.TTCompressor().compress({"w": torch.zeros(4)}, plan="bogus")


# ---------------------------------------------------------------------------
# Quantization and the TT-native linear layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("calib", ["absmax", "p99.5", "p50"])
@pytest.mark.parametrize("axis", [None, -1])
def test_quantize_array_matches_jax(rng, calib, axis):
    a = rng.standard_normal((5, 33)).astype(np.float32)
    a[2] = 0.0                      # an all-zero row keeps scale 1
    jq, js = jax_ttl.quantize_array(jnp.asarray(a), calib=calib, axis=axis)
    q, s = ttl.quantize_array(torch.from_numpy(a), calib=calib, axis=axis)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    diff = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01   # rounding ties
    assert_close_scaled(ttl.dequantize_array(q, s, axis=axis),
                        jax_ttl.dequantize_array(jq, js, axis=axis), 1e-2)


def test_quantize_rejects_bad_calibration():
    with pytest.raises(ValueError):
        ttl.quantize_array(torch.ones(3), calib="p0")
    with pytest.raises(ValueError):
        ttl.quant_dtype("int3")


def _tt_pair(rng, shape, eps=0.2):
    w = _decayed(rng, shape)
    jt = jax_tt.ttd(w, eps=eps)
    pt = tt_mod.TTTensor(cores=[torch.from_numpy(np.array(c))
                                for c in jt.cores],
                         shape=tuple(jt.shape), ranks=jt.ranks, eps=eps)
    return jt, pt


@pytest.mark.parametrize("shape,in_ndim", [((3, 32, 4, 8), 1),
                                           ((3, 4, 8, 32), 2),
                                           ((3, 32, 48), 1)])
@pytest.mark.parametrize("quant", [False, True])
def test_tt_apply_matches_jax(rng, shape, in_ndim, quant):
    jt, pt = _tt_pair(rng, shape)
    jl = jax_ttl.tt_linear_from_tt(jt, shape, stack=1, in_ndim=in_ndim,
                                   dtype=jnp.float32, core_dtype=jnp.float32)
    pl = ttl.tt_linear_from_tt(pt, shape, stack=1, in_ndim=in_ndim,
                               dtype=torch.float32, core_dtype=torch.float32)
    assert pl.split == jl.split and pl.in_shape == tuple(jl.in_shape)
    assert_close_scaled(pl.lead, jl.lead, 1e-5)
    if quant:
        jl, pl = jax_ttl.quantize_tt(jl), ttl.quantize_tt(pl)
    x = rng.standard_normal((2, 3, *shape[1:1 + in_ndim])).astype(np.float32)
    for layer in (0, 2, 7):          # 7 clamps to the last layer
        ref = jax_ttl.tt_apply(jnp.asarray(x), jax_ttl.select_layer(jl, layer))
        got = ttl.tt_apply(torch.from_numpy(x), ttl.select_layer(pl, layer))
        assert got.shape == tuple(ref.shape)
        assert_close_scaled(got, ref, 1e-5, 1e-6)
    assert ttl.tt_param_bytes({"t": pl}) == jax_ttl.tt_param_bytes({"t": jl})
    assert ttl.tt_leaf_bytes({"t": pl}) == jax_ttl.tt_leaf_bytes({"t": jl})


def test_dequantize_tt_round_trip(rng):
    _, pt = _tt_pair(rng, (3, 32, 48))
    wide = ttl.tt_linear_from_tt(pt, (3, 32, 48), stack=1, in_ndim=1)
    back = ttl.dequantize_tt(ttl.quantize_tt(wide))
    for g, h in zip(back.cores, wide.cores):
        assert float((g - h).abs().max()) <= float(h.abs().max()) / 254 + 1e-7


def test_spectral_decay_matches_jax(rng):
    tree = {"big": rng.standard_normal((4, 64, 40)).astype(np.float32),
            "small": rng.standard_normal((8, 8)).astype(np.float32)}
    ref = jax_ttl.spectral_decay_pytree(
        {k: jnp.asarray(v) for k, v in tree.items()}, alpha=1.0,
        min_size=1000)
    got = ttl.spectral_decay_pytree(
        {k: torch.from_numpy(v) for k, v in tree.items()}, alpha=1.0,
        min_size=1000)
    assert_close_scaled(got["big"], ref["big"], 1e-4)
    np.testing.assert_array_equal(got["small"].numpy(), tree["small"])
