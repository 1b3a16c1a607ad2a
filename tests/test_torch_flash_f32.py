"""The flash kernel's float32 route (3xTF32 on the tensor cores): its
tile-wise plain version against the JAX package and against float64.

``ref.tf32_rna`` is ``cvt.rna.tf32.f32``: round to 10 mantissa bits, to
nearest, ties away from zero; checked on ties, negatives, values that round
up into the next binade and, bit for bit, against the same rounding done in
float64 on random values.  ``ref.mha_tf32x3`` walks the route's tiles
(``ref.f32_tiles``: 64-row blocks and 32-key tiles, 128 and 16 at D = 256;
16-row warps; the skips and masks) with its products, hi·hi + hi·lo + lo·hi of the TF32 parts.  On the same
unit-normal numpy inputs it is held:

* against the JAX ``mha_flash`` (its Pallas kernel in interpret mode, as
  ``tests/test_kernels.py`` runs it) at the reference's float32 limit of
  2e-5 absolute, at every shape of ``cases.REFERENCE_SHAPES`` and
  ``EXTRA_SHAPES``;
* against ``mha_ref`` run in float64 at ``cases.F64_REL`` of max|ref|, the
  bound the card's kernel is held to (its derivation is beside it in
  ``cases.py``); plain TF32 (hi·hi alone) on the same tiles exceeds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha_flash as jax_mha_flash
from repro_torch.kernels.flash_attention import cases, ops, ref

from _torch_port import to_np

SHAPES = cases.REFERENCE_SHAPES + cases.EXTRA_SHAPES
ULP = 2.0 ** -10


def _inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for h in (hq, hkv, hkv))


@pytest.mark.parametrize("x,want", [
    (1 + ULP / 2, 1 + ULP),                 # tie: away from zero
    (-(1 + ULP / 2), -(1 + ULP)),
    (1 + 3 * ULP / 2, 1 + 2 * ULP),         # tie from an odd last bit
    (1 + ULP / 2 - 2.0 ** -23, 1.0),        # just under a tie
    (1 + ULP / 2 + 2.0 ** -23, 1 + ULP),    # just over
    (2 - ULP / 2, 2.0),                     # up into the next binade
    (-(2 - ULP / 2), -2.0),
    (2 - 2.0 ** -23, 2.0),
    (0.75 - 2.0 ** -25, 0.75),
    (1.5, 1.5), (-3.25, -3.25), (0.0, 0.0),
], ids=str)
def test_tf32_rna_rounds_to_nearest_ties_away(x, want):
    got = ref.tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert float(got[0]) == want


def test_tf32_rna_keeps_the_sign_of_zero_and_matches_float64_rounding():
    assert torch.signbit(ref.tf32_rna(torch.tensor([-0.0])))[0]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20_000) * 10.0 ** rng.integers(-6, 6, 20_000)
         ).astype(np.float32)
    mant, expo = np.frexp(x.astype(np.float64))      # |mant| in [0.5, 1)
    scaled = np.abs(mant) * 2.0 ** 11                # 11 significant bits
    want = np.sign(mant) * np.ldexp(np.floor(scaled + 0.5) / 2.0 ** 11, expo)
    got = ref.tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), want)


def test_split_tf32_parts_are_tf32_and_recover_float32():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        20_000).astype(np.float32))
    hi, lo = ref.split_tf32(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -22 * x.double().abs()).all())
    assert bool((lo.abs() <= 2.0 ** -11 * x.abs()).all())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tf32x3_route_matches_jax_mha_flash(shape):
    b, s, hq, hkv, d, causal, win = shape
    q, k, v = _inputs(b, s, hq, hkv, d, seed=5)
    want = jax_mha_flash(*(jnp.asarray(a) for a in (q, k, v)),
                         causal=causal, window=win)
    got = ops.mha_tf32x3(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=causal, window=win)
    assert got.dtype == torch.float32 and got.shape == (b, s, hq, d)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tf32x3_route_within_the_float64_bound(shape):
    b, s, hq, hkv, d, causal, win = shape
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, s, hq, hkv, d, 6))
    ref64 = ops.mha_ref(q.double(), k.double(), v.double(), causal=causal,
                        window=win)
    assert ref64.dtype == torch.float64
    got = ops.mha_tf32x3(q, k, v, causal=causal, window=win)
    assert cases.f64_gap(got, ref64) <= cases.F64_REL
    # TF32 alone on the same tiles is rejected
    one = ref._walk(q, k, v, causal, win, *ref.f32_tiles(d),
                    lambda a, kt: torch.einsum(ref._QK, ref.tf32_rna(a),
                                               ref.tf32_rna(kt)),
                    lambda p, vt: torch.einsum(ref._PV, ref.tf32_rna(p),
                                               ref.tf32_rna(vt)))
    assert cases.f64_gap(one, ref64) > 2 * cases.F64_REL
