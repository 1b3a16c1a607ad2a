"""Port parity: Householder bidiagonalization and the two-phase SVD.

HBD: B, the thin U_B (the reference's ``u_b[:, :n]``) and V_Bᵀ to 1e-4
relative.  SVD: σ to 1e-5 relative and U·Σ·Vᵀ to 1e-4 relative (phase-2
signs may differ, so the factors are compared through their product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hbd import householder_bidiagonalize as jax_hbd
from repro.core.svd import svd as jax_svd
from repro.core import truncation as jax_trunc
from repro_torch.core import truncation as trunc
from repro_torch.core.hbd import householder_bidiagonalize
from repro_torch.core.svd import sorting_basis, svd

from _torch_port import assert_close_scaled

SHAPES = [(40, 12), (24, 24), (100, 7), (33, 1)]


def _mat(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_hbd_matches_jax(rng, shape):
    a = _mat(rng, shape)
    m, n = shape
    ju, jb, jvt = (np.asarray(t) for t in jax_hbd(jnp.asarray(a)))
    u, b, vt = householder_bidiagonalize(torch.from_numpy(a))
    assert u.shape == (m, n) and b.shape == (n, n) and vt.shape == (n, n)
    np.testing.assert_array_equal(jb[n:], 0.0)
    assert_close_scaled(b, jb[:n], 1e-4)
    assert_close_scaled(u, ju[:, :n], 1e-4)
    assert_close_scaled(vt, jvt, 1e-4)
    assert_close_scaled(u @ b @ vt, a, 1e-5)


def test_hbd_zero_matrix_takes_the_identity_guard():
    """β = 0 (an all-zero active vector) makes every reflector the
    identity, in both packages."""
    a = np.zeros((9, 4), np.float32)
    ju, jb, jvt = (np.asarray(t) for t in jax_hbd(jnp.asarray(a)))
    u, b, vt = householder_bidiagonalize(torch.from_numpy(a))
    np.testing.assert_array_equal(u.numpy(), ju[:, :4])
    np.testing.assert_array_equal(b.numpy(), jb[:4])
    np.testing.assert_array_equal(vt.numpy(), jvt)


def test_hbd_rank_deficient_reconstructs(rng):
    """With a zero column the last reflector is built from rounding noise
    (so no factor parity is defined), but A = U_B B V_Bᵀ still holds."""
    a = _mat(rng, (30, 8))
    a[:, 1] = 0.0
    u, b, vt = householder_bidiagonalize(torch.from_numpy(a))
    assert_close_scaled(u @ b @ vt, a, 1e-5)


def test_hbd_without_bases(rng):
    a = _mat(rng, (20, 6))
    u, b, vt = householder_bidiagonalize(torch.from_numpy(a),
                                         compute_uv=False)
    assert u is None and vt is None
    _, jb, _ = jax_hbd(jnp.asarray(a))
    assert_close_scaled(b, np.asarray(jb)[:6], 1e-4)


def test_hbd_rejects_wide():
    with pytest.raises(ValueError):
        householder_bidiagonalize(torch.zeros(3, 5))


@pytest.mark.parametrize("shape", [(40, 12), (12, 40), (24, 24), (64, 3)])
@pytest.mark.parametrize("method", ["two_phase", "library"])
def test_svd_matches_jax(rng, shape, method):
    a = _mat(rng, shape)
    ref = jax_svd(jnp.asarray(a), method=method)
    got = svd(torch.from_numpy(a), method=method)
    k = min(shape)
    assert got.u.shape == (shape[0], k) and got.vt.shape == (k, shape[1])
    assert_close_scaled(got.s, ref.s, 1e-5)
    assert np.all(np.diff(got.s.numpy()) <= 0), "σ not descending"
    usv = (got.u * got.s) @ got.vt
    ref_usv = (np.asarray(ref.u) * np.asarray(ref.s)) @ np.asarray(ref.vt)
    assert_close_scaled(usv, ref_usv, 1e-4)


def test_svd_rejects_unknown_paths():
    a = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        svd(a, method="nope")
    with pytest.raises(ValueError, match="hbd_impl"):
        svd(a, hbd_impl="nope")


def test_sorting_basis_is_a_stable_descending_permutation():
    s = torch.tensor([1.0, 3.0, 2.0, 3.0])
    u = torch.eye(4)
    r = sorting_basis(u, s, u)
    assert r.s.tolist() == [3.0, 3.0, 2.0, 1.0]
    assert torch.argmax(r.u, 0).tolist() == [1, 3, 2, 0]


@pytest.mark.parametrize("delta", [0.0, 0.5, 2.0, 100.0])
def test_truncation_matches_jax(rng, delta):
    s = np.sort(np.abs(rng.standard_normal(12)).astype(np.float32))[::-1]
    s = np.ascontiguousarray(s)
    st = torch.from_numpy(s)
    assert trunc.truncation_rank(st, delta) == jax_trunc.truncation_rank(
        s, delta)
    assert int(trunc.truncation_rank_static(st, delta)) == int(
        jax_trunc.truncation_rank_static(jnp.asarray(s), delta))
    assert_close_scaled(trunc.tail_norms(st),
                        jax_trunc.tail_norms(jnp.asarray(s)), 1e-6)
    u = rng.standard_normal((5, 12)).astype(np.float32)
    vt = rng.standard_normal((12, 7)).astype(np.float32)
    ref = jax_trunc.truncate_masked(jnp.asarray(u), jnp.asarray(s),
                                    jnp.asarray(vt), delta)
    got = trunc.truncate_masked(torch.from_numpy(u), st,
                                torch.from_numpy(vt), delta)
    for g, r in zip(got[:3], ref[:3]):
        assert_close_scaled(g, r, 1e-6)
    assert int(got[3]) == int(ref[3])
    assert trunc.delta_threshold(0.1, 4, 3.0) == pytest.approx(
        float(jax_trunc.delta_threshold(0.1, 4, 3.0)))
