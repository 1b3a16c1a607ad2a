"""The panel factorization's TSQR route, rendered tile for tile in PyTorch
(``kernels/householder/ref.panel_factor_tsqr``), against the JAX package's
panel factor: its Pallas kernel in interpret mode up to M = 512 rows, its
plain ``panel_factor_ref`` (jnp) above.

Small tiles (64 or 128 rows) and few leaf chains, so that every case runs
leaf chains of several steps and a tree of one or more steps; b in
{7, 13, 32}; dense panels, panels with trailing zero columns (as
``qr_blocked`` pads N to a multiple of 32), row counts that are not a
multiple of the tile, a leading batch.  Bounds, about ten times the largest
gap measured on these cases (float64 norms):

  * V per column: ||V[:, j] − V_ref[:, j]|| <= 3e-6 ||V_ref[:, j]|| (measured
    <= 2.7e-7); a trailing zero column exactly zero in V, τ and R;
  * τ: |τ − τ_ref| <= 1.2e-6 (measured <= 1.2e-7, one ulp of τ in [1, 2]);
  * R per row: ||R[i] − R_ref[i]|| <= 2.4e-6 ||R_ref[i]|| (measured
    <= 2.4e-7);
  * the factorization returned, Q = (I − V T Vᵀ)[:, :b]: ||A − Q R|| / ||A||
    <= 2e-6 and max|I − QᵀQ| <= 1.2e-6 (measured <= 1.8e-7 and
    <= 1.2e-7).

A panel with a zero column before a nonzero one goes to the sequential
plain version, as the kernel's sweep route does: equal to
``panel_factor_ref`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.householder import ops as jax_hh
from repro.kernels.householder.kernel import (
    panel_factor_batched as jax_panel_batched,
)
from repro_torch.kernels.engine_cases import padded_zeros, panel_quality
from repro_torch.kernels.householder import ref as href

from _torch_port import no_tf32

V_COL, TAU, R_ROW, RES, ORTH = 3e-6, 1.2e-6, 2.4e-6, 2e-6, 1.2e-6

_jax_ref = jax.jit(jax_hh.panel_factor_ref)


@pytest.fixture(autouse=True)
def _f32():
    no_tf32()


def _panel(rng, shape, fill):
    a = rng.standard_normal(shape).astype(np.float32)
    if fill == "padded":
        a[..., shape[-1] - padded_zeros(shape[-1]):] = 0.0
    return a


def _check(a, got, ref, zeros: int = 0):
    """The module docstring's bounds, ``ref`` the JAX package's outputs."""
    v, tau, r = (x.double() for x in got)
    vr, taur, rr = (torch.from_numpy(np.asarray(x, np.float64)) for x in ref)
    col = torch.linalg.vector_norm(v - vr, dim=-2)
    scale = torch.linalg.vector_norm(vr, dim=-2)
    live = scale > 0
    assert bool((col[~live] == 0).all())
    assert float((col[live] / scale[live]).max()) <= V_COL
    assert float((tau - taur).abs().max()) <= TAU
    rows = torch.linalg.vector_norm(r - rr, dim=-1)
    rscale = torch.linalg.vector_norm(rr, dim=-1)
    assert bool((rows[rscale == 0] == 0).all())
    assert float((rows[rscale > 0] / rscale[rscale > 0]).max()) <= R_ROW
    res, orth = panel_quality(torch.from_numpy(a), *got)
    assert res <= RES and orth <= ORTH, (res, orth)
    if zeros:
        assert not got[0][..., -zeros:].any()
        assert not got[1][..., -zeros:].any()
        assert not got[2][..., -zeros:, :].any()
        assert not got[2][..., :, -zeros:].any()


# (M, b, fill, tile rows, leaf chains)
INTERPRET_CASES = [(300, 7, "dense", 64, 2), (512, 13, "padded", 64, 3),
                   (500, 32, "dense", 64, 4), (448, 32, "padded", 64, 2)]
REF_CASES = [(4000, 32, "dense", 64, 8), (3001, 32, "padded", 64, 264),
             (2500, 7, "dense", 128, 5), (1000, 13, "padded", 64, 4),
             (3900, 13, "dense", 64, 3)]


@pytest.mark.parametrize("m,b,fill,tile,chains", INTERPRET_CASES)
def test_tsqr_matches_jax_kernel(rng, m, b, fill, tile, chains):
    a = _panel(rng, (m, b), fill)
    got = href.panel_factor_tsqr(torch.from_numpy(a), tile, chains)
    ref = jax_hh.panel_factor(jnp.asarray(a), interpret=True)
    _check(a, got, ref, padded_zeros(b) if fill == "padded" else 0)


@pytest.mark.parametrize("m,b,fill,tile,chains", REF_CASES)
def test_tsqr_matches_jax_ref(rng, m, b, fill, tile, chains):
    a = _panel(rng, (m, b), fill)
    got = href.panel_factor_tsqr(torch.from_numpy(a), tile, chains)
    _check(a, got, _jax_ref(jnp.asarray(a)),
           padded_zeros(b) if fill == "padded" else 0)


def test_tsqr_batched_matches_jax_kernel(rng):
    a = _panel(rng, (3, 200, 13), "dense")
    a[1, :, 10:] = 0.0             # one member with trailing zeros
    got = href.panel_factor_tsqr(torch.from_numpy(a), 64, 4)
    ref = jax_panel_batched(jnp.asarray(a), interpret=True)
    _check(a, got, ref)
    assert not got[0][1, :, 10:].any() and not got[1][1, 10:].any()


def test_tsqr_interior_zero_takes_the_sequential_route(rng):
    a = _panel(rng, (700, 13), "dense")
    a[:, 2] = 0.0
    got = href.panel_factor_tsqr(torch.from_numpy(a), 64, 4)
    ref = href.panel_factor_ref(torch.from_numpy(a))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_tsqr_all_zero_panel():
    a = torch.zeros(300, 7)
    v, tau, r = href.panel_factor_tsqr(a, 64, 2)
    assert not v.any() and not tau.any() and not r.any()


@pytest.mark.parametrize("m,batch,tile,chains,want", [
    (19_447_808, 1, 512, 264, (144, 264, 37_984)),
    (24_576, 1, 512, 264, (1, 48, 48)),
    (4_096, 9, 512, 264, (1, 8, 8)),
    (4_000, 1, 64, 8, (8, 8, 63)),
])
def test_tsqr_plan(m, batch, tile, chains, want):
    tpb, nblk, ntiles = href.tsqr_plan(m, batch, tile, chains)
    assert (tpb, nblk, ntiles) == want
    assert (nblk - 1) * tpb < ntiles <= nblk * tpb


@pytest.mark.parametrize("masks,want", [
    ([0b0111], True), ([0b0001, 0b0110], True), ([0], True),
    ([0b0101], False), ([0b0100, 0b0001], False), ([0xFFFFFFFF], True),
    ([-1], True), ([0b1110], False),
])
def test_leading_columns(masks, want):
    assert href.leading_columns(masks) is want
