"""Port parity: the TTD-engine kernels' plain versions and the blocked QR /
bidiagonalization / SVD built on them, against the JAX package on the same
numpy inputs (f32, TF32 off).

Each kernel module's CPU path (the plain version the CUDA kernel is held to
on the card) is compared with the JAX kernel in interpret mode and with the
JAX ``ref.py``:

  * panel factor, M <= 512, b in {8, 32}, with a zero column: V, τ, R at
    1e-5·max|ref|, and the zero column takes the ``safe`` branch exactly
    (τ = 0, v = 0);
  * WY update 256 × 192, b = 32: 1e-5·max|ref|;
  * sort with ties: sorted σ equal to the JAX kernel's, index vectors equal
    to the JAX ``ref.py``'s stable argsort; against the JAX bitonic kernel
    only where σ is distinct (its tie order is an artifact of the network);
  * truncation at δ in {0, mid, ∞}: tails at 1e-6 relative, ranks equal.

Blocked QR and the two-phase SVD: factors at 1e-4·max|ref| (singular
vectors sign-aligned pair by pair, since phase 2 is a library SVD in each
package), σ at 1e-5 relative.  The bidiagonal factors (U_B, B, V_Bᵀ) are
held at 5e-4·max|ref|: f32 Householder bidiagonalization amplifies
rounding, and the two packages' factors differ by up to about 3e-4·max on
random inputs even where the QR factors they start from agree to 1e-6 (the
slice-1 unblocked HBD on dense inputs spreads the same way); their
invariants are held tightly (U_B B V_Bᵀ = A at 1e-5, σ(B) = σ(A) at 1e-5).
That gap is rounding, not a difference of algorithm: run in float64 on the
same tall inputs (512 × 64, 2048 × 32), the two packages' unblocked HBDs
agree to 2.5e-13·max (bound here 1e-10), while either one in float32 is up
to 1.4e-4·max off the float64 factors.  The reference casts to float32
inside, so its side runs in a subprocess with ``jax_enable_x64`` and the
module's ``jnp.float32`` read as float64: its code unchanged, and the
other tests keep float32.
"""

import importlib
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as jax_blocked
from repro.kernels.block_update import ops as jax_wy
from repro.kernels.frob_truncate import ops as jax_ft
from repro.kernels.householder import ops as jax_hh
from repro.kernels.singular_sort import ops as jax_ss
from repro_torch.core import blocked
from repro_torch.core.hbd import householder_bidiagonalize
from repro_torch.kernels.block_update import ops as wy
from repro_torch.kernels.frob_truncate import ops as ft
from repro_torch.kernels.householder import ops as hh
from repro_torch.kernels.singular_sort import ops as ss

from _torch_port import assert_close_scaled, no_tf32, to_np

# the package __init__s export a function named ``svd``: take the modules
jax_svd = importlib.import_module("repro.core.svd")
svd_mod = importlib.import_module("repro_torch.core.svd")


@pytest.fixture(autouse=True)
def _f32():
    no_tf32()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# householder panel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,b,zero_col", [(64, 8, 3), (200, 32, 0),
                                          (512, 32, 17), (96, 8, None)])
def test_panel_factor_matches_jax(rng, m, b, zero_col):
    a = rng.standard_normal((m, b)).astype(np.float32)
    if zero_col is not None:
        a[:, zero_col] = 0.0
    got = hh.panel_factor(_t(a))
    for ref in (jax_hh.panel_factor(jnp.asarray(a), interpret=True),
                jax_hh.panel_factor_ref(jnp.asarray(a))):
        for g, r in zip(got, ref):
            assert_close_scaled(g, r, 1e-5)
    if zero_col == 0:         # a zero first column: H_1 = I exactly
        assert float(got[1][0]) == 0.0
        assert not to_np(got[0][:, 0]).any()


def test_panel_factor_batched_matches_jax(rng):
    a = rng.standard_normal((3, 72, 16)).astype(np.float32)
    a[1, :, 5] = 0.0
    got = hh.panel_factor_batched(_t(a))
    ref = jax_hh.panel_factor_batched(jnp.asarray(a), interpret=True)
    for g, r in zip(got, ref):
        assert_close_scaled(g, r, 1e-5)
    for k in range(3):        # member k of the batch == the single call
        single = hh.panel_factor(_t(a[k]))
        for g, s in zip(got, single):
            np.testing.assert_allclose(to_np(g[k]), to_np(s), atol=1e-6)


def test_panel_factor_short_panel_pads_r():
    """Fewer rows than columns: the columns past M get τ = 0 and R's rows
    past M are zero (the blocked QR's last panel of a near-square matrix)."""
    a = np.arange(1, 4 * 6 + 1, dtype=np.float32).reshape(4, 6)
    v, tau, r = hh.panel_factor(_t(a))
    assert v.shape == (4, 6) and r.shape == (6, 6)
    assert not to_np(tau[4:]).any() and not to_np(r[4:]).any()
    q = np.eye(4)
    for j in range(6):
        vj = to_np(v[:, j])
        q = q @ (np.eye(4) - float(tau[j]) * np.outer(vj, vj))
    np.testing.assert_allclose(q @ to_np(r[:4]), a, atol=1e-4)


def test_build_t_matches_jax(rng):
    a = rng.standard_normal((40, 8)).astype(np.float32)
    v, tau, _ = hh.panel_factor(_t(a))
    t = hh.build_t(v, tau)
    assert_close_scaled(t, jax_hh.build_t(jnp.asarray(to_np(v)),
                                          jnp.asarray(to_np(tau))), 1e-5)


# ---------------------------------------------------------------------------
# WY update
# ---------------------------------------------------------------------------

def test_wy_update_matches_jax(rng):
    a = rng.standard_normal((256, 192)).astype(np.float32)
    v = rng.standard_normal((256, 32)).astype(np.float32)
    t = (np.triu(rng.standard_normal((32, 32))) * 0.1).astype(np.float32)
    got = wy.block_wy_update(_t(a), _t(v), _t(t))
    for ref in (jax_wy.block_wy_update(jnp.asarray(a), jnp.asarray(v),
                                       jnp.asarray(t), interpret=True),
                jax_wy.wy_update_ref(jnp.asarray(a), jnp.asarray(v),
                                     jnp.asarray(t))):
        assert_close_scaled(got, ref, 1e-5)
    # the batched form, and the update in place on a row-strided view
    batched = wy.block_wy_update_batched(_t(np.stack([a, -a])),
                                         _t(np.stack([v, v])),
                                         _t(np.stack([t, t])))
    assert_close_scaled(batched[1], -to_np(got), 1e-5)
    wide = _t(np.concatenate([np.zeros((256, 5), np.float32), a], 1))
    view = wide[:, 5:]
    wy.block_wy_update(view, _t(v), _t(t), out=view)
    assert_close_scaled(wide[:, 5:], got, 1e-6)
    assert not to_np(wide[:, :5]).any()


# ---------------------------------------------------------------------------
# singular-value sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 64, 100])
def test_sort_matches_jax(rng, n):
    s = (rng.integers(0, max(n // 3, 2), n) * 0.5).astype(np.float32)
    got_s, got_i = ss.sort_singular_values(_t(s))
    assert got_i.dtype == torch.int64
    ker_s, ker_i = jax_ss.sort_singular_values(jnp.asarray(s),
                                               interpret=True)
    ref_s, ref_i = jax_ss.sort_desc_ref(jnp.asarray(s))
    np.testing.assert_array_equal(to_np(got_s), np.asarray(ker_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(to_np(got_s), np.asarray(ref_s))
    vals, counts = np.unique(s, return_counts=True)
    distinct = np.isin(np.sort(s)[::-1], vals[counts == 1])
    np.testing.assert_array_equal(got_i.numpy()[distinct],
                                  np.asarray(ker_i)[distinct])


def test_sort_batched_and_sorting_basis(rng):
    s = (rng.integers(0, 6, (4, 33)) * 0.5).astype(np.float32)
    got_s, got_i = ss.sort_singular_values_batched(_t(s))
    ker_s, _ = jax_ss.sort_singular_values_batched(jnp.asarray(s),
                                                   interpret=True)
    np.testing.assert_array_equal(to_np(got_s), np.asarray(ker_s))
    for k in range(4):
        np.testing.assert_array_equal(
            got_i[k].numpy(), np.asarray(jax_ss.sort_desc_ref(
                jnp.asarray(s[k]))[1]))
    u = rng.standard_normal((3, 10, 6)).astype(np.float32)
    vt = rng.standard_normal((3, 6, 8)).astype(np.float32)
    sv = np.abs(rng.standard_normal((3, 6))).astype(np.float32)
    us, sv_s, vts = ss.sorting_basis(_t(u), _t(sv), _t(vt))
    for k in range(3):
        ju, js, jvt = jax_ss.sorting_basis(jnp.asarray(u[k]),
                                           jnp.asarray(sv[k]),
                                           jnp.asarray(vt[k]),
                                           interpret=True)
        for g, r in zip((us[k], sv_s[k], vts[k]), (ju, js, jvt)):
            np.testing.assert_array_equal(to_np(g), np.asarray(r))


# ---------------------------------------------------------------------------
# δ-truncation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["zero", "mid", "inf"])
def test_truncate_matches_jax(rng, which):
    s = np.sort(np.abs(rng.standard_normal(50)).astype(np.float32))[::-1]
    s = np.ascontiguousarray(s)
    delta = {"zero": 0.0, "mid": 0.5 * float(np.linalg.norm(s)),
             "inf": float("inf")}[which]
    tail, rank = ft.delta_truncate(_t(s), delta)
    assert rank.dtype == torch.int32
    for rt, rr in (jax_ft.delta_truncate(jnp.asarray(s), delta,
                                         interpret=True),
                   jax_ft.frob_truncate_ref(jnp.asarray(s), delta)):
        np.testing.assert_allclose(to_np(tail), np.asarray(rt), rtol=1e-6)
        assert int(rank) == int(rr)


def test_truncate_batched_matches_jax(rng):
    s = -np.sort(-np.abs(rng.standard_normal((5, 40))), axis=1)
    s = s.astype(np.float32)
    norms = np.linalg.norm(s, axis=1)
    delta = np.array([0.0, 0.3, 0.5, 0.9, np.inf], np.float32) * norms
    delta[-1] = np.inf
    tails, ranks = ft.delta_truncate_batched(_t(s), _t(delta))
    jt, jr = jax_ft.delta_truncate_batched(jnp.asarray(s),
                                           jnp.asarray(delta),
                                           interpret=True)
    np.testing.assert_allclose(to_np(tails), np.asarray(jt), rtol=1e-6)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jr))
    for k in range(5):
        _, r = ft.delta_truncate(_t(s[k]), float(delta[k]))
        assert int(r) == int(ranks[k])


# ---------------------------------------------------------------------------
# blocked QR, blocked bidiagonalization, SVD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,p", [(96, 64, 16), (200, 100, 32),
                                   (64, 64, 32)])
def test_qr_blocked_matches_jax(rng, m, n, p):
    a = rng.standard_normal((m, n)).astype(np.float32)
    q, r = hh.qr_blocked(_t(a), panel=p)
    for jq, jr in (jax_hh.qr_blocked(jnp.asarray(a), panel=p,
                                     interpret=True),
                   jax_blocked.blocked_qr(jnp.asarray(a), panel=p)):
        assert_close_scaled(q, jq, 1e-4)
        assert_close_scaled(r, jr, 1e-4)
    assert not np.tril(to_np(r), -1).any()
    qb, rb = blocked.blocked_qr(_t(np.stack([a, a[::-1].copy()])), panel=p)
    assert_close_scaled(qb[0], q, 1e-5)
    assert_close_scaled(rb[1], jax_blocked.blocked_qr(
        jnp.asarray(a[::-1].copy()), panel=p)[1], 1e-4)


HBD_F64_SHAPES = [(512, 64), (2048, 32)]
_JAX_HBD_F64 = textwrap.dedent("""
    import sys, types
    import numpy as np
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from repro.core import hbd

    class F64(types.ModuleType):
        # jax.numpy with float32 read as float64
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    hbd.jnp = F64("jnp_f64")
    data = np.load(sys.argv[1])
    out = {}
    for key in data.files:
        u, b, vt = hbd.householder_bidiagonalize(jnp.asarray(data[key]))
        assert u.dtype == jnp.float64 and b.dtype == jnp.float64
        out[key + ".u"], out[key + ".b"], out[key + ".vt"] = (
            np.asarray(u), np.asarray(b), np.asarray(vt))
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def hbd_f64(tmp_path_factory):
    """Tall float64 inputs and the reference's HBD of each in float64."""
    rng = np.random.default_rng(0)
    inputs = {f"{m}x{n}": rng.standard_normal((m, n))
              for m, n in HBD_F64_SHAPES}
    tmp = tmp_path_factory.mktemp("hbd_f64")
    np.savez(tmp / "in.npz", **inputs)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [src] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    subprocess.run([sys.executable, "-c", _JAX_HBD_F64, str(tmp / "in.npz"),
                    str(tmp / "out.npz")], env=env, check=True, timeout=120)
    return inputs, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("shape", HBD_F64_SHAPES, ids=str)
def test_hbd_float64_matches_jax_to_rounding(hbd_f64, shape):
    """Same algorithm: in float64 the factors agree to rounding."""
    inputs, ref = hbd_f64
    key = f"{shape[0]}x{shape[1]}"
    n = shape[1]
    u, b, vt = householder_bidiagonalize(torch.from_numpy(inputs[key]))
    assert u.dtype == torch.float64
    for got, want in ((u, ref[key + ".u"][:, :n]), (b, ref[key + ".b"][:n]),
                      (vt, ref[key + ".vt"])):
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= 1e-10 * scale


@pytest.mark.parametrize("shape", [(120, 40), (40, 33), (96, 24)])
def test_blocked_bidiagonalize_matches_jax(rng, shape):
    """Tall inputs, as TT-SVD's unfoldings are (``svd`` transposes wide
    ones); a square random matrix's bidiagonal factors move by 1e-2 under
    rounding alone."""
    a = rng.standard_normal(shape).astype(np.float32)
    got = blocked.blocked_bidiagonalize(_t(a), panel=16)
    ref = jax_blocked.blocked_bidiagonalize(jnp.asarray(a), panel=16)
    for g, r in zip(got, ref):
        assert_close_scaled(g, r, 5e-4)
    u, b, vt = got
    assert_close_scaled(u @ b @ vt, a, 1e-5)
    assert_close_scaled(torch.linalg.svdvals(b),
                        np.linalg.svd(a, compute_uv=False), 1e-5)
    bat = blocked.blocked_bidiagonalize_batched(_t(np.stack([a, 2 * a])),
                                                panel=16)
    for g, r in zip(bat, got):
        assert_close_scaled(g[0], r, 5e-4)


def _aligned(u, vt, ref_u):
    """u, vt with each singular pair's sign flipped to match ref_u."""
    sgn = np.sign(np.sum(to_np(u) * np.asarray(ref_u), axis=-2))
    sgn[sgn == 0] = 1.0
    return to_np(u) * sgn[..., None, :], to_np(vt) * sgn[..., :, None]


@pytest.mark.parametrize("shape", [(96, 40), (30, 70)])
@pytest.mark.parametrize("impl", ["blocked", "unblocked"])
def test_svd_matches_jax(rng, shape, impl):
    a = rng.standard_normal(shape).astype(np.float32)
    got = svd_mod.svd(_t(a), hbd_impl=impl, panel=16)
    ref = jax_svd.svd(jnp.asarray(a), hbd_impl=impl, panel=16)
    assert_close_scaled(got.s, ref.s, 1e-5)
    u, vt = _aligned(got.u, got.vt, ref.u)
    assert_close_scaled(u, ref.u, 1e-4)
    assert_close_scaled(vt, ref.vt, 1e-4)


@pytest.mark.parametrize("impl", ["blocked", "unblocked"])
def test_svd_batched_matches_jax(rng, impl):
    a = rng.standard_normal((3, 48, 20)).astype(np.float32)
    got = svd_mod.svd_batched(_t(a), hbd_impl=impl, panel=8)
    ref = jax_svd.svd_batched(jnp.asarray(a), hbd_impl=impl, panel=8)
    assert_close_scaled(got.s, ref.s, 1e-5)
    u, vt = _aligned(got.u, got.vt, ref.u)
    assert_close_scaled(u, ref.u, 1e-4)
    assert_close_scaled(vt, ref.vt, 1e-4)
    for k in range(3):
        single = svd_mod.svd(_t(a[k]), hbd_impl=impl, panel=8)
        assert_close_scaled(got.s[k], single.s, 1e-6)
    with pytest.raises(ValueError):
        svd_mod.svd_batched(_t(a[0]))
