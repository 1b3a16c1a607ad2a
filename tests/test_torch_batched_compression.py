"""Port parity: the static and batched TT-SVD, the compression planner and
the batched ``TTCompressor`` against the JAX package, on the same numpy
tensors (f32, TF32 off).

* ``ttd_static`` / ``ttd_static_batched``: live ranks equal, cores at
  1e-4·max|ref| once each rank column's sign is aligned (phase 2 is a
  library SVD in each package, whose singular vectors may differ in sign).
* ``build_plan`` on ResNet-32 and reduced qwen1.5-0.5b: the same buckets
  (dims, execution, member shapes and flatten indices in order) and the
  same raw set.  Leaf names differ between the packages (``['a']`` against
  dot paths), so the structure is compared; the fingerprint is
  deterministic within the port.
* ``TTCompressor().compress`` on ResNet-32 under both HBD impls against the
  JAX package's batched compress: ranks, payload and ratio equal, every
  reconstruction within 1e-4 (relative) of the reference's.
* ``configs.resnet32`` gives the arrays of the JAX repo's workload.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import batch_exec as jax_exec
from repro.core import compression as jax_comp
from repro.core import plan as jax_plan
from repro.core import tt as jax_tt
from repro.models.registry import build as jax_build
from repro_torch import tree
from repro_torch.configs.resnet32 import resnet32_params, total_params
from repro_torch.core import batch_exec
from repro_torch.core import compression as comp
from repro_torch.core import plan as plan_mod
from repro_torch.core import tt as tt_mod

from _torch_port import assert_close_scaled, f32_cfg, flat_numpy, no_tf32
from _torch_port import to_np

REPO = Path(__file__).resolve().parent.parent
EPS = 0.2


@pytest.fixture(autouse=True)
def _f32():
    no_tf32()


def _workload_module():
    """The JAX repo's ``benchmarks/workload_resnet32.py``, by file path."""
    path = REPO / "benchmarks" / "workload_resnet32.py"
    spec = importlib.util.spec_from_file_location("workload_resnet32", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def resnet():
    return resnet32_params(seed=0, alpha=1.0)


def test_resnet32_config_equals_the_jax_workload(resnet):
    ref = _workload_module().resnet32_params(seed=0, alpha=1.0)
    assert list(resnet) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(resnet[k], v)
    assert total_params(resnet) == _workload_module().total_params(ref)


# ---------------------------------------------------------------------------
# static / batched TT-SVD
# ---------------------------------------------------------------------------

def _align_cores(cores, ref_cores):
    """Flip each rank column's sign to match the reference (and the next
    core's matching row), then return the aligned cores as numpy."""
    cores = [to_np(c).copy() for c in cores]
    ref_cores = [np.asarray(c) for c in ref_cores]
    for k in range(len(cores) - 1):
        sgn = np.sign(np.einsum("...abc,...abc->...c", cores[k],
                                ref_cores[k]))
        sgn[sgn == 0] = 1.0
        cores[k] = cores[k] * sgn[..., None, None, :]
        cores[k + 1] = cores[k + 1] * sgn[..., :, None, None]
    return cores


@pytest.mark.parametrize("method,impl", [("library", "unblocked"),
                                         ("two_phase", "unblocked"),
                                         ("two_phase", "blocked")])
def test_ttd_static_batched_matches_jax(rng, method, impl):
    w = rng.standard_normal((4, 6, 5, 4)).astype(np.float32)
    w[1] *= np.linspace(1, 0.01, 4, dtype=np.float32)   # ranks differ
    kw = dict(eps=0.1, max_rank=32, svd_method=method, hbd_impl=impl)
    got = tt_mod.ttd_static_batched(torch.from_numpy(w), **kw)
    ref = jax_tt.ttd_static_batched(jnp.asarray(w), **kw)
    np.testing.assert_array_equal(got.ranks.numpy(), np.asarray(ref.ranks))
    for g, r in zip(_align_cores(got.cores, ref.cores), ref.cores):
        assert_close_scaled(g, r, 1e-4)
    for k in range(4):           # member k == the single-tensor call
        single = tt_mod.ttd_static(torch.from_numpy(w[k]), **kw)
        member = tt_mod.static_tt_member(got, k)
        np.testing.assert_array_equal(single.ranks.numpy(),
                                      member.ranks.numpy())
        assert_close_scaled(tt_mod.static_tt_reconstruct(member),
                            tt_mod.static_tt_reconstruct(single), 1e-5)
        crop = tt_mod.static_tt_crop(member)
        assert crop.ranks == tuple(member.ranks.tolist())
        assert_close_scaled(tt_mod.tt_reconstruct(crop),
                            tt_mod.static_tt_reconstruct(member), 1e-6)


def test_ttd_static_matches_jax(rng):
    w = rng.standard_normal((8, 3, 10)).astype(np.float32)
    got = tt_mod.ttd_static(torch.from_numpy(w), eps=0.3, max_rank=6)
    ref = jax_tt.ttd_static(jnp.asarray(w), eps=0.3, max_rank=6)
    np.testing.assert_array_equal(got.ranks.numpy(), np.asarray(ref.ranks))
    for g, r in zip(_align_cores(got.cores, ref.cores), ref.cores):
        assert_close_scaled(g, r, 1e-4)
    assert tt_mod.tt_max_ranks((8, 3, 10), 6) == jax_tt.tt_max_ranks(
        (8, 3, 10), 6)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def _structure(p):
    return ([(b.dims, b.execution, [(m.index, m.shape, m.dims)
                                    for m in b.members])
             for b in p.buckets],
            [(e.index, e.shape) for e in p.raw], p.num_leaves)


def _reduced_qwen():
    jcfg = f32_cfg(jax_get_config("qwen1.5-0.5b"))
    jparams = jax_build(jcfg).init(__import__("jax").random.PRNGKey(0))
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    pparams = params_from_numpy(flat_numpy(jparams),
                                f32_cfg(get_config("qwen1.5-0.5b")))
    return jparams, pparams


@pytest.mark.parametrize("workload", ["resnet32", "qwen1.5-0.5b"])
def test_build_plan_matches_jax(resnet, workload):
    if workload == "resnet32":
        jparams = resnet
        pparams = {k: torch.from_numpy(v) for k, v in resnet.items()}
        pol = dict(eps=EPS)
    else:
        jparams, pparams = _reduced_qwen()
        pol = dict(eps=EPS, min_size=8192)
    ref = jax_plan.build_plan(jparams, jax_comp.CompressionPolicy(**pol))
    got = plan_mod.build_plan(pparams, comp.CompressionPolicy(**pol))
    assert _structure(got) == _structure(ref)
    assert got.tt_params == ref.tt_params
    assert got.batched_launches == ref.batched_launches
    again = plan_mod.build_plan(pparams, comp.CompressionPolicy(**pol))
    assert again.fingerprint == got.fingerprint
    assert got.describe().splitlines()[1:] == ref.describe().splitlines()[1:]
    names = [m.name for b in got.buckets for m in b.members]
    assert all("[" not in n for n in names)            # the port's dot paths


def test_plan_serial_cutoff_and_padding_match_jax():
    params = {"a": np.zeros((16, 12, 3, 3), np.float32),
              "b": np.zeros((16, 10, 3, 3), np.float32),   # pads into a
              "c": np.zeros((64, 48), np.float32)}
    for tol, cutoff in [(0.25, 1 << 24), (0.0, 1 << 24), (0.25, 100)]:
        jp = jax_plan.build_plan(params, jax_comp.CompressionPolicy(
            min_size=256), pad_tolerance=tol, serial_cutoff_elems=cutoff)
        pp = plan_mod.build_plan(params, comp.CompressionPolicy(
            min_size=256), pad_tolerance=tol, serial_cutoff_elems=cutoff)
        assert _structure(pp) == _structure(jp)
    for dims in [(24, 1024, 16, 64), (16, 12, 3, 3), (8, 16, 1187, 32, 32)]:
        assert plan_mod.padded_work_estimate(dims, None) == \
            jax_plan.padded_work_estimate(dims, None)
    for n, ndev in [(5, 1), (5, 2), (0, 3)]:
        assert batch_exec.round_robin_chunks(n, ndev) == \
            jax_exec.round_robin_chunks(n, ndev)


# ---------------------------------------------------------------------------
# batched compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["unblocked", "blocked"])
def test_resnet32_batched_compress_matches_jax(resnet, impl):
    pol = dict(eps=EPS, hbd_impl=impl)
    jpay, jrep = jax_comp.TTCompressor(jax_comp.CompressionPolicy(
        **pol)).compress({k: jnp.asarray(v) for k, v in resnet.items()})
    pparams = {k: torch.from_numpy(v) for k, v in resnet.items()}
    ppay, prep = comp.TTCompressor(comp.CompressionPolicy(**pol)).compress(
        pparams)
    assert prep.total_params == jrep.total_params
    assert prep.payload_params == jrep.payload_params
    assert prep.ratio == jrep.ratio
    assert prep.exec_stats.bucket_launches == jrep.exec_stats.bucket_launches
    assert prep.exec_stats.serial_params == 0
    assert prep.exec_stats.compiles == 0 and prep.exec_stats.cache_hits == 0
    jrec = jax_comp.TTCompressor().decompress(jpay)
    prec = comp.TTCompressor().decompress(ppay)
    n_tt = 0
    for k in resnet:
        assert ppay[k].kind == jpay[k].kind, k
        if ppay[k].kind != "tt":
            continue
        n_tt += 1
        assert ppay[k].tt.ranks == jpay[k].tt.ranks, k
        ref = np.asarray(jrec[k], np.float64)
        err = np.linalg.norm(to_np(prec[k]) - ref) / np.linalg.norm(ref)
        assert err <= 1e-4, (k, err)
        assert np.linalg.norm(to_np(prec[k]) - resnet[k]) <= \
            EPS * np.linalg.norm(resnet[k])
    assert n_tt == 20
    ranks = {ppay[k].tt.ranks for k in resnet if ppay[k].kind == "tt"}
    assert ranks == {(1, 20, 9, 3, 1), (1, 28, 9, 3, 1)}


def test_padded_member_is_cropped_like_jax(rng):
    """A member zero-padded into a larger bucket carries ``crop_dims`` and
    decompresses to its own shape within ε, as in the reference."""
    def low(shape):
        m = rng.standard_normal((shape[0], 3)) @ rng.standard_normal(
            (3, int(np.prod(shape[1:]))))
        return m.reshape(shape).astype(np.float32)

    params = {"a": low((16, 12, 3, 3)), "b": low((16, 10, 3, 3))}
    pol = dict(eps=0.05, min_size=256)
    jpay, jrep = jax_comp.TTCompressor(jax_comp.CompressionPolicy(
        **pol)).compress({k: jnp.asarray(v) for k, v in params.items()})
    ppay, prep = comp.TTCompressor(comp.CompressionPolicy(**pol)).compress(
        {k: torch.from_numpy(v) for k, v in params.items()})
    assert ppay["b"].crop_dims == tuple(jpay["b"].crop_dims) == (16, 10, 3, 3)
    assert ppay["a"].crop_dims is None
    assert prep.payload_params == jrep.payload_params
    rec = comp.TTCompressor().decompress(ppay)
    for k, w in params.items():
        assert rec[k].shape == w.shape
        assert np.linalg.norm(to_np(rec[k]) - w) <= 0.05 * np.linalg.norm(w)
    # the serial plan is the oracle: same ranks for the exact-shape member
    spay, _ = comp.TTCompressor(comp.CompressionPolicy(
        plan="serial", **pol)).compress(
        {k: torch.from_numpy(v) for k, v in params.items()})
    assert spay["a"].tt.ranks == ppay["a"].tt.ranks


def test_default_plan_on_a_model_tree():
    """The default policy on the port's own params tree (NamedTuples, dot
    paths): the compressed tree keeps the params' structure."""
    _, pparams = _reduced_qwen()
    payload, report = comp.TTCompressor(comp.CompressionPolicy(
        eps=EPS, min_size=8192)).compress(pparams)
    flat = tree.leaves_with_paths(payload, is_leaf=comp.is_compressed_param)
    assert [p for p, _ in flat] == [p for p, _ in
                                    tree.leaves_with_paths(pparams)]
    assert set(report.per_param) == {p for p, _ in flat}
    assert report.exec_stats.bucket_launches >= 1
