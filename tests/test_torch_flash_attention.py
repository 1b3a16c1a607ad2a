"""The flash-attention kernel's plain version against the JAX package.

The same unit-normal numpy inputs go through the reference's
``mha_flash`` (its Pallas kernel in interpret mode on the CPU, as
``tests/test_kernels.py`` runs it) and ``attention_ref``, and through the
port's ``mha_flash`` on CPU tensors, which runs the plain version
(``ref.mha_ref``: GQA by indexing, no repeated KV heads).  The sweep is the
reference's own four shapes in both dtypes, plus head dim 256 with one KV
head and a window, with S > window + 128 so that blocks wholly before the
window exist.  Limits are the reference's: 2e-5 absolute in float32 (the
outputs are O(1) and both sides accumulate in float32, so only summation
order differs) and 2e-2 in bfloat16 (one output rounding of a unit-scale
value is up to 2^-8 · 4).

The tensor-core route's tile-wise plain version (``ref.mha_tiled``: the
kernel's blocks, warp slices, skipped tiles, -1e30 masking, base-2 online
softmax, P rounded to the input dtype) is held at every shape of
``cases.REFERENCE_SHAPES`` and ``EXTRA_SHAPES`` against the JAX
``mha_flash`` at the limits above, and against ``mha_ref`` on the same
(rounded) inputs before the output rounding: 2e-5 in float32, and in bf16
2^-8 · max|v| + 2e-5, since rounding p to bf16 moves each weight by at
most 2^-8 of itself (8 significant bits), so the weighted mean of v moves
by at most 2^-8 · max|v|.  ``cases.tiled_gap``, the card's per-element
check of the kernel against ``mha_tiled``, passes the tiled output rounded
once to bf16 and fails one that is off by a few percent on some rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha_flash as jax_mha_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import cases, ops
from repro_torch.kernels.flash_attention.ref import attention_ref

from _torch_port import to_np

SHAPES = [
    (2, 256, 4, 2, 64, True, None),
    (1, 128, 8, 8, 32, False, None),
    (2, 256, 4, 1, 64, True, 64),
    (1, 512, 2, 1, 128, True, 128),
    (1, 384, 2, 1, 256, True, 100),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_port_matches_jax_mha_flash(shape, dtype):
    b, s, hq, hkv, d, causal, win = shape
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(b, s, hq, hkv, d)
    ref = jax_mha_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                        causal=causal, window=win)
    got = ops.mha_flash(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                        causal=causal, window=win)
    assert got.dtype == tdt and got.shape == (b, s, hq, d)
    np.testing.assert_allclose(to_np(got), np.asarray(ref, np.float32),
                               atol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_attention_ref_matches_jax(shape):
    """The (BH, S, D) oracle and the GQA-indexed plain version agree with
    the reference's ``attention_ref`` on repeated KV heads (float32)."""
    b, s, hq, hkv, d, causal, win = shape
    q, k, v = _inputs(b, s, hq, hkv, d, seed=1)
    rep = hq // hkv

    def flat(a):
        a = np.repeat(a, rep, 2) if a.shape[2] != hq else a
        return a.transpose(0, 2, 1, 3).reshape(b * hq, s, d)

    ref = np.asarray(jax_attention_ref(
        *(jnp.asarray(flat(a)) for a in (q, k, v)), causal=causal,
        window=win))
    got = attention_ref(*(torch.from_numpy(flat(a)) for a in (q, k, v)),
                        causal=causal, window=win)
    np.testing.assert_allclose(to_np(got), ref, atol=2e-5)
    mha = ops.mha_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                      causal=causal, window=win)
    np.testing.assert_allclose(
        to_np(mha).transpose(0, 2, 1, 3).reshape(b * hq, s, d), ref,
        atol=2e-5)


@pytest.mark.parametrize("s,hq,hkv,win,match", [
    (200, 2, 1, None, "multiple of min"),
    (256, 3, 2, None, "do not fit"),
    (128, 2, 1, 0, "window"),
])
def test_mha_flash_rejects_bad_shapes(s, hq, hkv, win, match):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, s, hq, hkv, 32))
    with pytest.raises(ValueError, match=match):
        ops.mha_flash(q, k, v, window=win)


def test_cpu_tensors_take_the_plain_version_uncounted():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 64, 2, 1, 32))
    ops.reset_launches()
    out = ops.mha_flash(q, k, v, window=16)
    assert torch.equal(out, ops.mha_ref(q, k, v, window=16))
    assert sum(ops.launches.values()) == 0


TILED_SHAPES = cases.REFERENCE_SHAPES + cases.EXTRA_SHAPES


@pytest.mark.parametrize("shape", TILED_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_route_matches_jax_and_mha_ref(shape, dtype):
    b, s, hq, hkv, d, causal, win = shape
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(b, s, hq, hkv, d, seed=2)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = ops.mha_tiled(tq, tk, tv, causal=causal, window=win)
    assert got.dtype == torch.float32 and got.shape == (b, s, hq, d)
    ref = jax_mha_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                        causal=causal, window=win)
    np.testing.assert_allclose(to_np(got.to(tdt)),
                               np.asarray(ref, np.float32), atol=tol)
    exact = ops.mha_ref(tq.float(), tk.float(), tv.float(), causal=causal,
                        window=win)
    p_tol = 2e-5 if tdt == torch.float32 else (
        2 ** -8 * float(tv.float().abs().max()) + 2e-5)
    np.testing.assert_allclose(to_np(got), to_np(exact), atol=p_tol)


@pytest.mark.parametrize("shape", [(1, 512, 2, 1, 128, True, 128),
                                   (1, 640, 10, 10, 256, True, 300),
                                   (1, 100, 2, 1, 64, True, None)], ids=str)
def test_tiled_gap_takes_one_rounding_and_rejects_a_wrong_kernel(shape):
    b, s, hq, hkv, d, causal, win = shape
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(b, s, hq, hkv, d, seed=3))
    tiled = ops.mha_tiled(q, k, v, causal=causal, window=win)
    assert cases.tiled_gap(tiled.bfloat16(), tiled) <= 0.0
    for rows in (slice(None), slice(s // 2, None)):   # all rows, later rows
        wrong = tiled.clone()
        wrong[:, rows] *= 1.03
        assert cases.tiled_gap(wrong.bfloat16(), tiled) > cases.TILED_ABS


def test_parse_ptxas_reads_registers_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z16flash_mma_kernelILi256EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z16flash_mma_kernelILi256EEvPKf
    256 bytes stack frame, 260 bytes spill stores, 272 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 256 bytes cumulative stack size
ptxas info    : Compile time = 543.998 ms
ptxas info    : Compiling entry function '_Z16flash_mma_kernelILi32EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z16flash_mma_kernelILi32EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 116 registers, used 1 barriers
"""
    assert build.parse_ptxas(log) == {
        "_Z16flash_mma_kernelILi256EEvPKf": (255, 260, 272),
        "_Z16flash_mma_kernelILi32EEvPKf": (116, 0, 0)}
