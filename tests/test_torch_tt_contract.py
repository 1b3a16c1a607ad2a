"""Port parity: the PyTorch ``tt_contract`` (plain path on the CPU) against
the JAX package's dispatch (Pallas kernels in interpret mode) on the same
numpy chains, at the shapes of ``tests/test_tt_contract.py``.

Bound: max|Δ| <= 1e-5·max|ref| + 1e-6 (f32 chains summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize_array as jax_quantize_array
from repro.kernels.tt_contract.ops import tt_contract as jax_tt_contract
from repro_torch.core import tt_linear as ttl
from repro_torch.kernels.tt_contract import ops

from _torch_port import assert_close_scaled

REL, ABS = 1e-5, 1e-6

CASES = [
    ([128, 256], [7], 1),                 # mlp-style, tt_contract_2
    ([64, 4, 32], [5, 9], 1),             # wq-style, tt_contract_3 split 1
    ([4, 32, 64], [5, 9], 2),             # wo-style, tt_contract_3 split 2
    ([8, 16, 16, 16], [3, 5, 7], 2),      # depth-4: plain chain
    ([6, 7, 8, 9, 10], [2, 3, 4, 5], 3),  # depth-5: plain chain
]


def _chain(rng, mode_dims, ranks):
    cores = [rng.standard_normal((mode_dims[0], ranks[0])).astype(np.float32)]
    rs = list(ranks) + [1]
    for k in range(1, len(mode_dims)):
        cores.append(rng.standard_normal(
            (rs[k - 1], mode_dims[k], rs[k])).astype(np.float32))
    return cores


@pytest.mark.parametrize("mode_dims,ranks,split", CASES)
@pytest.mark.parametrize("batch", [1, 9])
def test_tt_contract_wide_matches_jax(rng, mode_dims, ranks, split, batch):
    cores = _chain(rng, mode_dims, ranks)
    x = rng.standard_normal(
        (batch, int(np.prod(mode_dims[:split])))).astype(np.float32)
    ref = jax_tt_contract(jnp.asarray(x), [jnp.asarray(c) for c in cores],
                          split)
    got = ops.tt_contract(torch.from_numpy(x),
                          [torch.from_numpy(c) for c in cores], split)
    assert got.dtype == torch.float32
    assert_close_scaled(got, ref, REL, ABS)


@pytest.mark.parametrize("mode_dims,ranks,split", CASES[:3])
def test_tt_contract_int8_matches_jax(rng, mode_dims, ranks, split):
    """Tail cores int8 with per-core scales: the q-kernels' dispatch."""
    cores = _chain(rng, mode_dims, ranks)
    x = rng.standard_normal(
        (6, int(np.prod(mode_dims[:split])))).astype(np.float32)
    jq = [jax_quantize_array(jnp.asarray(c)) for c in cores[1:]]
    ref = jax_tt_contract(jnp.asarray(x),
                          [jnp.asarray(cores[0])] + [q for q, _ in jq], split,
                          scales=[None] + [s for _, s in jq])
    tq = [ttl.quantize_array(torch.from_numpy(c)) for c in cores[1:]]
    for (q_j, s_j), (q_t, s_t) in zip(jq, tq):
        np.testing.assert_array_equal(np.asarray(q_j), q_t.numpy())
        np.testing.assert_allclose(float(s_j), float(s_t), rtol=1e-7)
    got = ops.tt_contract(torch.from_numpy(x),
                          [torch.from_numpy(cores[0])] + [q for q, _ in tq],
                          split, scales=[None] + [s for _, s in tq])
    assert_close_scaled(got, ref, REL, ABS)


def test_dispatch_routes_and_counts(rng):
    """Depth 2/3 go to the four kernels' wrappers (plain on the CPU, which
    is not a launch); deeper chains are counted as plain-path chains."""
    ops.reset_launches()
    for mode_dims, ranks, split in CASES:
        cores = [torch.from_numpy(c) for c in _chain(rng, mode_dims, ranks)]
        x = torch.randn(3, int(np.prod(mode_dims[:split])))
        ops.tt_contract(x, cores, split)
    assert ops.launches["plain_chains"] == 2
    assert all(ops.launches[k] == 0 for k in ops.KERNELS)
    ops.reset_launches()


def test_dense_ref_matches_chain(rng):
    cores = [torch.from_numpy(c) for c in _chain(rng, [4, 32, 64], [5, 9])]
    x = torch.randn(5, 128)
    w = ops.tt_dense_ref(cores, 2)
    assert_close_scaled(ops.tt_contract_ref(x, cores, 2), x @ w, REL, ABS)


def test_chunk_plan_covers_the_mode():
    for n, other in [(1024, 14), (2816, 1), (64, 8), (16, 300), (5, 1)]:
        length, count = ops.chunk_plan(n, other)
        assert length * count >= n > length * (count - 1)
