"""Port parity for one TTLinear call from its stored tensors: the plain
version with the lead (``kernels/tt_contract/ref.tt_chain_ref`` and
``tt_chain_experts_ref``, the CPU path of ``tt_apply`` /
``tt_apply_experts``) against the JAX package's ``tt_apply`` /
``tt_apply_experts`` (Pallas kernels in interpret mode) on the same numpy
leaves: stacked chains of depth 2 and 3, split 1 and 2, float32 and int8,
single chains and expert banks of E in {1, 3, 8}.  Also: the r_s = 1 form is
today's absorbed ``tt_contract``; the wrapper's checks raise on bad dtypes
and shapes; the launch plan covers every mode within the kernels' tiles.

Bound: max|Δ| <= 1e-5·max|ref| + 1e-6 (float32 chains summed in another
order; int8 leaves quantize to the same integers in both packages).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tt_linear as jax_ttl
from repro_torch.core import tt_linear as ttl
from repro_torch.kernels.tt_contract import ops, ref

from _torch_port import assert_close_scaled, to_np

REL, ABS = 1e-5, 1e-6
LAYERS = 3

# (in_shape, out_shape, mode dims after the stack, ranks r_s, r_1[, r_2], split)
CHAINS = [
    ((48,), (40,), [48, 40], [4, 6], 1),                # mlp-style, depth 2
    ((32,), (4, 24), [32, 4, 24], [3, 7, 5], 1),        # wq-style, split 1
    ((4, 16), (56,), [4, 16, 56], [5, 6, 9], 2),        # wo-style, split 2
    ((9,), (5, 7), [9, 5, 7], [2, 5, 3], 1),            # ragged, split 1
]


def _leaf_np(rng, dims, ranks, experts=None):
    """(lead table, cores) of a stacked leaf: lead (L[, E], r_s), cores
    (r_s, n_1, r_1), ..., (r_{k-1}, n_k, 1)."""
    lead_shape = (LAYERS, experts, ranks[0]) if experts else (LAYERS,
                                                              ranks[0])
    lead = rng.standard_normal(lead_shape).astype(np.float32)
    rs = list(ranks) + [1]
    cores = [(rng.standard_normal((rs[k], dims[k], rs[k + 1]))
              / np.sqrt(rs[k])).astype(np.float32) for k in range(len(dims))]
    return lead, cores


def _pair(lead, cores, in_shape, out_shape, split, experts, quant):
    jt = jax_ttl.TTLinear(lead=jnp.asarray(lead),
                          cores=[jnp.asarray(c) for c in cores], split=split,
                          in_shape=in_shape, out_shape=out_shape,
                          dtype=jnp.float32, experts=experts)
    pt = ttl.TTLinear(lead=torch.from_numpy(lead),
                      cores=[torch.from_numpy(c) for c in cores],
                      split=split, in_shape=in_shape, out_shape=out_shape,
                      dtype=torch.float32, experts=experts)
    if quant:
        jt, pt = jax_ttl.quantize_tt(jt), ttl.quantize_tt(pt)
        for a, b in zip([jt.lead, *jt.cores], [pt.lead, *pt.cores]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jt, pt


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("in_shape,out_shape,dims,ranks,split", CHAINS)
def test_tt_chain_matches_jax_tt_apply(rng, in_shape, out_shape, dims, ranks,
                                       split, quant):
    lead, cores = _leaf_np(rng, dims, ranks)
    jt, pt = _pair(lead, cores, in_shape, out_shape, split, None, quant)
    x = rng.standard_normal((2, 3, *in_shape)).astype(np.float32)
    for layer in range(LAYERS):
        jl, pl = jax_ttl.select_layer(jt, layer), ttl.select_layer(pt, layer)
        want = jax_ttl.tt_apply(jnp.asarray(x), jl)
        got = ttl.tt_apply(torch.from_numpy(x), pl)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert_close_scaled(got, want, REL, ABS)
        # the plain version itself, on the flattened rows
        plain = ref.tt_chain_ref(
            torch.from_numpy(x).reshape(6, -1), pl.lead, pl.lead_scale,
            pl.cores, pl.scales, split)
        assert_close_scaled(plain, np.asarray(want).reshape(6, -1), REL, ABS)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("experts", [1, 3, 8])
@pytest.mark.parametrize("in_shape,out_shape,dims,ranks,split",
                         [CHAINS[0], CHAINS[1], CHAINS[2]])
def test_tt_chain_experts_matches_jax(rng, in_shape, out_shape, dims, ranks,
                                      split, experts, quant):
    lead, cores = _leaf_np(rng, dims, ranks, experts)
    jt, pt = _pair(lead, cores, in_shape, out_shape, split, experts, quant)
    x = rng.standard_normal((experts, 3, *in_shape)).astype(np.float32)
    for layer in (0, LAYERS - 1):
        jl, pl = jax_ttl.select_layer(jt, layer), ttl.select_layer(pt, layer)
        want = jax_ttl.tt_apply_experts(jnp.asarray(x), jl)
        got = ttl.tt_apply_experts(torch.from_numpy(x), pl)
        assert got.shape == want.shape
        assert_close_scaled(got, want, REL, ABS)
        plain = ref.tt_chain_experts_ref(
            torch.from_numpy(x).reshape(experts, 3, -1), pl.lead,
            pl.lead_scale, pl.cores, pl.scales, split)
        assert_close_scaled(plain, np.asarray(want).reshape(experts, 3, -1),
                            REL, ABS)


@pytest.mark.parametrize("in_shape,out_shape,dims,ranks,split", CHAINS)
def test_rank_one_lead_is_the_absorbed_chain(rng, in_shape, out_shape, dims,
                                             ranks, split):
    """r_s = 1 with no lead (an unstacked leaf) and with lead = [1] equal
    today's ``tt_contract`` over the absorbed chain, bit for bit."""
    _, cores = _leaf_np(rng, dims, [1] + list(ranks[1:]))
    cores = [torch.from_numpy(c) for c in cores]
    x = torch.from_numpy(rng.standard_normal(
        (5, int(np.prod(in_shape)))).astype(np.float32))
    absorbed = ops.tt_contract(x, [cores[0][0]] + cores[1:], split)
    for lead in (None, torch.ones(1)):
        got = ops.tt_chain(x, lead, None, cores, None, split)
        assert torch.equal(got, absorbed)
    # and the quantized tails: the scale product multiplies y once
    q = [ttl.quantize_array(c) for c in cores]
    scales = [s for _, s in q]
    got = ops.tt_chain(x, None, None, [c for c, _ in q], scales, split)
    absorbed = ops.tt_contract(
        x, [q[0][0][0].float() * scales[0]] + [c for c, _ in q[1:]], split,
        scales=[None] + scales[1:])
    assert torch.equal(got, absorbed)


def _args(rng, dtype=torch.float32):
    lead, cores = _leaf_np(rng, [48, 40], [4, 6])
    x = torch.randn(3, 48)
    return (x, torch.from_numpy(lead[0]).to(dtype), None,
            [torch.from_numpy(c).to(dtype) for c in cores], None, 1)


def test_tt_chain_checks(rng):
    """The wrapper raises on what the kernels do not take, on every
    device (here the CPU, before the plain version runs)."""
    x, lead, ls, cores, scales, split = _args(rng)
    ops.tt_chain(x, lead, ls, cores, scales, split)
    with pytest.raises(TypeError, match="x must be"):
        ops.tt_chain(x.double(), lead, ls, cores, scales, split)
    with pytest.raises(TypeError, match="lead"):
        ops.tt_chain(x, lead.bfloat16(), ls, cores, scales, split)
    with pytest.raises(TypeError, match="stored form"):
        ops.tt_chain(x, lead.bfloat16(), ls,
                     [cores[0].bfloat16(), cores[1]], scales, split)
    with pytest.raises(TypeError, match="cores must be"):
        ops.tt_chain(x, lead.double(), ls, [c.double() for c in cores],
                     scales, split)
    q = [ttl.quantize_array(c) for c in cores]
    with pytest.raises(TypeError, match="does not fit"):
        ops.tt_chain(x, lead, ls, [cores[0], q[1][0]], None, split)
    with pytest.raises(TypeError, match="one float32 element"):
        ops.tt_chain(x, lead.to(torch.int8), torch.ones(()),
                     [c for c, _ in q], [torch.ones(2), torch.ones(())],
                     split)
    with pytest.raises(ValueError, match="N_in"):
        ops.tt_chain(x[:, :40].contiguous(), lead, ls, cores, scales, split)
    with pytest.raises(ValueError, match="lead's rank"):
        ops.tt_chain(x, lead[:3].contiguous(), ls, cores, scales, split)
    with pytest.raises(ValueError, match="contiguous"):
        ops.tt_chain(torch.randn(48, 3).t(), lead, ls, cores, scales, split)
    with pytest.raises(ValueError, match="ranks disagree"):
        ops.tt_chain(x, lead, ls, [cores[0], cores[1][:5].contiguous()],
                     scales, split)
    with pytest.raises(ValueError, match="experts"):
        ops.tt_chain_experts(x.reshape(1, 3, 48).expand(2, 3, 48)
                             .contiguous(), lead.reshape(1, 4).contiguous(),
                             ls, cores, scales, split)
    with pytest.raises(ValueError, match="one lead scale"):
        ops.tt_chain_experts(x.reshape(1, 3, 48),
                             lead.reshape(1, 4).to(torch.int8),
                             torch.ones(2), [c.to(torch.int8) for c in cores],
                             [torch.ones(()), torch.ones(())], split)


@pytest.mark.parametrize("shape,split,experts", [
    ((24, 1024, 417, 16, 18, 64), 1, None),     # qwen1.5-0.5b wq
    ((24, 16, 323, 64, 38, 1024), 2, None),     # wo
    ((24, 1024, 31, 2816, 0, 0), 1, None),      # mlp gate/up
    ((992, 2048, 43, 1024, 0, 0), 1, 64),       # olmoe-1b-7b w_gate
    ((977, 1024, 44, 2048, 0, 0), 1, 64),       # w_down
    ((16, 2048, 526, 16, 20, 128), 1, 64),      # a bank of wide rank
    ((37, 70, 5, 300, 0, 0), 1, 3),
])
@pytest.mark.parametrize("b", [1, 4, 64, 8192])
def test_launch_plan_covers_the_modes(shape, split, experts, b):
    """Route and grid of a call: the chunks cover the contracted mode (a
    bank's: its flat (k, r) columns, in tiles of whole 16-column mma steps
    up to 256), the absorb route's chunks are whole 16-row tiles, shared
    memory within the cap; a bank's phase B reads its partials once."""
    rs, n1, r1, n2, r2, n3 = shape
    depth = 3 if r2 else 2
    e = experts or 1
    route = ops._route(split, bool(experts), True, r1)
    kc, nchunk, rows_a, tile_b, n_part, n_t, n_cnt, rc = ops._plan(
        route, e, b, rs, n1, r1, n2, r2, n3, depth, 2)
    n = n1 if split == 1 else n2
    if route == ops._ROUTE_BANK:   # flat (k, r) columns, whole mma tiles
        n = n1 * r1
        assert experts and kc <= ops._BANK_NMAX and kc % 16 == 0
        assert n_t == 0 and n_part == e * nchunk * b * r1
        if depth == 2:   # one phase-B block makes every column: summed once
            assert tile_b * ops._B1_COLS >= n2
    assert kc * nchunk >= n > kc * (nchunk - 1)
    if route != ops._ROUTE_BANK:
        assert n_t == e * b * (r1 if split == 1 else r2)
        assert (n_part > 0) == (nchunk > 1) == (n_cnt > 0)
        if route == ops._ROUTE_ABSORB:
            assert kc % ops._A_KSUB == 0 and 1 <= rows_a <= ops._A_ROWS
    if split == 2:
        assert route == ops._ROUTE_CONTRACT2 and rc <= ops._C_RCHUNK
        assert rc % 4 == 0 and rc * ops._cdiv(r1, rc) >= r1
    assert tile_b >= 1


def test_launch_plan_rejects_oversized_grids():
    with pytest.raises(ValueError, match="grid"):
        ops._plan(ops._ROUTE_ABSORB, 65536, 1, 1, 64, 8, 32, 0, 0, 2, 4)
    with pytest.raises(ValueError, match="shared memory"):
        ops._plan(ops._ROUTE_ABSORB, 1, 4, 1, 64, 20000, 32, 16, 8, 3, 4)


def test_tt_apply_keeps_the_dtype_and_reads_stored_cores(rng):
    """bf16 activations and cores: y comes back in x's dtype, and the CPU
    path equals the plain version on the same stored tensors."""
    lead, cores = _leaf_np(rng, [32, 4, 24], [3, 7, 5])
    pt = ttl.TTLinear(lead=torch.from_numpy(lead).bfloat16(),
                      cores=[torch.from_numpy(c).bfloat16() for c in cores],
                      split=1, in_shape=(32,), out_shape=(4, 24))
    x = torch.randn(2, 32).bfloat16()
    pl = ttl.select_layer(pt, 2)
    got = ttl.tt_apply(x, pl)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, 24)
    want = ref.tt_chain_ref(x, pl.lead, None, pl.cores, None, 1)
    assert torch.equal(got.reshape(2, -1), want.bfloat16())
    assert to_np(got).shape == (2, 4, 24)
