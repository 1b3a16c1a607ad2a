"""The CUDA kernels against their plain PyTorch versions on the card.

* The four chain kernels (max|Δ| <= 2e-4·max|ref|) as ``tt_apply`` runs
  them, from the stored tensors with the lead absorbed in phase A
  (``cases.stored_case``), at the full-width stored shapes of qwen1.5-0.5b
  (wq/wo/MLP), olmoe-1b-7b's attention, recurrentgemma-2b (wq, MLP) and
  mamba2-1.3b (w_in 2,048 -> 8,512, whose width is a multiple of 64 but
  not of 128, and w_out) and gemma3-1b (1,152 wide, one KV head of 256,
  MLP 6,912; all also at the prefill's 8,192 rows, as recurrentgemma-2b's)
  and ragged ones, B in {1, 4, 64}, float32,
  bfloat16 and int8 storage; olmoe-1b-7b's three banks and synthetic
  depth-3 and ragged banks at 64 experts of 1, 4 or 64 tokens and 3 of 9,
  bf16 and int8 on the tensor-core route (the route counter), float32 on
  FFMA.  Integer-valued inputs (every partial sum below 2^24) give results
  bit-exact to the float64 product, tensor-core routes included; repeat
  calls are bit-identical; one call is two chain kernels and nothing else
  (the profiler); bf16 x gives a bf16 y within half an output ulp more; a
  captured call replays bit-identical after a larger call.  The
  absorbed-chain API (r_s = 1) of the four kernels at full-width
  qwen1.5-0.5b chain shapes and ragged small ones, and its
  expert-batched routes at olmoe-1b-7b's bank shapes, synthetic depth-3
  and ragged chains, each launch counted under its route.
* The TTD-engine kernels (panel factor, WY passes, sort, truncation; the
  case table of ``kernels/engine_cases.py``, shared with ``chip_smoke.py``)
  at full-width shapes, ResNet-32's batched shapes, ragged shapes and
  panels on either side of the shared-memory limit: 2e-4·max|ref|, sorted
  σ, index vectors and ranks exactly equal; and the blocked QR built on
  them.  Panels also within ``compare``'s panel bounds (V per column, τ,
  R per row, the float64 residual and orthogonality); dense, padded
  (trailing zero columns: V, τ and R exactly zero there) and interior-zero
  fills, each counted under the route it must take (``smem`` up to
  ``smem_rows``, ``tsqr`` above, ``sweep`` for an interior zero column);
  the TSQR route also against its tile-wise plain version
  ``panel_factor_tsqr`` at ``smem_rows(32)`` + {1, 4,096} and 2,883,584
  rows; repeat calls bit-identical.  The sort equal to
  ``torch.sort(stable=True)`` bit for bit, values and indices, on rows with
  ties at n in {1, 5, 100, 2,816, 4,096, 7,680}, single and batched.  The WY cases' A is a trailing view of a wider matrix: 16-byte
  aligned at the full-width shapes (as blocked QR's views), misaligned
  (offset 5) at the ragged ones, and pass 1 must take the matching copy
  route.  Pass 1 also on integer inputs in {−1, 0, 1} at every shape, both
  alignments: equal bit for bit to the float64 product rounded to float32
  (every partial sum is an exact integer); and two calls on the same random
  inputs give equal results.  The blocked SVD (phase 2 in float64) within
  1e-6·σ_max of float64 ``svdvals``.  The truncation kernel around its
  routes (a warp a row up to n = 1,024, a block a row above, chunks past
  4,096): n in {1, 31, 32, 33, 1,024, 1,025, 2,816, 4,096, 4,097,
  8,193}, single and 9 rows, δ a float, a device scalar, one per row, and
  δ keeping rank 1 or n: tails within 2e-4·max|ref|, ranks equal; one
  call is one graph node, a kernel (``cuda_timing.graph_node_types``).
* The flash-attention kernel (``kernels/flash_attention/cases.py``, shared
  with ``chip_smoke.py``): the hybrid path's shape, the reference's sweep,
  causal without window, non-causal, S in {64, 100, 128}, every head dim,
  Hq/Hkv in {1, 2, 10}, float32 (max|Δ| <= 2e-4·max|ref|) and bfloat16
  (max|Δ| <= 2e-2 on unit-normal inputs, the reference's own limit); the
  route counter that moved (mma for bf16, 3xTF32 for float32); in float32
  also against ``mha_ref`` in float64 (``cases.F64_REL`` of max|ref|,
  ``cases.f64_gap``); in bf16 also
  per element against the route's tile-wise plain version ``mha_tiled``
  (the same roundings of P): |kernel - tiled| <= 2^-8·|tiled| +
  ``cases.TILED_ABS``, half an output ulp plus the float32 summation
  order (``cases.tiled_gap``).

Needs an NVIDIA GPU: the kernels have no CPU mode, so every test here skips
without one.  Imports no JAX, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.svd import svd
from repro_torch.core.tt_linear import tt_apply, tt_apply_experts
from repro_torch.kernels import engine_cases as ec
from repro_torch.kernels.block_update import ops as wy
from repro_torch.kernels.flash_attention import cases as flash_cases
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.householder import ops as hh
from repro_torch.kernels.householder import ref as href
from repro_torch.kernels.frob_truncate import ops as ft
from repro_torch.kernels.singular_sort import ops as ss
from repro_torch.kernels.tt_contract import cases, ops

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from cuda_timing import graph_node_types  # noqa: E402


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips (decided at run time) where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


KERNEL_SHAPES = [(kind, shape)
                 for table in (cases.FULL_WIDTH_SHAPES, cases.RAGGED_SHAPES)
                 for kind, shapes in table.items() for shape in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", KERNEL_SHAPES)
@pytest.mark.parametrize("batch", [1, 4, 64])
def test_kernels_match_plain_on_card(cuda_device, kind, shape, batch):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype in cases.TAIL_DTYPES:
        name, kernel, plain, _ = cases.chain_case(kind, shape, batch, dtype,
                                                  gen, cuda_device)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        assert err <= 2e-4 * float(ref.abs().max()), (name, dtype, err)


BATCHED_SHAPES = [(kind, shape) for kind, shapes in
                  cases.BATCHED_SHAPES.items() for shape in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", BATCHED_SHAPES)
@pytest.mark.parametrize("e,c", cases.BATCHED_EC)
def test_batched_kernels_match_plain_on_card(cuda_device, kind, shape, e, c):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype in cases.TAIL_DTYPES:
        name, kernel, plain, _ = cases.batched_case(kind, shape, e, c, dtype,
                                                    gen, cuda_device)
        ops.reset_launches()
        got = kernel()
        counts = dict(ops.launches)
        ref = plain()
        torch.cuda.synchronize()
        # the absorbed API's per-expert first cores run phase A on FFMA
        assert counts == {name: 1, name[:-len("_batched")]: 1,
                          f"{name}_fma": 1}, counts
        err = float((got - ref).abs().max())
        assert err <= 2e-4 * float(ref.abs().max()), (name, dtype, err)


STORED = [(name, split, shapes, None, b)
          for name, (split, shapes) in {**cases.STORED_SHAPES,
                                        **cases.RAGGED_STORED}.items()
          for b in (1, 4, 64)] + [
    (name, split, shapes, None, 8192)
    for name, (split, shapes) in cases.STORED_SHAPES.items()
    if name.startswith(("recurrentgemma", "mamba2", "gemma3"))]
STORED += [(name, split, shapes, e, c)
           for name, (split, shapes) in cases.STORED_BANKS.items()
           for e, c in cases.BATCHED_EC]


def _route(name, dtype, shapes, experts):
    """The launch keys one stored call must add."""
    if not experts:
        return {name: 1}
    route = "fma" if dtype == torch.float32 else "mma"
    return {name: 1, name[:-len("_batched")]: 1, f"{name}_{route}": 1}


# max|Δ| / max|ref| of a call by x's dtype: bf16 x gives a bf16 y, which
# may sit half an output ulp (2^-8·|y|) from the float32 plain version
X_TOL = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -8 + 2e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("what,split,shapes,experts,b", STORED)
@pytest.mark.parametrize("x_dtype", list(X_TOL))
def test_stored_chains_match_plain_on_card(cuda_device, what, split, shapes,
                                           experts, b, x_dtype):
    """One tt_apply / tt_apply_experts call from the stored tensors (the
    lead absorbed in phase A) against the plain version (einsum absorption,
    then the chain, in float32 from the same x), float32, bfloat16 and int8
    storage, float32 x (2e-4·max|ref|) and bf16 x read as bf16 and y
    written as bf16 (2^-8·max|ref| more), as chip_smoke.py; each call
    counted once under its kernel (and a bank under its phase-A route: the
    tensor cores for bf16 and int8)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype in cases.TAIL_DTYPES:
        name, kernel, plain, _ = cases.stored_case(
            split, shapes, b, dtype, gen, cuda_device, experts=experts,
            x_dtype=x_dtype)
        ops.reset_launches()
        got = kernel()
        counts = dict(ops.launches)
        ref = plain()
        torch.cuda.synchronize()
        assert counts == _route(name, dtype, shapes, experts), counts
        assert got.dtype == x_dtype
        err = float((got.float() - ref).abs().max())
        assert err <= X_TOL[x_dtype] * float(ref.abs().max()), (
            what, dtype, err)


def _exact(split, shapes, x, lead, cores, experts):
    """The call's float64 product on the same integer tensors, and the
    largest intermediate magnitude of the chain (x · first core, then
    each core)."""
    d = [c.double() for c in cores]
    last = d[-1].reshape(d[-1].shape[:2])
    if experts:
        t = torch.einsum("ecn,snr,es->ecr", x.double(), d[0], lead.double())
        if len(d) == 2:
            return torch.einsum("ecr,rm->ecm", t, last), t.abs().max()
        t2 = torch.einsum("ecr,rpq->ecpq", t, d[1])
        y = torch.einsum("ecpq,qj->ecpj", t2, last)
        return y.reshape(*y.shape[:2], -1), max(t.abs().max(),
                                                t2.abs().max())
    if split == 2:
        x3 = x.double().reshape(x.shape[0], shapes[0][1], shapes[1][1])
        t = torch.einsum("bap,sar,s->bpr", x3, d[0], lead.double())
        t2 = torch.einsum("bpr,rpq->bq", t, d[1])
        return t2 @ last, max(t.abs().max(), t2.abs().max())
    t = torch.einsum("bn,snr,s->br", x.double(), d[0], lead.double())
    if len(d) == 2:
        return t @ last, t.abs().max()
    t2 = torch.einsum("br,rpq->bpq", t, d[1])
    return (torch.einsum("bpq,qj->bpj", t2, last).reshape(x.shape[0], -1),
            max(t.abs().max(), t2.abs().max()))


EXACT = [(name, split, shapes, None)
         for name, (split, shapes) in cases.STORED_SHAPES.items()
         if name.startswith("qwen")] + [
    (name, split, shapes, 64)
    for name, (split, shapes) in cases.STORED_BANKS.items()]


@pytest.mark.cuda
@pytest.mark.parametrize("what,split,shapes,experts", EXACT)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_integer_inputs_are_exact_on_card(cuda_device, what, split, shapes,
                                          experts, dtype, x_dtype):
    """Integer-valued lead, cores and x (``stored_case(integer=True)``),
    scales 1: every partial sum is an integer below 2^24, so the call
    equals the float64 product bit for bit — on the banks' tensor-core
    routes (bf16 m16n8k16, int8 m16n8k32) and the FFMA routes alike.  With
    bf16 x (exact: its values are -1, 0, 1) y is that product rounded once
    to bf16."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    b = 1 if experts else 4
    lead, ls, cores, scales = cases.stored_tensors(
        shapes, dtype, gen, cuda_device, experts, integer=True)
    leaf = cases.stored_leaf(split, shapes, lead, ls, cores, scales, experts)
    xs = (experts, b, leaf.in_shape[0]) if experts else (b, leaf.in_shape[0])
    x = torch.randint(-1, 2, xs, generator=gen, device=cuda_device).float()
    got = (tt_apply_experts(x.to(x_dtype), leaf) if experts
           else tt_apply(x.to(x_dtype), leaf))
    want, peak = _exact(split, shapes, x, lead, cores, experts)
    assert max(float(peak), float(want.abs().max())) < 2**24
    assert torch.equal(got, want.float().to(x_dtype)), (what, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("what,split,shapes,experts", EXACT)
def test_stored_repeat_calls_are_identical(cuda_device, what, split, shapes,
                                           experts):
    """Fixed-order sums and integer tickets, no float atomics: the same
    call twice gives the same bits, in every storage type."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    for dtype in cases.TAIL_DTYPES:
        _, kernel, _, _ = cases.stored_case(split, shapes, 4, dtype, gen,
                                            cuda_device, experts=experts)
        first = kernel()
        assert torch.equal(first, kernel()), (what, dtype)


@pytest.mark.cuda
def test_one_stored_call_is_two_kernels_on_card(cuda_device):
    """A tt_apply call launches its two chain kernels and nothing else (no
    cast, einsum or elementwise kernel), for a single chain and a bank."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for split, shapes, experts in (
            (*cases.STORED_SHAPES["qwen1.5-0.5b wo"], None),
            (*cases.STORED_BANKS["olmoe-1b-7b w_down"], 64)):
        _, kernel, _, _ = cases.stored_case(split, shapes, 4, torch.bfloat16,
                                            gen, cuda_device, experts=experts,
                                            x_dtype=torch.bfloat16)
        kernel()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kernel()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA for _ in range(e.count)]
        assert len(names) == 2 and all("_kernel" in n for n in names), names


@pytest.mark.cuda
def test_stored_calls_replay_in_a_cuda_graph(cuda_device):
    """A call captured in a CUDA graph (after one call on the capture
    stream) replays to the eager result bit for bit, also after a larger
    call has run outside the graph: a call's scratch comes from the caching
    allocator, so the graph keeps its own.  A capture on a stream no call
    has run on, which would need new ticket counters, raises."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    for (split, shapes), experts, more in (
            (cases.STORED_SHAPES["qwen1.5-0.5b wq/wk/wv"], None, 512),
            (cases.STORED_BANKS["olmoe-1b-7b w_down"], 64, 16)):
        _, kernel, _, _ = cases.stored_case(split, shapes, 4, torch.bfloat16,
                                            gen, cuda_device, experts=experts,
                                            x_dtype=torch.bfloat16)
        want = kernel()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            got = kernel()
        _, larger, _, _ = cases.stored_case(split, shapes, more,
                                            torch.bfloat16, gen, cuda_device,
                                            experts=experts)
        larger()
        got.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want), (shapes, experts)
        g.reset()
    split, shapes = cases.STORED_SHAPES["qwen1.5-0.5b wq/wk/wv"]
    _, kernel, _, _ = cases.stored_case(split, shapes, 4, torch.bfloat16, gen,
                                        cuda_device)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture stream"):
        with torch.cuda.graph(g, stream=torch.cuda.Stream()):
            kernel()


@pytest.mark.cuda
def test_batched_checks(cuda_device):
    x = torch.randn(3, 4, 64, device=cuda_device)
    g0 = torch.randn(3, 64, 8, device=cuda_device)
    g1 = torch.randn(8, 32, device=cuda_device)
    with pytest.raises(ValueError, match="experts"):
        ops.tt_contract_2_batched(x, g0[:2].contiguous(), g1)
    big = torch.zeros(65536, 1, 64, device=cuda_device)
    with pytest.raises(ValueError, match="grid"):
        ops.tt_contract_2_batched(big, torch.zeros(65536, 64, 8,
                                                   device=cuda_device), g1)
    ops.reset_launches()
    y = ops.tt_contract_batched(x, g0, [g1[:, :, None]], 1)
    assert y.shape == (3, 4, 32) and ops.launches["tt_contract_2_batched"] == 1
    ops.reset_launches()


@pytest.mark.cuda
def test_kernel_launch_counts_and_checks(cuda_device):
    x = torch.randn(4, 64, device=cuda_device)
    g0 = torch.randn(64, 8, device=cuda_device)
    g1 = torch.randn(8, 32, device=cuda_device)
    ops.reset_launches()
    ops.tt_contract(x, [g0, g1[:, :, None]], 1)
    assert ops.launches["tt_contract_2"] == 1
    with pytest.raises(TypeError):
        ops.tt_contract_2(x.double(), g0, g1)
    with pytest.raises(ValueError):
        ops.tt_contract_2(x.t().contiguous().t(), g0, g1)
    ops.reset_launches()


# full-width qwen1.5-0.5b (eps 0.2) and ResNet-32 shapes of the engine
# kernels: the tallest panels and WY updates, σ lengths
ENGINE_FULL_SHAPES = {
    "panel": [(2_883_584, 32), (1_048_576, 32), (24_576, 32)],
    "panel_batched": [(9, 576, 32), (9, 4096, 32), (9, 27, 32)],
    "wy_vta": [(24_576, 2_784, 32), (2_883_584, 32, 32)],
    "wy_apply": [(24_576, 2_784, 32), (2_883_584, 32, 32)],
    "wy_vta_batched": [(9, 576, 64, 32), (9, 4096, 32, 32)],
    "wy_apply_batched": [(9, 576, 64, 32), (9, 4096, 32, 32)],
    "sort": [(2_816,), (1_024,)], "sort_batched": [(9, 64), (9, 3)],
    "truncate": [(2_816,), (24,)], "truncate_batched": [(9, 64), (9, 3)],
}
# (kind, shape, aligned): the WY views aligned at full width, not ragged
ENGINE_CASES = [(kind, shape, aligned)
                for table, aligned in ((ENGINE_FULL_SHAPES, True),
                                       (ec.RAGGED_SHAPES, False))
                for kind, shapes in table.items() for shape in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,aligned", ENGINE_CASES)
def test_engine_kernels_match_plain_on_card(cuda_device, kind, shape,
                                            aligned):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    # the main path's panels are dense; the ragged ones keep an interior
    # zero column (the safe branch)
    case = ec.engine_case(kind, shape, gen, cuda_device, aligned,
                          fill="dense" if aligned else "interior_zero")
    mod, counter = ec.COUNTERS[kind]
    before = dict(mod.launches)
    got, ref = case.kernel(), case.plain()
    torch.cuda.synchronize()
    ok, _, parts = ec.compare(case, got, ref, 2e-4)
    assert ok, (kind, shape, parts)
    assert mod.launches[counter] == before.get(counter, 0) + 1
    if kind.startswith("wy_vta"):
        route = ec.vta_route(kind, shape, aligned)
        assert mod.launches[route] == before.get(route, 0) + 1, route


# the truncation kernel's shapes around its routes: one warp a row (n up
# to 32 values a lane, 1,024), one block a row above (4 values a thread,
# chunks of 1,024 threads: 4,096 values)
TRUNCATE_NS = [1, 31, 32, 33, 1_024, 1_025, 2_816, 4_096, 4_097, 8_193]


def _truncate_inputs(n, batch, gen, device):
    shape = (n,) if batch is None else (batch, n)
    s = torch.sort(torch.rand(shape, generator=gen, device=device), dim=-1,
                   descending=True).values
    norm = torch.linalg.vector_norm(s, dim=-1)
    frac = 0.1 + 0.8 * torch.rand(norm.shape, generator=gen, device=device)
    return s, norm, frac * norm


@pytest.mark.cuda
@pytest.mark.parametrize("n", TRUNCATE_NS)
@pytest.mark.parametrize("batch", [None, 9])
@pytest.mark.parametrize("delta", ["float", "scalar", "per_row", "rank_1",
                                   "rank_n"])
def test_truncate_shapes_match_plain_on_card(cuda_device, n, batch, delta):
    """Tails within 2e-4·max|ref| and ranks equal to the plain version's,
    for δ a Python float, a device scalar, one per row, and δ that keeps
    rank 1 (above ‖σ‖) or n (0: no tail is below it); one launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    s, norm, mid = _truncate_inputs(n, batch, gen, cuda_device)
    d = {"float": 0.5 * float(norm.flatten()[0]),
         "scalar": mid.flatten()[0], "per_row": mid,
         "rank_1": 2.0 * float(norm.max()), "rank_n": 0.0}[delta]
    fn = ft.delta_truncate if batch is None else ft.delta_truncate_batched
    counter = "frob_truncate" if batch is None else "frob_truncate_batched"
    before = ft.launches[counter]
    tail, rank = fn(s, d)
    ref_tail, ref_rank = ft.delta_truncate_plain(s, d)
    torch.cuda.synchronize()
    assert ft.launches[counter] == before + 1
    assert tail.shape == s.shape and rank.dtype == torch.int32
    assert float((tail - ref_tail).abs().max()) <= 2e-4 * float(
        ref_tail.abs().max())
    assert torch.equal(rank, ref_rank), (rank, ref_rank)
    if delta == "rank_1":
        assert bool((rank == 1).all())
    if delta == "rank_n":
        assert bool((rank == n).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(64, 9), (2_816, None), (1_025, 3),
                                     (4_097, None)])
def test_truncate_call_is_one_kernel(cuda_device, n, batch):
    """One call enqueues one device kernel and nothing else (no copy, fill
    or cast), read from a CUDA graph of the call."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    s, _, mid = _truncate_inputs(n, batch, gen, cuda_device)
    fn = ft.delta_truncate if batch is None else ft.delta_truncate_batched
    for d in (mid, 0.1):
        types, code = graph_node_types(lambda: fn(s, d))
        assert code == 0 and types == [0], (types, code)


VTA_CASES = [(kind, shape, aligned)
             for table in (ENGINE_FULL_SHAPES, ec.RAGGED_SHAPES)
             for kind in ("wy_vta", "wy_vta_batched")
             for shape in table[kind] for aligned in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,aligned", VTA_CASES)
def test_wy_vta_integer_inputs_are_exact(cuda_device, kind, shape, aligned):
    """Entries in {−1, 0, 1}: every partial sum is an integer far below
    2^24, exact in any order, so a dropped or doubled row shows."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    v, a = ec.wy_inputs(shape, gen, cuda_device, aligned, ints=True)
    fn = wy.wy_vta if kind == "wy_vta" else wy.wy_vta_batched
    route = ec.vta_route(kind, shape, aligned)
    before = wy.launches[route]
    got = fn(v, a)
    torch.cuda.synchronize()
    assert wy.launches[route] == before + 1, route
    assert torch.equal(got, ec.vta_exact(v, a)), (kind, shape, aligned)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,aligned", VTA_CASES)
def test_wy_vta_repeat_calls_are_identical(cuda_device, kind, shape,
                                          aligned):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    v, a = ec.wy_inputs(shape, gen, cuda_device, aligned)
    fn = wy.wy_vta if kind == "wy_vta" else wy.wy_vta_batched
    first = fn(v, a)
    assert torch.equal(first, fn(v, a)), (kind, shape, aligned)


@pytest.mark.cuda
def test_blocked_svd_on_card_within_float64(cuda_device):
    """Phase 2 in float64: the blocked SVD of a tall float32 matrix within
    1e-6·σ_max of float64 svdvals (float32 cuSOLVER: ~3e-5 at this size)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    a = torch.randn(24_576, 1_024, generator=gen, device=cuda_device)
    ref = torch.linalg.svdvals(a.double())
    got = svd(a, hbd_impl="blocked").s.double()
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.max())


def _moved(before, after):
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ec.PANEL_FILLS)
@pytest.mark.parametrize("delta", [0, 1])
def test_panel_on_either_side_of_shared_memory(cuda_device, delta, fill):
    """Each fill one row either side of ``smem_rows(32)``: the one-block
    form below, the TSQR or (interior zero column) sweep route above."""
    rows = hh.smem_rows(32) + delta
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    case = ec.engine_case("panel", (rows, 32), gen, cuda_device, fill=fill)
    route = ec.panel_route((rows, 32), fill, hh.smem_rows(32))
    before = dict(hh.launches)
    got = case.kernel()
    torch.cuda.synchronize()
    assert _moved(before, hh.launches) == {"panel_factor": 1,
                                           f"panel_factor_{route}": 1}
    ok, _, parts = ec.compare(case, got, case.plain(), 2e-4)
    assert ok, (rows, fill, parts)


PANEL_FILL_CASES = [(kind, shape, fill)
                    for kind in ("panel", "panel_batched")
                    for shape in ec.RAGGED_SHAPES[kind]
                    for fill in ec.PANEL_FILLS] + [
    ("panel", (2_883_584, 32), "dense"), ("panel", (2_883_584, 32), "padded"),
    ("panel_batched", (9, 4096, 32), "padded")]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,fill", PANEL_FILL_CASES)
def test_panel_fills_take_their_route_on_card(cuda_device, kind, shape,
                                              fill):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    case = ec.engine_case(kind, shape, gen, cuda_device, fill=fill)
    counter = ec.COUNTERS[kind][1]
    route = ec.panel_route(shape, fill, hh.smem_rows(shape[-1]))
    before = dict(hh.launches)
    got = case.kernel()
    torch.cuda.synchronize()
    assert _moved(before, hh.launches) == {counter: 1,
                                           f"{counter}_{route}": 1}
    ok, _, parts = ec.compare(case, got, case.plain(), 2e-4)
    assert ok, (kind, shape, fill, parts)
    if fill == "padded":
        z = ec.padded_zeros(shape[-1])
        v, tau, r = got
        assert not v[..., -z:].any() and not tau[..., -z:].any()
        assert not r[..., -z:, :].any() and not r[..., :, -z:].any()
    again = case.kernel()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [1, 4_096, 2_883_584])
def test_panel_tsqr_matches_both_plain_versions_on_card(cuda_device, extra):
    """The TSQR route against the sequential plain version and against its
    own tile-wise plain version, both within ``compare``'s bounds."""
    m = extra if extra > 4_096 else hh.smem_rows(32) + extra
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    case = ec.engine_case("panel", (m, 32), gen, cuda_device)
    before = dict(hh.launches)
    got = case.kernel()
    assert _moved(before, hh.launches) == {"panel_factor": 1,
                                           "panel_factor_tsqr": 1}
    (a,) = case.inputs
    for ref in (case.plain(), href.panel_factor_tsqr(a, hh.tsqr_tile_rows(),
                                                     hh.TSQR_CHAINS)):
        ok, _, parts = ec.compare(case, got, ref, 2e-4)
        assert ok, (m, parts)
    assert all(torch.equal(x, y) for x, y in zip(got, case.kernel()))


SORT_SHAPES = [(1,), (5,), (100,), (2_816,), (4_096,), (7_680,),
               (4, 5), (3, 100), (9, 64), (2, 2_816), (2, 4_096),
               (2, 7_680)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SORT_SHAPES, ids=str)
def test_sort_equals_torch_sort_on_card(cuda_device, shape):
    """Rows with many ties: the values and the index vector equal a stable
    descending torch.sort bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    n = shape[-1]
    s = torch.randint(0, max(n // 4, 2), shape, generator=gen,
                      device=cuda_device).float() * 0.25
    fn = (ss.sort_singular_values if len(shape) == 1
          else ss.sort_singular_values_batched)
    got_s, got_i = fn(s)
    ref = torch.sort(s, dim=-1, descending=True, stable=True)
    assert torch.equal(got_s.view(torch.int32), ref.values.view(torch.int32))
    assert torch.equal(got_i, ref.indices)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(24_576, 1_024), (4_096, 9), (40, 33)])
def test_qr_blocked_on_card(cuda_device, m, n):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    a = torch.randn(m, n, generator=gen, device=cuda_device)
    q, r = hh.qr_blocked(a)
    eye = torch.eye(n, device=cuda_device)
    rel = torch.linalg.vector_norm(q @ r - a) / torch.linalg.vector_norm(a)
    assert float(rel) <= 1e-5
    assert float((q.T @ q - eye).abs().max()) <= 1e-5
    ref = torch.linalg.svdvals(a.double())
    d = float((torch.linalg.svdvals(r.double()) - ref).abs().max())
    assert d <= 1e-5 * float(ref.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", flash_cases.SHAPES, ids=str)
@pytest.mark.parametrize("dtype", flash_cases.DTYPES, ids=str)
def test_flash_attention_matches_plain_on_card(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    case = flash_cases.flash_case(shape, dtype, gen, cuda_device)
    before = dict(flash_ops.launches)
    got = case.kernel()
    moved = {k: n - before.get(k, 0) for k, n in flash_ops.launches.items()
             if n != before.get(k, 0)}
    ref = case.plain()
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    err = float((got.float() - ref.float()).abs().max())
    tol = (2e-4 * float(ref.float().abs().max()) if dtype == torch.float32
           else 2e-2)
    assert err <= tol, (shape, dtype, err)
    route = flash_ops.ROUTES[dtype][0]
    assert moved == {"flash_attention": 1, route: 1}, moved
    if dtype == torch.float32:       # 3xTF32 against float64
        ref64 = flash_ops.mha_ref(*(t.double() for t in case.inputs),
                                  causal=shape[5], window=shape[6])
        gap = flash_cases.f64_gap(got, ref64)
        assert gap <= flash_cases.F64_REL, (shape, gap)
    if dtype == torch.bfloat16:
        q, k, v = case.inputs
        tiled = flash_ops.mha_tiled(q, k, v, causal=shape[5],
                                    window=shape[6])
        gap = flash_cases.tiled_gap(got, tiled)
        assert gap <= flash_cases.TILED_ABS, (shape, gap)


@pytest.mark.cuda
def test_flash_f32_accumulates_without_bias_on_card(cuda_device):
    """The float32 route's signed error against float64 at
    ``cases.BIAS_SHAPE`` within ``cases.bias_bound`` of that of ``mha_ref``
    in float32 (cuBLAS, TF32 off) on the same inputs."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = flash_cases.bias_inputs(gen, cuda_device)
    causal, window = flash_cases.BIAS_SHAPE[5:]
    ref64 = flash_ops.mha_ref(q.double(), k.double(), v.double(),
                              causal=causal, window=window)
    plain = flash_cases.signed_bias(
        flash_ops.mha_ref(q, k, v, causal=causal, window=window), ref64)
    got = flash_cases.signed_bias(
        flash_ops.mha_flash(q, k, v, causal=causal, window=window), ref64)
    assert abs(got) <= flash_cases.bias_bound(plain), (got, plain)


@pytest.mark.cuda
def test_flash_attention_checks(cuda_device):
    q = torch.randn(1, 200, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of min"):
        flash_ops.mha_flash(q, q[:, :, :1], q[:, :, :1])
    q = torch.randn(1, 128, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.mha_flash(q, q, q)
    q = torch.randn(1, 128, 2, 64, device=cuda_device)
    with pytest.raises(TypeError):
        flash_ops.mha_flash(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.mha_flash(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                            q)
    for dtype in flash_cases.DTYPES:    # contiguous, one element off 16 bytes
        buf = torch.randn(128 * 2 * 64 + 1, device=cuda_device).to(dtype)
        off = buf[1:].view(1, 128, 2, 64)
        with pytest.raises(ValueError, match="16-byte"):
            flash_ops.mha_flash(off, off, off)
