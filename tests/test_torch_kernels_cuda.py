"""The CUDA kernels against their plain PyTorch versions on the card.

* The four chain kernels (max|Δ| <= 2e-4·max|ref|), at full-width
  qwen1.5-0.5b chain shapes and ragged small ones, B in {1, 4, 64}, with
  float32, bfloat16 and int8 tail cores; and their expert-batched routes
  (the same bound) at olmoe-1b-7b's bank shapes, synthetic depth-3 and
  ragged chains, 64 experts of 1, 4 or 64 tokens and 3 experts of 9, each
  launch counted under its route.
* The TTD-engine kernels (panel factor, WY passes, sort, truncation; the
  case table of ``kernels/engine_cases.py``, shared with ``chip_smoke.py``)
  at full-width shapes, ResNet-32's batched shapes, ragged shapes and
  panels on either side of the shared-memory limit: 2e-4·max|ref|, sorted
  σ, index vectors and ranks exactly equal; and the blocked QR built on
  them.
* The flash-attention kernel (``kernels/flash_attention/cases.py``, shared
  with ``chip_smoke.py``): the hybrid path's shape, the reference's sweep,
  causal without window, non-causal, S in {64, 100, 128}, every head dim,
  Hq/Hkv in {1, 2, 10}, float32 (max|Δ| <= 2e-4·max|ref|) and bfloat16
  (max|Δ| <= 2e-2 on unit-normal inputs, the reference's own limit); the
  route counter that moved (mma for bf16, FMA for float32); in bf16 also
  per element against the route's tile-wise plain version ``mha_tiled``
  (the same roundings of P): |kernel - tiled| <= 2^-8·|tiled| +
  ``cases.TILED_ABS``, half an output ulp plus the float32 summation
  order (``cases.tiled_gap``).

Needs an NVIDIA GPU: the kernels have no CPU mode, so every test here skips
without one.  Imports no JAX, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import engine_cases as ec
from repro_torch.kernels.flash_attention import cases as flash_cases
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.householder import ops as hh
from repro_torch.kernels.tt_contract import cases, ops


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
        assert counts == {name: 1, name[:-len("_batched")]: 1}, counts
        err = float((got - ref).abs().max())
        assert err <= 2e-4 * float(ref.abs().max()), (name, dtype, err)


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
ENGINE_CASES = [(kind, shape) for table in (ENGINE_FULL_SHAPES,
                                            ec.RAGGED_SHAPES)
                for kind, shapes in table.items() for shape in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", ENGINE_CASES)
def test_engine_kernels_match_plain_on_card(cuda_device, kind, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    case = ec.engine_case(kind, shape, gen, cuda_device)
    mod, counter = ec.COUNTERS[kind]
    before = mod.launches[counter]
    got, ref = case.kernel(), case.plain()
    torch.cuda.synchronize()
    ok, _, parts = ec.compare(case, got, ref, 2e-4)
    assert ok, (kind, shape, parts)
    assert mod.launches[counter] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [0, 1])
def test_panel_on_either_side_of_shared_memory(cuda_device, delta):
    rows = hh.smem_rows(32) + delta
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    case = ec.engine_case("panel", (rows, 32), gen, cuda_device)
    ok, _, parts = ec.compare(case, case.kernel(), case.plain(), 2e-4)
    assert ok, (rows, parts)


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
    if dtype == torch.bfloat16:
        q, k, v = case.inputs
        tiled = flash_ops.mha_tiled(q, k, v, causal=shape[5],
                                    window=shape[6])
        gap = flash_cases.tiled_gap(got, tiled)
        assert gap <= flash_cases.TILED_ABS, (shape, gap)


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
