"""The four CUDA chain kernels against their plain PyTorch versions on the
card (max|Δ| <= 2e-4·max|ref|), at full-width qwen1.5-0.5b chain shapes and
ragged small ones, B in {1, 4, 64}, with float32, bfloat16 and int8 tail
cores.  Needs an NVIDIA GPU: the kernels have no CPU mode, so every test
here skips without one.  Imports no JAX, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

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
