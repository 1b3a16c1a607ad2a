"""Inputs for holding the flash-attention kernel against its plain version.

One table of shapes and one way to draw a case's inputs, shared by
``chip_smoke.py`` (which checks and times the kernel on the card) and
``tests/test_torch_kernels_cuda.py``:

    case = flash_case(shape, dtype, gen, device)
    case.kernel(), case.plain(), case.library(); q, k, v = case.inputs

``shape`` is ``(B, S, Hq, Hkv, D, causal, window)``; q, k, v are drawn
unit-normal in ``dtype``.  ``case.nbytes`` and ``case.flops`` are what the
function must move and do on these inputs: each of q, k, v read once, o
written once, and 4·D FLOPs (Q Kᵀ and P V) per live (query, key) pair of
each Q head, counted from the mask.

``tiled_gap`` holds the bf16 route to its tile-wise plain version
``ops.mha_tiled`` element by element; ``f64_gap`` holds the float32 route
to ``ops.mha_ref`` run in float64 (``F64_REL``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops

# recurrentgemma-2b's prefill at B = 2, S = 4,096: 10 Q heads, 1 KV head,
# head dim 256, window 2,048
PATH_SHAPE = (2, 4096, 10, 1, 256, True, 2048)
# the JAX package's own sweep (tests/test_kernels.py)
REFERENCE_SHAPES = [
    (2, 256, 4, 2, 64, True, None),
    (1, 128, 8, 8, 32, False, None),
    (2, 256, 4, 1, 64, True, 64),
    (1, 512, 2, 1, 128, True, 128),
]
# causal without a window, non-causal, one block (S = 128), shorter than a
# tile (S = 64, S = 100), every head dim, Hq/Hkv in {1, 2, 10}, windows that
# are no multiple of the tile with S > window + 128
EXTRA_SHAPES = [
    (1, 1024, 10, 1, 256, True, None),
    (1, 512, 10, 1, 256, False, None),
    (1, 512, 4, 2, 128, False, 200),
    (2, 128, 4, 2, 32, True, None),
    (2, 64, 2, 1, 64, True, 16),
    (1, 100, 2, 1, 64, True, None),
    (1, 640, 10, 10, 256, True, 300),
    (1, 384, 4, 4, 128, True, 100),
]
SHAPES = [PATH_SHAPE] + REFERENCE_SHAPES + EXTRA_SHAPES
DTYPES = (torch.float32, torch.bfloat16)
# The bf16 route against ``ops.mha_tiled`` (the same tiles, skips and
# roundings of P), per element: |kernel - tiled| <= TILED_REL·|tiled| +
# TILED_ABS.  TILED_REL covers the kernel's one rounding of O / l to bf16
# (half an ulp, at most 2^-8·|o|); TILED_ABS the two float32 summation
# orders and the rare p that rounds to bf16 the other way under them (one
# bf16 ulp of p, times v / l); set from ``chip_smoke.py``'s readings on an
# H100 (6 draws at every shape; PERF.md), small beside the median |o| of
# 0.03 at the path's shape.
TILED_REL = 2 ** -8
TILED_ABS = 2e-3
# The float32 route (3xTF32) against ``ops.mha_ref`` in float64:
# max|kernel - ref64| <= F64_REL·max|ref64|.  The split leaves each product
# within 2^-21 of exact (lo·lo and the rounding of lo dropped); float32
# accumulation on the tensor cores, up to one ulp of the running sum per
# mma rounded toward zero, over the 3·(D + keys)/8 mma steps a row takes
# (864 at the path's shape) is at most 864·2^-24 ≈ 2^-14.2 of |o| in bias.
# The tile-wise plain version ``ops.mha_tf32x3`` sits at 2^-20 or less on
# the CPU; plain TF32 (hi·hi alone) at 2^-12 to 2^-10.6, which this rejects.
F64_REL = 2 ** -14


@dataclass
class FlashCase:
    inputs: tuple
    kernel: Callable
    plain: Callable
    library: Callable
    nbytes: int
    flops: int


def flash_case(shape, dtype: torch.dtype, gen: torch.Generator,
               device) -> FlashCase:
    b, s, hq, hkv, d, causal, window = shape

    def rn(h):
        return torch.randn((b, s, h, d), generator=gen,
                           device=device).to(dtype)

    q, k, v = rn(hq), rn(hkv), rn(hkv)
    mask = ops.band_mask(s, causal, window, device)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=hq != hkv)

    live = int(mask.sum())
    return FlashCase(
        inputs=(q, k, v),
        kernel=lambda: ops.mha_flash(q, k, v, causal=causal, window=window),
        plain=lambda: ops.mha_flash_plain(q, k, v, causal=causal,
                                          window=window),
        library=library,
        nbytes=(2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
        flops=4 * b * hq * d * live)


def tiled_gap(got: torch.Tensor, tiled: torch.Tensor) -> float:
    """max over elements of |got - tiled| - TILED_REL·|tiled|: the kernel
    agrees with ``mha_tiled`` when this is at most ``TILED_ABS``."""
    return float(((got.float() - tiled).abs() - TILED_REL * tiled.abs())
                 .max())


def f64_gap(got: torch.Tensor, ref64: torch.Tensor) -> float:
    """max|got - ref64| / max|ref64|: the float32 route agrees with float64
    when this is at most ``F64_REL``."""
    return float((got.double() - ref64).abs().max() / ref64.abs().max())
