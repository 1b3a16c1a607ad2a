"""Dispatch and wrapper for the flash-attention (prefill) kernel.

    mha_flash(q (B, S, Hq, D), k, v (B, S, Hkv, D), causal, window)
        → (B, S, Hq, D) in q's dtype

For CUDA tensors it launches ``csrc/flash_attention.cu``, which reads KV
head h // (Hq/Hkv) for Q head h (no repeated KV copy), by one of two routes:
bfloat16 takes the tensor-core kernel (``mma.sync``, P rounded to bf16;
``ref.mha_tiled`` is its tile-wise plain version), float32 the tensor-core
kernel in 3xTF32 (each product hi·hi + hi·lo + lo·hi of TF32 parts;
``ref.mha_tf32x3`` is its tile-wise plain version; within
``cases.f64_bound`` of float64).  For tensors on the CPU it runs the plain
version, ``ref.mha_ref``.  A failed build or launch raises.  The shape
contract is the reference's (``flash_attention`` asserts ``S % min(128, S)
== 0``).
``launches`` counts kernel launches: the total under ``"flash_attention"``
and each route under its own key (``ROUTES``); ``"plain_on_cuda"`` counts
calls of the plain version with a CUDA tensor (the comparisons in
``chip_smoke.py``; the path never makes one).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, band_mask, mha_ref, mha_tf32x3, mha_tiled, tf32_rna,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# route counter and C entry point of each input dtype
ROUTES = {torch.bfloat16: ("flash_attention_mma", "flash_attention_mma_bf16"),
          torch.float32: ("flash_attention_f32", "flash_attention_f32")}
KERNELS = tuple(counter for counter, _ in ROUTES.values())
HEAD_DIMS = (32, 64, 128, 256)      # the kernels' instantiations

launches: collections.Counter = collections.Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    launches.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    sig = [_P] * 4 + [_I] * 7 + [ctypes.c_float, _P]
    return _build.load_bound(SOURCE, {entry: sig for _, entry in
                                      ROUTES.values()})


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


def _check_shapes(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, S, Hq, D) and k, v (B, S, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or hkv == 0 \
            or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if s == 0 or s % min(128, s):
        raise ValueError(f"sequence length {s} is not a multiple of "
                         f"min(128, S), the reference kernel's block")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _launch(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    """Launch the route of q's dtype."""
    name = "flash_attention"
    if not q.is_cuda:
        raise ValueError(f"{name}: expected CUDA tensors, got {q.device}")
    _build.check_cuda(name, q, k, v)
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must start on a 16-byte boundary "
                         f"(the bf16 route copies 16 bytes at a time)")
    b, s, hq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if q.numel() >= 2**31 or b > 65535 or hq > 65535 or s > 65535 * 64:
        raise ValueError(f"{name}: q {tuple(q.shape)} exceeds the grid")
    counter, entry = ROUTES[q.dtype]
    o = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, hq,
        k.shape[2], d, int(causal), 0 if window is None else int(window),
        d ** -0.5, stream)
    _build.raise_on(lib, code, name)
    launches[name] += 1
    launches[counter] += 1
    return o


def mha_flash_plain(q, k, v, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """The plain version, counted when it is given a CUDA tensor."""
    _check_shapes(q, k, v, window)
    if q.is_cuda:
        launches["plain_on_cuda"] += 1
    return mha_ref(q, k, v, causal=causal, window=window)


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention, online softmax in
    float32; (B, S, Hq, D) out in q's dtype."""
    _check_shapes(q, k, v, window)
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


__all__ = [
    "HEAD_DIMS", "KERNELS", "ROUTES", "attention_ref",
    "band_mask", "build", "launches", "mha_flash", "mha_flash_plain",
    "mha_ref", "mha_tf32x3", "mha_tiled", "reset_launches", "tf32_rna",
]
