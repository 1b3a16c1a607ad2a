"""Dispatch and wrappers for the δ-truncation kernel (the TRUNCATION module).

    delta_truncate(s (n,), δ)            → (tail norms (n,), rank () int32)
    delta_truncate_batched(s (B, n), δ (B,)) → (tails (B, n), ranks (B,))

For CUDA tensors each launches ``csrc/frob_truncate.cu`` (one kernel a
call: a warp a row up to n = 1,024, a block a row above); for tensors on
the CPU it runs the plain version in ``ref.py``.  A failed build or launch
raises.  ``launches`` counts kernel launches per
wrapper, and ``"plain_on_cuda"`` counts calls of the plain version with a
CUDA tensor (the comparisons in ``chip_smoke.py``; the path never makes
one).  δ may be a Python float or a tensor (a device scalar, or (B,) for
the batched form): no host read of it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.frob_truncate.ref import (
    frob_truncate_ref, tail_norms_ref,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "frob_truncate.cu"
KERNELS = ("frob_truncate", "frob_truncate_batched")

launches: collections.Counter = collections.Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    launches.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    return _build.load_bound(SOURCE, {
        "frob_truncate": [_P, _P, _I, ctypes.c_float, _P, _P, _I, _I, _P]})


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


def _launch(s: torch.Tensor, delta, name: str):
    """s (n,) or (rows, n) on the card, taken as contiguous float32; delta
    a float or a device tensor with one element per row (or one for all).
    Tails in s's shape, ranks in its leading shape.  A call is one kernel
    launch and the few host steps it needs (the wrapper's time is most of
    a call's at the sizes TT-SVD gives it)."""
    if s.dtype != torch.float32 or not s.is_contiguous():
        s = s.float().contiguous()
    dev = s.device
    n = s.shape[-1]
    rows = s.numel() // n if n else 0
    tail = torch.empty_like(s)
    rank = s.new_empty(s.shape[:-1], dtype=torch.int32)
    if rows == 0 or n == 0:
        return tail, rank.fill_(0)
    dptr, stride, dscalar = None, 0, 0.0
    if isinstance(delta, torch.Tensor):
        if delta.device != dev or delta.dtype != torch.float32:
            delta = delta.to(device=dev, dtype=torch.float32)
        if delta.numel() not in (1, rows):
            raise ValueError(f"{name}: {delta.numel()} values of δ for "
                             f"{rows} rows")
        if not delta.is_contiguous():
            delta = delta.contiguous()
        dptr = delta.data_ptr()
        stride = int(delta.numel() > 1)   # one δ for every row: stride 0
    else:
        dscalar = float(delta)
    lib = _lib()
    # the raw stream handle: torch.cuda.current_stream(dev).cuda_stream
    # builds a Stream object, 3.2 µs of a ~16 µs call on an H100's host
    # (PERF.md)
    code = lib.frob_truncate(
        s.data_ptr(), dptr, stride, dscalar, tail.data_ptr(),
        rank.data_ptr(), rows, n, torch._C._cuda_getCurrentRawStream(
            dev.index))
    _build.raise_on(lib, code, name)
    launches[name] += 1
    return tail, rank


def delta_truncate_plain(s: torch.Tensor, delta):
    """The plain version, counted when it is given a CUDA tensor."""
    if s.is_cuda:
        launches["plain_on_cuda"] += 1
    return frob_truncate_ref(s, delta)


def delta_truncate(s: torch.Tensor, delta):
    """(tail norms (n,) float32, rank () int32) under the paper's δ rule
    (Alg. 1 line 28)."""
    if s.ndim != 1:
        raise ValueError(f"expected σ of shape (n,), got {tuple(s.shape)}")
    if s.device.type == "cpu":
        return frob_truncate_ref(s, delta)
    return _launch(s, delta, "frob_truncate")


def delta_truncate_batched(s: torch.Tensor, delta):
    """One launch δ-truncating every row of a (B, n) σ stack; δ is (B,)
    (or a scalar for every row)."""
    if s.ndim != 2:
        raise ValueError(f"expected σ of shape (B, n), got {tuple(s.shape)}")
    if s.device.type == "cpu":
        return frob_truncate_ref(s, delta)
    return _launch(s, delta, "frob_truncate_batched")


__all__ = [
    "KERNELS", "build", "delta_truncate", "delta_truncate_batched",
    "delta_truncate_plain", "frob_truncate_ref", "launches",
    "reset_launches", "tail_norms_ref",
]
