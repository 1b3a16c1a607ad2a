"""Dispatch and wrappers for the δ-truncation kernel (the TRUNCATION module).

    delta_truncate(s (n,), δ)            → (tail norms (n,), rank () int32)
    delta_truncate_batched(s (B, n), δ (B,)) → (tails (B, n), ranks (B,))

For CUDA tensors each launches ``csrc/frob_truncate.cu`` (one block per
row); for tensors on the CPU it runs the plain version in ``ref.py``.  A
failed build or launch raises.  ``launches`` counts kernel launches per
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
    lib = _build.load_bound(SOURCE, {
        "frob_truncate": [_P, _P, ctypes.c_float, _P, _P, _I, _I, _P]})
    lib.max_shared_bytes.restype = _I
    return lib


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


def _launch(s2: torch.Tensor, delta, name: str):
    """s2 (rows, n) float32 on the card; delta a float or a device tensor
    with one element per row (or one for all)."""
    _build.check_cuda(name, s2, dtype=torch.float32)
    rows, n = s2.shape
    lib = _lib()
    if n * 4 > lib.max_shared_bytes():
        raise ValueError(f"{name}: n={n} exceeds one block's shared memory")
    tail = torch.empty_like(s2)
    rank = torch.empty(rows, dtype=torch.int32, device=s2.device)
    if rows == 0 or n == 0:
        return tail, rank.fill_(0)
    dvec, dscalar = None, 0.0
    if isinstance(delta, torch.Tensor):
        dvec = delta.to(device=s2.device, dtype=torch.float32).reshape(-1)
        dvec = dvec.expand(rows).contiguous()
    else:
        dscalar = float(delta)
    stream = torch.cuda.current_stream(s2.device).cuda_stream
    code = lib.frob_truncate(
        s2.data_ptr(), None if dvec is None else dvec.data_ptr(), dscalar,
        tail.data_ptr(), rank.data_ptr(), rows, n, stream)
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
    tail, rank = _launch(s.float().reshape(1, -1).contiguous(), delta,
                         "frob_truncate")
    return tail[0], rank[0]


def delta_truncate_batched(s: torch.Tensor, delta):
    """One launch δ-truncating every row of a (B, n) σ stack; δ is (B,)
    (or a scalar for every row)."""
    if s.ndim != 2:
        raise ValueError(f"expected σ of shape (B, n), got {tuple(s.shape)}")
    if s.device.type == "cpu":
        return frob_truncate_ref(s, delta)
    return _launch(s.float().contiguous(), delta, "frob_truncate_batched")


__all__ = [
    "KERNELS", "build", "delta_truncate", "delta_truncate_batched",
    "delta_truncate_plain", "frob_truncate_ref", "launches",
    "reset_launches", "tail_norms_ref",
]
