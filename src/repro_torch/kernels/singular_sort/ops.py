"""Dispatch and wrappers for the singular-value sort (the SORTING module).

    sort_singular_values(s (n,))            → (sorted (n,), index (n,) int64)
    sort_singular_values_batched(s (B, n))  → (sorted (B, n), index (B, n))
    sorting_basis(u, s, vt)                 → (U_s, σ_s, V_sᵀ), one matrix
                                              or a leading batch

For CUDA tensors the sorts launch ``csrc/singular_sort.cu`` (one block per
row, a bitonic network on (σ, index) keys held in registers: stages within
a thread or a warp need no barrier); for tensors
on the CPU they run the plain version in ``ref.py``.  The index vector is
the stable ``argsort(-σ)`` either way.  A failed build or launch raises.
``launches`` counts kernel launches per wrapper, and ``"plain_on_cuda"``
counts calls of the plain version with a CUDA tensor.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.singular_sort.ref import (
    permute_bases, sort_desc_ref, sorting_basis_ref,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "singular_sort.cu"
KERNELS = ("bitonic_sort_desc", "bitonic_sort_desc_batched")

launches: collections.Counter = collections.Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    launches.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_bound(SOURCE, {
        "singular_sort": [_P, _P, _P, _I, _I, _I, _P]})
    lib.max_shared_bytes.restype = _I
    return lib


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


def padded_length(n: int) -> int:
    """The power of two (at least 32, one warp) the network sorts a row of
    ``n`` in."""
    return max(32, 1 << max(n - 1, 0).bit_length())


def _launch(s2: torch.Tensor, name: str):
    _build.check_cuda(name, s2, dtype=torch.float32)
    rows, n = s2.shape
    out_s = torch.empty_like(s2)
    out_idx = torch.empty((rows, n), dtype=torch.int64, device=s2.device)
    if rows == 0 or n == 0:
        return out_s, out_idx
    n_pad = padded_length(n)
    lib = _lib()
    if n_pad * 8 > lib.max_shared_bytes():   # one buffer of 8-byte keys
        raise ValueError(f"{name}: n={n} (padded {n_pad}) exceeds one "
                         f"block's shared memory")
    stream = torch.cuda.current_stream(s2.device).cuda_stream
    code = lib.singular_sort(s2.data_ptr(), out_s.data_ptr(),
                             out_idx.data_ptr(), rows, n, n_pad, stream)
    _build.raise_on(lib, code, name)
    launches[name] += 1
    return out_s, out_idx


def sort_desc_plain(s: torch.Tensor):
    """The plain version, counted when it is given a CUDA tensor."""
    if s.is_cuda:
        launches["plain_on_cuda"] += 1
    return sort_desc_ref(s)


def sort_singular_values(s: torch.Tensor):
    """σ (n,) → (sorted descending (n,), index vector (n,) int64)."""
    if s.ndim != 1:
        raise ValueError(f"expected σ of shape (n,), got {tuple(s.shape)}")
    if s.device.type == "cpu":
        return sort_desc_ref(s)
    out_s, idx = _launch(s.float().reshape(1, -1).contiguous(),
                         "bitonic_sort_desc")
    return out_s[0].to(s.dtype), idx[0]


def sort_singular_values_batched(s: torch.Tensor):
    """One launch sorting every row of a (B, n) σ stack descending."""
    if s.ndim != 2:
        raise ValueError(f"expected σ of shape (B, n), got {tuple(s.shape)}")
    if s.device.type == "cpu":
        return sort_desc_ref(s)
    out_s, idx = _launch(s.float().contiguous(), "bitonic_sort_desc_batched")
    return out_s.to(s.dtype), idx


def sorting_basis(u: torch.Tensor, s: torch.Tensor, vt: torch.Tensor):
    """Sorted (U_s, Σ_s, V_sᵀ), the bases permuted by the sort's index
    vector: the paper's SORTING-module contract.  ``s`` (K,) with u (M, K),
    vt (K, N), or a leading batch on all three."""
    if s.ndim == 1:
        s_sorted, idx = sort_singular_values(s)
    else:
        s_sorted, idx = sort_singular_values_batched(s.reshape(-1, s.shape[-1]))
        s_sorted = s_sorted.reshape(s.shape)
        idx = idx.reshape(s.shape)
    return permute_bases(u, s_sorted, vt, idx)


__all__ = [
    "KERNELS", "build", "launches", "padded_length",
    "permute_bases", "reset_launches", "sort_desc_plain", "sort_desc_ref",
    "sort_singular_values", "sort_singular_values_batched", "sorting_basis",
    "sorting_basis_ref",
]
