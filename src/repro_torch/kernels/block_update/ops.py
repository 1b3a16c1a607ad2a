"""Dispatch and wrappers for the compact-WY trailing update.

    block_wy_update(a (M, N), v (M, b), t (b, b))  → A − V Tᵀ Vᵀ A
    block_wy_update_batched(a (B, M, N), v (B, M, b), t (B, b, b))

each as the kernel's two passes, ``wy_vta`` (Y = Vᵀ A) and ``wy_apply``
(A − V W), with W = Tᵀ Y a small ``torch.matmul`` between them (the
reference computes it outside Pallas too).  ``a`` may be a row-strided view
(the trailing block of a larger matrix, last stride 1), and ``out=`` may be
``a`` itself to update in place.  Forming Q = (I − V T Vᵀ) Q is the same
update with ``t.T``.

For CUDA tensors the passes launch ``csrc/block_update.cu``; for tensors on
the CPU they run the plain versions in ``ref.py``.  A failed build or
launch raises.  ``launches`` counts kernel launches per wrapper (pass 1's
two CUDA launches count once), and ``"plain_on_cuda"`` counts calls of the
plain version with a CUDA tensor.  The kernels take panels of at most
``MAX_B`` = 32 reflectors.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.block_update.ref import (
    apply_ref, vta_ref, wy_update_ref,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "block_update.cu"
KERNELS = ("wy_vta", "wy_apply", "wy_vta_batched", "wy_apply_batched")
MAX_B = 32

launches: collections.Counter = collections.Counter()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# pass 1's layout, as csrc/block_update.cu has it (``layout`` reads it back
# on the card): rows per ring stage, and the blocks an SM runs for each
# column tile
STAGE_ROWS = 64          # kStageRows
BLOCKS_PER_SM = {32: 3, 64: 2}
SMS = 132                # the H100's SMs
GRID_YZ = 65535          # gridDim.y (chunks) and gridDim.z (batch) limit


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reset_launches() -> None:
    launches.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    return _build.load_bound(SOURCE, {
        "wy_vta": [_P, _P, _L, _L, _P, _P] + [_I] * 6 + [_P, _P],
        "wy_vta_layout": [_I, _I, _P, _P, _P, _P],
        "wy_apply": [_P, _L, _L, _P, _P, _P, _L, _L] + [_I] * 4 + [_P]})


def build() -> None:
    """Build and load the kernels now (they are otherwise built at first
    use)."""
    _lib()


def tile_cols(n: int) -> int:
    """Pass 1's column tile for N columns: 32 up to 32, else 64."""
    return 32 if n <= 32 else 64


def chunk_plan(m: int, n: int, batch: int):
    """(rows per chunk, chunk count) for pass 1's split of M: chunks of
    whole stages, as many as the SMs run at once at the tile's occupancy
    (one chunk when the column tiles alone fill them, fewer when M has
    fewer stages): a block past that would start a second wave alone."""
    tn = tile_cols(n)
    tiles = _cdiv(n, tn) * batch
    want = max(1, SMS * BLOCKS_PER_SM[tn] // max(tiles, 1))
    nchunk = max(1, min(want, _cdiv(m, STAGE_ROWS), GRID_YZ))
    crows = _cdiv(_cdiv(m, nchunk), STAGE_ROWS) * STAGE_ROWS
    return crows, _cdiv(m, crows)


def layout(n: int, wide: bool) -> dict:
    """Pass 1's layout as the built kernel reports it for N columns on the
    16-byte (``wide``) or 4-byte copy route: stage rows, ring stages,
    column tile and blocks per SM (CUDA's occupancy calculator)."""
    lib = _lib()
    out = [ctypes.c_int() for _ in range(4)]
    code = lib.wy_vta_layout(n, int(wide), *(ctypes.byref(x) for x in out))
    _build.raise_on(lib, code, "wy_vta_layout")
    return dict(zip(("stage_rows", "stages", "tile", "blocks_per_sm"),
                    (x.value for x in out)))


def _check(name, a, v, w_or_t=None):
    tensors = [a, v] + ([w_or_t] if w_or_t is not None else [])
    _build.check_cuda(name, *tensors, dtype=torch.float32)
    if a.stride(-1) != 1 or not v.is_contiguous():
        raise ValueError(f"{name}: a needs unit column stride and v must be "
                         f"contiguous")
    if v.shape[-2] != a.shape[-2] or v.shape[:-2] != a.shape[:-2]:
        raise ValueError(f"{name}: v {tuple(v.shape)} does not fit a "
                         f"{tuple(a.shape)}")
    if v.shape[-1] > MAX_B:
        raise ValueError(f"{name}: panel width {v.shape[-1]} > {MAX_B}")
    if max(a.shape) >= 2**31 or (a.ndim == 3 and a.shape[0] > 65535):
        raise ValueError(f"{name}: shape {tuple(a.shape)} too large")


def _strides(x: torch.Tensor):
    """(row stride, member stride) of a (M, N) or (B, M, N) tensor."""
    return (x.stride(-2), x.stride(0) if x.ndim == 3 else 0)


def _vta(v, a, name):
    _check(name, a, v)
    batch = a.shape[0] if a.ndim == 3 else 1
    m, n = a.shape[-2:]
    b = v.shape[-1]
    y = torch.empty((*a.shape[:-2], b, n), dtype=torch.float32,
                    device=a.device)
    if m == 0 or n == 0 or b == 0:
        return y.zero_()
    crows, nchunk = chunk_plan(m, n, batch)
    part = torch.empty((nchunk, batch, b, n), dtype=torch.float32,
                       device=a.device)
    lda, sa = _strides(a)
    lib = _lib()
    wide = ctypes.c_int()
    code = lib.wy_vta(v.data_ptr(), a.data_ptr(), lda, sa, part.data_ptr(),
                      y.data_ptr(), batch, m, n, b, crows, nchunk,
                      ctypes.byref(wide),
                      torch.cuda.current_stream(a.device).cuda_stream)
    _build.raise_on(lib, code, name)
    launches[name] += 1
    launches[f"{name}_copy{16 if wide.value else 4}"] += 1
    return y


def _apply(a, v, w, out, name):
    _check(name, a, v, w)
    if out is None:
        out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    _build.check_cuda(name, a, out, dtype=torch.float32)
    if out.shape != a.shape or out.stride(-1) != 1:
        raise ValueError(f"{name}: out must match a with unit column stride")
    batch = a.shape[0] if a.ndim == 3 else 1
    m, n = a.shape[-2:]
    b = v.shape[-1]
    if m == 0 or n == 0:
        return out
    w = w.contiguous()
    lda, sa = _strides(a)
    ldo, so = _strides(out)
    lib = _lib()
    code = lib.wy_apply(a.data_ptr(), lda, sa, v.data_ptr(), w.data_ptr(),
                        out.data_ptr(), ldo, so, batch, m, n, b,
                        torch.cuda.current_stream(a.device).cuda_stream)
    _build.raise_on(lib, code, name)
    launches[name] += 1
    return out


def _plain_into(result: torch.Tensor, out: Optional[torch.Tensor]):
    if out is None:
        return result
    out.copy_(result)
    return out


# ---------------------------------------------------------------------------
# The two passes
# ---------------------------------------------------------------------------

def wy_vta(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Pass 1: Y = Vᵀ A, v (M, b), a (M, N) → (b, N) float32."""
    if a.device.type == "cpu":
        return vta_ref(v, a)
    return _vta(v, a, "wy_vta")


def wy_vta_batched(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Pass 1 over a leading batch: (B, M, b), (B, M, N) → (B, b, N)."""
    if a.device.type == "cpu":
        return vta_ref(v, a)
    return _vta(v, a, "wy_vta_batched")


def wy_apply(a, v, w, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pass 2: A − V W, a (M, N), v (M, b), w (b, N); into ``out`` if
    given (which may be ``a``)."""
    if a.device.type == "cpu":
        return _plain_into(apply_ref(a, v, w), out)
    return _apply(a, v, w, out, "wy_apply")


def wy_apply_batched(a, v, w, out: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Pass 2 over a leading batch."""
    if a.device.type == "cpu":
        return _plain_into(apply_ref(a, v, w), out)
    return _apply(a, v, w, out, "wy_apply_batched")


# ---------------------------------------------------------------------------
# The update
# ---------------------------------------------------------------------------

def vta_plain(v, a):
    """Pass 1's plain version, counted when it is given a CUDA tensor."""
    if a.is_cuda:
        launches["plain_on_cuda"] += 1
    return vta_ref(v, a)


def apply_plain(a, v, w):
    """Pass 2's plain version, counted when it is given a CUDA tensor."""
    if a.is_cuda:
        launches["plain_on_cuda"] += 1
    return apply_ref(a, v, w)


def block_wy_update(a: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A ← (I − V T Vᵀ)ᵀ A = A − V Tᵀ Vᵀ A, float32.

    a: (M, N) trailing matrix; v: (M, b) panel reflectors; t: (b, b) WY
    factor."""
    y = wy_vta(v, a)
    return wy_apply(a, v, t.float().T @ y, out)


def block_wy_update_batched(a: torch.Tensor, v: torch.Tensor,
                            t: torch.Tensor,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``block_wy_update`` over a leading batch: (B, M, N), (B, M, b),
    (B, b, b); one launch per pass for the whole batch."""
    y = wy_vta_batched(v, a)
    return wy_apply_batched(a, v, t.float().transpose(1, 2) @ y, out)


__all__ = [
    "BLOCKS_PER_SM", "GRID_YZ", "KERNELS", "MAX_B", "SMS", "STAGE_ROWS",
    "apply_plain", "apply_ref", "block_wy_update", "block_wy_update_batched",
    "build", "chunk_plan", "launches", "layout", "reset_launches",
    "tile_cols", "vta_plain", "vta_ref", "wy_apply", "wy_apply_batched",
    "wy_update_ref", "wy_vta", "wy_vta_batched",
]
