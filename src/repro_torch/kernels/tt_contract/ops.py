"""Dispatch and wrappers for the fused TT-chain contraction kernels.

``tt_contract`` takes the lead-absorbed chain (see ``ref.py``) and picks:

  * depth 2 (split 1)      → ``tt_contract_2`` / ``tt_contract_2q``
  * depth 3 (split 1 or 2) → ``tt_contract_3`` / ``tt_contract_3q``
  * anything else          → ``tt_contract_ref`` (unfused einsum chain)

``tt_contract_batched`` is the expert-batched chain (the reference's
``jax.vmap`` of the same dispatch over the expert axis): x (E, B, N_in)
through E lead-absorbed first cores (E, n1, r1) and one shared tail, in the
same two launches as one chain, the expert axis folded into the kernels'
token-tile grid axis.  Its routes count under the kernel's name and under
``<kernel>_batched``; other depths and splits go to
``tt_contract_batched_ref`` and count as ``"plain_chains"``.

There is no size gate: the CUDA kernels stream their cores through shared
memory in tiles (``csrc/tt_contract.cu``), so every depth-2/3 chain runs
fused whatever its width.  Each wrapper launches its kernel for CUDA
tensors and uses the plain version only for tensors on the CPU; a failed
build or launch raises.  ``launches`` counts kernel launches per wrapper
(and ``"plain_chains"`` counts chains sent to the unfused einsum path), so
a run can show which path it took.

All paths return float32; ``core/tt_linear.tt_apply`` casts back.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.tt_contract.ref import (
    tt_contract_batched_ref, tt_contract_ref, tt_dense_ref, tt_dequant_chain,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "tt_contract.cu"
KERNELS = ("tt_contract_2", "tt_contract_3", "tt_contract_2q",
           "tt_contract_3q")
# the expert-batched routes of the same four kernels (their launch keys)
BATCHED = tuple(f"{k}_batched" for k in KERNELS)

launches: collections.Counter = collections.Counter()

# enough blocks in phase A to cover the H100's 132 SMs about twice
_TARGET_BLOCKS = 264
_ROWS = 8          # token rows per block (kRows in the CUDA source)
_COL_TILE = 32     # kColTile
_S_TILE = 64       # kSTile

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    launches.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.tt_error_string.argtypes = [_I]
    lib.tt_error_string.restype = ctypes.c_char_p
    for sfx in _SUFFIX.values():
        # every entry takes the expert count E first among its ints
        getattr(lib, f"tt_contract_2b_{sfx}").argtypes = [_P] * 6 + [_I] * 7 + [_P]
        for name in (f"tt_contract_3s1b_{sfx}", f"tt_contract_3s2b_{sfx}"):
            getattr(lib, name).argtypes = [_P] * 7 + [_I] * 9 + [_P]
        for name in ("2b", "3s1b", "3s2b"):
            getattr(lib, f"tt_contract_{name}_{sfx}").restype = _I
    return lib


def build() -> None:
    """Build and load the kernels now (they are otherwise built at first
    use)."""
    _lib()


def chunk_plan(n: int, other_blocks: int, min_chunk: int = 1):
    """(chunk length, chunk count) splitting a contracted mode of size ``n``
    so phase A has about ``_TARGET_BLOCKS`` blocks."""
    want = max(1, -(-_TARGET_BLOCKS // max(other_blocks, 1)))
    nchunk = max(1, min(want, -(-n // min_chunk)))
    length = -(-n // nchunk)
    return length, -(-n // length)


def _row_tiles(b: int) -> int:
    return -(-b // _ROWS)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_cuda(x, cores, scale, quantized: bool):
    """Validate one chain (x 2-D, cores[0] 2-D) or an expert batch (x
    (E, B, N_in), cores[0] (E, n1, r1)); returns the tail-dtype suffix."""
    dev = x.device
    batched = x.ndim == 3
    if batched and (cores[0].ndim != 3 or cores[0].shape[0] != x.shape[0]):
        raise ValueError(f"x {tuple(x.shape)} and first cores "
                         f"{tuple(cores[0].shape)} disagree on the experts")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if cores[0].dtype != torch.float32:
        raise TypeError(f"the lead-absorbed core must be float32, "
                        f"got {cores[0].dtype}")
    tail = {g.dtype for g in cores[1:]}
    if len(tail) != 1:
        raise TypeError(f"tail cores must share one dtype, got {tail}")
    (tdt,) = tail
    if quantized != (tdt == torch.int8) or tdt not in _SUFFIX:
        raise TypeError(f"tail core dtype {tdt} does not fit this kernel")
    tensors = [x, *cores] + ([scale] if scale is not None else [])
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.numel() != 1):
        raise TypeError("scale must be one float32 element")
    if max(*x.shape, *(d for g in cores for d in g.shape)) >= 2**31:
        raise ValueError("dimension too large for the kernels' int indices")
    experts, b = (x.shape[0], x.shape[1]) if batched else (1, x.shape[0])
    if experts * _row_tiles(b) > 65535:
        raise ValueError(f"{experts} expert(s) x batch {b} exceed the "
                         f"kernels' grid (65,535 token tiles)")
    return _SUFFIX[tdt]


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        msg = _lib().tt_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")


def _experts(x):
    """(E, lead shape of y) for one chain (x 2-D) or an expert batch."""
    return (x.shape[0], x.shape[:1]) if x.ndim == 3 else (1, ())


def _count(name: str, batched: bool) -> None:
    launches[name] += 1
    if batched:
        launches[f"{name}_batched"] += 1


def _launch_2(x, g0, g1, scale, name):
    """x (B, n1) or (E, B, n1); g0 (n1, r1) or (E, n1, r1) f32; g1 (r1, n2)
    shared by the experts."""
    sfx = _check_cuda(x, [g0, g1], scale, quantized=name.endswith("q"))
    e, lead = _experts(x)
    b, n1 = x.shape[-2:]
    r1, n2 = g1.shape
    y = torch.empty((*lead, b, n2), dtype=torch.float32, device=x.device)
    if b == 0 or e == 0:
        return y
    kchunk, nchunk = chunk_plan(
        n1, -(-r1 // _COL_TILE) * e * _row_tiles(b), min_chunk=32)
    part = torch.empty((e, nchunk, b, r1), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = getattr(_lib(), f"tt_contract_2b_{sfx}")(
        x.data_ptr(), g0.data_ptr(), g1.data_ptr(), _ptr(scale),
        part.data_ptr(), y.data_ptr(), e, b, n1, r1, n2, kchunk, nchunk,
        stream)
    _raise_on(code, name)
    _count(name, x.ndim == 3)
    return y


def _launch_3(x, g0, g1, g2, scale, split, name):
    """x (B, N_in) or (E, B, N_in); g0 (n1, r1) or (E, n1, r1) f32; g1
    (r1, n2, r2) and g2 (r2, n3) shared by the experts."""
    sfx = _check_cuda(x, [g0, g1, g2], scale, quantized=name.endswith("q"))
    e, lead = _experts(x)
    b = x.shape[-2]
    n1, r1 = g0.shape[-2:]
    _, n2, r2 = g1.shape
    n3 = g2.shape[1]
    n_out = n2 * n3 if split == 1 else n3
    y = torch.empty((*lead, b, n_out), dtype=torch.float32, device=x.device)
    if b == 0 or e == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tiles = e * _row_tiles(b)
    if split == 1:
        chunk, nchunk = chunk_plan(
            n1, -(-r1 // _COL_TILE) * tiles, min_chunk=32)
        r_part = r1
        fn = getattr(_lib(), f"tt_contract_3s1b_{sfx}")
        dims = (e, b, n1, r1, n2, r2, n3)
    else:
        chunk, nchunk = chunk_plan(n2, -(-r2 // _S_TILE) * tiles)
        r_part = r2
        fn = getattr(_lib(), f"tt_contract_3s2b_{sfx}")
        dims = (e, b, n1, n2, r1, r2, n3)
    part = torch.empty((e, nchunk, b, r_part), dtype=torch.float32,
                       device=x.device)
    code = fn(x.data_ptr(), g0.data_ptr(), g1.data_ptr(), g2.data_ptr(),
              _ptr(scale), part.data_ptr(), y.data_ptr(), *dims, chunk,
              nchunk, stream)
    _raise_on(code, name)
    _count(name, x.ndim == 3)
    return y


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle chip_smoke.py compares with)
# ---------------------------------------------------------------------------

def tt_contract_2_plain(x, g0, g1, scale=None):
    y = tt_contract_ref(x, [g0, g1.reshape(*g1.shape[:2], 1)], 1)
    return y if scale is None else y * scale.float().reshape(())


def tt_contract_3_plain(x, g0, g1, g2, split: int, scale=None):
    y = tt_contract_ref(x, [g0, g1, g2.reshape(*g2.shape[:2], 1)], split)
    return y if scale is None else y * scale.float().reshape(())


def tt_contract_2_batched_plain(x3, g0b, g1, scale=None):
    y = tt_contract_batched_ref(x3, g0b, [g1.reshape(*g1.shape[:2], 1)], 1)
    return y if scale is None else y * scale.float().reshape(())


def tt_contract_3_batched_plain(x3, g0b, g1, g2, split: int, scale=None):
    y = tt_contract_batched_ref(
        x3, g0b, [g1, g2.reshape(*g2.shape[:2], 1)], split)
    return y if scale is None else y * scale.float().reshape(())


# ---------------------------------------------------------------------------
# The four kernels' wrappers
# ---------------------------------------------------------------------------

def tt_contract_2(x, g0, g1):
    """(B, n1) · g0 (n1, r1) · g1 (r1, n2) → (B, n2) f32; wide tail core."""
    if x.device.type == "cpu":
        return tt_contract_2_plain(x, g0, g1)
    return _launch_2(x, g0, g1, None, "tt_contract_2")


def tt_contract_2q(x, g0, g1, scale):
    """``tt_contract_2`` with g1 int8; ``scale`` (one f32) multiplies y."""
    if x.device.type == "cpu":
        return tt_contract_2_plain(x, g0, g1, scale)
    return _launch_2(x, g0, g1, scale, "tt_contract_2q")


def tt_contract_3(x, g0, g1, g2, split: int):
    """3-core chain; g1 (r1, n2, r2), g2 (r2, n3).  split=1: x (B, n1) →
    (B, n2·n3); split=2: x (B, n1·n2) → (B, n3)."""
    if split not in (1, 2):
        raise ValueError(f"split must be 1 or 2, got {split}")
    if x.device.type == "cpu":
        return tt_contract_3_plain(x, g0, g1, g2, split)
    return _launch_3(x, g0, g1, g2, None, split, "tt_contract_3")


def tt_contract_3q(x, g0, g1, g2, scale, split: int):
    """``tt_contract_3`` with g1 and g2 int8; ``scale`` multiplies y."""
    if split not in (1, 2):
        raise ValueError(f"split must be 1 or 2, got {split}")
    if x.device.type == "cpu":
        return tt_contract_3_plain(x, g0, g1, g2, split, scale)
    return _launch_3(x, g0, g1, g2, scale, split, "tt_contract_3q")


# ---------------------------------------------------------------------------
# Their expert-batched routes: x (E, B, N_in), g0b (E, n1, r1), shared tails
# ---------------------------------------------------------------------------

def tt_contract_2_batched(x3, g0b, g1):
    """E depth-2 chains sharing g1 (r1, n2) → (E, B, n2) f32."""
    if x3.device.type == "cpu":
        return tt_contract_2_batched_plain(x3, g0b, g1)
    return _launch_2(x3, g0b, g1, None, "tt_contract_2")


def tt_contract_2q_batched(x3, g0b, g1, scale):
    """``tt_contract_2_batched`` with g1 int8; ``scale`` multiplies y."""
    if x3.device.type == "cpu":
        return tt_contract_2_batched_plain(x3, g0b, g1, scale)
    return _launch_2(x3, g0b, g1, scale, "tt_contract_2q")


def tt_contract_3_batched(x3, g0b, g1, g2, split: int):
    """E depth-3 chains sharing g1 (r1, n2, r2) and g2 (r2, n3)."""
    if split not in (1, 2):
        raise ValueError(f"split must be 1 or 2, got {split}")
    if x3.device.type == "cpu":
        return tt_contract_3_batched_plain(x3, g0b, g1, g2, split)
    return _launch_3(x3, g0b, g1, g2, None, split, "tt_contract_3")


def tt_contract_3q_batched(x3, g0b, g1, g2, scale, split: int):
    """``tt_contract_3_batched`` with g1 and g2 int8; ``scale``
    multiplies y."""
    if split not in (1, 2):
        raise ValueError(f"split must be 1 or 2, got {split}")
    if x3.device.type == "cpu":
        return tt_contract_3_batched_plain(x3, g0b, g1, g2, split, scale)
    return _launch_3(x3, g0b, g1, g2, scale, split, "tt_contract_3q")


def _combined_scale(scales) -> Optional[torch.Tensor]:
    """Product of the non-``None`` per-core scales (the chain is linear in
    every core, so they commute out to one output multiply)."""
    if scales is None:
        return None
    combined = None
    for s in scales:
        if s is None:
            continue
        s = torch.as_tensor(s, dtype=torch.float32)
        combined = s if combined is None else combined * s
    return combined


def tt_contract(x2: torch.Tensor, cores: Sequence[torch.Tensor], split: int,
                scales: Optional[Sequence[Optional[torch.Tensor]]] = None,
                ) -> torch.Tensor:
    """Contract activations straight through TT cores (no dense weight).

    ``scales`` (aligned with ``cores``; ``None`` entries are wide cores)
    selects the int8 kernels: integer cores go into the kernel as stored
    and the scale product multiplies the output once."""
    depth = len(cores)
    x2 = x2.float().contiguous()
    combined = _combined_scale(scales)
    if combined is not None:
        combined = combined.reshape(1).contiguous()
    g0 = cores[0].float().contiguous()
    if depth == 2 and split == 1:
        g1 = cores[1]
        g1m = (g1[:, :, 0] if g1.ndim == 3 else g1).contiguous()
        if combined is not None:
            return tt_contract_2q(x2, g0, g1m, combined)
        return tt_contract_2(x2, g0, g1m)
    if depth == 3 and split in (1, 2):
        g1 = cores[1].contiguous()
        g2 = cores[2]
        g2m = (g2[:, :, 0] if g2.ndim == 3 else g2).contiguous()
        if combined is not None:
            return tt_contract_3q(x2, g0, g1, g2m, combined, split)
        return tt_contract_3(x2, g0, g1, g2m, split)
    launches["plain_chains"] += 1
    y = tt_contract_ref(x2, cores, split)
    return y if combined is None else y * combined.reshape(())


def tt_contract_batched(x3: torch.Tensor, g0b: torch.Tensor,
                        cores: Sequence[torch.Tensor], split: int,
                        scales: Optional[Sequence[Optional[torch.Tensor]]]
                        = None) -> torch.Tensor:
    """Expert-batched chain: the whole bank in one launch per phase.

    x3 (E, B, N_in) through the per-expert lead-absorbed first cores
    ``g0b`` (E, n1, r1) and the shared tail ``cores`` → (E, B, N_out)
    float32.  ``scales`` aligns with the tail cores (the lead's scales are
    folded into ``g0b`` by the caller), so their product is the same for
    every expert and multiplies the output once."""
    depth = 1 + len(cores)
    x3 = x3.float().contiguous()
    g0b = g0b.float().contiguous()
    combined = _combined_scale(scales)
    if combined is not None:
        combined = combined.reshape(1).contiguous()
    if depth == 2 and split == 1:
        g1 = cores[0]
        g1m = (g1[:, :, 0] if g1.ndim == 3 else g1).contiguous()
        if combined is not None:
            return tt_contract_2q_batched(x3, g0b, g1m, combined)
        return tt_contract_2_batched(x3, g0b, g1m)
    if depth == 3 and split in (1, 2):
        g1 = cores[0].contiguous()
        g2 = cores[1]
        g2m = (g2[:, :, 0] if g2.ndim == 3 else g2).contiguous()
        if combined is not None:
            return tt_contract_3q_batched(x3, g0b, g1, g2m, combined, split)
        return tt_contract_3_batched(x3, g0b, g1, g2m, split)
    launches["plain_chains"] += 1
    y = tt_contract_batched_ref(x3, g0b, cores, split)
    return y if combined is None else y * combined.reshape(())


__all__ = [
    "BATCHED", "KERNELS", "build", "chunk_plan", "launches",
    "reset_launches", "tt_contract", "tt_contract_2", "tt_contract_2q",
    "tt_contract_3", "tt_contract_3q", "tt_contract_2_plain",
    "tt_contract_3_plain", "tt_contract_batched", "tt_contract_2_batched",
    "tt_contract_2q_batched", "tt_contract_3_batched",
    "tt_contract_3q_batched", "tt_contract_2_batched_plain",
    "tt_contract_3_batched_plain", "tt_contract_batched_ref",
    "tt_contract_ref", "tt_dense_ref", "tt_dequant_chain",
]
