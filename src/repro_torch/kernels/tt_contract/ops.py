"""Dispatch and wrappers for the fused TT-chain kernels.

``tt_chain`` / ``tt_chain_experts`` run one TTLinear call from its STORED
tensors — the lead row(s), the first core (r_s, n1, r1) as stored, the tail
cores and the scales of a quantized leaf — in two launches, with the lead
absorbed inside phase A (``csrc/tt_contract.cu``):

  * depth 2 (split 1)      → ``tt_contract_2`` / ``tt_contract_2q``
  * depth 3 (split 1 or 2) → ``tt_contract_3`` / ``tt_contract_3q``
  * anything else          → the plain version (unfused einsum chain),
                             counted as ``"plain_chains"``

An expert bank counts under the kernel's name and under ``<kernel>_batched``,
and under the route its phase A took: ``<kernel>_batched_mma`` (bf16 and
int8 banks: the absorption on the tensor cores) or ``<kernel>_batched_fma``
(float32 banks, per-expert first cores, split 2).

The absorbed-chain API of the reference — ``tt_contract``,
``tt_contract_batched`` and the four route wrappers, whose first core is
already lead-absorbed float32 — runs the same kernels as the case r_s = 1
with no lead, and keeps returning float32.

There is no size gate: the kernels stream their cores through shared
memory in tiles, so every depth-2/3 chain runs fused whatever its width.
Each wrapper launches its kernels for CUDA tensors and uses the plain
version only for tensors on the CPU; a failed build or launch raises.
``launches`` counts wrapper calls per kernel, so a run can show which path
it took.  A call allocates y and its float32 scratch (the partials and
rank vectors) from the caching allocator, which orders them on the stream
and keeps them alive in a captured CUDA graph.  Phase A's ticket counters
(zeros, left at zero by every launch) persist, one buffer a stream
(``_counters``).  The checks and the launch plan of a call signature
(shapes, dtypes) are worked out once; the host spends about 35 µs a call
(PERF.md).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.tt_contract.ref import (
    tt_chain_experts_ref, tt_chain_ref, tt_contract_batched_ref,
    tt_contract_ref, tt_dense_ref, tt_dequant_chain,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "tt_contract.cu"
KERNELS = ("tt_contract_2", "tt_contract_3", "tt_contract_2q",
           "tt_contract_3q")
# the expert-batched routes of the same four kernels (their launch keys)
BATCHED = tuple(f"{k}_batched" for k in KERNELS)
# phase-A routes of an expert bank: tensor cores (bf16/int8) or FFMA
BANK_ROUTES = ("mma", "fma")

launches: collections.Counter = collections.Counter()
# the launch counts and the ticket counters are shared by every thread (the
# router's replicas step their engines from threads of their own)
_LOCK = threading.Lock()

# enough blocks in phase A to cover the H100's 132 SMs about twice
_TARGET_BLOCKS = 264
# the CUDA source's tiles (its constants of the same meaning)
_A_COLS, _A_KSUB, _A_ROWS = 32, 16, 64        # absorb_in_kernel
_C_STILE, _C_RCHUNK, _C_ROWS = 64, 256, 32     # contract2_kernel
_C_PRO, _C_STAGES = 8192, 3
_BANK_M, _BANK_NMAX = 64, 256                  # bank_kernel
_ROWS_B, _B1_COLS, _B2_S = 16, 256, 32         # expand1 / expand2
_SUM_SLOTS, _WARPS = 2048, 8
_SMEM_CAP = 200 * 1024
_ROUTE_ABSORB, _ROUTE_BANK, _ROUTE_CONTRACT2 = 0, 1, 2
_GRID_MAX = 65535

_SFX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}
_X_SFX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# (lead and first core, tail cores): stored leaves share one type; the
# absorbed API has a float32 first core before bf16 or int8 tails
_PAIRS = {("f32", "f32"), ("f32", "bf16"), ("f32", "i8"), ("bf16", "bf16"),
          ("i8", "i8")}
_P = ctypes.c_void_p


def reset_launches() -> None:
    launches.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.tt_error_string.argtypes = [ctypes.c_int]
    lib.tt_error_string.restype = ctypes.c_char_p
    for t0, t in _PAIRS:
        for xs in _X_SFX.values():
            fn = getattr(lib, f"tt_chain_{t0}_{t}_{xs}")
            fn.argtypes = [ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int),
                           _P]
            fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build and load the kernels now (they are otherwise built at first
    use)."""
    _lib()


_COUNTERS: dict = {}
_RETIRED: list = []


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """Phase A's ticket counters for calls on ``stream``: zeros, and left
    at zero by every launch (the last block of a tile re-arms its counter).
    One buffer a stream, so calls on two streams never share a ticket.  It
    is made, or grown, only outside a CUDA graph capture (a capture that
    needs it raises: run the call once on the capture stream first), and a
    grown buffer's predecessor stays allocated, since a graph captured
    earlier may still use it.  A graph uses the counters of the stream it
    was captured on: do not replay it while calls run on that stream."""
    with _LOCK:
        buf = _COUNTERS.get((device, stream))
        if buf is None or buf.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "a TT-chain call needs new ticket counters while a CUDA "
                    "graph is being captured: run the same call once on the "
                    "capture stream before capturing")
            if buf is not None:
                _RETIRED.append(buf)
            buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
            _COUNTERS[(device, stream)] = buf
        return buf


def chunk_plan(n: int, other_blocks: int, min_chunk: int = 1):
    """(chunk length, chunk count) splitting a contracted mode of size ``n``
    so phase A has about ``_TARGET_BLOCKS`` blocks."""
    want = max(1, -(-_TARGET_BLOCKS // max(other_blocks, 1)))
    nchunk = max(1, min(want, -(-n // min_chunk)))
    length = -(-n // nchunk)
    return length, -(-n // length)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        msg = _lib().tt_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")


def _route(split: int, experts: bool, has_lead: bool, r1: int) -> int:
    """Phase A's kernel: contract2 for split 2; an expert bank with lead
    rows on bank_kernel; else absorb_in."""
    if split == 2:
        return _ROUTE_CONTRACT2
    if experts and has_lead:
        return _ROUTE_BANK
    return _ROUTE_ABSORB


def _plan(route, e, b, rs, n1, r1, n2, r2, n3, depth, isz):
    """Grid and scratch of one call: (chunk length, nchunk, phase-A rows,
    phase-B tile, partial floats, rank-vector floats, counters, contract2's
    r1 chunk); ``isz`` is the first core's element size."""
    if route == _ROUTE_BANK:
        # flat (k, r) columns a block: a multiple of 16, about 264 blocks
        plane = n1 * r1
        kc = min(_BANK_NMAX, 16 * _cdiv(_cdiv(plane, _TARGET_BLOCKS), 16))
        nchunk = _cdiv(plane, kc)
        rows_a, part, t, cnt, R = 0, e * nchunk * b * r1, 0, 0, r1
    elif route == _ROUTE_ABSORB:
        rows_a = max(1, min(b, _A_ROWS))
        tiles = _cdiv(r1, _A_COLS) * e * _cdiv(b, rows_a)
        want = max(1, _cdiv(_TARGET_BLOCKS, tiles))
        kc = _A_KSUB * _cdiv(_cdiv(n1, want), _A_KSUB)
        nchunk = _cdiv(n1, kc)
        R, cnt = r1, tiles
    else:
        rows_a = max(1, min(b, _C_ROWS))
        tiles = _cdiv(r2, _C_STILE) * e * _cdiv(b, rows_a)
        kc, nchunk = chunk_plan(n2, tiles)
        R, cnt = r2, tiles
    if route != _ROUTE_BANK:
        part = e * nchunk * b * R if nchunk > 1 else 0
        t = e * b * R
        cnt = cnt if nchunk > 1 else 0
    nsum = nchunk if route == _ROUTE_BANK else 1
    tiles_b = e * _cdiv(b, _ROWS_B)
    if depth == 3 and route != _ROUTE_CONTRACT2:
        tile_b = 8
        for jt in (128, 64, 32, 16):
            if jt < 2 * n3 and (nsum > 1
                                or n2 * _cdiv(n3, jt) * tiles_b >= 128):
                tile_b = jt
                break
        smem_b = (_ROWS_B * r1 + _WARPS * _ROWS_B * _B2_S
                  + _ROWS_B * _B2_S) * 4
    else:
        # passes of 256 columns a block: a bank's block makes all of them,
        # so its expert's partials are summed once
        cols = _cdiv(n2 if depth == 2 else n3, _B1_COLS)
        tile_b = cols if nsum > 1 else 1
        smem_b = (_ROWS_B * R + _SUM_SLOTS) * 4
    rc = 4 * _cdiv(_cdiv(r1, _cdiv(r1, _C_RCHUNK)), 4)   # whole float4s
    smem_a = (_cdiv(n1 * r1 * 4, 16) * 16 + max(
        _C_STAGES * (_C_PRO * isz + 16),
        (_C_ROWS * rc + rc * _C_STILE + _C_ROWS * n1) * 4)
        if route == _ROUTE_CONTRACT2 else 0)
    if max(smem_a, smem_b) > _SMEM_CAP:
        raise ValueError(f"chain too wide for the kernels' shared memory "
                         f"(rank {R}, n1 {n1})")
    z_a = _cdiv(e, _BANK_M) if route == _ROUTE_BANK else e * _cdiv(b, rows_a)
    if max(z_a, tiles_b) > _GRID_MAX:
        raise ValueError(f"{e} expert(s) x batch {b} exceed the kernels' "
                         f"grid (65,535 tiles)")
    return kc, nchunk, rows_a, tile_b, part, t, cnt, rc


def _check(name: str, x, lead, lead_scale, g0, g0_es: int, tail, scales,
           split: int, experts: bool):
    """Validate one call (any device) and return its sizes: (type
    suffixes, E, B, r_s, n1, r1, n2, r2, n3, N_out).  x (B, N_in), or (E, B,
    N_in) with ``experts``; ``lead`` None, (r_s,) or (E, r_s); g0 (r_s, n1,
    r1) shared, or per expert (E, n1, r1) with r_s = 1 and ``g0_es`` =
    n1·r1; ``tail`` [g1 (r1, n2)] or [g1 (r1, n2, r2), g2 (r2, n3)];
    ``scales`` (s0, s1, s2), each None or one float32."""
    dev = x.device
    if x.dtype not in _X_SFX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if g0.dtype not in _SFX or any(g.dtype not in _SFX for g in tail):
        raise TypeError("cores must be float32, bfloat16 or int8")
    t0 = _SFX[g0.dtype]
    tail_types = {g.dtype for g in tail}
    if len(tail_types) != 1:
        raise TypeError(f"tail cores must share one dtype, got {tail_types}")
    ts = _SFX[tail[0].dtype]
    if (t0, ts) not in _PAIRS:
        raise TypeError(f"first core {g0.dtype} with tail cores "
                        f"{tail[0].dtype} is not a stored form")
    if name.endswith("q") != (ts == "i8"):
        raise TypeError(f"tail core dtype {tail[0].dtype} does not fit {name}")
    if lead is not None and lead.dtype != g0.dtype:
        raise TypeError(f"lead {lead.dtype} and first core {g0.dtype} "
                        f"differ")
    for s in (*scales, lead_scale):
        if s is not None and s.dtype != torch.float32:
            raise TypeError(f"scales must be float32, got {s.dtype}")
    for s in scales:
        if s is not None and s.numel() != 1:
            raise TypeError("a core's scale must be one float32 element")
    for t in (x, g0, *tail, lead, lead_scale, *scales):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if x.ndim != (3 if experts else 2):
        raise ValueError(f"x {tuple(x.shape)} must be "
                         f"{'(E, B, N_in)' if experts else '(B, N_in)'}")
    e = x.shape[0] if experts else 1
    b = x.shape[-2]
    if lead is not None:
        if lead.ndim != (2 if experts else 1) or (
                experts and lead.shape[0] != e):
            raise ValueError(f"x {tuple(x.shape)} and lead "
                             f"{tuple(lead.shape)} disagree on the experts")
        rs = lead.shape[-1]
        if g0.ndim != 3 or g0.shape[0] != rs:
            raise ValueError(f"first core {tuple(g0.shape)} does not match "
                             f"the lead's rank {rs}")
        if lead_scale is not None and lead_scale.numel() != e:
            raise ValueError("one lead scale per lead row")
    else:
        if g0.ndim != 3 or g0.shape[0] != (e if g0_es else 1):
            raise ValueError(f"x {tuple(x.shape)} and first cores "
                             f"{tuple(g0.shape)} disagree on the experts")
        rs = 1
    _, n1, r1 = g0.shape
    depth = 1 + len(tail)
    if tail[0].shape[0] != r1:
        raise ValueError(f"core ranks disagree: {tuple(g0.shape)} then "
                         f"{tuple(tail[0].shape)}")
    if depth == 2:
        if tail[0].ndim != 2:
            raise ValueError("the last core must be (r, n)")
        n2, r2, n3 = tail[0].shape[1], 0, 0
        n_in, n_out = n1, n2
    else:
        g1, g2 = tail
        if g1.ndim != 3 or g2.ndim != 2 or g2.shape[0] != g1.shape[2]:
            raise ValueError(f"depth-3 tail {tuple(g1.shape)}, "
                             f"{tuple(g2.shape)} is not (r1, n2, r2), (r2, n3)")
        n2, r2, n3 = g1.shape[1], g1.shape[2], g2.shape[1]
        n_in = n1 if split == 1 else n1 * n2
        n_out = n2 * n3 if split == 1 else n3
    if x.shape[-1] != n_in:
        raise ValueError(f"x {tuple(x.shape)} does not end in N_in {n_in}")
    if max(*x.shape, rs, n1, r1, n2, r2, n3, g0.numel(),
           *(g.numel() for g in tail)) >= 2**31:
        raise ValueError("dimension too large for the kernels' int indices")
    return (t0, ts), e, b, rs, n1, r1, n2, r2, n3, n_out


class _Call:
    """What one call signature needs beyond its tensors, worked out once:
    the kernel entry, the sizes and grid (a reusable int array), y's shape,
    the scratch and counters, the route's launch keys."""

    def __init__(self, name, x, lead, lead_scale, g0, g0_es, tail, scales,
                 split, experts):
        (t0, ts), e, b, rs, n1, r1, n2, r2, n3, n_out = _check(
            name, x, lead, lead_scale, g0, g0_es, tail, scales, split,
            experts)
        depth = 1 + len(tail)
        route = _route(split, experts, lead is not None, r1)
        kc, nchunk, rows_a, tile_b, n_part, n_t, n_cnt, rc = _plan(
            route, e, b, rs, n1, r1, n2, r2, n3, depth, g0.element_size())
        self.fn = getattr(_lib(), f"tt_chain_{t0}_{ts}_{_X_SFX[x.dtype]}")
        self.dims = (ctypes.c_int * 17)(
            route, depth, e, b, rs, n1, r1, n2, r2, n3, kc, nchunk, rows_a,
            tile_b, rs if lead is not None else 0, g0_es, rc)
        self.y_shape = ((e,) if experts else ()) + (b, n_out)
        self.empty = b == 0 or e == 0
        self.n_part, self.n_scratch, self.n_cnt = n_part, n_part + n_t, n_cnt
        self.keys = [name]
        if experts:
            self.keys += [f"{name}_batched", f"{name}_batched_" + (
                "mma" if route == _ROUTE_BANK and t0 != "f32" else "fma")]


_CALLS: dict = {}


def _stream(dev) -> int:
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(dev.index if dev.index is not None else
                   torch.cuda.current_device())
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name: str, x, lead, lead_scale, g0, g0_es: int, tail,
            scales, split: int, experts: bool) -> torch.Tensor:
    """One fused call on CUDA tensors (arguments as ``_check``'s); returns
    y in x's dtype.  The shape and type checks and the plan run once per
    call signature; device and layout are checked on every call."""
    tensors = (x, lead, lead_scale, g0, *tail, *scales)
    key = (name, g0_es, split, experts) + tuple(
        None if t is None else (t.shape, t.dtype) for t in tensors)
    call = _CALLS.get(key)
    if call is None:
        if len(_CALLS) > 4096:
            _CALLS.clear()
        call = _CALLS[key] = _Call(name, x, lead, lead_scale, g0, g0_es,
                                   tail, scales, split, experts)
    dev = x.device
    index = x.get_device()
    for t in tensors:
        if t is not None and (t.get_device() != index
                              or not t.is_contiguous()):
            raise ValueError(f"kernel inputs must be contiguous and on "
                             f"{dev}: got {t.device}, contiguous "
                             f"{t.is_contiguous()}")
    y = torch.empty(call.y_shape, dtype=x.dtype, device=dev)
    if call.empty:
        return y
    stream = _stream(dev)
    scratch = torch.empty(call.n_scratch, dtype=torch.float32, device=dev)
    cnt = _counters(index, stream, call.n_cnt) if call.n_cnt else None
    s0, s1, s2 = scales
    sp = scratch.data_ptr()
    p = (_P * 13)(x.data_ptr(), _ptr(lead), _ptr(lead_scale), g0.data_ptr(),
                  _ptr(s0), tail[0].data_ptr(),
                  tail[1].data_ptr() if len(tail) == 2 else None, _ptr(s1),
                  _ptr(s2), sp, sp + 4 * call.n_part, _ptr(cnt), y.data_ptr())
    code = call.fn(p, call.dims, stream)
    _raise_on(code, name)
    with _LOCK:
        for k in call.keys:
            launches[k] += 1
    return y


def _name(depth: int, quant: bool) -> str:
    return f"tt_contract_{depth}{'q' if quant else ''}"


def _fused(depth: int, split: int) -> bool:
    return (depth == 2 and split == 1) or (depth == 3 and split in (1, 2))


def _stored_tail(cores):
    """The tail cores as the kernels take them: the last core's trailing
    rank of 1 dropped (a view)."""
    last = cores[-1]
    return list(cores[1:-1]) + [last.reshape(last.shape[0], last.shape[1])]


# ---------------------------------------------------------------------------
# One TTLinear call from its stored tensors
# ---------------------------------------------------------------------------

def _dispatch(x, lead, lead_scale, cores, scales, split, experts):
    """Checks on every device; the kernels on CUDA, the plain version on
    the CPU and for depths the kernels do not fuse."""
    depth = len(cores)
    plain = tt_chain_experts_ref if experts else tt_chain_ref
    if not _fused(depth, split):
        with _LOCK:
            launches["plain_chains"] += 1
        return plain(x, lead, lead_scale, cores, scales, split).to(x.dtype)
    s = list(scales) if scales is not None else [None] * depth
    args = (_name(depth, scales is not None), x, lead, lead_scale, cores[0],
            0, _stored_tail(cores), (s[0], s[1], s[2] if depth == 3 else None),
            split, experts)
    if x.device.type == "cpu":
        _check(*args)
        return plain(x, lead, lead_scale, cores, scales, split).to(x.dtype)
    return _launch(*args)


def tt_chain(x2: torch.Tensor, lead: Optional[torch.Tensor],
             lead_scale: Optional[torch.Tensor],
             cores: Sequence[torch.Tensor],
             scales: Optional[Sequence[Optional[torch.Tensor]]],
             split: int) -> torch.Tensor:
    """y = x · W for one chain, (B, N_in) → (B, N_out) in x's dtype.

    ``lead`` (r_s,) is the selected layer's lead row (``None``: the first
    core is (1, n1, r1)), ``cores`` the stored cores (r_{k-1}, n_k, r_k),
    ``scales`` one per core and ``lead_scale`` the lead row's for a
    quantized leaf.  On CUDA: the two launches of ``csrc/tt_contract.cu``,
    the lead absorbed in phase A and the scales multiplied on the chip; on
    the CPU the plain version ``ref.tt_chain_ref`` (the reference's einsum
    absorption, then the chain)."""
    return _dispatch(x2, lead, lead_scale, cores, scales, split, False)


def tt_chain_experts(x3: torch.Tensor, lead: torch.Tensor,
                     lead_scale: Optional[torch.Tensor],
                     cores: Sequence[torch.Tensor],
                     scales: Optional[Sequence[Optional[torch.Tensor]]],
                     split: int) -> torch.Tensor:
    """An expert bank's call, x3 (E, C, N_in) → (E, C, N_out) in x's dtype:
    E chains that share every core and differ in their lead rows (E, r_s)
    (and lead scales (E,)).  On CUDA one fused call (the bank's absorption
    on the tensor cores for bf16 and int8); on the CPU
    ``ref.tt_chain_experts_ref``."""
    return _dispatch(x3, lead, lead_scale, cores, scales, split, True)


# ---------------------------------------------------------------------------
# Plain versions of the absorbed-chain API (the CPU path, and the oracle
# chip_smoke.py compares with)
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
# The four kernels' wrappers, absorbed form: r_s = 1, no lead, float32 first
# core(s); x (B, N_in) or, batched, (E, B, N_in) with first cores (E, n1, r1)
# ---------------------------------------------------------------------------

def _absorbed(name, x, g0, tail, scale, split):
    batched = x.ndim == 3
    if g0.dtype != torch.float32:
        raise TypeError(f"the lead-absorbed core must be float32, "
                        f"got {g0.dtype}")
    if batched:
        if g0.ndim != 3 or g0.shape[0] != x.shape[0]:
            raise ValueError(f"x {tuple(x.shape)} and first cores "
                             f"{tuple(g0.shape)} disagree on the experts")
        g0v, es = g0, g0.shape[1] * g0.shape[2]
    else:
        if g0.ndim != 2:
            raise ValueError(f"first core {tuple(g0.shape)} must be (n1, r1)")
        g0v, es = g0.unsqueeze(0), 0
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    return _launch(name, x, None, None, g0v, es, tail, (None, scale, None),
                   split, batched)


def tt_contract_2(x, g0, g1):
    """(B, n1) · g0 (n1, r1) · g1 (r1, n2) → (B, n2) f32; wide tail core."""
    if x.device.type == "cpu":
        return tt_contract_2_plain(x, g0, g1)
    return _absorbed("tt_contract_2", x, g0, [g1], None, 1)


def tt_contract_2q(x, g0, g1, scale):
    """``tt_contract_2`` with g1 int8; ``scale`` (one f32) multiplies y."""
    if x.device.type == "cpu":
        return tt_contract_2_plain(x, g0, g1, scale)
    return _absorbed("tt_contract_2q", x, g0, [g1], scale, 1)


def tt_contract_3(x, g0, g1, g2, split: int):
    """3-core chain; g1 (r1, n2, r2), g2 (r2, n3).  split=1: x (B, n1) →
    (B, n2·n3); split=2: x (B, n1·n2) → (B, n3)."""
    if split not in (1, 2):
        raise ValueError(f"split must be 1 or 2, got {split}")
    if x.device.type == "cpu":
        return tt_contract_3_plain(x, g0, g1, g2, split)
    return _absorbed("tt_contract_3", x, g0, [g1, g2], None, split)


def tt_contract_3q(x, g0, g1, g2, scale, split: int):
    """``tt_contract_3`` with g1 and g2 int8; ``scale`` multiplies y."""
    if split not in (1, 2):
        raise ValueError(f"split must be 1 or 2, got {split}")
    if x.device.type == "cpu":
        return tt_contract_3_plain(x, g0, g1, g2, split, scale)
    return _absorbed("tt_contract_3q", x, g0, [g1, g2], scale, split)


def tt_contract_2_batched(x3, g0b, g1):
    """E depth-2 chains sharing g1 (r1, n2) → (E, B, n2) f32."""
    if x3.device.type == "cpu":
        return tt_contract_2_batched_plain(x3, g0b, g1)
    return _absorbed("tt_contract_2", x3, g0b, [g1], None, 1)


def tt_contract_2q_batched(x3, g0b, g1, scale):
    """``tt_contract_2_batched`` with g1 int8; ``scale`` multiplies y."""
    if x3.device.type == "cpu":
        return tt_contract_2_batched_plain(x3, g0b, g1, scale)
    return _absorbed("tt_contract_2q", x3, g0b, [g1], scale, 1)


def tt_contract_3_batched(x3, g0b, g1, g2, split: int):
    """E depth-3 chains sharing g1 (r1, n2, r2) and g2 (r2, n3)."""
    if split not in (1, 2):
        raise ValueError(f"split must be 1 or 2, got {split}")
    if x3.device.type == "cpu":
        return tt_contract_3_batched_plain(x3, g0b, g1, g2, split)
    return _absorbed("tt_contract_3", x3, g0b, [g1, g2], None, split)


def tt_contract_3q_batched(x3, g0b, g1, g2, scale, split: int):
    """``tt_contract_3_batched`` with g1 and g2 int8; ``scale``
    multiplies y."""
    if split not in (1, 2):
        raise ValueError(f"split must be 1 or 2, got {split}")
    if x3.device.type == "cpu":
        return tt_contract_3_batched_plain(x3, g0b, g1, g2, split, scale)
    return _absorbed("tt_contract_3q", x3, g0b, [g1, g2], scale, split)


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
    """Contract activations straight through lead-absorbed TT cores (no
    dense weight), the reference's API: ``cores[0]`` (n1, r1).

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
    """Expert-batched chain over lead-absorbed first cores, the reference's
    API: x3 (E, B, N_in) through ``g0b`` (E, n1, r1) and the shared tail
    ``cores`` → (E, B, N_out) float32.  ``scales`` aligns with the tail
    cores, so their product is the same for every expert and multiplies the
    output once."""
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
    "BANK_ROUTES", "BATCHED", "KERNELS", "build", "chunk_plan", "launches",
    "reset_launches", "tt_chain", "tt_chain_experts", "tt_chain_experts_ref",
    "tt_chain_ref", "tt_contract", "tt_contract_2", "tt_contract_2q",
    "tt_contract_3", "tt_contract_3q", "tt_contract_2_plain",
    "tt_contract_3_plain", "tt_contract_batched", "tt_contract_2_batched",
    "tt_contract_2q_batched", "tt_contract_3_batched",
    "tt_contract_3q_batched", "tt_contract_2_batched_plain",
    "tt_contract_3_batched_plain", "tt_contract_batched_ref",
    "tt_contract_ref", "tt_dense_ref", "tt_dequant_chain",
]
