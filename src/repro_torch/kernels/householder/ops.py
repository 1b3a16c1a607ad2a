"""Dispatch and wrappers for the Householder panel factorization, and the
blocked QR built from the TTD engine's kernels.

    panel_factor(a (M, b))              → (V (M, b), τ (b,), R (b, b))
    panel_factor_batched(a (B, M, b))   → (V (B, M, b), τ (B, b), R (B, b, b))
    build_t(V, τ)                       → T with H_1 … H_b = I − V T Vᵀ
    qr_blocked(a (…, M, N), panel=32)   → (Q thin (…, M, N), R (…, N, N))

For CUDA tensors the panel wrappers launch ``csrc/householder.cu`` by one
of three routes, each counted in ``launches`` as ``<wrapper>_<route>``
beside the wrapper's total:

  * ``smem``: the one-block form with the panel in shared memory, when it
    fits (``smem_rows``);
  * ``tsqr``: taller panels, by TSQR with Householder reconstruction (three
    CUDA launches whatever the height: leaf chains, tree and top block,
    apply); the leaf pass reports which columns hold a nonzero, and the
    wrapper reads that back (one host sync) to pick the route;
  * ``sweep``: taller panels with an exactly zero column before a nonzero
    one, which the reconstruction cannot reproduce: the column-by-column
    sweep (2b + 1 launches).  Chosen by the data, never after a failure.

For tensors on the CPU they run the plain version in ``ref.py``
(``panel_factor_tsqr`` there renders the ``tsqr`` route in PyTorch for the
tests).  A failed build or launch raises.  The panel
may be a row-strided view (last stride 1), so ``qr_blocked`` hands the
kernel the active sub-view ``A[c0:, c0:c0+b]`` itself.  ``"plain_on_cuda"``
counts calls of the plain version with a CUDA tensor.  The kernels take
panels of at most ``MAX_B`` = 32 columns (one warp lane per column).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.block_update import ops as _wy
from repro_torch.kernels.householder.ref import (
    build_t, leading_columns, panel_factor_ref, panel_factor_tsqr, tsqr_plan,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "householder.cu"
KERNELS = ("panel_factor", "panel_factor_batched")
ROUTES = ("smem", "tsqr", "sweep")
MAX_B = 32
TSQR_CHAINS = 264        # leaf chains a launch: two blocks on each of 132 SMs

launches: collections.Counter = collections.Counter()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TARGET_BLOCKS = 528     # streamed sweep: about four blocks per SM
_SWEEP_ROWS = 32         # rows per block come in multiples of this


def reset_launches() -> None:
    launches.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_bound(SOURCE, {
        "panel_factor_smem": [_P, _L, _L, _P, _P, _P, _I, _I, _I, _P],
        "panel_factor_stream": [_P, _L, _L] + [_P] * 5 + [_I] * 5 + [_P],
        "panel_factor_tsqr_leaf": [_P, _L, _L, _P, _P] + [_I] * 6 + [_P],
        "panel_factor_tsqr_finish": [_P] * 4 + [_I] * 6 + [_P]})
    lib.max_shared_bytes.restype = _I
    lib.panel_smem_static_bytes.restype = _I
    for fn in (lib.tsqr_scratch_bytes, lib.tsqr_masks_offset):
        fn.argtypes = [_I, _I, _I]
        fn.restype = _L
    lib.tsqr_tile_rows.restype = _I
    return lib


def build() -> None:
    """Build and load the kernels now (they are otherwise built at first
    use)."""
    _lib()


def tsqr_tile_rows() -> int:
    """Rows of one TSQR leaf step, as the source defines them (a tree step
    is twice as many)."""
    return _lib().tsqr_tile_rows()


@functools.cache
def smem_rows(b: int) -> int:
    """The most rows of a width-``b`` panel the one-block form holds in
    shared memory on this card."""
    lib = _lib()
    static = lib.panel_smem_static_bytes()
    if static < 0:
        raise RuntimeError("cannot read the panel kernel's attributes")
    return (lib.max_shared_bytes() - static) // (4 * b)


def stream_plan(m: int, batch: int):
    """(rows per block, blocks per member) for the sweep route."""
    want = max(1, -(-_TARGET_BLOCKS // batch))
    rpb = -(-m // want)
    rpb = -(-rpb // _SWEEP_ROWS) * _SWEEP_ROWS
    return rpb, -(-m // rpb)


def _sweep(lib, a3, v, tau, r, stream) -> int:
    bsz, m, b = a3.shape
    rpb, nblk = stream_plan(m, bsz)
    scal = torch.empty((bsz, 40), dtype=torch.float32, device=a3.device)
    part = torch.empty((bsz, nblk, 32), dtype=torch.float32, device=a3.device)
    tau.zero_()
    r.zero_()
    return lib.panel_factor_stream(
        a3.data_ptr(), a3.stride(1), a3.stride(0), v.data_ptr(),
        tau.data_ptr(), r.data_ptr(), scal.data_ptr(), part.data_ptr(), bsz,
        m, b, rpb, nblk, stream)


def _streamed(lib, a3, v, tau, r, stream, name) -> str:
    """A panel taller than ``smem_rows``: the leaf pass of the TSQR route,
    then its finish, or the sweep where a zero column precedes a nonzero
    one (in any member).  Returns the route."""
    bsz, m, b = a3.shape
    tpb, nblk, ntiles = tsqr_plan(m, bsz, lib.tsqr_tile_rows(), TSQR_CHAINS)
    scratch = torch.empty(lib.tsqr_scratch_bytes(bsz, ntiles, nblk),
                          dtype=torch.uint8, device=a3.device)
    code = lib.panel_factor_tsqr_leaf(
        a3.data_ptr(), a3.stride(1), a3.stride(0), v.data_ptr(),
        scratch.data_ptr(), bsz, m, b, tpb, ntiles, nblk, stream)
    _build.raise_on(lib, code, name)
    at = lib.tsqr_masks_offset(bsz, ntiles, nblk)
    masks = scratch[at:at + 4 * bsz * nblk].view(torch.int32)
    per_member = masks.reshape(bsz, nblk).cpu()
    if not all(leading_columns(row) for row in per_member.tolist()):
        _build.raise_on(lib, _sweep(lib, a3, v, tau, r, stream), name)
        return "sweep"
    code = lib.panel_factor_tsqr_finish(
        v.data_ptr(), tau.data_ptr(), r.data_ptr(), scratch.data_ptr(), bsz,
        m, b, tpb, ntiles, nblk, stream)
    _build.raise_on(lib, code, name)
    return "tsqr"


def _launch(a3: torch.Tensor, name: str):
    """a3 (B, M, b) float32 on the card, rows of unit stride."""
    _build.check_cuda(name, a3, dtype=torch.float32)
    bsz, m, b = a3.shape
    if a3.stride(-1) != 1:
        raise ValueError(f"{name}: the panel needs unit column stride")
    if b > MAX_B:
        raise ValueError(f"{name}: panel width {b} > {MAX_B}")
    if m >= 2**31 // max(b, 1) or bsz > 65535:
        raise ValueError(f"{name}: panel {tuple(a3.shape)} too large")
    dev = a3.device
    v = torch.empty((bsz, m, b), dtype=torch.float32, device=dev)
    tau = torch.empty((bsz, b), dtype=torch.float32, device=dev)
    r = torch.empty((bsz, b, b), dtype=torch.float32, device=dev)
    if bsz == 0 or b == 0 or m == 0:
        return v, tau.zero_(), r.zero_()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    if m <= smem_rows(b):
        tau.zero_()
        r.zero_()
        code = lib.panel_factor_smem(a3.data_ptr(), a3.stride(1),
                                     a3.stride(0), v.data_ptr(),
                                     tau.data_ptr(), r.data_ptr(), bsz, m, b,
                                     stream)
        _build.raise_on(lib, code, name)
        route = "smem"
    else:
        route = _streamed(lib, a3, v, tau, r, stream, name)
    launches[name] += 1
    launches[f"{name}_{route}"] += 1
    return v, tau, r


def panel_factor_plain(a_panel: torch.Tensor):
    """The plain version, counted when it is given a CUDA tensor."""
    if a_panel.is_cuda:
        launches["plain_on_cuda"] += 1
    return panel_factor_ref(a_panel)


def panel_factor(a_panel: torch.Tensor):
    """Factor an (M, b) panel: (V (M, b), τ (b,), R (b, b)), float32."""
    if a_panel.ndim != 2:
        raise ValueError(f"expected (M, b), got {tuple(a_panel.shape)}")
    if a_panel.device.type == "cpu":
        return panel_factor_ref(a_panel)
    v, tau, r = _launch(a_panel.float()[None], "panel_factor")
    return v[0], tau[0], r[0]


def panel_factor_batched(a_panels: torch.Tensor):
    """One launch factoring a (B, M, b) stack of panels; member k equals
    ``panel_factor(a_panels[k])``."""
    if a_panels.ndim != 3:
        raise ValueError(f"expected (B, M, b), got {tuple(a_panels.shape)}")
    if a_panels.device.type == "cpu":
        return panel_factor_ref(a_panels)
    return _launch(a_panels.float(), "panel_factor_batched")


def qr_blocked(a: torch.Tensor, panel: int = 32):
    """Blocked Householder QR A = Q R from the TTD engine's kernels: the
    panel factor (HBD-ACC), ``build_t`` and the WY trailing update (GEMM
    reuse).  a (M, N) or a leading batch (B, M, N) → (Q thin (…, M, N),
    R (…, N, N)), float32.  N is padded with zero columns to a multiple of
    ``panel`` and cropped back.

    Each panel is the active sub-view ``A[c0:, c0:c0+panel]`` (the JAX
    package's ``qr_blocked`` rolls the panel up by c0 and masks; a view
    needs neither).  The trailing update touches ``A[c0:, c0+panel:]`` and
    thin Q is formed backwards on ``Q[c0:, c0:]`` only: the reflectors of
    panel k are zero above row c0, and Q's columns left of c0 are still
    unit vectors there, so the rest is unchanged."""
    batched = a.ndim == 3
    if not batched and a.ndim != 2:
        raise ValueError(f"expected (M, N) or (B, M, N), got {tuple(a.shape)}")
    if panel < 1:
        raise ValueError(f"panel must be >= 1, got {panel}")
    work_in = a if batched else a[None]
    bsz, m, n = work_in.shape
    np_ = -(-n // panel) * panel
    work = torch.zeros((bsz, m, np_), dtype=torch.float32, device=a.device)
    work[:, :, :n] = work_in
    if batched:
        pf, wy = panel_factor_batched, _wy.block_wy_update_batched
    else:
        def pf(p):
            v, tau, r = panel_factor(p[0])
            return v[None], tau[None], r[None]

        def wy(x, v, t, out):
            return _wy.block_wy_update(x[0], v[0], t[0], out=out[0])

    vs, ts = [], []
    for c0 in range(0, np_, panel):
        c1 = c0 + panel
        v, tau, r = pf(work[:, c0:, c0:c1])
        rows = min(panel, m - c0)
        work[:, c0:c0 + rows, c0:c1] = r[:, :rows]
        t = build_t(v, tau)
        if c1 < np_:
            trail = work[:, c0:, c1:]
            wy(trail, v, t, trail)
        vs.append(v)
        ts.append(t)
    r = torch.triu(work[:, :n, :n])
    q = torch.zeros((bsz, m, np_), dtype=torch.float32, device=a.device)
    diag = torch.arange(min(m, np_), device=a.device)
    q[:, diag, diag] = 1.0
    for k in reversed(range(len(vs))):
        c0 = k * panel
        sub = q[:, c0:, c0:]
        wy(sub, vs[k], ts[k].transpose(-1, -2), sub)
    q = q[:, :, :n]
    return (q, r) if batched else (q[0], r[0])


__all__ = [
    "KERNELS", "MAX_B", "ROUTES", "TSQR_CHAINS", "build",
    "build_t", "launches", "panel_factor", "panel_factor_batched",
    "panel_factor_plain", "panel_factor_ref", "panel_factor_tsqr",
    "qr_blocked", "reset_launches", "smem_rows", "stream_plan",
    "tsqr_plan", "tsqr_tile_rows",
]
