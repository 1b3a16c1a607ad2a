"""Inputs for holding each TTD-engine kernel against its plain version.

One table of shapes and one way to draw a case's inputs, shared by
``chip_smoke.py`` (which checks and times the kernels on the card) and
``tests/test_torch_kernels_cuda.py``:

    case = engine_case(kind, shape, gen, device)
    case.kernel(), case.plain(), case.library()   # tuples of tensors

``kind`` and ``shape``:

  * ``"panel"`` (m, b) and ``"panel_batched"`` (B, m, b): Householder panel
    factor (V, τ, R); the panel is a row-strided view, as ``qr_blocked``
    hands it over, filled as ``fill`` says (``PANEL_FILLS``): ``"dense"``
    (the main path's panels), ``"padded"`` (the last ``padded_zeros(b)``
    columns exactly zero, as ``qr_blocked`` pads N to a multiple of 32) or
    ``"interior_zero"`` (the first column zero, nonzero ones after it: the
    ``safe`` branch inside the panel; ragged shapes only);
  * ``"wy_vta"`` (m, n, b) / ``"wy_vta_batched"`` (B, m, n, b): Y = Vᵀ A;
  * ``"wy_apply"`` (m, n, b) / ``"wy_apply_batched"`` (B, m, n, b): A − V W;
    A is the trailing block of a wider matrix, as blocked QR hands it over:
    ``aligned`` (the default) at an offset of 32 columns, as the main path's
    views, where pass 1 takes its 16-byte copy route; otherwise at an
    offset of 5 (4-byte route);
  * ``"sort"`` (n,) / ``"sort_batched"`` (B, n): σ with ties → (sorted,
    index vector), compared exactly;
  * ``"truncate"`` (n,) / ``"truncate_batched"`` (B, n): sorted σ and δ →
    (tail norms, rank); the rank is compared exactly.

Each case also carries the bytes its function must move (each input read
once, each output written once) and the operations it does, for the bound,
and its inputs.

``compare`` holds every inexact output to ``tol``·max|ref|, and a panel
also to these bounds (all in float64, each tighter than that max check):

  * V per column: ||V[:, j] − V_ref[:, j]|| <= PANEL_V_COL·||V_ref[:, j]||
    (a zero column of V_ref must be exactly zero);
  * τ per element: |τ − τ_ref| <= PANEL_TAU (τ lies in [1, 2], or is 0);
  * R per row: ||R[i] − R_ref[i]|| <= PANEL_R_ROW·||R_ref[i]|| (zero rows
    exactly zero);
  * the factorization it returns (``panel_quality``: Q = (I − V T Vᵀ)[:, :b]
    through ``build_t``): the residual ||A − Q R|| / ||A|| and
    max|I − QᵀQ| each within PANEL_FACTOR times the plain version's, or
    PANEL_FLOOR (8 float32 ulps of 1) where that is larger, and within
    PANEL_SMALL at panels of up to PANEL_SMALL_ROWS rows.

``wy_inputs(shape, gen, device, aligned, ints=True)`` draws pass 1's inputs
with entries in {−1, 0, 1}: every partial sum is then an integer far below
2²⁴, so any summation order is exact and the kernel must equal
``vta_exact(v, a)`` bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels.block_update import ops as wy
from repro_torch.kernels.frob_truncate import ops as ft
from repro_torch.kernels.householder import ops as hh
from repro_torch.kernels.singular_sort import ops as ss

# the kernel each kind launches: (ops module, launch-counter name)
COUNTERS = {
    "panel": (hh, "panel_factor"),
    "panel_batched": (hh, "panel_factor_batched"),
    "wy_vta": (wy, "wy_vta"), "wy_vta_batched": (wy, "wy_vta_batched"),
    "wy_apply": (wy, "wy_apply"), "wy_apply_batched": (wy, "wy_apply_batched"),
    "sort": (ss, "bitonic_sort_desc"),
    "sort_batched": (ss, "bitonic_sort_desc_batched"),
    "truncate": (ft, "frob_truncate"),
    "truncate_batched": (ft, "frob_truncate_batched"),
}
KINDS = tuple(COUNTERS)

# ragged shapes: nothing a multiple of the kernels' tiles, panels narrower
# than a warp, a panel shorter than it is wide, rows that are not a power
# of two; for pass 1 also M one row past a 64-row stage, N = 32 (its narrow
# column tile), N = 64 and N = 100 (ragged past the wide tile), b = 28 (V
# padded on the 16-byte route) and b = 13
RAGGED_SHAPES = {
    "panel": [(77, 13), (20, 32), (3001, 7)],
    "panel_batched": [(3, 77, 13), (2, 2050, 32)],
    "wy_vta": [(77, 45, 13), (65, 32, 32), (65, 64, 32), (1000, 100, 28),
               (4161, 45, 13)],
    "wy_vta_batched": [(3, 77, 45, 13), (2, 65, 32, 32), (3, 129, 100, 28)],
    "wy_apply": [(77, 45, 13)], "wy_apply_batched": [(3, 77, 45, 13)],
    "sort": [(1,), (5,), (100,)], "sort_batched": [(3, 100)],
    "truncate": [(1,), (5,), (100,)], "truncate_batched": [(3, 100)],
}


PANEL_FILLS = ("dense", "padded", "interior_zero")
PANEL_V_COL = 1e-5
PANEL_TAU = 1e-5
PANEL_R_ROW = 1e-5
PANEL_FACTOR = 2.0
PANEL_FLOOR = 8 * 2.0 ** -24
PANEL_SMALL, PANEL_SMALL_ROWS = 1e-5, 24_576


@dataclass
class Case:
    kind: str
    shape: Tuple[int, ...]
    kernel: Callable[[], tuple]
    plain: Callable[[], tuple]
    library: Optional[Callable[[], object]]
    exact: Tuple[bool, ...]          # per output: compared exactly
    nbytes: int
    ops: int
    inputs: tuple = ()

    @property
    def counter(self) -> str:
        return COUNTERS[self.kind][1]


def padded_zeros(b: int) -> int:
    """The trailing zero columns of a ``"padded"`` panel of width b."""
    return max(1, b // 4)


def _panel_input(shape, gen, device, fill: str = "dense"):
    """A row-strided (…, m, b) view of a wider matrix, filled as ``fill``
    says (``PANEL_FILLS``)."""
    if fill not in PANEL_FILLS:
        raise ValueError(f"unknown panel fill {fill!r}")
    *lead, m, b = shape
    base = torch.randn(*lead, m, b + 3, generator=gen, device=device)
    if fill == "interior_zero":
        base[..., :, min(1, b - 1)] = 0.0
    view = base[..., :, 1:b + 1] if b > 1 else base[..., :, :b]
    if fill == "padded":
        view[..., :, b - padded_zeros(b):] = 0.0
    return view


def panel_route(shape, fill: str, smem_rows: int) -> str:
    """The route ``householder.ops`` takes for a panel case: ``"smem"`` up
    to ``smem_rows`` rows, else ``"sweep"`` for a zero column before a
    nonzero one and ``"tsqr"`` for the rest."""
    if shape[-2] <= smem_rows:
        return "smem"
    return "sweep" if fill == "interior_zero" and shape[-1] > 1 else "tsqr"


def panel_quality(a, v, tau, r):
    """(||A − Q R|| / ||A||, max|I − QᵀQ|) in float64 of a panel
    factorization, Q = (I − V T Vᵀ)[:, :min(M, b)] with T from
    ``build_t``; a leading batch is reduced to its worst member."""
    vd = v.double()
    m, b = vd.shape[-2:]
    k = min(m, b)                # thin Q's columns; R's rows past M are 0
    t = hh.build_t(vd, tau.double())
    q = -(vd @ (t @ vd[..., :k, :].transpose(-1, -2)))
    q[..., :k, :] += torch.eye(k, dtype=torch.float64, device=q.device)
    ad = a.double()
    res = (torch.linalg.vector_norm(q @ r.double()[..., :k, :] - ad,
                                    dim=(-2, -1))
           / torch.linalg.vector_norm(ad, dim=(-2, -1)).clamp_min(1e-300))
    eye = torch.eye(k, dtype=torch.float64, device=q.device)
    orth = (q.transpose(-1, -2) @ q - eye).abs().amax(dim=(-2, -1))
    return float(res.max()), float(orth.max())


ALIGNED_PAD, MISALIGNED_PAD = 32, 5


def wy_inputs(shape, gen, device, aligned: bool = True, ints: bool = False):
    """(v, a) of a WY case of shape (…, m, n, b): a is the (…, m, n)
    trailing block of a (…, m, n + pad) matrix; unit-normal entries (v
    scaled by 1/√m), or entries in {−1, 0, 1} with ``ints``."""
    *lead, m, n, b = shape
    pad = ALIGNED_PAD if aligned else MISALIGNED_PAD
    if ints:
        a = torch.randint(-1, 2, (*lead, m, n + pad), generator=gen,
                          device=device, dtype=torch.float32)
        v = torch.randint(-1, 2, (*lead, m, b), generator=gen,
                          device=device, dtype=torch.float32)
    else:
        a = torch.randn(*lead, m, n + pad, generator=gen, device=device)
        v = torch.randn(*lead, m, b, generator=gen, device=device) / math.sqrt(m)
    return v, a[..., :, pad:]


def vta_exact(v, a):
    """Y = Vᵀ A in float64, rounded to float32."""
    return (v.double().transpose(-1, -2) @ a.double()).float()


def vta_route(kind: str, shape, aligned: bool) -> str:
    """The launch counter of the copy route pass 1 takes for a case."""
    wide = aligned and shape[-1] % 4 == 0
    return f"{kind}_copy{16 if wide else 4}"


def engine_case(kind: str, shape, gen: torch.Generator, device,
                aligned: bool = True, fill: str = "dense") -> Case:
    def rn(*s):
        return torch.randn(*s, generator=gen, device=device)

    if kind in ("panel", "panel_batched"):
        a = _panel_input(shape, gen, device, fill)
        *lead, m, b = shape
        nb = math.prod(lead) if lead else 1
        flops = nb * max(2 * m * b * b - 2 * b ** 3 // 3, m * b)
        nbytes = 4 * nb * (2 * m * b + b + b * b)
        fn = hh.panel_factor if kind == "panel" else hh.panel_factor_batched
        ac = a.contiguous()
        return Case(kind, tuple(shape), lambda: fn(a),
                    lambda: hh.panel_factor_plain(a),
                    lambda: torch.geqrf(ac), (False,) * 3, nbytes, flops,
                    (a,))

    if kind.startswith("wy_"):
        *lead, m, n, b = shape
        nb = math.prod(lead) if lead else 1
        v, a = wy_inputs(shape, gen, device, aligned)
        flops = 2 * nb * m * n * b
        if kind.startswith("wy_vta"):
            fn = wy.wy_vta if kind == "wy_vta" else wy.wy_vta_batched
            nbytes = 4 * nb * (m * b + m * n + b * n)
            return Case(kind, tuple(shape), lambda: (fn(v, a),),
                        lambda: (wy.vta_plain(v, a),),
                        lambda: v.transpose(-1, -2) @ a, (False,), nbytes,
                        flops)
        w = rn(*lead, b, n)
        fn = wy.wy_apply if kind == "wy_apply" else wy.wy_apply_batched
        nbytes = 4 * nb * (2 * m * n + m * b + b * n)
        a3, v3, w3 = (x.reshape(-1, *x.shape[-2:]).contiguous()
                      for x in (a, v, w))
        return Case(kind, tuple(shape), lambda: (fn(a, v, w),),
                    lambda: (wy.apply_plain(a, v, w),),
                    lambda: torch.baddbmm(a3, v3, w3, alpha=-1.0),
                    (False,), nbytes, flops)

    if kind in ("sort", "sort_batched"):
        n = shape[-1]
        nb = shape[0] if kind == "sort_batched" else 1
        # few distinct values: many ties, which must keep index order
        s = torch.randint(0, max(n // 4, 2), tuple(shape), generator=gen,
                          device=device).float() * 0.25
        fn = (ss.sort_singular_values if kind == "sort"
              else ss.sort_singular_values_batched)
        ops = nb * n * max(1, math.ceil(math.log2(max(n, 2))))
        return Case(kind, tuple(shape), lambda: fn(s),
                    lambda: ss.sort_desc_plain(s),
                    lambda: torch.sort(s, dim=-1, descending=True,
                                       stable=True),
                    (True, True), nb * n * (4 + 4 + 8), ops)

    if kind in ("truncate", "truncate_batched"):
        n = shape[-1]
        nb = shape[0] if kind == "truncate_batched" else 1
        s = torch.sort(torch.rand(tuple(shape), generator=gen,
                                  device=device), dim=-1,
                       descending=True).values
        # δ inside the tail norms' range: a rank between 1 and n
        frac = 0.1 + 0.8 * torch.rand(s.shape[:-1], generator=gen,
                                      device=device)
        delta = frac * torch.linalg.vector_norm(s, dim=-1)
        if kind == "truncate":
            return Case(kind, tuple(shape),
                        lambda: ft.delta_truncate(s, delta),
                        lambda: ft.delta_truncate_plain(s, delta), None,
                        (False, True), 4 * (2 * n + 2), 3 * n)
        return Case(kind, tuple(shape),
                    lambda: ft.delta_truncate_batched(s, delta),
                    lambda: ft.delta_truncate_plain(s, delta), None,
                    (False, True), 4 * nb * (2 * n + 2), 3 * nb * n)
    raise ValueError(f"unknown engine kernel kind {kind!r}")


def _panel_gaps(case: Case, got: tuple, ref: tuple):
    """(ok, report) of the panel bounds (module docstring)."""
    (v, tau, r), (vr, taur, rr) = got, ref
    v, vr, r, rr = v.double(), vr.double(), r.double(), rr.double()

    def rel(diff, scale):
        zero = scale == 0
        if bool((zero & (diff != 0)).any()):
            return float("inf")
        return float((diff / torch.where(zero, 1.0, scale)).max()) \
            if diff.numel() else 0.0

    col = rel(torch.linalg.vector_norm(v - vr, dim=-2),
              torch.linalg.vector_norm(vr, dim=-2))
    dtau = float((tau.double() - taur.double()).abs().max()) \
        if tau.numel() else 0.0
    row = rel(torch.linalg.vector_norm(r - rr, dim=-1),
              torch.linalg.vector_norm(rr, dim=-1))
    (a,) = case.inputs
    res, orth = panel_quality(a, *got)
    res_p, orth_p = panel_quality(a, *ref)
    cap_res = max(PANEL_FACTOR * res_p, PANEL_FLOOR)
    cap_orth = max(PANEL_FACTOR * orth_p, PANEL_FLOOR)
    if case.shape[-2] <= PANEL_SMALL_ROWS:
        cap_res, cap_orth = min(cap_res, PANEL_SMALL), min(cap_orth,
                                                           PANEL_SMALL)
    ok = (col <= PANEL_V_COL and dtau <= PANEL_TAU and row <= PANEL_R_ROW
          and res <= cap_res and orth <= cap_orth)
    return ok, (f"V col {col:.2e}, tau {dtau:.2e}, R row {row:.2e}, "
                f"residual {res:.2e} (plain {res_p:.2e}), "
                f"orth {orth:.2e} (plain {orth_p:.2e})")


def compare(case: Case, got: tuple, ref: tuple, tol: float):
    """(ok, max|Δ| over the inexact outputs, per-output report).  Inexact
    outputs pass at max|Δ| <= tol · max|ref|; exact ones must be equal; a
    panel must also meet the panel bounds (module docstring)."""
    ok, worst, parts = True, 0.0, []
    for g, r, exact in zip(got, ref, case.exact):
        if exact:
            same = bool(torch.equal(g, r))
            ok &= same
            parts.append("equal" if same else "DIFFER")
            continue
        g, r = g.float(), r.float()
        err = float((g - r).abs().max()) if r.numel() else 0.0
        scale = float(r.abs().max()) if r.numel() else 0.0
        ok &= err <= tol * scale
        worst = max(worst, err)
        parts.append(f"{err:.2e}/{scale:.2e}")
    if case.kind in ("panel", "panel_batched"):
        good, report = _panel_gaps(case, got, ref)
        ok &= good
        parts.append(report)
    return ok, worst, parts
