"""Timing on the card, shared by ``chip_smoke.py`` and the tools.

``time_ms(fn)`` is the median of CUDA-event times around single calls of
``fn`` after a few warm-up calls (the host's time to issue the call shows
in it when the card waits for the host); ``device_ms(fn)`` is the card's
own time per call of each kernel ``fn`` launches, from ``torch.profiler``
(``kernel_ms`` reads a profile); ``PhaseTimers`` adds up the host seconds
of each compression phase (synchronized at the phase boundaries) by
wrapping the functions the compression path calls, in whichever
``repro_torch`` is imported.  Needs a CUDA card.
"""

from __future__ import annotations

import importlib
import statistics
import time

import torch


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median time of ``fn()`` on the card, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(prof) -> dict:
    """{kernel name: (device ms, launches)} of a finished
    ``torch.profiler.profile`` with CUDA activity, read from its raw events
    (``key_averages`` takes minutes over the million launches of a
    compression)."""
    from torch.autograd import DeviceType
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, n = out.get(e.name(), (0.0, 0))
            out[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return out


def device_ms(fn, calls: int = 10) -> dict:
    """{kernel name: device ms per call} over ``calls`` calls of ``fn``
    after one warm-up call (``torch.profiler``, CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {k: ms / calls for k, (ms, _) in kernel_ms(prof).items()}


class PhaseTimers:
    """Host seconds of each compression phase, synchronized at the phase
    boundaries: the spectral decay of the synthetic weights (where the run
    makes them), the HBD (unblocked loop, or blocked QR + HBD of R), the
    sort, the truncation, the whole SVD (phase 2 = SVD - HBD - sort), by
    wrapping the functions the compression path calls for one run."""

    def __init__(self):
        blocked, svd, truncation, tt, tt_linear = (
            importlib.import_module(f"repro_torch.core.{m}")
            for m in ("blocked", "svd", "truncation", "tt", "tt_linear"))
        self.sec = {"hbd": 0.0, "sort": 0.0, "truncate": 0.0, "svd": 0.0,
                    "decay": 0.0}
        self.targets = [
            (svd, "householder_bidiagonalize", "hbd"),
            (svd, "householder_bidiagonalize_batched", "hbd"),
            (blocked, "blocked_bidiagonalize", "hbd"),
            (blocked, "blocked_bidiagonalize_batched", "hbd"),
            (svd, "sorting_basis", "sort"),
            (truncation, "truncation_rank", "truncate"),
            (truncation, "truncate_masked", "truncate"),
            (tt, "_svd_fn", "svd"), (tt, "_svd_batched", "svd"),
            (tt_linear, "spectral_decay_pytree", "decay")]
        self.saved = []

    def _wrap(self, fn, key):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.sec[key] += time.perf_counter() - t0
            return out
        return timed

    def __enter__(self):
        for mod, name, key in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(fn, key))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def breakdown(self, total: float) -> dict:
        s = self.sec
        return {"total_s": total, "decay_s": s["decay"], "hbd_s": s["hbd"],
                "diag_s": s["svd"] - s["hbd"] - s["sort"], "sort_s": s["sort"],
                "truncate_s": s["truncate"],
                "rest_s": total - s["svd"] - s["truncate"] - s["decay"]}
