"""Timing on the card, shared by ``chip_smoke.py`` and the tools.

``time_ms(fn)`` is the median of CUDA-event times around single calls of
``fn`` after a few warm-up calls (the host's time to issue the call shows
in it when the card waits for the host); ``device_ms(fn)`` is the card's
own time per call of each kernel ``fn`` launches, from ``torch.profiler``
(``kernel_ms`` reads a profile; a session that sees no kernel gives {});
``graph_ms(fn)`` is the card's time per call with no host in the way and
no profiler, from CUDA events around replays of a CUDA graph of calls
(``capture`` makes one; ``graph_node_types`` reads the device work one
call enqueues from such a graph); ``PhaseTimers`` adds up the host seconds
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


def gap_ms(prof, before: str, after: str) -> tuple:
    """(pairs, total ms) of the device time from the end of each CUDA
    event whose name holds ``before`` to the start of the next one whose
    name holds ``after`` (one stream: what the device waits between them)."""
    from torch.autograd import DeviceType
    evs = sorted((e.start_ns(), e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA
                 and (before in e.name() or after in e.name()))
    pairs, total, end = 0, 0.0, None
    for start, dur, name in evs:
        if after in name and end is not None:
            pairs, total, end = pairs + 1, total + (start - end) / 1e6, None
        elif before in name:
            end = start + dur
    return pairs, total


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


def capture(fn, calls: int = 1, keep_graph: bool = False):
    """A CUDA graph of ``calls`` calls of ``fn``, captured on a side stream
    after one warm-up call on that stream (what a call sets up for its
    stream, it sets up outside the capture)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    with torch.cuda.graph(g, stream=s):
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    return g


def graph_node_types(fn) -> tuple:
    """(node types, CUresult) of a CUDA graph captured from one call of
    ``fn`` after a warm-up call on the capture stream (``capture``): 0 =
    kernel, 1 = copy, 2 = fill, ...; the device work the call enqueues,
    read exactly from libcuda (CUresult 0: read)."""
    import ctypes
    g = capture(fn, 1, keep_graph=True)
    cuda = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    code = cuda.cuGraphGetNodes(graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    code = code or cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    types = []
    for i in range(n.value):
        t = ctypes.c_int(-1)
        code = code or cuda.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                               ctypes.byref(t))
        types.append(t.value)
    g.reset()
    return types, code


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device ms per call of ``fn``: ``calls`` calls in one CUDA graph,
    replayed ``reps`` times after a warm-up replay, the median replay
    between CUDA events over ``calls``.  The kernels' time and the graph's
    own gaps between them; no host time and no profiler."""
    g = capture(fn, calls)
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    g.reset()
    return statistics.median(times)


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
