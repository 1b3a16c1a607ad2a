#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), torch and CUDA versions; builds the
   CUDA kernels from ``src/repro_torch/kernels/*/csrc`` and prints the
   build time.
2. Main path: ``repro_torch.launch.serve.serve`` on full-width
   qwen1.5-0.5b (24 layers, d_model 1024, 16x64 heads, d_ff 2816, vocab
   151,936), random weights from a seed, 4 requests, prompt 16, gen 16,
   greedy, eps 0.2 — once with ``--weights tt`` and once with
   ``--weights tt-int8``.  Compression runs on the card.  The launch
   counters are zeroed just before each run and read just after: every
   TT chain must have run on a hand-written kernel (no plain-path chain).
   Gates, both in float32 activations so that two runs differ only by
   float32 summation order, held to F32_TOL (1e-4) of the logits' scale:
   the served params' teacher-forced logits with the kernels against the
   same params on the CPU's plain path (tt and tt-int8), and TT-native
   against reconstruct-then-serve with the same cores (tt); and the fused
   and python drivers give the same tokens (tt).  The reference's own bf16
   verify numbers are printed, not gated: on full-width synthetic weights
   the JAX reference misses them itself, seed to seed (PERF.md).
3. Kernel phase: each of the four kernels against its plain PyTorch
   version on the same card tensors, at every chain shape the main path
   gave it and at B in {1, 4, 64}, with float32, bfloat16 and int8 tail
   cores (``kernels/tt_contract/cases.py``); pass when max|Δ| <= 2e-4 *
   max|ref|.  Times (CUDA events, median) of the kernel, its plain
   version and one ``torch.einsum`` call over the same chain, with the
   tail cores in the dtype the main path serves (bfloat16, int8).
4. Prints one ``{"kernels": [...]}`` JSON line, the card line again, and
   as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA card, and on any failed phase.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s and f32
# FLOP/s outside the tensor cores (the kernels' FFMA path)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TOL = 2e-4       # kernel phase: max|d| <= TOL * max|ref|
F32_TOL = 1e-4   # main path, float32 logits: max|d| <= F32_TOL * scale
DEVICE = "cuda"
ARCH = "qwen1.5-0.5b"
# tail-core dtypes the main path serves: tt_native_params keeps cores in
# bfloat16, quantize_tt stores them in int8
SERVED_TAIL = (torch.bfloat16, torch.int8)
SERVE_ARGS = ["--arch", ARCH, "--batch", "4", "--prompt-len", "16",
              "--gen", "16", "--seed", "0", "--tt-eps", "0.2"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


FAILURES: list = []


def check(ok: bool, msg: str) -> None:
    """Record a failed gate; every phase still runs so one call on the card
    reports all its numbers, and the script exits non-zero at the end."""
    if not ok:
        print(f"[chip_smoke] FAIL: {msg}")
        FAILURES.append(msg)


def time_ms(fn, reps: int = 30) -> float:
    """Median time of ``fn()`` on the card, CUDA events around each call."""
    for _ in range(3):
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


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def _on(device, params):
    """A copy of a params tree on ``device`` (TT leaves included)."""
    from repro_torch import tree
    from repro_torch.core.tt_linear import is_tt_linear

    def mv(leaf):
        if is_tt_linear(leaf):
            return dataclasses.replace(
                leaf, lead=None if leaf.lead is None else leaf.lead.to(device),
                cores=[c.to(device) for c in leaf.cores],
                scales=(None if leaf.scales is None
                        else [s.to(device) for s in leaf.scales]),
                lead_scale=(None if leaf.lead_scale is None
                            else leaf.lead_scale.to(device)))
        return leaf.to(device)
    return tree.map_leaves(mv, params, is_leaf=is_tt_linear)


def _f32_model(model, device):
    """The model in float32 with a float32 KV cache: no bf16 rounding of
    activations, so two runs differ only by float32 summation order."""
    from repro_torch.models import transformer
    from repro_torch.models.registry import build
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    return dataclasses.replace(
        build(cfg32, device=device),
        init_cache=lambda b, n: transformer.init_cache(
            cfg32, b, n, device, dtype=torch.float32))


def kernels_vs_plain(serve_mod, out, weights: str) -> float:
    """Teacher-forced logits of the served params with the CUDA kernels
    against the same params on the CPU, where every chain takes the plain
    PyTorch version: the hand kernels held to their oracle on the real path
    at full width and depth.  The cores stay as served (bf16 or int8, so
    the same kernel instantiations run); activations and raw leaves are
    float32, so rounding of bf16 activations, which depth amplifies, does
    not hide a kernel fault."""
    from repro_torch import tree
    params = tree.map_leaves(
        lambda x: x.float() if isinstance(x, torch.Tensor) else x,
        out["params"])
    prompts = torch.as_tensor(out["prompts"], dtype=torch.int64)
    tf_gpu = serve_mod.teacher_forced_logits(
        _f32_model(out["model"], DEVICE), params, prompts.to(DEVICE))
    tf_cpu = serve_mod.teacher_forced_logits(
        _f32_model(out["model"], "cpu"), _on("cpu", params), prompts)
    scale = float(np.abs(tf_cpu).max())
    d = float(np.abs(tf_gpu - tf_cpu).max())
    check(d <= F32_TOL * scale,
          f"{weights}: kernels vs plain max|d| {d:.3e} over "
          f"{F32_TOL} * scale {scale:.3e}")
    print(f"[chip_smoke] {weights}: kernels (card) vs plain (CPU), "
          f"teacher-forced in float32: max|d|/scale {d / scale:.3e}")
    return d / scale


def f32_oracle(serve_mod, out) -> float:
    """TT-native serving against reconstruct-then-serve with the same cores,
    everything in float32 (no bf16 rounding): the compress → convert →
    TT-apply path computes the dense model's function."""
    from repro_torch import tree
    from repro_torch.core import compression as comp
    from repro_torch.core.tt import tt_reconstruct
    from repro_torch.core.tt_linear import is_tt_linear
    from repro_torch.models import common
    model, payload = out["model"], out["payload"]
    m32 = _f32_model(model, DEVICE)
    rx32 = tree.map_leaves(
        lambda c: (tt_reconstruct(c.tt).reshape(c.orig_shape)
                   if c.kind == "tt" else c.raw.float()),
        payload, is_leaf=comp.is_compressed_param)
    dense32 = dict(tree.leaves_with_paths(rx32))
    tt32 = tree.map_with_path(
        lambda path, x: x if is_tt_linear(x) else dense32[path],
        common.tt_native_params(payload, family=model.cfg.family,
                                core_dtype=torch.float32),
        is_leaf=is_tt_linear)
    prompts = torch.as_tensor(out["prompts"], dtype=torch.int64,
                              device=DEVICE)
    tf_tt = serve_mod.teacher_forced_logits(m32, tt32, prompts)
    tf_rx = serve_mod.teacher_forced_logits(m32, rx32, prompts)
    d, scale, agree = common.logit_parity(torch.from_numpy(tf_tt),
                                          torch.from_numpy(tf_rx))
    check(d <= F32_TOL * scale,
          f"tt f32: TT-native vs reconstruct max|d| {d:.3e} over "
          f"{F32_TOL} * scale {scale:.3e}")
    print(f"[chip_smoke] tt f32: TT-native vs reconstruct-then-serve "
          f"max|d|/scale {d / scale:.3e}, argmax agreement {agree:.2%}")
    return d / scale


def run_main_path(ops, serve_mod, weights: str) -> dict:
    """``serve()`` once; the launch counters cover exactly this run."""
    args = serve_mod.parse_args(SERVE_ARGS + ["--weights", weights])
    ops.reset_launches()
    t0 = time.perf_counter()
    out = serve_mod.serve(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    ops.reset_launches()
    info, ver = out["info"], out["verify"]
    gen = out["generated"]
    check(gen.shape == (4, 16) and gen.min() >= 0 and gen.max() < 151_936,
          f"{weights}: generated tokens {gen.shape} out of range")
    check(bool(torch.isfinite(out["run"]["prompt_logits"]).all()),
          f"{weights}: non-finite logits")
    check(counts.get("plain_chains", 0) == 0,
          f"{weights}: {counts.get('plain_chains')} chains took the plain path")
    want = (("tt_contract_2", "tt_contract_3") if weights == "tt"
            else ("tt_contract_2q", "tt_contract_3q"))
    for k in want:
        check(counts.get(k, 0) > 0,
              f"{weights}: kernel {k} never launched on the main path")
    # decode steps that ran TT kernels: fused prefill + decode (16 + 15),
    # plus the int8 verify's teacher-forced pass over the prompt (15)
    steps = 31 + (15 if weights != "tt" else 0)
    print(f"[chip_smoke] main path {weights}: launches {counts} over {steps} "
          f"TT decode steps; compress {info['compress_s']:.3f}s; "
          f"decode {out['tok_per_s']:.2f} tok/s; wall {wall:.1f}s")
    # the reference's own verify gates, bf16 at full width: reported; on
    # identical full-width cores the JAX reference misses them itself
    # (tools/tt_parity_depth.py, PERF.md)
    print(f"[chip_smoke] {weights} reference-oracle gate (reported): "
          f"max|d|/scale {ver['max_diff'] / ver['scale']:.4f} (bound 0.05)"
          + (f", tie-tolerant agreement {ver['tie_agree']:.4f} (gate 0.99)"
             if "tie_agree" in ver else ""))
    res = {"counts": counts, "steps": steps, "info": info, "verify": ver,
           "tok_per_s": out["tok_per_s"], "run": out["run"]}
    res["kernels_vs_plain"] = kernels_vs_plain(serve_mod, out, weights)
    if weights == "tt":
        res["f32_oracle"] = f32_oracle(serve_mod, out)
        py = serve_mod.engine_mod.generate(
            out["model"], out["params"], out["prompts"], 16, driver="python")
        same = np.array_equal(py["gen"], gen)
        check(same, "tt: fused and python drivers disagree on the card")
        print(f"[chip_smoke] tt: fused == python driver tokens: {same}")
    return res


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def chain_cost(kind, shape, b, tail_itemsize):
    """(bytes, flops) the chain must move/do: each input read once (x, the
    absorbed first core in f32, the tail cores in storage type, the scale),
    the output written once; two FLOPs per multiply-add of the chain."""
    if kind == 2:
        n1, r1, n2 = shape
        n_in, n_out = n1, n2
        macs = n1 * r1 + r1 * n2
        tail = r1 * n2
    else:
        split, n1, r1, n2, r2, n3 = shape
        if split == 1:
            n_in, n_out = n1, n2 * n3
            macs = n1 * r1 + r1 * n2 * r2 + n2 * r2 * n3
        else:
            n_in, n_out = n1 * n2, n3
            macs = n1 * n2 * r1 + n2 * r1 * r2 + r2 * n3
        tail = r1 * n2 * r2 + r2 * n3
    nbytes = 4 * (b * n_in + n1 * r1 + b * n_out) + tail * tail_itemsize + 4
    return nbytes, 2 * b * macs


def chain_shapes(info):
    """{kernel kind: {shape: calls per layer}} from the main path's chains."""
    shapes = {2: {}, 3: {}}
    for split, cores in info["chains"].values():
        if len(cores) == 2:
            (_, n1, r1), (_, n2, _) = cores
            key = (n1, r1, n2)
            shapes[2][key] = shapes[2].get(key, 0) + 1
        elif len(cores) == 3:
            (_, n1, r1), (_, n2, r2), (_, n3, _) = cores
            key = (split, n1, r1, n2, r2, n3)
            shapes[3][key] = shapes[3].get(key, 0) + 1
        else:
            check(False, f"unexpected chain depth {len(cores)}")
    return shapes


def kernel_phase(ops, cases, shapes, batch_sizes=(1, 4, 64), report_b=4):
    """Check every kernel at every main-path shape with float32, bfloat16
    and int8 tail cores; time it with its tail cores as the main path serves
    them (bfloat16 for the wide kernels, int8 for the others).  Returns
    per-kernel records summed over one layer's calls at ``report_b``."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rec = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0}
           for k in ops.KERNELS}
    for b in batch_sizes:
        for kind, per_layer in shapes.items():
            for shape, calls in per_layer.items():
                for dtype in cases.TAIL_DTYPES:
                    name, kern, plain, library = cases.chain_case(
                        kind, shape, b, dtype, gen, DEVICE)
                    y = kern()
                    ref = plain()
                    torch.cuda.synchronize()
                    err = float((y - ref).abs().max())
                    scale = float(ref.abs().max())
                    ok = err <= TOL * scale
                    rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"],
                                                   err)
                    line = (f"[kernel] {name} {str(dtype)[6:]} shape={shape} "
                            f"B={b}: max|d| {err:.3e} (ref max {scale:.3e}) "
                            f"{'ok' if ok else 'FAIL'}")
                    check(ok, f"{name} {dtype} {shape} B={b} disagrees with "
                              f"its plain version")
                    if dtype not in SERVED_TAIL:
                        print(line)
                        continue
                    ms = time_ms(kern)
                    p_ms = time_ms(plain)
                    l_ms = time_ms(library)
                    nbytes, flops = chain_cost(kind, shape, b,
                                               dtype.itemsize)
                    bound = max(nbytes / HBM_BYTES_PER_S,
                                flops / F32_FLOPS) * 1e3
                    print(f"{line}; kernel {ms:.4f} ms, plain {p_ms:.4f} ms, "
                          f"einsum {l_ms:.4f} ms, bound {bound:.5f} ms")
                    if b == report_b:
                        r = rec[name]
                        r["ms"] += calls * ms
                        r["plain_ms"] += calls * p_ms
                        r["library_ms"] += calls * l_ms
                        r["bound_ms"] += calls * bound
                        r["bytes"] += calls * nbytes
                        r["flops"] += calls * flops
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.tt_contract import cases, ops
    from repro_torch.launch import serve as serve_mod

    card = card_line()
    print(f"[chip_smoke] card: {card}")
    print(f"[chip_smoke] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    ops.build()
    print(f"[chip_smoke] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    paths = {w: run_main_path(ops, serve_mod, w) for w in ("tt", "tt-int8")}
    print(f"[chip_smoke] main path phase {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    shapes = chain_shapes(paths["tt"]["info"])
    for kind, listed in cases.FULL_WIDTH_SHAPES.items():
        for shape in listed:
            shapes[kind].setdefault(shape, 0)   # checked, not in the sums
    rec = kernel_phase(ops, cases, shapes)
    print(f"[chip_smoke] kernel phase {time.perf_counter() - t0:.1f}s")

    kernels = []
    for name in ops.KERNELS:
        path = paths["tt" if not name.endswith("q") else "tt-int8"]
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/tt_contract/csrc/tt_contract.cu",
            "replaces": {"tt_contract_2": "src/repro/kernels/tt_contract/kernel.py:138",
                         "tt_contract_3": "src/repro/kernels/tt_contract/kernel.py:162",
                         "tt_contract_2q": "src/repro/kernels/tt_contract/kernel.py:190",
                         "tt_contract_3q": "src/repro/kernels/tt_contract/kernel.py:219"}[name],
            "launches": path["counts"].get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["flops"] / F32_FLOPS else "operations"),
            "library_ms": r["library_ms"],
            "timed": "sum over one layer's calls at B=4, main-path shapes",
        })
    summary = {
        w: {"compress_s": p["info"]["compress_s"], "tok_per_s": p["tok_per_s"],
            "ranks": {k: list(v) for k, v in p["info"]["ranks"].items()},
            "dense_bytes": p["info"]["dense_bytes"],
            "tt_bytes": p["info"]["tt_bytes"],
            "tt_leaf_bytes": p["info"]["tt_leaf_bytes"],
            "ttq_bytes": p["info"].get("ttq_bytes"),
            "ttq_leaf_bytes": p["info"].get("ttq_leaf_bytes"),
            "verify": p["verify"], "launches": p["counts"],
            "tt_steps": p["steps"],
            "kernels_vs_plain": p["kernels_vs_plain"],
            "f32_oracle": p.get("f32_oracle")}
        for w, p in paths.items()}
    print(f"[chip_smoke] main path summary: {json.dumps(summary)}")
    if FAILURES:
        print(f"[chip_smoke] {len(FAILURES)} failed check(s): {FAILURES}")
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
