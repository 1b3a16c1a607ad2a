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
   The main path compresses on the default batched plan; at full width
   every bucket runs serial, through the sort and truncation kernels
   (gated: both launched, no plain engine call on the card).
   The tt run also profiles 3 fused decode steps (``decode_profile``:
   host wall, device busy, kernels by device time).
3. Kernel phase: every chain the main path serves, as ``tt_apply`` runs it
   from the stored tensors (lead row, first core (r_s, n1, r1), tail cores,
   scales: ``kernels/tt_contract/cases.stored_case``), against its plain
   version (``ref.tt_chain_ref``: einsum absorption, then the chain) on the
   same card tensors, at B in {1, 4, 64}, in float32, bfloat16 and int8
   storage; pass when max|Δ| <= 2e-4 * max|ref|.  At B = 4 with bf16 x and
   the storage the main path serves (bfloat16, int8): times (CUDA events,
   median) of the call, its plain version and one ``torch.einsum`` of x,
   the cores and the lead; the profiler's device time; and the one-call
   gate: one ``tt_apply`` call runs at most 2 device kernels, both chain
   kernels (no cast, einsum, copy or elementwise kernel), read from a CUDA
   graph captured from the call (the profiler's names printed beside).  The
   bound counts the stored bytes and the absorption's operations at the
   peak of the route taken.  The absorbed-chain API (r_s = 1) of the four
   kernels is held to its plain version at the shapes of ``cases.py``.
4. TTD-engine phase (the paper's engine: panel factor, WY update, sort,
   truncation; ``kernels/{householder,block_update,singular_sort,
   frob_truncate}``):
   a. full-width qwen1.5-0.5b, the main path's weights, compressed with
      the TT-Edge policy (``hbd_impl="blocked"``) on the batched plan,
      under ``torch.profiler`` (device time by kernel, each engine
      kernel's and WY pass 1's share, the panel factor's split by route):
      plan, seconds, ranks beside the main path's (each within one), every
      TT leaf within ε, TT-native vs reconstruct-then-serve in float32 at
      1e-4 of scale, and the single-panel (its streamed panels on the TSQR
      route, none on the sweep), WY (pass 1 on its 16-byte copy route), sort
      and truncation kernels launched with no plain call; then where the
      time goes, for both HBD impls (host timers around each phase,
      synchronized);
   b. ResNet-32 (``configs/resnet32.py``, seed 0, α 1.0, eps 0.2), blocked,
      batched plan: 4 bucket passes and no serial member, every TT leaf
      within ε, ranks and payload equal to a ``plan="serial"`` run, and
      the batched kernels launched (the batched panel on the TSQR route
      too, none on the sweep);
   c. each engine kernel against its plain version at the shapes those
      two runs gave it (printed; the WY views 16-byte aligned, as blocked
      QR's; the panels dense, and also with trailing zero columns as
      ``qr_blocked`` pads them), ragged shapes (the WY views misaligned:
      pass 1's 4-byte copy route; the panels dense, padded and with an
      interior zero column) and panels on either side of the
      shared-memory limit (``kernels/engine_cases.py``): 2e-4 * max|ref|,
      and for panels also V per column, τ, R per row and the float64
      residual and orthogonality (``engine_cases.compare``), each panel
      counted under the route its fill and height pick (smem, tsqr,
      sweep), trailing zero columns exactly zero, repeat calls
      bit-identical; sorted σ, index vectors and ranks exactly equal; WY
      pass 1 also on integer inputs in
      {-1, 0, 1} at each of those shapes (and the ragged ones aligned too),
      equal bit for bit to the float64 product, and twice on the same random
      inputs, equal; its ptxas registers and spills, its layout (stages,
      tile, blocks per SM from CUDA's occupancy calculator, which must match
      ``ops.chunk_plan``'s) and the copies in flight per SM; the blocked
      SVD (phase 2 in float64) of wq's 24,576 x 1,024 unfolding against
      ``torch.linalg.svd`` in float64 (max|Δσ| <= 1e-4 σ_max); times of
      kernel, plain version and library call (geqrf, matmul, baddbmm,
      sort).
5. Hybrid phase (``models/rglru.py``, ``kernels/flash_attention``):
   a. the main path ``serve --arch recurrentgemma-2b --weights tt`` at full
      width and depth (26 layers, d_model 2560, 10 Q heads and 1 KV head x
      256, d_ff 7680, vocab 256,000, window 2048), random weights from seed
      0 with the spectral decay, eps 0.2: compression seconds, ranks,
      resident bytes, every TT leaf within eps, chain, sort and truncation
      kernels launched with no plain call;
   b. prefill through ``make_prefill_step`` at B = 2, S = 4096 with the
      same compression's dense bf16 and TT-native weights, ``impl="pallas"``
      (flash kernel: 8 launches per prefill, one per attention layer, all
      on the bf16 tensor-core route ``flash_attention_mma``) and
      ``impl="xla"`` (plain chunked attention): tokens/s, and the bf16
      differences printed.  Gates in float32 activations at F32_TOL of
      scale, every flash launch on the float32 3xTF32 tensor-core route
      ``flash_attention_f32`` (8 per run): G1 pallas vs xla with dense
      weights (and ``make_eval_step`` at B = 1, S = 4096: losses within
      1e-5 relative); G2 TT-native prefill (flash + chain kernels) vs
      reconstruct-then-prefill (plain); G3 prefill's last logits vs decode
      stepped through the ring-buffer window cache at S = 2176 (the ring
      wraps);
   b'. the stored chains of this compression (``stored_phase``) at B in
      {1, 4, 8192} (8,192: the prefill's rows), as in 3.;
   c. the flash kernel against its plain version at every shape of
      ``kernels/flash_attention/cases.py`` in float32 (3xTF32 route, TOL
      of max|ref|; also against ``mha_ref`` in float64 within
      ``cases.F64_REL`` of max|ref|) and bfloat16 (mma route, 2e-2 on
      unit-normal inputs), and in bfloat16 also per element against the
      route's tile-wise plain version ``mha_tiled`` (``cases.tiled_gap``
      within ``TILED_ABS``, on this draw and TILED_DRAWS more);
      S = 200 must raise; ptxas's registers and spills of each route's
      kernels, from the build log; at the path's shape, times of each
      route (CUDA-event median and graph replays), its plain version and
      one ``scaled_dot_product_attention`` call in the route's dtype, each
      route against its own bound (the bf16 tensor-core rate for mma; for
      f32 three TF32 products at the TF32 rate, the FFMA bound beside it).
6. MoE phase (``models/mlp.moe_apply``, the expert-batched routes of
   ``kernels/tt_contract``):
   a. the main path ``serve --arch olmoe-1b-7b`` at full width and depth
      (16 layers, d_model 2048, 16x128 heads with qk-norm, 64 experts top-8
      of d_ff 1024, vocab 50,304, untied), random weights from seed 0 with
      the spectral decay, eps 0.2, B = 4, prompt 16, gen 16: ``--weights
      tt``, then ``tt-int8`` on the same compression: compression seconds,
      peak device memory, bytes, the banks' ranks, decode tok/s;
   b. every expert bank call one batched call: tt_contract_2_batched
      (tt) and tt_contract_2q_batched (int8) exactly 3 banks x 16 layers x
      the TT decode steps, every one on the tensor-core route
      (``..._batched_mma``), no plain chain, no plain call on the card; the
      tt run also profiles 3 fused decode steps;
   c. float32: each MoE call of the reconstruct-then-serve teacher-forced
      run replayed with the TT-native banks and the dense banks (same input,
      same routing), per layer within F32_TOL of scale; the whole model's
      teacher-forced logits printed with the routing flips between the two
      and their margins;
   d. the banks from their stored tensors with the lead (as 3., through
      ``tt_apply_experts``): the path's bank shapes and a synthetic depth-3
      and ragged bank, 64 experts of 1, 4 and 64 tokens and 3 of 9,
      float32, bfloat16 and int8 storage (TOL of max|ref|; bf16 and int8 on
      the tensor-core route); times at 1 token per expert (float32 too, the
      gates' FFMA route); the attention chains at B in {1, 4}; the absorbed
      batched API's routes against their plain versions.
7. Prints the script's total seconds, one ``{"kernels": [...]}`` JSON line
   (the twelve other ported kernels, one entry per flash route and one per
   batched chain route, the float32 banks' FFMA route too; the panel rows
   with their main-path route counts),
   the card line again, and as the last line ``{"ok": true, "device":
   {...}}``.

Exits non-zero without a CUDA card, and on any failed phase.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cuda_timing import (  # noqa: E402
    PhaseTimers, gap_ms, graph_ms, graph_node_types, kernel_ms, time_ms)

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s and f32
# FLOP/s outside the tensor cores (the kernels' FFMA path)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# dense tensor-core peaks (same source): the banks' absorption route
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
TF32_FLOPS = 495e12  # the float32 flash route's three TF32 products
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
    """The model in float32 with a float32 decode cache: no bf16 rounding
    of activations, so two runs differ only by float32 summation order."""
    from repro_torch.models import rglru, transformer
    from repro_torch.models.registry import build
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    init_cache = {"dense": transformer.init_cache,
                  "moe": transformer.init_cache,
                  "hybrid": rglru.init_cache}[cfg32.family]
    return dataclasses.replace(
        build(cfg32, device=device),
        init_cache=lambda b, n: init_cache(cfg32, b, n, device,
                                           dtype=torch.float32))


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


def f32_params(payload, family: str):
    """(TT-native params, reconstructed dense params) of one payload, both
    in float32: TT leaves keep float32 cores, every other leaf is the same
    float32 reconstruction in both."""
    from repro_torch import tree
    from repro_torch.core import compression as comp
    from repro_torch.core.tt import tt_reconstruct
    from repro_torch.core.tt_linear import is_tt_linear
    from repro_torch.models import common
    rx32 = tree.map_leaves(
        lambda c: (tt_reconstruct(c.tt).reshape(c.orig_shape)
                   if c.kind == "tt" else c.raw.float()),
        payload, is_leaf=comp.is_compressed_param)
    dense32 = dict(tree.leaves_with_paths(rx32))
    tt32 = tree.map_with_path(
        lambda path, x: x if is_tt_linear(x) else dense32[path],
        common.tt_native_params(payload, family=family,
                                core_dtype=torch.float32),
        is_leaf=is_tt_linear)
    return tt32, rx32


def f32_oracle(serve_mod, out) -> float:
    """TT-native serving against reconstruct-then-serve with the same cores,
    everything in float32 (no bf16 rounding): the compress → convert →
    TT-apply path computes the dense model's function."""
    from repro_torch.models import common
    model = out["model"]
    m32 = _f32_model(model, DEVICE)
    tt32, rx32 = f32_params(out["payload"], model.cfg.family)
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


def kernel_modules():
    """The ops modules of every ported kernel (chain, engine, attention)."""
    from repro_torch.kernels.block_update import ops as wy
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.frob_truncate import ops as ft
    from repro_torch.kernels.householder import ops as hh
    from repro_torch.kernels.singular_sort import ops as ss
    from repro_torch.kernels.tt_contract import ops as tc
    return (tc, hh, wy, ss, ft, fa)


def reset_counts() -> None:
    for m in kernel_modules():
        m.reset_launches()


def read_counts() -> dict:
    """Every module's launch counts; plain calls on the card are keyed
    ``plain_on_cuda:<kernel dir>``."""
    out = {}
    for m in kernel_modules():
        for k, v in m.launches.items():
            if k == "plain_on_cuda":
                k = f"plain_on_cuda:{m.__name__.split('.')[-2]}"
            out[k] = out.get(k, 0) + v
    return out


def check_no_plain(counts: dict, what: str) -> None:
    for k, v in counts.items():
        if k.startswith("plain_on_cuda") and v:
            check(False, f"{what}: {v} plain calls on the card ({k})")


def run_main_path(ops, serve_mod, weights: str) -> dict:
    """``serve()`` once; the launch counters cover exactly this run."""
    args = serve_mod.parse_args(SERVE_ARGS + ["--weights", weights])
    reset_counts()
    t0 = time.perf_counter()
    out = serve_mod.serve(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    reset_counts()
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
    # compression on the batched plan: every full-width bucket is serial,
    # so each TT-SVD step sorts and truncates on the engine kernels
    want += ("bitonic_sort_desc", "frob_truncate")
    for k in want:
        check(counts.get(k, 0) > 0,
              f"{weights}: kernel {k} never launched on the main path")
    check_no_plain(counts, weights)
    ex = info["exec_stats"]
    print(f"[chip_smoke] main path {weights}: compression plan "
          f"{ex.bucket_launches} bucket passes, {ex.serial_params} serial "
          f"params, fingerprint {info['plan_fingerprint'][:16]}")
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
           "tok_per_s": out["tok_per_s"], "run": out["run"],
           "prompts": out["prompts"]}
    res["kernels_vs_plain"] = kernels_vs_plain(serve_mod, out, weights)
    if weights == "tt":
        res["decode_profile"] = decode_profile(out, "qwen1.5-0.5b tt")
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

def chain_cost(split, shapes, b, itemsize, x_itemsize, experts=None,
               absorb_peak=F32_FLOPS):
    """(bytes, absorption ops, chain ops, bound ms) of one stored call
    (``cases.stored_case``): x, the lead row(s), the stored cores in their
    storage type and the scales read once, y written once; the absorption's
    E·r_s·n1·r1 multiply-adds at ``absorb_peak`` (the route taken: tensor
    cores for a bf16 or int8 bank, FFMA otherwise), the chain's at the FFMA
    peak; two operations per multiply-add."""
    e = experts or 1
    rs, n1, r1 = shapes[0]
    if len(shapes) == 2:
        n2 = shapes[1][1]
        n_in, n_out, macs = n1, n2, n1 * r1 + r1 * n2
    else:
        _, n2, r2 = shapes[1]
        n3 = shapes[2][1]
        if split == 1:
            n_in, n_out = n1, n2 * n3
            macs = n1 * r1 + r1 * n2 * r2 + n2 * r2 * n3
        else:
            n_in, n_out = n1 * n2, n3
            macs = n1 * n2 * r1 + n2 * r1 * r2 + r2 * n3
    nbytes = (x_itemsize * e * b * (n_in + n_out)
              + itemsize * (e * rs + sum(math.prod(c) for c in shapes))
              + 4 * (len(shapes) + e))
    absorb, chain = 2 * e * rs * n1 * r1, 2 * e * b * macs
    bound = max(nbytes / HBM_BYTES_PER_S,
                absorb / absorb_peak + chain / F32_FLOPS) * 1e3
    return nbytes, absorb, chain, bound


def chain_shapes(info, experts: bool = False):
    """{(split, stored core shapes): calls per layer} of the main path's
    single chains (or, with ``experts``, its expert banks)."""
    shapes = {}
    for split, cores, e in info["chains"].values():
        if bool(e) != experts:
            continue
        check(len(cores) in (2, 3),
              f"unexpected chain depth {len(cores)}: {cores}")
        key = (split, tuple(tuple(c) for c in cores))
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


# the chain kernels of kernels/tt_contract (phase A routes, phase B)
CHAIN_KERNELS = ("absorb_in_kernel", "bank_kernel", "contract2_kernel",
                 "expand1_kernel", "expand1_wide_kernel", "expand2_kernel")


def profile_call(fn, calls: int = 5):
    """(the device kernels one call of ``fn`` launches, its device ms):
    ``torch.profiler`` over ``calls`` calls after a warm-up call.  A session
    that sees no device kernel is run once more; sessions late in a long
    process can still come back empty (then ([], None): not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    kern = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if kern:
            break
    names = [e.key for e in kern for _ in range(round(e.count / calls))]
    if not kern:
        return [], None
    return names, sum(e.self_device_time_total for e in kern) / 1e3 / calls


def graph_nodes(fn) -> list:
    """The node types (0 = kernel, 1 = copy, 2 = fill, ...) of a CUDA graph
    of one call of ``fn`` (``cuda_timing.graph_node_types``)."""
    types, code = graph_node_types(fn)
    check(code == 0, f"reading a captured graph failed: CUresult {code}")
    return types


def one_call_gate(fn, names, what: str) -> list:
    """One tt_apply call is at most 2 device kernels and nothing else (no
    cast, einsum, copy, fill or elementwise kernel): the nodes of a CUDA
    graph of the call, all kernels, one or two of them; the profiler's
    kernel names are printed beside them where it saw the call."""
    kinds = graph_nodes(fn)
    short = [next((k for k in CHAIN_KERNELS if k in n), n[:60])
             for n in names]
    check(1 <= len(kinds) <= 2 and all(k == 0 for k in kinds)
          and all(n in CHAIN_KERNELS for n in short),
          f"{what}: one call is {len(kinds)} graph nodes {kinds} (0 = "
          f"kernel), profiled kernels {short}")
    return short


def _peak(dtype, experts, route_counts) -> float:
    """The absorption's peak for the route a call took."""
    if experts and any(k.endswith("_mma") and v
                       for k, v in route_counts.items()):
        return INT8_OPS if dtype == torch.int8 else BF16_FLOPS
    return F32_FLOPS


# bf16 x: y is stored in bf16, so the kernel's y may sit half an output
# ulp (2^-8 of |y| at most) from the float32 plain version's, on top of TOL
X_TOL = {torch.float32: TOL, torch.bfloat16: 2.0 ** -8 + TOL}


def stored_phase(ops, cases, shapes, what: str, batch_sizes=(1, 4, 64),
                 report_b=4, experts=False, ec=None,
                 timed=SERVED_TAIL) -> dict:
    """Every stored chain of ``shapes`` (``chain_shapes``) through
    ``tt_apply`` (``experts``: ``tt_apply_experts``, at the (E, C) of ``ec``)
    against its plain version (``ref.tt_chain_ref`` on the same x, in
    float32), with float32, bfloat16 and int8 storage, each with float32 x
    and with bf16 x (whose y is bf16): max|d| <= X_TOL[x dtype] * max|ref|;
    a bank in bf16 or int8 must take the tensor-core route.  At
    ``report_b`` rows (or C = 1 tokens per expert), in the storage the main
    path serves (bf16, int8) with bf16 x as served: CUDA-event times of the
    call, its plain version and one ``torch.einsum`` of x, the cores and
    the lead; the device time from replays of a CUDA graph of calls
    (``graph_ms``; the profiler's is printed beside it, "not measured"
    where a session came back empty, and can miss kernels late in a long
    process, so it is not kept); the one-call gate.  Returns
    per-kernel records summed over one layer's calls (a float32 bank under
    ``<kernel>_batched_fma``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rec = {}
    pairs = ec if experts else [(None, b) for b in batch_sizes]
    for (split, cores), calls in shapes.items():
        for e, b in pairs:
            for dtype in cases.TAIL_DTYPES:
                for x_dtype in X_TOL:
                    name, kern, plain, library = cases.stored_case(
                        split, cores, b, dtype, gen, DEVICE, experts=e,
                        x_dtype=x_dtype)
                    ops.reset_launches()
                    y = kern()
                    routes = {k: v for k, v in ops.launches.items()
                              if k.endswith(("_mma", "_fma"))}
                    ref = plain()
                    torch.cuda.synchronize()
                    err, scale = _gap(y, ref)
                    ok = y.dtype == x_dtype and err <= X_TOL[x_dtype] * scale
                    tag = (f"{name} {str(dtype)[6:]} x {str(x_dtype)[6:]} "
                           f"{what} stored={list(cores)} split={split} "
                           + (f"E={e} C={b}" if e else f"B={b}"))
                    check(ok, f"{tag} disagrees with its plain version: "
                              f"max|d| {err:.3e} (ref max {scale:.3e}, y "
                              f"{y.dtype})")
                    if e and dtype != torch.float32:
                        check(routes.get(f"{name}_mma") == 1,
                              f"{tag}: not on the tensor-core route {routes}")
                    key = name + ("_fma" if e and dtype == torch.float32
                                  else "")
                    r = rec.setdefault(key, {
                        "max_abs_err": 0.0, "ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "library_ms": 0.0, "bytes": 0, "ops_absorb": 0,
                        "ops_chain": 0, "time_peak": F32_FLOPS,
                        "routes": {}})
                    if x_dtype == torch.float32:
                        r["max_abs_err"] = max(r["max_abs_err"], err)
                    else:
                        r["max_abs_err_bf16_x"] = max(
                            r.get("max_abs_err_bf16_x", 0.0), err)
                    for k, v in routes.items():
                        r["routes"][k] = r["routes"].get(k, 0) + v
                    served_x = (torch.float32 if dtype == torch.float32
                                else torch.bfloat16)
                    if not (dtype in timed and b == (1 if e else report_b)
                            and x_dtype == served_x):
                        print(f"[kernel] {tag}: max|d| {err:.3e} (ref max "
                              f"{scale:.3e}) " + ("ok" if ok else "FAIL"))
                        continue
                    ms, p_ms, l_ms = (time_ms(f) for f in
                                      (kern, plain, library))
                    g_ms = graph_ms(kern)
                    names, dev = profile_call(kern)
                    peak = _peak(dtype, e, routes)
                    nbytes, absorb, chain, bound = chain_cost(
                        split, cores, b, dtype.itemsize, x_dtype.itemsize, e,
                        peak)
                    names = one_call_gate(kern, names, tag)
                    dev_txt = ("not measured" if dev is None
                               else f"{dev:.4f}")
                    print(f"[kernel] {tag}: max|d| {err:.3e} (ref max "
                          f"{scale:.3e}) {'ok' if ok else 'FAIL'}; call "
                          f"{ms:.4f} ms (graph replay {g_ms:.4f}, profiler "
                          f"{dev_txt}: {names}), plain {p_ms:.4f} ms, "
                          f"einsum {l_ms:.4f} ms, bound {bound:.5f} ms")
                    r["ms"] += calls * ms
                    r["graph_ms"] += calls * g_ms
                    r["plain_ms"] += calls * p_ms
                    r["library_ms"] += calls * l_ms
                    r["bound_ms"] += calls * bound
                    r["bytes"] += calls * nbytes
                    r["ops_absorb"] += calls * absorb
                    r["ops_chain"] += calls * chain
                    r["time_peak"] = peak
    return rec


def absorbed_phase(ops, cases) -> float:
    """The absorbed-chain API (r_s = 1, float32 first core) of the four
    kernels at ``cases.FULL_WIDTH_SHAPES`` and the ragged shapes, B in
    {1, 4, 64}, float32, bfloat16 and int8 tails, against its plain
    version: TOL * max|ref|.  Returns the largest max|d|."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    worst = 0.0
    for table in (cases.FULL_WIDTH_SHAPES, cases.RAGGED_SHAPES):
        for kind, listed in table.items():
            for shape in listed:
                for b in (1, 4, 64):
                    for dtype in cases.TAIL_DTYPES:
                        name, kern, plain, _ = cases.chain_case(
                            kind, shape, b, dtype, gen, DEVICE)
                        err, scale = _gap(kern(), plain())
                        worst = max(worst, err)
                        check(err <= TOL * scale,
                              f"absorbed {name} {dtype} {shape} B={b} "
                              f"disagrees with its plain version")
    print(f"[chip_smoke] absorbed-chain API: every shape within TOL, worst "
          f"max|d| {worst:.3e}")
    return worst


# ---------------------------------------------------------------------------
# TTD-engine phase
# ---------------------------------------------------------------------------

EPS = 0.2
PANEL = 32          # core/blocked.py's panel width


def tt_leaves(payload) -> dict:
    from repro_torch import tree
    from repro_torch.core import compression as comp
    return {path: c for path, c in tree.leaves_with_paths(
        payload, is_leaf=comp.is_compressed_param) if c.kind == "tt"}


def eps_gate(params, payload, what: str) -> float:
    """Every TT leaf within ε of its dense weight; returns the worst
    relative error."""
    from repro_torch import tree
    from repro_torch.core import compression as comp
    dense = dict(tree.leaves_with_paths(params))
    worst = 0.0
    for path, c in tt_leaves(payload).items():
        w = torch.as_tensor(dense[path]).to(DEVICE, torch.float32)
        rec = comp.decompress_param(c).to(DEVICE, torch.float32)
        rel = float(torch.linalg.vector_norm(w - rec)
                    / torch.linalg.vector_norm(w))
        check(rel <= EPS, f"{what}: {path} error {rel:.4f} > eps {EPS}")
        worst = max(worst, rel)
    print(f"[chip_smoke] {what}: every TT leaf within eps {EPS} "
          f"(worst ||W - W_R|| / ||W|| {worst:.4f})")
    return worst


def compress_timed(params, policy, plan=None, timers=False):
    """(payload, report, seconds), optionally with the phase breakdown."""
    from repro_torch.core import compression as comp
    torch.cuda.synchronize()
    if timers:
        with PhaseTimers() as pt:
            t0 = time.perf_counter()
            payload, report = comp.TTCompressor(policy).compress(params, plan)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        return payload, report, dt, pt.breakdown(dt)
    t0 = time.perf_counter()
    payload, report = comp.TTCompressor(policy).compress(params, plan)
    torch.cuda.synchronize()
    return payload, report, time.perf_counter() - t0, None


# the engine kernels by the names of their CUDA functions
ENGINE_KERNELS = {"wy pass 1": ("vta_partial_kernel", "vta_reduce_kernel"),
                  "wy pass 2": ("wy_apply_kernel",),
                  "panel factor": ("panel_",),
                  "sort": ("bitonic_sort_kernel",),
                  "truncate": ("truncate_warp_kernel",
                               "truncate_block_kernel")}
# the panel factor's routes by the names of their CUDA functions
PANEL_ROUTES = {"smem": ("panel_smem_kernel",), "tsqr": ("panel_tsqr_",),
                "sweep": ("panel_sweep_kernel", "panel_finalize_kernel")}


def device_profile(prof, wall_s: float) -> dict:
    """Device ms by kernel of a ``torch.profiler`` run (CUDA activity):
    the engine kernels' ms and share of the device's busy time, and the top
    other kernels."""
    by_name = kernel_ms(prof)
    busy = sum(ms for ms, _ in by_name.values())
    engine = {}
    for label, keys in ENGINE_KERNELS.items():
        hit = [v for k, v in by_name.items() if any(x in k for x in keys)]
        ms = sum(v[0] for v in hit)
        engine[label] = {"ms": ms, "launches": sum(v[1] for v in hit),
                         "share": ms / busy if busy else 0.0}
    panel = {}
    for route, keys in PANEL_ROUTES.items():
        hit = [v for k, v in by_name.items() if any(x in k for x in keys)]
        panel[route] = {"ms": sum(v[0] for v in hit),
                        "launches": sum(v[1] for v in hit)}
    # the TSQR route's host read: the device waits from the end of each
    # leaf pass to the start of its tree (the masks' copy to the host and
    # the finish's launch); the host waits for the leaf pass
    pairs, gap = gap_ms(prof, "panel_tsqr_leaf", "panel_tsqr_tree")
    leaf = [v for k, v in by_name.items() if "panel_tsqr_leaf" in k]
    read = {"panels": pairs, "gap_ms": gap,
            "leaf_ms": sum(v[0] for v in leaf)}
    engine_names = [k for k in by_name if any(
        x in k for keys in ENGINE_KERNELS.values() for x in keys)]
    rest = sorted(((k, v) for k, v in by_name.items()
                   if k not in engine_names), key=lambda kv: -kv[1][0])
    return {"wall_s": wall_s, "device_busy_ms": busy,
            "launches": sum(n for _, n in by_name.values()),
            "engine": engine, "panel_by_route": panel, "tsqr_read": read,
            "top_other": [[k[:70], n, ms] for k, (ms, n) in rest[:8]]}


def check_panel_routes(counts: dict, what: str) -> None:
    """Every panel call of a main path counted under one route, and no
    streamed panel on the sweep route (the main path's panels hold no zero
    column before a nonzero one)."""
    from repro_torch.kernels.householder import ops as hh
    for name in hh.KERNELS:
        routes = {r: counts.get(f"{name}_{r}", 0) for r in hh.ROUTES}
        check(sum(routes.values()) == counts.get(name, 0),
              f"{what}: {name} {counts.get(name, 0)} calls, routes {routes}")
        check(routes["sweep"] == 0,
              f"{what}: {routes['sweep']} streamed {name} calls took the "
              f"sweep route")


def engine_fullwidth(serve_mod, main_tt: dict) -> dict:
    """Full-width qwen1.5-0.5b with the TT-Edge policy on the batched plan,
    the main path's weights (same seed, same spectral decay)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import compression as comp
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.tt_linear import spectral_decay_pytree
    from repro_torch.models.registry import build
    model = build(get_config(ARCH), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = spectral_decay_pytree(model.init(0), alpha=1.0)
    torch.cuda.synchronize()
    decay_s = time.perf_counter() - t0
    policy = comp.CompressionPolicy(eps=EPS, min_size=8192,
                                    hbd_impl="blocked")
    plan = plan_mod.build_plan(params, policy)
    print(f"[chip_smoke] engine, full width, blocked policy:\n"
          f"{plan.describe()}")
    from torch.profiler import ProfilerActivity, profile
    reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        payload, report, secs, _ = compress_timed(params, policy)
    counts = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    dprof = device_profile(prof, secs)
    del prof
    p1 = dprof["engine"]["wy pass 1"]
    print(f"[chip_smoke] engine, full width, blocked compression under "
          f"torch.profiler: wall {secs:.3f}s, device busy "
          f"{dprof['device_busy_ms']:.1f} ms in {dprof['launches']} "
          f"launches; WY pass 1 {p1['ms']:.2f} ms ({p1['share']:.2%} of "
          f"the device's busy time, {p1['launches']} launches incl. the "
          f"fixed-order sum); engine kernels [ms, launches, share] "
          f"{json.dumps({k: [v['ms'], v['launches'], v['share']] for k, v in dprof['engine'].items()})}; "
          f"panel factor by route [ms, launches] "
          f"{json.dumps({k: [v['ms'], v['launches']] for k, v in dprof['panel_by_route'].items()})}; "
          f"TSQR host read {json.dumps(dprof['tsqr_read'])}; "
          f"top other kernels [name, launches, ms] "
          f"{json.dumps(dprof['top_other'])} (read in "
          f"{time.perf_counter() - t0:.1f}s)")
    ranks = {p: c.tt.ranks for p, c in tt_leaves(payload).items()}
    main_ranks = main_tt["info"]["ranks"]
    print(f"[chip_smoke] engine, full width: compressed in {secs:.3f}s "
          f"(blocked, under the profiler); main path "
          f"{main_tt['info']['compress_s']:.3f}s "
          f"(unblocked, incl. the spectral decay, which takes "
          f"{decay_s:.3f}s); payload ratio {report.ratio:.3f}")
    check(set(ranks) == set(main_ranks),
          f"engine: TT leaves {sorted(ranks)} differ from the main path's "
          f"{sorted(main_ranks)}")
    for path, r in ranks.items():
        ru = main_ranks.get(path, ())
        near = len(r) == len(ru) and all(abs(a - b) <= 1
                                         for a, b in zip(r, ru))
        check(near, f"engine: {path} blocked ranks {r} vs unblocked {ru}")
        print(f"[chip_smoke]   {path}: blocked ranks {r}, unblocked {ru}")
    eps_worst = eps_gate(params, payload, "engine, full width")
    oracle = f32_oracle(serve_mod, {"model": model, "payload": payload,
                                    "prompts": main_tt["prompts"]})
    for k in ("panel_factor", "panel_factor_tsqr", "wy_vta",
              "wy_vta_copy16", "wy_apply", "frob_truncate",
              "bitonic_sort_desc"):
        check(counts.get(k, 0) > 0,
              f"engine, full width: kernel {k} never launched")
    check_panel_routes(counts, "engine, full width")
    check_no_plain(counts, "engine, full width")
    print(f"[chip_smoke] engine, full width: launches {counts}")

    wq = dict(tree.leaves_with_paths(params))["layers.attn.wq"]
    times = {}
    for impl in ("unblocked", "blocked"):
        pol = dataclasses.replace(policy, hbd_impl=impl)
        _, _, _, br = compress_timed(params, pol, timers=True)
        times[impl] = br
        print(f"[chip_smoke] engine, full width, {impl}: where the time "
              f"goes {json.dumps(br)}")
    return {"secs": secs, "decay_s": decay_s, "ranks": ranks,
            "counts": counts, "eps_worst": eps_worst, "f32_oracle": oracle,
            "plan": plan.describe(), "breakdown": times, "profile": dprof,
            "tts": {p: c.tt for p, c in tt_leaves(payload).items()},
            "wq": wq}


def engine_resnet() -> dict:
    """ResNet-32 with the TT-Edge policy on the batched plan."""
    from repro_torch.configs.resnet32 import resnet32_params
    from repro_torch.core import compression as comp
    from repro_torch.core import plan as plan_mod
    params = {k: torch.from_numpy(v).to(DEVICE)
              for k, v in resnet32_params(seed=0, alpha=1.0).items()}
    policy = comp.CompressionPolicy(eps=EPS, hbd_impl="blocked")
    plan = plan_mod.build_plan(params, policy)
    print(f"[chip_smoke] engine, ResNet-32, blocked policy:\n"
          f"{plan.describe()}")
    reset_counts()
    payload, report, secs, _ = compress_timed(params, policy)
    counts = read_counts()
    reset_counts()
    ex = report.exec_stats
    print(f"[chip_smoke] engine, ResNet-32: compressed in {secs:.3f}s, "
          f"{ex.bucket_launches} bucket passes, {ex.serial_params} serial "
          f"params, ratio {report.ratio:.3f}; launches {counts}")
    check(ex.bucket_launches == 4 and ex.serial_params == 0,
          f"ResNet-32: {ex.bucket_launches} bucket passes and "
          f"{ex.serial_params} serial params (want 4 and 0)")
    eps_gate(params, payload, "engine, ResNet-32")
    serial, s_report, s_secs, _ = compress_timed(params, policy, "serial")
    tts, s_tts = tt_leaves(payload), tt_leaves(serial)
    check(set(tts) == set(s_tts), "ResNet-32: batched and serial TT leaves "
                                  "differ")
    for path, c in tts.items():
        sr = s_tts[path].tt.ranks if path in s_tts else None
        check(c.tt.ranks == sr and c.payload_params
              == s_tts[path].payload_params,
              f"ResNet-32: {path} batched ranks {c.tt.ranks} vs serial {sr}")
    check(report.payload_params == s_report.payload_params,
          f"ResNet-32: payload {report.payload_params} vs serial "
          f"{s_report.payload_params}")
    ranks = sorted({c.tt.ranks for c in tts.values()})
    print(f"[chip_smoke] engine, ResNet-32: ranks {ranks} equal the serial "
          f"plan's ({s_secs:.3f}s); payload {report.payload_params}")
    for k in ("panel_factor_batched", "panel_factor_batched_tsqr",
              "wy_vta_batched", "wy_apply_batched", "frob_truncate_batched",
              "bitonic_sort_desc_batched"):
        check(counts.get(k, 0) > 0, f"ResNet-32: kernel {k} never launched")
    check_panel_routes(counts, "ResNet-32")
    check_no_plain(counts, "ResNet-32")
    return {"secs": secs, "counts": counts, "ranks": ranks,
            "payload_params": report.payload_params, "ratio": report.ratio,
            "plan": plan}


def tall(m: int, n: int):
    return (m, n) if m >= n else (n, m)


def engine_shapes(full_tts: dict, resnet_plan) -> dict:
    """{kind: {shape: calls in one compression}} of every engine kernel:
    the unfoldings each TT-SVD step factored (the serial path at the live
    ranks, the batched buckets at the padded max ranks), the first panel
    and the widest WY updates of each blocked QR, and σ's length."""
    from repro_torch.core.tt import tt_max_ranks
    shapes = {k: {} for k in ("panel", "wy_vta", "wy_apply", "sort",
                              "truncate", "panel_batched", "wy_vta_batched",
                              "wy_apply_batched", "sort_batched",
                              "truncate_batched")}

    def add(kind, shape, calls=1):
        shapes[kind][shape] = shapes[kind].get(shape, 0) + calls

    def qr(m, n, lead, sfx):
        np_ = -(-n // PANEL) * PANEL
        add("panel" + sfx, (*lead, m, PANEL))
        for wn in ([np_ - PANEL] if np_ > PANEL else []) + [np_]:
            add("wy_vta" + sfx, (*lead, m, wn, PANEL))
            add("wy_apply" + sfx, (*lead, m, wn, PANEL))
        add("sort" + sfx, (*lead, n))
        add("truncate" + sfx, (*lead, n))

    for tt in full_tts.values():
        r, dims = tt.ranks, tt.shape
        for k in range(len(dims) - 1):
            qr(*tall(r[k] * dims[k], math.prod(dims[k + 1:])), (), "")
    for b in resnet_plan.buckets:
        rmax = tt_max_ranks(b.dims, 1 << 30)
        for k in range(len(b.dims) - 1):
            m, n = tall(rmax[k] * b.dims[k], math.prod(b.dims[k + 1:]))
            qr(m, n, (b.batch,), "_batched")
    return shapes


def vta_checks(kind: str, shape, aligned: bool, gen) -> None:
    """WY pass 1 on integer inputs in {-1, 0, 1} (every partial sum an exact
    integer): equal bit for bit to the float64 product rounded to float32,
    on the copy route the view's alignment picks; and twice on the same
    random inputs: equal."""
    from repro_torch.kernels import engine_cases as ec
    from repro_torch.kernels.block_update import ops as wy
    fn = wy.wy_vta if kind == "wy_vta" else wy.wy_vta_batched
    route = ec.vta_route(kind, shape, aligned)
    v, a = ec.wy_inputs(shape, gen, DEVICE, aligned, ints=True)
    before = wy.launches[route]
    exact = bool(torch.equal(fn(v, a), ec.vta_exact(v, a)))
    routed = wy.launches[route] == before + 1
    v, a = ec.wy_inputs(shape, gen, DEVICE, aligned)
    same = bool(torch.equal(fn(v, a), fn(v, a)))
    del v, a
    check(exact and routed and same,
          f"{kind} {shape} {'aligned' if aligned else 'misaligned'}: "
          f"integer inputs exact {exact}, route {route} {routed}, repeat "
          f"calls equal {same}")


def vta_layout() -> dict:
    """Pass 1's ptxas usage, and its layout as CUDA reports it against the
    constants ``chunk_plan`` sizes the grid with; copies in flight per SM."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.block_update import ops as wy
    usage = {}
    for fn, use in kbuild.ptxas_usage(wy.SOURCE).items():
        m = re.search(r"vta_partial_kernelILi(\d+)ELi(\d+)E", fn)
        if m:
            usage[f"TN{m.group(1)}_copy{4 * int(m.group(2))}"] = list(use)
    lay = {}
    for n in (32, 64):
        for wide in (True, False):
            got = wy.layout(n, wide)
            tn = got["tile"]
            stage_bytes = 4 * got["stage_rows"] * (wy.MAX_B + tn)
            got["in_flight_bytes_per_sm"] = (got["blocks_per_sm"]
                                             * (got["stages"] - 1)
                                             * stage_bytes)
            lay[f"TN{tn}_copy{16 if wide else 4}"] = got
            check(tn == wy.tile_cols(n)
                  and got["stage_rows"] == wy.STAGE_ROWS
                  and got["blocks_per_sm"] == wy.BLOCKS_PER_SM[tn],
                  f"wy pass 1 layout {got} differs from ops.py's")
    print(f"[kernel] wy pass 1 ptxas [registers, spill store B, spill load B]"
          f": {json.dumps(usage)}; layout {json.dumps(lay)}")
    check(len(usage) == 4, f"ptxas report of vta_partial_kernel: {usage}")
    return {"ptxas": usage, "layout": lay}


def panel_route_check(case, fill: str, got, before: dict):
    """A panel case launched once, counted under the route its fill and
    height pick (``engine_cases.panel_route``; the comparison's plain call
    counts apart); trailing zero columns exactly zero in V, τ and R; a
    second call bit-identical."""
    from repro_torch.kernels import engine_cases as ec
    from repro_torch.kernels.householder import ops as hh
    counter = ec.COUNTERS[case.kind][1]
    route = ec.panel_route(case.shape, fill, hh.smem_rows(case.shape[-1]))
    moved = {k: n - before.get(k, 0) for k, n in hh.launches.items()
             if n != before.get(k, 0) and k != "plain_on_cuda"}
    check(moved == {counter: 1, f"{counter}_{route}": 1},
          f"{case.kind} {case.shape} {fill}: launches {moved}, want route "
          f"{route}")
    if fill == "padded":
        z = ec.padded_zeros(case.shape[-1])
        v, tau, r = got
        check(not (v[..., -z:].any() or tau[..., -z:].any()
                   or r[..., -z:, :].any() or r[..., :, -z:].any()),
              f"{case.kind} {case.shape}: trailing zero columns not zero in "
              f"V, tau, R")
    again = case.kernel()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"{case.kind} {case.shape} {fill}: repeat calls differ")


def engine_kernel_phase(shapes: dict) -> dict:
    """Every engine kernel against its plain version at the main paths'
    shapes and the ragged ones; WY pass 1's exactness, determinism, copy
    routes and layout; times at the main paths' shapes.  Returns per kind
    the record at its largest main-path shape (pass 1 also every main-path
    shape's times)."""
    from repro_torch.kernels import engine_cases as ec
    from repro_torch.kernels.block_update import ops as wy
    from repro_torch.kernels.householder import ops as hh
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    limit = hh.smem_rows(PANEL)
    extra = {k: list(v) for k, v in ec.RAGGED_SHAPES.items()}
    extra["panel"] += [(limit, PANEL), (limit + 1, PANEL)]
    print(f"[chip_smoke] engine kernel shapes (calls per compression): "
          f"{json.dumps({k: {str(s): n for s, n in v.items()} for k, v in shapes.items()})}")
    rec = {}
    wy.reset_launches()
    for kind in ec.KINDS:
        main = shapes.get(kind, {})
        for shape in list(main) + extra[kind]:
            aligned = shape in main      # the ragged views are misaligned
            if kind.startswith("wy_vta"):
                for al in (True,) if aligned else (False, True):
                    vta_checks(kind, shape, al, gen)
            # panels: the main path's are dense (timed) or padded; the
            # ragged ones take every fill
            fills = ((("dense", "padded") if aligned else ec.PANEL_FILLS)
                     if kind.startswith("panel") else ("dense",))
            for fill in fills:
                case = ec.engine_case(kind, shape, gen, DEVICE, aligned, fill)
                before = dict(hh.launches)
                got, ref = case.kernel(), case.plain()
                torch.cuda.synchronize()
                ok, err, parts = ec.compare(case, got, ref, TOL)
                check(ok, f"{kind} {shape} {fill} disagrees with its plain "
                          f"version {parts}")
                if kind.startswith("panel"):
                    panel_route_check(case, fill, got, before)
                line = (f"[kernel] {kind} {shape}"
                        f"{f' {fill}' if kind.startswith('panel') else ''}: "
                        f"{parts} {'ok' if ok else 'FAIL'}")
                r = rec.setdefault(kind, {"max_abs_err": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], err)
                del got, ref
                if shape not in main or fill != "dense":
                    print(line)
                    continue
                reps = 10
                ms = time_ms(case.kernel, reps)
                p_ms = time_ms(case.plain, reps)
                l_ms = time_ms(case.library, reps) if case.library else None
                bound = max(case.nbytes / HBM_BYTES_PER_S,
                            case.ops / F32_FLOPS) * 1e3
                print(f"{line}; kernel {ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"library {'-' if l_ms is None else f'{l_ms:.4f}'} ms, "
                      f"bound {bound:.5f} ms, calls {main[shape]}")
                if kind.startswith("wy_vta"):
                    r.setdefault("by_shape", {})[str(shape)] = {
                        "ms": ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": bound, "calls": main[shape]}
                if kind.startswith("truncate"):   # one kernel a call
                    nodes = graph_nodes(case.kernel)
                    g_ms = graph_ms(case.kernel)
                    check(nodes == [0], f"{kind} {shape}: one call is "
                                        f"graph nodes {nodes}, not one "
                                        f"kernel")
                    print(f"[kernel] {kind} {shape}: graph {g_ms:.4f} ms "
                          f"a call, graph nodes {nodes}")
                    if case.nbytes >= r.get("bytes", -1):
                        r["graph_ms"] = g_ms
                if case.nbytes >= r.get("bytes", -1):
                    r.update(shape=list(shape), ms=ms, plain_ms=p_ms,
                             library_ms=l_ms, bound_ms=bound,
                             bytes=case.nbytes, ops=case.ops)
    routes = {k: n for k, n in hh.launches.items()
              if k.endswith(tuple(f"_{r}" for r in hh.ROUTES))}
    print(f"[kernel] panel routes in this phase: {json.dumps(routes)}")
    routes = {k: n for k, n in wy.launches.items() if "_copy" in k}
    print(f"[kernel] wy pass 1 copy routes in this phase: {routes}")
    for k in ("wy_vta_copy16", "wy_vta_copy4", "wy_vta_batched_copy16",
              "wy_vta_batched_copy4"):
        check(routes.get(k, 0) > 0, f"wy pass 1 route {k} never launched")
    rec["wy_vta"].update(vta_layout())
    return rec


def blocked_svd_check(wq: torch.Tensor) -> float:
    """The composed blocked SVD of wq's (24·1024) x (16·64) unfolding (the
    second TT-SVD step's shape; the first step is exact at full rank 24, so
    this reshape has the same singular values) against torch.linalg.svd in
    float64; the SVD's phase 2 runs in float64 (``core/svd.diagonalize``).
    float32 ``torch.linalg.svd`` on the card is printed beside it: it is
    itself ~1e-4·σ_max off float64 at this shape, too coarse to be the
    oracle."""
    from repro_torch.core.svd import svd
    a = wq.float().reshape(wq.shape[0] * wq.shape[1], -1)
    ref = torch.linalg.svdvals(a.double())
    smax = float(ref.max())
    d = float((svd(a, hbd_impl="blocked").s.double() - ref).abs().max()) / smax
    d_lib = float((torch.linalg.svdvals(a).double() - ref).abs().max()) / smax
    check(d <= 1e-4, f"blocked SVD of {tuple(a.shape)}: max|dsigma|/sigma_max "
                     f"{d:.3e} > 1e-4")
    print(f"[chip_smoke] blocked SVD of {tuple(a.shape)} (phase 2 in float64) "
          f"vs torch.linalg.svd in float64: max|dsigma|/sigma_max {d:.3e} "
          f"(torch.linalg.svd in float32: {d_lib:.3e})")
    return d


# ---------------------------------------------------------------------------
# Hybrid phase: full-width recurrentgemma-2b, prefill through the flash kernel
# ---------------------------------------------------------------------------

HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_SERVE_ARGS = ["--arch", HYBRID_ARCH, "--batch", "4", "--prompt-len",
                     "16", "--gen", "16", "--seed", "0", "--tt-eps", "0.2"]
PREFILL_B, PREFILL_S = 2, 4096
RING_S = 17 * 128    # past the 2,048 window: the decode ring buffer wraps
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (700 W)
TILED_DRAWS = 5      # extra draws (seeds 0-4) of the bf16 check vs mha_tiled
ATTN_LAYERS = 8      # attention layers of recurrentgemma-2b: flash launches


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _counted(fn):
    """(fn(), seconds, launch counts) with the counters zeroed just before
    the call and read just after."""
    reset_counts()
    out, secs = _timed(fn)
    counts = read_counts()
    reset_counts()
    return out, secs, counts


def _gap(got, ref):
    """(max|got - ref|, max|ref|)."""
    return (float((got.float() - ref.float()).abs().max()),
            float(ref.float().abs().max()))


def hybrid_serve(serve_mod) -> dict:
    """The main path: ``serve --weights tt`` at full width and depth; the
    compression runs once and its params and payload serve the prefill
    checks below."""
    args = serve_mod.parse_args(HYBRID_SERVE_ARGS + ["--weights", "tt"])
    out, wall, counts = _counted(lambda: serve_mod.serve(args))
    info, ver, gen = out["info"], out["verify"], out["generated"]
    vocab = out["model"].cfg.vocab_size
    check(gen.shape == (4, 16) and gen.min() >= 0 and gen.max() < vocab,
          f"hybrid: generated tokens {gen.shape} out of range")
    check(bool(torch.isfinite(out["run"]["prompt_logits"]).all()),
          "hybrid: non-finite logits")
    check(counts.get("plain_chains", 0) == 0,
          f"hybrid: {counts.get('plain_chains')} chains took the plain path")
    for k in ("tt_contract_2", "tt_contract_3", "bitonic_sort_desc",
              "frob_truncate"):
        check(counts.get(k, 0) > 0,
              f"hybrid serve: kernel {k} never launched")
    check_no_plain(counts, "hybrid serve")
    print(f"[chip_smoke] hybrid serve (tt): compressed in "
          f"{info['compress_s']:.3f}s (incl. the spectral decay), payload "
          f"ratio {info['payload_ratio']:.3f}, plan "
          f"{info['exec_stats'].bucket_launches} bucket passes, "
          f"{info['exec_stats'].serial_params} serial params; decode "
          f"{out['tok_per_s']:.2f} tok/s; wall {wall:.1f}s; launches {counts}")
    print(f"[chip_smoke] hybrid ranks: " + json.dumps(
        {k: list(v) for k, v in info["ranks"].items()}))
    print(f"[chip_smoke] hybrid resident weight bytes: dense "
          f"{info['dense_bytes']:,} -> tt-native {info['tt_bytes']:,}")
    print(f"[chip_smoke] hybrid reference-oracle gate (reported): "
          f"max|d|/scale {ver['max_diff'] / ver['scale']:.4f} (bound 0.05)")
    eps_worst = eps_gate(out["dense_params"], out["payload"],
                         "hybrid, full width")
    return {"out": out, "counts": counts, "wall_s": wall,
            "eps_worst": eps_worst,
            "summary": {"compress_s": info["compress_s"],
                        "payload_ratio": info["payload_ratio"],
                        "tok_per_s": out["tok_per_s"],
                        "dense_bytes": info["dense_bytes"],
                        "tt_bytes": info["tt_bytes"],
                        "verify": ver, "launches": counts,
                        "eps_worst": eps_worst}}


def _check_prefill_counts(counts, what, tt: bool, route: str) -> None:
    """One flash launch per attention layer, all on ``route``."""
    check(counts.get("flash_attention", 0) == ATTN_LAYERS
          and counts.get(route, 0) == ATTN_LAYERS,
          f"{what}: {counts.get('flash_attention', 0)} flash launches, "
          f"{counts.get(route, 0)} of them on {route}; want {ATTN_LAYERS} "
          f"(one per attention layer)")
    if tt:
        check(counts.get("tt_contract_2", 0) > 0
              and counts.get("tt_contract_3", 0) > 0
              and counts.get("plain_chains", 0) == 0,
              f"{what}: chain kernels not all launched: {counts}")
    check_no_plain(counts, what)


def hybrid_prefill(served: dict) -> dict:
    """Prefill and eval of full-width recurrentgemma-2b through the entry
    points (``make_prefill_step`` / ``make_eval_step``): tokens/s in bf16
    with dense and TT-native weights, then the float32 gates G1-G3."""
    from repro_torch import tree
    from repro_torch.core import compression as comp
    from repro_torch.train.steps import make_eval_step, make_prefill_step
    out = served["out"]
    model = out["model"]
    vocab = model.cfg.vocab_size
    g = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, vocab, (PREFILL_B, PREFILL_S), generator=g,
                           device=DEVICE)
    batch = {"tokens": tokens}
    res = {"tok_per_s": {}, "counts": {}}

    # bf16, as served: throughput; the differences are printed, not gated
    rx = comp.TTCompressor().decompress(out["payload"])
    weights = {"dense": out["dense_params"], "tt": out["params"],
               "reconstruct": rx}
    logits = {}
    for name, impl in (("dense", "pallas"), ("dense", "xla"),
                       ("tt", "pallas"), ("tt", "xla"),
                       ("reconstruct", "xla")):
        step = make_prefill_step(model, impl=impl)
        step(weights[name], batch)                     # warm-up
        lg, secs, counts = _counted(lambda: step(weights[name], batch))
        logits[(name, impl)] = lg
        check(lg.shape == (PREFILL_B, vocab)
              and bool(torch.isfinite(lg).all()),
              f"hybrid prefill {name}/{impl}: logits {tuple(lg.shape)} "
              f"not finite")
        if impl == "pallas":
            _check_prefill_counts(counts, f"hybrid prefill {name} bf16",
                                  tt=name == "tt",
                                  route="flash_attention_mma")
        if name != "reconstruct":
            tps = PREFILL_B * PREFILL_S / secs
            res["tok_per_s"][f"{name}/{impl}"] = tps
            res["counts"][f"{name}/{impl}"] = counts
            print(f"[chip_smoke] hybrid prefill bf16 {name} impl={impl}: "
                  f"B={PREFILL_B} S={PREFILL_S} in {secs:.3f}s = {tps:.0f} "
                  f"tok/s; launches {counts}")
    for key, (a, b) in {"G1_bf16": (("dense", "pallas"), ("dense", "xla")),
                        "G2_bf16": (("tt", "pallas"),
                                    ("reconstruct", "xla"))}.items():
        d, scale = _gap(logits[a], logits[b])
        res[key] = d / scale
        print(f"[chip_smoke] hybrid {key} (reported): {a} vs {b} "
              f"max|d|/scale {d / scale:.3e}")
    del rx, weights, logits

    # float32 activations and weights: the gates
    m32 = _f32_model(model, DEVICE)
    dense32 = tree.map_leaves(lambda x: x.float(), out["dense_params"])
    lg = {}
    for impl in ("pallas", "xla"):
        lg[impl], _, counts = _counted(
            lambda: make_prefill_step(m32, impl=impl)(dense32, batch))
        if impl == "pallas":
            _check_prefill_counts(counts, "hybrid prefill dense f32", False,
                                  route="flash_attention_f32")
            res["counts"]["dense_f32/pallas"] = counts
    d, scale = _gap(lg["pallas"], lg["xla"])
    res["G1"] = d / scale
    check(d <= F32_TOL * scale, f"G1: flash vs plain prefill max|d| {d:.3e} "
                                f"over {F32_TOL} * scale {scale:.3e}")
    print(f"[chip_smoke] hybrid G1 f32: prefill impl=pallas vs xla, dense "
          f"weights: max|d|/scale {d / scale:.3e}")
    batch1 = {"tokens": tokens[:1], "labels": torch.roll(tokens[:1], -1, 1)}
    loss = {}
    for impl in ("pallas", "xla"):
        metrics, secs, counts = _counted(
            lambda: make_eval_step(m32, impl=impl)(dense32, batch1))
        if impl == "pallas":
            _check_prefill_counts(counts, "hybrid eval dense f32", False,
                                  route="flash_attention_f32")
        loss[impl] = float(metrics["loss"])
        print(f"[chip_smoke] hybrid eval f32 impl={impl}: B=1 S={PREFILL_S} "
              f"loss {loss[impl]:.6f} in {secs:.3f}s")
    rel = abs(loss["pallas"] - loss["xla"]) / abs(loss["xla"])
    res["eval_loss"], res["eval_rel"] = loss, rel
    check(math.isfinite(loss["xla"]) and rel <= 1e-5,
          f"G1 eval: losses {loss} differ by {rel:.3e} relative")

    ring = tokens[:1, :RING_S]
    last, _, counts = _counted(lambda: make_prefill_step(m32, impl="pallas")(
        dense32, {"tokens": ring}))
    _check_prefill_counts(counts, "hybrid G3 prefill f32", False,
                          route="flash_attention_f32")
    cache = m32.init_cache(1, RING_S)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for t in range(RING_S):
            stepped, cache = m32.decode_step(dense32, cache, ring[:, t:t + 1])
    torch.cuda.synchronize()
    d, scale = _gap(last, stepped)
    res["G3"] = d / scale
    check(d <= F32_TOL * scale, f"G3: prefill vs decode-stepped logits at "
                                f"position {RING_S - 1}: max|d| {d:.3e} over "
                                f"{F32_TOL} * scale {scale:.3e}")
    print(f"[chip_smoke] hybrid G3 f32: prefill (flash, window 2048) vs "
          f"{RING_S} decode steps through the ring cache "
          f"({time.perf_counter() - t0:.1f}s): last-position max|d|/scale "
          f"{d / scale:.3e}")
    del dense32, cache

    tt32, rx32 = f32_params(out["payload"], model.cfg.family)
    got, _, counts = _counted(
        lambda: make_prefill_step(m32, impl="pallas")(tt32, batch))
    _check_prefill_counts(counts, "hybrid prefill TT f32", tt=True,
                          route="flash_attention_f32")
    ref = make_prefill_step(m32, impl="xla")(rx32, batch)
    d, scale = _gap(got, ref)
    res["G2"] = d / scale
    check(d <= F32_TOL * scale, f"G2: TT-native vs reconstruct prefill "
                                f"max|d| {d:.3e} over {F32_TOL} * scale "
                                f"{scale:.3e}")
    print(f"[chip_smoke] hybrid G2 f32: TT-native prefill (flash + chain "
          f"kernels) vs reconstruct-then-prefill (plain): max|d|/scale "
          f"{d / scale:.3e}")
    return res


def flash_phase() -> dict:
    """The flash kernel against its plain version at every shape of
    ``kernels/flash_attention/cases.py`` (float32 also against ``mha_ref``
    in float64, within ``cases.F64_REL`` of max|ref|); times of each route
    at the hybrid path's shape (event median and graph replays): bf16 on
    the mma route, float32 on the 3xTF32 route."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import cases as fc
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fref
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rec = {dtype: {"max_abs_err": 0.0} for dtype in fc.DTYPES}
    rec[torch.bfloat16]["tiled_gap"] = -math.inf
    rec[torch.float32]["f64_gap"] = 0.0
    for shape in fc.SHAPES:
        for dtype in fc.DTYPES:
            case = fc.flash_case(shape, dtype, gen, DEVICE)
            got, ref = case.kernel(), case.plain()
            torch.cuda.synchronize()
            err, scale = _gap(got, ref)
            limit = TOL * scale if dtype == torch.float32 else 2e-2
            ok = err <= limit and got.dtype == dtype
            check(ok, f"flash_attention {shape} {dtype}: max|d| {err:.3e} "
                      f"over {limit:.3e}")
            r = rec[dtype]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            line = (f"[kernel] {fa.ROUTES[dtype][0]} {str(dtype)[6:]} "
                    f"(B, S, Hq, Hkv, D, causal, window)={shape}: max|d| "
                    f"{err:.3e} (ref max {scale:.3e})")
            if dtype == torch.float32:
                ref64 = fa.mha_ref(*(t.double() for t in case.inputs),
                                   causal=shape[5], window=shape[6])
                gap = fc.f64_gap(got, ref64)
                del ref64
                f_ok = gap <= fc.F64_REL
                check(f_ok, f"flash_attention {shape} float32 vs float64: "
                            f"max|d|/max|ref| {gap:.3e} over "
                            f"{fc.F64_REL:.3e}")
                r["f64_gap"] = max(r["f64_gap"], gap)
                ok = ok and f_ok
                line += (f", vs float64 max|d|/max|ref| {gap:.3e} (limit "
                         f"{fc.F64_REL:.3e})")
            if dtype == torch.bfloat16:   # this draw and TILED_DRAWS more
                draws = [case] + [fc.flash_case(
                    shape, dtype, torch.Generator(device=DEVICE).manual_seed(
                        seed), DEVICE) for seed in range(TILED_DRAWS)]
                gap = max(fc.tiled_gap(c.kernel(), fa.mha_tiled(
                    *c.inputs, causal=shape[5], window=shape[6]))
                    for c in draws)
                t_ok = gap <= fc.TILED_ABS
                check(t_ok, f"flash_attention {shape} bf16 vs mha_tiled: "
                            f"per-element gap {gap:.3e} over "
                            f"{fc.TILED_ABS:.1e}")
                r["tiled_gap"] = max(r["tiled_gap"], gap)
                ok = ok and t_ok
                line += (f", vs mha_tiled max(|d| - 2^-8|tiled|) over "
                         f"{len(draws)} draws {gap:.3e} (limit "
                         f"{fc.TILED_ABS:.1e})")
            line += " ok" if ok else " FAIL"
            if shape != fc.PATH_SHAPE:
                print(line)
                continue
            fast = dtype == torch.bfloat16
            ms = time_ms(case.kernel, 20 if fast else 5)
            g_ms = graph_ms(case.kernel, 10 if fast else 5, 5)
            p_ms = time_ms(case.plain, 3)
            l_ms = time_ms(case.library, 20 if fast else 5)
            # the route as built: float32 takes three TF32 products per
            # float32 product; its FFMA bound is printed beside it
            flops, rate = ((case.flops, BF16_FLOPS) if fast
                           else (3 * case.flops, TF32_FLOPS))
            by_ops = flops / rate >= case.nbytes / HBM_BYTES_PER_S
            bound = max(case.nbytes / HBM_BYTES_PER_S, flops / rate) * 1e3
            r.update(ms=ms, graph_ms=g_ms, plain_ms=p_ms, library_ms=l_ms,
                     bound_ms=bound,
                     bound_by="operations" if by_ops else "bytes")
            extra = ""
            if not fast:
                r["bound_ffma_ms"] = max(case.nbytes / HBM_BYTES_PER_S,
                                         case.flops / F32_FLOPS) * 1e3
                extra = (f"; FFMA bound {r['bound_ffma_ms']:.5f} ms "
                         f"({r['bound_ffma_ms'] / ms:.1%})")
            print(f"{line}; kernel {ms:.4f} ms (graph {g_ms:.4f} ms), "
                  f"plain {p_ms:.4f} ms, sdpa "
                  f"{l_ms:.4f} ms, bound {bound:.5f} ms ({flops:.4e} "
                  f"FLOPs at {rate / 1e12:.0f} TFLOP/s, "
                  f"{case.nbytes:,} bytes; {bound / ms:.1%} of the bound)"
                  f"{extra}")
    usage = kbuild.ptxas_usage(fa.SOURCE)
    for dtype, kernel in ((torch.bfloat16, "flash_mma_kernel"),
                          (torch.float32, "flash_tf32x3_kernel")):
        rec[dtype]["ptxas"] = {}
        for fn, (regs, st, ld) in usage.items():
            d = re.search(rf"{kernel}ILi(\d+)E", fn)
            if d:
                rec[dtype]["ptxas"][f"D{d.group(1)}"] = [regs, st, ld]
        print(f"[kernel] ptxas {fa.ROUTES[dtype][0]} ({kernel}) "
              f"[registers, spill store B, spill load B] per head dim: "
              f"{json.dumps(rec[dtype]['ptxas'])}")
        check(len(rec[dtype]["ptxas"]) == len(fa.HEAD_DIMS),
              f"ptxas report of {kernel}: {rec[dtype]['ptxas']}")
    print(f"[kernel] flash_attention_mma dynamic shared memory at D = 256: "
          f"{(fref.BLOCK_ROWS + 4 * fref.BLOCK_KEYS) * 256 * 2:,} B "
          f"(Q tile and two K/V stages, bf16)")
    raised = False
    bad = torch.zeros((1, 200, 2, 64), device=DEVICE)
    try:
        fa.mha_flash(bad, bad[:, :, :1], bad[:, :, :1])
    except ValueError:
        raised = True
    check(raised, "flash_attention: S = 200 (not a multiple of 128) did not "
                  "raise")
    return rec


# ---------------------------------------------------------------------------
# MoE phase: full-width olmoe-1b-7b, expert banks on the batched chain kernel
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
MOE_SERVE_ARGS = ["--arch", MOE_ARCH, "--batch", "4", "--prompt-len", "16",
                  "--gen", "16", "--seed", "0", "--tt-eps", "0.2"]
MOE_BANKS = ("layers.moe.w_gate", "layers.moe.w_up", "layers.moe.w_down")
# the tt_contract_batched dispatch the batched routes replace
BATCHED_TPU = "src/repro/kernels/tt_contract/ops.py:205"


class _Recorder:
    """Wrap ``module.name`` for a block: every call's result of ``keep``
    (called with the call's arguments and result) goes to ``self.calls``."""

    def __init__(self, module, name, keep):
        self.module, self.name, self.keep, self.calls = module, name, keep, []

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            self.calls.append(self.keep(a, out))
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def moe_serve(serve_mod) -> dict:
    """a-b: ``serve --arch olmoe-1b-7b`` at full width and depth, ``--weights
    tt``, then ``tt-int8`` on the same compression; every expert bank call
    must be one batched chain launch."""
    res, compressed = {}, None
    for weights in ("tt", "tt-int8"):
        args = serve_mod.parse_args(MOE_SERVE_ARGS + ["--weights", weights])
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with PhaseTimers() as timers:      # compresses in the tt run only
            out, wall, counts = _counted(
                lambda: serve_mod.serve(args, compressed=compressed))
        peak = torch.cuda.max_memory_allocated()
        info, ver, gen = out["info"], out["verify"], out["generated"]
        cfg = out["model"].cfg
        compressed = info["compressed"]
        check(gen.shape == (4, 16) and gen.min() >= 0
              and gen.max() < cfg.vocab_size,
              f"moe {weights}: generated tokens {gen.shape} out of range")
        check(bool(torch.isfinite(out["run"]["prompt_logits"]).all()),
              f"moe {weights}: non-finite logits")
        check(counts.get("plain_chains", 0) == 0,
              f"moe {weights}: {counts.get('plain_chains')} chains took the "
              f"plain path")
        quant = weights != "tt"
        # TT decode steps: fused prefill + decode (16 + 15), plus the int8
        # verify's teacher-forced pass over the prompt (15)
        steps = 31 + (15 if quant else 0)
        key = "tt_contract_2q_batched" if quant else "tt_contract_2_batched"
        want = len(MOE_BANKS) * cfg.num_layers * steps
        check(counts.get(key, 0) == want,
              f"moe {weights}: {counts.get(key, 0)} {key} launches, want "
              f"{want} (3 banks x {cfg.num_layers} layers x {steps} steps)")
        # the banks' absorption on the tensor cores, every call
        check(counts.get(f"{key}_mma", 0) == want,
              f"moe {weights}: {counts.get(f'{key}_mma', 0)} bank calls on "
              f"the tensor-core route, want {want}")
        attn = "tt_contract_3q" if quant else "tt_contract_3"
        check(counts.get(attn, 0) > 0,
              f"moe {weights}: attention chains never launched {attn}")
        if not quant:
            for k in ("bitonic_sort_desc", "frob_truncate"):
                check(counts.get(k, 0) > 0,
                      f"moe compression: kernel {k} never launched")
        check_no_plain(counts, f"moe {weights}")
        banks = {p: list(info["ranks"][p]) for p in MOE_BANKS}
        print(f"[chip_smoke] moe {weights}: compression "
              f"{info['compress_s']:.3f}s (incl. the spectral decay"
              f"{', reused from the tt run' if quant else ''}), peak device "
              f"memory {peak:,} B ({base:,} B allocated before the run); "
              f"decode {out['tok_per_s']:.2f} tok/s; wall "
              f"{wall:.1f}s; bank ranks {json.dumps(banks)}; launches "
              f"{counts}")
        print(f"[chip_smoke] moe {weights} bytes: {info['line']}")
        print(f"[chip_smoke] moe {weights} reference-oracle gate (reported): "
              f"max|d|/scale {ver['max_diff'] / ver['scale']:.4f} (bound "
              f"0.05)" + (f", tie-tolerant agreement {ver['tie_agree']:.4f}"
                          f" (gate 0.99)" if quant else ""))
        if not quant:
            res["compression"] = timers.breakdown(info["compress_s"])
            print(f"[chip_smoke] moe compression, where the time goes: "
                  f"{json.dumps(res['compression'])}")
            res["decode_profile"] = decode_profile(out, "moe tt")
        res[weights] = {
            "counts": counts, "steps": steps, "wall_s": wall,
            "peak_bytes": peak, "base_bytes": base,
            "tok_per_s": out["tok_per_s"],
            "compress_s": info["compress_s"], "bank_ranks": banks,
            "ranks": {k: list(v) for k, v in info["ranks"].items()},
            "dense_bytes": info["dense_bytes"], "tt_bytes": info["tt_bytes"],
            "ttq_bytes": info.get("ttq_bytes"),
            "call_bytes": info["call_bytes"], "verify": ver}
        res["info"] = {"chains": info["chains"]}
        res["out"] = out
    return res


def decode_profile(out, what: str, steps: int = 3) -> dict:
    """Host wall and device busy time of ``steps`` fused greedy decode
    steps of the served TT params after the prompt (``torch.profiler``),
    with the kernels that take the most device time and the number of
    device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import common
    model = out["model"]
    b, s = out["prompts"].shape
    toks = torch.zeros((b, 2 * s), dtype=torch.int64, device=DEVICE)
    toks[:, :s] = torch.as_tensor(out["prompts"], device=DEVICE)
    state = common.gen_init(model.init_cache(b, 2 * s), toks, s, 2 * s,
                            model.cfg.vocab_size)
    with torch.inference_mode():
        for _ in range(s):                       # through the prompt
            state = common.gen_step(model.decode_step, out["params"], state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()    # the profiler's start-up excluded
            for _ in range(steps):
                state = common.gen_step(model.decode_step, out["params"],
                                        state)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    res = {"steps": steps, "wall_ms": wall * 1e3, "device_busy_ms": busy,
           "kernel_calls": sum(e.count for e in kern),
           "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                   for e in top]}
    print(f"[chip_smoke] {what} decode profile: {steps} fused steps, host "
          f"wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms in "
          f"{res['kernel_calls']} kernels; top kernels [name, calls, ms] "
          f"{json.dumps(res['top'])}")
    return res


def moe_f32_gates(serve_mod, out) -> dict:
    """c: float32 weights and activations.  Every MoE call of the
    reconstruct-then-serve teacher-forced run is replayed with the TT-native
    banks (batched chain kernels) and with the reconstructed dense banks:
    the same input, so the same routing; gated per layer at F32_TOL of the
    dense output's scale.  The whole-model teacher-forced logits of both
    are printed with the routing flips between them and their margins."""
    from repro_torch.models import common, mlp
    model = out["model"]
    m32 = _f32_model(model, DEVICE)
    cfg32, layers, k = m32.cfg, model.cfg.num_layers, model.cfg.moe.num_experts_per_tok
    tt32, rx32 = f32_params(out["payload"], model.cfg.family)
    prompts = torch.as_tensor(out["prompts"], dtype=torch.int64,
                              device=DEVICE)
    with _Recorder(mlp, "moe_apply", lambda a, _: a[0].clone()) as xs, \
            _Recorder(mlp, "_top_k", lambda a, r: (a[0].clone(), r[1])) as rx_r:
        tf_rx = serve_mod.teacher_forced_logits(m32, rx32, prompts)
    reset_counts()
    with _Recorder(mlp, "_top_k", lambda a, r: (a[0].clone(), r[1])) as tt_r:
        tf_tt = serve_mod.teacher_forced_logits(m32, tt32, prompts)
    whole_counts = read_counts()
    d, scale, agree = common.logit_parity(torch.from_numpy(tf_tt),
                                          torch.from_numpy(tf_rx))
    flips = []
    for n, ((p_rx, e_rx), (_, e_tt)) in enumerate(zip(rx_r.calls,
                                                      tt_r.calls)):
        srt = p_rx.sort(dim=-1, descending=True).values
        for t in range(e_rx.shape[0]):
            if set(e_rx[t].tolist()) != set(e_tt[t].tolist()):
                flips.append({"layer": n % layers, "position": n // layers,
                              "token": t, "margin": float(
                                  srt[t, k - 1] - srt[t, k])})
    print(f"[chip_smoke] moe f32 whole model, teacher-forced (reported): "
          f"TT-native vs reconstruct max|d|/scale {d / scale:.3e}, argmax "
          f"agreement {agree:.2%}; routing flips {len(flips)} of "
          f"{len(rx_r.calls) * prompts.shape[0]} token-layer routings "
          f"{json.dumps(flips[:10])}; launches {whole_counts}")

    worst, per_layer = 0.0, []
    reset_counts()
    for layer in range(layers):
        p_tt = common.layer_at(tt32.layers, layer).moe
        p_rx = common.layer_at(rx32.layers, layer).moe
        dl, sl = 0.0, 0.0
        for x in xs.calls[layer::layers]:
            got = mlp.moe_apply(x, p_tt, cfg32)
            ref = mlp.moe_apply(x, p_rx, cfg32)
            dd, ss = _gap(got, ref)
            dl, sl = max(dl, dd), max(sl, ss)
        check(dl <= F32_TOL * sl,
              f"moe f32 layer {layer}: TT-native vs dense banks max|d| "
              f"{dl:.3e} over {F32_TOL} * scale {sl:.3e}")
        per_layer.append(dl / sl)
        worst = max(worst, dl / sl)
    counts = read_counts()
    reset_counts()
    want = len(MOE_BANKS) * len(xs.calls)
    check(counts.get("tt_contract_2_batched", 0) == want
          and counts.get("tt_contract_2_batched_fma", 0) == want
          and counts.get("plain_chains", 0) == 0,
          f"moe f32 gate: {counts} (want {want} batched launches, all on "
          f"the float32 FFMA route)")
    check_no_plain(counts, "moe f32 gate")
    print(f"[chip_smoke] moe f32 gate: {len(xs.calls)} MoE calls replayed "
          f"with TT-native and dense banks, same routing: worst per-layer "
          f"max|d|/scale {worst:.3e} (gate {F32_TOL}); per layer "
          f"{json.dumps([float(f'{v:.3e}') for v in per_layer])}")
    return {"worst": worst, "per_layer": per_layer,
            "whole_model": d / scale, "whole_agree": agree,
            "flips": len(flips), "flip_margins": [f["margin"] for f in flips],
            "routings": len(rx_r.calls) * prompts.shape[0]}


def moe_kernel_phase(ops, cases, info) -> dict:
    """d: the main path's expert banks (``stored_phase``, from their stored
    tensors with the lead) at every (E, C) of ``cases.BATCHED_EC``, float32,
    bfloat16 and int8 (bf16 and int8 on the tensor-core route, timed as
    served at C = 1; float32, the gates' FFMA route, timed too), and the
    synthetic depth-3 and ragged banks of ``cases.STORED_BANKS``; the
    attention chains at B in {1, 4}; the absorbed batched API's routes
    against their plain versions (``cases.batched_case``)."""
    banks = chain_shapes(info, experts=True)
    for path in MOE_BANKS:
        split, cores, experts = info["chains"][path]
        check(len(cores) == 2 and split == 1 and experts == 64,
              f"moe: {path} is not a depth-2, split-1 bank of 64 experts: "
              f"{info['chains'][path]}")
    rec = stored_phase(ops, cases, banks, "olmoe-1b-7b bank", experts=True,
                       ec=cases.BATCHED_EC, timed=SERVED_TAIL
                       + (torch.float32,))
    synthetic = {(split, tuple(tuple(c) for c in cores)): 1
                 for name, (split, cores) in cases.STORED_BANKS.items()
                 if not name.startswith("olmoe")}
    for k, v in stored_phase(ops, cases, synthetic, "synthetic bank",
                             experts=True, ec=cases.BATCHED_EC).items():
        rec.setdefault(k, v)
    rec["attention"] = stored_phase(ops, cases, chain_shapes(info),
                                    "olmoe-1b-7b", batch_sizes=(1, 4))
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    worst = 0.0
    for kind, listed in cases.BATCHED_SHAPES.items():
        for shape in listed:
            for e, c in cases.BATCHED_EC:
                for dtype in cases.TAIL_DTYPES:
                    name, kern, plain, _ = cases.batched_case(
                        kind, shape, e, c, dtype, gen, DEVICE)
                    err, scale = _gap(kern(), plain())
                    worst = max(worst, err)
                    check(err <= TOL * scale,
                          f"absorbed {name} {dtype} {shape} E={e} C={c} "
                          f"disagrees with its plain version")
    print(f"[chip_smoke] absorbed batched API: every shape within TOL, "
          f"worst max|d| {worst:.3e}")
    return rec


# (JSON name, engine_cases kinds (timed first), source, TPU kernel, launch
# counters summed)
ENGINE_ROWS = [
    ("panel_factor", ("panel",), "householder/csrc/householder.cu",
     "householder/kernel.py:99", ("panel_factor",)),
    ("panel_factor_batched", ("panel_batched",),
     "householder/csrc/householder.cu", "householder/kernel.py:122",
     ("panel_factor_batched",)),
    ("wy_update_pass1", ("wy_vta", "wy_vta_batched"),
     "block_update/csrc/block_update.cu", "block_update/kernel.py:67",
     ("wy_vta", "wy_vta_batched")),
    ("wy_update_pass2", ("wy_apply", "wy_apply_batched"),
     "block_update/csrc/block_update.cu", "block_update/kernel.py:83",
     ("wy_apply", "wy_apply_batched")),
    ("frob_truncate", ("truncate",), "frob_truncate/csrc/frob_truncate.cu",
     "frob_truncate/kernel.py:37", ("frob_truncate",)),
    ("frob_truncate_batched", ("truncate_batched",),
     "frob_truncate/csrc/frob_truncate.cu", "frob_truncate/kernel.py:65",
     ("frob_truncate_batched",)),
    ("bitonic_sort_desc", ("sort",), "singular_sort/csrc/singular_sort.cu",
     "singular_sort/kernel.py:93", ("bitonic_sort_desc",)),
    ("bitonic_sort_desc_batched", ("sort_batched",),
     "singular_sort/csrc/singular_sort.cu", "singular_sort/kernel.py:61",
     ("bitonic_sort_desc_batched",)),
]


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.tt_contract import cases, ops
    from repro_torch.launch import serve as serve_mod

    card = card_line()
    print(f"[chip_smoke] card: {card}")
    print(f"[chip_smoke] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    kbuild.load_many([m.SOURCE for m in kernel_modules()])   # in parallel
    print(f"[chip_smoke] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    paths = {w: run_main_path(ops, serve_mod, w) for w in ("tt", "tt-int8")}
    print(f"[chip_smoke] main path phase {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    rec = stored_phase(ops, cases, chain_shapes(paths["tt"]["info"]),
                       "qwen1.5-0.5b")
    absorbed_phase(ops, cases)
    print(f"[chip_smoke] kernel phase {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    full = engine_fullwidth(serve_mod, paths["tt"])
    resnet = engine_resnet()
    erec = engine_kernel_phase(engine_shapes(full["tts"], resnet["plan"]))
    svd_d = blocked_svd_check(full["wq"])
    print(f"[chip_smoke] TTD-engine phase {time.perf_counter() - t0:.1f}s")
    del full["tts"], full["wq"]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    served = hybrid_serve(serve_mod)
    hrec = stored_phase(ops, cases, chain_shapes(served["out"]["info"]),
                        "recurrentgemma-2b", batch_sizes=(1, 4, 8192))
    hybrid = hybrid_prefill(served)
    del served["out"]
    torch.cuda.empty_cache()
    frec = flash_phase()
    print(f"[chip_smoke] hybrid phase {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    moe = moe_serve(serve_mod)
    served_moe = moe.pop("out")
    keep = {k: served_moe[k] for k in ("model", "payload", "prompts")}
    del served_moe
    torch.cuda.empty_cache()
    gates = moe_f32_gates(serve_mod, keep)
    del keep
    torch.cuda.empty_cache()
    mrec = moe_kernel_phase(ops, cases, moe.pop("info"))
    print(f"[chip_smoke] moe phase {time.perf_counter() - t0:.1f}s")

    def bound_by(r):
        return ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                >= r["ops_absorb"] / r["time_peak"]
                + r["ops_chain"] / F32_FLOPS else "operations")

    chain_src = "src/repro_torch/kernels/tt_contract/csrc/tt_contract.cu"
    kernels = []
    for name in ops.KERNELS:
        path = paths["tt" if not name.endswith("q") else "tt-int8"]
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": chain_src,
            "replaces": {"tt_contract_2": "src/repro/kernels/tt_contract/kernel.py:138",
                         "tt_contract_3": "src/repro/kernels/tt_contract/kernel.py:162",
                         "tt_contract_2q": "src/repro/kernels/tt_contract/kernel.py:190",
                         "tt_contract_3q": "src/repro/kernels/tt_contract/kernel.py:219"}[name],
            "launches": path["counts"].get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "graph_ms": r["graph_ms"],
            "max_abs_err_bf16_x": r["max_abs_err_bf16_x"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": bound_by(r), "library_ms": r["library_ms"],
            "timed": "one tt_apply call from the stored tensors (lead "
                     "absorbed in phase A), summed over one qwen1.5-0.5b "
                     "layer's calls at B=4, bf16 x, storage as served; "
                     "graph_ms: device time from replays of a CUDA graph "
                     "of calls",
        })
    for name, key in [(k, k) for k in ops.BATCHED] + [
            ("tt_contract_2_batched_fma", "tt_contract_2_batched_fma")]:
        r = mrec[key]
        base = name[:-len("_fma")] if name.endswith("_fma") else name
        moe_run = moe["tt-int8" if "q_" in name else "tt"]
        kernels.append({
            "name": name, "route": "cuda", "source": chain_src,
            "replaces": BATCHED_TPU,
            "launches": moe_run["counts"].get(
                name if name.endswith("_fma") else base, 0),
            "phase_a_routes": {k: moe_run["counts"].get(f"{base}_{k}", 0)
                               for k in ops.BANK_ROUTES},
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "graph_ms": r["graph_ms"],
            "max_abs_err_bf16_x": r["max_abs_err_bf16_x"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": bound_by(r), "library_ms": r["library_ms"],
            "timed": ("float32 banks (the float32 gates' FFMA route), sum "
                      "over one olmoe-1b-7b layer's three bank calls, 64 "
                      "experts x 1 token; launches in the main path: none "
                      "(bf16 serving)" if name.endswith("_fma") else
                      "sum over one olmoe-1b-7b layer's three bank calls "
                      "from the stored tensors, 64 experts x 1 token, "
                      "absorption on the tensor cores" if "_2" in name else
                      "one call of the synthetic depth-3 stored bank of "
                      "cases.STORED_BANKS, 64 experts x 1 token; on no "
                      "config's path"),
        })
    engine_counts = {**full["counts"], **resnet["counts"]}
    for name, kinds, src, replaces, keys in ENGINE_ROWS:
        r = erec[kinds[0]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": sum(engine_counts.get(k, 0) for k in keys),
            "max_abs_err": max(erec[k]["max_abs_err"] for k in kinds),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["ops"] / F32_FLOPS else "operations"),
            "library_ms": r["library_ms"],
            "timed": f"one call at the largest main-path shape {r['shape']}",
            **{k: r[k] for k in ("by_shape", "ptxas", "layout", "graph_ms")
               if k in r},
            **({"routes": {route: engine_counts.get(f"{keys[0]}_{route}", 0)
                           for route in ("smem", "tsqr", "sweep")}}
               if name.startswith("panel") else {}),
        })
    for dtype, run in ((torch.bfloat16, "dense/pallas"),
                       (torch.float32, "dense_f32/pallas")):
        name = fa_ops.ROUTES[dtype][0]
        r = frec[dtype]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:93",
            "launches": hybrid["counts"][run].get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "graph_ms": r["graph_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "ptxas": r["ptxas"],
            **({"max_rel_err_f64": r["f64_gap"],
                "bound_ffma_ms": r["bound_ffma_ms"]} if "f64_gap" in r
               else {}),
            "timed": f"one {str(dtype)[6:]} call at the hybrid prefill's "
                     "shape (B 2, S 4096, 10 Q heads, 1 KV head, D 256, "
                     "window 2048); launches per prefill ("
                     + ("dense bf16" if dtype == torch.bfloat16 else
                        "dense f32, gate G1") + ")",
        })
    print(f"[chip_smoke] hybrid stored chains: " + json.dumps(
        {k: {kk: v[kk] for kk in ("max_abs_err", "max_abs_err_bf16_x",
                                  "ms", "graph_ms", "bound_ms")}
         for k, v in hrec.items()}))
    print(f"[chip_smoke] hybrid summary: " + json.dumps({
        "serve": served["summary"],
        "prefill": {k: v for k, v in hybrid.items() if k != "counts"},
        "prefill_launches": hybrid["counts"]}))
    print(f"[chip_smoke] moe summary: " + json.dumps(
        {"serve": moe, "f32": gates}))
    print(f"[chip_smoke] engine summary: " + json.dumps({
        "full_width": {k: full[k] for k in (
            "secs", "decay_s", "eps_worst", "f32_oracle", "breakdown",
            "profile")},
        "full_width_ranks": {k: list(v) for k, v in full["ranks"].items()},
        "full_width_launches": full["counts"],
        "resnet32": {k: resnet[k] for k in (
            "secs", "counts", "ranks", "payload_params", "ratio")},
        "blocked_svd_dsigma": svd_d}))
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
            "decode_profile": p.get("decode_profile"),
            "kernels_vs_plain": p["kernels_vs_plain"],
            "f32_oracle": p.get("f32_oracle")}
        for w, p in paths.items()}
    print(f"[chip_smoke] main path summary: {json.dumps(summary)}")
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f}s")
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
