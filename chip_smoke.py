#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), torch and CUDA versions; builds the
   CUDA kernels from ``src/repro_torch/kernels/*/csrc`` and prints the
   build time.
2. Main path: ``repro_torch.launch.serve.serve`` on full-width
   qwen1.5-0.5b (24 layers, d_model 1024, 16x64 heads, d_ff 2816, vocab
   151,936), random weights from a seed, 4 requests, prompt 16, gen 16,
   greedy, eps 0.2 — once with ``--weights tt``, which compresses on the
   card (its phases timed: the unblocked policy's breakdown) and saves
   the payload with ``--save-tt-checkpoint``, and once with ``--weights
   tt-int8``, which serves from that checkpoint (``--tt-checkpoint``) and
   compresses nothing (gated: no engine kernel launched).  The launch
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
   a. full-width qwen1.5-0.5b, the main path's weights, compressed once
      with the TT-Edge policy (``hbd_impl="blocked"``) on the batched plan,
      under ``torch.profiler`` and the phase timers (device time by
      kernel, each engine kernel's and WY pass 1's share, the panel
      factor's split by route; full-width qwen is compressed twice in all):
      plan, seconds, ranks beside the main path's (each within one), every
      TT leaf within ε, TT-native vs reconstruct-then-serve in float32 at
      1e-4 of scale, and the single-panel (its streamed panels on the TSQR
      route, none on the sweep), WY (pass 1 on its 16-byte copy route), sort
      and truncation kernels launched with no plain call; then where the
      time goes, for both HBD impls (host timers around each phase,
      synchronized; the blocked one under the profiler, the unblocked one
      the main path's);
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
      width and ``HYBRID_LAYERS`` of its 26 layers (d_model 2560, 10 Q
      heads and 1 KV head x 256, d_ff 7680, vocab 256,000, window 2048;
      the (rglru, rglru, attn) pattern kept), random weights from seed
      0 with the spectral decay, eps 0.2: compression seconds, ranks,
      resident bytes, every TT leaf within eps, chain, sort and truncation
      kernels launched with no plain call;
   b. prefill through ``make_prefill_step`` at B = 2, S = 4096 with the
      same compression's dense bf16 and TT-native weights, ``impl="pallas"``
      (flash kernel: one launch per attention layer, ``ATTN_LAYERS`` a
      prefill, all on the bf16 tensor-core route ``flash_attention_mma``)
      and
      ``impl="xla"`` (plain chunked attention): tokens/s, and the bf16
      differences printed.  Gates in float32 activations at F32_TOL of
      scale, every flash launch on the float32 3xTF32 tensor-core route
      ``flash_attention_f32`` (``ATTN_LAYERS`` a run): G1 pallas vs xla
      with dense
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
7. Forward and checkpoint phase (``checkpoint/checkpoint.py``, the dense
   and MoE ``forward``/``prefill``/``loss_fn``):
   a. the main path's checkpoint: every leaf loaded back equal bit for bit
      to the payload in memory; ``serve --tt-checkpoint`` (no compression)
      gives the tt run's tokens; a copy with one flipped byte raises
      ``CheckpointCorrupt``;
   b. qwen1.5-0.5b, the tt run's TT-native bf16 weights:
      ``make_prefill_step`` at B = 2, S = 4096 under both impls and
      ``make_eval_step`` at B = 1, S = 4096 (tok/s; chain kernels
      launched, no plain-path chain, no flash launch: the reference's
      scanned layer flag keeps both impls on the plain attention; eval
      losses of the impls within 1e-5 relative); in float32 at F32_TOL of
      scale, TT-native prefill against reconstruct-then-prefill, and
      prefill's last logits against the KV cache stepped through 256
      tokens;
   c. olmoe-1b-7b, the MoE phase's compression: prefill at B = 1, S = 2048
      (320 rows an expert) with the TT-native bf16 banks (tok/s; every bank
      call one batched launch, the routes counted, no plain call); in
      float32 each MoE call of a reconstruct-then-prefill run replayed with
      the TT-native and the dense banks, per layer within F32_TOL of scale;
      the banks against their plain version at 64 experts x 320 rows;
   d. qwen3-8b at full width (d_model 4096, 32 Q heads and 8 KV heads x
      128, qk-norm, d_ff 12,288, vocab 151,936, untied), ``BIG_LAYERS`` = 8
      of its 36 layers (the cut: compression seconds), random weights from
      seed 0 with the spectral decay, eps 0.2: ``serve --weights tt``,
      compressed on the card, with the main path's gates (fused == python
      tokens, kernels vs plain and TT-native vs reconstruct in float32,
      every TT leaf within eps); its stored chains (as 3.) at B in {1, 4,
      4096}; prefill at B = 1, S = 4096.
   7a-b run after 3, 7c after 6c, 7d last.
8. Prints each phase's seconds, the script's total, one ``{"kernels":
   [...]}`` JSON line (the twelve other ported kernels, one entry per
   flash route and one per batched chain route, the float32 banks' FFMA
   route too; the panel rows with their main-path route counts; the
   chains and both flash routes again at the encoder-decoder's shapes,
   ``*_encdec``, with that phase's launches; at mamba2-1.3b's,
   ``*_ssm``; and at gemma3-1b's, ``*_gemma3``),
   the card line again, and as the last line ``{"ok": true, "device":
   {...}}``.

9. Serving phase (``prng``, ``models/common`` sampling and slot
   machinery, ``launch/engine.Engine``, ``launch/router``,
   ``launch/server``), run after 4 while the children still compress (its
   gates are exact; its tok/s are taken beside them); 9c in the hybrid
   phase:
   a. the sampler on the card: threefry keys and bits, ``fold_in``, a
      categorical draw and ``sample_tokens`` equal to the port on the CPU
      and to answers taken from the JAX package; on identical logits
      (8 rows x 151,936, mixed per-slot temperatures and top-k, 16 steps)
      card tokens equal to CPU tokens, any mismatch printed and gated to
      be a near-tie within the Gumbel noise's ulps; 65,536 draws of one
      64-way distribution at temperature 0.7, top-k 16: nothing outside
      the top 16, χ² p-value above 1e-3;
   b. the ``Engine`` on full-width qwen1.5-0.5b in float32 (the main
      path's checkpoint as TT-native params with float32 cores), 4 slots,
      chunks of 8, 12 requests (prompts 3-32, gens 4-32, greedy and
      sampled mixed) in both admission modes: every completion equal to
      its isolated ``generate`` run, scan == boundary byte for byte, every
      chain on a kernel, and no host sync inside a chunk
      (``torch.cuda.set_sync_debug_mode("error")`` around each chunk);
      then the same stream in bf16 ``tt`` and ``tt-int8``: tok/s,
      occupancy, agreement of 2 requests with their isolated runs
      (reported);
   c. the hybrid phase's recurrentgemma-2b checkpoint (float32 TT-native)
      through the Engine, 6 requests: staggered == isolated;
   d. ``serve --serve --weights tt --tt-checkpoint`` (the main path's
      checkpoint) with 2 replicas x 4 slots (``serve.make_router``) behind
      ``server.serve_in_thread`` on an ephemeral port; over HTTP 8 JSON and
      2 SSE requests whose tokens equal their isolated runs, a 504 on a
      1 ms deadline and then a served request, a 429 past the queue depth,
      and 12 dropped streams whose slots come back.

10. Encoder-decoder phase (``models/encdec.py``, ``Engine`` admission
   with encoder memory), last, from a third child compression
   (``serve --arch seamless-m4t-large-v2 --weights tt
   --save-tt-checkpoint``, started with the other two): full-width
   seamless-m4t-large-v2 (``ENCDEC_LAYERS`` = 12 encoder and 12 decoder
   layers of 24 each, the cut: the script's time; d_model 1024, 16x64 heads, d_ff 8192 relu, vocab 256,206,
   tied, 1,024 memory rows), random weights from seed 0 with the spectral
   decay, eps 0.2:
   a. ``serve --weights tt --tt-checkpoint`` (B 4, prompt 16, gen 16, a
      source of 1,024 tokens a row): every leaf loaded equal bit for bit
      to the payload the child compressed (sha256 of each leaf's bytes),
      a flipped byte refused, chain kernels launched with no plain call;
      the bf16 verify reported;
   b. prefill at B = 2 with 1,024 frames and 1,024 tokens, bf16 TT-native
      under both impls: tok/s, the decoder's flash launches (exactly one
      a decoder layer under ``"pallas"``, on the mma route; none under
      ``"xla"``, none in the encoder); float32 (float32 cores): TT-native
      pallas vs xla and TT-native vs reconstruct-then-prefill within
      F32_TOL of scale (every flash launch on the 3xTF32 route), eval at
      B = 1 under both impls within 1e-5 relative;
   c. float32 ``populate_memory`` of 4 sources against ``admit_memory``
      slot by slot (F32_TOL of scale; bit-equality reported), and a slot
      with a source decoding otherwise than one with none;
   d. the Engine, 4 slots, boundary admission (the source encoded at
      admission), 8 requests with sources of 16-256 tokens and a
      token-only one that recycles a slot: float32 tokens equal to their
      isolated ``generate(src_tokens=...)`` runs' bit for bit, prompt
      logits within F32_TOL of scale (bit-equality reported), chains on
      their kernels, no host sync inside a chunk, scan admission refused;
      bf16 ``tt`` reported;
   e. the flash kernel at the decoder's shape (2, 1,024, 16, 64), both
      routes, against its plain version (and float64, ``mha_tiled``),
      timed beside SDPA and its bound; the path's stored chains at B in
      {1, 4, 2,048} (as 3.).

11. SSM phase (``models/mamba2.py``: chunked SSD prefill, O(1)-state
   decode; 11a-c after the serving phase, while qwen3-8b's and
   recurrentgemma-2b's children still compress: their gates hold beside
   them; 11d-e last), from a fourth child compression (``serve --arch
   mamba2-1.3b --weights tt --save-tt-checkpoint``, started with the
   other three; it waits for seamless's to end before it compresses:
   four at once beside the TTD-engine phase run the card out of
   memory): full-width mamba2-1.3b (``SSM_LAYERS`` = 24 of 48 layers;
   d_model 2048, d_inner 4096, 64 heads of 64, state 128, conv 4, chunk
   256, vocab 50,280 tied), random weights from seed 0 with the spectral
   decay, eps 0.2:
   a. ``serve --weights tt`` then ``--weights tt-int8`` from the checkpoint
      (B 4, prompt 16, gen 16): the leaves equal bit for bit to the
      child's payload (``leaf_digests``), a flipped byte refused, exactly
      w_in and w_out served from cores, every chain on its kernel with no
      plain call, fused == python driver tokens; decode tok/s and the
      verify numbers reported;
   b. float32 (TT leaves with float32 cores), gated: TT-native vs
      reconstruct prefill (B 1 x 2,048) within F32_TOL of scale, eval
      losses within 1e-5 relative, and every position's logits of the
      chunked prefill of 300 tokens (a chunk of 256 and a padded tail)
      against the decode cache stepped through them, each within F32_TOL
      of its scale;
   c. the Engine (4 slots, chunks of 8, 8 requests, greedy and sampled
      mixed) in float32: tokens equal to the isolated runs' in both
      admission modes, scan == boundary byte for byte, chains on their
      kernels, no host sync inside a chunk; bf16 ``tt`` tok/s reported;
   d. bf16 prefill B = 2 x S = 4,096 (TT-native and dense): tok/s and the
      share of the device time in ``ssd_chunked`` (CUDA events), reported;
      exactly two ``tt_apply`` calls a layer, no flash launch;
   e. the path's stored chains (w_in 2,048 -> 8,512, w_out 4,096 ->
      2,048) at B in {1, 4, 64, 8,192} (as 3.).

12. gemma3 phase (the dense transformer with 5:1 local:global windows,
   the √d_model embedding and a 262,144-entry tied vocabulary; 12a-c in
   the wait for qwen3-8b's child, before the SSM phase's gates; 12d-e
   last), from a fifth child compression (``serve --arch gemma3-1b
   --weights tt --save-tt-checkpoint``, started with the others; it waits
   for the TTD-engine phase to end before it compresses): full-width
   gemma3-1b (``GEMMA_LAYERS`` = 12 of 26 layers, global layers 6 and 12;
   d_model 1,152, 4 Q heads and 1 KV head of 256, qk-norm, d_ff 6,912
   gelu, window 512 with every sixth layer global, vocab 262,144 tied),
   random weights from seed 0 with the spectral decay, eps 0.2:
   a. ``serve --weights tt`` then ``--weights tt-int8`` from the checkpoint
      (B 4, prompt 16, gen 16) with the main path's gates (``big_serve``):
      ranks equal to the compression's, every TT leaf within eps, chains on
      their kernels with no plain call, kernels vs plain in float32, fused
      == python driver tokens, TT-native vs reconstruct-then-serve in
      float32; the leaves equal bit for bit to the child's payload and a
      flipped byte refused;
   b. float32 (float32 cores) at F32_TOL of scale (``dense_f32_gates``):
      TT-native vs reconstruct prefill at B 2 x 4,096; prefill's last
      logits against the KV cache stepped through GEMMA_STEP_S = 640
      tokens (at position 639 the local layers' window of 512 excludes the
      first 128 keys); and the window is live: the same prefill with no
      window differs from the windowed one by more than 1e-3 of scale;
   c. the Engine (4 slots, chunks of 8) in float32 on 6 requests, greedy
      and sampled mixed, one of them a prompt of GEMMA_LONG[0] tokens that
      crosses the window while its neighbours do not: tokens equal to the
      isolated runs' in both admission modes, scan == boundary byte for
      byte, chains on their kernels, no host sync inside a chunk;
   d. (with e) bf16 TT-native prefill B 2 x 4,096 under both impls and
      eval B 1 x 4,096 (``dense_forward``): tok/s, exactly 7 ``tt_apply``
      calls a layer (wq, wk, wv, wo, w_gate, w_up, w_down), no flash
      launch, losses of the impls within 1e-5 relative;
   e. the path's stored chains at B in {1, 4} and at 4,096 rows (as 3.).

Cuts of depth (every width as configured): qwen3-8b runs 8 of its 36
layers; recurrentgemma-2b ``HYBRID_LAYERS`` of its 26;
seamless-m4t-large-v2 ``ENCDEC_LAYERS`` = 12 of its 24 encoder and 24
decoder layers; mamba2-1.3b ``SSM_LAYERS`` of its 48; gemma3-1b
``GEMMA_LAYERS`` of its 26.  Nothing else is cut.

Exits non-zero without a CUDA card, and on any failed phase.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zipfile
from pathlib import Path
from typing import Optional

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
# Compressions in child processes
# ---------------------------------------------------------------------------
#
# recurrentgemma-2b's and qwen3-8b's compressions (minutes each, bound by
# the host's launch loop, the card mostly idle) run in child processes from
# the start, each ``serve --weights tt --save-tt-checkpoint`` on the same
# card; the phases that serve those models load the checkpoints
# (``--tt-checkpoint``).  Their seconds are taken while other phases share
# the card and the host.

AFTER_TIMEOUT_S = 900.0      # longest a child waits for the one before it


def start_compression(name: str, serve_args, work: str,
                      after: Optional[str] = None) -> dict:
    """Start ``python3 chip_smoke.py --compress CKPT REPORT [--after
    FILE] serve-args``; with ``after`` (another child's report, or a file
    the main process writes when a phase ends), the process waits for that
    file before it compresses, so the two never hold device memory at
    once."""
    ckpt = str(Path(work) / name)
    report = str(Path(work) / f"{name}.json")
    log_path = Path(work) / f"{name}.log"
    log = open(log_path, "w")
    wait = [] if after is None else ["--after", after]
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--compress", ckpt,
         report, *wait, *serve_args], stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "ckpt": ckpt, "report": report, "log": log,
            "log_path": log_path, "t0": time.perf_counter(),
            "t0_unix": time.time()}


def ttd_done_mark(work: str) -> str:
    """The file the main process writes when the TTD-engine phase ends."""
    return str(Path(work) / "ttd_engine.done")


def finish_compression(name: str, child: dict,
                       timeout: float = 1200.0) -> dict:
    """Wait for a child compression; its output is printed and its report
    (``compress_child``) returned with the checkpoint's directory."""
    try:
        rc = child["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        child["proc"].kill()
        rc = child["proc"].wait()
    wall = time.perf_counter() - child["t0"]
    child["log"].flush()
    for line in child["log_path"].read_text().splitlines():
        print(f"[{name} compression] {line[:2000]}")
    check(rc == 0, f"{name}: the compression's process exited {rc}")
    rep = {"ckpt": child["ckpt"], "wall_s": wall, "counts": {}}
    if rc == 0:
        with open(child["report"]) as f:
            rep.update(json.load(f))
        rep["done_s"] = rep["ended_unix"] - child["t0_unix"]
    counts = rep["counts"]
    for k in ("bitonic_sort_desc", "frob_truncate"):
        check(counts.get(k, 0) > 0,
              f"{name} compression: kernel {k} never launched")
    check_no_plain(counts, f"{name} compression")
    print(f"[chip_smoke] {name}: compressed in a child process in "
          f"{rep.get('compress_s', float('nan')):.3f}s (incl. the spectral "
          f"decay; its report came {rep.get('done_s', float('nan')):.1f}s "
          f"after its start, {rep.get('waited_s', 0.0):.1f}s of it waiting "
          f"its turn; collected after {wall:.1f}s), "
          f"peak device memory {rep.get('peak_bytes', 0):,} B; launches "
          f"{counts}")
    return rep


def compress_child(ckpt: str, report: str, serve_args) -> int:
    """The child's side: ``serve --weights tt --save-tt-checkpoint CKPT``
    (two tokens, no verify), its compression's seconds, phases, peak device
    memory, launch counts and ranks written to ``report`` as JSON.  Leading
    ``--after FILE`` in ``serve_args``: first wait (up to AFTER_TIMEOUT_S)
    until FILE (another child's report, or the main process's mark that a
    phase has ended) exists."""
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    if serve_args[:1] == ["--after"]:
        first, serve_args = Path(serve_args[1]), serve_args[2:]
        while (not first.exists()
               and time.perf_counter() - t0 < AFTER_TIMEOUT_S):
            time.sleep(1.0)
    waited = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)        # no CPU math here: leave the cores
    from repro_torch.launch import serve as serve_mod
    args = serve_mod.parse_args(list(serve_args) + [
        "--weights", "tt", "--save-tt-checkpoint", ckpt, "--no-verify",
        "--gen", "2"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with PhaseTimers() as timers:
        out = serve_mod.serve(args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    info = out["info"]
    ex = info["exec_stats"]
    rep = {"compress_s": info["compress_s"],
           "breakdown": timers.breakdown(info["compress_s"]),
           "peak_bytes": peak,
           "counts": read_counts(),
           "leaf_sha": leaf_digests(out["payload"]),
           "ranks": {k: list(v) for k, v in info["ranks"].items()},
           "payload_ratio": info["payload_ratio"],
           "plan": [ex.bucket_launches, ex.serial_params],
           "dense_bytes": info["dense_bytes"], "tt_bytes": info["tt_bytes"],
           "line": info["line"], "waited_s": waited,
           "ended_unix": time.time()}
    # written whole, then renamed: a child waiting on it reads it complete
    with open(report + ".tmp", "w") as f:
        json.dump(rep, f)
    os.replace(report + ".tmp", report)
    return 0


def leaf_digests(payload) -> dict:
    """{leaf path: sha256 of its kind, shape, dtype, ranks and the bytes of
    its cores (or raw tensor)}: a payload in memory and the same payload
    loaded from its checkpoint give equal digests when every leaf is equal
    bit for bit."""
    import hashlib

    from repro_torch import tree
    from repro_torch.core import compression as comp
    out = {}
    for path, c in tree.leaves_with_paths(payload,
                                          is_leaf=comp.is_compressed_param):
        h = hashlib.sha256(repr((c.kind, tuple(c.orig_shape),
                                 str(c.orig_dtype),
                                 c.tt.ranks if c.kind == "tt" else None)
                                ).encode())
        for t in (c.tt.cores if c.kind == "tt" else [c.raw]):
            h.update(str(t.dtype).encode())
            h.update(t.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        out[path] = h.hexdigest()
    return out


def decayed_params(model, seed: int = 0):
    """The weights ``serve`` compresses: random from ``seed``, given the
    spectral decay (deterministic: a loaded checkpoint's dense weights)."""
    from repro_torch.core.tt_linear import spectral_decay_pytree
    return spectral_decay_pytree(model.init(seed), alpha=1.0)


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
    from repro_torch.models import encdec, mamba2, rglru, transformer
    from repro_torch.models.registry import build
    cfg32 = dataclasses.replace(model.cfg, dtype="float32")
    init_cache = {"dense": transformer.init_cache,
                  "moe": transformer.init_cache,
                  "ssm": mamba2.init_cache,
                  "hybrid": rglru.init_cache,
                  "encdec": encdec.init_cache}[cfg32.family]
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


def f32_oracle(serve_mod, out, what: str = "tt") -> float:
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
          f"{what} f32: TT-native vs reconstruct max|d| {d:.3e} over "
          f"{F32_TOL} * scale {scale:.3e}")
    print(f"[chip_smoke] {what} f32: TT-native vs reconstruct-then-serve "
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


def run_main_path(ops, serve_mod, weights: str, ckpt_dir: str) -> dict:
    """``serve()`` once; the launch counters cover exactly this run.  The
    tt run compresses (the phases timed: the unblocked policy's breakdown)
    and saves its payload to ``ckpt_dir`` (``--save-tt-checkpoint``); the
    tt-int8 run serves from that checkpoint (``--tt-checkpoint``) and
    compresses nothing."""
    tt = weights == "tt"
    args = serve_mod.parse_args(
        SERVE_ARGS + ["--weights", weights]
        + ["--save-tt-checkpoint" if tt else "--tt-checkpoint", ckpt_dir])
    reset_counts()
    with PhaseTimers() as timers:
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
    want = (("tt_contract_2", "tt_contract_3") if tt
            else ("tt_contract_2q", "tt_contract_3q"))
    if tt:
        # compression on the batched plan: every full-width bucket is
        # serial, so each TT-SVD step sorts and truncates on the engine
        # kernels
        want += ("bitonic_sort_desc", "frob_truncate")
        ex = info["exec_stats"]
        print(f"[chip_smoke] main path tt: compression plan "
              f"{ex.bucket_launches} bucket passes, {ex.serial_params} "
              f"serial params, fingerprint {info['plan_fingerprint'][:16]}")
    else:
        engine = [k for k in ("bitonic_sort_desc", "frob_truncate",
                              "panel_factor", "wy_vta") if counts.get(k)]
        check(info["compress_s"] is None and not engine,
              f"{weights}: served from the checkpoint but compressed "
              f"({engine} launched)")
    for k in want:
        check(counts.get(k, 0) > 0,
              f"{weights}: kernel {k} never launched on the main path")
    check_no_plain(counts, weights)
    # decode steps that ran TT kernels: fused prefill + decode (16 + 15),
    # plus the int8 verify's teacher-forced pass over the prompt (15)
    steps = 31 + (0 if tt else 15)
    setup = (f"compress {info['compress_s']:.3f}s" if tt else
             f"loaded from the checkpoint in {info['load_s']:.3f}s")
    print(f"[chip_smoke] main path {weights}: launches {counts} over {steps} "
          f"TT decode steps; {setup}; decode {out['tok_per_s']:.2f} tok/s; "
          f"wall {wall:.1f}s")
    # the reference's own verify gates, bf16 at full width: reported; on
    # identical full-width cores the JAX reference misses them itself
    # (tools/tt_parity_depth.py, PERF.md)
    print(f"[chip_smoke] {weights} reference-oracle gate (reported): "
          f"max|d|/scale {ver['max_diff'] / ver['scale']:.4f} (bound 0.05)"
          + (f", tie-tolerant agreement {ver['tie_agree']:.4f} (gate 0.99)"
             if "tie_agree" in ver else ""))
    res = {"counts": counts, "steps": steps, "info": info, "verify": ver,
           "tok_per_s": out["tok_per_s"], "run": out["run"],
           "prompts": out["prompts"], "wall_s": wall}
    res["kernels_vs_plain"] = kernels_vs_plain(serve_mod, out, weights)
    if tt:
        res["breakdown"] = timers.breakdown(info["compress_s"])
        print(f"[chip_smoke] main path tt compression (unblocked policy), "
              f"where the time goes {json.dumps(res['breakdown'])}")
        res["decode_profile"] = decode_profile(out, "qwen1.5-0.5b tt")
        res["f32_oracle"] = f32_oracle(serve_mod, out)
        res["drivers_agree"] = drivers_agree(serve_mod, out, "tt")
        res["out"] = out
    return res


def drivers_agree(serve_mod, out, what: str) -> bool:
    """The fused driver's tokens (``serve``) against the python driver's on
    the same params."""
    py = serve_mod.engine_mod.generate(
        out["model"], out["params"], out["prompts"],
        out["generated"].shape[1], driver="python")
    same = np.array_equal(py["gen"], out["generated"])
    check(same, f"{what}: fused and python drivers disagree on the card")
    print(f"[chip_smoke] {what}: fused == python driver tokens: {same}")
    return same


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


def served_chains(info, quant: bool) -> tuple:
    """The chain kernels the served leaves' depths launch."""
    return tuple(sorted({f"tt_contract_{len(cores)}" + ("q" if quant else "")
                         for _, cores, _ in info["chains"].values()}))


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
        payload, report, secs, blocked_br = compress_timed(params, policy,
                                                           timers=True)
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
    # one compression of each policy: the main path's (unblocked, its own
    # phase timers) and this one (blocked, timed under the profiler)
    times = {"unblocked": main_tt["breakdown"], "blocked": blocked_br}
    for impl, br in times.items():
        print(f"[chip_smoke] engine, full width, {impl}: where the time "
              f"goes {json.dumps(br)}"
              + (" (under the profiler)" if impl == "blocked" else
                 " (the main path's compression)"))
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
# 8 of its 26 layers: 2 (rglru, rglru, attn) triples + the 2 rglru of the
# tail (the full depth: 8 triples + 2), the cut that keeps this script
# inside its time (PERF.md §4)
HYBRID_LAYERS = 8
HYBRID_SERVE_ARGS = ["--arch", HYBRID_ARCH, "--layers", str(HYBRID_LAYERS),
                     "--batch", "4", "--prompt-len", "16", "--gen", "16",
                     "--seed", "0", "--tt-eps", "0.2"]
PREFILL_B, PREFILL_S = 2, 4096
RING_S = 17 * 128    # past the 2,048 window: the decode ring buffer wraps
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (700 W)
TILED_DRAWS = 5      # extra draws (seeds 0-4) of the bf16 check vs mha_tiled
ATTN_LAYERS = HYBRID_LAYERS // 3   # attention layers: flash launches


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


def hybrid_serve(serve_mod, rep: dict) -> dict:
    """The main path: ``serve --weights tt`` at full width, served from the
    checkpoint a child process compressed (``rep``: its report); its
    params and payload, and the dense weights that compression took,
    serve the prefill checks below."""
    args = serve_mod.parse_args(HYBRID_SERVE_ARGS + [
        "--weights", "tt", "--tt-checkpoint", rep["ckpt"]])
    out, wall, counts = _counted(lambda: serve_mod.serve(args))
    info, ver, gen = out["info"], out["verify"], out["generated"]
    vocab = out["model"].cfg.vocab_size
    check(gen.shape == (4, 16) and gen.min() >= 0 and gen.max() < vocab,
          f"hybrid: generated tokens {gen.shape} out of range")
    check(bool(torch.isfinite(out["run"]["prompt_logits"]).all()),
          "hybrid: non-finite logits")
    check(counts.get("plain_chains", 0) == 0,
          f"hybrid: {counts.get('plain_chains')} chains took the plain path")
    for k in ("tt_contract_2", "tt_contract_3"):
        check(counts.get(k, 0) > 0,
              f"hybrid serve: kernel {k} never launched")
    check(info["ranks"] == {k: tuple(v) for k, v in rep["ranks"].items()},
          "hybrid: the checkpoint's ranks differ from the compression's")
    check_no_plain(counts, "hybrid serve")
    print(f"[chip_smoke] hybrid serve (tt, {HYBRID_LAYERS} layers): "
          f"compressed in {rep['compress_s']:.3f}s (incl. the spectral "
          f"decay, a child process), payload ratio "
          f"{rep['payload_ratio']:.3f}, plan {rep['plan'][0]} bucket "
          f"passes, {rep['plan'][1]} serial params; loaded in "
          f"{info['load_s']:.3f}s; decode {out['tok_per_s']:.2f} tok/s; "
          f"wall {wall:.1f}s; launches {counts}")
    print(f"[chip_smoke] hybrid compression, where the time goes "
          f"{json.dumps(rep['breakdown'])}")
    print(f"[chip_smoke] hybrid ranks: " + json.dumps(rep["ranks"]))
    print(f"[chip_smoke] hybrid resident weight bytes: dense "
          f"{info['dense_bytes']:,} -> tt-native {info['tt_bytes']:,}")
    print(f"[chip_smoke] hybrid reference-oracle gate (reported): "
          f"max|d|/scale {ver['max_diff'] / ver['scale']:.4f} (bound 0.05)")
    out["dense_params"] = decayed_params(out["model"])
    eps_worst = eps_gate(out["dense_params"], out["payload"],
                         "hybrid, full width")
    return {"out": out, "counts": counts, "wall_s": wall,
            "eps_worst": eps_worst,
            "summary": {"compress_s": rep["compress_s"],
                        "compress_peak_bytes": rep["peak_bytes"],
                        "compress_launches": rep["counts"],
                        "breakdown": rep["breakdown"],
                        "payload_ratio": rep["payload_ratio"],
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


def flash_times(case, dtype) -> dict:
    """Times of one flash case on the route of ``dtype`` (CUDA-event median
    and graph replays), its plain version and one SDPA call, and the
    route's bound; ``"line"`` prints them."""
    fast = dtype == torch.bfloat16
    ms = time_ms(case.kernel, 20 if fast else 5)
    g_ms = graph_ms(case.kernel, 10 if fast else 5, 5)
    p_ms = time_ms(case.plain, 3)
    l_ms = time_ms(case.library, 20 if fast else 5)
    # the route as built: float32 takes three TF32 products per float32
    # product; its FFMA bound is printed beside it
    flops, rate = ((case.flops, BF16_FLOPS) if fast
                   else (3 * case.flops, TF32_FLOPS))
    by_ops = flops / rate >= case.nbytes / HBM_BYTES_PER_S
    bound = max(case.nbytes / HBM_BYTES_PER_S, flops / rate) * 1e3
    r = {"ms": ms, "graph_ms": g_ms, "plain_ms": p_ms, "library_ms": l_ms,
         "bound_ms": bound, "bound_by": "operations" if by_ops else "bytes"}
    extra = ""
    if not fast:
        r["bound_ffma_ms"] = max(case.nbytes / HBM_BYTES_PER_S,
                                 case.flops / F32_FLOPS) * 1e3
        extra = (f"; FFMA bound {r['bound_ffma_ms']:.5f} ms "
                 f"({r['bound_ffma_ms'] / ms:.1%})")
    r["line"] = (f"kernel {ms:.4f} ms (graph {g_ms:.4f} ms), plain "
                 f"{p_ms:.4f} ms, sdpa {l_ms:.4f} ms, bound {bound:.5f} ms "
                 f"({flops:.4e} FLOPs at {rate / 1e12:.0f} TFLOP/s, "
                 f"{case.nbytes:,} bytes; {bound / ms:.1%} of the bound)"
                 f"{extra}")
    return r


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
            r.update(flash_times(case, dtype))
            print(f"{line}; {r.pop('line')}")
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
# the TPU kernels the four chain kernels replace
CHAIN_TPU = {name: f"src/repro/kernels/tt_contract/kernel.py:{line}"
             for name, line in (("tt_contract_2", 138), ("tt_contract_3", 162),
                                ("tt_contract_2q", 190),
                                ("tt_contract_3q", 219))}


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
        if not quant:
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


def moe_f32_gates(serve_mod, out, tt32, rx32) -> dict:
    """c: float32 weights and activations (``tt32``, ``rx32``: the payload's
    ``f32_params``).  Every MoE call of the reconstruct-then-serve
    teacher-forced run is replayed with the TT-native banks (batched chain
    kernels) and with the reconstructed dense banks: the same input, so the
    same routing; gated per layer at F32_TOL of the dense output's scale.
    The whole-model teacher-forced logits of both are printed with the
    routing flips between them and their margins."""
    from repro_torch.models import common, mlp
    model = out["model"]
    m32 = _f32_model(model, DEVICE)
    layers, k = model.cfg.num_layers, model.cfg.moe.num_experts_per_tok
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

    worst, per_layer = moe_replay(xs.calls, tt32, rx32, m32.cfg, layers,
                                  "moe f32 gate")
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


# ---------------------------------------------------------------------------
# Forward and checkpoint phase: the payload checkpoint, the dense and MoE
# prefill and eval, and qwen3-8b at full width
# ---------------------------------------------------------------------------

FWD_B, FWD_S = 2, 4096       # dense prefill (qwen1.5-0.5b)
DECODE_S = 256               # prefill vs the decode cache stepped through
MOE_PREFILL_S = 2048         # olmoe prefill, B = 1: 320 rows an expert
BIG_ARCH, BIG_LAYERS = "qwen3-8b", 8      # 8 of its 36 layers: the one cut
BIG_SERVE_ARGS = ["--arch", BIG_ARCH, "--layers", str(BIG_LAYERS),
                  "--batch", "4", "--prompt-len", "16", "--gen", "16",
                  "--seed", "0", "--tt-eps", "0.2"]
BIG_PREFILL_S = 4096


def flip_byte(directory: str) -> None:
    """Flip one byte in the middle of the first core's stored data in a
    checkpoint's archive."""
    path = Path(directory) / "tt_payload.npz"
    with zipfile.ZipFile(path) as z:
        member = next(i for i in z.infolist() if "__core0" in i.filename)
    with open(path, "r+b") as f:
        f.seek(member.header_offset + 26)     # the local header's lengths
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        pos = (member.header_offset + 30 + name_len + extra_len
               + member.file_size // 2)
        f.seek(pos)
        byte = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([byte ^ 0x10]))


def checkpoint_phase(serve_mod, out, ckpt_dir: str) -> dict:
    """a: the tt run's checkpoint.  Every leaf loaded back equals the one in
    memory bit for bit; ``serve --tt-checkpoint`` serves the in-memory run's
    tokens; a copy with one flipped byte raises ``CheckpointCorrupt``."""
    from repro_torch import tree
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import compression as comp
    t0 = time.perf_counter()
    loaded, manifest = ckpt.load_tt_payload(ckpt_dir, like=out["payload"],
                                            device=DEVICE)
    saved = dict(tree.leaves_with_paths(out["payload"],
                                        is_leaf=comp.is_compressed_param))
    differ = []
    for path, c in tree.leaves_with_paths(loaded,
                                          is_leaf=comp.is_compressed_param):
        ref = saved[path]
        pairs = (list(zip(c.tt.cores, ref.tt.cores)) if c.kind == "tt"
                 else [(c.raw, ref.raw)])
        same = (c.kind == ref.kind and c.orig_shape == ref.orig_shape
                and c.orig_dtype == ref.orig_dtype
                and (c.kind != "tt" or c.tt.ranks == ref.tt.ranks)
                and all(a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in pairs))
        if not same:
            differ.append(path)
    check(not differ and len(saved) == len(manifest["leaves"]),
          f"checkpoint: leaves {differ} differ from the saved payload")
    load_s = time.perf_counter() - t0
    del loaded
    args = serve_mod.parse_args(SERVE_ARGS + [
        "--weights", "tt", "--tt-checkpoint", ckpt_dir, "--no-verify"])
    served, secs, counts = _counted(lambda: serve_mod.serve(args))
    same = np.array_equal(served["generated"], out["generated"])
    check(same, "checkpoint: tokens served from the checkpoint differ from "
                "the in-memory run's")
    check(counts.get("tt_contract_2", 0) > 0 and not counts.get(
        "frob_truncate") and served["info"]["compress_s"] is None,
          f"checkpoint serve: compressed or no chain kernel ({counts})")
    del served
    flipped = ckpt_dir + "-flipped"
    shutil.copytree(ckpt_dir, flipped)
    flip_byte(flipped)
    try:
        ckpt.load_tt_payload(flipped, like=out["payload"], device=DEVICE)
        raised = "nothing"
    except ckpt.CheckpointCorrupt as e:
        raised = f"CheckpointCorrupt: {e}"
    shutil.rmtree(flipped)
    check(raised.startswith("CheckpointCorrupt"),
          f"checkpoint: a flipped byte raised {raised}")
    size = sum(f.stat().st_size for f in Path(ckpt_dir).iterdir())
    print(f"[chip_smoke] checkpoint: {len(saved)} leaves ({size:,} bytes on "
          f"disk) loaded back equal bit for bit in {load_s:.3f}s; served "
          f"from it (no compression, {secs:.1f}s): same tokens {same}; "
          f"flipped byte -> {raised[:90]}")
    return {"leaves": len(saved), "bytes": size, "load_s": load_s,
            "same_tokens": same, "serve_s": secs, "differ": differ}


def _prefill_counts(counts, what: str, chains, flash: bool = False) -> None:
    """The chain kernels of ``chains`` launched, no plain-path chain, no
    plain call on the card, and (``flash`` False) no flash launch."""
    check(all(counts.get(k, 0) > 0 for k in chains)
          and counts.get("plain_chains", 0) == 0,
          f"{what}: chain kernels {chains} not all launched: {counts}")
    if not flash:
        check(counts.get("flash_attention", 0) == 0,
              f"{what}: {counts.get('flash_attention')} flash launches (the "
              f"dense and MoE forward keep to the plain attention path)")
    check_no_plain(counts, what)


def _tokens(vocab: int, b: int, s: int, seed: int = 1) -> torch.Tensor:
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g, device=DEVICE)


class _TTCalls:
    """Counts ``tt_apply`` calls (every TT-served projection goes through
    ``common.dense_apply`` → ``tt_linear.tt_apply``)."""

    def __init__(self):
        from repro_torch.core import tt_linear
        self.mod, self.orig, self.n = tt_linear, tt_linear.tt_apply, 0

    def __enter__(self):
        def wrapped(*a, **k):
            self.n += 1
            return self.orig(*a, **k)
        self.mod.tt_apply = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.tt_apply = self.orig


def dense_forward(out, what: str, b: int, s: int, eval_s: int = 0,
                  tt_calls=None) -> dict:
    """Prefill (and eval at B = 1, S = ``eval_s``) through the entry points
    with the served TT-native bf16 weights under both impls: tok/s, the
    chain kernels launched, no flash launch, equal losses; with
    ``tt_calls``, exactly that many ``tt_apply`` calls a layer in each
    timed prefill."""
    from repro_torch.train.steps import make_eval_step, make_prefill_step
    model, params = out["model"], out["params"]
    vocab = model.cfg.vocab_size
    batch = {"tokens": _tokens(vocab, b, s)}
    chains = ("tt_contract_2", "tt_contract_3")
    res = {"tok_per_s": {}, "counts": {}}
    for impl in ("pallas", "xla"):
        step = make_prefill_step(model, impl=impl)
        step(params, batch)                               # warm-up
        with _TTCalls() as calls:
            lg, secs, counts = _counted(lambda: step(params, batch))
        check(lg.shape == (b, vocab) and bool(torch.isfinite(lg).all()),
              f"{what} prefill {impl}: logits {tuple(lg.shape)} not finite")
        _prefill_counts(counts, f"{what} prefill {impl}", chains)
        if tt_calls is not None:
            want = tt_calls * model.cfg.num_layers
            check(calls.n == want, f"{what} prefill {impl}: {calls.n} "
                                   f"tt_apply calls, want {want}")
        res["tok_per_s"][impl] = b * s / secs
        res["counts"][impl] = counts
        res["tt_apply_calls"] = calls.n
        print(f"[chip_smoke] {what} prefill bf16 tt impl={impl}: B={b} S={s} "
              f"in {secs:.3f}s = {b * s / secs:.0f} tok/s; tt_apply calls "
              f"{calls.n}; launches {counts}")
    if eval_s:
        toks = batch["tokens"][:1, :eval_s]
        batch1 = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        loss = {}
        for impl in ("pallas", "xla"):
            step = make_eval_step(model, impl=impl)
            step(params, batch1)
            metrics, secs, counts = _counted(lambda: step(params, batch1))
            _prefill_counts(counts, f"{what} eval {impl}", chains)
            loss[impl] = float(metrics["loss"])
            res["tok_per_s"][f"eval/{impl}"] = eval_s / secs
            print(f"[chip_smoke] {what} eval bf16 tt impl={impl}: B=1 "
                  f"S={eval_s} loss {loss[impl]:.6f} in {secs:.3f}s = "
                  f"{eval_s / secs:.0f} tok/s")
        rel = abs(loss["pallas"] - loss["xla"]) / abs(loss["xla"])
        res["eval_loss"], res["eval_rel"] = loss, rel
        check(math.isfinite(loss["xla"]) and rel <= 1e-5,
              f"{what} eval: losses {loss} differ by {rel:.3e} relative")
    return res


def dense_f32_gates(out, what: str, b: int = FWD_B, s: int = FWD_S,
                    decode_s: int = DECODE_S) -> dict:
    """Float32 activations and weights: TT-native prefill (chain kernels)
    against reconstruct-then-prefill (plain) at B = ``b``, S = ``s``, and
    prefill's last logits against the decode cache stepped through
    ``decode_s`` tokens, both at F32_TOL of scale.  A model with a window:
    the same TT-native prefill with no window (every layer global) must
    differ from the windowed one by more than 1e-3 of scale, or the local
    layers' mask is not in effect."""
    from repro_torch.train.steps import make_prefill_step
    model = out["model"]
    m32 = _f32_model(model, DEVICE)
    tt32, rx32 = f32_params(out["payload"], model.cfg.family)
    batch = {"tokens": _tokens(model.cfg.vocab_size, b, s)}
    got, _, counts = _counted(
        lambda: make_prefill_step(m32, impl="pallas")(tt32, batch))
    _prefill_counts(counts, f"{what} prefill TT f32",
                    ("tt_contract_2", "tt_contract_3"))
    ref = make_prefill_step(m32, impl="xla")(rx32, batch)
    d, scale = _gap(got, ref)
    res = {"tt_vs_reconstruct": d / scale}
    check(d <= F32_TOL * scale, f"{what}: TT-native vs reconstruct prefill "
                                f"max|d| {d:.3e} over {F32_TOL} * scale "
                                f"{scale:.3e}")
    print(f"[chip_smoke] {what} f32: TT-native prefill (chain kernels) vs "
          f"reconstruct-then-prefill (plain), B={b} S={s}: "
          f"max|d|/scale {d / scale:.3e}")
    del rx32, ref
    if model.cfg.window is not None:
        unwindowed = dataclasses.replace(
            model, cfg=dataclasses.replace(model.cfg, window=None))
        wide = make_prefill_step(_f32_model(unwindowed, DEVICE),
                                 impl="pallas")(tt32, batch)
        d, scale = _gap(wide, got)
        res["window_gap"] = d / scale
        check(d > 1e-3 * scale, f"{what}: the prefill with no window is "
                                f"within {d / scale:.3e} of scale of the "
                                f"windowed one: the window is not live")
        print(f"[chip_smoke] {what} f32: TT-native prefill with no window "
              f"vs window {model.cfg.window}, B={b} S={s}: max|d|/scale "
              f"{d / scale:.3e} (must exceed 1e-3)")
        del wide
    del got
    toks = batch["tokens"][:1, :decode_s]
    last = make_prefill_step(m32, impl="pallas")(tt32, {"tokens": toks})
    cache = m32.init_cache(1, decode_s)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for t in range(decode_s):
            stepped, cache = m32.decode_step(tt32, cache, toks[:, t:t + 1])
    torch.cuda.synchronize()
    d, scale = _gap(last, stepped)
    res["prefill_vs_decode"] = d / scale
    check(d <= F32_TOL * scale, f"{what}: prefill vs decode-stepped logits at "
                                f"position {decode_s - 1}: max|d| {d:.3e} "
                                f"over {F32_TOL} * scale {scale:.3e}")
    print(f"[chip_smoke] {what} f32: TT-native prefill vs {decode_s} decode "
          f"steps through the KV cache ({time.perf_counter() - t0:.1f}s): "
          f"last-position max|d|/scale {d / scale:.3e}")
    return res


def moe_replay(xs, tt32, rx32, cfg32, layers: int, what: str):
    """Each recorded MoE input (layer-major, ``layers`` a pass) through the
    layer's TT-native banks and its dense banks: per-layer max|d| / scale,
    gated at F32_TOL; every bank call one batched launch on the float32
    FFMA route.  Returns (worst, per layer)."""
    from repro_torch.models import common, mlp
    worst, per_layer = 0.0, []
    reset_counts()
    for layer in range(layers):
        p_tt = common.layer_at(tt32.layers, layer).moe
        p_rx = common.layer_at(rx32.layers, layer).moe
        dl, sl = 0.0, 0.0
        for x in xs[layer::layers]:
            dd, ss = _gap(mlp.moe_apply(x, p_tt, cfg32),
                          mlp.moe_apply(x, p_rx, cfg32))
            dl, sl = max(dl, dd), max(sl, ss)
        check(dl <= F32_TOL * sl,
              f"{what} layer {layer}: TT-native vs dense banks max|d| "
              f"{dl:.3e} over {F32_TOL} * scale {sl:.3e}")
        per_layer.append(dl / sl)
        worst = max(worst, dl / sl)
    counts = read_counts()
    reset_counts()
    want = len(MOE_BANKS) * len(xs)
    check(counts.get("tt_contract_2_batched", 0) == want
          and counts.get("tt_contract_2_batched_fma", 0) == want
          and counts.get("plain_chains", 0) == 0,
          f"{what}: {counts} (want {want} batched launches, all on the "
          f"float32 FFMA route)")
    check_no_plain(counts, what)
    return worst, per_layer


def moe_prefill(ops, cases, keep, tt32, rx32, info) -> dict:
    """c: olmoe-1b-7b prefill at B = 1, S = MOE_PREFILL_S (2,048 tokens: 320
    rows an expert) with the served TT-native bf16 banks: tok/s, every bank
    call one batched launch on a CUDA route, no plain call; in float32 each
    MoE call of a reconstruct-then-prefill run replayed with the TT-native
    and the dense banks; the banks against their plain version at 64
    experts x 320 rows."""
    from repro_torch.models import mlp
    from repro_torch.train.steps import make_prefill_step
    model = keep["model"]
    cfg, layers = model.cfg, model.cfg.num_layers
    batch = {"tokens": _tokens(cfg.vocab_size, 1, MOE_PREFILL_S)}
    step = make_prefill_step(model, impl="pallas")
    step(keep["params"], batch)
    lg, secs, counts = _counted(lambda: step(keep["params"], batch))
    check(bool(torch.isfinite(lg).all()), "moe prefill: non-finite logits")
    want = len(MOE_BANKS) * layers
    routes = {k: counts.get(f"tt_contract_2_batched_{k}", 0)
              for k in ops.BANK_ROUTES}
    check(counts.get("tt_contract_2_batched", 0) == want
          and sum(routes.values()) == want,
          f"moe prefill: {counts.get('tt_contract_2_batched', 0)} batched "
          f"launches on routes {routes}, want {want} (3 banks x {layers} "
          f"layers)")
    _prefill_counts(counts, "moe prefill", ("tt_contract_3",))
    cap = math.ceil(MOE_PREFILL_S * cfg.moe.num_experts_per_tok
                    / cfg.moe.num_experts * 1.25)
    print(f"[chip_smoke] moe prefill bf16 tt impl=pallas: B=1 "
          f"S={MOE_PREFILL_S} ({cap} rows an expert) in {secs:.3f}s = "
          f"{MOE_PREFILL_S / secs:.0f} tok/s; bank routes {routes}; "
          f"launches {counts}")
    res = {"tok_per_s": MOE_PREFILL_S / secs, "counts": counts,
           "routes": routes, "rows_per_expert": cap}

    m32 = _f32_model(model, DEVICE)
    with _Recorder(mlp, "moe_apply", lambda a, _: a[0].clone()) as xs:
        make_prefill_step(m32, impl="pallas")(rx32, batch)
    res["worst"], res["per_layer"] = moe_replay(
        xs.calls, tt32, rx32, m32.cfg, layers, "moe prefill f32")
    print(f"[chip_smoke] moe prefill f32: {len(xs.calls)} MoE calls of "
          f"{MOE_PREFILL_S} tokens replayed with TT-native and dense banks: "
          f"worst per-layer max|d|/scale {res['worst']:.3e} (gate {F32_TOL})")
    del xs
    rec = stored_phase(ops, cases, chain_shapes(info, experts=True),
                       "olmoe-1b-7b bank, prefill rows", experts=True,
                       ec=((cfg.moe.num_experts, cap),), timed=())
    res["banks_vs_plain"] = {k: v["max_abs_err"] for k, v in rec.items()}
    print(f"[chip_smoke] moe banks at {cfg.moe.num_experts} experts x {cap} "
          f"rows vs plain: max|d| {json.dumps(res['banks_vs_plain'])}")
    return res


def big_serve(serve_mod, rep: dict, serve_args=BIG_SERVE_ARGS,
              weights: str = "tt"):
    """d: qwen3-8b at full width, BIG_LAYERS of its 36 layers (or another
    dense model's ``serve_args``): ``serve --weights WEIGHTS`` from the
    checkpoint a child process compressed on the card (``rep``: its
    report), with the main path's gates (``tt``: every TT leaf within eps,
    fused == python tokens, kernels vs plain and TT-native vs reconstruct
    in float32; ``tt-int8``: kernels vs plain).  Returns (the results, what
    ``big_kernels`` needs)."""
    from repro_torch.configs import get_config
    args = serve_mod.parse_args(serve_args + [
        "--weights", weights, "--tt-checkpoint", rep["ckpt"]])
    out, wall, counts = _counted(lambda: serve_mod.serve(args))
    info, ver, gen = out["info"], out["verify"], out["generated"]
    cfg, arch = out["model"].cfg, args.arch
    what = f"{arch} {weights}"
    check(cfg.num_layers == args.layers
          and cfg.d_model == get_config(arch).d_model,
          f"{arch}: served {cfg.num_layers} layers of width {cfg.d_model}")
    check(gen.shape == (4, 16) and gen.min() >= 0
          and gen.max() < cfg.vocab_size,
          f"{what}: generated tokens {gen.shape} out of range")
    check(bool(torch.isfinite(out["run"]["prompt_logits"]).all()),
          f"{what}: non-finite logits")
    _chains_on_kernels(counts, what, served_chains(info, weights != "tt"))
    check(not counts.get("frob_truncate") and info["compress_s"] is None,
          f"{what}: compressed ({counts})")
    check(info["ranks"] == {k: tuple(v) for k, v in rep["ranks"].items()},
          f"{what}: the checkpoint's ranks differ from the compression's")
    breakdown, peak = rep["breakdown"], rep["peak_bytes"]
    print(f"[chip_smoke] {arch} ({cfg.num_layers} layers) {weights}: "
          f"compressed in {rep['compress_s']:.3f}s (incl. the spectral "
          f"decay, a child process), peak device memory {peak:,} B, payload "
          f"ratio {info['payload_ratio']:.3f}; loaded in "
          f"{info['load_s']:.3f}s; decode {out['tok_per_s']:.2f} tok/s; "
          f"wall {wall:.1f}s; launches {counts}")
    print(f"[chip_smoke] {what} reference-oracle gate (reported): "
          f"max|d|/scale {ver['max_diff'] / ver['scale']:.4f} (bound 0.05)"
          + (f", tie-tolerant agreement {ver['tie_agree']:.4f} (gate 0.99)"
             if "tie_agree" in ver else ""))
    res = {"compress_s": rep["compress_s"], "breakdown": breakdown,
           "peak_bytes": peak, "wall_s": wall, "counts": counts,
           "compress_launches": rep["counts"],
           "ranks": {k: list(v) for k, v in info["ranks"].items()},
           "payload_ratio": info["payload_ratio"],
           "dense_bytes": info["dense_bytes"], "tt_bytes": info["tt_bytes"],
           "ttq_bytes": info.get("ttq_bytes"),
           "tok_per_s": out["tok_per_s"], "verify": ver,
           "served": {k: [v[0], [list(c) for c in v[1]]]
                      for k, v in info["chains"].items()}}
    res["kernels_vs_plain"] = kernels_vs_plain(serve_mod, out, what)
    if weights == "tt":
        print(f"[chip_smoke] {arch} compression, where the time goes "
              f"{json.dumps(breakdown)}")
        print(f"[chip_smoke] {arch} ranks: " + json.dumps(rep["ranks"]))
        print(f"[chip_smoke] {arch} bytes: {info['line']}")
        res["eps_worst"] = eps_gate(decayed_params(out["model"]),
                                    out["payload"], f"{arch}, full width")
        res["drivers_agree"] = drivers_agree(serve_mod, out, arch)
        res["f32_oracle"] = f32_oracle(serve_mod, out, arch)
    keep = {"model": out["model"], "params": out["params"],
            "payload": out["payload"], "info": info,
            "shapes": chain_shapes(info)}
    return res, keep


def big_kernels(ops, cases, res: dict, keep: dict, arch: str = BIG_ARCH,
                b: int = 1, eval_s: int = 0, tt_calls=None) -> None:
    """d, timed: qwen3-8b's (or ``arch``'s) stored chains at B in {1, 4,
    BIG_PREFILL_S} (``stored_phase``), and prefill at B = ``b``, S =
    BIG_PREFILL_S (``dense_forward``: eval at S = ``eval_s`` too, and
    ``tt_calls`` tt_apply calls a layer gated)."""
    res["chains"] = stored_phase(ops, cases, keep["shapes"], arch,
                                 batch_sizes=(1, 4))
    # timed at the prefill's rows too
    res["chains_prefill_rows"] = stored_phase(
        ops, cases, keep["shapes"], arch, batch_sizes=(BIG_PREFILL_S,),
        report_b=BIG_PREFILL_S)
    res["prefill"] = dense_forward(keep, arch, b, BIG_PREFILL_S,
                                   eval_s=eval_s, tt_calls=tt_calls)


# (JSON name, engine_cases kinds (timed first), source, TPU kernel, launch
# counters summed)
# ---------------------------------------------------------------------------
# Serving phase: sampler, Engine, router and HTTP front door
# ---------------------------------------------------------------------------

# known answers taken from the JAX package (jax 0.9, threefry partitionable)
JAX_KEY_42 = [0, 42]
JAX_FOLD_42_7 = [2547012911, 1371500959]
JAX_SLOT_KEYS_5 = [[2724472204, 3573582090], [202567368, 3886822060],
                   [3594430910, 1784718894]]
JAX_BITS_0_1 = [31327077, 89727312, 2497208264, 1554082365, 957939715,
                512339923]
JAX_BITS_0_1_LAST = [224656000, 2771682342, 947058821]   # of a (151936,) draw
JAX_CATEGORICAL_9 = [63, 7, 47, 63]       # categorical, slot_keys(9, 4)
JAX_TOKENS_9 = [63, 23, 36, 63]           # sample_tokens, temp 0.7, top-k 16
CHI2_DRAWS, CHI2_V, CHI2_TEMP, CHI2_K = 65_536, 64, 0.7, 16
SERVE_SLOTS, SERVE_CHUNK = 4, 8
SERVE_MAX_LEN = 64                        # prompts 3-32 + gens 4-32
AGREE_REQS = 2                            # bf16 / int8: isolated runs kept


def serve_stream(vocab: int, n: int = 12, seed: int = 22, plen=(3, 33),
                 gen=(4, 33)):
    """A request stream: prompts of 3-32 tokens and gens of 4-32 (by
    default), every second request sampled (its temperature and top-k from
    a small table), request i under seed i."""
    rng = np.random.default_rng(seed)
    table = [(0.7, None), (1.0, 16), (0.9, 64)]
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(*plen)), np.int32)
        t, k = (0.0, None) if i % 2 == 0 else table[(i // 2) % len(table)]
        out.append({"prompt": p, "gen": int(rng.integers(*gen)), "seed": i,
                    "temperature": t, "top_k": k})
    return out


def sampler_phase() -> dict:
    """9a: threefry keys and bits, and sampled tokens, on the card against
    the port on the CPU and against known answers from the JAX package;
    a χ² test of 65,536 draws."""
    from repro_torch import prng
    from repro_torch.models import common
    rec = {}
    for dev in ("cpu", DEVICE):
        k0 = prng.fold_in(prng.PRNGKey(0, device=dev), 1)
        keys = common.slot_keys(9, 4, device=dev)
        lg = torch.from_numpy((np.arange(64) % 13 * 0.37).astype(
            np.float32)[None].repeat(4, 0)).to(dev)
        rec[dev] = {
            "key": prng.PRNGKey(42, device=dev).tolist(),
            "fold": prng.fold_in(prng.PRNGKey(42, device=dev), 7).tolist(),
            "slot_keys": common.slot_keys(5, 3, device=dev).tolist(),
            "bits": prng.random_bits(k0, (151_936,)).cpu(),
            "cat": prng.categorical(keys, lg).tolist(),
            "tok": common.sample_tokens(lg, keys, common.Sampling(
                CHI2_TEMP, CHI2_K)).tolist()}
    gpu, cpu = rec[DEVICE], rec["cpu"]
    known = (gpu["key"] == JAX_KEY_42 and gpu["fold"] == JAX_FOLD_42_7
             and gpu["slot_keys"] == JAX_SLOT_KEYS_5
             and gpu["bits"][:6].tolist() == JAX_BITS_0_1
             and gpu["bits"][-3:].tolist() == JAX_BITS_0_1_LAST
             and gpu["cat"] == JAX_CATEGORICAL_9
             and gpu["tok"] == JAX_TOKENS_9)
    same = all(torch.equal(gpu[k], cpu[k]) if k == "bits" else gpu[k] == cpu[k]
               for k in gpu)
    check(known, "sampler: card keys/bits/tokens differ from the JAX answers")
    check(same, "sampler: card keys/bits/tokens differ from the CPU's")

    # identical logits, mixed per-slot params, 32 steps: card vs CPU tokens
    b, v, steps = 8, 151_936, 16
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn((b, v), generator=gen) * 3.0
    temp = torch.tensor([0.0, 0.7, 1.0, 1.3, 0.9, 0.5, 1.1, 0.8])
    topk = torch.tensor([0, 0, 16, 64, 1, 0, 512, 40])
    base = common.slot_keys(11, b)
    mismatches = []
    t0 = time.perf_counter()
    for step in range(steps):
        keys = prng.fold_in(base, step)
        want = common.sample_tokens_per_slot(logits, keys, temp, topk)
        got = common.sample_tokens_per_slot(
            logits.to(DEVICE), keys.to(DEVICE), temp.to(DEVICE),
            topk.to(DEVICE)).cpu()
        for r in torch.nonzero(got != want).flatten().tolist():
            # a mismatch is a near-tie: the two tokens' perturbed scores
            # on the CPU within the Gumbel noise's few-ulp gap
            g = prng.gumbel(keys[r], (v,)) + logits[r] / temp[r]
            a, c = float(g[want[r]]), float(g[got[r]])
            gap = abs(a - c)
            ok = gap <= 4 * 2.0 ** -23 * max(abs(a), 1.0)
            mismatches.append({"step": step, "row": r, "cpu": int(want[r]),
                               "card": int(got[r]), "gap": gap,
                               "near_tie": ok})
            print(f"[chip_smoke] sampler mismatch step {step} row {r}: cpu "
                  f"{int(want[r])} card {int(got[r])} score gap {gap:.3e} "
                  f"({'near-tie' if ok else 'NOT a near-tie'})")
            check(ok, f"sampler: card token {int(got[r])} vs cpu "
                      f"{int(want[r])} is no near-tie (gap {gap:.3e})")
    torch.cuda.synchronize()
    per_step_ms = (time.perf_counter() - t0) / steps * 1e3

    # chi-squared: 65,536 rows of one 64-way distribution, one key each
    from scipy import stats
    row = torch.linspace(-2.0, 2.0, CHI2_V)
    x = row[None].repeat(CHI2_DRAWS, 1).to(DEVICE)
    keys = common.slot_keys(17, CHI2_DRAWS, device=DEVICE)
    toks = common.sample_tokens(x, keys, common.Sampling(CHI2_TEMP, CHI2_K))
    counts = torch.bincount(toks, minlength=CHI2_V).cpu().double()
    top = torch.topk(row, CHI2_K).indices
    outside = int(counts.sum() - counts[top].sum())
    p = torch.softmax(row[top].double() / CHI2_TEMP, dim=0)
    chi2, pval = stats.chisquare(counts[top].numpy(),
                                 (p * CHI2_DRAWS).numpy())
    check(outside == 0, f"sampler: {outside} draws outside the top {CHI2_K}")
    check(pval > 1e-3, f"sampler: chi-squared p-value {pval:.3e} <= 1e-3")
    res = {"known_answers": known, "card_equals_cpu": same,
           "token_rows": b * steps, "mismatches": mismatches,
           "per_slot_step_ms": per_step_ms, "chi2": float(chi2),
           "chi2_p": float(pval), "outside_top_k": outside}
    print(f"[chip_smoke] sampler: JAX answers {known}, card == CPU keys and "
          f"bits {same}; {b * steps} sampled rows, {len(mismatches)} "
          f"mismatches; {CHI2_DRAWS} draws at temp {CHI2_TEMP}, top-k "
          f"{CHI2_K}: chi2 {chi2:.2f}, p {pval:.4f}, {outside} outside the "
          f"top {CHI2_K}")
    return res


class _NoSyncSteps:
    """Wrap ``engine._run_steps`` in ``torch.cuda.set_sync_debug_mode
    ("error")``: a device-to-host read or a host sync inside a chunk
    raises.  Counts the chunks it saw."""

    def __init__(self, engine_mod):
        self.mod, self.orig, self.chunks = engine_mod, engine_mod._run_steps, 0

    def __enter__(self):
        def wrapped(*a, **k):
            self.chunks += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return self.orig(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.mod._run_steps = wrapped
        return self

    def __exit__(self, *exc):
        self.mod._run_steps = self.orig


def engine_stream(engine_mod, model, params, stream, admission: str,
                  no_sync: bool = False, max_len: int = SERVE_MAX_LEN
                  ) -> dict:
    """One ``Engine`` (SERVE_SLOTS slots, SERVE_CHUNK steps a chunk, caches
    of ``max_len`` positions) over ``stream`` (a request's ``"src"``, when
    it has one, is its encoder input); launch counts over exactly its
    run."""
    eng = engine_mod.Engine(model, params, slots=SERVE_SLOTS,
                            max_len=max_len, chunk_steps=SERVE_CHUNK,
                            admission=admission)
    uids = [eng.submit(r["prompt"], r["gen"], seed=r["seed"],
                       temperature=r["temperature"], top_k=r["top_k"],
                       src_tokens=r.get("src"))
            for r in stream]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if no_sync:
        with _NoSyncSteps(engine_mod) as guard:
            done = {c.uid: c for c in eng.run()}
    else:
        done = {c.uid: c for c in eng.run()}
    wall = time.perf_counter() - t0
    counts = read_counts()
    reset_counts()
    comps = [done[u] for u in uids]
    return {"comps": comps, "wall_s": wall, "counts": counts,
            "steps": eng.steps, "occupancy": eng.occupancy,
            "tok_per_s": sum(r["gen"] for r in stream) / wall,
            "chunks_no_sync": guard.chunks if no_sync else 0}


def isolated_runs(engine_mod, model, params, stream) -> list:
    return [engine_mod.generate(
        model, params, r["prompt"][None], r["gen"], seed=r["seed"],
        temperature=r["temperature"], top_k=r["top_k"])["gen"][0]
        for r in stream]


def _chains_on_kernels(counts, what: str, kernels) -> None:
    check(counts.get("plain_chains", 0) == 0,
          f"{what}: {counts.get('plain_chains')} chains took the plain path")
    for k in kernels:
        check(counts.get(k, 0) > 0, f"{what}: kernel {k} never launched")
    check_no_plain(counts, what)


def engine_phase(engine_mod, main_out) -> dict:
    """9b: the Engine on full-width qwen1.5-0.5b.  Gated in float32
    (TT-native params with float32 cores, the F32 gates' params): every
    completion equal to its isolated ``generate`` run, scan == boundary
    byte for byte, every chain on a kernel, no host sync inside a chunk.
    Then bf16 ``tt`` and ``tt-int8`` (as served) on the same stream:
    tok/s, occupancy and the agreement of the first AGREE_REQS requests
    with their isolated runs, reported."""
    from repro_torch.core import tt_linear as ttl
    model = main_out["model"]
    stream = serve_stream(model.cfg.vocab_size)
    m32 = _f32_model(model, DEVICE)
    tt32, _ = f32_params(main_out["payload"], model.cfg.family)
    iso = isolated_runs(engine_mod, m32, tt32, stream)
    res = {"requests": len(stream),
           "tokens": sum(r["gen"] for r in stream)}
    runs = {}
    for admission in ("scan", "boundary"):
        r = engine_stream(engine_mod, m32, tt32, stream, admission,
                          no_sync=True)
        runs[admission] = r
        bad = [i for i, (c, t) in enumerate(zip(r["comps"], iso))
               if not np.array_equal(c.tokens, t)]
        check(not bad, f"engine f32 {admission}: requests {bad} differ "
                       f"from their isolated runs")
        _chains_on_kernels(r["counts"], f"engine f32 {admission}",
                           ("tt_contract_2", "tt_contract_3"))
        res[f"f32_{admission}"] = {
            "equal_isolated": len(stream) - len(bad), "steps": r["steps"],
            "occupancy": r["occupancy"], "tok_per_s": r["tok_per_s"],
            "wall_s": r["wall_s"], "chunks_no_sync": r["chunks_no_sync"],
            "launches": r["counts"]}
        print(f"[chip_smoke] engine f32 {admission}: {len(stream) - len(bad)}"
              f"/{len(stream)} equal to isolated, {r['steps']} steps, "
              f"occupancy {r['occupancy']:.3f}, {r['tok_per_s']:.1f} tok/s, "
              f"{r['chunks_no_sync']} chunks under sync-debug 'error', "
              f"launches {r['counts']}")
    same = all(np.array_equal(a.tokens, b.tokens)
               and np.array_equal(a.prompt_logits, b.prompt_logits)
               for a, b in zip(runs["scan"]["comps"],
                               runs["boundary"]["comps"]))
    check(same, "engine f32: scan and boundary admission differ")
    res["scan_equals_boundary"] = same
    del tt32
    torch.cuda.empty_cache()
    params = main_out["params"]
    for what, p in (("tt", params), ("tt-int8", ttl.quantize_tt_tree(
            params, dtype=ttl.quant_dtype("int8")))):
        r = engine_stream(engine_mod, model, p, stream, "scan")
        iso = isolated_runs(engine_mod, model, p, stream[:AGREE_REQS])
        agree = sum(np.array_equal(c.tokens, t)
                    for c, t in zip(r["comps"], iso))
        _chains_on_kernels(r["counts"], f"engine {what}", (
            ("tt_contract_2", "tt_contract_3") if what == "tt"
            else ("tt_contract_2q", "tt_contract_3q")))
        res[what] = {"tok_per_s": r["tok_per_s"], "occupancy": r["occupancy"],
                     "steps": r["steps"], "wall_s": r["wall_s"],
                     "equal_isolated": f"{agree}/{AGREE_REQS}"}
        print(f"[chip_smoke] engine {what} (bf16 activations): "
              f"{r['tok_per_s']:.1f} tok/s, occupancy {r['occupancy']:.3f}, "
              f"{r['steps']} steps in {r['wall_s']:.2f}s; first "
              f"{AGREE_REQS} requests equal to isolated: {agree}/"
              f"{AGREE_REQS} (reported)")
    return res


def hybrid_engine(engine_mod, out) -> dict:
    """9c: recurrentgemma-2b (the hybrid phase's checkpoint, float32
    TT-native params) through the Engine: staggered == isolated, gated."""
    stream = serve_stream(out["model"].cfg.vocab_size, n=6, seed=23,
                          plen=(3, 13), gen=(4, 13))
    m32 = _f32_model(out["model"], DEVICE)
    tt32, _ = f32_params(out["payload"], "hybrid")
    iso = isolated_runs(engine_mod, m32, tt32, stream)
    r = engine_stream(engine_mod, m32, tt32, stream, "scan")
    bad = [i for i, (c, t) in enumerate(zip(r["comps"], iso))
           if not np.array_equal(c.tokens, t)]
    check(not bad, f"hybrid engine: requests {bad} differ from their "
                   f"isolated runs")
    _chains_on_kernels(r["counts"], "hybrid engine",
                       ("tt_contract_2", "tt_contract_3"))
    print(f"[chip_smoke] hybrid engine f32 ({HYBRID_LAYERS} layers): "
          f"{len(stream) - len(bad)}/{len(stream)} equal to isolated, "
          f"{r['steps']} steps, occupancy {r['occupancy']:.3f}, "
          f"{r['tok_per_s']:.1f} tok/s")
    return {"equal_isolated": len(stream) - len(bad), "steps": r["steps"],
            "occupancy": r["occupancy"], "tok_per_s": r["tok_per_s"]}


def _http(port, method, path, body=None, timeout=300):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, None if body is None else json.dumps(body))
    resp = conn.getresponse()
    out = (resp.status, resp.read(), resp.getheader("Content-Type"))
    conn.close()
    return out


def _sse_tokens(raw: bytes):
    deltas, done = [], None
    for block in raw.decode().strip().split("\n\n"):
        lines = block.split("\n")
        event = [ln[7:] for ln in lines if ln.startswith("event: ")]
        data = [json.loads(ln[6:]) for ln in lines if ln.startswith("data: ")]
        if event and event[0] == "done":
            done = data[0]["tokens"]
        elif data:
            deltas.extend(data[0].get("tokens", []))
    return deltas, done


def _park(port, body):
    import socket
    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    data = json.dumps(body).encode()
    sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\nContent-Length: "
                 + str(len(data)).encode() + b"\r\n\r\n" + data)
    return sock


def server_phase(serve_mod, ckpt_dir: str) -> dict:
    """9d: ``serve --serve --weights tt --tt-checkpoint`` (the main path's
    checkpoint, 2 replicas x 4 slots, queue depth 6) through
    ``make_router`` behind ``serve_in_thread`` on an ephemeral port; over
    HTTP: 8 JSON and 2 SSE requests (their tokens equal to isolated runs),
    a 504 on a 1 ms deadline and the next request served, a 429 past the
    queue depth, and dropped connections that free their slots."""
    import threading

    from repro_torch.launch.server import serve_in_thread
    args = serve_mod.parse_args(SERVE_ARGS + [
        "--weights", "tt", "--tt-checkpoint", ckpt_dir, "--serve",
        "--replicas", "2", "--slots", "4", "--chunk-steps", "8",
        "--queue-depth", "6", "--prompt-len", "32", "--gen", "32",
        "--port", "0"])
    t0 = time.perf_counter()
    router, model, params = serve_mod.make_router(args)
    server, shutdown = serve_in_thread(router, port=args.port)
    setup_s = time.perf_counter() - t0
    res = {"setup_s": setup_s}
    try:
        stream = serve_stream(model.cfg.vocab_size, n=10, seed=24,
                              gen=(4, 25))
        replies = [None] * len(stream)

        def post(i):
            r = stream[i]
            body = {"prompt": r["prompt"].tolist(), "gen": r["gen"],
                    "seed": r["seed"], "temperature": r["temperature"],
                    "top_k": r["top_k"], "stream": i >= 8}
            replies[i] = _http(server.port, "POST", "/v1/generate", body)

        t1 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(stream))]
        for i, t in enumerate(threads):
            t.start()
            if i == 7:          # the 8 JSON requests fill the 2 x 4 slots,
                time.sleep(0.5)  # the 2 SSE ones wait in the queues
        for t in threads:
            t.join()
        http_s = time.perf_counter() - t1
        iso = isolated_runs(serve_mod.engine_mod, model, params, stream)
        equal = 0
        for i, ((status, raw, ctype), want) in enumerate(zip(replies, iso)):
            if i < 8:
                got = (json.loads(raw)["tokens"] if status == 200 else None)
                ok = status == 200 and got == want.tolist()
            else:
                deltas, done = _sse_tokens(raw)
                ok = (status == 200 and ctype == "text/event-stream"
                      and deltas == done == want.tolist())
            equal += ok
            check(ok, f"server: request {i} ({'SSE' if i >= 8 else 'JSON'}) "
                      f"status {status}, tokens differ from the isolated run")
        res.update(requests=len(stream), equal_isolated=equal, http_s=http_s,
                   tokens=sum(r["gen"] for r in stream))
        # a 504 on a deadline already past, then the server serves again
        p = stream[0]["prompt"].tolist()
        s504, raw, _ = _http(server.port, "POST", "/v1/generate",
                             {"prompt": p, "gen": 24, "deadline_ms": 1})
        s200, raw2, _ = _http(server.port, "POST", "/v1/generate",
                              {"prompt": p, "gen": 4, "seed": 3})
        after = (s200 == 200 and json.loads(raw2)["tokens"] == isolated_runs(
            serve_mod.engine_mod, model, params,
            [{"prompt": np.asarray(p, np.int32), "gen": 4, "seed": 3,
              "temperature": 0.0, "top_k": None}])[0].tolist())
        check(s504 == 504, f"server: deadline gave {s504}, not 504")
        check(after, f"server: after the 504 the next request gave {s200} "
                     f"or tokens differ")
        # fill 2 replicas x queue depth 6 with long streams, then one more
        socks = [_park(server.port, {"prompt": p[:3], "gen": 60,
                                     "stream": True}) for _ in range(12)]
        t2 = time.monotonic()
        while (sum(r["outstanding"] for r in router.stats()["replicas"]) < 12
               and time.monotonic() - t2 < 30):
            time.sleep(0.01)
        s429, _, _ = _http(server.port, "POST", "/v1/generate",
                           {"prompt": p[:3], "gen": 4})
        check(s429 == 429, f"server: past the queue depth gave {s429}, "
                           f"not 429")
        for s in socks:            # every client walks away mid-stream
            s.close()
        t2 = time.monotonic()
        while time.monotonic() - t2 < 60:
            st = router.stats()["replicas"]
            if all(r["outstanding"] == 0 and r["busy_slots"] == 0
                   for r in st):
                break
            time.sleep(0.05)
        st = router.stats()["replicas"]
        freed = all(r["outstanding"] == 0 and r["busy_slots"] == 0
                    for r in st)
        check(freed, f"server: dropped connections left {st}")
        health = json.loads(_http(server.port, "GET", "/healthz")[1])
        check(health["status"] == "ok", f"server: /healthz says {health}")
        res.update(status_504=s504, after_504=after, status_429=s429,
                   disconnect_freed=freed,
                   replica_steps=[r["steps"] for r in st],
                   occupancy=[r["occupancy"] for r in st])
        print(f"[chip_smoke] server (2 replicas x 4 slots, queue depth 6, "
              f"setup {setup_s:.1f}s): {equal}/{len(stream)} replies (8 "
              f"JSON, 2 SSE) equal to isolated runs in {http_s:.2f}s; 504 "
              f"{s504}, then {s200}; 429 {s429}; 12 dropped streams freed "
              f"their slots: {freed}; replica steps "
              f"{[r['steps'] for r in st]}")
    finally:
        shutdown()
    return res


# ---------------------------------------------------------------------------
# Encoder-decoder phase: full-width seamless-m4t-large-v2
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_LAYERS = 12       # encoder and decoder layers served, of 24 each
ENCDEC_SERVE_ARGS = ["--arch", ENCDEC_ARCH, "--layers", str(ENCDEC_LAYERS),
                     "--batch", "4", "--prompt-len", "16", "--gen", "16",
                     "--seed", "0", "--tt-eps", "0.2"]
ENCDEC_B, ENCDEC_S = 2, 1024     # prefill: 1,024 frames and 1,024 tokens
ENCDEC_SRC = (16, 257)           # Engine requests' source lengths


def child_checkpoint_checks(out, rep: dict, what: str):
    """A run served from a child's checkpoint: every leaf loaded equal bit
    for bit to the payload the child compressed (``leaf_digests``), and a
    copy with a flipped byte refused.  Returns (equal, leaves, what the
    flipped copy raised)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    digests = leaf_digests(out["payload"])
    same = bool(digests) and digests == rep.get("leaf_sha")
    check(same, f"{what} checkpoint: loaded leaves differ from the payload "
                f"the child compressed")
    flipped = rep["ckpt"] + "-flipped"
    shutil.copytree(rep["ckpt"], flipped)
    flip_byte(flipped)
    try:
        ckpt.load_tt_payload(flipped, like=out["payload"], device=DEVICE)
        raised = "nothing"
    except ckpt.CheckpointCorrupt as e:
        raised = f"CheckpointCorrupt: {e}"
    shutil.rmtree(flipped)
    check(raised.startswith("CheckpointCorrupt"),
          f"{what} checkpoint: a flipped byte raised {raised}")
    return same, len(digests), raised


def encdec_serve(serve_mod, rep: dict) -> dict:
    """10a: ``serve --weights tt --tt-checkpoint`` from the child's
    checkpoint (no compression): every leaf loaded equal bit for bit to
    the payload the child compressed (``leaf_digests``), a flipped byte
    refused, chain kernels launched with no plain call, the sources
    encoded; the bf16 verify against reconstruct-then-serve reported."""
    args = serve_mod.parse_args(ENCDEC_SERVE_ARGS + [
        "--weights", "tt", "--tt-checkpoint", rep["ckpt"]])
    out, secs, counts = _counted(lambda: serve_mod.serve(args))
    _chains_on_kernels(counts, "encdec serve",
                       ("tt_contract_2", "tt_contract_3"))
    check(not counts.get("frob_truncate")
          and out["info"]["compress_s"] is None,
          f"encdec serve: compressed ({counts})")
    same, leaves, raised = child_checkpoint_checks(out, rep, "encdec")
    cfg, info = out["model"].cfg, out["info"]
    check(out["src"].shape == (4, cfg.frontend_len)
          and out["generated"].shape == (4, 16),
          f"encdec serve: sources {out['src'].shape}, tokens "
          f"{out['generated'].shape}")
    res = {"serve_s": secs, "tok_per_s": out["tok_per_s"],
           "checkpoint_equal": same, "leaves": leaves,
           "flipped": raised[:90], "verify": out["verify"],
           "launches": counts, "dense_bytes": info["dense_bytes"],
           "tt_bytes": info["tt_bytes"], "payload_ratio": info["payload_ratio"],
           "layers": [cfg.enc_layers, cfg.num_layers]}
    print(f"[chip_smoke] {ENCDEC_ARCH} ({cfg.enc_layers} + {cfg.num_layers} "
          f"layers) served from its checkpoint in {secs:.1f}s: {leaves} "
          f"leaves equal to the child's payload: {same}; flipped byte -> "
          f"{raised[:60]}; decode {out['tok_per_s']:.1f} tok/s; bf16 verify "
          f"(reported) {json.dumps(out['verify'])}; launches {counts}")
    print(f"[chip_smoke] {ENCDEC_ARCH} ranks: " + json.dumps(
        {k: list(v) for k, v in info["ranks"].items()}))
    print(f"[chip_smoke] {ENCDEC_ARCH} bytes: {info['line']}")
    return {"out": out, "summary": res}


def _encdec_batch(cfg, b: int, s: int, seed: int = 2) -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    frames = torch.randn((b, cfg.frontend_len, cfg.d_model), generator=g,
                         device=DEVICE)
    toks = _tokens(cfg.vocab_size, b, s, seed=seed)
    return {"frames": frames, "tokens": toks,
            "labels": torch.roll(toks, -1, 1)}


def _flash_counts(counts, what: str, route, layers: int) -> None:
    """Exactly ``layers`` flash launches, all on ``route`` (None: none)."""
    n = counts.get("flash_attention", 0)
    want = 0 if route is None else layers
    check(n == want and (route is None or counts.get(route, 0) == layers),
          f"{what}: {n} flash launches ({counts}), want {want}"
          + ("" if route is None else f" on {route}"))


def encdec_prefill(served: dict) -> dict:
    """10b: prefill and eval through ``make_prefill_step`` /
    ``make_eval_step`` at B = 2 with ``ENCDEC_S`` memory frames and
    decoder tokens.  bf16 (the served TT-native weights) under both impls:
    tok/s, the decoder's flash launches (one a decoder layer under
    ``"pallas"``, on the mma route; none under ``"xla"``, none in the
    encoder), the chains on their kernels, the impls' gap reported.
    Float32 (the payload's TT-native params with float32 cores): TT-native
    pallas vs xla and TT-native vs reconstruct-then-prefill within F32_TOL
    of scale, every flash launch on the 3xTF32 route; eval at B = 1
    under both impls, losses within 1e-5 relative.  Returns the record and
    the float32 (model, params) for the memory and Engine checks."""
    from repro_torch.train.steps import make_eval_step, make_prefill_step
    out = served["out"]
    model, params = out["model"], out["params"]
    cfg = model.cfg
    layers = cfg.num_layers
    batch = _encdec_batch(cfg, ENCDEC_B, ENCDEC_S)
    res = {"tok_per_s": {}, "counts": {}}
    chains = ("tt_contract_2", "tt_contract_3")
    lg = {}
    for impl in ("pallas", "xla"):
        step = make_prefill_step(model, impl=impl)
        bb = {k: batch[k] for k in ("frames", "tokens")}
        bb["frames"] = bb["frames"].bfloat16()
        step(params, bb)                                  # warm-up
        lg[impl], secs, counts = _counted(lambda: step(params, bb))
        check(lg[impl].shape == (ENCDEC_B, cfg.vocab_size)
              and bool(torch.isfinite(lg[impl]).all()),
              f"encdec prefill bf16 {impl}: logits not finite")
        _prefill_counts(counts, f"encdec prefill bf16 {impl}", chains,
                        flash=True)
        _flash_counts(counts, f"encdec prefill bf16 {impl}",
                      "flash_attention_mma" if impl == "pallas" else None,
                      layers)
        res["tok_per_s"][impl] = ENCDEC_B * ENCDEC_S / secs
        res["counts"][f"bf16/{impl}"] = counts
        print(f"[chip_smoke] encdec prefill bf16 tt impl={impl}: B="
              f"{ENCDEC_B}, {cfg.frontend_len} frames + {ENCDEC_S} tokens "
              f"in {secs:.3f}s = {ENCDEC_B * ENCDEC_S / secs:.0f} decoder "
              f"tok/s; launches {counts}")
    d, scale = _gap(lg["pallas"], lg["xla"])
    res["bf16_pallas_vs_xla"] = d / scale
    b1 = {k: v[:1] for k, v in batch.items()}
    b1["frames"] = b1["frames"].bfloat16()
    res["bf16_eval_loss"] = {
        impl: float(make_eval_step(model, impl=impl)(params, b1)["loss"])
        for impl in ("pallas", "xla")}
    print(f"[chip_smoke] encdec bf16 (reported): prefill pallas vs xla "
          f"max|d|/scale {d / scale:.3e}; eval B=1 losses "
          f"{json.dumps(res['bf16_eval_loss'])}")
    del lg
    m32 = _f32_model(model, DEVICE)
    tt32, rx32 = f32_params(out["payload"], "encdec")
    f32 = {}
    for name, p, impl in (("tt/pallas", tt32, "pallas"),
                          ("tt/xla", tt32, "xla"),
                          ("rx/xla", rx32, "xla")):
        step = make_prefill_step(m32, impl=impl)
        bb = {k: batch[k] for k in ("frames", "tokens")}
        f32[name], secs, counts = _counted(lambda: step(p, bb))
        if name.startswith("tt"):
            _prefill_counts(counts, f"encdec prefill f32 {name}", chains,
                            flash=True)
        else:
            check_no_plain(counts, f"encdec prefill f32 {name}")
        _flash_counts(counts, f"encdec prefill f32 {name}",
                      "flash_attention_f32" if impl == "pallas" else None,
                      layers)
        res["counts"][f"f32/{name}"] = counts
    for what, a, b in (("pallas vs xla (TT-native)", "tt/pallas", "tt/xla"),
                       ("TT-native vs reconstruct", "tt/xla", "rx/xla")):
        d, scale = _gap(f32[a], f32[b])
        check(d <= F32_TOL * scale,
              f"encdec f32 {what}: max|d| {d:.3e} over {F32_TOL} * scale "
              f"{scale:.3e}")
        res[f"f32 {what}"] = d / scale
        print(f"[chip_smoke] encdec prefill f32 {what}: max|d|/scale "
              f"{d / scale:.3e} (gate {F32_TOL})")
    del f32, rx32
    b1 = {k: v[:1] for k, v in batch.items()}
    loss = {impl: float(make_eval_step(m32, impl=impl)(tt32, b1)["loss"])
            for impl in ("pallas", "xla")}
    rel = abs(loss["pallas"] - loss["xla"]) / abs(loss["xla"])
    check(math.isfinite(loss["xla"]) and rel <= 1e-5,
          f"encdec eval f32: losses {loss} differ by {rel:.3e} relative")
    res["f32_eval_loss"], res["f32_eval_rel"] = loss, rel
    print(f"[chip_smoke] encdec eval f32 TT-native B=1: losses "
          f"{json.dumps(loss)}, {rel:.3e} relative (gate 1e-5)")
    torch.cuda.empty_cache()
    return res, m32, tt32


def encdec_memory(m32, tt32) -> dict:
    """10c, float32: ``populate_memory`` of 4 sources of 256 tokens against
    ``admit_memory`` of each into its own slot (within F32_TOL of scale;
    bit-equality reported); a slot with a source decodes otherwise than
    one with none (the same tokens, ``mem_len`` 0)."""
    from repro_torch.models import encdec
    cfg = m32.cfg
    rng = np.random.default_rng(26)
    n = min(256, cfg.frontend_len)
    src = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, n)),
                          dtype=torch.int64, device=DEVICE)
    with torch.inference_mode():
        full = encdec.populate_memory(tt32, m32.init_cache(4, 8), src, cfg)
        slots = m32.init_cache(4, 8)
        slots.mem_len.fill_(0)
        for i in (3, 1, 0, 2):
            encdec.admit_memory(tt32, slots, i, src[i], cfg)
        gaps = [_gap(getattr(slots, f), getattr(full, f))
                for f in ("mem_k", "mem_v")]
        bitwise = all(torch.equal(getattr(slots, f), getattr(full, f))
                      for f in ("mem_k", "mem_v", "mem_len"))
        d = max(g[0] / g[1] for g in gaps)
        check(d <= F32_TOL and slots.mem_len.tolist() == [n] * 4,
              f"encdec memory: admit vs populate max|d|/scale {d:.3e}, "
              f"mem_len {slots.mem_len.tolist()}")
        # slot 0 keeps its memory, slot 1 none: same tokens, 4 steps
        slots.mem_len[1].fill_(0)
        tok = _tokens(cfg.vocab_size, 1, 4, seed=3).expand(4, 4)
        for t in range(4):
            logits, slots = m32.decode_step(tt32, slots, tok[:, t:t + 1])
        dd, scale = _gap(logits[0], logits[1])
    check(dd > 1e-2 * scale, f"encdec memory: a slot with a source decodes "
                             f"as one with none (max|d| {dd:.3e})")
    print(f"[chip_smoke] encdec memory f32: admit_memory vs populate_memory "
          f"max|d|/scale {d:.3e} (bit-equal: {bitwise}); with a source vs "
          f"none after 4 steps max|d|/scale {dd / scale:.3e}")
    return {"admit_vs_populate": d, "bitwise": bitwise,
            "with_vs_without": dd / scale}


def encdec_engine(engine_mod, served: dict, m32, tt32) -> dict:
    """10d: the Engine (SERVE_SLOTS slots, boundary admission: the source
    encoded at admission) on 8 requests with sources of 16-256 tokens and
    a token-only one that recycles a slot.  Float32: every completion's
    tokens equal to its isolated ``generate(src_tokens=...)`` run's bit
    for bit and its prompt logits within F32_TOL of scale (bit-equality
    reported; the recycled slot's also within 1e-3 of scale, the
    reference's stale-memory bound), every chain on a kernel, no host
    sync inside a chunk, scan admission refused.  Then bf16 ``tt`` (as served): tok/s, and the first
    AGREE_REQS requests against their isolated runs, reported."""
    cfg = m32.cfg
    stream = serve_stream(cfg.vocab_size, n=9, seed=25, plen=(3, 17),
                          gen=(4, 17))
    rng = np.random.default_rng(27)
    hi = min(ENCDEC_SRC[1], cfg.frontend_len + 1)
    for r in stream[:8]:
        r["src"] = rng.integers(0, cfg.vocab_size, int(rng.integers(
            min(ENCDEC_SRC[0], hi - 1), hi)), np.int32)

    def isolated(model, params, reqs):
        return [engine_mod.generate(
            model, params, r["prompt"][None], r["gen"], max_len=SERVE_MAX_LEN,
            seed=r["seed"], temperature=r["temperature"], top_k=r["top_k"],
            src_tokens=None if r.get("src") is None else r["src"][None])
            for r in reqs]

    iso = isolated(m32, tt32, stream)
    r = engine_stream(engine_mod, m32, tt32, stream, "auto", no_sync=True)
    bad = [i for i, (c, t) in enumerate(zip(r["comps"], iso))
           if not np.array_equal(c.tokens, t["gen"][0])]
    # prompt logits: a pooled row's rms_norm may round otherwise than the
    # same row alone (the reduction picks its split by the row count), so
    # they are held to F32_TOL of scale and their bit-equality reported
    gaps = [_gap(torch.from_numpy(c.prompt_logits),
                 t["prompt_logits"][0].cpu())
            for c, t in zip(r["comps"], iso)]
    logit_gap = max(d / sc for d, sc in gaps)
    bitwise = sum(d == 0.0 for d, _ in gaps)
    check(not bad, f"encdec engine f32: requests {bad} differ from their "
                   f"isolated runs' tokens")
    check(logit_gap <= F32_TOL, f"encdec engine f32: prompt logits "
                                f"max|d|/scale {logit_gap:.3e}")
    last = r["comps"][-1].prompt_logits
    want = iso[-1]["prompt_logits"][0].cpu().numpy()
    stale = float(np.abs(last - want).max())
    check(stale <= 1e-3 * float(np.abs(want).max()) + 1e-5,
          f"encdec engine: the recycled slot's logits moved by {stale:.3e}")
    _chains_on_kernels(r["counts"], "encdec engine f32",
                       ("tt_contract_2", "tt_contract_3"))
    refused = False
    try:
        engine_mod.Engine(m32, tt32, slots=2, max_len=8, admission="scan")
    except ValueError:
        refused = True
    check(refused, "encdec engine: scan admission was not refused")
    res = {"requests": len(stream), "equal_isolated": len(stream) - len(bad),
           "logits_bitwise": bitwise, "logit_gap": logit_gap,
           "recycled_gap": stale, "scan_refused": refused,
           "steps": r["steps"], "occupancy": r["occupancy"],
           "tok_per_s": r["tok_per_s"], "wall_s": r["wall_s"],
           "chunks_no_sync": r["chunks_no_sync"], "launches": r["counts"]}
    print(f"[chip_smoke] encdec engine f32 (boundary): tokens of "
          f"{res['equal_isolated']}/{len(stream)} equal to their isolated "
          f"runs bit for bit, prompt logits max|d|/scale {logit_gap:.3e} "
          f"({bitwise}/{len(stream)} bit-equal), recycled slot "
          f"max|d| {stale:.3e}, {r['steps']} steps, occupancy "
          f"{r['occupancy']:.3f}, {r['tok_per_s']:.1f} tok/s, "
          f"{r['chunks_no_sync']} chunks under sync-debug 'error', scan "
          f"refused: {refused}; launches {r['counts']}")
    out = served["out"]
    r = engine_stream(engine_mod, out["model"], out["params"], stream, "auto")
    iso = isolated(out["model"], out["params"], stream[:AGREE_REQS])
    agree = sum(np.array_equal(c.tokens, t["gen"][0])
                for c, t in zip(r["comps"], iso))
    res["tt"] = {"tok_per_s": r["tok_per_s"], "occupancy": r["occupancy"],
                 "steps": r["steps"], "wall_s": r["wall_s"],
                 "equal_isolated": f"{agree}/{AGREE_REQS}"}
    print(f"[chip_smoke] encdec engine tt (bf16 activations): "
          f"{r['tok_per_s']:.1f} tok/s, occupancy {r['occupancy']:.3f}, "
          f"{r['steps']} steps in {r['wall_s']:.2f}s; first {AGREE_REQS} "
          f"requests equal to isolated: {agree}/{AGREE_REQS} (reported)")
    return res


def encdec_flash() -> dict:
    """10e: the flash kernel at the decoder's shape
    (``cases.ENCDEC_SHAPE``) against its plain version in both routes
    (float32 at TOL of max|ref| and within ``cases.F64_REL`` of float64;
    bf16 at 2e-2 and per element against ``mha_tiled``), timed beside
    SDPA and its bound."""
    from repro_torch.kernels.flash_attention import cases as fc
    from repro_torch.kernels.flash_attention import ops as fa
    shape = fc.ENCDEC_SHAPE
    rec = {}
    for dtype in fc.DTYPES:
        case = fc.flash_case(shape, dtype, torch.Generator(
            device=DEVICE).manual_seed(5), DEVICE)
        got, ref = case.kernel(), case.plain()
        err, scale = _gap(got, ref)
        ok = err <= (TOL * scale if dtype == torch.float32 else 2e-2)
        r = {"max_abs_err": err}
        if dtype == torch.float32:
            gap = fc.f64_gap(got, fa.mha_ref(*(t.double() for t in
                                               case.inputs), causal=True))
            ok = ok and gap <= fc.F64_REL
            r["max_rel_err_f64"] = gap
        else:
            gap = fc.tiled_gap(got, fa.mha_tiled(*case.inputs, causal=True))
            ok = ok and gap <= fc.TILED_ABS
            r["tiled_gap"] = gap
        check(ok, f"flash_attention {shape} {dtype}: max|d| {err:.3e}, "
                  f"gap {gap:.3e}")
        r.update(flash_times(case, dtype))
        print(f"[kernel] {fa.ROUTES[dtype][0]} {str(dtype)[6:]} encdec "
              f"{shape}: max|d| {err:.3e} (ref max {scale:.3e}), gap "
              f"{gap:.3e} {'ok' if ok else 'FAIL'}; {r.pop('line')}")
        rec[dtype] = r
    return rec


def encdec_phase(ops, cases, serve_mod, rep: dict) -> dict:
    """10: full-width seamless-m4t-large-v2 from the child's checkpoint:
    serve (10a), prefill and eval (10b), memory (10c), the Engine (10d), the
    flash kernel at the decoder's shape (10e) and the stored chains of the
    path at B in {1, 4, 2,048} (2,048: a prefill's rows)."""
    t0 = time.perf_counter()
    served = encdec_serve(serve_mod, rep)
    res = {"serve": served["summary"]}
    res["prefill"], m32, tt32 = encdec_prefill(served)
    res["memory"] = encdec_memory(m32, tt32)
    res["engine"] = encdec_engine(serve_mod.engine_mod, served, m32, tt32)
    del m32, tt32
    info = served["out"]["info"]
    del served
    torch.cuda.empty_cache()
    res["flash"] = encdec_flash()
    res["chains"] = stored_phase(ops, cases, chain_shapes(info), ENCDEC_ARCH,
                                 batch_sizes=(1, 4, ENCDEC_B * ENCDEC_S),
                                 timed=(torch.bfloat16,))
    res["secs"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# SSM phase: full-width mamba2-1.3b
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-1.3b"
SSM_LAYERS = 24          # layers served, of 48 (the cut: the script's time)
SSM_SERVE_ARGS = ["--arch", SSM_ARCH, "--layers", str(SSM_LAYERS),
                  "--batch", "4", "--prompt-len", "16", "--gen", "16",
                  "--seed", "0", "--tt-eps", "0.2"]
SSM_B, SSM_S = 2, 4096           # bf16 prefill throughput
SSM_GATE_S = 2048                # float32 prefill and eval gates, B = 1
SSM_STEP_S = 300                 # prefill vs stepped decode: one whole
                                 # chunk of 256 and a padded tail
SSM_REQS = 8                     # Engine requests


def ssm_serve(serve_mod, rep: dict) -> dict:
    """11a: ``serve --weights tt`` and then ``--weights tt-int8`` from the
    child's checkpoint (no compression): the tt run's leaves equal bit for
    bit to the payload the child compressed (``leaf_digests``), a flipped
    byte refused, exactly w_in and w_out served from cores, every chain on
    its kernel with no plain call, fused and python drivers giving the same
    tokens; decode tok/s and the verify numbers (bf16 gap, int8
    tie-tolerant agreement) reported."""
    res, keep = {}, None
    for weights in ("tt", "tt-int8"):
        args = serve_mod.parse_args(SSM_SERVE_ARGS + [
            "--weights", weights, "--tt-checkpoint", rep["ckpt"]])
        out, secs, counts = _counted(lambda: serve_mod.serve(args))
        info, cfg = out["info"], out["model"].cfg
        what = f"ssm serve {weights}"
        _chains_on_kernels(counts, what,
                           served_chains(info, weights != "tt"))
        check(not counts.get("frob_truncate") and info["compress_s"] is None,
              f"{what}: compressed ({counts})")
        check(sorted(info["chains"]) == ["layers.w_in", "layers.w_out"],
              f"{what}: TT-served leaves {sorted(info['chains'])}")
        gen = out["generated"]
        check(gen.shape == (4, 16) and gen.min() >= 0
              and gen.max() < cfg.vocab_size
              and bool(torch.isfinite(out["run"]["prompt_logits"]).all()),
              f"{what}: tokens {gen.shape} out of range or logits not "
              f"finite")
        r = {"serve_s": secs, "tok_per_s": out["tok_per_s"],
             "verify": out["verify"], "launches": counts,
             "load_s": info["load_s"], "dense_bytes": info["dense_bytes"],
             "tt_bytes": info["tt_bytes"],
             "ttq_bytes": info.get("ttq_bytes"),
             "chains": {k: [v[0], [list(c) for c in v[1]]]
                        for k, v in info["chains"].items()}}
        if weights == "tt":
            same, leaves, raised = child_checkpoint_checks(out, rep, "ssm")
            r.update(checkpoint_equal=same, leaves=leaves,
                     flipped=raised[:90],
                     drivers_agree=drivers_agree(serve_mod, out, what))
            print(f"[chip_smoke] {SSM_ARCH} ranks: " + json.dumps(
                {k: list(v) for k, v in info["ranks"].items()}))
            print(f"[chip_smoke] {SSM_ARCH} bytes: {info['line']}")
            keep = {k: out[k] for k in ("model", "params", "payload",
                                        "prompts", "info")}
        res[weights] = r
        print(f"[chip_smoke] {SSM_ARCH} ({cfg.num_layers} layers) {weights} "
              f"served from its checkpoint in {secs:.1f}s: decode "
              f"{out['tok_per_s']:.1f} tok/s; verify (reported) "
              f"{json.dumps(out['verify'])}; launches {counts}"
              + (f"; {r['leaves']} leaves equal to the child's payload: "
                 f"{r['checkpoint_equal']}; flipped byte -> "
                 f"{r['flipped'][:60]}" if weights == "tt" else ""))
        del out
        torch.cuda.empty_cache()
    return res, keep


class _Spans:
    """CUDA events around every top-level call of ``mamba2.ssd_chunked``
    (its padded-tail call inside not counted twice): the device time the
    SSD's kernels span within a run."""

    def __init__(self):
        from repro_torch.models import mamba2
        self.mod, self.orig, self.events, self.depth = (
            mamba2, mamba2.ssd_chunked, [], 0)

    def __enter__(self):
        def wrapped(*a, **k):
            self.depth += 1
            try:
                if self.depth > 1:
                    return self.orig(*a, **k)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                y = self.orig(*a, **k)
                e1.record()
                self.events.append((e0, e1))
                return y
            finally:
                self.depth -= 1
        self.mod.ssd_chunked = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.ssd_chunked = self.orig

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def _ssm_prefill_bf16(step, params, toks, what: str, tt: bool) -> dict:
    """One warm-up and one timed bf16 prefill of ``toks``: tok/s, the SSD's
    share of the run's device time (CUDA events around the prefill and
    around each ``ssd_chunked``), launches and ``tt_apply`` calls."""
    step(params, {"tokens": toks})
    torch.cuda.synchronize()
    with _Spans() as spans, _TTCalls() as calls:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        reset_counts()
        t0 = time.perf_counter()
        e0.record()
        logits = step(params, {"tokens": toks})
        e1.record()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        reset_counts()
    total = e0.elapsed_time(e1)
    ssd = spans.ms()
    check(bool(torch.isfinite(logits).all()), f"{what}: logits not finite")
    b, s = toks.shape
    print(f"[chip_smoke] {what}: B={b} x S={s} in {secs:.3f}s = "
          f"{b * s / secs:.0f} tok/s; device span {total:.2f} ms, of it "
          f"ssd_chunked {ssd:.2f} ms ({ssd / total:.1%}); tt_apply calls "
          f"{calls.n}; launches {counts}")
    return {"tok_per_s": b * s / secs, "device_ms": total, "ssd_ms": ssd,
            "ssd_share": ssd / total, "tt_apply_calls": calls.n,
            "counts": counts, "tt": tt}


def ssm_prefill(keep: dict) -> dict:
    """11d: bf16 prefill B = SSM_B x S = SSM_S through
    ``make_prefill_step``, TT-native (exactly two ``tt_apply`` calls a
    layer, chains on their kernels, no flash launch) and dense
    (reconstructed): tok/s and the SSD's share of the device time,
    reported."""
    from repro_torch.core import compression as comp
    from repro_torch.train.steps import make_prefill_step
    model, params = keep["model"], keep["params"]
    cfg = model.cfg
    layers = cfg.num_layers
    res = {}
    toks = _tokens(cfg.vocab_size, SSM_B, SSM_S)
    step = make_prefill_step(model)
    res["bf16_tt"] = _ssm_prefill_bf16(step, params, toks,
                                       "ssm prefill bf16 tt", True)
    r = res["bf16_tt"]
    _prefill_counts(r["counts"], "ssm prefill bf16 tt",
                    served_chains(keep["info"], False))
    chain_launches = sum(v for k, v in r["counts"].items()
                         if k in ("tt_contract_2", "tt_contract_3"))
    check(r["tt_apply_calls"] == 2 * layers
          and chain_launches == 2 * layers,
          f"ssm prefill: {r['tt_apply_calls']} tt_apply calls and "
          f"{chain_launches} chain launches, want {2 * layers} each (w_in "
          f"and w_out a layer)")
    dense = comp.TTCompressor().decompress(keep["payload"])
    res["bf16_dense"] = _ssm_prefill_bf16(step, dense, toks,
                                          "ssm prefill bf16 dense", False)
    del dense, toks
    torch.cuda.empty_cache()
    return res


def ssm_f32_gates(keep: dict) -> dict:
    """11b, float32 (TT leaves with float32 cores), gated: TT-native vs
    reconstruct prefill at B = 1 x SSM_GATE_S within F32_TOL of scale,
    exactly two ``tt_apply`` calls a layer; eval losses within 1e-5
    relative; every position's logits of the chunked prefill of SSM_STEP_S
    tokens against the decode cache stepped through them, each within
    F32_TOL of its scale.  Returns the record and the float32 (model,
    params) for the Engine."""
    from repro_torch.models import common, mamba2
    from repro_torch.train.steps import make_eval_step, make_prefill_step
    model = keep["model"]
    cfg = model.cfg
    layers = cfg.num_layers
    res = {}
    m32 = _f32_model(model, DEVICE)
    tt32, rx32 = f32_params(keep["payload"], "ssm")
    cfg32 = m32.cfg
    toks = _tokens(cfg.vocab_size, 1, SSM_GATE_S, seed=3)
    step32 = make_prefill_step(m32)
    with _TTCalls() as calls:
        lt, _, counts = _counted(lambda: step32(tt32, {"tokens": toks}))
    _prefill_counts(counts, "ssm prefill f32 tt",
                    served_chains(keep["info"], False))
    check(calls.n == 2 * layers, f"ssm prefill f32: {calls.n} tt_apply "
                                 f"calls, want {2 * layers}")
    lr = step32(rx32, {"tokens": toks})
    d, scale = _gap(lt, lr)
    check(d <= F32_TOL * scale, f"ssm f32 TT-native vs reconstruct prefill: "
                                f"max|d| {d:.3e} over {F32_TOL} * scale "
                                f"{scale:.3e}")
    res["f32_tt_vs_rx"] = d / scale
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    loss = {name: float(make_eval_step(m32)(p, batch)["loss"])
            for name, p in (("tt", tt32), ("rx", rx32))}
    rel = abs(loss["tt"] - loss["rx"]) / abs(loss["rx"])
    check(math.isfinite(loss["rx"]) and rel <= 1e-5,
          f"ssm eval f32: losses {loss} differ by {rel:.3e} relative")
    res["f32_eval_loss"], res["f32_eval_rel"] = loss, rel
    del rx32
    torch.cuda.empty_cache()

    toks = _tokens(cfg.vocab_size, 1, SSM_STEP_S, seed=4)
    with torch.inference_mode():
        want = common.unembed(mamba2.forward(tt32, toks, cfg32), tt32.embed,
                              cfg32.logit_softcap,
                              real_vocab=cfg32.vocab_size)[0]
        cache = m32.init_cache(1, SSM_STEP_S)
        worst, t0 = 0.0, time.perf_counter()
        for t in range(SSM_STEP_S):
            got, cache = m32.decode_step(tt32, cache, toks[:, t:t + 1])
            dd, sc = _gap(got[0], want[t])
            worst = max(worst, dd / sc)
        secs = time.perf_counter() - t0
    check(worst <= F32_TOL, f"ssm f32: chunked prefill vs stepped decode, "
                            f"worst step max|d|/scale {worst:.3e}")
    res["f32_prefill_vs_decode"] = worst
    res["f32_decode_step_ms"] = secs / SSM_STEP_S * 1e3
    print(f"[chip_smoke] ssm f32 TT-native ({layers} layers): vs reconstruct "
          f"prefill B=1 x {SSM_GATE_S} max|d|/scale {res['f32_tt_vs_rx']:.3e} "
          f"(gate {F32_TOL}); eval losses {json.dumps(loss)}, {rel:.3e} "
          f"relative (gate 1e-5); chunked prefill vs {SSM_STEP_S} decode "
          f"steps, worst step max|d|/scale {worst:.3e} (gate {F32_TOL}), "
          f"{res['f32_decode_step_ms']:.2f} ms a step")
    del want, cache
    torch.cuda.empty_cache()
    return res, m32, tt32


def engine_f32_gates(engine_mod, m32, tt32, stream, what: str, chains,
                     max_len: int = SERVE_MAX_LEN) -> dict:
    """The Engine on ``stream`` in float32 (TT-native params with float32
    cores), gated: every completion's tokens equal to its isolated
    ``generate`` run's, in both admission modes; scan == boundary byte for
    byte (tokens and prompt logits); the chain kernels ``chains`` launched
    with no plain chain; no host sync inside a chunk."""
    iso = isolated_runs(engine_mod, m32, tt32, stream)
    res, runs = {}, {}
    for admission in ("scan", "boundary"):
        r = engine_stream(engine_mod, m32, tt32, stream, admission,
                          no_sync=True, max_len=max_len)
        runs[admission] = r
        bad = [i for i, (c, t) in enumerate(zip(r["comps"], iso))
               if not np.array_equal(c.tokens, t)]
        check(not bad, f"{what} engine f32 {admission}: requests {bad} "
                       f"differ from their isolated runs")
        _chains_on_kernels(r["counts"], f"{what} engine f32 {admission}",
                           chains)
        res[f"f32_{admission}"] = {
            "equal_isolated": len(stream) - len(bad), "steps": r["steps"],
            "occupancy": r["occupancy"], "tok_per_s": r["tok_per_s"],
            "chunks_no_sync": r["chunks_no_sync"], "launches": r["counts"]}
        print(f"[chip_smoke] {what} engine f32 {admission}: "
              f"{len(stream) - len(bad)}/{len(stream)} equal to isolated, "
              f"{r['steps']} steps, occupancy {r['occupancy']:.3f}, "
              f"{r['tok_per_s']:.1f} tok/s, {r['chunks_no_sync']} chunks "
              f"under sync-debug 'error'")
    same = all(np.array_equal(a.tokens, b.tokens)
               and np.array_equal(a.prompt_logits, b.prompt_logits)
               for a, b in zip(runs["scan"]["comps"],
                               runs["boundary"]["comps"]))
    check(same, f"{what} engine f32: scan and boundary admission differ")
    res["scan_equals_boundary"] = same
    return res


def ssm_engine(engine_mod, keep: dict, m32, tt32) -> dict:
    """11c: the Engine (SERVE_SLOTS slots, chunks of SERVE_CHUNK) on
    SSM_REQS requests, greedy and sampled mixed: the float32 gates
    (``engine_f32_gates``); bf16 ``tt`` (as served), scan: tok/s,
    reported."""
    stream = serve_stream(m32.cfg.vocab_size, n=SSM_REQS, seed=28,
                          plen=(3, 17), gen=(4, 17))
    res = engine_f32_gates(engine_mod, m32, tt32, stream, "ssm",
                           served_chains(keep["info"], False))
    r = engine_stream(engine_mod, keep["model"], keep["params"], stream,
                      "scan")
    res["tt"] = {"tok_per_s": r["tok_per_s"], "occupancy": r["occupancy"],
                 "steps": r["steps"], "wall_s": r["wall_s"]}
    print(f"[chip_smoke] ssm engine tt (bf16 activations, scan): "
          f"{r['tok_per_s']:.1f} tok/s, occupancy {r['occupancy']:.3f}, "
          f"{r['steps']} steps in {r['wall_s']:.2f}s (reported)")
    return res


def ssm_gates(serve_mod, rep: dict):
    """11a-c: full-width mamba2-1.3b from the child's checkpoint: serve tt
    and tt-int8, the float32 gates, the Engine.  Their gates hold whatever
    else runs on the card, so they run while the longer children still
    compress (tok/s taken beside them).  Returns the record and what 11d-e
    need."""
    t0 = time.perf_counter()
    res = {"compression": {k: rep.get(k) for k in (
        "compress_s", "breakdown", "peak_bytes", "ranks", "plan",
        "dense_bytes", "tt_bytes", "wall_s")}}
    res["serve"], keep = ssm_serve(serve_mod, rep)
    res["prefill"], m32, tt32 = ssm_f32_gates(keep)
    res["engine"] = ssm_engine(serve_mod.engine_mod, keep, m32, tt32)
    del m32, tt32
    torch.cuda.empty_cache()
    res["secs"] = time.perf_counter() - t0
    return res, keep


def ssm_timed(ops, cases, res: dict, keep: dict) -> None:
    """11d-e, with the card to themselves: the bf16 prefill throughput and
    the SSD's share (``ssm_prefill``), and the path's stored chains at B in
    {1, 4, 64} and a prefill's rows (as 3.)."""
    t0 = time.perf_counter()
    res["prefill"].update(ssm_prefill(keep))
    info = keep["info"]
    keep.clear()
    torch.cuda.empty_cache()
    res["chains"] = stored_phase(ops, cases, chain_shapes(info), SSM_ARCH,
                                 batch_sizes=(1, 4, 64, SSM_B * SSM_S))
    res["secs"] += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# gemma3 phase: the dense transformer with local and global layers
# ---------------------------------------------------------------------------

GEMMA_ARCH = "gemma3-1b"
GEMMA_LAYERS = 12        # layers served, of 26: global layers 6 and 12
GEMMA_SERVE_ARGS = ["--arch", GEMMA_ARCH, "--layers", str(GEMMA_LAYERS),
                    "--batch", "4", "--prompt-len", "16", "--gen", "16",
                    "--seed", "0", "--tt-eps", "0.2"]
GEMMA_B, GEMMA_S = 2, 4096       # bf16 prefill and the float32 gates
GEMMA_STEP_S = 640               # prefill vs stepped decode: 128 keys past
                                 # the local layers' window of 512
GEMMA_LONG = (530, 8)            # the Engine request crossing the window
GEMMA_TT_CALLS = 7               # wq, wk, wv, wo, w_gate, w_up, w_down


def gemma_engine(engine_mod, keep: dict) -> dict:
    """12c: the Engine in float32 (``engine_f32_gates``) on 5 requests of
    prompts 3-32 and gens 4-16, greedy and sampled mixed, and one greedy
    request of GEMMA_LONG (prompt, gen), whose positions cross the local
    layers' window while its neighbours' stay inside it."""
    vocab = keep["model"].cfg.vocab_size
    stream = serve_stream(vocab, n=5, seed=29, plen=(3, 33), gen=(4, 17))
    plen, gen = GEMMA_LONG
    stream.append({"prompt": np.random.default_rng(30).integers(
        0, vocab, plen, np.int32), "gen": gen, "seed": len(stream),
        "temperature": 0.0, "top_k": None})
    m32 = _f32_model(keep["model"], DEVICE)
    tt32, _ = f32_params(keep["payload"], "dense")
    res = engine_f32_gates(engine_mod, m32, tt32, stream, "gemma3",
                           served_chains(keep["info"], False),
                           max_len=plen + gen)
    res["requests"] = [[len(r["prompt"]), r["gen"]] for r in stream]
    return res


def gemma_gates(serve_mod, rep: dict):
    """12a-c: full-width gemma3-1b from the child's checkpoint: serve tt
    and tt-int8 with the main path's gates and the checkpoint's, the
    float32 gates, the Engine.  Their gates hold whatever else runs on the
    card, so they run while the longer children still compress.  Returns
    the record and what 12d-e need."""
    t0 = time.perf_counter()
    res = {"compression": {k: rep.get(k) for k in (
        "compress_s", "breakdown", "peak_bytes", "ranks", "plan",
        "payload_ratio", "dense_bytes", "tt_bytes", "wall_s", "done_s")}}
    res["tt"], keep = big_serve(serve_mod, rep, GEMMA_SERVE_ARGS)
    same, leaves, raised = child_checkpoint_checks(keep, rep, GEMMA_ARCH)
    res["checkpoint"] = {"equal": same, "leaves": leaves,
                         "flipped": raised[:90]}
    print(f"[chip_smoke] {GEMMA_ARCH} checkpoint: {leaves} leaves equal to "
          f"the child's payload: {same}; flipped byte -> {raised[:60]}")
    res["tt-int8"], _ = big_serve(serve_mod, rep, GEMMA_SERVE_ARGS,
                                  weights="tt-int8")
    torch.cuda.empty_cache()
    res["f32"] = dense_f32_gates(keep, GEMMA_ARCH, GEMMA_B, GEMMA_S,
                                 GEMMA_STEP_S)
    torch.cuda.empty_cache()
    res["engine"] = gemma_engine(serve_mod.engine_mod, keep)
    torch.cuda.empty_cache()
    res["secs"] = time.perf_counter() - t0
    return res, keep


def gemma_timed(ops, cases, res: dict, keep: dict) -> None:
    """12d-e, with the card to themselves: the bf16 prefill and eval under
    both impls (7 ``tt_apply`` calls a layer, no flash launch), the path's
    stored chains at B in {1, 4} and a prefill's rows (``big_kernels``)."""
    t0 = time.perf_counter()
    big_kernels(ops, cases, res, keep, GEMMA_ARCH, b=GEMMA_B,
                eval_s=GEMMA_S, tt_calls=GEMMA_TT_CALLS)
    keep.clear()
    torch.cuda.empty_cache()
    res["secs"] += time.perf_counter() - t0


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
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    children = {}
    try:
        # qwen3-8b's compression, the longest, starts before the build
        # (its process builds what it needs itself)
        children[BIG_ARCH] = start_compression(BIG_ARCH, BIG_SERVE_ARGS,
                                               work)
        t0 = time.perf_counter()
        kbuild.load_many([m.SOURCE for m in kernel_modules()])  # parallel
        print(f"[chip_smoke] kernels built and loaded in "
              f"{time.perf_counter() - t0:.2f}s")
        children["recurrentgemma-2b"] = start_compression(
            "recurrentgemma-2b", HYBRID_SERVE_ARGS, work)
        children[ENCDEC_ARCH] = start_compression(
            ENCDEC_ARCH, ENCDEC_SERVE_ARGS, work)
        # mamba2-1.3b after seamless: four compressions at once beside
        # the TTD-engine phase run the card out of memory
        children[SSM_ARCH] = start_compression(
            SSM_ARCH, SSM_SERVE_ARGS, work,
            after=children[ENCDEC_ARCH]["report"])
        # gemma3-1b once the TTD-engine phase has ended, for the same
        # reason, and early enough for its gates to run in the wait for
        # qwen3-8b's child
        children[GEMMA_ARCH] = start_compression(
            GEMMA_ARCH, GEMMA_SERVE_ARGS, work, after=ttd_done_mark(work))
        return run_phases(t_start, work, children, ops, cases, fa_ops,
                          serve_mod)
    finally:
        for child in children.values():
            if child["proc"].poll() is None:
                child["proc"].kill()
                child["proc"].wait()
            child["log"].close()
        shutil.rmtree(work, ignore_errors=True)


def run_phases(t_start, work, children, ops, cases, fa_ops,
               serve_mod) -> int:
    """Every phase after the build.  While ``children`` compress
    recurrentgemma-2b, qwen3-8b, seamless-m4t-large-v2, mamba2-1.3b and
    gemma3-1b, the main path, the checkpoint, the float32 gates, the
    engine's compressions, the serving phase and qwen3-8b's serve run
    (their seconds and tok/s taken beside the children's work); the timed
    kernel checks, the prefill throughputs and the phases after them run
    once the children they need have ended; the SSM and gemma3 phases'
    gates run once their children have ended, their timed checks last."""
    phase_s = {}
    ckpt_dir = str(Path(work) / ARCH)
    t0 = time.perf_counter()
    paths = {w: run_main_path(ops, serve_mod, w, ckpt_dir)
             for w in ("tt", "tt-int8")}
    phase_s["main path"] = time.perf_counter() - t0
    print(f"[chip_smoke] main path phase {phase_s['main path']:.1f}s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    main_out = paths["tt"].pop("out")
    fwd = {"checkpoint": checkpoint_phase(serve_mod, main_out, ckpt_dir)}
    fwd["dense_f32"] = dense_f32_gates(main_out, ARCH)
    torch.cuda.empty_cache()
    phase_s["forward, qwen1.5"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    full = engine_fullwidth(serve_mod, paths["tt"])
    resnet = engine_resnet()
    svd_d = blocked_svd_check(full["wq"])
    torch.cuda.empty_cache()
    phase_s["TTD engine"] = time.perf_counter() - t0
    Path(ttd_done_mark(work)).touch()       # gemma3-1b's child starts

    # serving (9a, 9b, 9d; 9c in the hybrid phase), while the children
    # compress: its gates are exact, and its tok/s are taken beside them
    serving, serving_s = {}, {}
    for name, fn in (
            ("sampler", sampler_phase),
            ("engine", lambda: engine_phase(serve_mod.engine_mod, main_out)),
            ("server", lambda: server_phase(serve_mod, ckpt_dir))):
        t0 = time.perf_counter()
        serving[name] = fn()
        serving_s[name] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    phase_s["serving"] = sum(serving_s.values())

    # 12a-c and 11a-c while qwen3-8b's and recurrentgemma-2b's children
    # compress: gemma3-1b's and mamba2-1.3b's end before theirs, and these
    # gates hold beside them
    t0 = time.perf_counter()
    compressed = {GEMMA_ARCH: finish_compression(GEMMA_ARCH,
                                                 children[GEMMA_ARCH])}
    phase_s["waiting for the compressions"] = time.perf_counter() - t0
    gemma, gemma_keep = gemma_gates(serve_mod, compressed[GEMMA_ARCH])
    t0 = time.perf_counter()
    compressed[SSM_ARCH] = finish_compression(SSM_ARCH, children[SSM_ARCH])
    phase_s["waiting for the compressions"] += time.perf_counter() - t0
    ssm, ssm_keep = ssm_gates(serve_mod, compressed[SSM_ARCH])

    t0 = time.perf_counter()
    compressed[BIG_ARCH] = finish_compression(BIG_ARCH, children[BIG_ARCH])
    phase_s["waiting for the compressions"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd["big"], big_keep = big_serve(serve_mod, compressed[BIG_ARCH])
    torch.cuda.empty_cache()
    phase_s[f"forward, {BIG_ARCH}"] = time.perf_counter() - t0

    # the timed checks run with the card to themselves
    t0 = time.perf_counter()
    compressed["recurrentgemma-2b"] = finish_compression(
        "recurrentgemma-2b", children["recurrentgemma-2b"])
    phase_s["waiting for the compressions"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    rec = stored_phase(ops, cases, chain_shapes(paths["tt"]["info"]),
                       "qwen1.5-0.5b")
    absorbed_phase(ops, cases)
    phase_s["kernel"] = time.perf_counter() - t0
    print(f"[chip_smoke] kernel phase {phase_s['kernel']:.1f}s")

    t0 = time.perf_counter()
    fwd["dense"] = dense_forward(main_out, ARCH, FWD_B, FWD_S, eval_s=FWD_S)
    del main_out
    phase_s["forward, qwen1.5"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    big_kernels(ops, cases, fwd["big"], big_keep)
    del big_keep
    torch.cuda.empty_cache()
    phase_s[f"forward, {BIG_ARCH}"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    erec = engine_kernel_phase(engine_shapes(full["tts"], resnet["plan"]))
    phase_s["TTD engine"] += time.perf_counter() - t0
    print(f"[chip_smoke] TTD-engine phase {phase_s['TTD engine']:.1f}s")
    del full["tts"], full["wq"]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    serving_before_hybrid = phase_s["serving"]
    served = hybrid_serve(serve_mod, compressed["recurrentgemma-2b"])
    hrec = stored_phase(ops, cases, chain_shapes(served["out"]["info"]),
                        "recurrentgemma-2b", batch_sizes=(1, 4, 8192))
    hybrid = hybrid_prefill(served)
    t1 = time.perf_counter()
    serving["hybrid_engine"] = hybrid_engine(serve_mod.engine_mod,
                                             served["out"])
    serving_s["hybrid_engine"] = time.perf_counter() - t1
    phase_s["serving"] += serving_s["hybrid_engine"]
    print(f"[chip_smoke] serving phase {phase_s['serving']:.1f}s "
          f"({json.dumps(serving_s)})")
    del served["out"]
    torch.cuda.empty_cache()
    frec = flash_phase()
    phase_s["hybrid"] = time.perf_counter() - t0 - (
        phase_s["serving"] - serving_before_hybrid)
    print(f"[chip_smoke] hybrid phase {phase_s['hybrid']:.1f}s")

    t0 = time.perf_counter()
    moe = moe_serve(serve_mod)
    served_moe = moe.pop("out")
    keep = {k: served_moe[k] for k in ("model", "payload", "prompts",
                                       "params")}
    del served_moe
    torch.cuda.empty_cache()
    tt32, rx32 = f32_params(keep["payload"], keep["model"].cfg.family)
    gates = moe_f32_gates(serve_mod, keep, tt32, rx32)
    t1 = time.perf_counter()
    fwd["moe"] = moe_prefill(ops, cases, keep, tt32, rx32, moe["info"])
    phase_s["forward, olmoe"] = time.perf_counter() - t1
    del keep, tt32, rx32
    torch.cuda.empty_cache()
    mrec = moe_kernel_phase(ops, cases, moe.pop("info"))
    phase_s["moe"] = time.perf_counter() - t0 - phase_s["forward, olmoe"]
    print(f"[chip_smoke] moe phase {phase_s['moe']:.1f}s (and olmoe "
          f"prefill {phase_s['forward, olmoe']:.1f}s)")

    t0 = time.perf_counter()
    compressed[ENCDEC_ARCH] = finish_compression(ENCDEC_ARCH,
                                                 children[ENCDEC_ARCH])
    phase_s["waiting for the compressions"] += time.perf_counter() - t0
    peaks = {k: v.get("peak_bytes", 0) for k, v in compressed.items()}
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    check(sum(peaks.values()) <= card_bytes,
          f"the child compressions' peaks {peaks} exceed the card's "
          f"{card_bytes:,} B")
    print(f"[chip_smoke] child compressions' peak device memory "
          f"{json.dumps(peaks)}, together {sum(peaks.values()):,} B of the "
          f"card's {card_bytes:,} B")
    encdec = encdec_phase(ops, cases, serve_mod, compressed[ENCDEC_ARCH])
    phase_s["encdec"] = encdec["secs"]
    print(f"[chip_smoke] encdec phase {phase_s['encdec']:.1f}s")
    torch.cuda.empty_cache()
    ssm_timed(ops, cases, ssm, ssm_keep)
    phase_s["ssm"] = ssm["secs"]
    print(f"[chip_smoke] ssm phase {phase_s['ssm']:.1f}s")
    gemma_timed(ops, cases, gemma, gemma_keep)
    phase_s["gemma3"] = gemma["secs"]
    print(f"[chip_smoke] gemma3 phase {phase_s['gemma3']:.1f}s")

    fwd_s = {k: v for k, v in phase_s.items() if k.startswith("forward")}
    print(f"[chip_smoke] forward and checkpoint phase "
          f"{sum(fwd_s.values()):.1f}s ({json.dumps(fwd_s)})")

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
            "replaces": CHAIN_TPU[name],
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
    for name in ("tt_contract_2", "tt_contract_3"):
        r = encdec["chains"][name]
        kernels.append({
            "name": f"{name}_encdec", "route": "cuda", "source": chain_src,
            "replaces": CHAIN_TPU[name],
            "launches": encdec["serve"]["launches"].get(name, 0),
            "prefill_launches": encdec["prefill"]["counts"][
                "bf16/pallas"].get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_bf16_x": r["max_abs_err_bf16_x"],
            "ms": r["ms"], "graph_ms": r["graph_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": bound_by(r), "library_ms": r["library_ms"],
            "timed": f"one tt_apply call from the stored tensors, summed "
                     f"over one {ENCDEC_ARCH} encoder and decoder layer's "
                     f"calls at B=4, bf16 x and cores; launches: the "
                     f"serve run (B 4, prompt 16, gen 16, sources of "
                     f"1,024 tokens) and one bf16 prefill",
        })
    for dtype, run in ((torch.bfloat16, "bf16/pallas"),
                       (torch.float32, "f32/tt/pallas")):
        name = fa_ops.ROUTES[dtype][0]
        r = encdec["flash"][dtype]
        kernels.append({
            "name": f"{name}_encdec", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:93",
            "launches": encdec["prefill"]["counts"][run].get(name, 0),
            **{k: r[k] for k in ("max_abs_err", "ms", "graph_ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            **{k: r[k] for k in ("max_rel_err_f64", "tiled_gap",
                                 "bound_ffma_ms") if k in r},
            "timed": f"one {str(dtype)[6:]} call at {ENCDEC_ARCH}'s decoder "
                     f"shape (B 2, S 1024, 16 Q and 16 KV heads, D 64, "
                     f"causal); launches per prefill (one a decoder layer)",
        })
    for name in sorted(ssm["chains"]):
        r = ssm["chains"][name]
        weights = "tt-int8" if name.endswith("q") else "tt"
        kernels.append({
            "name": f"{name}_ssm", "route": "cuda", "source": chain_src,
            "replaces": CHAIN_TPU[name],
            "launches": ssm["serve"][weights]["launches"].get(name, 0),
            "prefill_launches": ssm["prefill"]["bf16_tt"]["counts"].get(
                name, 0),
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_bf16_x": r["max_abs_err_bf16_x"],
            "ms": r["ms"], "graph_ms": r["graph_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": bound_by(r), "library_ms": r["library_ms"],
            "timed": f"one tt_apply call from the stored tensors, summed "
                     f"over one {SSM_ARCH} layer's calls (w_in 2,048 -> "
                     f"8,512, w_out 4,096 -> 2,048) at B=4, bf16 x, "
                     f"storage as served; launches: the {weights} serve "
                     f"run (B 4, prompt 16, gen 16) and one bf16 prefill "
                     f"(tt storage)",
        })
    for name in sorted(gemma["chains"]):
        r = gemma["chains"][name]
        weights = "tt-int8" if name.endswith("q") else "tt"
        kernels.append({
            "name": f"{name}_gemma3", "route": "cuda", "source": chain_src,
            "replaces": CHAIN_TPU[name],
            "launches": gemma[weights]["counts"].get(name, 0),
            "prefill_launches": gemma["prefill"]["counts"]["pallas"].get(
                name, 0),
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_bf16_x": r["max_abs_err_bf16_x"],
            "ms": r["ms"], "graph_ms": r["graph_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": bound_by(r), "library_ms": r["library_ms"],
            "timed": f"one tt_apply call from the stored tensors, summed "
                     f"over one {GEMMA_ARCH} layer's calls (wq, wk, wv, "
                     f"wo, w_gate, w_up, w_down) at B=4, bf16 x, storage "
                     f"as served; launches: the {weights} serve run (B 4, "
                     f"prompt 16, gen 16) and one bf16 prefill (tt "
                     f"storage, B {GEMMA_B} x {BIG_PREFILL_S})",
        })
    print(f"[chip_smoke] gemma3 summary: " + json.dumps({
        k: (v if not k.startswith("chains") else
            {n: {kk: r[kk] for kk in ("max_abs_err", "max_abs_err_bf16_x",
                                      "ms", "graph_ms", "bound_ms",
                                      "plain_ms", "library_ms")}
             for n, r in v.items()})
        for k, v in gemma.items()}))
    print(f"[chip_smoke] ssm summary: " + json.dumps({
        k: v for k, v in ssm.items() if k != "chains"}))
    print(f"[chip_smoke] encdec summary: " + json.dumps({
        k: v for k, v in encdec.items() if k not in ("flash", "chains")}))
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
    big = fwd["big"]
    print(f"[chip_smoke] forward summary: " + json.dumps({
        "checkpoint": fwd["checkpoint"],
        "qwen1.5-0.5b": {"prefill": fwd["dense"], "f32": fwd["dense_f32"]},
        "olmoe-1b-7b": {k: v for k, v in fwd["moe"].items()},
        BIG_ARCH: {**{k: v for k, v in big.items()
                      if not k.startswith("chains")},
                   **{c: {k: {kk: v[kk] for kk in (
                       "max_abs_err", "max_abs_err_bf16_x", "ms",
                       "graph_ms", "bound_ms", "plain_ms", "library_ms")}
                       for k, v in big[c].items()}
                      for c in ("chains", "chains_prefill_rows")}}}))
    print(f"[chip_smoke] serving summary: " + json.dumps(serving))
    print(f"[chip_smoke] phase seconds: {json.dumps(phase_s)}")
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
    if sys.argv[1:2] == ["--compress"]:
        sys.exit(compress_child(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
