"""Decode tokens/s, a profile of the decode steps, and the TT-native hybrid
prefill, with the port package of a given checkout on one compression — to
compare two checkouts on one card.

    python3 tools/decode_time.py --save DIR [--arch A ...]
    python3 tools/decode_time.py [--src OTHER/src] --load DIR [--arch A ...]

``--save`` compresses each model as ``serve --weights tt`` does (random
weights from seed 0 with the spectral decay, eps 0.2, on the card) and
writes its payload as a TT checkpoint to ``DIR/<arch>``
(``checkpoint.save_tt_payload``, the layout ``serve --tt-checkpoint``
reads).  ``--load`` reads the checkpoints with the ``repro_torch`` under
``--src`` (default: this checkout's; it must have
``repro_torch.checkpoint``) and serves each model from them: ``tt`` and ``tt-int8`` (recurrentgemma-2b ``tt``
only), 4 greedy requests, prompt 16, gen 16, the fused driver; one warm-up
run, then decode tok/s of two runs, resident weight bytes, the peak device
memory of a run, and ``torch.profiler`` over 3 fused decode steps after the
prompt (host wall, device busy, the kernels that take the most device
time).  For recurrentgemma-2b also the prefill through
``make_prefill_step(impl="pallas")`` at B 2 × S 4,096 with the TT-native
bf16 weights (tok/s, the median of 3 after a warm-up).  One JSON line per
(arch, weights) with the card's name.

Run ``--save`` once, then ``--load`` once per checkout and side, alternating
the sides (parent, change, change, parent), in one call on one card.
"""

import argparse
import json
import os
import sys
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
ARCHS = ("qwen1.5-0.5b", "olmoe-1b-7b", "recurrentgemma-2b")
PREFILL_B, PREFILL_S = 2, 4096


def save(torch, archs, out_dir):
    from repro_torch.checkpoint.checkpoint import save_tt_payload
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.registry import build
    os.makedirs(out_dir, exist_ok=True)
    for arch in archs:
        args = serve_mod.parse_args(["--arch", arch, "--weights", "tt"])
        cfg = get_config(arch)
        model = build(cfg, device="cuda")
        t0 = time.perf_counter()
        _, payload, _, _ = serve_mod._tt_setup(model, args, cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        save_tt_payload(os.path.join(out_dir, arch), payload,
                        extra={"eps": args.tt_eps, "arch": arch},
                        family=cfg.family)
        print(json.dumps({"arch": arch, "saved": True, "compress_s": secs}))
        del payload, model
        torch.cuda.empty_cache()


def _profile(torch, model, params, prompts, steps=3):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import common
    b, s = prompts.shape
    toks = torch.zeros((b, 2 * s), dtype=torch.int64, device="cuda")
    toks[:, :s] = torch.as_tensor(prompts, device="cuda")
    state = common.gen_init(model.init_cache(b, 2 * s), toks, s, 2 * s,
                            model.cfg.vocab_size)
    with torch.inference_mode():
        for _ in range(s):
            state = common.gen_step(model.decode_step, params, state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()    # the profiler's start-up excluded
            for _ in range(steps):
                state = common.gen_step(model.decode_step, params, state)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"steps": steps, "wall_ms": wall * 1e3,
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in kern) / 1e3,
            "kernel_calls": sum(e.count for e in kern),
            "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                    for e in top]}


def load(torch, archs, in_dir, src):
    import numpy as np
    from repro_torch.checkpoint.checkpoint import load_tt_payload
    from repro_torch.configs import get_config
    from repro_torch.core import tt_linear as ttl
    from repro_torch.launch import engine
    from repro_torch.models import common
    from repro_torch.models.registry import build
    from repro_torch.train.steps import make_prefill_step
    for arch in archs:
        cfg = get_config(arch)
        model = build(cfg, device="cuda")
        like = model.init(0)
        payload, _ = load_tt_payload(os.path.join(in_dir, arch), like=like,
                                     device="cuda")
        del like
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(4, 16), dtype=np.int32)
        for weights in (("tt",) if cfg.family == "hybrid"
                        else ("tt", "tt-int8")):
            params = common.tt_native_params(payload, family=cfg.family)
            if weights == "tt-int8":
                params = ttl.quantize_tt_tree(params)
            engine.generate(model, params, prompts, 16, max_len=32)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            tps = []
            for _ in range(2):
                run = engine.generate(model, params, prompts, 16, max_len=32)
                tps.append(4 * 15 / max(run["decode_t"], 1e-9))
            peak = torch.cuda.max_memory_allocated()
            rec = {"src": src, "arch": arch, "weights": weights,
                   "tok_per_s": tps, "bytes": ttl.tt_param_bytes(params),
                   "peak_bytes": peak, "base_bytes": base,
                   "gen": run["gen"][0][:8].tolist(),
                   "profile": _profile(torch, model, params, prompts)}
            if cfg.family == "hybrid":
                g = torch.Generator(device="cuda").manual_seed(1)
                batch = {"tokens": torch.randint(
                    0, cfg.vocab_size, (PREFILL_B, PREFILL_S), generator=g,
                    device="cuda")}
                step = make_prefill_step(model, impl="pallas")
                step(params, batch)
                secs = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(params, batch)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                rec["prefill_tok_per_s"] = [PREFILL_B * PREFILL_S / s
                                            for s in secs]
            rec["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(rec), flush=True)
            del params
            torch.cuda.empty_cache()
        del payload, model
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(TOOLS, "..", "src"))
    ap.add_argument("--arch", action="append", choices=ARCHS)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", metavar="DIR")
    mode.add_argument("--load", metavar="DIR")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("decode_time: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    archs = args.arch or ARCHS
    if args.save:
        save(torch, archs, args.save)
    else:
        load(torch, archs, args.load, args.src)


if __name__ == "__main__":
    main()
