"""Where decode time goes on the card, and how the `tt` verify gap depends
on precision, for full-width qwen1.5-0.5b.

    python3 tools/decode_profile.py          # needs one CUDA card

Compresses the model on the card as ``serve --weights tt`` does (seed 0,
eps 0.2), then prints the reference-oracle gap (max|Δlogits| / scale of the
last prompt position, 4 requests, prompt 16, gen 16) with cuBLAS's
reduced-precision bf16 reductions allowed and disallowed, and with the TT
cores kept in float32; then profiles three fused decode steps with
``torch.profiler`` (kernel time by name, device busy time, host wall time).
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.launch import engine  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    args = serve_mod.parse_args(["--arch", "qwen1.5-0.5b", "--batch", "4",
                                 "--prompt-len", "16", "--gen", "16",
                                 "--weights", "tt"])
    cfg = get_config(args.arch)
    model = build(cfg)
    params_tt, payload, _, _ = serve_mod._tt_setup(model, args, cfg)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16), dtype=np.int32)
    rx = comp.TTCompressor().decompress(payload)

    def run(p):
        return engine.generate(model, p, prompts, 16)

    def gap(a, b):
        d, s, agree = common.logit_parity(a["prompt_logits"],
                                          b["prompt_logits"])
        return (f"max|d| {d:.3e} scale {s:.3e} ratio {d / s:.4f} "
                f"argmax agreement {agree}")

    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = True
    print("bf16 GEMM reduced-precision reductions on: ", gap(run(params_tt), run(rx)))
    matmul.allow_bf16_reduced_precision_reduction = False
    dense = run(rx)
    print("bf16 GEMM reduced-precision reductions off:", gap(run(params_tt), dense))
    tt32 = common.tt_native_params(payload, family="dense",
                                   core_dtype=torch.float32)
    print("TT cores in float32 (dense unchanged):     ", gap(run(tt32), dense))

    cache = model.init_cache(4, 40)
    toks = torch.zeros((4, 40), dtype=torch.int64, device="cuda")
    toks[:, :16] = torch.as_tensor(prompts, device="cuda")
    state = common.gen_init(cache, toks, 16, 32, cfg.vocab_size)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        for _ in range(3):
            state = common.gen_step(model.decode_step, params_tt, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                state = common.gen_step(model.decode_step, params_tt, state)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # kernel rows only: operator rows repeat their kernels' device time
    busy = sum(e.self_device_time_total for e in ka
               if e.device_type == DeviceType.CUDA) / 1e3
    print(f"3 fused decode steps under the profiler: host wall "
          f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms")
    print(ka.table(sort_by="self_device_time_total", row_limit=18,
                   max_name_column_width=60))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=12,
                   max_name_column_width=60))


if __name__ == "__main__":
    main()
