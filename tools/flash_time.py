"""Time of the flash kernel's bf16 route at the hybrid prefill's shape, with
the port package of a given checkout — to compare two checkouts on one card.

    python3 tools/flash_time.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (and
whose kernel is built; default: this checkout's).  The shape is
``kernels/flash_attention/cases.PATH_SHAPE`` (B 2, S 4,096, 10 Q heads, 1
KV head, D 256, window 2,048), unit-normal bf16 inputs from seed 4.  Prints
one JSON line: the CUDA-event median of 30 calls after 3 warm-up calls,
max|Δ| against ``mha_ref`` in float32 on the same inputs, and ptxas's
[registers, spill store bytes, spill load bytes] of the route's kernel per
head dim, from the build log.  Run it once per checkout and side,
alternating the sides (parent, change, change, parent), in one call on one
card.
"""

import argparse
import json
import os
import statistics
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import cases, ops

    if not torch.cuda.is_available():
        sys.exit("flash_time: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(4)
    case = cases.flash_case(cases.PATH_SHAPE, torch.bfloat16, gen, "cuda")
    for _ in range(3):
        case.kernel()
    torch.cuda.synchronize()
    times = []
    for _ in range(30):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        case.kernel()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    _, _, _, _, _, causal, window = cases.PATH_SHAPE
    ref = ops.mha_ref(*(t.float() for t in case.inputs), causal=causal,
                      window=window)
    err = float((case.kernel().float() - ref).abs().max())
    ptxas = {fn: use for fn, use in build.ptxas_usage(ops.SOURCE).items()
             if "flash_mma_kernel" in fn}
    print(json.dumps({"src": args.src, "ms": statistics.median(times),
                      "max_abs_err_vs_f32": err, "ptxas": ptxas,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
