"""Time one hand-written kernel with the port package of a given checkout —
to compare two checkouts on one card.

    python3 tools/kernel_time.py [--src DIR] [--case flash]
    python3 tools/kernel_time.py [--src DIR] --case wy_vta \
        [--shape M,N,B[,PAD]] ...

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (and
whose kernels are built; default: this checkout's).  Each case prints one
JSON line per shape with the CUDA-event median of 30 calls after 3 warm-up
calls (``tools/cuda_timing.time_ms``) and the card's name:

* ``flash``: the flash kernel's bf16 route at the hybrid prefill's shape
  ``kernels/flash_attention/cases.PATH_SHAPE`` (B 2, S 4,096, 10 Q heads,
  1 KV head, D 256, window 2,048), unit-normal bf16 inputs from seed 4;
  max|Δ| against ``mha_ref`` in float32 on the same inputs, and ptxas's
  [registers, spill store bytes, spill load bytes] of the route's kernel
  per head dim, from the build log.
* ``wy_vta``: pass 1 of the WY update, Y = Vᵀ A, through ``wy_vta``, with
  V (M, B) and A the (M, N) trailing block at column PAD (default 0) of a
  contiguous (M, N + PAD) matrix, unit-normal inputs from seed 2 made here
  (so both checkouts time the same inputs); beside it one ``V.T @ A`` call
  (the library yardstick), max|Δ| against it, the device time of each
  kernel either one launches (``cuda_timing.device_ms``: the card's own
  time, without the host's time to issue the call), and ptxas's report of
  pass 1's kernels.  Default shapes: the largest main-path shape
  (19,447,808 x 32, B 32, a contiguous Q formation) and 24,576 x 2,784
  (B 32, the first trailing update of a 2,816-column matrix, PAD 32).

Run it once per checkout and side, alternating the sides (parent, change,
change, parent), in one call on one card.
"""

import argparse
import json
import os
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
WY_SHAPES = ["19447808,32,32,0", "24576,2784,32,32"]


def flash(build, torch, time_ms, src):
    from repro_torch.kernels.flash_attention import cases, ops
    gen = torch.Generator(device="cuda").manual_seed(4)
    case = cases.flash_case(cases.PATH_SHAPE, torch.bfloat16, gen, "cuda")
    ms = time_ms(case.kernel)
    _, _, _, _, _, causal, window = cases.PATH_SHAPE
    ref = ops.mha_ref(*(t.float() for t in case.inputs), causal=causal,
                      window=window)
    err = float((case.kernel().float() - ref).abs().max())
    ptxas = {fn: use for fn, use in build.ptxas_usage(ops.SOURCE).items()
             if "flash_mma_kernel" in fn}
    print(json.dumps({"src": src, "case": "flash", "ms": ms,
                      "max_abs_err_vs_f32": err, "ptxas": ptxas,
                      "device": torch.cuda.get_device_name(0)}))


def wy_vta(build, torch, time_ms, device_ms, src, shapes):
    from repro_torch.kernels.block_update import ops
    for spec in shapes:
        m, n, b, *rest = (int(x) for x in spec.split(","))
        pad = rest[0] if rest else 0
        gen = torch.Generator(device="cuda").manual_seed(2)
        a = torch.randn(m, n + pad, generator=gen, device="cuda")[:, pad:]
        v = torch.randn(m, b, generator=gen, device="cuda") / m ** 0.5
        ms = time_ms(lambda: ops.wy_vta(v, a))
        lib_ms = time_ms(lambda: v.T @ a)
        dev = device_ms(lambda: ops.wy_vta(v, a))
        lib_dev = device_ms(lambda: v.T @ a)
        ref = v.T @ a
        err = float((ops.wy_vta(v, a) - ref).abs().max())
        ptxas = {fn: use for fn, use in build.ptxas_usage(ops.SOURCE).items()
                 if "vta" in fn}
        print(json.dumps({"src": src, "case": "wy_vta", "shape": [m, n, b],
                          "pad": pad, "ms": ms, "library_ms": lib_ms,
                          "device_ms": sum(dev.values()),
                          "library_device_ms": sum(lib_dev.values()),
                          "device_by_kernel": dev,
                          "library_device_by_kernel": lib_dev,
                          "max_abs_err_vs_library": err,
                          "ref_max": float(ref.abs().max()),
                          "ptxas": ptxas,
                          "device": torch.cuda.get_device_name(0)}))
        del a, v, ref
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(TOOLS, "..", "src"))
    ap.add_argument("--case", choices=("flash", "wy_vta"), default="flash")
    ap.add_argument("--shape", action="append",
                    help="wy_vta: M,N,B[,PAD] (repeatable)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, TOOLS)
    import torch

    from cuda_timing import device_ms, time_ms
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("kernel_time: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.case == "flash":
        flash(build, torch, time_ms, args.src)
    else:
        wy_vta(build, torch, time_ms, device_ms, args.src,
               args.shape or WY_SHAPES)


if __name__ == "__main__":
    main()
