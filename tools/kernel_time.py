"""Time one hand-written kernel with the port package of a given checkout —
to compare two checkouts on one card.

    python3 tools/kernel_time.py [--src DIR] [--case flash]
    python3 tools/kernel_time.py [--src DIR] --case wy_vta \
        [--shape M,N,B[,PAD]] ...
    python3 tools/kernel_time.py [--src DIR] --case panel [--shape [B,]M,b]
    python3 tools/kernel_time.py [--src DIR] --case sort [--shape [B,]n]

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
* ``panel``: the Householder panel factor through ``panel_factor`` (or
  ``panel_factor_batched`` with a leading B), the (M, b) panel a view at
  column 32 of a unit-normal (M, b + 32) matrix from seed 2, as blocked QR
  hands it over; beside it one ``torch.geqrf`` of a contiguous copy (the
  library yardstick), the device time of each kernel either launches, the
  routes counted (where the checkout counts them) and ptxas's report of the
  panel kernels.  Default shapes: 19,447,808 x 32 (the largest main-path
  panel) and 24,576 x 32.
* ``sort``: the singular-value sort through ``sort_singular_values`` (or
  ``_batched`` with a leading B), σ in {0, 0.25, ...} from seed 2 (many
  ties); beside it one ``torch.sort(..., descending=True, stable=True)``,
  whether the two agree bit for bit, device times and ptxas's report.
  Default shapes: n = 2,816 (qwen1.5-0.5b's longest σ) and 9 x 64
  (ResNet-32's batched bucket).

Run it once per checkout and side, alternating the sides (parent, change,
change, parent), in one call on one card.
"""

import argparse
import json
import os
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
WY_SHAPES = ["19447808,32,32,0", "24576,2784,32,32"]
PANEL_SHAPES = ["19447808,32", "24576,32"]
SORT_SHAPES = ["2816", "9,64"]


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


def _ptxas(build, source, *names):
    return {fn: use for fn, use in build.ptxas_usage(source).items()
            if any(n in fn for n in names)}


def _shape(spec):
    dims = [int(x) for x in spec.split(",")]
    return dims[:-1], dims[-1]


def panel(build, torch, time_ms, device_ms, src, shapes):
    from repro_torch.kernels.householder import ops
    for spec in shapes:
        lead, b = _shape(spec)
        *batch, m = lead
        gen = torch.Generator(device="cuda").manual_seed(2)
        a = torch.randn(*batch, m, b + 32, generator=gen,
                        device="cuda")[..., 32:]
        fn = ops.panel_factor_batched if batch else ops.panel_factor
        ac = a.contiguous()
        ops.launches.clear()
        fn(a)
        routes = dict(ops.launches)
        ms = time_ms(lambda: fn(a), reps=10)
        lib_ms = time_ms(lambda: torch.geqrf(ac), reps=5)
        dev = device_ms(lambda: fn(a), calls=3)
        lib_dev = device_ms(lambda: torch.geqrf(ac), calls=2)
        print(json.dumps({"src": src, "case": "panel",
                          "shape": [*batch, m, b], "ms": ms,
                          "library_ms": lib_ms,
                          "device_ms": sum(dev.values()),
                          "library_device_ms": sum(lib_dev.values()),
                          "device_by_kernel": dev, "routes": routes,
                          "ptxas": _ptxas(build, ops.SOURCE, "panel_"),
                          "device": torch.cuda.get_device_name(0)}))
        del a, ac
        torch.cuda.empty_cache()


def sort(build, torch, time_ms, device_ms, src, shapes):
    from repro_torch.kernels.singular_sort import ops
    for spec in shapes:
        batch, n = _shape(spec)
        gen = torch.Generator(device="cuda").manual_seed(2)
        s = torch.randint(0, max(n // 4, 2), (*batch, n), generator=gen,
                          device="cuda").float() * 0.25
        fn = (ops.sort_singular_values_batched if batch
              else ops.sort_singular_values)

        def lib():
            return torch.sort(s, dim=-1, descending=True, stable=True)

        got, ref = fn(s), lib()
        equal = (torch.equal(got[0], ref.values)
                 and torch.equal(got[1], ref.indices))
        dev, lib_dev = device_ms(lambda: fn(s)), device_ms(lib)
        print(json.dumps({"src": src, "case": "sort", "shape": [*batch, n],
                          "ms": time_ms(lambda: fn(s)),
                          "library_ms": time_ms(lib),
                          "device_ms": sum(dev.values()),
                          "library_device_ms": sum(lib_dev.values()),
                          "device_by_kernel": dev,
                          "library_device_by_kernel": lib_dev,
                          "equal_to_library": equal,
                          "ptxas": _ptxas(build, ops.SOURCE, "bitonic"),
                          "device": torch.cuda.get_device_name(0)}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(TOOLS, "..", "src"))
    ap.add_argument("--case", choices=("flash", "wy_vta", "panel", "sort"),
                    default="flash")
    ap.add_argument("--shape", action="append",
                    help="wy_vta: M,N,B[,PAD]; panel: [B,]M,b; sort: "
                         "[B,]n (repeatable)")
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
    elif args.case == "wy_vta":
        wy_vta(build, torch, time_ms, device_ms, args.src,
               args.shape or WY_SHAPES)
    elif args.case == "panel":
        panel(build, torch, time_ms, device_ms, args.src,
              args.shape or PANEL_SHAPES)
    else:
        sort(build, torch, time_ms, device_ms, args.src,
             args.shape or SORT_SHAPES)


if __name__ == "__main__":
    main()
