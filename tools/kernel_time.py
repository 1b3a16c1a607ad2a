"""Time one hand-written kernel with the port package of a given checkout —
to compare two checkouts on one card.

    python3 tools/kernel_time.py [--src DIR] [--case flash] \
        [--dtype float32|bfloat16]
    python3 tools/kernel_time.py [--src DIR] --case truncate [--shape [B,]n]
    python3 tools/kernel_time.py [--src DIR] --case wy_vta \
        [--shape M,N,B[,PAD]] ...
    python3 tools/kernel_time.py [--src DIR] --case panel [--shape [B,]M,b]
    python3 tools/kernel_time.py [--src DIR] --case sort [--shape [B,]n]
    python3 tools/kernel_time.py [--src DIR] --case chain \
        [--shape NAME,DTYPE,B] ...

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (and
whose kernels are built; default: this checkout's).  Each case prints one
JSON line per shape with the CUDA-event median of 30 calls after 3 warm-up
calls (``tools/cuda_timing.time_ms``) and the card's name:

* ``flash``: the flash kernel's route of ``--dtype`` (both routes when it
  is not given) at the hybrid prefill's shape
  ``kernels/flash_attention/cases.PATH_SHAPE`` (B 2, S 4,096, 10 Q heads,
  1 KV head, D 256, window 2,048), unit-normal inputs from seed 4; beside
  it one ``scaled_dot_product_attention`` call on the same inputs (the
  library yardstick), each with the graph-replay time of a CUDA graph of
  calls (``cuda_timing.graph_ms``: the card's time with no host); max|Δ|
  against ``mha_ref`` in float32 and in float64 on the same inputs, and
  ptxas's [registers, spill store bytes, spill load bytes] of the route's
  kernel per head dim, from the build log.
* ``truncate``: the δ-truncation through ``delta_truncate`` (or
  ``_batched`` with a leading B) on the case of
  ``kernels/engine_cases.engine_case`` (sorted uniform σ, δ a device tensor
  inside the tail norms' range, per row), seed 2; the graph-replay time
  beside the event median, the plain version's event median, the device
  nodes one call enqueues (``cuda_timing.graph_node_types``: 0 = kernel),
  whether the ranks equal the plain version's, and ptxas's report.
  Default shapes: n = 2,816 and 9 x 64 (the kernel table's).
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

* ``chain``: one whole ``tt_apply`` call (``tt_apply_experts`` for a bank)
  on a TTLinear of one layer built here from stored tensors (the lead row
  or rows, the first core (r_s, n1, r1), the tail cores, in ``DTYPE``
  bf16, int8 — absmax scales per core and lead row, as ``quantize_tt`` —
  or f32), unit-normal draws from seed 2, bf16 x of B rows (B tokens per
  expert for a bank; f32 x for f32 storage).  So the parent's absorption
  (cast, einsum, then its kernels) and a fused kernel are timed on like
  terms.  Beside it one ``torch.einsum`` of x, the cores and the lead (the
  library yardstick; cores widened and dequantized beforehand), max|Δ|
  against it, the device time of each kernel either launches (null where
  the profiler saw none), the time of one call replayed in a CUDA graph of
  20 calls (``cuda_timing.graph_ms``, for the call and the einsum) and the
  number of device kernels of one call.  NAME is a stored chain of
  ``CHAIN_SHAPES`` (full-width qwen1.5-0.5b, olmoe-1b-7b and
  recurrentgemma-2b, eps 0.2, seed 0).  Default: the targets' calls
  (qwen wq bf16 B 4, olmoe w_gate bf16 and int8 at 64 x 1) and the other
  main-path chains at B 4, recurrentgemma-2b's MLP at the prefill's 8,192
  rows.

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
TRUNCATE_SHAPES = ["2816", "9,64"]
# stored chains: (split, [first core (r_s, n1, r1), tail cores], experts)
CHAIN_SHAPES = {
    "qwen-wq": (1, [(24, 1024, 417), (417, 16, 18), (18, 64, 1)], 0),
    "qwen-wo": (2, [(24, 16, 323), (323, 64, 38), (38, 1024, 1)], 0),
    "qwen-up": (1, [(24, 1024, 31), (31, 2816, 1)], 0),
    "qwen-down": (1, [(24, 2816, 31), (31, 1024, 1)], 0),
    "olmoe-wq": (1, [(16, 2048, 526), (526, 16, 20), (20, 128, 1)], 0),
    "olmoe-wo": (2, [(16, 16, 238), (238, 128, 43), (43, 2048, 1)], 0),
    "olmoe-gate": (1, [(992, 2048, 43), (43, 1024, 1)], 64),
    "olmoe-down": (1, [(977, 1024, 44), (44, 2048, 1)], 64),
    "rg-wq": (1, [(8, 2560, 377), (377, 10, 22), (22, 256, 1)], 0),
    "rg-up": (1, [(8, 2560, 31), (31, 7680, 1)], 0),
    "rg-down": (1, [(8, 7680, 31), (31, 2560, 1)], 0),
    "rg-wo": (2, [(8, 10, 79), (79, 256, 45), (45, 2560, 1)], 0),
    "rg-wk": (1, [(8, 2560, 40), (40, 1, 22), (22, 256, 1)], 0),
}
CHAIN_CASES = ["qwen-wq,bf16,4", "olmoe-gate,bf16,1", "olmoe-gate,int8,1",
               "qwen-wq,int8,4", "qwen-wo,bf16,4", "qwen-wo,int8,4",
               "qwen-up,bf16,4", "qwen-up,int8,4", "qwen-down,bf16,4",
               "olmoe-down,bf16,1", "olmoe-down,int8,1", "olmoe-gate,f32,1",
               "olmoe-wq,bf16,4", "olmoe-wo,bf16,4", "rg-wq,bf16,4",
               "rg-up,bf16,8192", "rg-down,bf16,8192", "rg-wq,bf16,8192",
               "rg-wo,bf16,8192", "rg-wk,bf16,8192"]


def flash(build, torch, time_ms, src, dtypes):
    from cuda_timing import graph_ms
    from repro_torch.kernels.flash_attention import cases, ops
    _, _, _, _, _, causal, window = cases.PATH_SHAPE
    for name in dtypes:
        dtype = getattr(torch, name)
        gen = torch.Generator(device="cuda").manual_seed(4)
        case = cases.flash_case(cases.PATH_SHAPE, dtype, gen, "cuda")
        reps = 30 if dtype == torch.bfloat16 else 10
        got = case.kernel().float()
        errs = {}
        for wide in (torch.float32, torch.float64):
            ref = ops.mha_ref(*(t.to(wide) for t in case.inputs),
                              causal=causal, window=window)
            errs[str(wide)[6:]] = float((got.to(wide) - ref).abs().max())
            del ref
        route = ("flash_mma_kernel" if dtype == torch.bfloat16 else None)
        ptxas = {fn: use for fn, use in build.ptxas_usage(ops.SOURCE).items()
                 if (route in fn if route else "flash_mma_kernel" not in fn)}
        print(json.dumps({"src": src, "case": "flash", "dtype": name,
                          "ms": time_ms(case.kernel, reps),
                          "graph_ms": graph_ms(case.kernel, 5, 5),
                          "library_ms": time_ms(case.library, reps),
                          "library_graph_ms": graph_ms(case.library, 5, 5),
                          "max_abs_err_vs": errs,
                          "ref_max": float(got.abs().max()),
                          "ptxas": ptxas,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
        del case, got
        torch.cuda.empty_cache()


def truncate(build, torch, time_ms, src, shapes):
    from cuda_timing import graph_ms, graph_node_types
    from repro_torch.kernels import engine_cases as ec
    from repro_torch.kernels.frob_truncate import ops
    for spec in shapes:
        batch, n = _shape(spec)
        kind = "truncate_batched" if batch else "truncate"
        gen = torch.Generator(device="cuda").manual_seed(2)
        case = ec.engine_case(kind, (*batch, n), gen, "cuda")
        got, ref = case.kernel(), case.plain()
        nodes, code = graph_node_types(case.kernel)
        print(json.dumps({"src": src, "case": "truncate",
                          "shape": [*batch, n],
                          "ms": time_ms(case.kernel),
                          "graph_ms": graph_ms(case.kernel),
                          "plain_ms": time_ms(case.plain),
                          "graph_nodes": nodes if code == 0 else code,
                          "ranks_equal": bool(torch.equal(got[1], ref[1])),
                          "max_abs_err_tails": float(
                              (got[0] - ref[0]).abs().max()),
                          "ptxas": _ptxas(build, ops.SOURCE, "truncate"),
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)


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


def _chain_inputs(torch, spec):
    """(TTLinear of one layer, x, call, library call) of a ``--shape``."""
    from repro_torch.core import tt_linear as ttl
    name, dt, b = spec.split(",")
    split, shapes, experts = CHAIN_SHAPES[name]
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8,
             "f32": torch.float32}[dt]
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    rs = shapes[0][0]
    lead = rn(*((experts, rs) if experts else (rs,)))
    cores = [rn(*c) / c[0] ** 0.5 for c in shapes]
    if dtype == torch.int8:
        lq, ls = ttl.quantize_array(lead, axis=-1)
        qs = [ttl.quantize_array(c) for c in cores]
        lead_w = ttl.dequantize_array(lq, ls, axis=-1)
        wide = [ttl.dequantize_array(q, sc) for q, sc in qs]
        leaf = ttl.TTLinear(lead=lq, cores=[q for q, _ in qs], split=split,
                            in_shape=(0,), out_shape=(0,),
                            experts=experts or None,
                            scales=[sc for _, sc in qs], lead_scale=ls)
    else:
        lead, cores = lead.to(dtype), [c.to(dtype) for c in cores]
        lead_w, wide = lead.float(), [c.float() for c in cores]
        leaf = ttl.TTLinear(lead=lead, cores=cores, split=split,
                            in_shape=(0,), out_shape=(0,),
                            experts=experts or None)
    n_in = shapes[0][1] * (shapes[1][1] if split == 2 else 1)
    n_out = 1
    for c in shapes[split:]:
        n_out *= c[1]
    leaf.in_shape, leaf.out_shape = (n_in,), (n_out,)
    b = int(b)
    x = rn(*((experts, b, n_in) if experts else (b, n_in)))
    x = x.to(torch.float32 if dtype == torch.float32 else torch.bfloat16)
    xf = x.float()
    last = wide[-1].reshape(wide[-1].shape[:2])
    if experts:
        def call():
            return ttl.tt_apply_experts(x, leaf)

        def lib():
            return torch.einsum("ecn,snr,es,rm->ecm", xf, wide[0], lead_w,
                                last)
    elif len(shapes) == 2:
        def call():
            return ttl.tt_apply(x, leaf)

        def lib():
            return torch.einsum("bn,snr,s,rm->bm", xf, wide[0], lead_w, last)
    elif split == 1:
        def call():
            return ttl.tt_apply(x, leaf)

        def lib():
            return torch.einsum("bn,snr,s,rpq,qj->bpj", xf, wide[0], lead_w,
                                wide[1], last).reshape(b, -1)
    else:
        x3 = xf.reshape(b, shapes[0][1], shapes[1][1])

        def call():
            return ttl.tt_apply(x, leaf)

        def lib():
            return torch.einsum("bap,sar,s,rpq,qj->bj", x3, wide[0], lead_w,
                                wide[1], last)
    return call, lib


def _launches(torch, fn, calls=5):
    """Device kernels one call of ``fn`` launches (mean over ``calls``)."""
    from cuda_timing import kernel_ms
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(n for _, n in kernel_ms(prof).values()) / calls


def chain(build, torch, time_ms, device_ms, src, shapes):
    from cuda_timing import graph_ms
    from repro_torch.kernels.tt_contract import ops
    for spec in shapes:
        call, lib = _chain_inputs(torch, spec)
        ref = lib()
        err = float((call().float() - ref).abs().max())
        dev, lib_dev = device_ms(call), device_ms(lib)
        kernels = _launches(torch, call)
        print(json.dumps({"src": src, "case": "chain", "shape": spec,
                          "ms": time_ms(call), "library_ms": time_ms(lib),
                          "graph_ms": graph_ms(call),
                          "library_graph_ms": graph_ms(lib),
                          "device_ms": sum(dev.values()) if dev else None,
                          "library_device_ms": (sum(lib_dev.values())
                                                if lib_dev else None),
                          "device_by_kernel": dev,
                          "library_device_by_kernel": lib_dev,
                          "kernels_a_call": kernels,
                          "max_abs_err_vs_library": err,
                          "ref_max": float(ref.abs().max()),
                          "ptxas": _ptxas(build, ops.SOURCE, "kernel"),
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
        del call, lib, ref
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(TOOLS, "..", "src"))
    ap.add_argument("--case", choices=("flash", "wy_vta", "panel", "sort",
                                       "chain", "truncate"), default="flash")
    ap.add_argument("--shape", action="append",
                    help="wy_vta: M,N,B[,PAD]; panel: [B,]M,b; sort, "
                         "truncate: [B,]n; chain: NAME,DTYPE,B (repeatable)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    help="flash: the route (default: both)")
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
        flash(build, torch, time_ms, args.src,
              [args.dtype] if args.dtype else ["bfloat16", "float32"])
    elif args.case == "truncate":
        truncate(build, torch, time_ms, args.src,
                 args.shape or TRUNCATE_SHAPES)
    elif args.case == "wy_vta":
        wy_vta(build, torch, time_ms, device_ms, args.src,
               args.shape or WY_SHAPES)
    elif args.case == "panel":
        panel(build, torch, time_ms, device_ms, args.src,
              args.shape or PANEL_SHAPES)
    elif args.case == "sort":
        sort(build, torch, time_ms, device_ms, args.src,
             args.shape or SORT_SHAPES)
    else:
        chain(build, torch, time_ms, device_ms, args.src,
              args.shape or CHAIN_CASES)


if __name__ == "__main__":
    main()
