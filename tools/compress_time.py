"""Seconds to compress a full-width model on the card, with the port package
of a given checkout — to compare two checkouts on one card.

    python3 tools/compress_time.py [--src DIR] [--arch ARCH] [--layers N]
                                   [--plan serial|batched]
                                   [--hbd-impl unblocked|blocked] [--phases]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's); ``--arch`` the config (default qwen1.5-0.5b;
recurrentgemma-2b, olmoe-1b-7b, seamless-m4t-large-v2 and mamba2-1.3b
are the hybrid, MoE, encoder-decoder and SSM paths' compressions); ``--layers`` cuts the depth
(an encoder-decoder's encoder too), every width kept.  The weights are ``serve --weights tt``'s: seed 0, its
spectral decay, compressed at eps 0.2 with ``min_size=8192``.  Prints one
JSON line: the seconds of ``compress`` (synchronized; neither the decay nor
the kernels' build is timed), the payload size and the ranks; with
``--phases`` also the seconds of each phase (``tools/cuda_timing.
PhaseTimers``: HBD, phase 2, sort, truncation; synchronized at each
boundary, so the total grows a little).  Run it once per checkout and
side, alternating the sides, in one call on one card.
"""

import argparse
import contextlib
import json
import os
import sys
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(TOOLS, "..", "src"))
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--plan", default=None)
    ap.add_argument("--hbd-impl", default="unblocked")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, TOOLS)
    import dataclasses

    import torch

    from cuda_timing import PhaseTimers

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import compression as comp
    from repro_torch.core.tt_linear import spectral_decay_pytree
    from repro_torch.models.registry import build

    if not torch.cuda.is_available():
        sys.exit("compress_time: no CUDA device")
    # build the engine kernels before the clock starts
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.block_update import ops as wy
    from repro_torch.kernels.frob_truncate import ops as ft
    from repro_torch.kernels.householder import ops as hh
    from repro_torch.kernels.singular_sort import ops as ss
    kbuild.load_many([m.SOURCE for m in (hh, wy, ss, ft)])
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(
            cfg, num_layers=args.layers,
            **({"enc_layers": args.layers} if getattr(cfg, "enc_layers", 0)
               else {}))
    model = build(cfg, device="cuda")
    params = spectral_decay_pytree(model.init(0), alpha=1.0)
    kw = dict(eps=0.2, min_size=8192, hbd_impl=args.hbd_impl)
    if args.plan:
        kw["plan"] = args.plan
    timers = PhaseTimers() if args.phases else contextlib.nullcontext()
    torch.cuda.synchronize()
    with timers:
        t0 = time.perf_counter()
        payload, report = comp.TTCompressor(comp.CompressionPolicy(**kw)
                                            ).compress(params)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    ranks = {p: list(c.tt.ranks) for p, c in tree.leaves_with_paths(
        payload, is_leaf=comp.is_compressed_param) if c.kind == "tt"}
    print(json.dumps({"src": args.src, "arch": args.arch,
                      "layers": cfg.num_layers,
                      "plan": args.plan or "default",
                      "hbd_impl": args.hbd_impl, "compress_s": secs,
                      "payload_params": report.payload_params,
                      "phases": (timers.breakdown(secs) if args.phases
                                 else None),
                      "device": torch.cuda.get_device_name(0),
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "ranks": ranks}))


if __name__ == "__main__":
    main()
