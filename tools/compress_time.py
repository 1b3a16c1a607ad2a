"""Seconds to compress full-width qwen1.5-0.5b on the card, with the port
package of a given checkout — to compare two checkouts on one card.

    python3 tools/compress_time.py [--src DIR] [--plan serial|batched]
                                   [--hbd-impl unblocked|blocked]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's).  The weights are the main path's: seed 0, the
spectral decay of ``serve --weights tt``, compressed at eps 0.2 with
``min_size=8192``.  Prints one JSON line: the seconds of ``compress``
(synchronized; the decay is not timed), the payload size and the ranks.
Run it once per checkout and side, alternating the sides, in one call on
one card.
"""

import argparse
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    ap.add_argument("--plan", default=None)
    ap.add_argument("--hbd-impl", default="unblocked")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import compression as comp
    from repro_torch.core.tt_linear import spectral_decay_pytree
    from repro_torch.models.registry import build

    if not torch.cuda.is_available():
        sys.exit("compress_time: no CUDA device")
    model = build(get_config("qwen1.5-0.5b"), device="cuda")
    params = spectral_decay_pytree(model.init(0), alpha=1.0)
    kw = dict(eps=0.2, min_size=8192, hbd_impl=args.hbd_impl)
    if args.plan:
        kw["plan"] = args.plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload, report = comp.TTCompressor(comp.CompressionPolicy(**kw)
                                        ).compress(params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ranks = {p: list(c.tt.ranks) for p, c in tree.leaves_with_paths(
        payload, is_leaf=comp.is_compressed_param) if c.kind == "tt"}
    print(json.dumps({"src": args.src, "plan": args.plan or "default",
                      "hbd_impl": args.hbd_impl, "compress_s": secs,
                      "payload_params": report.payload_params,
                      "device": torch.cuda.get_device_name(0),
                      "ranks": ranks}))


if __name__ == "__main__":
    main()
