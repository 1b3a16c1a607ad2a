"""How far TT-native serving drifts from reconstruct-then-serve with depth
and width, in the JAX package and in the PyTorch port on identical numbers.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/tt_parity_depth.py \
        --layers 8 --d-model 256 --d-ff 704 [--vocab 512]

Builds reduced qwen1.5-0.5b (bf16) at the given depth, width and vocabulary
(full width: --layers 24 --d-model 1024 --d-ff 2816 --vocab 151936) in the JAX
package, imposes the σ_i ∝ 1/i spectrum, compresses it (serial plan, library
SVD, eps 0.2), and carries the weights' TT payload to the port through numpy
(``repro_torch.convert``), so both packages serve the same cores.  Prints,
for ``tt`` and ``tt-int8`` in each package, the teacher-forced max|Δlogits| /
scale against reconstruct-then-serve and the tie-tolerant next-token
agreement (the quantities the reference's serve verify gates), and the
port-vs-reference gap of each path.  CPU only.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import jax  # noqa: E402
import torch  # noqa: E402

from _torch_port import flat_payload  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import (CompressionPolicy, TTCompressor,  # noqa: E402
                        quantize_tt_tree, spectral_decay_pytree)
from repro.launch.serve import _teacher_forced_logits  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.registry import build as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import payload_from_numpy  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core import tt_linear as ttl  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--d-ff", type=int, default=704)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    kw = dict(num_layers=a.layers, d_model=a.d_model, d_ff=a.d_ff,
              num_heads=a.d_model // 64, num_kv_heads=a.d_model // 64,
              vocab_size=a.vocab)
    jcfg = jax_get_config("qwen1.5-0.5b").reduced(**kw)
    jmodel = jax_build(jcfg)
    params = spectral_decay_pytree(jmodel.init(jax.random.PRNGKey(a.seed)))
    payload, _ = TTCompressor(CompressionPolicy(
        eps=0.2, min_size=8192, svd_method="library", plan="serial")
    ).compress(params)
    jtt = jax_common.tt_native_params(payload, family="dense")
    model = build(get_config("qwen1.5-0.5b").reduced(**kw), device="cpu")
    ppay = payload_from_numpy(flat_payload(payload))
    ptt = common.tt_native_params(ppay, family="dense")
    prompts = np.random.default_rng(a.seed).integers(
        0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    pt = torch.as_tensor(prompts, dtype=torch.int64)

    ref = {"rx": _teacher_forced_logits(
               jmodel, TTCompressor().decompress(payload), prompts),
           "tt": _teacher_forced_logits(jmodel, jtt, prompts),
           "int8": _teacher_forced_logits(jmodel, quantize_tt_tree(jtt),
                                          prompts)}
    port = {"rx": serve_mod.teacher_forced_logits(
                model, comp.TTCompressor().decompress(ppay), pt),
            "tt": serve_mod.teacher_forced_logits(model, ptt, pt),
            "int8": serve_mod.teacher_forced_logits(
                model, ttl.quantize_tt_tree(ptt), pt)}

    def gap(x, y):
        return float(np.abs(x - y).max() / np.abs(y).max())

    print(f"layers {a.layers}, d_model {a.d_model}, d_ff {a.d_ff}, "
          f"vocab {a.vocab}")
    for k in ("tt", "int8"):
        print(f"{k}: vs reconstruct max|d|/scale  reference "
              f"{gap(ref[k], ref['rx']):.4f}  port {gap(port[k], port['rx']):.4f}"
              f"; tie-tolerant agreement reference "
              f"{serve_mod.tie_tolerant_agreement(ref[k], ref['rx']):.4f}  "
              f"port {serve_mod.tie_tolerant_agreement(port[k], port['rx']):.4f}")
    for k in ("rx", "tt", "int8"):
        print(f"port vs reference, {k}: max|d|/scale {gap(port[k], ref[k]):.4f}")


if __name__ == "__main__":
    main()
