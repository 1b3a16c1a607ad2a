"""Serving driver: one batch of greedy requests through ``engine.generate``.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen1.5-0.5b --weights tt --batch 4 --prompt-len 16 --gen 16

``--arch`` is any ported config (``repro_torch.configs.NAME_TO_MODULE``:
qwen1.5-0.5b of the dense family, olmoe-1b-7b of the MoE family,
recurrentgemma-2b of the hybrid family); every family serves through the
same ``Model`` API.

Runs on the first CUDA card unless ``--device cpu`` is given.  With
``--weights tt`` the weights (random from ``--seed``, given a power-law
spectrum as trained weights have) are TT-compressed on the device (paper
Algorithm 1 on the default batched plan, as the reference's serve does),
converted to TT-native params, and decode contracts activations straight
through the cores with the hand-written kernels — the dense matrices are
never rebuilt.  An MoE expert bank serves as one expert-batched chain per
layer (``tt_apply_experts``).  ``--weights tt-int8`` stores the cores as
int8.
``--verify`` (default on) reruns the batch on the reconstructed dense
weights and reports logit parity; for int8 it reports tie-tolerant
next-token agreement over every teacher-forced prompt position.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.configs import get_config
from repro_torch.core import compression as _comp
from repro_torch.core import tt_linear as _ttl
from repro_torch.launch import engine as engine_mod
from repro_torch.models import common as model_common
from repro_torch.models.registry import build


def _dense_bytes(payload) -> int:
    """Bytes the payload would occupy reconstructed (from metadata)."""
    return sum(
        int(np.prod(c.orig_shape)) * torch.empty((), dtype=c.orig_dtype).element_size()
        for c in _tree.leaves(payload, is_leaf=_comp.is_compressed_param))


def _quant_of(weights: str) -> Optional[str]:
    """``tt-<fmt>`` → fmt (validated); ``tt``/``dense`` → None."""
    if weights.startswith("tt-"):
        fmt = weights[3:]
        _ttl.quant_dtype(fmt)
        return fmt
    return None


def teacher_forced_logits(model, params, prompts: torch.Tensor) -> np.ndarray:
    """Per-position next-token logits over the prompt → (B, S-1, V)."""
    b, s = prompts.shape
    cache = model.init_cache(b, s)
    outs = []
    with torch.inference_mode():
        for t in range(s - 1):
            logits, cache = model.decode_step(params, cache,
                                              prompts[:, t:t + 1])
            outs.append(logits.float().cpu().numpy())
    return np.stack(outs, 1)


def tie_tolerant_agreement(tf_q: np.ndarray, tf_ref: np.ndarray) -> float:
    """Share of positions where the reference's argmax is within 5% of the
    reference's logit scale of the candidate's best logit (ties on
    near-flat synthetic logits do not count as disagreements)."""
    tol = 0.05 * float(np.max(np.abs(tf_ref)))
    top = np.argmax(tf_ref, -1)
    deficit = np.max(tf_q, -1) - np.take_along_axis(
        tf_q, top[..., None], -1)[..., 0]
    return float(np.mean(deficit <= tol))


def _compress(model, args):
    """Random weights from ``args.seed`` with the spectral decay, compressed
    on the model's device; the random init is dropped once its decayed copy
    exists.  Returns (the dense params compressed, payload, report,
    seconds)."""
    comp = _comp.TTCompressor(_comp.CompressionPolicy(
        eps=args.tt_eps, min_size=8192))
    params = model.init(args.seed)
    dev = params.embed.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    params = _ttl.spectral_decay_pytree(params, alpha=args.tt_alpha)
    payload, report = comp.compress(params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return params, payload, report, time.perf_counter() - t0


def _tt_setup(model, args, cfg, compressed=None):
    """The compression (``_compress``, or ``compressed``: its result from
    an earlier run of the same weights) and the TT-native params.

    Returns (params_tt, payload, info, the dense params compressed)."""
    quant = _quant_of(args.weights)
    params, payload, report, compress_s = compressed or _compress(model,
                                                                   args)
    params_tt = model_common.tt_native_params(payload, family=cfg.family)
    info = {
        "compressed": (params, payload, report, compress_s),
        "compress_s": compress_s,
        "payload_ratio": report.ratio,
        "plan_fingerprint": report.plan_fingerprint,
        "exec_stats": report.exec_stats,
        "ranks": {path: c.tt.ranks for path, c in _tree.leaves_with_paths(
            payload, is_leaf=_comp.is_compressed_param) if c.kind == "tt"},
        "dense_bytes": _dense_bytes(payload),
        "tt_bytes": _ttl.tt_param_bytes(params_tt),
    }
    tt_leaves = [(path, leaf) for path, leaf in _tree.leaves_with_paths(
        params_tt, is_leaf=_ttl.is_tt_linear) if _ttl.is_tt_linear(leaf)]
    # (split, core shapes, experts or None) of every TT-served weight
    info["chains"] = {
        path: (leaf.split, [tuple(c.shape) for c in leaf.cores],
               leaf.experts) for path, leaf in tt_leaves}
    wide_leaf_b, dense_leaf_b = _ttl.tt_leaf_bytes(params_tt)
    info.update(tt_leaf_bytes=wide_leaf_b, dense_leaf_bytes=dense_leaf_b)
    line = (f"weight bytes: dense {info['dense_bytes']:,} -> tt-native "
            f"{info['tt_bytes']:,}")
    if quant is not None:
        params_tt = _ttl.quantize_tt_tree(
            params_tt, dtype=_ttl.quant_dtype(quant), calib=args.quant_calib)
        info["ttq_bytes"] = _ttl.tt_param_bytes(params_tt)
        info["ttq_leaf_bytes"] = _ttl.tt_leaf_bytes(params_tt)[0]
        line += (f" -> tt-{quant} {info['ttq_bytes']:,}; TT-served leaves "
                 f"{wide_leaf_b:,} -> {info['ttq_leaf_bytes']:,} "
                 f"(dense form {dense_leaf_b:,})")
    # the stored bytes one call of each TT leaf reads (its lead row, the
    # cores, the scales); the kernels absorb the lead as the first core
    # streams, so nothing wider is formed
    info["call_bytes"] = {
        path: _ttl.tt_call_bytes(leaf) for path, leaf in
        _tree.leaves_with_paths(params_tt, is_leaf=_ttl.is_tt_linear)
        if _ttl.is_tt_linear(leaf)}
    banks = {p: n for p, n in info["call_bytes"].items()
             if dict(tt_leaves)[p].experts}
    line += (f"; stored bytes one call of each TT leaf reads, summed "
             f"{sum(info['call_bytes'].values()):,}"
             + "".join(f", {p} {n:,}" for p, n in banks.items()))
    info["line"] = line
    return params_tt, payload, info, params


def serve(args, compressed=None) -> dict:
    """Run one batch; returns tok/s, the tokens, the run, the verify
    numbers and the setup info, plus the model, the served params, the
    dense params they came from, the payload and the prompts for further
    checks.  ``compressed``: ``info["compressed"]`` of an earlier run with
    the same ``--arch``, ``--seed``, ``--tt-eps`` and ``--tt-alpha``, whose
    compression this run reuses (``compress_s`` is then that run's)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg, device=args.device)
    rng = np.random.default_rng(args.seed)
    b = args.batch
    max_len = args.prompt_len + args.gen

    payload, info = None, {}
    if args.weights == "dense":
        params = dense = model.init(args.seed)
    else:
        params, payload, info, dense = _tt_setup(model, args, cfg,
                                                 compressed)
        print(f"[serve] compressed on {model.device} in "
              f"{info['compress_s']:.3f}s; TT ranks "
              + ", ".join(f"{k} {v}" for k, v in info["ranks"].items()))
        print(f"[serve] TT-native mode: {info['line']}")

    prompts = rng.integers(0, cfg.vocab_size, size=(b, args.prompt_len),
                           dtype=np.int32)
    run = engine_mod.generate(model, params, prompts, args.gen,
                              max_len=max_len, driver=args.driver)
    verify = None
    if args.weights != "dense" and args.verify:
        # reconstruct-then-serve oracle on the same payload
        params_rx = _comp.TTCompressor().decompress(payload)
        oracle = engine_mod.generate(model, params_rx, prompts, args.gen,
                                     max_len=max_len, driver=args.driver)
        d, scale, agree = model_common.logit_parity(
            run["prompt_logits"], oracle["prompt_logits"])
        verify = {"max_diff": d, "scale": scale, "agree": agree,
                  "bound": model_common.parity_bound(scale)}
        line = f"next-token agreement {agree:.2%}"
        if _quant_of(args.weights) is not None:
            pt = torch.as_tensor(prompts, dtype=torch.int64,
                                 device=model.device)
            tf_q = teacher_forced_logits(model, params, pt)
            tf_rx = teacher_forced_logits(model, params_rx, pt)
            verify["tie_agree"] = tie_tolerant_agreement(tf_q, tf_rx)
            verify["positions"] = int(tf_rx.shape[0] * tf_rx.shape[1])
            line = (f"tie-tolerant next-token agreement "
                    f"{verify['tie_agree']:.2%} over {verify['positions']} "
                    f"teacher-forced positions")
        print(f"[serve] verify vs reconstruct-then-serve: max|Δlogits| "
              f"{d:.2e} (scale {scale:.2e}, bound {verify['bound']:.2e}), "
              f"{line}")
        del params_rx

    gen = run["gen"]
    tps = b * (args.gen - 1) / max(run["decode_t"], 1e-9)
    mode = "dense" if args.weights == "dense" else f"{args.weights}-native"
    print(f"[serve] ({mode}, driver={args.driver}, device={model.device}) "
          f"prefill {args.prompt_len} toks in {run['prefill_t'] * 1e3:.1f}ms; "
          f"decode {args.gen - 1} steps @ {tps:.1f} tok/s (batch={b})")
    print(f"[serve] sample generation: {gen[0][:16].tolist()}")
    return {"tok_per_s": tps, "generated": gen, "run": run,
            "verify": verify, "info": info, "model": model,
            "params": params, "dense_params": dense, "payload": payload,
            "prompts": prompts}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="weights and prompts seed")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the first CUDA card; "
                         "'cpu' runs the plain PyTorch paths)")
    ap.add_argument("--driver", choices=engine_mod.DRIVERS, default="fused",
                    help="'fused' steps on the device with no host read per "
                         "token; 'python' is the per-token oracle")
    ap.add_argument("--weights", choices=("dense", "tt", "tt-int8"),
                    default="dense")
    ap.add_argument("--quant-calib", type=str, default="absmax",
                    help="'absmax' or 'pXX' (percentile of |w|)")
    ap.add_argument("--tt-eps", type=float, default=0.2,
                    help="compression ε for the in-process TT payload")
    ap.add_argument("--tt-alpha", type=float, default=1.0,
                    help="spectral decay of the synthetic trained weights")
    ap.add_argument("--verify", action="store_true", default=True,
                    help="cross-check against reconstruct-then-serve "
                         "(default on)")
    ap.add_argument("--no-verify", dest="verify", action="store_false")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    serve(parse_args(argv))


if __name__ == "__main__":
    main()
