"""Serving driver: one batch through ``engine.generate``, or the HTTP
server.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen1.5-0.5b --weights tt --batch 4 --prompt-len 16 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen1.5-0.5b --weights tt --tt-checkpoint DIR --serve \
        --replicas 2 --slots 4 --port 8000

Two modes share one model setup (``--weights``/``--tt-*`` work in both):

* **batch mode** (default) — one uniform batch, greedy or sampled
  (``--temperature``, ``--top-k``; row r samples under
  ``fold_in(PRNGKey(--seed), r)``), with timing and the TT-vs-dense verify;
* **server mode** (``--serve``) — N ``Engine`` replicas
  (``--replicas``/``--slots``/``--chunk-steps``/``--admission``) sharing
  one params tree behind the router (``--queue-depth``, ``--deadline-ms``,
  ``--watchdog-ms``) and the asyncio HTTP front door (``--host``/
  ``--port``): ``POST /v1/generate``, ``GET /healthz``, ``GET /stats``.
  Requests may not be longer than ``--prompt-len`` + ``--gen`` positions.

``--arch`` is any ported config (``repro_torch.configs.NAME_TO_MODULE``:
qwen1.5-0.5b of the dense family, olmoe-1b-7b of the MoE family,
mamba2-1.3b of the SSM family, recurrentgemma-2b of the hybrid family,
seamless-m4t-large-v2 of the encoder-decoder family); every family serves
through the same ``Model`` API.  In batch mode an encoder-decoder row also gets a random source of
``frontend_len`` tokens from ``--seed``, encoded into its memory before
decode; in server mode a request brings its own ``src_tokens``.

Runs on the first CUDA card unless ``--device cpu`` is given.  With
``--weights tt`` the weights (random from ``--seed``, given a power-law
spectrum as trained weights have) are TT-compressed on the device (paper
Algorithm 1 on the default batched plan, as the reference's serve does),
converted to TT-native params, and decode contracts activations straight
through the cores with the hand-written kernels — the dense matrices are
never rebuilt.  An MoE expert bank serves as one expert-batched chain per
layer (``tt_apply_experts``).  ``--weights tt-int8`` stores the cores as
int8.  ``--save-tt-checkpoint DIR`` writes the payload after the
compression (``checkpoint.save_tt_payload``, the manifest naming the
model family; int8 cores for ``--weights tt-int8``), and ``--tt-checkpoint
DIR`` serves a saved payload instead of compressing, refusing one of
another family.
``--verify`` (default on) reruns the batch on the reconstructed dense
weights and reports logit parity; for int8 it reports tie-tolerant
next-token agreement over every teacher-forced prompt position.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.checkpoint import checkpoint as _ckpt
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


def teacher_forced_logits(model, params, prompts: torch.Tensor,
                          src: Optional[torch.Tensor] = None) -> np.ndarray:
    """Per-position next-token logits over the prompt → (B, S-1, V); an
    encoder-decoder's rows attend to the memory of ``src`` (B, S_src)."""
    b, s = prompts.shape
    cache = model.init_cache(b, s)
    outs = []
    with torch.inference_mode():
        if src is not None:
            cache = model.populate_memory(params, cache, src)
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


def _load_checkpoint(model, args, cfg):
    """The payload of ``--tt-checkpoint`` on the model's device; ``like``
    is the model's own params tree, as the reference's.  A manifest naming
    another family is refused before any array is read (the trees of two
    families differ, so the load would only name the mismatched leaves).
    Returns (payload, report, seconds)."""
    t0 = time.perf_counter()
    ck_family = _ckpt.read_manifest(args.tt_checkpoint).get("family")
    if ck_family is not None and ck_family != cfg.family:
        raise ValueError(
            f"TT checkpoint was compressed from family {ck_family!r}, "
            f"cannot serve arch family {cfg.family!r}")
    like = model.init(args.seed)
    payload, _ = _ckpt.load_tt_payload(args.tt_checkpoint, like=like,
                                       device=model.device)
    del like
    return payload, _comp.payload_report(payload), time.perf_counter() - t0


def _tt_setup(model, args, cfg, compressed=None):
    """The payload — compressed here (``_compress``), taken from
    ``compressed`` (an earlier run's compression of the same weights) or
    loaded from ``--tt-checkpoint`` — and the TT-native params.

    Returns (params_tt, payload, info, the dense params compressed: None
    for a loaded payload)."""
    quant = _quant_of(args.weights)
    load_s = None
    if args.tt_checkpoint:
        payload, report, load_s = _load_checkpoint(model, args, cfg)
        params, compress_s, compressed = None, None, None
    else:
        params, payload, report, compress_s = compressed or _compress(
            model, args)
        compressed = (params, payload, report, compress_s)
        if args.save_tt_checkpoint:
            _ckpt.save_tt_payload(
                args.save_tt_checkpoint, payload,
                extra={"eps": args.tt_eps, "arch": cfg.name},
                family=cfg.family, quant=quant, quant_calib=args.quant_calib)
            print(f"[serve] TT payload saved to {args.save_tt_checkpoint}"
                  + (f" ({quant} cores)" if quant else ""))
    params_tt = model_common.tt_native_params(payload, family=cfg.family)
    info = {
        "compressed": compressed,
        "compress_s": compress_s,
        "load_s": load_s,
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


def _setup(args, compressed=None):
    """The model on its device and its params: dense, or TT-native from a
    compression here or ``--tt-checkpoint`` (``_tt_setup``).  Returns (cfg,
    model, params, payload, info, dense params)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        # an encoder-decoder keeps as many encoder layers as decoder ones
        cfg = dataclasses.replace(
            cfg, num_layers=args.layers,
            enc_layers=args.layers if cfg.enc_layers else 0)
    model = build(cfg, device=args.device)
    if args.weights == "dense":
        params = model.init(args.seed)
        return cfg, model, params, None, {}, params
    params, payload, info, dense = _tt_setup(model, args, cfg, compressed)
    how = (f"loaded from {args.tt_checkpoint} in {info['load_s']:.3f}s"
           if args.tt_checkpoint else
           f"compressed on {model.device} in {info['compress_s']:.3f}s")
    print(f"[serve] {how}; TT ranks "
          + ", ".join(f"{k} {v}" for k, v in info["ranks"].items()))
    print(f"[serve] TT-native mode: {info['line']}")
    return cfg, model, params, payload, info, dense


def serve(args, compressed=None) -> dict:
    """Run one batch; returns tok/s, the tokens, the run, the verify
    numbers and the setup info, plus the model, the served params, the
    dense params they came from, the payload, the prompts and the sources
    (None for a token-only family) for further checks.  ``compressed``: ``info["compressed"]`` of an earlier run with
    the same ``--arch``, ``--seed``, ``--tt-eps`` and ``--tt-alpha``, whose
    compression this run reuses (``compress_s`` is then that run's)."""
    cfg, model, params, payload, info, dense = _setup(args, compressed)
    rng = np.random.default_rng(args.seed)
    b = args.batch
    max_len = args.prompt_len + args.gen

    prompts = rng.integers(0, cfg.vocab_size, size=(b, args.prompt_len),
                           dtype=np.int32)
    # an encoder-decoder row carries encoder input: a source of
    # frontend_len tokens, encoded into its memory before decode
    src = None
    if model.populate_memory is not None:
        src = rng.integers(0, cfg.vocab_size, size=(b, cfg.frontend_len),
                           dtype=np.int32)
    sample_kw = dict(src_tokens=src, temperature=args.temperature,
                     top_k=args.top_k, seed=args.seed)
    run = engine_mod.generate(model, params, prompts, args.gen,
                              max_len=max_len, driver=args.driver,
                              **sample_kw)
    verify = None
    if args.weights != "dense" and args.verify:
        # reconstruct-then-serve oracle on the same payload
        params_rx = _comp.TTCompressor().decompress(payload)
        oracle = engine_mod.generate(model, params_rx, prompts, args.gen,
                                     max_len=max_len, driver=args.driver,
                                     **sample_kw)
        d, scale, agree = model_common.logit_parity(
            run["prompt_logits"], oracle["prompt_logits"])
        verify = {"max_diff": d, "scale": scale, "agree": agree,
                  "bound": model_common.parity_bound(scale)}
        line = f"next-token agreement {agree:.2%}"
        if _quant_of(args.weights) is not None:
            pt, ps = (None if a is None else torch.as_tensor(
                a, dtype=torch.int64, device=model.device)
                for a in (prompts, src))
            tf_q = teacher_forced_logits(model, params, pt, ps)
            tf_rx = teacher_forced_logits(model, params_rx, pt, ps)
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
            "prompts": prompts, "src": src}


def make_router(args):
    """Server mode's stack below the HTTP front door: the model on its
    device, its params (dense, compressed here or loaded from
    ``--tt-checkpoint``) and ``--replicas`` Engines sharing that one params
    tree (each replica adds a cache pool, not a copy of the weights),
    behind a Router.  Returns (router, model, params)."""
    from repro_torch.launch.router import Router

    _, model, params, _, _, _ = _setup(args)
    max_len = args.prompt_len + args.gen
    engines = [
        engine_mod.Engine(
            model, params, slots=args.slots, max_len=max_len,
            chunk_steps=args.chunk_steps, temperature=args.temperature,
            top_k=args.top_k, seed=args.seed, admission=args.admission)
        for _ in range(args.replicas)]
    watchdog = None if args.watchdog_ms is None else args.watchdog_ms / 1e3
    router = Router(engines, queue_depth=args.queue_depth,
                    watchdog_s=watchdog)
    print(f"[serve] {args.replicas} replica(s) x {args.slots} slots on "
          f"{model.device}, admission={engines[0].admission}, "
          f"queue_depth={args.queue_depth}, max_len={max_len}"
          + (f", watchdog={watchdog:g}s" if watchdog else ""))
    return router, model, params


def serve_http(args) -> None:
    """Server mode: ``make_router`` behind the HTTP front door, until
    interrupted."""
    from repro_torch.launch.server import run_server

    router, _, _ = make_router(args)
    deadline = None if args.deadline_ms is None else args.deadline_ms / 1e3
    run_server(router, host=args.host, port=args.port,
               default_deadline=deadline)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve only the first N layers of --arch (a cut "
                         "of depth: every width as configured; an "
                         "encoder-decoder keeps N encoder and N decoder "
                         "layers)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="weights/prompts seed AND the sampling seed (row r "
                         "samples under fold_in(PRNGKey(seed), r))")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 (default) is the greedy "
                         "argmax (in server mode: the requests' default)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="keep only the k highest logits before sampling "
                         "(matters with --temperature > 0)")
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
    ap.add_argument("--tt-checkpoint", type=str, default=None,
                    help="serve the TT payload saved in this directory "
                         "(checkpoint.save_tt_payload layout) instead of "
                         "compressing; its manifest's family must be "
                         "--arch's")
    ap.add_argument("--save-tt-checkpoint", type=str, default=None,
                    help="after the compression, save the TT payload here "
                         "(the manifest records the model family)")
    ap.add_argument("--verify", action="store_true", default=True,
                    help="cross-check against reconstruct-then-serve "
                         "(default on)")
    ap.add_argument("--no-verify", dest="verify", action="store_false")
    ap.add_argument("--serve", action="store_true",
                    help="server mode: run the HTTP front door instead of "
                         "one batch (POST /v1/generate)")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="TCP port (0 = ephemeral, printed at startup)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the router (weights "
                         "shared; each replica adds one cache pool and a "
                         "worker thread)")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent requests per replica (cache pool rows)")
    ap.add_argument("--chunk-steps", type=int, default=8,
                    help="decode steps per scheduling chunk")
    ap.add_argument("--queue-depth", type=int, default=16,
                    help="max outstanding requests per replica before "
                         "submissions get 429")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request deadline; an expired request "
                         "is cancelled (504) and its slot freed; requests "
                         "may set their own 'deadline_ms'")
    ap.add_argument("--watchdog-ms", type=float, default=None,
                    help="a replica whose worker goes stale longer than "
                         "this while holding work is marked suspect (no new "
                         "placements) until it recovers; a dead worker is "
                         "always failed over and restarted")
    ap.add_argument("--admission", choices=engine_mod.ADMISSION_MODES,
                    default="auto",
                    help="slot admission: 'scan' admits inside a chunk from "
                         "a device queue, 'boundary' between chunks; "
                         "'auto' is 'scan', or 'boundary' for a family "
                         "with encoder input")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.serve:
        serve_http(args)
    else:
        serve(args)


if __name__ == "__main__":
    main()
