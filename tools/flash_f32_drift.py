"""Where the float32 flash route's prefill gap (gate G1 of ``chip_smoke.py``)
grows: full-width, full-depth recurrentgemma-2b with dense float32 weights
(random from seed 0 with the spectral decay, as ``serve`` makes them; no
compression), the prefill's batch (B 2 × S 4,096, tokens from seed 1).

    python3 tools/flash_f32_drift.py [--layers N] [--out FILE]

1. The forward layer by layer, four times, each attention layer computed
   by: ``kernel`` (``impl="pallas"``: ``flash_attention_f32``, 3xTF32 on the
   tensor cores, whose float32 accumulation truncates), ``plain``
   (``impl="xla"``: the chunked float32 path, the gate's reference),
   ``emulated`` (``ref.mha_tf32x3``: the route's tile walk and 3xTF32
   split in plain torch, summed with round-to-nearest float32 adds) and
   ``exact`` (``ref.mha_ref`` in float64, rounded to float32).  After each
   layer, each run's hidden state against ``plain``'s and ``exact``'s
   (max|d| / max|ref|), and the last position's logits (G1 is ``kernel``
   against ``plain`` there).
2. Every attention layer's q, k, v of the ``plain`` run through each
   attention alone, against ``mha_ref`` in float64: max|d| / max|ref|, and
   the signed mean of (o - o64)·sign(o64) over mean|o64|, which is negative
   where magnitudes shrink (a round-toward-zero bias) and near zero for
   unbiased rounding.

If ``emulated`` tracks ``plain`` and ``exact`` where ``kernel`` drifts, the
kernel's truncating accumulation (or another difference between kernel
and emulation) makes the growth; if ``emulated`` drifts as ``kernel`` does,
the 3xTF32 split's rounding does.  Prints one JSON line per layer and a
summary line with the card's name; ``--out`` also writes them to a file.
"""

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

ARCH = "recurrentgemma-2b"
PREFILL_B, PREFILL_S = 2, 4096
# exact before kernel and emulated: both are held to it too
RUNS = ("plain", "exact", "kernel", "emulated")
DEVICE = "cuda"


def _gap(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def _bias(got, ref64) -> float:
    """mean((got - ref)·sign(ref)) / mean|ref|: < 0 where |got| < |ref|."""
    d = (got.double() - ref64) * torch.sign(ref64)
    return float(d.mean() / ref64.abs().mean())


def _attention(run: str):
    """The ``mha_flash`` stand-in of one run (``causal_attend`` looks it up
    in the ops module at each call)."""
    from repro_torch.kernels.flash_attention import ref
    if run == "emulated":
        return lambda q, k, v, causal=True, window=None: ref.mha_tf32x3(
            q, k, v, causal=causal, window=window)
    return lambda q, k, v, causal=True, window=None: ref.mha_ref(
        q.double(), k.double(), v.double(), causal=causal,
        window=window).float()


def forward_layers(params, tokens, cfg, impl, keep):
    """The hybrid forward (``rglru.forward``) with ``keep(i, kind, x)``
    called on the hidden state after each layer; returns the last
    position's logits (B, V)."""
    from repro_torch.models import common, rglru
    x = rglru._embed(params, tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    n_triples, n_tail = rglru.plan(cfg)
    i = 0
    for l in range(n_triples):
        tp = common.layer_at(params.triples, l)
        for kind, fn in (("rglru", lambda h: rglru._rglru_block(h, tp.r1,
                                                                  cfg)),
                         ("rglru", lambda h: rglru._rglru_block(h, tp.r2,
                                                                  cfg)),
                         ("attn", lambda h: rglru._attn_block(
                             h, tp.at, cfg, positions, impl))):
            x = fn(x)
            keep(i, kind, x)
            i += 1
    for l in range(n_tail):
        x = rglru._rglru_block(x, common.layer_at(params.tail, l), cfg)
        keep(i, "rglru", x)
        i += 1
    h = common.rms_norm(x, params.final_norm, cfg.norm_eps)
    return common.unembed(h[:, -1:, :], params.embed, cfg.logit_softcap,
                          real_vocab=cfg.vocab_size)[:, 0, :]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="the first N layers only (default: all 26)")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_f32_drift: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core.tt_linear import spectral_decay_pytree
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models import attention as attn
    from repro_torch.models.registry import build

    t_start = time.perf_counter()
    cfg = get_config(ARCH)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = spectral_decay_pytree(build(cfg, device=DEVICE).init(0),
                                   alpha=1.0)
    dense32 = tree.map_leaves(lambda x: x.float(), params)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=g, device=DEVICE)
    window = cfg.hybrid.window
    lines = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        lines.append(rec)

    # 1. the four runs, hidden states compared layer by layer
    hidden = {}
    qkv = []
    logits = {}
    real_flash = fa_ops.mha_flash
    real_attend = attn.causal_attend
    per_layer = {}
    for run in RUNS:
        impl = "xla" if run == "plain" else "pallas"
        if run in ("emulated", "exact"):
            fa_ops.mha_flash = _attention(run)
        if run == "plain":
            def recording(q, k, v, *a, **kw):
                qkv.append((q.clone(), k.clone(), v.clone()))
                return real_attend(q, k, v, *a, **kw)
            attn.causal_attend = recording

        def keep(i, kind, x, run=run):
            if run in ("plain", "exact"):
                hidden[(run, i)] = x.clone()
            rec = per_layer.setdefault(i, {"layer": i, "kind": kind})
            if run != "plain":
                rec[f"{run}_vs_plain"] = _gap(x, hidden[("plain", i)])
            if run in ("kernel", "emulated"):
                rec[f"{run}_vs_exact"] = _gap(x, hidden[("exact", i)])
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits[run] = forward_layers(dense32, tokens, cfg32, impl, keep)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        fa_ops.mha_flash = real_flash
        attn.causal_attend = real_attend
        print(f"[drift] run {run}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    for i in sorted(per_layer):
        emit(per_layer[i])
    hidden.clear()
    g1 = {f"{run}_vs_plain": _gap(logits[run], logits["plain"])
          for run in RUNS if run != "plain"}
    g1.update({f"{run}_vs_exact": _gap(logits[run], logits["exact"])
               for run in ("kernel", "emulated")})

    # 2. each attention layer alone on the plain run's q, k, v
    attn_rows = []
    for n, (q, k, v) in enumerate(qkv):
        with torch.inference_mode():
            o64 = ref.mha_ref(q.double(), k.double(), v.double(),
                              causal=True, window=window)
            outs = {"kernel": real_flash(q, k, v, causal=True, window=window),
                    "emulated": ref.mha_tf32x3(q, k, v, causal=True,
                                               window=window),
                    "plain": real_attend(q, k, v, cfg32, window=window)}
        rec = {"attention_layer": n}
        for name, o in outs.items():
            rec[f"{name}_vs_f64"] = _gap(o, o64)
            rec[f"{name}_bias"] = _bias(o, o64)
        emit(rec)
        attn_rows.append(rec)
        del o64, outs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    emit({"summary": True, "layers": cfg.num_layers, "G1": g1,
          "worst_attention": {k: max(r[k] for r in attn_rows)
                              for k in attn_rows[0] if k.endswith("_f64")},
          "mean_bias": {k: sum(r[k] for r in attn_rows) / len(attn_rows)
                        for k in attn_rows[0] if k.endswith("_bias")},
          "seconds": time.perf_counter() - t_start, "card": card,
          "device": torch.cuda.get_device_name(0),
          "note": "G1 = kernel_vs_plain; 2^-14 = %.3e" % math.ldexp(1, -14)})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
