"""Serving engine: ``generate`` over one uniform batch, two drivers.

* ``python`` — the oracle: one ``decode_step`` per token driven from
  Python, with the argmax read back to the host every token.
* ``fused``  — the device loop: every step is ``common.gen_step``
  (prompt consumption, argmax, append as masked device ops), so the host
  only enqueues work and reads the tokens once at the end.

Both prefill by stepping the decode cache through the prompt and return
the same contract, token for token.  Sampling (temperature > 0) needs the
reference's threefry streams and is not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import common as model_common

DRIVERS = ("fused", "python")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _python_loop(model, params, cache, prompts: torch.Tensor, gen: int):
    b, prompt_len = prompts.shape
    dev = model.device
    t0 = time.perf_counter()
    logits = None
    with torch.inference_mode():
        for i in range(prompt_len):
            logits, cache = model.decode_step(params, cache,
                                              prompts[:, i:i + 1])
        _sync(dev)
        prefill_t = time.perf_counter() - t0
        prompt_logits = logits
        tok = logits.argmax(dim=-1)[:, None]
        out_tokens = [tok.cpu().numpy()]
        t0 = time.perf_counter()
        for _ in range(1, gen):
            logits, cache = model.decode_step(params, cache, tok)
            tok = logits.argmax(dim=-1)[:, None]
            out_tokens.append(tok.cpu().numpy())
        _sync(dev)
    return {
        "prefill_t": prefill_t,
        "decode_t": time.perf_counter() - t0,
        "gen": np.concatenate(out_tokens, axis=1).astype(np.int32),
        "prompt_logits": prompt_logits.float(),
    }


def _fused_generate(model, params, cache, prompts: torch.Tensor, gen: int):
    b, prompt_len = prompts.shape
    dev = model.device
    t_max = int(prompt_len + gen)
    tokens = torch.zeros((b, t_max), dtype=torch.int64, device=dev)
    tokens[:, :prompt_len] = prompts
    state = model_common.gen_init(cache, tokens, prompt_len, t_max,
                                  model.cfg.padded_vocab_size)
    with torch.inference_mode():
        t0 = time.perf_counter()
        for _ in range(prompt_len):
            state = model_common.gen_step(model.decode_step, params, state)
        _sync(dev)
        prefill_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            state = model_common.gen_step(model.decode_step, params, state)
        _sync(dev)
    return {
        "prefill_t": prefill_t,
        "decode_t": time.perf_counter() - t0,
        "gen": state.tokens[:, prompt_len:].cpu().numpy().astype(np.int32),
        "prompt_logits": state.prompt_logits,
    }


def generate(model, params, prompts, gen: int, max_len: Optional[int] = None,
             driver: str = "fused", temperature: float = 0.0) -> dict:
    """One uniform-batch serving run (greedy).

    Returns ``{prefill_t, decode_t, gen (B, gen) np.int32, prompt_logits}``
    — the same contract and tokens for both drivers."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r} (choose from {DRIVERS})")
    if temperature != 0.0:
        raise NotImplementedError(
            "sampling (temperature > 0) needs the threefry streams of the "
            "reference and is not ported yet (ROADMAP queue 1, item 4)")
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                              device=model.device)
    b = prompts.shape[0]
    if max_len is None:
        max_len = prompts.shape[1] + gen
    cache = model.init_cache(b, max_len)
    if driver == "python":
        return _python_loop(model, params, cache, prompts, gen)
    return _fused_generate(model, params, cache, prompts, gen)
