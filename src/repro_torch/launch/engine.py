"""Serving engine: ``generate`` over one uniform batch, and continuous
batching.

``generate(model, params, prompts, gen, driver=...)`` — one uniform batch,
two drivers:

* ``python`` — the oracle: one ``decode_step`` per token driven from
  Python, the sampled token read back to the host every token.
* ``fused``  — the device loop: every step is ``common.gen_step``
  (prompt consumption, sampling, append as masked device ops), so the host
  only enqueues work and reads the tokens once at the end.

Both prefill by stepping the decode cache through the prompt and sample
under the same per-row ``fold_in(keys[row], t)`` streams (greedy at
temperature 0), so they agree token for token.  An encoder-decoder run
(``src_tokens``) encodes its sources into the cache's memory rows first.

``Engine`` — continuous batching over the fused driver: a slot pool with
per-slot lengths and sampling params and two admission modes; see its
docstring.  One level up, ``launch/router.py`` spreads requests over N
Engine replicas and ``launch/server.py`` puts the HTTP front door in front
of the router.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch import tree as _tree
from repro_torch.models import common as model_common

DRIVERS = ("fused", "python")
ADMISSION_MODES = ("auto", "scan", "boundary")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _python_loop(model, params, cache, prompts: torch.Tensor, gen: int,
                 sampling=model_common.GREEDY, keys=None):
    b, prompt_len = prompts.shape
    dev = model.device
    t0 = time.perf_counter()
    logits = None

    def pick(logits, t):
        if sampling.temperature == 0.0:
            return logits.argmax(dim=-1)[:, None]
        keys_t = prng.fold_in(keys, torch.full((b,), t, dtype=torch.int64,
                                               device=dev))
        return model_common.sample_tokens(logits, keys_t, sampling)[:, None]

    with torch.inference_mode():
        for i in range(prompt_len):
            logits, cache = model.decode_step(params, cache,
                                              prompts[:, i:i + 1])
        _sync(dev)
        prefill_t = time.perf_counter() - t0
        prompt_logits = logits
        tok = pick(logits, 0)
        out_tokens = [tok.cpu().numpy()]
        t0 = time.perf_counter()
        for t in range(1, gen):
            logits, cache = model.decode_step(params, cache, tok)
            tok = pick(logits, t)
            out_tokens.append(tok.cpu().numpy())
        _sync(dev)
    return {
        "prefill_t": prefill_t,
        "decode_t": time.perf_counter() - t0,
        "gen": np.concatenate(out_tokens, axis=1).astype(np.int32),
        "prompt_logits": prompt_logits.float(),
    }


def _run_steps(decode_step, params, state, n_steps: int,
               sampling=model_common.GREEDY, schedule=None):
    """``n_steps`` fused decode steps (``common.gen_scan``) under inference
    mode; nothing here reads the device."""
    with torch.inference_mode():
        return model_common.gen_scan(decode_step, params, state, n_steps,
                                     sampling, schedule)


def _fused_generate(model, params, cache, prompts: torch.Tensor, gen: int,
                    sampling=model_common.GREEDY, keys=None):
    b, prompt_len = prompts.shape
    dev = model.device
    t_max = int(prompt_len + gen)
    tokens = torch.zeros((b, t_max), dtype=torch.int64, device=dev)
    tokens[:, :prompt_len] = prompts
    state = model_common.gen_init(cache, tokens, prompt_len, t_max,
                                  model.cfg.padded_vocab_size, rng=keys)
    t0 = time.perf_counter()
    state = _run_steps(model.decode_step, params, state, prompt_len,
                       sampling)
    _sync(dev)
    prefill_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    if gen > 1:
        state = _run_steps(model.decode_step, params, state, gen - 1,
                           sampling)
    _sync(dev)
    return {
        "prefill_t": prefill_t,
        "decode_t": time.perf_counter() - t0,
        "gen": state.tokens[:, prompt_len:].cpu().numpy().astype(np.int32),
        "prompt_logits": state.prompt_logits,
    }


def generate(model, params, prompts, gen: int, max_len: Optional[int] = None,
             driver: str = "fused", src_tokens=None,
             temperature: float = 0.0, top_k: Optional[int] = None,
             seed: int = 0) -> dict:
    """One uniform-batch serving run.

    Returns ``{prefill_t, decode_t, gen (B, gen) np.int32, prompt_logits}``
    — the same contract and tokens for both drivers.  ``temperature`` /
    ``top_k`` / ``seed``: row ``r`` samples under
    ``fold_in(PRNGKey(seed), r)``; temperature 0 (the default) is the
    greedy argmax.

    ``src_tokens`` — the encoder input of an encoder-decoder family:
    (S_src,) shared by every row or (B, S_src) a row; encoded once up front
    into the cache's memory rows (``model.populate_memory``) before any
    decode step.  A token-only family refuses it."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r} (choose from {DRIVERS})")
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    if src_tokens is not None and model.populate_memory is None:
        raise ValueError(
            f"family {model.cfg.family!r} takes token-only input (no "
            f"encoder memory); src_tokens is encdec-only")
    sampling = model_common.make_sampling(temperature, top_k)
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                              device=model.device)
    b = prompts.shape[0]
    if max_len is None:
        max_len = prompts.shape[1] + gen
    cache = model.init_cache(b, max_len)
    if src_tokens is not None:
        src = np.asarray(src_tokens, np.int64)
        if src.ndim == 1:
            src = np.broadcast_to(src, (b, src.shape[0]))
        cap = model.cfg.frontend_len
        if src.shape[1] > cap:
            raise ValueError(
                f"src_tokens needs {src.shape[1]} encoder positions, the "
                f"cache's memory rows hold {cap}")
        with torch.inference_mode():
            cache = model.populate_memory(
                params, cache, torch.as_tensor(np.ascontiguousarray(src),
                                               device=model.device))
    keys = model_common.slot_keys(seed, b, device=model.device)
    if driver == "python":
        return _python_loop(model, params, cache, prompts, gen, sampling,
                            keys)
    return _fused_generate(model, params, cache, prompts, gen, sampling,
                           keys)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

class Request(NamedTuple):
    uid: int
    prompt: np.ndarray            # (plen,) int32
    gen: int
    key: np.ndarray               # (2,) int64 sampling base key
    temp: float = 0.0             # per-request temperature (0 = greedy)
    topk: int = 0                 # per-request top-k (0 = no filter)
    src_tokens: Optional[np.ndarray] = None   # (slen,) int32 encoder input


class InvalidRequest(ValueError):
    """A submission rejected at validation — bad shape, bad sampling
    params, out-of-range tokens, or capacity the pool cannot hold.  The
    request never took a queue slot (HTTP 400)."""


class Completion(NamedTuple):
    uid: int
    tokens: np.ndarray            # (gen,) int32 generated tokens
    prompt_logits: np.ndarray     # (V,) float32 logits after the prompt
    bad: bool = False             # tripped the NaN/Inf logit guard: the
                                  # tokens are poisoned; quarantine them


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy (on the CPU ``.cpu()`` would share the device buffer,
    which the next step or admission overwrites)."""
    return t.to("cpu", copy=True).numpy()


def _admit_slot(state, i: int, token_row, prompt_len: int, total_len: int,
                key_row, temp: float, topk: int):
    """Reset slot ``i`` for a new request between chunks: cache rows
    zeroed, prompt written, lengths, key and sampling params set, guard
    cleared, slot active.  (The pool's buffers are inference tensors once
    a step has run, so every update of them runs in inference mode.)"""
    with torch.inference_mode():
        for leaf in _tree.leaves(state.cache):
            model_common.zero_slot_leaf(leaf, i)
        state.tokens[i] = token_row
        state.prompt_len[i].fill_(prompt_len)
        state.total_len[i].fill_(total_len)
        state.active[i].fill_(True)
        state.prompt_logits[i].fill_(0.0)
        state.rng[i] = key_row
        state.temp[i].fill_(temp)
        state.topk[i].fill_(topk)
        state.bad[i].fill_(False)
    return state


def _deactivate_slot(state, i: int):
    """Cancel an in-flight slot between chunks: freeze it (active=False);
    the next admission zeroes its buffers.  A slot frozen here never
    retires inside a step, so no harvest copies it."""
    with torch.inference_mode():
        state.active[i].fill_(False)
    return state


def _refill_scan(state, q_tokens, q_plen, q_tlen, q_rng, q_temp, q_topk):
    """Before a chunk under scan admission: copy the pending window into
    the device queue (one host-to-device copy per field and chunk, however
    many requests it carries)."""
    q = state.queue
    with torch.inference_mode():
        for dst, src in ((q.tokens, q_tokens), (q.prompt_len, q_plen),
                         (q.total_len, q_tlen), (q.rng, q_rng),
                         (q.temp, q_temp), (q.topk, q_topk)):
            dst.copy_(torch.from_numpy(src))
    return state


class Engine:
    """Slot-based continuous-batching engine over the fused decode driver.

    ``slots`` cache rows step together in chunks of up to ``chunk_steps``
    steps.  Each admission resets exactly one slot — cache rows zeroed,
    prompt written, per-slot lengths, key and sampling params set — so a
    stream of unequal requests keeps every slot busy instead of padding to
    the longest.  Two admission modes:

    * ``admission="scan"`` (the default of token-only families) — the
      pending window rides on the device (``common.ScanQueue``, uploaded
      once a chunk) and a slot that retires mid-chunk is refilled on the
      NEXT step without ending the chunk.  The host mirrors the schedule
      step by step (FIFO order, lowest free slot first, retirement in slot
      order) and hands each step its admissions and harvests as ``(slot,
      row)`` pairs: the step copies those rows between device buffers at
      those indices (there is no ``lax.scan`` whose body would need a
      masked sweep over every slot).  A retiring slot's rows are copied to
      the device done buffer (``DoneBuf``) before a re-admission can
      overwrite them; the host reads it once a chunk.
    * ``admission="boundary"`` — harvest and one admission per request
      between chunks (the default, and the only mode, of a family with
      encoder input).

    Both give byte-equal completions: a slot's row runs the same
    arithmetic at the same pool size wherever it is admitted.

    Decode is deterministic in length: a request with prompt ``plen`` and
    budget ``gen`` retires after exactly ``plen + gen - 1`` steps
    (sampling changes which tokens come out, never how many).  So the
    engine schedules by host arithmetic alone and nothing inside a chunk
    reads the device; the device is read once per request at harvest (plus
    ``peek_tokens`` for streaming callers).

    Sampling is per request: ``submit(..., temperature=, top_k=, seed=)``
    rides the slot as ``GenState.temp``/``topk``/``rng``; the engine-level
    ``temperature``/``top_k`` are the defaults.  Keys advance with the
    slot's own progress, so staggered == isolated holds token for token
    under any mix of params.

    ``cancel(uid)`` abandons a request (pending: dropped; in flight: its
    slot is frozen at once and freed for the next admission); the router
    uses it for deadlines and client disconnects.

    Encoder-decoder requests ride slots like any other: ``submit`` takes
    the request's source tokens, and its admission resets the slot and
    encodes the source (``model.admit_memory``), writing the projected
    cross-attention K/V into that slot's memory rows; ``mem_len`` masks
    the unused tail rows.  A token-only admission leaves the zeroed rows
    and ``mem_len`` 0, so a recycled slot never shows a previous
    occupant's memory.  The encode runs on the host's schedule between
    chunks, so such a family takes boundary admission only.

    Families: dense, SSM, hybrid, MoE (token-only: ``src_tokens`` raises)
    and encoder-decoder.  The SSM's and the hybrid's recurrent state and
    conv history are zeroed with the slot at admission; a free slot's
    state runs on in lockstep until then, its rows discarded.  MoE serves, but staggered == isolated is not
    promised there (expert capacity couples the rows of a batch;
    ``mlp.moe_apply``).
    """

    def __init__(self, model, params, slots: int = 4, max_len: int = 128,
                 chunk_steps: int = 8, temperature: float = 0.0,
                 top_k: Optional[int] = None, seed: int = 0,
                 admission: str = "auto", queue_cap: Optional[int] = None):
        if admission not in ADMISSION_MODES:
            raise ValueError(
                f"unknown admission mode {admission!r} "
                f"(choose from {ADMISSION_MODES})")
        if admission == "auto":
            admission = ("boundary" if model.admit_memory is not None
                         else "scan")
        if admission == "scan" and model.admit_memory is not None:
            raise ValueError(
                f"family {model.cfg.family!r} carries encoder input; "
                f"admission runs the encode between chunks, so it must use "
                f"admission='boundary' (or 'auto')")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.chunk_steps = chunk_steps
        self.admission = admission
        self.sampling = model_common.make_sampling(temperature, top_k)
        self.seed = seed
        # encoder positions a slot's memory rows hold (0: token-only)
        self.src_capacity = (model.cfg.frontend_len
                             if model.admit_memory is not None else 0)
        self._step = model.decode_step
        self.queue: deque = deque()
        self._occupant: List[Optional[Request]] = [None] * slots
        self._remaining = [0] * slots         # steps until retirement
        self._uid = 0
        self.steps = 0            # steps run (occupancy accounting)
        self.slot_steps = 0       # steps × busy slots (useful work)
        # at most one admission (and one retirement) per slot per step
        self._queue_cap = (slots * chunk_steps if queue_cap is None
                           else queue_cap)
        dev = model.device
        vocab = model.cfg.padded_vocab_size
        scan_mode = admission == "scan"
        self.state = model_common.gen_init(
            model.init_cache(slots, max_len),
            torch.zeros((slots, max_len), dtype=torch.int64, device=dev),
            prompt_len=1, total_len=1, vocab=vocab, active=False,
            temp=0.0, topk=0,
            queue=(model_common.make_scan_queue(self._queue_cap, max_len,
                                                dev) if scan_mode else None),
            done=(model_common.make_done_buf(slots * chunk_steps, max_len,
                                             vocab, dev)
                  if scan_mode else None),
            bad=False)

    @property
    def busy_slots(self) -> int:
        """Slots currently occupied (host view; exact between chunks)."""
        return sum(1 for r in self._occupant if r is not None)

    @property
    def pending(self) -> int:
        """Requests queued but not yet admitted (host view)."""
        return len(self.queue)

    @property
    def outstanding(self) -> int:
        """Requests submitted and not completed: pending + in flight (the
        router's least-outstanding placement metric)."""
        return self.pending + self.busy_slots

    @property
    def occupancy(self) -> float:
        """Lifetime useful-work share: busy slot-steps / slot-steps."""
        return self.slot_steps / max(self.steps * self.slots, 1)

    def _token_ids(self, x, what: str) -> np.ndarray:
        """One token-id field as a flat int32 array; garbage (non-numeric,
        non-integral, out of vocab) raises ``InvalidRequest``."""
        try:
            arr = np.asarray(x)
        except Exception as e:
            raise InvalidRequest(f"{what} is not array-like: {e}") from None
        if arr.dtype.kind == "f":
            if arr.size and not np.all(np.isfinite(arr)
                                       & (arr == np.floor(arr))):
                raise InvalidRequest(
                    f"{what} must be integer token ids, got non-integral "
                    f"floats")
        elif arr.dtype.kind not in "iu":
            raise InvalidRequest(
                f"{what} must be integer token ids, got dtype {arr.dtype}")
        arr = arr.reshape(-1).astype(np.int32)
        vocab = self.model.cfg.vocab_size
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= vocab):
            raise InvalidRequest(
                f"{what} token ids must be in [0, {vocab}), got range "
                f"[{int(arr.min())}, {int(arr.max())}]")
        return arr

    def validate(self, prompt, gen: int, src_tokens=None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None):
        """Normalize and validate a request without queuing it — the
        front door's fail-fast check (a bad request must 400 before it takes
        a queue slot).  Returns ``(prompt, src, sampling)`` (``src`` None
        for a token-only request); raises ``InvalidRequest`` (a
        ``ValueError``) on anything malformed."""
        prompt = self._token_ids(prompt, "prompt")
        if not isinstance(gen, (int, np.integer)):
            raise InvalidRequest(
                f"gen must be an integer, got {type(gen).__name__}")
        if len(prompt) < 1 or gen < 1:
            raise InvalidRequest(
                f"request needs a non-empty prompt and gen >= 1, got "
                f"plen={len(prompt)} gen={gen}")
        src = None
        if src_tokens is not None:
            if self.model.admit_memory is None:
                raise InvalidRequest(
                    f"family {self.model.cfg.family!r} takes token-only "
                    f"requests (no encoder input); src_tokens is "
                    f"encdec-only")
            src = self._token_ids(src_tokens, "src_tokens")
            if len(src) < 1:
                raise InvalidRequest(
                    "src_tokens, when given, must be non-empty")
        need_dec = len(prompt) + gen
        need_enc = 0 if src is None else len(src)
        if need_dec > self.max_len or need_enc > self.src_capacity:
            raise InvalidRequest(
                f"request needs {need_dec} decoder positions"
                + (f" and {need_enc} encoder positions" if src is not None
                   else "")
                + f", pool rows hold {self.max_len} decoder"
                + (f" and {self.src_capacity} encoder" if src is not None
                   else "")
                + " positions")
        try:
            s = model_common.make_sampling(
                self.sampling.temperature if temperature is None
                else temperature,
                self.sampling.top_k if top_k is None else top_k)
        except (TypeError, ValueError) as e:
            raise InvalidRequest(str(e)) from None
        return prompt, src, s

    def submit(self, prompt, gen: int, src_tokens=None,
               seed: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None) -> int:
        """Queue one request; returns its uid (completions match by uid).

        ``temperature``/``top_k`` override the engine's defaults for this
        request; ``seed`` gives it the row-0 key of an isolated
        ``generate(..., seed=seed)`` run, so sampled staggered-vs-isolated
        parity holds key for key."""
        prompt, src, s = self.validate(prompt, gen, src_tokens, temperature,
                                       top_k)
        uid = self._uid
        self._uid += 1
        if seed is not None:
            key = model_common.slot_keys(seed, 1)[0]
        else:
            # the uid folded into the engine's stream (not seed + uid: an
            # explicit per-request seed must not collide with it)
            key = prng.fold_in(model_common.slot_keys(self.seed, 1)[0], uid)
        self.queue.append(Request(
            uid, prompt, int(gen), key.numpy(), temp=s.temperature,
            topk=0 if s.top_k is None else s.top_k, src_tokens=src))
        return uid

    def cancel(self, uid: int) -> bool:
        """Abandon a request: pending → removed; in flight → its slot is
        frozen and freed for re-admission.  False when the uid is unknown
        or already completed.  A cancelled request gives no Completion."""
        for j, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[j]
                return True
        for i in range(self.slots):
            occ = self._occupant[i]
            if occ is not None and occ.uid == uid:
                self.state = _deactivate_slot(self.state, i)
                self._occupant[i] = None
                self._remaining[i] = 0
                return True
        return False

    def progress(self, uid: int) -> Optional[int]:
        """Generated tokens available so far for an in-flight request
        (host arithmetic; exact between chunks); None when not in a slot."""
        for i in range(self.slots):
            occ = self._occupant[i]
            if occ is not None and occ.uid == uid:
                return max(0, occ.gen - self._remaining[i])
        return None

    def peek_tokens(self, uid: int) -> Optional[np.ndarray]:
        """The tokens generated so far by an in-flight request (one device
        row read, between chunks); None when the uid is not in a slot."""
        for i in range(self.slots):
            occ = self._occupant[i]
            if occ is not None and occ.uid == uid:
                plen = len(occ.prompt)
                avail = max(0, occ.gen - self._remaining[i])
                return _host(self.state.tokens[i, plen:plen + avail]
                             ).astype(np.int32)
        return None

    # -- boundary admission (between chunks) --------------------------------

    def _harvest_slot(self, i: int) -> Completion:
        """Read a retired slot's rows (the once-per-request device read)
        and free it."""
        req = self._occupant[i]
        plen = len(req.prompt)
        toks = _host(self.state.tokens[i, plen:plen + req.gen])
        plog = _host(self.state.prompt_logits[i])
        bad = bool(self.state.bad[i])
        self._occupant[i] = None
        return Completion(req.uid, toks.astype(np.int32), plog, bad=bad)

    def _admit_one(self, i: int, req: Request) -> None:
        plen = len(req.prompt)
        row = np.zeros((self.max_len,), np.int64)
        row[:plen] = req.prompt
        self.state = _admit_slot(
            self.state, i, torch.from_numpy(row), plen, plen + req.gen,
            torch.from_numpy(req.key), req.temp, req.topk)
        if req.src_tokens is not None:
            # encode at admission: the request's memory goes into THIS
            # slot's rows (zeroed just above) and its mem_len
            src = torch.from_numpy(req.src_tokens.astype(np.int64)).to(
                self.model.device)
            with torch.inference_mode():
                self.model.admit_memory(self.params, self.state.cache, i,
                                        src)
        self._occupant[i] = req
        self._remaining[i] = plen + req.gen - 1

    def _turnover(self) -> List[Completion]:
        """Harvest every retired slot; refill from the queue."""
        done = []
        for i in range(self.slots):
            if self._occupant[i] is not None and self._remaining[i] <= 0:
                done.append(self._harvest_slot(i))
            if self._occupant[i] is None and self.queue:
                self._admit_one(i, self.queue.popleft())
        return done

    def _chunk_sampling(self, requests) -> model_common.Sampling:
        """The chunk's sampling mode: the per-slot sampler pays a
        full-vocab sort and a categorical draw every step, so a chunk whose
        requests are all greedy takes the greedy path (the same tokens: the
        per-slot sampler's argmax at temp 0); the host knows the chunk's
        requests, so the choice costs no device read."""
        if any(r is not None and r.temp > 0.0 for r in requests):
            return model_common.PER_SLOT
        return model_common.GREEDY

    def _step_chunk_boundary(self) -> List[Completion]:
        """Harvest/admit, then one chunk, shortened when every busy slot
        retires sooner."""
        done = self._turnover()
        busy = [i for i in range(self.slots) if self._occupant[i] is not None]
        if not busy:
            return done
        n = min(self.chunk_steps, max(self._remaining[i] for i in busy))
        self.state = _run_steps(self._step, self.params, self.state, n,
                                self._chunk_sampling(self._occupant))
        self.steps += n
        for i in busy:
            self.slot_steps += min(self._remaining[i], n)
            self._remaining[i] -= n
        return done

    # -- scan admission (device queue, host-mirrored schedule) --------------

    def _queue_arrays(self, upload: List[Request]):
        """The pending window as the device queue's host arrays."""
        qc = self._queue_cap
        qt = np.zeros((qc, self.max_len), np.int64)
        qp = np.ones((qc,), np.int64)
        ql = np.ones((qc,), np.int64)
        qr = np.zeros((qc, 2), np.int64)
        qtemp = np.zeros((qc,), np.float32)
        qk = np.zeros((qc,), np.int64)
        for j, req in enumerate(upload):
            plen = len(req.prompt)
            qt[j, :plen] = req.prompt
            qp[j] = plen
            ql[j] = plen + req.gen
            qr[j] = req.key
            qtemp[j] = req.temp
            qk[j] = req.topk
        return qt, qp, ql, qr, qtemp, qk

    def _step_chunk_scan(self) -> List[Completion]:
        """One chunk with admission inside it.

        The host first plays the schedule for up to ``chunk_steps`` steps —
        admit free slots from the FIFO lowest index first, advance the busy
        ones, retire the exhausted ones in slot order — which gives the
        chunk's length, each step's ``(slot, queue row)`` admissions and
        ``(slot, done row)`` harvests, with no device read.  Then one queue
        upload, the chunk, one done-buffer read."""
        upload = list(itertools.islice(self.queue, self._queue_cap))
        sampling = self._chunk_sampling(list(self._occupant) + upload)
        occ = list(self._occupant)
        rem = list(self._remaining)
        qi = 0
        retired: List[Request] = []
        schedule = []
        busy_steps = 0
        for _ in range(self.chunk_steps):
            if qi >= len(upload) and all(o is None for o in occ):
                break                       # nothing left this chunk
            admit = []
            for i in range(self.slots):     # admission, lowest slot first
                if occ[i] is None and qi < len(upload):
                    req = upload[qi]
                    admit.append((i, qi))
                    qi += 1
                    occ[i] = req
                    rem[i] = len(req.prompt) + req.gen - 1
            busy = [i for i in range(self.slots) if occ[i] is not None]
            busy_steps += len(busy)
            for i in busy:                  # one decode step
                rem[i] -= 1
            harvest = []
            for i in range(self.slots):     # retire, slot order
                if occ[i] is not None and rem[i] <= 0:
                    harvest.append((i, len(retired)))
                    retired.append(occ[i])
                    occ[i] = None
                    rem[i] = 0
            schedule.append((admit, harvest))
        if not schedule:
            return []
        if qi:
            self.state = _refill_scan(self.state,
                                      *self._queue_arrays(upload[:qi]))
        self.state = _run_steps(self._step, self.params, self.state,
                                len(schedule), sampling, schedule)
        for _ in range(qi):
            self.queue.popleft()
        self._occupant, self._remaining = occ, rem
        self.steps += len(schedule)
        self.slot_steps += busy_steps
        out: List[Completion] = []
        if retired:
            # the once-per-request read, rows in the mirrored order
            n = len(retired)
            dt = _host(self.state.done.tokens[:n])
            dl = _host(self.state.done.prompt_logits[:n])
            db = _host(self.state.done.bad[:n])
            for j, req in enumerate(retired):
                plen = len(req.prompt)
                out.append(Completion(
                    req.uid, dt[j, plen:plen + req.gen].astype(np.int32),
                    dl[j], bad=bool(db[j])))
        return out

    # -- main loop ----------------------------------------------------------

    def step_chunk(self) -> List[Completion]:
        """Advance the pool by one chunk; returns completions."""
        if self.admission == "scan":
            return self._step_chunk_scan()
        return self._step_chunk_boundary()

    def run(self) -> List[Completion]:
        """Drain the queue; returns every completion (match by uid)."""
        out: List[Completion] = []
        while self.queue or any(r is not None for r in self._occupant):
            out.extend(self.step_chunk())
        return out
