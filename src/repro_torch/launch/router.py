"""Multi-replica request router: load-aware admission over N Engines.

One Engine serves ``slots`` concurrent requests on one device.  Scaling
past that means N engine REPLICAS — same model, same params (one tree in
memory, shared), independent cache pools — each driven by its own worker
thread.  PyTorch releases the GIL inside its ops, so the replicas' host
work and their launches interleave; on one card their kernels share its
default stream.

The router owns four decisions the engine does not make:

* **Placement** — ``submit`` picks the live replica with the fewest
  outstanding requests (pending + in flight), then the lowest lifetime
  occupancy, then the lowest index: host arithmetic over counters the
  router keeps, so a seeded trace maps to replicas deterministically,
  testable without starting the workers.
* **Backpressure** — each replica admits at most ``queue_depth``
  outstanding requests; when every live replica is full, ``submit`` raises
  ``QueueFull`` at once (HTTP 429).  A request is admitted, rejected now,
  or completed — never parked.
* **Lifecycle** — per-request deadlines (checked between chunks: an
  expired request is cancelled, its slot freed, its ticket resolves to
  ``DeadlineExpired``) and cancellation (a client disconnect reaches
  ``Engine.cancel``, so an abandoned request stops taking slot-steps).
* **Supervision** — a supervisor thread watches every worker: each loop
  iteration refreshes the replica's heartbeat, so a dead thread (a device
  error, an injected fault) or a stale heartbeat (a slow chunk) is noticed
  within ``supervise_interval``.  A dead replica's tickets split at the
  at-most-once boundary: requests not yet admitted into a slot (mailbox or
  engine queue: no token left the device) fail over to a live replica and
  complete normally; requests already admitted (tokens may have streamed)
  complete with a retryable ``replica_lost`` — the router never silently
  decodes a partly delivered request again.  The dead replica then
  restarts single-flight — a fresh Engine (the old one's buffers are in an
  unknown state mid-chunk) under ``RestartPolicy``'s bounded exponential
  backoff.  A stale-but-alive worker is only marked ``suspect`` (no new
  placements; its thread cannot be killed safely) and returns to ``live``
  when its heartbeat does.

Threads and the device: ``torch.inference_mode``, the current CUDA device
and stream are thread-local, so each worker enters inference mode and
selects its engine's device itself; ``start`` builds the TT-chain kernels
before any worker runs.  The kernels' launch counts
(``kernels/tt_contract/ops.launches``) are shared by all replicas: they
count every replica's launches.

Results flow back through per-request ``Ticket``s: a thread-safe event
queue carrying ``("delta", tokens)`` chunks for streaming consumers and a
terminal ``("done", Completion)`` / ``("expired", None)`` /
``("cancelled", None)`` / ``("replica_lost", msg)`` / ``("poisoned",
msg)`` / ``("error", msg)``.  ``Ticket.result()`` is the blocking
convenience; ``launch/server.py`` bridges the same queue into asyncio for
SSE.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np

import torch

from repro_torch.launch.engine import Completion, Engine
from repro_torch.runtime.fault_tolerance import RestartPolicy

# replica lifecycle states (stats()["replicas"][i]["state"])
LIVE = "live"                # worker running, placement candidate
SUSPECT = "suspect"          # heartbeat stale (slow chunk): no new
                             # placements, recovers when the heartbeat does
DEAD = "dead"                # worker thread exited (restarts exhausted or
                             # restart pending)
RESTARTING = "restarting"    # single-flight restart in progress


class QueueFull(RuntimeError):
    """Every live replica is at its ``queue_depth`` bound — retry later
    (HTTP 429 + ``Retry-After``)."""


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before it finished; its slot was
    freed (HTTP 504)."""


class RequestCancelled(RuntimeError):
    """The request was cancelled (client disconnect / explicit cancel)."""


class ReplicaLost(RuntimeError):
    """The replica serving this request died mid-flight.  At-most-once
    token delivery: the request was NOT silently re-decoded (its tokens
    may already have streamed), so it is safe to retry (HTTP 503)."""


class NumericFault(RuntimeError):
    """The request's logits went non-finite (NaN/Inf).  It was
    quarantined and its slot freed; sibling slots are unaffected."""


class NoLiveReplicas(RuntimeError):
    """Every replica is dead or restarting — nothing can take the request
    (HTTP 503; ``/healthz`` reports ``down``)."""


def _build_kernels(engines: List[Engine]) -> None:
    """Build the TT-chain kernels before any worker thread launches one (a
    build is a compile and a library load, not work for a replica's first
    chunk); nothing to build for engines on the CPU."""
    if any(e.state.tokens.device.type == "cuda" for e in engines):
        from repro_torch.kernels.tt_contract import ops
        ops.build()


class Ticket:
    """Handle for one routed request.

    ``events`` is a thread-safe queue of ``(kind, payload)`` tuples
    emitted by the replica worker: zero or more ``("delta", np.ndarray)``
    token chunks (streaming requests only), then exactly one terminal
    event — ``("done", Completion)``, ``("expired", None)``,
    ``("cancelled", None)``, ``("replica_lost", str)`` (retryable —
    at-most-once delivery forbids a silent re-decode), ``("poisoned",
    str)`` (NaN/Inf logits — the request was quarantined), or
    ``("error", str)``.
    """

    def __init__(self, rid: int, replica: int, stream: bool,
                 deadline: Optional[float]):
        self.rid = rid
        self.replica = replica            # current placement (failover moves it)
        self.stream = stream
        self.deadline = deadline          # absolute time.monotonic() bound
        self.events: "queue.Queue" = queue.Queue()
        self.cancel_event = threading.Event()
        self.done_event = threading.Event()
        self._emit_lock = threading.Lock()
        self._listener = None

    def attach(self, fn) -> None:
        """Route events to ``fn(event)`` (called from the replica worker
        thread) instead of the pull queue; events already queued are
        flushed to ``fn`` first, in order.  The HTTP server uses this to
        bridge into asyncio via ``loop.call_soon_threadsafe`` — one
        callback per event instead of one blocked executor thread per
        in-flight request."""
        with self._emit_lock:
            while True:
                try:
                    fn(self.events.get_nowait())
                except queue.Empty:
                    break
            self._listener = fn

    def _emit(self, kind: str, payload=None) -> None:
        with self._emit_lock:
            if self._listener is not None:
                self._listener((kind, payload))
            else:
                self.events.put((kind, payload))

    def result(self, timeout: Optional[float] = None) -> Completion:
        """Block until the terminal event; returns the Completion or
        raises ``DeadlineExpired`` / ``RequestCancelled`` / ``ReplicaLost``
        / ``NumericFault`` / ``RuntimeError``.  Streaming deltas drained on
        the way are discarded (streaming consumers read ``events``
        directly instead)."""
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            left = None if end is None else max(0.0, end - time.monotonic())
            kind, payload = self.events.get(timeout=left)
            if kind == "delta":
                continue
            if kind == "done":
                return payload
            if kind == "expired":
                raise DeadlineExpired(f"request {self.rid} missed deadline")
            if kind == "cancelled":
                raise RequestCancelled(f"request {self.rid} cancelled")
            if kind == "replica_lost":
                raise ReplicaLost(f"request {self.rid}: {payload}")
            if kind == "poisoned":
                raise NumericFault(f"request {self.rid}: {payload}")
            raise RuntimeError(f"request {self.rid} failed: {payload}")


class _Replica:
    """One engine + its worker thread + the command mailbox + the
    supervision bookkeeping the router reads about it."""

    def __init__(self, index: int, engine: Engine):
        self.index = index
        self.engine = engine
        self.commands: "queue.Queue" = queue.Queue()
        self.outstanding = 0              # router-side counter (lock-guarded)
        self.thread: Optional[threading.Thread] = None
        self.state = LIVE
        self.heartbeat = time.monotonic() # refreshed every worker iteration
        self.chunks = 0                   # worked chunks (fault-hook clock)
        self.error: Optional[str] = None  # last worker/restart exception
        self.restarts = 0                 # lifetime restart count
        # rid -> [ticket, submit args, admitted-to-slot?, engine uid].
        # ``admitted`` is the at-most-once boundary: True means tokens may
        # already have streamed, so on replica death the ticket gets a
        # retryable replica_lost instead of a silent re-decode.
        self.inflight: dict = {}
        self.fault_hook: Optional[Callable[[int], None]] = None
        self.completed = 0                # lifetime completions
        self.busy_s = 0.0                 # lifetime seconds inside step_chunk


def _clone_engine(eng: Engine) -> Engine:
    """Default restart factory: a fresh Engine with the dead one's
    construction params (model and params are shared — only the cache pool
    and queues are rebuilt)."""
    return Engine(
        eng.model, eng.params, slots=eng.slots, max_len=eng.max_len,
        chunk_steps=eng.chunk_steps,
        temperature=eng.sampling.temperature, top_k=eng.sampling.top_k,
        seed=eng.seed, admission=eng.admission, queue_cap=eng._queue_cap,
    )


class Router:
    """Load-aware, supervised front of N Engine replicas.

    ``submit`` never blocks: it places the request (least-outstanding →
    occupancy tiebreak → lowest index, live replicas only), bumps the
    chosen replica's outstanding counter, and mails the work to its
    worker.  All engine interaction — ``Engine.submit``, chunk stepping,
    cancellation, harvest — happens on that replica's worker thread, so
    engines need no locking.  ``start()`` spawns the workers plus a
    supervisor; placement itself needs no workers, which keeps the
    routing rule unit-testable as a pure function of the trace.

    ``watchdog_s`` — per-chunk heartbeat bound: a worker whose heartbeat
    goes stale by more than this while it has work is marked ``suspect``
    (no new placements) until the heartbeat resumes.  ``None`` (default)
    disables the watchdog; thread-death supervision is always on.

    ``restart_policy`` — bounded exponential backoff for dead-replica
    restarts (``RestartPolicy``; its injectable ``sleep`` keeps tests and
    the chaos lane fast).  ``engine_factory(dead_engine) -> Engine``
    builds the replacement engine (default: clone construction params).
    """

    def __init__(self, engines: List[Engine], queue_depth: int = 16,
                 watchdog_s: Optional[float] = None,
                 restart_policy: Optional[RestartPolicy] = None,
                 engine_factory: Optional[Callable[[Engine], Engine]] = None,
                 supervise_interval: float = 0.05):
        if not engines:
            raise ValueError("router needs at least one engine replica")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.replicas = [_Replica(i, e) for i, e in enumerate(engines)]
        self.queue_depth = queue_depth
        self.watchdog_s = watchdog_s
        self.restart_policy = restart_policy or RestartPolicy(
            max_restarts=3, backoff_s=0.5, max_backoff_s=10.0)
        self.supervise_interval = supervise_interval
        self._engine_factory = engine_factory or _clone_engine
        self._lock = threading.Lock()
        self._rid = 0
        self._stop = threading.Event()
        self._started = False
        self._supervisor: Optional[threading.Thread] = None

    # -- placement ----------------------------------------------------------

    def pick_replica(self) -> int:
        """The routing rule: fewest outstanding, then lowest lifetime
        occupancy, then lowest index — over LIVE replicas only.  Raises
        ``QueueFull`` when every live replica is at the bound and
        ``NoLiveReplicas`` when none is live at all."""
        with self._lock:
            live = [r for r in self.replicas if r.state == LIVE]
            if not live:
                raise NoLiveReplicas(
                    f"all {len(self.replicas)} replicas dead or restarting")
            free = [r for r in live if r.outstanding < self.queue_depth]
            if not free:
                raise QueueFull(
                    f"all {len(live)} live replicas at queue_depth="
                    f"{self.queue_depth}"
                )
            best = min(free, key=lambda r: (r.outstanding,
                                            r.engine.occupancy, r.index))
            return best.index

    def submit(self, prompt, gen: int, src_tokens=None,
               seed: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               deadline: Optional[float] = None,
               stream: bool = False) -> Ticket:
        """Place one request; returns its Ticket immediately.

        ``deadline`` is seconds from now; expiry between chunks cancels
        the request and frees its slot.  ``stream=True`` makes the worker
        emit ``("delta", tokens)`` events after each fused chunk.
        Raises ``ValueError`` (``InvalidRequest``) on bad params
        (fail-fast, before placement), ``QueueFull`` when no live replica
        has room, and ``NoLiveReplicas`` when every replica is down.
        """
        # validate against replica 0 — replicas are homogeneous, and a bad
        # request must be rejected before it consumes a queue slot
        self.replicas[0].engine.validate(prompt, gen, src_tokens,
                                         temperature, top_k)
        abs_deadline = (None if deadline is None
                        else time.monotonic() + deadline)
        while True:
            idx = self.pick_replica()
            rep = self.replicas[idx]
            # counter bump + mailbox put are atomic with a state re-check:
            # a replica that died between pick and put must not swallow
            # the command (its mailbox is drained under this same lock)
            with self._lock:
                if rep.state != LIVE:
                    continue
                rid = self._rid
                self._rid += 1
                rep.outstanding += 1
                ticket = Ticket(rid, idx, stream, abs_deadline)
                rep.commands.put(("submit", ticket,
                                  (prompt, gen, src_tokens, seed,
                                   temperature, top_k)))
            return ticket

    def cancel(self, ticket: Ticket) -> None:
        """Request cancellation; the replica worker acts on it at the next
        chunk boundary (or before admission, if still queued)."""
        ticket.cancel_event.set()
        # wake the worker even when it is idle-blocking on its mailbox
        self.replicas[ticket.replica].commands.put(("nudge", None, None))

    # -- stats / health ------------------------------------------------------

    def live_replicas(self) -> int:
        """Replicas currently accepting placements (``live`` state)."""
        with self._lock:
            return sum(1 for r in self.replicas if r.state == LIVE)

    def retry_after(self) -> int:
        """Seconds a 429/503 client should wait, derived from the queue
        depth actually in front of it: least-loaded live backlog over the
        measured completion rate (lifetime completions / busy seconds).
        Clamped to [1, 30]; 5 when nothing is live (restart backoff
        territory), 1 before any rate is measured."""
        with self._lock:
            live = [r for r in self.replicas if r.state == LIVE]
            if not live:
                return 5
            backlog = min(r.outstanding for r in live)
            completed = sum(r.completed for r in live)
            busy = sum(r.busy_s for r in live)
        if completed < 1 or busy <= 0.0:
            return 1
        per_req = busy / completed            # mean busy-seconds per request
        return max(1, min(30, math.ceil(backlog * per_req)))

    def stats(self) -> dict:
        with self._lock:
            return {
                "queue_depth": self.queue_depth,
                "live_replicas": sum(1 for r in self.replicas
                                     if r.state == LIVE),
                "replicas": [
                    {
                        "index": r.index,
                        "state": r.state,
                        "outstanding": r.outstanding,
                        "busy_slots": r.engine.busy_slots,
                        "pending": r.engine.pending,
                        "steps": r.engine.steps,
                        "occupancy": round(r.engine.occupancy, 4),
                        "restarts": r.restarts,
                        "error": r.error,
                    }
                    for r in self.replicas
                ],
            }

    # -- lifecycle ----------------------------------------------------------

    def _spawn_worker(self, rep: _Replica) -> None:
        rep.thread = threading.Thread(
            target=self._worker_main, args=(rep,),
            name=f"replica-{rep.index}", daemon=True,
        )
        rep.thread.start()

    def start(self) -> "Router":
        if self._started:
            return self
        _build_kernels([r.engine for r in self.replicas])
        self._started = True
        for rep in self.replicas:
            self._spawn_worker(rep)
        self._supervisor = threading.Thread(
            target=self._supervise, name="router-supervisor", daemon=True)
        self._supervisor.start()
        return self

    def close(self) -> None:
        if not self._started:
            return
        self._stop.set()
        for rep in self.replicas:
            rep.commands.put(("nudge", None, None))
        for rep in self.replicas:
            t = rep.thread
            if t is None:
                continue
            if not t.is_alive() and rep.state in (LIVE, SUSPECT):
                # the worker crashed and nobody noticed yet (supervisor
                # raced with close): surface it instead of silently
                # "joining" a corpse
                with self._lock:
                    rep.state = DEAD
                    if rep.error is None:
                        rep.error = ("worker thread died without recording "
                                     "an exception")
            t.join(timeout=30.0)
        if self._supervisor is not None:
            self._supervisor.join(timeout=5.0)
            self._supervisor = None
        self._started = False
        self._stop.clear()

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- supervision --------------------------------------------------------

    def _supervise(self) -> None:
        """Watch worker liveness (always) and heartbeat staleness (when
        ``watchdog_s`` is set).  Dead workers trigger the failover +
        restart path; stale-but-alive workers only flip to ``suspect`` —
        a Python thread stuck inside a device call cannot be killed safely, so the
        router just stops placing onto it until it breathes again."""
        while not self._stop.wait(self.supervise_interval):
            now = time.monotonic()
            for rep in self.replicas:
                if rep.state in (DEAD, RESTARTING):
                    continue
                t = rep.thread
                if t is not None and not t.is_alive():
                    self._on_replica_death(rep)
                    continue
                if self.watchdog_s is None:
                    continue
                stale = now - rep.heartbeat > self.watchdog_s
                with self._lock:
                    if rep.state == LIVE and stale and rep.outstanding > 0:
                        rep.state = SUSPECT
                    elif rep.state == SUSPECT and not stale:
                        rep.state = LIVE

    def _on_replica_death(self, rep: _Replica) -> None:
        """Failover for a dead worker.  Idempotent/single-flight: first
        caller (dying thread or supervisor) wins.  Splits the replica's
        tickets at the at-most-once boundary — never-admitted work moves
        to live replicas, admitted work fails retryably — then kicks off
        the bounded-backoff restart."""
        with self._lock:
            if rep.state in (DEAD, RESTARTING):
                return
            rep.state = DEAD
            if rep.error is None:
                rep.error = "worker thread died"
            entries = list(rep.inflight.values())
            rep.inflight.clear()
            # mailbox orphans never reached the worker at all — drained
            # under the router lock so submit() can't race a command into
            # a queue nobody will ever read
            mail = []
            while True:
                try:
                    cmd, ticket, args = rep.commands.get_nowait()
                except queue.Empty:
                    break
                if cmd == "submit":
                    mail.append((ticket, args))
            reason = rep.error
        lost = [(t, a) for t, a, admitted, _ in entries if admitted]
        pending = [(t, a) for t, a, admitted, _ in entries if not admitted]
        pending.extend(mail)
        for ticket, _ in lost:
            # tokens may already have streamed: complete with a retryable
            # typed error, never re-decode (at-most-once delivery)
            self._finish(rep, ticket, "replica_lost",
                         f"replica {rep.index} lost mid-flight ({reason})")
        for ticket, args in pending:
            self._failover(rep, ticket, args)
        self._restart_async(rep)

    def _failover(self, dead: _Replica, ticket: Ticket, args) -> None:
        """Move a never-admitted ticket to a live replica (its tokens are
        a pure function of its own request, so the re-run is exact); when
        nothing can take it, complete it retryably."""
        while True:
            try:
                idx = self.pick_replica()
            except (QueueFull, NoLiveReplicas) as e:
                self._finish(dead, ticket, "replica_lost",
                             f"replica {dead.index} died and no live "
                             f"replica could take over ({e})")
                return
            rep = self.replicas[idx]
            with self._lock:
                if rep.state != LIVE:
                    continue
                dead.outstanding -= 1
                rep.outstanding += 1
                ticket.replica = idx
                rep.commands.put(("submit", ticket, args))
            return

    def _restart_async(self, rep: _Replica) -> None:
        if self._stop.is_set() or not self._started:
            return
        with self._lock:
            if rep.state != DEAD:
                return
            rep.state = RESTARTING
        threading.Thread(
            target=self._restart, args=(rep,),
            name=f"replica-{rep.index}-restart", daemon=True,
        ).start()

    def _restart(self, rep: _Replica) -> None:
        """Single-flight replica restart under the bounded-backoff
        policy.  The engine is rebuilt from scratch — a worker that died
        mid-chunk leaves the pool's device buffers in an unknown state."""
        policy = self.restart_policy
        while not self._stop.is_set():
            rep.restarts += 1
            if rep.restarts > policy.max_restarts:
                with self._lock:
                    rep.state = DEAD
                return
            policy.sleep(policy.backoff(rep.restarts))
            if self._stop.is_set():
                break
            try:
                engine = self._engine_factory(rep.engine)
            except Exception as e:
                with self._lock:
                    rep.error = f"restart failed: {type(e).__name__}: {e}"
                continue
            with self._lock:
                rep.engine = engine
                rep.commands = queue.Queue()
                rep.inflight.clear()
                rep.chunks = 0
                rep.heartbeat = time.monotonic()
                rep.error = None
            # spawn BEFORE flipping LIVE: the supervisor skips RESTARTING
            # replicas, so it can't mistake the old dead thread for a
            # fresh-but-crashed worker during the handoff
            self._spawn_worker(rep)
            with self._lock:
                rep.state = LIVE
            return
        with self._lock:
            if rep.state == RESTARTING:
                rep.state = DEAD

    # -- worker -------------------------------------------------------------

    def _finish(self, rep: _Replica, ticket: Ticket, kind: str,
                payload=None) -> None:
        with self._lock:
            rep.outstanding -= 1
            rep.inflight.pop(ticket.rid, None)
        ticket._emit(kind, payload)
        ticket.done_event.set()

    def _worker_main(self, rep: _Replica) -> None:
        """Worker wrapper: enter inference mode and the engine's device
        (both thread-local), record the fatal exception, then run the
        failover path from the dying thread itself (fast path — the
        supervisor is the backstop for anything that slips through)."""
        try:
            dev = rep.engine.state.tokens.device    # with its index
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            with torch.inference_mode():
                self._worker(rep)
        except BaseException as e:        # noqa: BLE001 — died means died
            with self._lock:
                rep.error = f"{type(e).__name__}: {e}"
            if not self._stop.is_set():
                self._on_replica_death(rep)

    def _worker(self, rep: _Replica) -> None:
        eng = rep.engine
        cmds = rep.commands
        live = {}          # engine uid -> Ticket
        sent = {}          # engine uid -> tokens already streamed
        while True:
            # drain the mailbox; block briefly when the engine is idle so
            # an idle replica doesn't spin
            block = not (eng.queue or any(o is not None
                                          for o in eng._occupant))
            if block and self._stop.is_set():
                break
            rep.heartbeat = time.monotonic()
            try:
                while True:
                    cmd, ticket, args = cmds.get(timeout=0.02 if block else 0)
                    block = False
                    if cmd == "nudge":
                        continue
                    # register BEFORE any processing: from here on a
                    # worker death hands the ticket to the failover path
                    # instead of stranding it
                    with self._lock:
                        rep.inflight[ticket.rid] = [ticket, args, False, None]
                    prompt, gen, src, seed, temp, topk = args
                    if ticket.cancel_event.is_set():
                        self._finish(rep, ticket, "cancelled")
                        continue
                    now = time.monotonic()
                    if ticket.deadline is not None and now > ticket.deadline:
                        self._finish(rep, ticket, "expired")
                        continue
                    try:
                        uid = eng.submit(prompt, gen, src_tokens=src,
                                         seed=seed, temperature=temp,
                                         top_k=topk)
                    except Exception as e:        # validated upstream, but
                        self._finish(rep, ticket, "error", str(e))
                        continue
                    with self._lock:
                        entry = rep.inflight.get(ticket.rid)
                        if entry is not None:
                            entry[3] = uid
                    live[uid] = ticket
                    sent[uid] = 0
            except queue.Empty:
                pass
            # deadline / cancellation sweep (between chunks — an engine
            # cancel here frees the slot for the next admission sweep)
            now = time.monotonic()
            for uid, ticket in list(live.items()):
                expired = (ticket.deadline is not None
                           and now > ticket.deadline)
                if ticket.cancel_event.is_set() or expired:
                    eng.cancel(uid)
                    self._finish(rep, ticket,
                                 "expired" if expired else "cancelled")
                    del live[uid]
                    sent.pop(uid, None)
            if not (eng.queue or any(o is not None for o in eng._occupant)):
                continue
            # chaos injection point: counts WORKED chunks only, so a
            # seeded FaultPlan hits a deterministic point in the schedule
            if rep.fault_hook is not None:
                rep.fault_hook(rep.chunks)
            # no blanket except here: a step_chunk failure leaves the
            # pool's device buffers in an unknown state, so the worker dies
            # and the supervisor fails over + restarts with a FRESH engine
            t0 = time.monotonic()
            done = eng.step_chunk()
            rep.busy_s += time.monotonic() - t0
            rep.chunks += 1
            rep.heartbeat = time.monotonic()
            finished = {c.uid for c in done}
            # flip the at-most-once flag BEFORE streaming: once a delta
            # may have left the process the ticket must never fail over
            with self._lock:
                for entry in rep.inflight.values():
                    if not entry[2] and entry[3] is not None:
                        uid = entry[3]
                        if uid in finished or eng.progress(uid) is not None:
                            entry[2] = True
            # stream per-chunk deltas for still-in-flight tickets (one
            # device row read per streaming ticket per chunk)
            for uid, ticket in live.items():
                if not ticket.stream or uid in finished:
                    continue
                avail = eng.progress(uid)
                if avail is not None and avail > sent[uid]:
                    toks = eng.peek_tokens(uid)
                    ticket._emit("delta", np.asarray(toks[sent[uid]:]))
                    sent[uid] = avail
            for c in done:
                ticket = live.pop(c.uid, None)
                n = sent.pop(c.uid, 0)
                if ticket is None:
                    continue              # cancelled earlier this loop
                if c.bad:
                    # numeric quarantine: the slot already came back with
                    # the normal retirement; only this request is failed
                    self._finish(rep, ticket, "poisoned",
                                 "non-finite logits (NaN/Inf) — request "
                                 "quarantined")
                    continue
                if ticket.stream and len(c.tokens) > n:
                    ticket._emit("delta", c.tokens[n:])
                rep.completed += 1
                self._finish(rep, ticket, "done", c)
