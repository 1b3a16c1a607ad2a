"""The port's serving front door on the CPU: the router over Engine
replicas (placement, backpressure, deadlines, cancel, supervision,
failover, restart), the asyncio HTTP server, the fault plan and restart
policy, and ``serve --serve``'s setup — the behaviours
``tests/test_server.py`` and the serving half of
``tests/test_fault_tolerance.py`` hold the JAX package to, on reduced
qwen1.5-0.5b (float32) with ``device="cpu"``, and an encoder-decoder
request's ``src_tokens`` through the server to a reduced
seamless-m4t-large-v2 Engine.  Every completion that comes
back is compared with the isolated ``generate`` run of its request.
"""

import dataclasses
import http.client
import json
import socket
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.engine import Engine, InvalidRequest, generate
from repro_torch.launch.router import (
    DEAD, DeadlineExpired, NoLiveReplicas, NumericFault, QueueFull,
    ReplicaLost, RequestCancelled, Router,
)
from repro_torch.launch.server import serve_in_thread
from repro_torch.models.registry import build
from repro_torch.runtime.fault_tolerance import (
    FaultPlan, InjectedFault, RestartPolicy,
)

from _torch_port import f32_cfg, no_tf32


@pytest.fixture(scope="module")
def setup():
    no_tf32()
    cfg = f32_cfg(get_config("qwen1.5-0.5b"))
    model = build(cfg, device="cpu")
    return cfg, model, model.init(0)


def _engines(model, params, n, slots=2, max_len=24, chunk_steps=3):
    return [Engine(model, params, slots=slots, max_len=max_len,
                   chunk_steps=chunk_steps) for _ in range(n)]


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n,), np.int32)


def _iso(model, params, p, gen, **kw):
    return generate(model, params, np.asarray(p, np.int32)[None], gen,
                    **kw)["gen"][0].tolist()


# -- control plane (no model) -----------------------------------------------

def test_restart_policy_backoff():
    policy = RestartPolicy(backoff_s=0.5, backoff_factor=3.0,
                           max_backoff_s=10.0)
    assert [policy.backoff(i) for i in (1, 2, 3, 4)] == [0.5, 1.5, 4.5, 10.0]


def test_fault_plan_seeded_determinism():
    a = FaultPlan.seeded(3, replicas=4, requests=16, crashes=1, stalls=2)
    b = FaultPlan.seeded(3, replicas=4, requests=16, crashes=1, stalls=2)
    assert (a.crash_at, a.stall_at, a.poison) == (b.crash_at, b.stall_at,
                                                  b.poison)
    assert set(a.crash_at).isdisjoint(a.stall_at)
    assert a.counts()["crashes"] == 1 and a.counts()["stalls"] == 2


def test_fault_plan_hook_fires_once():
    slept = []
    plan = FaultPlan(crash_at={0: 2}, stall_at={1: (1, 0.5)},
                     sleep=slept.append)
    h0, h1 = plan.hook_for(0), plan.hook_for(1)
    h0(0)
    h0(1)
    with pytest.raises(InjectedFault):
        h0(2)
    h0(3)
    h1(1)
    h1(5)
    assert slept == [0.5]
    assert plan.fired() == {"crashes": 1, "stalls": 1}


# -- router (no workers needed) ---------------------------------------------

def test_router_places_deterministically(setup):
    cfg, model, params = setup
    router = Router(_engines(model, params, 3), queue_depth=8)
    p = _prompt(cfg, 4)
    picks = [router.submit(p, 3).replica for _ in range(7)]
    assert picks == [0, 1, 2, 0, 1, 2, 0]
    t = router.submit(p, 3)           # outstanding 3, 2, 2 -> replica 1
    assert t.replica == 1
    router.cancel(t)                  # async: the counter is still held
    assert router.stats()["replicas"][1]["outstanding"] == 3


def test_router_queue_full_is_immediate(setup):
    cfg, model, params = setup
    router = Router(_engines(model, params, 2), queue_depth=1)
    p = _prompt(cfg, 3)
    router.submit(p, 3)
    router.submit(p, 3)
    t0 = time.monotonic()
    with pytest.raises(QueueFull):
        router.submit(p, 3)
    assert time.monotonic() - t0 < 1.0
    assert router.retry_after() == 1      # no completion rate measured yet


def test_router_rejects_bad_request_before_placement(setup):
    cfg, model, params = setup
    router = Router(_engines(model, params, 1), queue_depth=2)
    with pytest.raises(ValueError, match="temperature"):
        router.submit(_prompt(cfg, 3), 3, temperature=-1.0)
    with pytest.raises(InvalidRequest, match="must be in"):
        router.submit(np.asarray([0, cfg.vocab_size]), 3)
    assert router.stats()["replicas"][0]["outstanding"] == 0
    with pytest.raises(ValueError, match="queue_depth"):
        Router(_engines(model, params, 1), queue_depth=0)
    with pytest.raises(ValueError, match="at least one"):
        Router([])


def test_router_deadline_expiry_frees_slot(setup):
    cfg, model, params = setup
    router = Router(_engines(model, params, 1, slots=1), queue_depth=4)
    with router:
        doomed = router.submit(_prompt(cfg, 4, seed=1), 12, deadline=0.0)
        with pytest.raises(DeadlineExpired):
            doomed.result(timeout=60)
        p = _prompt(cfg, 3, seed=2)
        comp = router.submit(p, 4, seed=7).result(timeout=120)
    assert comp.tokens.tolist() == _iso(model, params, p, 4, seed=7)
    stats = router.stats()["replicas"][0]
    assert stats["outstanding"] == 0 and stats["busy_slots"] == 0


def test_router_cancel_resolves_ticket(setup):
    cfg, model, params = setup
    router = Router(_engines(model, params, 1, slots=1), queue_depth=4)
    with router:
        t = router.submit(_prompt(cfg, 4), 12)
        router.cancel(t)
        with pytest.raises(RequestCancelled):
            t.result(timeout=60)


def test_routed_completions_match_isolated(setup):
    """Unequal requests with their own seeds and sampling params over 2
    replicas (one of them streaming), each equal to its isolated run."""
    cfg, model, params = setup
    rng = np.random.default_rng(3)
    router = Router(_engines(model, params, 2), queue_depth=8)
    specs = [(5, 4, {}), (3, 6, dict(temperature=0.9, top_k=16)),
             (2, 5, {}), (6, 3, dict(temperature=1.1))]
    with router:
        reqs = []
        for i, (plen, gen, kw) in enumerate(specs):
            p = rng.integers(0, cfg.vocab_size, (plen,), np.int32)
            reqs.append((router.submit(p, gen, seed=i, stream=i == 1, **kw),
                         p, gen, i, kw))
        for t, p, gen, i, kw in reqs:
            comp = t.result(timeout=120)
            assert comp.tokens.tolist() == _iso(model, params, p, gen,
                                                seed=i, **kw)
        stream = reqs[1][0]
    assert stream.done_event.is_set()
    assert sum(r["steps"] > 0 for r in router.stats()["replicas"]) == 2


# -- supervision: crashes, poison, dead replicas ------------------------------

def _fast_router(model, params, n, **kw):
    slept = []
    kw.setdefault("restart_policy",
                  RestartPolicy(max_restarts=3, backoff_s=0.2,
                                max_backoff_s=1.0, sleep=slept.append))
    kw.setdefault("engine_factory", lambda old: _engines(model, params, 1)[0])
    kw.setdefault("supervise_interval", 0.01)
    router = Router(_engines(model, params, n), queue_depth=8, **kw)
    return router, slept


def test_crash_failover_parity_and_restart(setup):
    """A replica's worker dies mid-trace: never-admitted tickets fail over
    and equal their isolated runs; admitted ones get ReplicaLost; the
    replica restarts under the policy and serves again."""
    cfg, model, params = setup
    router, slept = _fast_router(model, params, 2)
    router.replicas[0].fault_hook = FaultPlan(crash_at={0: 1}).hook_for(0)
    router.start()
    try:
        reqs = [(_prompt(cfg, 3 + i % 3, seed=i), 4 + i % 3, i)
                for i in range(6)]
        tickets = [router.submit(p, g, seed=s) for p, g, s in reqs]
        done, lost = {}, []
        for i, t in enumerate(tickets):
            try:
                done[i] = t.result(timeout=120).tokens.tolist()
            except ReplicaLost:
                lost.append(i)
        assert done and lost, (sorted(done), lost)
        for i, toks in done.items():
            p, g, s = reqs[i]
            assert toks == _iso(model, params, p, g, seed=s), i
        deadline = time.monotonic() + 60
        while router.live_replicas() < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert router.live_replicas() == 2
        assert router.stats()["replicas"][0]["restarts"] == 1
        assert slept and slept[0] == 0.2
        p = _prompt(cfg, 4, seed=99)
        toks = router.submit(p, 5, seed=99).result(timeout=120).tokens
        assert toks.tolist() == _iso(model, params, p, 5, seed=99)
    finally:
        router.close()


def test_poisoned_request_quarantined_siblings_exact(setup):
    cfg, model, params = setup
    poison_tok = cfg.vocab_size - 1
    base = model.decode_step

    def poisoned(p, c, t):
        logits, cache = base(p, c, t)
        hit = (t == poison_tok).any(dim=-1)
        return torch.where(hit[:, None], float("nan"), logits), cache

    pmodel = dataclasses.replace(model, decode_step=poisoned)
    router = Router([Engine(pmodel, params, slots=2, max_len=24,
                            chunk_steps=3)], queue_depth=8)
    router.start()
    try:
        prompts = [_prompt(cfg, 3, seed=i) % (cfg.vocab_size - 1)
                   for i in range(3)]
        prompts[1][-1] = poison_tok
        tickets = [router.submit(p, 5, seed=i)
                   for i, p in enumerate(prompts)]
        with pytest.raises(NumericFault):
            tickets[1].result(timeout=120)
        for i in (0, 2):
            toks = tickets[i].result(timeout=120).tokens.tolist()
            assert toks == _iso(pmodel, params, prompts[i], 5, seed=i), i
        p = _prompt(cfg, 4, seed=7) % (cfg.vocab_size - 1)
        assert router.submit(p, 4, seed=7).result(
            timeout=120).tokens is not None
    finally:
        router.close()


def test_dead_worker_surfaced_and_no_live_replicas(setup):
    cfg, model, params = setup
    router, _ = _fast_router(
        model, params, 1,
        restart_policy=RestartPolicy(max_restarts=0, sleep=lambda s: None))
    router.replicas[0].fault_hook = FaultPlan(crash_at={0: 0}).hook_for(0)
    router.start()
    try:
        t = router.submit(_prompt(cfg, 3), 4, seed=0)
        with pytest.raises(ReplicaLost):
            t.result(timeout=60)
        deadline = time.monotonic() + 30
        while (router.replicas[0].state != DEAD
               and time.monotonic() < deadline):
            time.sleep(0.02)
        st = router.stats()
        assert st["live_replicas"] == 0 and st["replicas"][0]["state"] == DEAD
        assert "InjectedFault" in st["replicas"][0]["error"]
        with pytest.raises(NoLiveReplicas):
            router.submit(_prompt(cfg, 3), 4, seed=1)
        assert router.retry_after() >= 1
    finally:
        router.close()
    assert "InjectedFault" in router.stats()["replicas"][0]["error"]


# -- HTTP surface -----------------------------------------------------------

@pytest.fixture(scope="module")
def http_server(setup):
    cfg, model, params = setup
    router = Router(_engines(model, params, 2), queue_depth=4)
    server, shutdown = serve_in_thread(router)
    yield cfg, model, params, server, router
    shutdown()


def _post(port, body, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    status, data, headers = resp.status, resp.read(), dict(resp.getheaders())
    conn.close()
    return status, data, headers


def _get(port, path, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("GET", path)
    resp = conn.getresponse()
    status, data = resp.status, resp.read()
    conn.close()
    return status, data


def test_http_healthz_and_stats(http_server):
    cfg, model, params, server, router = http_server
    status, data = _get(server.port, "/healthz")
    body = json.loads(data)
    assert status == 200 and body["status"] == "ok"
    assert body["live_replicas"] == 2 and body["queue_depth"] >= 0
    status, data = _get(server.port, "/stats")
    stats = json.loads(data)
    assert status == 200 and len(stats["replicas"]) == 2
    assert all(r["state"] == "live" and r["error"] is None
               for r in stats["replicas"])
    assert _get(server.port, "/nope")[0] == 404


def test_http_generate_parity_and_sampling(http_server):
    cfg, model, params, server, router = http_server
    p = _prompt(cfg, 4, seed=5).tolist()
    status, data, _ = _post(server.port, {"prompt": p, "gen": 5, "seed": 7})
    out = json.loads(data)
    assert status == 200 and out["tokens"] == _iso(model, params, p, 5,
                                                   seed=7)
    assert out["replica"] in (0, 1) and out["latency_ms"] > 0
    status, data, _ = _post(server.port, {
        "prompt": p, "gen": 5, "seed": 3, "temperature": 0.9, "top_k": 16})
    assert status == 200 and json.loads(data)["tokens"] == _iso(
        model, params, p, 5, seed=3, temperature=0.9, top_k=16)


def test_http_stream_sse_parity(http_server):
    cfg, model, params, server, router = http_server
    p = _prompt(cfg, 4, seed=6).tolist()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    conn.request("POST", "/v1/generate", json.dumps(
        {"prompt": p, "gen": 6, "seed": 9, "stream": True}))
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    raw = resp.read().decode()
    conn.close()
    deltas, done = [], None
    for block in raw.strip().split("\n\n"):
        lines = block.split("\n")
        event = [ln[7:] for ln in lines if ln.startswith("event: ")]
        data = [json.loads(ln[6:]) for ln in lines if ln.startswith("data: ")]
        if event and event[0] == "done":
            done = data[0]
        else:
            deltas.extend(data[0]["tokens"])
    assert deltas == done["tokens"] == _iso(model, params, p, 6, seed=9)


def test_http_bad_request_400(http_server):
    cfg, model, params, server, router = http_server
    status, data, _ = _post(server.port, {"prompt": [1, 2], "gen": 4,
                                          "temperature": -2.0})
    assert status == 400 and "temperature" in json.loads(data)["error"]
    assert _post(server.port, {"gen": 4})[0] == 400
    assert _post(server.port, {"prompt": [1, 2], "gen": 40})[0] == 400


def test_http_deadline_504_then_recovers(http_server):
    cfg, model, params, server, router = http_server
    p = _prompt(cfg, 3, seed=8).tolist()
    status, data, _ = _post(server.port,
                            {"prompt": p, "gen": 10, "deadline_ms": 0})
    assert status == 504 and "deadline" in json.loads(data)["error"]
    status, data, _ = _post(server.port, {"prompt": p, "gen": 3, "seed": 1})
    assert status == 200 and json.loads(data)["tokens"] == _iso(
        model, params, p, 3, seed=1)


def _park_stream(port, p, gen):
    """Send a streaming request and leave its response unread."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    body = json.dumps({"prompt": p, "gen": gen, "stream": True}).encode()
    sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Length: " + str(len(body)).encode()
                 + b"\r\n\r\n" + body)
    return sock


def test_http_queue_full_429(setup):
    cfg, model, params = setup
    router = Router(_engines(model, params, 1, slots=1, max_len=512,
                             chunk_steps=2), queue_depth=1)
    server, shutdown = serve_in_thread(router)
    try:
        p = _prompt(cfg, 3, seed=4).tolist()
        sock = _park_stream(server.port, p, 500)
        for _ in range(200):
            if router.stats()["replicas"][0]["outstanding"] > 0:
                break
            time.sleep(0.02)
        status, data, headers = _post(server.port, {"prompt": p, "gen": 3})
        assert status == 429, (status, data)
        assert int(headers["Retry-After"]) >= 1
        sock.close()
    finally:
        shutdown()


def test_http_disconnect_cancels_request(setup):
    cfg, model, params = setup
    router = Router(_engines(model, params, 1, slots=1, max_len=64,
                             chunk_steps=2), queue_depth=4)
    server, shutdown = serve_in_thread(router)
    try:
        sock = _park_stream(server.port, _prompt(cfg, 3, seed=4).tolist(),
                            48)
        buf = b""
        while b"data: " not in buf:      # at least one delta arrived
            buf += sock.recv(4096)
        sock.close()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            rep = router.stats()["replicas"][0]
            if rep["outstanding"] == 0 and rep["busy_slots"] == 0:
                break
            time.sleep(0.1)
        rep = router.stats()["replicas"][0]
        assert rep["outstanding"] == 0 and rep["busy_slots"] == 0, rep
    finally:
        shutdown()


# -- serve --serve -----------------------------------------------------------

def test_serve_flags_and_router_setup(tmp_path):
    """``serve --serve``'s stack: the flags parse, ``make_router`` builds
    the replicas on one shared params tree from a saved TT checkpoint, and
    the server answers with the tokens of the isolated run."""
    base = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
            "--weights", "tt", "--batch", "1", "--prompt-len", "4",
            "--gen", "4", "--no-verify"]
    serve_mod.serve(serve_mod.parse_args(
        base + ["--save-tt-checkpoint", str(tmp_path / "ck")]))
    args = serve_mod.parse_args(
        base + ["--tt-checkpoint", str(tmp_path / "ck"), "--serve",
                "--replicas", "2", "--slots", "3", "--chunk-steps", "4",
                "--queue-depth", "5", "--deadline-ms", "60000",
                "--watchdog-ms", "30000", "--admission", "boundary",
                "--temperature", "0.5", "--top-k", "8", "--port", "0"])
    assert args.serve and args.replicas == 2 and args.top_k == 8
    router, model, params = serve_mod.make_router(args)
    engines = [r.engine for r in router.replicas]
    assert len(engines) == 2 and router.queue_depth == 5
    assert all(e.params is params and e.slots == 3 and e.chunk_steps == 4
               and e.admission == "boundary" and e.max_len == 8
               and e.sampling.temperature == 0.5 for e in engines)
    assert router.watchdog_s == 30.0
    server, shutdown = serve_in_thread(router, default_deadline=60.0)
    try:
        p = _prompt(model.cfg, 3, seed=1).tolist()
        status, data, _ = _post(server.port, {"prompt": p, "gen": 4,
                                              "seed": 2})
        assert status == 200
        assert json.loads(data)["tokens"] == _iso(
            model, params, p, 4, seed=2, temperature=0.5, top_k=8)
    finally:
        shutdown()


def test_http_encdec_request_with_sources():
    """An encoder-decoder JSON request's ``src_tokens`` pass the server and
    the router to an encdec Engine, which encodes them at admission: the
    reply is its isolated ``generate(src_tokens=...)`` run's tokens, beside
    a token-only request; a source longer than the memory rows is a 400."""
    no_tf32()
    cfg = f32_cfg(get_config("seamless-m4t-large-v2"))
    model = build(cfg, device="cpu")
    params = model.init(0)
    eng = Engine(model, params, slots=2, max_len=16, chunk_steps=3)
    assert eng.admission == "boundary"
    server, shutdown = serve_in_thread(Router([eng], queue_depth=4))
    try:
        rng = np.random.default_rng(11)
        cases = [(_prompt(cfg, 4, seed=12).tolist(),
                  rng.integers(0, cfg.vocab_size, (n,)).tolist())
                 for n in (6, 8)] + [(_prompt(cfg, 3, seed=13).tolist(),
                                      None)]
        for p, src in cases:
            body = {"prompt": p, "gen": 5, "seed": 1}
            if src is not None:
                body["src_tokens"] = src
            status, data, _ = _post(server.port, body)
            assert status == 200
            assert json.loads(data)["tokens"] == _iso(
                model, params, p, 5, seed=1, max_len=16,
                src_tokens=None if src is None else np.asarray([src]))
        assert _iso(model, params, cases[0][0], 5, max_len=16) != _iso(
            model, params, cases[0][0], 5, max_len=16,
            src_tokens=np.asarray([cases[0][1]]))
        status, data, _ = _post(server.port, {
            "prompt": [1, 2], "gen": 2,
            "src_tokens": [0] * (cfg.frontend_len + 1)})
        assert status == 400 and b"encoder positions" in data
    finally:
        shutdown()


def test_launch_counts_hold_under_threads():
    """Replica threads share ``tt_contract.ops.launches``: 16 threads
    (more than this host's cores) with a short switch interval, each
    counting 200 plain chains, lose no increment."""
    import sys
    import threading

    from repro_torch.kernels.tt_contract import ops
    cores = [torch.ones(1, 2, 2), torch.ones(2, 2, 2), torch.ones(2, 2, 2),
             torch.ones(2, 2, 1)]                    # depth 4: plain path
    x = torch.ones(3, 4)
    ops.tt_chain(x, None, None, cores, None, 2)
    before = ops.launches["plain_chains"]

    def work():
        for _ in range(200):
            ops.tt_chain(x, None, None, cores, None, 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ops.launches["plain_chains"] - before == 16 * 200
