"""Async HTTP front door for the serving stack (stdlib asyncio only).

Port of the JAX package's ``launch/server.py``: the same endpoints, wire
format and error mapping over the port's router.

One process, one event loop, N replica worker threads underneath: the
server parses HTTP/1.1 itself (no third-party web framework — the
container ships none, and the surface is three endpoints), hands requests
to ``launch/router.py``, and bridges each request's worker-thread events
into asyncio with ``loop.call_soon_threadsafe`` — no blocked executor
thread per in-flight request.

Endpoints:

``POST /v1/generate``
    Body: ``{"prompt": [ids], "gen": n}`` plus optional ``src_tokens``
    (encdec), ``temperature``/``top_k``/``seed`` (per-request sampling),
    ``deadline_ms`` and ``"stream": true``.  Non-streaming replies are one
    JSON object (tokens + replica + timing); streaming replies are SSE
    (``text/event-stream``): ``data: {"tokens": [...]}`` per fused chunk,
    then ``event: done`` with the full result.  Error mapping — 400 bad
    request (fails BEFORE placement), 429 + ``Retry-After`` when every
    live replica is at its queue bound, 503 + ``Retry-After`` when no
    replica is live or the serving replica died mid-flight
    (``replica_lost`` — retryable, the request was never silently
    re-decoded), 500 when a request is quarantined for non-finite logits
    (``poisoned``), 504 when the per-request deadline expires (slot
    freed), ``event: error`` mid-stream.  ``Retry-After`` is derived from
    the live queue depth over the measured completion rate, not a
    constant.

``GET /healthz``  health probe: ``{"status": "ok"|"degraded"|"down",
"live_replicas": n, "queue_depth": outstanding}`` — 200 while at least
one replica is live (``degraded`` = some replicas down or restarting),
503 + ``Retry-After`` when none is.  ``GET /stats``  router/replica
counters (state, outstanding, busy slots, lifetime occupancy, restarts,
last error).

Client disconnects propagate: the handler watches the socket for EOF
while waiting on events and calls ``Router.cancel`` so an abandoned
request stops burning slot-steps at the next chunk boundary.

Run it with ``python -m repro_torch.launch.serve --serve ...`` or embed
it via ``Server`` / ``serve_in_thread``.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.launch.router import NoLiveReplicas, QueueFull, Router

_MAX_HEADER = 64 * 1024
_MAX_BODY = 16 * 1024 * 1024


def _json_bytes(obj) -> bytes:
    return json.dumps(obj).encode()


def _response(status: int, body: bytes, content_type: str = "application/json",
              extra: str = "") -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              405: "Method Not Allowed", 429: "Too Many Requests",
              500: "Internal Server Error", 503: "Service Unavailable",
              504: "Gateway Timeout"}.get(status, "OK")
    return (
        f"HTTP/1.1 {status} {reason}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"{extra}"
        f"Connection: close\r\n\r\n"
    ).encode() + body


def _sse(payload: dict, event: Optional[str] = None) -> bytes:
    head = f"event: {event}\n" if event else ""
    return (head + f"data: {json.dumps(payload)}\n\n").encode()


class Server:
    """Asyncio HTTP server over a Router.

    ``default_deadline`` (seconds) applies to requests that don't carry
    their own ``deadline_ms``; ``None`` means no server-imposed deadline.
    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``self.port`` after ``start()``.
    """

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0, default_deadline: Optional[float] = None):
        self.router = router
        self.host = host
        self.port = port
        self.default_deadline = default_deadline
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> "Server":
        self.router.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- request plumbing ---------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                head = await reader.readuntil(b"\r\n\r\n")
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
                return
            if len(head) > _MAX_HEADER:
                writer.write(_response(400, _json_bytes(
                    {"error": "headers too large"})))
                return
            lines = head.decode("latin-1").split("\r\n")
            try:
                method, path, _ = lines[0].split(" ", 2)
            except ValueError:
                writer.write(_response(400, _json_bytes(
                    {"error": "malformed request line"})))
                return
            headers = {}
            for ln in lines[1:]:
                if ":" in ln:
                    k, v = ln.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            body = b""
            clen = int(headers.get("content-length", "0") or "0")
            if clen:
                if clen > _MAX_BODY:
                    writer.write(_response(400, _json_bytes(
                        {"error": "body too large"})))
                    return
                body = await reader.readexactly(clen)
            await self._dispatch(method, path, body, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                await writer.drain()
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, asyncio.CancelledError):
                pass

    def _retry_after_header(self) -> str:
        return f"Retry-After: {self.router.retry_after()}\r\n"

    async def _dispatch(self, method, path, body, reader, writer) -> None:
        if method == "GET" and path == "/healthz":
            st = self.router.stats()
            live = st["live_replicas"]
            depth = sum(r["outstanding"] for r in st["replicas"])
            if live == len(st["replicas"]):
                status = "ok"
            elif live > 0:
                status = "degraded"    # some replicas dead/restarting
            else:
                status = "down"        # load balancer should drain us
            body_obj = {"status": status, "live_replicas": live,
                        "queue_depth": depth}
            if live > 0:
                writer.write(_response(200, _json_bytes(body_obj)))
            else:
                writer.write(_response(503, _json_bytes(body_obj),
                                       extra=self._retry_after_header()))
            return
        if method == "GET" and path == "/stats":
            writer.write(_response(200, _json_bytes(self.router.stats())))
            return
        if path != "/v1/generate":
            writer.write(_response(404, _json_bytes({"error": "not found"})))
            return
        if method != "POST":
            writer.write(_response(405, _json_bytes(
                {"error": "POST required"})))
            return
        await self._generate(body, reader, writer)

    async def _generate(self, body, reader, writer) -> None:
        t_start = time.monotonic()
        try:
            req = json.loads(body.decode())
            prompt = np.asarray(req["prompt"], np.int32)
            gen = int(req["gen"])
            src = req.get("src_tokens")
            if src is not None:
                src = np.asarray(src, np.int32)
            temperature = req.get("temperature")
            top_k = req.get("top_k")
            seed = req.get("seed")
            stream = bool(req.get("stream", False))
            deadline = self.default_deadline
            if req.get("deadline_ms") is not None:
                deadline = float(req["deadline_ms"]) / 1e3
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            writer.write(_response(400, _json_bytes(
                {"error": f"bad request: {e}"})))
            return

        loop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()
        try:
            ticket = self.router.submit(
                prompt, gen, src_tokens=src, seed=seed,
                temperature=temperature, top_k=top_k,
                deadline=deadline, stream=stream)
        except QueueFull as e:
            writer.write(_response(429, _json_bytes({"error": str(e)}),
                                   extra=self._retry_after_header()))
            return
        except NoLiveReplicas as e:
            writer.write(_response(503, _json_bytes(
                {"error": str(e), "retryable": True}),
                extra=self._retry_after_header()))
            return
        except ValueError as e:
            writer.write(_response(400, _json_bytes({"error": str(e)})))
            return
        # bridge worker-thread events into this loop; watch the socket for
        # client EOF so a disconnect cancels the request
        def _bridge(ev):
            try:
                loop.call_soon_threadsafe(events.put_nowait, ev)
            except RuntimeError:
                pass     # loop already closed (server stopping mid-request)

        ticket.attach(_bridge)
        eof = asyncio.ensure_future(reader.read(1))
        try:
            if stream:
                await self._stream_response(ticket, events, eof, writer,
                                            t_start)
            else:
                await self._block_response(ticket, events, eof, writer,
                                           t_start)
        finally:
            eof.cancel()

    async def _next_event(self, ticket, events, eof):
        """One router event, or ``("disconnect", None)`` on client EOF."""
        getter = asyncio.ensure_future(events.get())
        done, _ = await asyncio.wait(
            {getter, eof}, return_when=asyncio.FIRST_COMPLETED)
        if getter in done:
            return getter.result()
        getter.cancel()
        self.router.cancel(ticket)
        return ("disconnect", None)

    @staticmethod
    def _done_payload(ticket, comp, t_start) -> dict:
        return {
            "rid": ticket.rid,
            "replica": ticket.replica,
            "tokens": np.asarray(comp.tokens).tolist(),
            "latency_ms": round((time.monotonic() - t_start) * 1e3, 3),
        }

    async def _block_response(self, ticket, events, eof, writer,
                              t_start) -> None:
        while True:
            kind, payload = await self._next_event(ticket, events, eof)
            if kind == "delta":
                continue
            if kind == "disconnect":
                return
            if kind == "done":
                writer.write(_response(200, _json_bytes(
                    self._done_payload(ticket, payload, t_start))))
            elif kind == "expired":
                writer.write(_response(504, _json_bytes(
                    {"error": "deadline expired", "rid": ticket.rid})))
            elif kind == "cancelled":
                writer.write(_response(500, _json_bytes(
                    {"error": "cancelled", "rid": ticket.rid})))
            elif kind == "replica_lost":
                # retryable: at-most-once delivery means the request was
                # NOT re-decoded — the client decides whether to resend
                writer.write(_response(503, _json_bytes(
                    {"error": str(payload), "rid": ticket.rid,
                     "retryable": True}),
                    extra=self._retry_after_header()))
            elif kind == "poisoned":
                writer.write(_response(500, _json_bytes(
                    {"error": str(payload), "rid": ticket.rid,
                     "kind": "poisoned"})))
            else:
                writer.write(_response(500, _json_bytes(
                    {"error": str(payload), "rid": ticket.rid})))
            return

    async def _stream_response(self, ticket, events, eof, writer,
                               t_start) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n"
        )
        await writer.drain()
        while True:
            kind, payload = await self._next_event(ticket, events, eof)
            if kind == "disconnect":
                return
            try:
                if kind == "delta":
                    writer.write(_sse(
                        {"tokens": np.asarray(payload).tolist()}))
                    await writer.drain()
                    continue
                if kind == "done":
                    writer.write(_sse(
                        self._done_payload(ticket, payload, t_start),
                        event="done"))
                elif kind == "expired":
                    writer.write(_sse({"error": "deadline expired"},
                                      event="error"))
                else:
                    # replica_lost / poisoned / error — the SSE channel has
                    # one error shape; ``kind`` tells the client which
                    writer.write(_sse({"error": str(payload or kind),
                                       "kind": kind,
                                       "retryable": kind == "replica_lost"},
                                      event="error"))
                await writer.drain()
            except ConnectionError:
                self.router.cancel(ticket)
            return


def serve_in_thread(router: Router, host: str = "127.0.0.1", port: int = 0,
                    default_deadline: Optional[float] = None):
    """Run a Server on its own event loop in a daemon thread; returns the
    started Server (``server.port`` is bound).  Call the returned
    ``shutdown()`` to stop the loop — the embedding entry point."""
    server = Server(router, host, port, default_deadline)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def _run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        started.set()
        loop.run_forever()
        loop.run_until_complete(server.stop())
        loop.close()

    thread = threading.Thread(target=_run, name="http-server", daemon=True)
    thread.start()
    if not started.wait(timeout=30.0):
        raise RuntimeError("HTTP server failed to start within 30s")

    def shutdown():
        async def _drain():
            # stop accepting, then cancel in-flight handlers so the loop
            # winds down clean (no destroyed-but-pending tasks)
            await server.stop()
            cur = asyncio.current_task()
            tasks = [t for t in asyncio.all_tasks() if t is not cur]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            asyncio.run_coroutine_threadsafe(_drain(), loop).result(
                timeout=30.0)
        except Exception:
            pass
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30.0)
        router.close()

    return server, shutdown


def run_server(router: Router, host: str = "127.0.0.1", port: int = 8000,
               default_deadline: Optional[float] = None) -> None:
    """Blocking entry point for the CLI: serve until interrupted."""
    async def _main():
        server = Server(router, host, port, default_deadline)
        await server.start()
        print(f"serving on http://{server.host}:{server.port}  "
              f"(POST /v1/generate, GET /healthz, GET /stats)")
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()
            router.close()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        pass
