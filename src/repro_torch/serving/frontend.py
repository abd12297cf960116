"""Streaming front-end over the port's ``ServeEngine`` (own copy of the
reference ``repro/serving/frontend.py``), stdlib only.

* :class:`EngineService`: the thread-safe mailbox between the clients and
  the scheduler. ``ServeEngine.serve_service(service)`` runs on one worker
  thread, which makes every call to the card (prefills, decode windows, the
  side stream's staged recall, the pinned copies); each round the
  continuous scheduler takes ``poll()`` (new requests) and
  ``drain_cancels()`` (hung-up clients) and pushes each token and each
  terminal state back through the callback given at ``submit()``. A
  request keeps its own sample stream (``request_key(seed, uid)``), so its
  tokens are the same whether it arrives here or in a batch handed to
  ``engine.generate``.
* :class:`HttpFrontend`: a small asyncio HTTP/1.1 server over the service:

  - ``POST /generate``: admit a request; ``"stream": true`` (the default)
    answers with a chunked NDJSON stream (``start``, a ``token`` per token
    with its server time, ``done``), else with one JSON reply at the end.
    EOF on the client's socket cancels the request: the scheduler frees
    its slot (and drops the staged recall in flight) at the next round and
    records it CANCELLED.
  - ``GET /metrics``: the live run's registry as Prometheus text.
  - ``GET /stats``: the sliding-window board's snapshot
    (``obs.timeseries``) with the run's counts and SLO section.
  - ``GET /healthz``: liveness.

  The server's thread touches no tensor: it reads the registry and the
  board, which take their own locks.

The blocking client helpers (:func:`http_generate`, :func:`http_get_json`,
:func:`http_get_text`) use ``http.client``, so plain threads can drive the
server.
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serving.engine import Request

# event kinds delivered to ``submit(on_event=...)`` subscribers
EV_TOKEN = "token"
EV_FINISH = "finish"
EV_ERROR = "error"


class EngineService:
    """Thread-safe request mailbox driving ``ServeEngine.serve_service``.

    Client side (any thread): ``submit``, ``cancel``, ``close``, ``stop``.
    Scheduler side (the worker thread): ``poll``, ``drain_cancels``,
    ``wait``, ``emit_token``, ``emit_finish``, the ``service`` protocol of
    ``ContinuousScheduler.run``. Events reach the callbacks on the worker
    thread, so a callback must be cheap and thread-safe (the HTTP layer
    hands them to its event loop with ``loop.call_soon_threadsafe``). A
    failure of the worker reaches every waiting callback as an ``error``
    event, refuses later submissions, and is raised again by ``stop``.
    """

    def __init__(self, engine, seed: int = 0):
        self.engine = engine
        self.seed = seed
        self._cv = threading.Condition()
        self._inbox: List[object] = []
        self._cancels: List[int] = []
        self._subs: Dict[int, Callable] = {}
        self._closed = False
        self._next_uid = 0
        self._used_uids: set = set()
        self.em = None                  # live EngineMetrics once attached
        self.t0: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._result = None
        self._error: Optional[BaseException] = None
        self.started_at = time.time()

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "EngineService":
        assert self._thread is None, "service already started"
        self._thread = threading.Thread(
            target=self._run, name="engine-service", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        try:
            self._result = self.engine.serve_service(self, seed=self.seed)
        except Exception as e:          # the clients hear of it; stop() raises it
            with self._cv:
                self._error = e
                subs = dict(self._subs)
                self._subs.clear()
                self._cv.notify_all()
            for uid, cb in subs.items():
                try:
                    cb(EV_ERROR, {"uid": uid, "error": repr(e)})
                except Exception:       # a callback's fault must not hide the worker's
                    pass

    def close(self) -> None:
        """No further submissions; the scheduler drains what is queued."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def stop(self):
        """Close, drain, join the worker; returns every completion (in
        admission order, cancelled requests' partial ones included), or
        raises the worker's failure."""
        self.close()
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- producer side --------------------------------------------------
    def submit(self, tokens, max_new_tokens: int,
               on_event: Callable[[str, dict], None], *,
               uid: Optional[int] = None, priority: int = 0,
               eos_token: Optional[int] = None,
               slo_ttft_ms: Optional[float] = None,
               slo_itl_ms: Optional[float] = None) -> int:
        """Admit one request; returns its uid. ``on_event(kind, payload)``
        fires on the worker thread for every token and at the terminal
        state. An explicit ``uid`` lets a run be compared with a direct
        ``engine.generate`` of the same requests (the sample stream is keyed
        on it)."""
        tokens = np.asarray(tokens, np.int32)
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        req = Request(uid=-1, tokens=tokens, max_new_tokens=max_new_tokens,
                      eos_token=eos_token, priority=priority,
                      slo_ttft_ms=slo_ttft_ms, slo_itl_ms=slo_itl_ms)
        padded = getattr(self.engine, "_padded_prompt", None)
        if padded is not None:
            padded(req)                 # raises ValueError past the engine's max_len
        with self._cv:
            if self._error is not None:
                raise RuntimeError(f"engine worker failed: {self._error!r}")
            if self._closed:
                raise RuntimeError("service closed to new submissions")
            if uid is None:
                while self._next_uid in self._used_uids:
                    self._next_uid += 1
                uid = self._next_uid
                self._next_uid += 1
            elif uid in self._used_uids:
                raise ValueError(f"duplicate uid {uid}")
            self._used_uids.add(uid)
            self._subs[uid] = on_event
            req.uid = uid
            self._inbox.append(req)
            self._cv.notify_all()
        return uid

    def cancel(self, uid: int) -> None:
        """Ask for a request's cancellation (idempotent; the scheduler's
        cancellation pass ignores unknown and finished uids)."""
        with self._cv:
            self._cancels.append(int(uid))
            self._cv.notify_all()

    # -- scheduler side (ContinuousScheduler service protocol) ----------
    def attach(self, em, t0: float) -> None:
        self.em = em
        self.t0 = t0

    def poll(self) -> List[object]:
        with self._cv:
            out, self._inbox = self._inbox, []
        return out

    def drain_cancels(self) -> List[int]:
        with self._cv:
            out, self._cancels = self._cancels, []
        return out

    def wait(self, timeout: float) -> None:
        with self._cv:
            if not (self._inbox or self._cancels or self._closed):
                self._cv.wait(timeout)

    @property
    def closed(self) -> bool:
        """True once no new work can ever arrive: closed AND drained."""
        with self._cv:
            return self._closed and not self._inbox and not self._cancels

    @property
    def pending(self) -> bool:
        """Work waiting in the mailbox (a decode window then ends at the
        next slot turnover instead of running its whole length)."""
        with self._cv:
            return bool(self._inbox or self._cancels)

    def emit_token(self, uid: int, index: int, token: int,
                   t_rel: float, interpolated: bool = False) -> None:
        """``interpolated`` marks a time the scheduler split out of one read
        (the steps of a decode window, the rows of a verify iteration)
        rather than one it measured for this token."""
        cb = self._subs.get(uid)
        if cb is None:
            return
        try:
            cb(EV_TOKEN, {"uid": uid, "index": index, "token": token,
                          "t": t_rel, "interpolated": bool(interpolated)})
        except Exception:               # a callback's fault never stops the decode
            pass

    def emit_finish(self, uid: int, tr) -> None:
        cb = self._subs.pop(uid, None)
        if cb is None:
            return
        rm = tr.metrics
        rec = {
            "uid": uid,
            "state": tr.state,
            "cancelled": bool(rm.cancelled),
            "tokens": [int(t) for t in tr.tokens],
            "new_tokens": len(tr.tokens),
            "ttft_s": rm.ttft_s,
            "queue_wait_s": rm.queue_wait_s,
            "finish_t": rm.finish_t,
        }
        try:
            cb(EV_FINISH, rec)
        except Exception:
            pass


# ----------------------------------------------------------------------
# asyncio HTTP front-end (stdlib only)
# ----------------------------------------------------------------------
_MAX_BODY = 8 << 20


def _resp(status: str, body: bytes, ctype: str = "application/json") -> bytes:
    return (f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n"
            f"\r\n").encode() + body


def _json_resp(status: str, obj) -> bytes:
    return _resp(status, (json.dumps(obj) + "\n").encode())


class HttpFrontend:
    """Small asyncio HTTP/1.1 server over an :class:`EngineService`."""

    def __init__(self, service: EngineService, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self.host, self.port = host, port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # -- request plumbing ----------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            parts = line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0].upper(), parts[1]
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", 0) or 0)
            if 0 < n <= _MAX_BODY:
                body = await reader.readexactly(n)
            await self._route(method, path, body, reader, writer)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, method, path, body, reader, writer):
        if method == "GET" and path == "/healthz":
            writer.write(_json_resp("200 OK", {
                "ok": True, "engine_running": self.service.running,
                "uptime_s": time.time() - self.service.started_at}))
            await writer.drain()
        elif method == "GET" and path == "/metrics":
            em = self.service.em
            text = em.registry.to_prometheus() if em is not None else "\n"
            writer.write(_resp("200 OK", text.encode(),
                               "text/plain; version=0.0.4"))
            await writer.drain()
        elif method == "GET" and path == "/stats":
            writer.write(_json_resp("200 OK", self._stats()))
            await writer.drain()
        elif method == "POST" and path == "/generate":
            await self._generate(body, reader, writer)
        else:
            writer.write(_json_resp("404 Not Found",
                                    {"error": f"no route {method} {path}"}))
            await writer.drain()

    def _stats(self) -> dict:
        svc = self.service
        board = getattr(getattr(svc.engine, "obs", None), "timeseries", None)
        em = svc.em
        extra = {}
        if em is not None:
            extra = {
                "completed": em.registry.counter(
                    "requests_completed_total").value,
                "cancelled": em.cancellations,
                "generated_tokens": em.registry.counter(
                    "request_tokens_generated_total").value,
                "slo": em.slo_summary(),
            }
        if board is not None:
            snap = board.snapshot(extra=extra)
        else:
            snap = {"schema_version": 0, "stats": {}, "rates": {},
                    "extra": extra}
        snap["engine_running"] = svc.running
        return snap

    async def _generate(self, body, reader, writer):
        svc = self.service
        try:
            req = json.loads(body.decode() or "{}")
            tokens = req["tokens"]
            if not isinstance(tokens, list) or not tokens:
                raise ValueError("tokens must be a non-empty list")
        except (ValueError, KeyError) as e:
            writer.write(_json_resp("400 Bad Request", {"error": str(e)}))
            await writer.drain()
            return
        stream = bool(req.get("stream", True))
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def on_event(kind, payload):
            loop.call_soon_threadsafe(q.put_nowait, (kind, payload))

        try:
            uid = svc.submit(
                tokens, int(req.get("max_new_tokens", 32)), on_event,
                uid=req.get("uid"), priority=int(req.get("priority", 0)),
                eos_token=req.get("eos_token"),
                slo_ttft_ms=req.get("slo_ttft_ms"),
                slo_itl_ms=req.get("slo_itl_ms"))
        except (ValueError, RuntimeError) as e:
            writer.write(_json_resp("400 Bad Request", {"error": str(e)}))
            await writer.drain()
            return

        if not stream:
            await self._await_completion(uid, q, writer)
            return
        await self._stream(uid, q, reader, writer)

    async def _await_completion(self, uid, q, writer):
        tokens = []
        while True:
            kind, payload = await q.get()
            if kind == EV_TOKEN:
                tokens.append(payload["token"])
            elif kind == EV_FINISH:
                writer.write(_json_resp("200 OK", payload))
                await writer.drain()
                return
            else:
                writer.write(_json_resp("500 Internal Server Error",
                                        payload))
                await writer.drain()
                return

    async def _stream(self, uid, q, reader, writer):
        """Chunked NDJSON event stream; EOF from the client cancels the
        request. A pending one-byte read watches the socket: a client that
        goes away closes it, the read returns EOF, and the uid goes to the
        scheduler's cancellations; the slot (and the staged recall in
        flight) is released at the next round."""
        svc = self.service
        writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: application/x-ndjson\r\n"
            b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n")
        await writer.drain()

        def chunk(obj) -> bytes:
            data = (json.dumps(obj) + "\n").encode()
            return f"{len(data):x}\r\n".encode() + data + b"\r\n"

        eof_watch = asyncio.ensure_future(reader.read(1))
        try:
            writer.write(chunk({"event": "start", "uid": uid,
                                "t_server": time.time()}))
            await writer.drain()
            while True:
                get = asyncio.ensure_future(q.get())
                await asyncio.wait({get, eof_watch},
                                   return_when=asyncio.FIRST_COMPLETED)
                if eof_watch.done() and not get.done():
                    get.cancel()
                    svc.cancel(uid)
                    # drain until the scheduler confirms the terminal state
                    while True:
                        kind, payload = await q.get()
                        if kind != EV_TOKEN:
                            break
                    return
                kind, payload = await get
                if kind == EV_TOKEN:
                    writer.write(chunk({"event": "token", **payload,
                                        "t_server": time.time()}))
                    await writer.drain()
                elif kind == EV_FINISH:
                    writer.write(chunk({"event": "done", **payload}))
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                    return
                else:
                    writer.write(chunk({"event": "error", **payload}))
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                    return
        except (ConnectionError, RuntimeError):
            svc.cancel(uid)
        finally:
            if not eof_watch.done():
                eof_watch.cancel()


def run_http_frontend(service: EngineService, host: str = "127.0.0.1",
                      port: int = 0, ready: Optional[threading.Event] = None,
                      stop: Optional[threading.Event] = None,
                      frontend: Optional[HttpFrontend] = None) -> HttpFrontend:
    """Run the HTTP front-end's event loop on the calling thread until
    ``stop`` is set (or forever). ``launch/serve.py --serve-http`` runs it
    on the main thread, tests on a helper thread. The bound port is in
    ``frontend.port`` before ``ready`` is set."""
    fe = frontend if frontend is not None else HttpFrontend(service, host,
                                                            port)

    async def main():
        await fe.start()
        if ready is not None:
            ready.set()
        if stop is None:
            await fe._server.serve_forever()
        else:
            while not stop.is_set():
                await asyncio.sleep(0.01)
        await fe.stop()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:           # pragma: no cover - interactive
        pass
    return fe


def serve_http_background(service: EngineService, host: str = "127.0.0.1",
                          port: int = 0):
    """Start the HTTP front-end on a daemon thread; returns ``(frontend,
    stop_event, thread)`` once the port is bound. Set ``stop_event`` and
    join the thread to shut it down."""
    fe = HttpFrontend(service, host, port)
    ready, stop = threading.Event(), threading.Event()
    th = threading.Thread(
        target=run_http_frontend, args=(service, host, port),
        kwargs={"ready": ready, "stop": stop, "frontend": fe},
        name="http-frontend", daemon=True)
    th.start()
    if not ready.wait(30.0):            # pragma: no cover - startup hang
        raise RuntimeError("HTTP front-end failed to bind")
    return fe, stop, th


# ----------------------------------------------------------------------
# blocking client helpers (http.client)
# ----------------------------------------------------------------------
def http_get_json(host: str, port: int, path: str, timeout: float = 30.0):
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def http_get_text(host: str, port: int, path: str, timeout: float = 30.0):
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def http_generate(host: str, port: int, payload: dict,
                  timeout: float = 300.0):
    """POST /generate with ``stream=true``; yields the NDJSON events as
    they arrive (http.client undoes the chunking)."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps({**payload, "stream": True})
        conn.request("POST", "/generate", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(
                f"/generate -> {resp.status}: {resp.read().decode()}")
        while True:
            line = resp.readline()
            if not line:
                return
            line = line.strip()
            if line:
                yield json.loads(line.decode())
    finally:
        conn.close()
