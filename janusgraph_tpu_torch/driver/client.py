"""Remote client: submit queries over HTTP or WebSocket — the port's copy
of ``janusgraph_tpu/driver/client.py``; it talks to a server of either
package.

Capability parity with the reference's remote driver usage (gremlin-driver
Cluster/Client against JanusGraphServer — here a dependency-free client
speaking the server's JSON protocol with GraphSON-typed results).

Overload cooperation (docs/robustness.md "Overload defense"): the client
is the TOP of the retry stack, so it carries the two client-side halves
of the defense —

- **deadline propagation**: ``submit(..., deadline_ms=...)`` (or the
  constructor's ``deadline_ms`` default) ships the remaining budget in an
  ``X-Deadline-Ms`` header (WS ``deadline`` field). The server enforces
  it as a wall-clock evaluation bound and forwards it into the storage
  protocols, so abandoning callers stop burning server work.
- **per-connection retry budget** (:class:`RetryBudget`): a token bucket
  (``driver.retry-budget-capacity`` / ``-refill-per-s``). A shed response
  (429/503 + Retry-After) is retried only while tokens remain, sleeping
  the server's jittered Retry-After hint first — so a thousand shed
  clients cannot re-stampede a recovering server on a synchronized
  schedule, and a client out of tokens surfaces the 503 instead of
  retrying forever.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
import time
from typing import Any, Optional
from urllib import error as _urlerr
from urllib import request as _urlreq

from janusgraph_tpu_torch.driver.graphson import _decode  # typed-JSON reader


class RemoteError(Exception):
    def __init__(self, code, message, status=None, retry_after_s=None):
        super().__init__(f"[{code}] {message}")
        self.code = code
        #: the server's status discriminator ("shed" / "timeout" / None)
        self.status = status
        #: the shed response's Retry-After hint, when one came back
        self.retry_after_s = retry_after_s


class RetryBudget:
    """Token bucket bounding retries per client connection. ``take()``
    spends one token when available; tokens refill continuously at
    ``refill_per_s`` up to ``capacity``. Capacity 0 = never retry."""

    def __init__(self, capacity: float = 8.0, refill_per_s: float = 0.5):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._tokens = float(capacity)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def take(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.capacity,
                self._tokens + (now - self._last) * self.refill_per_s,
            )
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


def _merge_status_ledger(status: dict) -> None:
    """Fold the server's echoed per-request resource ledger
    (``status.ledger``) into the caller's ambient ledger, so a driver-side
    ``ledger_scope()`` sees the query's storage/index costs. Merged
    WITHOUT span annotation: the server-side spans already carry the
    fields (the trace-totals == span-sums invariant)."""
    echoed = status.get("ledger")
    if not isinstance(echoed, dict):
        return
    from janusgraph_tpu_torch.observability.profiler import current_ledger

    led = current_ledger()
    if led is None:
        return
    led.add(**{
        k: v for k, v in echoed.items()
        if isinstance(v, (int, float)) and k != "wall_ms_by_layer"
    })
    for layer, ms in (echoed.get("wall_ms_by_layer") or {}).items():
        led.add_wall(layer, float(ms))


class JanusGraphClient:
    """HTTP client; `ws()` upgrades to a persistent WebSocket session."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8182,
        username: Optional[str] = None,
        password: Optional[str] = None,
        token: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        retry_budget_capacity: Optional[float] = None,
        retry_budget_refill_per_s: Optional[float] = None,
        http_timeout_s: float = 120.0,
        connect_timeout_s: float = 30.0,
    ):
        from janusgraph_tpu_torch.core.config import REGISTRY

        self.base = f"http://{host}:{port}"
        self.host, self.port = host, port
        self.username, self.password = username, password
        self.token = token
        #: default per-submit deadline budget (None = let the server
        #: apply its own default); overridable per call
        self.deadline_ms = deadline_ms
        #: socket-level timeouts: every outbound hop carries one
        #: — a dead server must cost a bounded wait,
        #: never a hung connection. Requests under a deadline use the
        #: remaining budget (+ slack) instead of the flat ceiling.
        self.http_timeout_s = float(http_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        # driver.retry-budget-* defaults come from the config registry so
        # the documented keys and the constructor agree on one value
        if retry_budget_capacity is None:
            retry_budget_capacity = REGISTRY[
                "driver.retry-budget-capacity"
            ].default
        if retry_budget_refill_per_s is None:
            retry_budget_refill_per_s = REGISTRY[
                "driver.retry-budget-refill-per-s"
            ].default
        #: one bucket per client CONNECTION (WS sessions opened from this
        #: client share it): retries across every submit draw from the
        #: same budget, so a burst of sheds cannot multiply into a
        #: stampede
        self.retry_budget = RetryBudget(
            retry_budget_capacity, retry_budget_refill_per_s
        )

    # ----------------------------------------------------------------- auth
    def _auth_header(self) -> dict:
        if self.token:
            return {"Authorization": f"Token {self.token}"}
        if self.username is not None:
            raw = base64.b64encode(
                f"{self.username}:{self.password}".encode()
            ).decode()
            return {"Authorization": f"Basic {raw}"}
        return {}

    def fetch_token(self) -> str:
        body = json.dumps(
            {"username": self.username, "password": self.password}
        ).encode()
        req = _urlreq.Request(
            self.base + "/token", data=body, method="POST",
            headers={"Content-Type": "application/json"},
        )
        with _urlreq.urlopen(req, timeout=self.http_timeout_s) as resp:
            self.token = json.loads(resp.read())["token"]
        return self.token

    # ---------------------------------------------------------------- HTTP
    def submit(
        self,
        gremlin: str,
        graph: Optional[str] = None,
        deadline_ms: Optional[float] = None,
    ) -> Any:
        from janusgraph_tpu_torch.observability import tracer

        if deadline_ms is None:
            deadline_ms = self.deadline_ms
        give_up_at = (
            time.monotonic() + deadline_ms / 1000.0
            if deadline_ms else None
        )
        # the client-side root of the distributed trace: the request ships
        # this span's context in X-Trace-Context, the server's spans (and
        # the storage/index nodes' below it) join the same trace_id
        with tracer.span(
            "driver.submit", graph=graph or "", transport="http",
        ) as sp:
            ctx = sp.context()
            body = json.dumps({"gremlin": gremlin, "graph": graph}).encode()
            while True:
                headers = {
                    "Content-Type": "application/json",
                    "X-Trace-Context": ctx.to_header(),
                    **self._auth_header(),
                }
                if give_up_at is not None:
                    # REMAINING budget at send time: retries shrink it
                    headers["X-Deadline-Ms"] = str(
                        max(0, int((give_up_at - time.monotonic()) * 1000))
                    )
                req = _urlreq.Request(
                    self.base + "/gremlin", data=body, method="POST",
                    headers=headers,
                )
                retry_after = None
                # per-request socket timeout: the remaining deadline plus
                # slack for the response to travel, else the flat ceiling
                timeout_s = self.http_timeout_s
                if give_up_at is not None:
                    timeout_s = max(
                        0.05, give_up_at - time.monotonic() + 5.0
                    )
                try:
                    with _urlreq.urlopen(req, timeout=timeout_s) as resp:
                        payload = json.loads(resp.read())
                except _urlerr.HTTPError as e:
                    # shed (429/503 + Retry-After) and timeout (504)
                    # responses ride real HTTP codes with a structured
                    # JSON body; anything else (401, 404, ...) keeps the
                    # stdlib behavior callers already handle
                    if e.code not in (429, 503, 504):
                        raise
                    try:
                        payload = json.loads(e.read())
                    except Exception:  # noqa: BLE001 - non-JSON error body
                        payload = {"status": {
                            "code": e.code, "message": str(e),
                        }}
                    retry_after = e.headers.get("Retry-After")
                status = payload.get("status", {})
                if "trace" in status:
                    sp.annotate(server_trace=status["trace"])
                _merge_status_ledger(status)
                if status.get("code") == 200:
                    return _decode(payload["result"]["data"])
                sp.annotate(code=status.get("code"))
                err = RemoteError(
                    status.get("code"), status.get("message"),
                    status=status.get("status"),
                    retry_after_s=status.get("retry_after_s"),
                )
                if not self._should_retry(err, retry_after, give_up_at, sp):
                    raise err

    def _should_retry(self, err, retry_after_header, give_up_at, sp) -> bool:
        """Shed-response retry policy: only 429/503 sheds are retriable,
        only while the retry budget has tokens, and only after sleeping
        the server's Retry-After hint (never past the caller's own
        deadline). Everything else surfaces immediately."""
        if err.code not in (429, 503) or err.status != "shed":
            return False
        wait_s = err.retry_after_s
        if wait_s is None and retry_after_header:
            try:
                wait_s = float(retry_after_header)
            except ValueError:
                wait_s = None
        if wait_s is None:
            wait_s = 1.0
        if give_up_at is not None and (
            time.monotonic() + wait_s >= give_up_at
        ):
            return False  # honoring Retry-After would blow the deadline
        if not self.retry_budget.take():
            sp.annotate(retry_budget_exhausted=True)
            return False
        sp.annotate(retried_after_s=wait_s)
        time.sleep(wait_s)
        return True

    def graphs(self) -> list:
        req = _urlreq.Request(
            self.base + "/graphs", headers=self._auth_header()
        )
        with _urlreq.urlopen(req, timeout=self.http_timeout_s) as resp:
            return json.loads(resp.read())["graphs"]

    def health(self) -> bool:
        with _urlreq.urlopen(
            self.base + "/health", timeout=self.http_timeout_s
        ) as resp:
            return json.loads(resp.read()).get("status") == "ok"

    # ------------------------------------------------------------ WebSocket
    def ws(
        self, session: bool = False, multiplex: Optional[bool] = None
    ) -> "WebSocketSession":
        """Open a persistent WS connection; session=True switches it to
        the server's in-session mode (one transaction spans submits until
        the query commits — g.commit() — or the connection closes, which
        rolls back). ``multiplex`` (default driver.ws-multiplex) lets
        concurrent submits share this one socket: each request carries a
        client id the server echoes, responses demux out of order."""
        return WebSocketSession(self, session=session, multiplex=multiplex)


class WebSocketSession:
    """Persistent WS connection; submit() round-trips one JSON request.

    With multiplexing on, many threads may submit concurrently over the
    ONE socket: requests carry a client-assigned ``id``, a send lock
    serializes frames out, and whichever waiter holds the receive lock
    demuxes responses (its own and its siblings') by the echoed id —
    the same leader/follower discipline as the pipelined KCVS client.
    Against an old server that does not echo ids, responses are matched
    in request order (the server processes id-less and pre-multiplex
    requests strictly serially), so mixed pairs stay compatible."""

    def __init__(self, client: JanusGraphClient, session: bool = False,
                 multiplex: Optional[bool] = None):
        from janusgraph_tpu_torch.core.config import REGISTRY

        self.client = client
        self.session = session
        if multiplex is None:
            multiplex = REGISTRY["driver.ws-multiplex"].default
        self.multiplex = bool(multiplex)
        self._next_id = 1
        self._id_lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        #: id -> [Event, payload|None, exc|None]; one entry per in-flight
        #: submit — bounded by the caller thread count
        self._waiters = {}
        #: outstanding ids in request order, for old servers that do not
        #: echo ids (their responses are strictly ordered)
        import collections

        self._order = collections.deque()
        # bounded CONNECT (a dead host costs one timeout,
        # not a hang); the established socket returns to blocking mode —
        # a WS session legitimately idles between submits
        self.sock = socket.create_connection(
            (client.host, client.port), timeout=client.connect_timeout_s
        )
        key = base64.b64encode(os.urandom(16)).decode()
        auth = client._auth_header()
        auth_line = "".join(f"{k}: {v}\r\n" for k, v in auth.items())
        handshake = (
            f"GET /gremlin HTTP/1.1\r\n"
            f"Host: {client.host}:{client.port}\r\n"
            f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n{auth_line}\r\n"
        )
        self.sock.sendall(handshake.encode())
        # read response headers
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("handshake failed")
            buf += chunk
        status_line = buf.split(b"\r\n", 1)[0].decode()
        if " 101 " not in status_line:
            raise ConnectionError(f"ws upgrade rejected: {status_line}")
        # handshake done: long-lived blocking socket from here on (the
        # connect timeout above bounded the only hop that can hang cold)
        self.sock.settimeout(None)

    def submit(
        self,
        gremlin: str,
        graph: Optional[str] = None,
        deadline_ms: Optional[float] = None,
    ) -> Any:
        from janusgraph_tpu_torch.observability import tracer

        if deadline_ms is None:
            deadline_ms = self.client.deadline_ms
        give_up_at = (
            time.monotonic() + deadline_ms / 1000.0
            if deadline_ms else None
        )
        with tracer.span(
            "driver.submit", graph=graph or "", transport="ws",
        ) as sp:
            while True:
                req = {
                    "gremlin": gremlin, "graph": graph,
                    # WS has no per-message headers; the trace context
                    # (and the deadline budget) ride reserved request
                    # fields instead
                    "trace": sp.context().to_header(),
                }
                if give_up_at is not None:
                    req["deadline"] = max(
                        0, int((give_up_at - time.monotonic()) * 1000)
                    )
                if self.session:
                    req["session"] = True
                if self.multiplex:
                    payload = self._submit_multiplexed(req)
                else:
                    self._send(json.dumps(req))
                    payload = json.loads(self._recv())
                status = payload.get("status", {})
                _merge_status_ledger(status)
                if status.get("code") == 200:
                    return _decode(payload["result"]["data"])
                sp.annotate(code=status.get("code"))
                err = RemoteError(
                    status.get("code"), status.get("message"),
                    status=status.get("status"),
                    retry_after_s=status.get("retry_after_s"),
                )
                # shed retries draw from the OWNING client's budget: one
                # connection, one bucket
                if not self.client._should_retry(err, None, give_up_at, sp):
                    raise err

    # ------------------------------------------------------- multiplexing
    def _submit_multiplexed(self, req: dict) -> dict:
        """One multiplexed round trip: send with a fresh id, then drive
        the shared receive loop (leader) or wait for a leader to demux
        our response (follower)."""
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        req["id"] = rid
        waiter = [threading.Event(), None, None]
        self._waiters[rid] = waiter
        self._order.append(rid)
        with self._send_lock:
            self._send(json.dumps(req))
        ev = waiter[0]
        while not ev.is_set():
            if self._recv_lock.acquire(timeout=0.02):
                try:
                    while not ev.is_set():
                        self._route(json.loads(self._recv()))
                except Exception as e:  # noqa: BLE001 - fail all waiters
                    self._fail_waiters(e)
                finally:
                    self._recv_lock.release()
            else:
                ev.wait(0.05)
        if waiter[2] is not None:
            raise waiter[2]
        return waiter[1]

    def _route(self, payload: dict) -> None:
        rid = payload.get("id")
        if rid is None and self._order:
            # old server: no echoed id — responses arrive in request
            # order (the server serves id-less requests serially)
            rid = self._order[0]
        try:
            self._order.remove(rid)
        except ValueError:
            pass
        w = self._waiters.pop(rid, None)
        if w is not None:
            w[1] = payload
            w[0].set()

    def _fail_waiters(self, exc: Exception) -> None:
        while self._waiters:
            try:
                _rid, w = self._waiters.popitem()
            except KeyError:
                break
            w[2] = exc
            w[0].set()
        self._order.clear()

    def close(self) -> None:
        try:
            self.sock.sendall(b"\x88\x80" + os.urandom(4))  # masked close
        except OSError:
            pass
        self.sock.close()

    # client frames MUST be masked per RFC6455
    def _send(self, text: str) -> None:
        payload = text.encode()
        mask = os.urandom(4)
        masked = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        n = len(payload)
        hdr = bytearray([0x81])
        if n < 126:
            hdr.append(0x80 | n)
        elif n < (1 << 16):
            hdr.append(0x80 | 126)
            hdr += struct.pack(">H", n)
        else:
            hdr.append(0x80 | 127)
            hdr += struct.pack(">Q", n)
        self.sock.sendall(bytes(hdr) + mask + masked)

    def _recv(self) -> str:
        hdr = self._read_exact(2)
        b1, b2 = hdr
        length = b2 & 0x7F
        if length == 126:
            (length,) = struct.unpack(">H", self._read_exact(2))
        elif length == 127:
            (length,) = struct.unpack(">Q", self._read_exact(8))
        payload = self._read_exact(length)
        if (b1 & 0x0F) == 0x8:
            raise ConnectionError("server closed")
        return payload.decode()

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("connection closed")
            buf += chunk
        return buf


class WatchSession:
    """Client half of the server's ``/watch`` live-telemetry stream.

    Speaks the telemetry bus's wire protocol (server/server.py
    ``_watch_stream``): connect, upgrade, send ONE masked subscribe
    frame, then :meth:`recv` parsed ``hello`` / ``event`` /
    ``heartbeat`` frames until the peer closes.  The reference's
    ``watch`` tool and the fleet federation's push-mode transport ride
    it (ROADMAP Queue A #5.6b), which is why the constructor takes a URL
    rather than a JanusGraphClient: the federation addresses replicas by
    their registered base URLs.

    ``recv(timeout)`` returns the next frame dict, or None when the
    timeout elapses with nothing queued (callers poll their stop flags
    on that cadence — no unbounded blocking
    reads), and raises ``ConnectionError`` when the peer is gone.
    """

    def __init__(
        self,
        url: str,
        subscribe: Optional[dict] = None,
        connect_timeout_s: float = 5.0,
    ):
        from urllib.parse import urlsplit

        parts = urlsplit(url if "//" in url else "//" + url)
        host = parts.hostname or "localhost"
        port = parts.port or 80
        self.url = url
        # bounded CONNECT, like WebSocketSession
        self.sock = socket.create_connection(
            (host, port), timeout=connect_timeout_s
        )
        key = base64.b64encode(os.urandom(16)).decode()
        handshake = (
            f"GET /watch HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n"
        )
        self.sock.sendall(handshake.encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("watch handshake failed")
            buf += chunk
        status_line = buf.split(b"\r\n", 1)[0].decode()
        if " 101 " not in status_line:
            raise ConnectionError(f"watch upgrade rejected: {status_line}")
        self._send(json.dumps(subscribe or {}))

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Next protocol frame as a dict; None on timeout, raises
        ``ConnectionError`` on close/EOF.  The poll timeout applies to
        the frame HEADER only — once a header lands, the body is read
        under a fixed generous bound, and a mid-frame stall is a dead
        peer (abandoning mid-frame would desync the stream)."""
        self.sock.settimeout(timeout)
        try:
            hdr = self._read_exact(2)
        except (socket.timeout, TimeoutError):
            return None
        self.sock.settimeout(max(10.0, timeout or 0.0))
        try:
            text = self._recv_body(hdr)
        except (socket.timeout, TimeoutError):
            raise ConnectionError("peer stalled mid-frame") from None
        try:
            return json.loads(text)
        except ValueError as e:
            raise ConnectionError(f"undecodable watch frame: {e}") from None

    def close(self) -> None:
        try:
            self.sock.sendall(b"\x88\x80" + os.urandom(4))  # masked close
        except OSError:
            pass
        self.sock.close()

    # client frames MUST be masked per RFC6455 (same codec shape as
    # WebSocketSession; duplicated rather than shared because the two
    # sessions have different timeout disciplines on the same calls)
    def _send(self, text: str) -> None:
        payload = text.encode()
        mask = os.urandom(4)
        masked = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
        n = len(payload)
        hdr = bytearray([0x81])
        if n < 126:
            hdr.append(0x80 | n)
        elif n < (1 << 16):
            hdr.append(0x80 | 126)
            hdr += struct.pack(">H", n)
        else:
            hdr.append(0x80 | 127)
            hdr += struct.pack(">Q", n)
        self.sock.sendall(bytes(hdr) + mask + masked)

    def _recv_body(self, hdr: bytes) -> str:
        b1, b2 = hdr
        length = b2 & 0x7F
        if length == 126:
            (length,) = struct.unpack(">H", self._read_exact(2))
        elif length == 127:
            (length,) = struct.unpack(">Q", self._read_exact(8))
        payload = self._read_exact(length)
        if (b1 & 0x0F) == 0x8:
            raise ConnectionError("server closed")
        return payload.decode()

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("connection closed")
            buf += chunk
        return buf
