"""RPC transports: deterministic in-process fake + real TCP sockets.

Both present the same tiny surface: a server side binds an address to a
`handler(request: dict) -> dict`, a client side does `call(addr, request)`.
Handlers answer `{"ok": True, ...}` on success and
`{"ok": False, "error": msg}` on application errors; transport-level
failures raise `RpcError` / `RpcTimeout`.

The reference's counterpart is one Bolt RPC server per broker with five
registered processors and sync `invokeSync` clients (reference:
mq-broker/.../TopicsRaftServer.java:106-120,
mq-common/.../MetadataClient.java:27,63-69). Differences by design:

- `InProcNetwork` exists for N-broker single-process tests with fault
  injection (node down, link partition) — the deterministic harness
  SURVEY.md §4 calls for; the reference could only test multi-broker
  behavior inside docker-compose.
- `TcpClient` pipelines: frames carry request ids, many calls can be in
  flight per connection (the reference is strictly one-at-a-time).

Twin of `ripplemq_tpu/wire/transport.py` (PyTorch port): the same code,
importing only the port's modules, so both packages behave alike step
for step.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
# On Python < 3.11 concurrent.futures.TimeoutError is NOT the builtin
# TimeoutError, so Future.result timeouts must be caught as both.
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Callable, Optional

from ripplemq_tpu_torch.obs.lockwitness import make_lock

from ripplemq_tpu_torch.wire import codec

Handler = Callable[[dict], dict]


class RpcError(Exception):
    """Transport-level RPC failure (connect refused, peer down, ...)."""


class RpcTimeout(RpcError):
    """No response within the deadline (network partition, dead peer)."""


class Transport:
    """Client-side transport interface."""

    def call(self, addr: str, request: dict, timeout: float = 3.0) -> dict:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


# ---------------------------------------------------------------------------
# In-process fake network
# ---------------------------------------------------------------------------

class InProcNetwork:
    """Deterministic in-process network: handlers keyed by address string.

    Fault injection:
      - `set_down(addr)` / `set_up(addr)`: node crash — calls raise RpcError.
      - `block(a, b)` / `unblock(a, b)`: symmetric link partition between
        two endpoint addresses — calls raise RpcTimeout (a partition looks
        like silence, not a refusal).
      - `block_oneway(src, dst)` / `unblock_oneway`: ASYMMETRIC partition
        — only src→dst requests vanish; dst can still reach src. The
        classic half-open link that symmetric partitions cannot express
        (a leader that can send heartbeats but never hear acks).
      - `drop_next(src, dst, n)`: drop the next n requests on a link —
        exercises retry paths deterministically.
      - `dup_next(src, dst, n)`: deliver the next n requests on a link
        TWICE (handler runs twice; the first response is discarded) —
        exercises handler idempotence under at-least-once delivery.
      - `delay_next(src, dst, n, delay_s)`: stall the next n requests by
        `delay_s` on the caller's thread before the handler runs — a slow
        link that reorders traffic relative to other links.

    Calls run the handler synchronously on the caller's thread: no real
    concurrency is introduced by the network itself, so test interleavings
    are exactly the interleavings the test writes.
    """

    def __init__(self) -> None:
        self._handlers: dict[str, Handler] = {}
        self._down: set[str] = set()
        self._blocked: set[frozenset[str]] = set()
        self._blocked_oneway: set[tuple[str, str]] = set()
        self._drops: dict[tuple[str, str], int] = {}
        self._dups: dict[tuple[str, str], int] = {}
        self._delays: dict[tuple[str, str], tuple[int, float]] = {}
        self._lock = make_lock("InProcNetwork._lock")
        self.calls: list[tuple[str, str, str]] = []  # (src, dst, type) trace
        # Duplications actually DELIVERED (handler ran twice) — distinct
        # from charges consumed by requests that also hit a block/drop.
        # The chaos checker keys its exactly-once suspension on this.
        self.dups_applied = 0

    # -- server side --
    def register(self, addr: str, handler: Handler) -> None:
        with self._lock:
            self._handlers[addr] = handler

    def unregister(self, addr: str) -> None:
        with self._lock:
            self._handlers.pop(addr, None)

    # -- fault injection --
    def set_down(self, addr: str) -> None:
        with self._lock:
            self._down.add(addr)

    def set_up(self, addr: str) -> None:
        with self._lock:
            self._down.discard(addr)

    def block(self, a: str, b: str) -> None:
        with self._lock:
            self._blocked.add(frozenset((a, b)))

    def unblock(self, a: str, b: str) -> None:
        with self._lock:
            self._blocked.discard(frozenset((a, b)))

    def block_oneway(self, src: str, dst: str) -> None:
        with self._lock:
            self._blocked_oneway.add((src, dst))

    def unblock_oneway(self, src: str, dst: str) -> None:
        with self._lock:
            self._blocked_oneway.discard((src, dst))

    def heal(self) -> None:
        with self._lock:
            self._blocked.clear()
            self._blocked_oneway.clear()
            self._down.clear()
            self._drops.clear()
            self._dups.clear()
            self._delays.clear()

    def drop_next(self, src: str, dst: str, n: int = 1) -> None:
        with self._lock:
            self._drops[(src, dst)] = self._drops.get((src, dst), 0) + n

    def dup_next(self, src: str, dst: str, n: int = 1) -> None:
        with self._lock:
            self._dups[(src, dst)] = self._dups.get((src, dst), 0) + n

    def delay_next(self, src: str, dst: str, n: int = 1,
                   delay_s: float = 0.05) -> None:
        with self._lock:
            left, _ = self._delays.get((src, dst), (0, 0.0))
            self._delays[(src, dst)] = (left + n, float(delay_s))

    # -- client side --
    def client(self, src_addr: str = "client") -> "InProcClient":
        return InProcClient(self, src_addr)

    def deliver(self, src: str, dst: str, request: dict, timeout: float) -> dict:
        with self._lock:
            handler = self._handlers.get(dst)
            down = dst in self._down or src in self._down
            blocked = (frozenset((src, dst)) in self._blocked
                       or (src, dst) in self._blocked_oneway)
            pending_drops = self._drops.get((src, dst), 0)
            if pending_drops:
                self._drops[(src, dst)] = pending_drops - 1
            dup = 0
            pending_dups = self._dups.get((src, dst), 0)
            if pending_dups:
                self._dups[(src, dst)] = pending_dups - 1
                dup = 1
            delay_s = 0.0
            pending_delays, d = self._delays.get((src, dst), (0, 0.0))
            if pending_delays:
                self._delays[(src, dst)] = (pending_delays - 1, d)
                delay_s = d
            self.calls.append((src, dst, str(request.get("type"))))
        if handler is None or down:
            raise RpcError(f"{dst}: connection refused")
        if blocked or pending_drops:
            raise RpcTimeout(f"{src}->{dst}: timed out after {timeout}s")
        if delay_s > 0:
            # Synchronous by design: the slow link stalls the CALLER, the
            # same head-of-line effect a real slow socket produces.
            time.sleep(delay_s)
        # Round-trip through the codec so in-proc tests exercise the same
        # encoding constraints as real sockets (no sharing of mutables).
        wire_req = codec.decode(codec.encode(request))
        try:
            resp = handler(wire_req)
            if dup:
                # At-least-once delivery: the handler sees the request
                # again (fresh decode — no shared mutables between the
                # two executions); only the LAST response reaches the
                # caller, like a client retry whose first response was
                # lost in flight.
                resp = handler(codec.decode(codec.encode(request)))
                with self._lock:
                    self.dups_applied += 1
        except Exception as e:  # handler bug → application error, not crash
            resp = {"ok": False, "error": f"internal: {type(e).__name__}: {e}"}
        return codec.decode(codec.encode(resp))


class InProcClient(Transport):
    def __init__(self, net: InProcNetwork, src_addr: str) -> None:
        self._net = net
        self.src_addr = src_addr

    def call(self, addr: str, request: dict, timeout: float = 3.0) -> dict:
        return self._net.deliver(self.src_addr, addr, request, timeout)

    def call_async(self, addr: str, request: dict) -> Future:
        """Uniform pipelining surface: the in-proc network is
        synchronous BY DESIGN (deterministic interleavings), so this
        executes inline and returns an already-resolved future. Callers
        written against the async surface — windowed producers, the
        consumer readahead — then run unchanged on in-proc clusters
        without anyone burning a pool thread around a sync call."""
        fut: Future = Future()
        try:
            fut.set_result(self.call(addr, request))
        except Exception as e:
            fut.set_exception(e)
        return fut


# ---------------------------------------------------------------------------
# TCP
# ---------------------------------------------------------------------------

class TcpServer:
    """Length-prefixed-frame TCP server with a worker pool.

    One acceptor thread; one reader thread per connection; handlers run on
    a shared pool so a slow request (e.g. an append waiting on its device
    round) does not stall the connection's other pipelined requests.
    """

    def __init__(
        self,
        host: str,
        port: int,
        handler: Handler,
        workers: int = 16,
        raw_handler: Optional[Callable[[bytes], Optional[dict]]] = None,
    ) -> None:
        self._handler = handler
        # Raw-frame dispatch hook: sees the UNDECODED body before the
        # codec runs and may answer the request itself (the broker's
        # produce fast path peeks routing scalars and ships the frame
        # to the owning host worker, which performs the only decode).
        # Returning None falls through to the ordinary decode path —
        # the hook must never raise for "not mine".
        self._raw_handler = raw_handler
        self._sock = socket.create_server((host, port), reuse_port=False)
        self._sock.settimeout(0.2)
        self.host, self.port = self._sock.getsockname()[:2]
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._lock = make_lock("TcpServer._lock")

    def start(self) -> None:
        t = threading.Thread(target=self._accept_loop, daemon=True, name="tcp-accept")
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            # Daemon reader thread per connection; deliberately untracked —
            # it exits when the socket dies, and stop() closes all sockets.
            threading.Thread(
                target=self._conn_loop, args=(conn,), daemon=True, name="tcp-conn"
            ).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        write_lock = threading.Lock()
        try:
            while not self._stop.is_set():
                try:
                    req_id, body = codec.read_frame(conn)
                except (ConnectionError, ValueError, OSError):
                    return
                self._pool.submit(self._handle_one, conn, write_lock, req_id, body)
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle_one(self, conn, write_lock, req_id: int, body: bytes) -> None:
        try:
            resp = (self._raw_handler(body)
                    if self._raw_handler is not None else None)
            if resp is None:
                request = codec.decode(body)
                if not isinstance(request, dict):
                    raise ValueError("request must be a dict")
                resp = self._handler(request)
        except Exception as e:
            resp = {"ok": False, "error": f"internal: {type(e).__name__}: {e}"}
        try:
            with write_lock:
                codec.write_frame(conn, req_id, codec.encode(resp))
        except OSError:
            pass  # client went away; nothing to do

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._pool.shutdown(wait=False)


def connect(host: str, port: int, timeout: float,
            source_address=None) -> socket.socket:
    """`socket.create_connection`, refusing a connection to itself. A
    client port taken from the ephemeral range can equal the port it
    dials; when nothing listens there yet, TCP's simultaneous open
    connects the socket to itself, and the caller would then hear its
    own request as the peer's answer. Such a socket is closed and the
    connect raises ConnectionRefusedError, like the refused dial it is."""
    sock = socket.create_connection((host, port), timeout=timeout,
                                    source_address=source_address)
    try:
        if sock.getsockname() == sock.getpeername():
            raise ConnectionRefusedError(
                f"connection to {host}:{port} reached its own socket "
                f"(nothing listens there)")
    except OSError:
        sock.close()
        raise
    return sock


class _Conn:
    """One pooled client connection with a reader thread matching request
    ids to futures (pipelining)."""

    def __init__(self, addr: str, connect_timeout: float) -> None:
        host, port_s = addr.rsplit(":", 1)
        self.sock = connect(host, int(port_s), connect_timeout)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.write_lock = make_lock("_Conn.write_lock")
        self.pending: dict[int, Future] = {}
        self.pending_lock = make_lock("_Conn.pending_lock")
        self.dead = False
        self.reader = threading.Thread(target=self._read_loop, daemon=True,
                                       name=f"tcp-client-{addr}")
        self.reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                req_id, body = codec.read_frame(self.sock)
                with self.pending_lock:
                    fut = self.pending.pop(req_id, None)
                if fut is not None and not fut.cancelled():
                    try:
                        fut.set_result(codec.decode(body))
                    except Exception as e:
                        fut.set_exception(RpcError(f"bad response frame: {e}"))
        except (ConnectionError, ValueError, OSError) as e:
            self._fail_all(RpcError(f"connection lost: {e}"))

    def _fail_all(self, exc: Exception) -> None:
        # The dead latch flips INSIDE pending_lock (ownership lint):
        # send() checks it under the same lock, so every future
        # either sees dead (refused) or sits in the dict this swap
        # takes — a latch flipped outside the critical section leaves
        # that pairing to the GIL's mercy.
        with self.pending_lock:
            self.dead = True
            pending, self.pending = self.pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)
        try:
            self.sock.close()
        except OSError:
            pass

    def send(self, req_id: int, body: bytes) -> Future:
        fut: Future = Future()
        with self.pending_lock:
            if self.dead:
                raise RpcError("connection closed")
            self.pending[req_id] = fut
        try:
            with self.write_lock:
                codec.write_frame(self.sock, req_id, body)
        except OSError as e:
            with self.pending_lock:
                self.pending.pop(req_id, None)
            self._fail_all(RpcError(f"send failed: {e}"))
            raise RpcError(f"send failed: {e}") from e
        return fut


class TcpClient(Transport):
    """Thread-safe pipelining client with one pooled connection per address."""

    def __init__(self, connect_timeout: float = 3.0) -> None:
        self._conns: dict[str, _Conn] = {}
        self._lock = make_lock("TcpClient._lock")
        self._ids = itertools.count(1)
        self._connect_timeout = connect_timeout

    def _conn_for(self, addr: str) -> _Conn:
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn.dead:
                return conn
        # connect outside the lock; last writer wins on a race
        try:
            conn = _Conn(addr, self._connect_timeout)
        except OSError as e:
            raise RpcError(f"{addr}: connect failed: {e}") from e
        with self._lock:
            existing = self._conns.get(addr)
            if existing is not None and not existing.dead:
                conn._fail_all(RpcError("superseded"))
                return existing
            self._conns[addr] = conn
        return conn

    def call_async(self, addr: str, request: dict) -> Future:
        body = codec.encode(request)
        conn = self._conn_for(addr)
        req_id = next(self._ids)
        fut = conn.send(req_id, body)
        fut._rmq_conn, fut._rmq_req_id = conn, req_id  # for timeout cleanup
        return fut

    def call(self, addr: str, request: dict, timeout: float = 3.0) -> dict:
        fut = self.call_async(addr, request)
        try:
            return fut.result(timeout=timeout)
        except (TimeoutError, FuturesTimeoutError):
            # Drop the pending entry: the connection may stay alive for a
            # long time, and abandoned futures must not accumulate.
            with fut._rmq_conn.pending_lock:
                fut._rmq_conn.pending.pop(fut._rmq_req_id, None)
            fut.cancel()
            raise RpcTimeout(f"{addr}: no response after {timeout}s") from None

    def close(self) -> None:
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for conn in conns:
            conn._fail_all(RpcError("client closed"))
