"""NDArray pub/sub over TCP, the Kafka client's counterpart (the JAX
package's ``streaming/ndarray_channel.py``, whose wire this is byte for
byte: a JAX publisher and a port consumer, or the reverse, exchange the
same frames).

Ref: dl4j-streaming/.../kafka/{NDArrayPublisher,NDArrayConsumer,
NDArrayKafkaClient}.java (NDArrays base64-serialized onto Kafka topics).
``NDArrayServer`` is the broker stand-in: it buffers published arrays
per topic (bounded queues) and hands them to consumers in FIFO order.
Arrays on the wire are host numpy arrays; a card tensor is copied off the
device by its caller (``streaming/pipeline.ServeRoute``).

Wire format (protocol v2): 8-byte big-endian word whose top bit marks a
v2 frame and whose low 63 bits carry the payload length, then the
``np.save`` payload, then a 4-byte CRC-32 trailer of the payload. v1
frames (plain length word, no trailer) are still accepted, but both
versions are subject to the frame-size cap: a corrupt or malicious
length header must produce a clean ``ProtocolError``, never a multi-GB
allocation loop. A frame that starts arriving must keep arriving — a
stalled (slow-loris) frame times out as a protocol error while an idle
stream may stay quiet forever.
"""

from __future__ import annotations

import collections
import io
import random
import socket
import socketserver
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.profiling.flightrec import record as flight_record
from deeplearning4j_tpu_torch.profiling.metrics import get_registry

#: refuse frames claiming more than this many payload bytes (both
#: directions, both protocol versions). 256 MiB holds a ~67M-element
#: float32 array — far beyond any sane streaming minibatch.
FRAME_CAP_BYTES = 1 << 28

_V2_FLAG = 1 << 63
_HEADER_MAX = 1024  # "PUB <topic>\n" header line cap (broker side)


class ProtocolError(ConnectionError):
    """Corrupt/oversized/stalled frame. A ``ConnectionError`` because
    the stream cannot be resynchronized past a bad frame — the only
    recovery is reconnect (which the consumer/publisher already do)."""


def _frame_error(msg: str) -> ProtocolError:
    get_registry().counter(
        "streaming_frame_errors_total",
        help="frames rejected by the streaming protocol (bad length, "
             "bad CRC, truncation, stall)").inc()
    return ProtocolError(msg)


def _send_array(sock: socket.socket, arr: np.ndarray,
                frame_cap: Optional[int] = None) -> None:
    from deeplearning4j_tpu_torch.resilience import faultinject
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    data = buf.getvalue()
    cap = FRAME_CAP_BYTES if frame_cap is None else int(frame_cap)
    if len(data) > cap:
        raise _frame_error(
            f"refusing to send {len(data)}-byte frame (cap {cap})")
    frame = (struct.pack(">Q", _V2_FLAG | len(data)) + data
             + struct.pack(">I", zlib.crc32(data) & 0xFFFFFFFF))
    frame = faultinject.corrupt_wire(frame)
    stall = faultinject.slow_loris_s()
    if stall > 0.0:
        # chaos: dribble the header one byte at a time — the receiver's
        # mid-frame timeout must reclaim its thread
        per = stall / 8.0
        for i in range(min(8, len(frame))):
            sock.sendall(frame[i:i + 1])
            time.sleep(per)
        sock.sendall(frame[8:])
        return
    sock.sendall(frame)


def _recv_exact(sock: socket.socket, n: int,
                t_end: Optional[float] = None) -> Optional[bytes]:
    """Exactly ``n`` bytes, None on clean EOF at a frame boundary, or
    ``ProtocolError`` on EOF mid-buffer (a truncated frame).

    ``t_end`` is a *per-frame* monotonic deadline: each recv gets only
    the remaining budget (a per-recv timeout alone would let a peer
    dribbling one byte per window hold the thread for hours)."""
    got = bytearray()
    while len(got) < n:
        if t_end is not None:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                raise _frame_error(
                    "stalled frame: per-frame budget exhausted")
            sock.settimeout(remaining)
        c = sock.recv(min(n - len(got), 1 << 20))
        if not c:
            if not got:
                return None
            raise _frame_error(
                f"truncated frame: EOF after {len(got)}/{n} bytes")
        got += c
    return bytes(got)


def _recv_array(sock: socket.socket, frame_cap: Optional[int] = None,
                io_timeout: Optional[float] = None) -> Optional[np.ndarray]:
    """One array off the wire; None on clean close.

    ``io_timeout`` arms the anti-slow-loris clock: the wait for a
    frame's FIRST byte uses the socket's own timeout (an idle stream is
    legal), but once a frame starts arriving the remainder must land
    within ``io_timeout`` or the frame is a protocol error.
    """
    cap = FRAME_CAP_BYTES if frame_cap is None else int(frame_cap)
    old_timeout = sock.gettimeout()
    try:
        first = _recv_exact(sock, 1)
        if first is None:
            return None
        # the frame has begun: the REST of it shares one budget
        t_end = (None if io_timeout is None
                 else time.monotonic() + io_timeout)
        try:
            rest = _recv_exact(sock, 7, t_end)
            if rest is None:
                raise _frame_error("truncated frame: EOF inside header")
            (word,) = struct.unpack(">Q", first + rest)
            v2 = bool(word & _V2_FLAG)
            length = word & (_V2_FLAG - 1)
            if length > cap:
                raise _frame_error(
                    f"frame claims {length} bytes (cap {cap}) — corrupt "
                    f"or malicious length header")
            data = _recv_exact(sock, int(length), t_end)
            if data is None:
                raise _frame_error("truncated frame: EOF before payload")
            if v2:
                trailer = _recv_exact(sock, 4, t_end)
                if trailer is None:
                    raise _frame_error(
                        "truncated frame: EOF before CRC trailer")
                (want,) = struct.unpack(">I", trailer)
                have = zlib.crc32(data) & 0xFFFFFFFF
                if have != want:
                    raise _frame_error(
                        f"CRC-32 mismatch (got {have:#x}, frame says "
                        f"{want:#x})")
            try:
                return np.load(io.BytesIO(data), allow_pickle=False)
            except ProtocolError:
                raise
            except Exception as e:
                raise _frame_error(f"undecodable npy payload: {e}") from e
        except TimeoutError as e:
            # only reachable once the frame began arriving
            raise _frame_error(
                f"stalled frame: no bytes for {io_timeout}s "
                f"mid-frame") from e
    finally:
        try:
            sock.settimeout(old_timeout)
        except OSError:
            pass  # socket already closed


class _Topic:
    """Bounded FIFO queue supporting head-requeue (a consumer that
    vanishes mid-send must not reorder the stream).

    ``max_depth`` bounds the queue (0 = unbounded, the legacy
    behavior); ``policy`` picks what a full queue does to ``put``:
    ``drop_oldest`` evicts the head (freshest data keeps flowing — the
    right default for telemetry-style streams) and ``block`` makes the
    publisher wait for a consumer, up to ``deadline_s``."""

    def __init__(self, max_depth: int = 0, policy: str = "drop_oldest"):
        if policy not in ("drop_oldest", "block"):
            raise ValueError(f"unknown topic policy {policy!r}")
        self._dq: "collections.deque[np.ndarray]" = collections.deque()
        self._cond = threading.Condition()
        self.max_depth = max(0, int(max_depth))
        self.policy = policy

    def __len__(self) -> int:
        with self._cond:
            return len(self._dq)

    def put(self, arr: np.ndarray,
            deadline_s: Optional[float] = None) -> bool:
        """Enqueue; returns False when the array was dropped (block
        policy past its deadline). drop_oldest always succeeds — the
        HEAD is evicted and counted instead."""
        dropped = get_registry().counter(
            "streaming_dropped_total",
            help="arrays dropped by bounded topic queues")
        with self._cond:
            if self.max_depth and len(self._dq) >= self.max_depth:
                if self.policy == "drop_oldest":
                    self._dq.popleft()
                    dropped.inc()
                else:  # block
                    t_end = (None if deadline_s is None
                             else time.monotonic() + deadline_s)
                    while len(self._dq) >= self.max_depth:
                        left = (0.5 if t_end is None
                                else t_end - time.monotonic())
                        if left <= 0:
                            # streaming_dropped_total IS the signal; a
                            # topic-put timeout is not a request
                            # deadline (taxonomy: serving_deadline_*
                            # means an admitted request's budget)
                            dropped.inc()
                            return False
                        self._cond.wait(min(0.5, left))
            self._dq.append(arr)
            # notify_all, not notify: a dead subscriber's handler may be
            # among the waiters and declines the array (see get) — every
            # live waiter must get a chance at it
            self._cond.notify_all()
        return True

    def put_front(self, arr: np.ndarray) -> None:
        with self._cond:
            # requeue is exempt from the bound: dropping an in-flight
            # array on requeue would silently lose delivered-once data
            self._dq.appendleft(arr)
            self._cond.notify_all()

    def get(self, closing: Optional[threading.Event] = None,
            dead=None) -> Optional[np.ndarray]:
        """Block for the next array; returns None once ``closing`` is set
        (woken by NDArrayServer.stop's notify_all) so idle SUB handler
        threads exit on shutdown instead of parking forever, or once
        ``dead()`` reports the consumer vanished — without the dead
        check, a dropped subscriber's handler keeps competing for the
        queue and silently eats arrays meant for its reconnected
        successor."""
        with self._cond:
            while True:
                if closing is not None and closing.is_set():
                    return None
                # checked BEFORE popping on every wake: a handler woken
                # by put() whose consumer died mid-wait must decline the
                # array, not send it into the void
                if dead is not None and dead():
                    return None
                if self._dq:
                    arr = self._dq.popleft()
                    self._cond.notify_all()  # unblock 'block' publishers
                    return arr
                self._cond.wait(timeout=0.5)

    def wake_all(self) -> None:
        with self._cond:
            self._cond.notify_all()


class NDArrayServer:
    """Broker: topics -> bounded FIFO queues. Protocol per connection:
    first line ``PUB <topic>\\n`` or ``SUB <topic>\\n``; then arrays flow
    (PUB: client->server; SUB: server->client).

    Hardened edge: connection admission through a
    ``ServiceGuard`` (``max_connections`` concurrent handlers, excess
    closed and counted as shed), a header-read timeout that reclaims
    slow-loris threads, per-frame stall timeouts, the frame cap + CRC
    protocol, bounded topics, and a graceful ``drain``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_depth: int = 1024, policy: str = "drop_oldest",
                 max_connections: int = 64, header_timeout: float = 10.0,
                 io_timeout: float = 30.0,
                 put_deadline_s: Optional[float] = 5.0,
                 frame_cap: int = FRAME_CAP_BYTES):
        from deeplearning4j_tpu_torch.resilience import service
        self._topics: Dict[str, _Topic] = {}
        self._lock = threading.Lock()
        self._closing = threading.Event()
        self._max_depth = max(0, int(max_depth))
        self._policy = policy
        self._header_timeout = header_timeout
        self._io_timeout = io_timeout
        self._put_deadline_s = put_deadline_s
        self._frame_cap = int(frame_cap)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                from deeplearning4j_tpu_torch.resilience.service import \
                    ServiceError
                try:
                    admission = outer._guard.admit()
                except ServiceError:
                    return  # shed/draining: close the connection
                with admission:
                    try:
                        self._serve()
                    except (ProtocolError, TimeoutError, OSError):
                        return  # counted where raised; reclaim thread

            def _serve(self):
                # header under a deadline: a client dribbling
                # "PUB t\n" byte-by-byte must not park this thread
                self.request.settimeout(outer._header_timeout)
                line = b""
                try:
                    while not line.endswith(b"\n"):
                        if len(line) >= _HEADER_MAX:
                            raise _frame_error("oversized header line")
                        c = self.request.recv(1)
                        if not c:
                            return
                        line += c
                except TimeoutError as e:
                    # an idle/dribbled header, not an admitted
                    # request's blown budget — keep the deadline
                    # counter honest (same taxonomy as KerasServer)
                    get_registry().counter(
                        "serving_idle_timeouts_total",
                        help="connections closed after the handler "
                             "socket idle/slow-loris timeout").inc()
                    raise _frame_error("slow-loris header timed "
                                       "out") from e
                mode, topic = line.decode().strip().split(None, 1)
                q = outer._queue(topic)
                if mode == "PUB":
                    # idle publishers are legal: no timeout between
                    # frames; _recv_array arms the per-frame stall clock
                    self.request.settimeout(None)
                    while True:
                        arr = _recv_array(self.request,
                                          frame_cap=outer._frame_cap,
                                          io_timeout=outer._io_timeout)
                        if arr is None:
                            return
                        q.put(arr, deadline_s=outer._put_deadline_s)
                elif mode == "SUB":
                    import select
                    # io_timeout on the SEND side too: a subscriber
                    # that connects and never reads fills its TCP
                    # buffer and would otherwise park this handler in
                    # sendall forever — under bounded admission that
                    # is one stolen slot per bad client until the
                    # whole broker is dead. On timeout the OSError
                    # path below requeues the array at the HEAD and
                    # reclaims the thread.
                    self.request.settimeout(outer._io_timeout)

                    def sub_dead(sock=self.request):
                        # a SUB client never sends after its header, so
                        # readability can only mean EOF/RST: the
                        # consumer hung up (or reconnected elsewhere)
                        try:
                            r, _, _ = select.select([sock], [], [], 0)
                            return bool(r)
                        except OSError:
                            return True

                    while True:
                        arr = q.get(closing=outer._closing, dead=sub_dead)
                        if arr is None:  # server shutdown or dead consumer
                            return
                        try:
                            _send_array(self.request, arr,
                                        frame_cap=outer._frame_cap)
                        except OSError:
                            # consumer vanished mid-send: requeue at the
                            # HEAD so stream order is preserved
                            q.put_front(arr)
                            return

        self._server = socketserver.ThreadingTCPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self.host = host
        self._guard = service.register_guard(service.ServiceGuard(
            f"ndarray_broker_{self.port}", max_concurrency=max_connections,
            queue_depth=0, default_deadline_ms=None))
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _queue(self, topic: str) -> _Topic:
        with self._lock:
            return self._topics.setdefault(
                topic, _Topic(max_depth=self._max_depth,
                              policy=self._policy))

    def drain(self, grace_s: float = 10.0) -> bool:
        """Graceful shutdown: stop admitting connections, give queued
        arrays up to ``grace_s`` to flush to subscribers, then stop.
        Returns True when every topic emptied inside the grace."""
        self._guard.start_drain()
        flight_record("streaming", "drain_started", port=self.port)
        t_end = time.monotonic() + max(0.0, grace_s)
        drained = True
        while True:
            with self._lock:
                depth = sum(len(t) for t in self._topics.values())
            if depth == 0:
                break
            if time.monotonic() >= t_end:
                drained = False
                get_registry().counter(
                    "serving_drain_timeouts_total",
                    help="drains whose grace expired with work still "
                         "in flight").inc()
                break
            time.sleep(0.05)
        self.stop()
        return drained

    def stop(self) -> None:
        from deeplearning4j_tpu_torch.resilience import service
        self._closing.set()
        with self._lock:
            for topic in self._topics.values():
                topic.wake_all()  # unpark idle SUB handler threads
        self._server.shutdown()
        self._server.server_close()
        # shutdown() already waited for serve_forever to exit; the join
        # reaps the acceptor thread itself (bounded for safety)
        self._thread.join(timeout=5.0)
        service.unregister_guard(self._guard)
        flight_record("streaming", "stopped", port=self.port)


class _ReconnectingEndpoint:
    """Shared reconnect machinery for publisher and consumer: bounded
    exponential backoff + FULL jitter (uniform over [0, delay) —
    OS-seeded so a fleet losing the same broker never retries in
    lockstep), a reconnect counter, and escalation to
    ``ConnectionError`` after ``max_retries`` consecutive failures.
    Subclasses provide ``_connect`` (dial + protocol header)."""

    _RECONNECT_COUNTER = "streaming_reconnects_total"
    _RECONNECT_HELP = "reconnects after a dropped stream"
    _VERB = ""  # prefix in the escalation message ("publish ")

    def __init__(self, host: str, port: int, topic: str,
                 max_retries: int = 3, backoff_base: float = 0.05,
                 backoff_max: float = 2.0):
        self._host, self._port, self._topic = host, port, topic
        self._max_retries = max(0, int(max_retries))
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self._jitter = random.Random()
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> None:
        raise NotImplementedError

    def _close_quietly(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass

    def _reconnect_or_raise(self, attempt: int,
                            exc: BaseException) -> int:
        """One reconnect cycle; returns the bumped attempt count or
        escalates. A failed dial is NOT an extra attempt — the next
        op fails fast on the dead socket and consumes it."""
        attempt += 1
        if attempt > self._max_retries:
            raise ConnectionError(
                f"topic {self._topic!r}: {self._VERB}stream lost and "
                f"{self._max_retries} reconnect attempts failed "
                f"({exc})") from exc
        get_registry().counter(self._RECONNECT_COUNTER,
                               help=self._RECONNECT_HELP).inc()
        delay = min(self._backoff_max,
                    self._backoff_base * (2.0 ** (attempt - 1)))
        time.sleep(delay * self._jitter.random())
        self._close_quietly()
        try:
            self._connect()
        except OSError:
            pass  # broker still down; see docstring
        return attempt

    def close(self) -> None:
        self._close_quietly()


class NDArrayPublisher(_ReconnectingEndpoint):
    """ref: NDArrayPublisher.java — publish(arr) onto a topic.

    ``publish`` reconnects with bounded backoff + jitter on a dropped
    broker connection (parity with the consumer's reconnect), counted
    as ``streaming_pub_reconnects_total``; the whole frame is re-sent
    on the new connection. The broker discards the partial frame a
    failed send left behind (it sees a truncated/stalled frame and
    closes that handler), so delivery across a drop is at-least-once
    for the retried array and never a garbled one."""

    _RECONNECT_COUNTER = "streaming_pub_reconnects_total"
    _RECONNECT_HELP = ("NDArrayPublisher reconnects after a dropped "
                       "stream")
    _VERB = "publish "

    def __init__(self, host: str, port: int, topic: str,
                 max_retries: int = 3, backoff_base: float = 0.05,
                 backoff_max: float = 2.0,
                 frame_cap: int = FRAME_CAP_BYTES):
        super().__init__(host, port, topic, max_retries=max_retries,
                         backoff_base=backoff_base,
                         backoff_max=backoff_max)
        self._frame_cap = frame_cap
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection((self._host, self._port))
        self._sock.sendall(f"PUB {self._topic}\n".encode())

    def publish(self, arr: np.ndarray) -> None:
        from deeplearning4j_tpu_torch.resilience import faultinject
        arr = np.asarray(arr)
        attempt = 0
        while True:
            try:
                if faultinject.on_pub_send():
                    # chaos harness: simulate the broker dropping us
                    self._close_quietly()
                _send_array(self._sock, arr, frame_cap=self._frame_cap)
                return
            except ProtocolError:
                raise  # over-cap frame: no amount of reconnecting helps
            except (ConnectionError, OSError) as e:
                attempt = self._reconnect_or_raise(attempt, e)


class NDArrayConsumer(_ReconnectingEndpoint):
    """ref: NDArrayConsumer.java — getArrays(count) off a topic.

    A dropped connection is an expected event on a long-lived stream
    (broker restart, LB idle-kill, flaky NIC), not an exception: the
    consumer reconnects and re-subscribes with bounded exponential
    backoff + full jitter, raising ``ConnectionError`` only after
    ``max_retries`` consecutive failed attempts. Reconnects are counted
    in the metrics registry (``streaming_reconnects_total``). A corrupt
    frame (bad length, bad CRC, truncation, mid-frame stall) is a
    ``ProtocolError`` — the stream cannot resync past it, so it is
    handled exactly like a drop: reconnect, counted.

    Delivery across a drop is at-most-once for in-flight data: the
    broker requeues the ONE array whose send failed mid-flight at the
    HEAD of the topic (order preserved), but arrays already sitting in
    the dead socket's OS buffer are gone. A recv *timeout* waiting for
    a frame to START is NOT a drop — a quiet stream propagates
    ``TimeoutError`` to the caller, exactly as before reconnect support
    existed.
    """

    _RECONNECT_COUNTER = "streaming_reconnects_total"
    _RECONNECT_HELP = ("NDArrayConsumer reconnects after a dropped "
                       "stream")

    def __init__(self, host: str, port: int, topic: str,
                 timeout: Optional[float] = 10.0, max_retries: int = 3,
                 backoff_base: float = 0.05, backoff_max: float = 2.0,
                 frame_cap: int = FRAME_CAP_BYTES,
                 io_timeout: Optional[float] = 30.0):
        super().__init__(host, port, topic, max_retries=max_retries,
                         backoff_base=backoff_base,
                         backoff_max=backoff_max)
        self._timeout = timeout
        self._frame_cap = frame_cap
        self._io_timeout = io_timeout
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection((self._host, self._port))
        self._sock.settimeout(self._timeout)
        self._sock.sendall(f"SUB {self._topic}\n".encode())

    def get_array(self) -> np.ndarray:
        from deeplearning4j_tpu_torch.resilience import faultinject
        attempt = 0
        while True:
            try:
                if faultinject.on_stream_recv():
                    # chaos harness: simulate the broker dropping us
                    self._close_quietly()
                arr = _recv_array(self._sock, frame_cap=self._frame_cap,
                                  io_timeout=self._io_timeout)
                if arr is None:
                    raise ConnectionError("stream closed by peer")
                return arr
            except (ConnectionError, OSError) as e:
                if isinstance(e, TimeoutError):
                    raise  # quiet stream, not a dropped one — caller's call
                attempt = self._reconnect_or_raise(attempt, e)

    def get_arrays(self, count: int) -> List[np.ndarray]:
        return [self.get_array() for _ in range(count)]
