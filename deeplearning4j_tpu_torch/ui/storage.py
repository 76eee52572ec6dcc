"""Stats storage: pluggable persistence for StatsReport streams (the JAX
package's ``ui/storage.py``: the same file format, so a file written by
either package replays in the other).

Role parity (ref: deeplearning4j-core/.../api/storage/{StatsStorage,
StatsStorageRouter,Persistable}.java and deeplearning4j-ui-model/.../storage/
{InMemoryStatsStorage,MapDBStatsStorage,J7FileStatsStorage}.java): an
in-memory store, an append-only file store over the binary codec, and a
remote router that POSTs records to a running UIServer
(ref: deeplearning4j-core/.../api/storage/impl/RemoteUIStatsStorageRouter.java).
"""

from __future__ import annotations

import json
import os
import struct
import threading
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.ui.stats import StatsInitializationReport, StatsReport


class StatsStorage:
    """Base API: sessions, per-session report streams, change listeners."""

    def __init__(self):
        self._lock = threading.Lock()
        self._listeners: List[Callable[[str, StatsReport], None]] = []

    # ---- router interface (what StatsListener calls)
    def put_init_report(self, report: StatsInitializationReport) -> None:
        raise NotImplementedError

    def put_report(self, session_id: str, report: StatsReport) -> None:
        raise NotImplementedError

    # ---- query interface (what the UI calls)
    def list_sessions(self) -> List[str]:
        raise NotImplementedError

    def get_reports(self, session_id: str) -> List[StatsReport]:
        raise NotImplementedError

    def get_init_report(self, session_id: str) -> Optional[StatsInitializationReport]:
        raise NotImplementedError

    # ---- change notification (ref: StatsStorage listener registration)
    def register_listener(self, fn: Callable[[str, StatsReport], None]) -> None:
        self._listeners.append(fn)

    def _notify(self, session_id: str, report: StatsReport) -> None:
        for fn in list(self._listeners):
            try:
                fn(session_id, report)
            except Exception:
                pass


class InMemoryStatsStorage(StatsStorage):
    """Ref: deeplearning4j-ui-model/.../storage/InMemoryStatsStorage.java."""

    def __init__(self):
        super().__init__()
        self._reports: Dict[str, List[StatsReport]] = {}
        self._inits: Dict[str, StatsInitializationReport] = {}

    def put_init_report(self, report):
        with self._lock:
            self._inits[report.session_id] = report
            self._reports.setdefault(report.session_id, [])

    def put_report(self, session_id, report):
        with self._lock:
            self._reports.setdefault(session_id, []).append(report)
        self._notify(session_id, report)

    def list_sessions(self):
        with self._lock:
            return sorted(self._reports.keys())

    def get_reports(self, session_id):
        with self._lock:
            return list(self._reports.get(session_id, []))

    def get_init_report(self, session_id):
        with self._lock:
            return self._inits.get(session_id)


# File record framing: u8 kind (0=init json, 1=report), u16 session len,
# session bytes, u32 payload len, payload.
_FRAME = struct.Struct("<BH")


class FileStatsStorage(InMemoryStatsStorage):
    """Append-only single-file store over the binary codec; the full index
    is rebuilt by replaying the file on open (ref: J7FileStatsStorage.java —
    SQLite there; a flat log + in-memory index here)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            valid_end = self._replay()
            if valid_end < os.path.getsize(path):
                # drop the torn tail so future appends start at a
                # record boundary
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
        self._fh = open(path, "ab")

    def _replay(self) -> int:
        """Rebuild the index; returns the offset after the last complete
        record."""
        with open(self.path, "rb") as f:
            data = f.read()
        off = 0
        valid = 0
        while off + _FRAME.size <= len(data):
            kind, slen = _FRAME.unpack_from(data, off)
            off += _FRAME.size
            # a partially-written trailing record (process killed mid-
            # _append) must not make earlier records inaccessible: stop
            # replaying at the first incomplete frame
            if off + slen + 4 > len(data):
                break
            sid = data[off:off + slen].decode()
            off += slen
            (plen,) = struct.unpack_from("<I", data, off)
            off += 4
            if off + plen > len(data):
                break
            payload = data[off:off + plen]
            off += plen
            if kind == 0:
                d = json.loads(payload.decode())
                rep = StatsInitializationReport(
                    session_id=sid, timestamp_ms=d.get("timestamp_ms", 0),
                    software=d.get("software", {}),
                    hardware=d.get("hardware", {}), model=d.get("model", {}))
                super().put_init_report(rep)
            else:
                super().put_report(sid, StatsReport.decode(payload))
            valid = off
        return valid

    def _append(self, kind: int, session_id: str, payload: bytes) -> None:
        sid = session_id.encode()
        with self._lock:
            if self._fh.closed:
                # the log is append-only, so reopening after close() is safe
                # (e.g. storage still attached to a UIServer)
                self._fh = open(self.path, "ab")
            self._fh.write(_FRAME.pack(kind, len(sid)))
            self._fh.write(sid)
            self._fh.write(struct.pack("<I", len(payload)))
            self._fh.write(payload)
            self._fh.flush()

    def put_init_report(self, report):
        payload = json.dumps({
            "timestamp_ms": report.timestamp_ms, "software": report.software,
            "hardware": report.hardware, "model": report.model}).encode()
        self._append(0, report.session_id, payload)
        super().put_init_report(report)

    def put_report(self, session_id, report):
        self._append(1, session_id, report.encode())
        super().put_report(session_id, report)

    def close(self) -> None:
        self._fh.close()


class RemoteStatsStorageRouter(StatsStorage):
    """POSTs records to a UIServer over HTTP. A dashboard outage must not
    abort training: failures are logged and, after `max_failures`
    consecutive errors, posting is disabled for the session
    (ref: RemoteUIStatsStorageRouter.java — same degrade-gracefully
    contract, retry queue there, circuit breaker here)."""

    def __init__(self, url: str, max_failures: int = 10,
                 queue_size: int = 256, timeout: float = 5.0):
        super().__init__()
        import queue
        self.url = url.rstrip("/")
        self.max_failures = max_failures
        self.timeout = timeout
        self._consecutive_failures = 0
        # async delivery (ref: RemoteUIStatsStorageRouter's retry queue):
        # iteration_done never blocks on the network; a full queue drops
        # the oldest record
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._worker = threading.Thread(target=self._drain, daemon=True,
                                        name="stats-router")
        self._worker.start()

    def _enqueue(self, item) -> None:
        import queue
        if self._consecutive_failures >= self.max_failures:
            return
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            try:
                self._queue.get_nowait()  # drop oldest
            except queue.Empty:
                pass
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                pass

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._post_now(*item)
            finally:
                self._queue.task_done()

    def _post_now(self, path: str, body: bytes, content_type: str) -> None:
        import logging
        import urllib.request
        req = urllib.request.Request(
            self.url + path, data=body, method="POST",
            headers={"Content-Type": content_type})
        try:
            urllib.request.urlopen(req, timeout=self.timeout).read()
            self._consecutive_failures = 0
        except Exception as e:
            self._consecutive_failures += 1
            log = logging.getLogger("deeplearning4j_tpu_torch")
            if self._consecutive_failures == self.max_failures:
                log.warning("stats POST to %s failed %d times (%s); "
                            "disabling remote stats for this run",
                            self.url, self._consecutive_failures, e)
            else:
                log.debug("stats POST to %s failed: %s", self.url, e)

    def _post(self, path: str, body: bytes, content_type: str) -> None:
        self._enqueue((path, body, content_type))

    def flush(self, timeout: float = 10.0) -> None:
        """Block until queued records are delivered (or timeout)."""
        import time as _time
        deadline = _time.monotonic() + timeout
        # unfinished_tasks covers both queued and in-flight records
        while (self._queue.unfinished_tasks
               and _time.monotonic() < deadline):
            _time.sleep(0.02)

    def close(self) -> None:
        self.flush()
        self._queue.put(None)
        # reap the worker: it exits on the None poison, bounded by the
        # in-flight POST's own timeout
        self._worker.join(timeout=self.timeout + 1.0)

    def put_init_report(self, report):
        payload = json.dumps({
            "session_id": report.session_id,
            "timestamp_ms": report.timestamp_ms, "software": report.software,
            "hardware": report.hardware, "model": report.model}).encode()
        self._post("/api/init", payload, "application/json")

    def put_report(self, session_id, report):
        from urllib.parse import quote
        self._post(f"/api/post?session={quote(session_id, safe='')}",
                   report.encode(), "application/octet-stream")

    def list_sessions(self):
        return []

    def get_reports(self, session_id):
        return []

    def get_init_report(self, session_id):
        return None
