"""Chrome about:tracing timeline writer (Python side).

Analog of the reference's horovod/common/timeline.cc (Timeline,
TimelineWriter; SURVEY.md §5): every tensor's lifecycle is emitted as
chrome-trace duration events (NEGOTIATE -> QUEUE -> FUSE -> <OP>) from hooks
in the cycle loop, serialised by a dedicated writer thread.  The C++ core has
its own native timeline with the same output format; this implementation
backs the pure-Python core and Python-level annotations.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional


class TimelineWriter:
    """Background thread draining events to a chrome-trace JSON array file."""

    def __init__(self, path: str):
        self._path = path
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="hvd-timeline-writer", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        with open(self._path, "w") as f:
            f.write("[\n")
            first = True
            while True:
                ev = self._queue.get()
                if ev is None:
                    break
                if not first:
                    f.write(",\n")
                f.write(json.dumps(ev))
                first = False
                f.flush()
            f.write("\n]\n")

    def emit(self, ev: dict) -> None:
        self._queue.put(ev)

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=5.0)


class Timeline:
    """Per-tensor phase tracking with chrome-trace output.

    Phases mirror the reference: NEGOTIATE_<OP>, QUEUE, MEMCPY_IN_FUSION_BUFFER,
    <OP> (data plane), MEMCPY_OUT_FUSION_BUFFER.
    """

    def __init__(self):
        self._writer: Optional[TimelineWriter] = None
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._mark_cycles = False
        self._t0 = time.monotonic()

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def start(self, path: str, mark_cycles: bool = False) -> None:
        with self._lock:
            if self._writer is None:
                self._writer = TimelineWriter(path)
                self._mark_cycles = mark_cycles

    def stop(self) -> None:
        with self._lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None

    def _us(self) -> int:
        return int((time.monotonic() - self._t0) * 1e6)

    def begin(self, tensor_name: str, phase: str) -> None:
        w = self._writer
        if w is None:
            return
        w.emit({"name": phase, "ph": "B", "ts": self._us(), "pid": self._pid,
                "tid": hash(tensor_name) % (1 << 31), "args": {"tensor": tensor_name}})

    def end(self, tensor_name: str, phase: str) -> None:
        w = self._writer
        if w is None:
            return
        w.emit({"name": phase, "ph": "E", "ts": self._us(), "pid": self._pid,
                "tid": hash(tensor_name) % (1 << 31)})

    def instant(self, name: str) -> None:
        w = self._writer
        if w is None:
            return
        w.emit({"name": name, "ph": "i", "ts": self._us(), "pid": self._pid,
                "tid": 0, "s": "p"})

    def mark_cycle(self) -> None:
        if self._mark_cycles:
            self.instant("CYCLE")
