"""Flight recorder: the last N request timelines, dumped on fault events
(the port's copy of ``repro.serve.flight_recorder``, the same JSONL
layout).

A bounded ring (``collections.deque(maxlen=N)``) of compact per-request
timelines, built from the stamps the engine keeps on each ``Request``
(arrival, admission, first token, finish): no tracer, no per-step work,
one dict a finished request.  When a fault fires (a quarantine, a
watchdog hang or recovery, a shed, a retry) the engine calls
:meth:`FlightRecorder.record_fault`, which appends one dump (a header
line, the fault's facts, then the ring oldest first) to a JSON-lines
file; ``launch/trace_report.py --flight`` renders the dumps.

Request stamps are ``time.time()`` wall clock except ``admit_pc``
(``perf_counter``); the recorder fixes one epoch offset at construction
that puts admission on the wall clock.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, Optional


class FlightRecorder:
    """Bounded per-request history and fault-triggered JSONL dumps.

    ``capacity`` bounds the ring; ``path`` is the dump file, appended to
    (a run may dump several faults; each dump is self-delimiting through
    its header's ``entries``).  ``path=None`` keeps the ring in memory
    only."""

    def __init__(self, capacity: int = 32, path: Optional[str] = None):
        self.capacity = int(capacity)
        self.path = path
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, self.capacity))
        self._epoch = time.time() - time.perf_counter()
        self.dumps = 0          # fault dumps written so far
        self.recorded = 0       # requests ever recorded
        # record_fault runs on the serving thread and the watchdog's: one
        # dump at a time keeps the dumps' indices and lines whole.
        self._dump_lock = threading.Lock()

    def record_request(self, req, *, slot: Optional[int] = None,
                       status: str = "ok") -> None:
        """Fold one finished or failed request's timeline into the ring:
        its queue, staging and decode segments from its stamps (a segment
        whose stamps are missing, e.g. a request shed while queued, is
        ``None``)."""
        arrival = getattr(req, "arrival_s", None)
        admit_pc = getattr(req, "admit_pc", None)
        admit = (admit_pc + self._epoch) if admit_pc is not None else None
        first = getattr(req, "first_token_s", None)
        finish = getattr(req, "finish_s", None)

        def seg(a, b):
            return round(b - a, 6) if a is not None and b is not None \
                else None

        self._ring.append({
            "uid": getattr(req, "uid", None),
            "status": status,
            "slot": slot,
            "prompt_tokens": len(getattr(req, "prompt", ()) or ()),
            "tokens": len(getattr(req, "out_tokens", ()) or ()),
            "retries": getattr(req, "retries", 0),
            "arrival_s": arrival,
            "queue_s": seg(arrival, admit),
            "staging_s": seg(admit, first),
            "decode_s": seg(first, finish),
            "latency_s": getattr(req, "latency_s", None) or
            seg(arrival, finish),
        })
        self.recorded += 1

    def record_fault(self, kind: str, **facts: Any) -> Dict[str, Any]:
        """A fault fired: append one dump to the file (one
        ``{"flight_dump": ...}`` header, one ``{"fault": ...}`` line, then
        ``entries`` request lines oldest first); returns the header.  The
        watchdog's thread may call this while the serving thread records:
        dumps are taken one at a time, each from one copy of the ring."""
        with self._dump_lock:
            ring = list(self._ring)
            header = {
                "flight_dump": self.dumps,
                "time_s": round(time.time(), 3),
                "kind": kind,
                "entries": len(ring),
                "capacity": self.capacity,
                "recorded_total": self.recorded,
            }
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(header) + "\n")
                    f.write(json.dumps({"fault": {"kind": kind, **facts}}) +
                            "\n")
                    for entry in ring:
                        f.write(json.dumps(entry) + "\n")
            self.dumps += 1
            self.last_fault = {"kind": kind, **facts}
        return header

    def entries(self):
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


def load_flight(path: str):
    """A flight-recorder JSONL file as a list of dumps, ``[{"header": ...,
    "fault": ..., "requests": [...]}, ...]``; lines before a header that
    are not part of a dump are skipped."""
    dumps = []
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        ln = lines[i]
        if not isinstance(ln, dict) or "flight_dump" not in ln:
            i += 1
            continue
        header = ln
        fault = None
        i += 1
        if i < len(lines) and isinstance(lines[i], dict) \
                and "fault" in lines[i]:
            fault = lines[i]["fault"]
            i += 1
        n = int(header.get("entries", 0))
        requests = lines[i:i + n]
        i += n
        dumps.append({"header": header, "fault": fault,
                      "requests": requests})
    return dumps
