"""Request admission: queue policy, priorities, deadlines, bucketing.

Port of ``repro.serve.scheduler`` (without the tracer hooks): FCFS or
priority ordering, deadline-based load shedding, the prompt ->
prefill-bucket mapping with explicit truncation accounting, and the
chunked prefill's padded span (``chunk_span``).
"""
from __future__ import annotations

import dataclasses
import heapq
import logging
import time
from typing import Callable, List, Optional, Sequence, Tuple

log = logging.getLogger("repro_torch.serve")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    latency_s: float = 0.0        # arrival -> completion (wall)
    truncated: bool = False       # prompt exceeded the largest prefill bucket
    priority: int = 0             # lower = served sooner (priority policy)
    deadline_s: Optional[float] = None   # absolute time.time() admission SLA
    expired: bool = False         # shed: deadline passed while queued
    bucket: int = 0               # prefill bucket chosen at admission
    status: str = "ok"
    arrival_s: float = 0.0
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    on_token: Optional[Callable[[int, int], None]] = None  # (uid, token)

    def emit(self, token: int) -> None:
        self.out_tokens.append(token)
        if self.on_token is not None:
            self.on_token(self.uid, token)


def bucket_for(buckets: Sequence[int], length: int) -> Tuple[int, bool]:
    """Smallest configured bucket that fits ``length``; ``truncated`` is
    True when the prompt is longer than the largest bucket."""
    for b in buckets:
        if length <= b:
            return b, False
    return buckets[-1], True


def chunk_span(buckets: Sequence[int], chunk: int, length: int) -> int:
    """Padded prefill length under chunked prefill: the prompt (capped at
    the largest bucket, the monolithic path's truncation rule) left-pads
    to the next ``chunk`` multiple, at least one chunk, so an empty or
    short prompt still gives a first token."""
    capped = min(max(length, 1), buckets[-1])
    return -(-capped // chunk) * chunk


def flag_truncation(req: Request, buckets: Sequence[int]) -> None:
    """Mark (and warn about) a prompt that overflows the largest bucket."""
    bucket, truncated = bucket_for(buckets, len(req.prompt))
    if truncated:
        req.truncated = True
        log.warning(
            "request %d: prompt length %d exceeds largest prefill bucket "
            "%d; truncating to the last %d tokens", req.uid,
            len(req.prompt), bucket, bucket)


def build_request(uid: int, prompt: Sequence[int], max_new_tokens: int, *,
                  priority: int = 0, deadline_s: Optional[float] = None,
                  on_token=None, buckets: Sequence[int] = (),
                  metrics=None) -> Request:
    """Submit-time bookkeeping: construct the Request, flag (and warn
    about) truncation, and stamp arrival metrics."""
    req = Request(uid=uid, prompt=list(prompt),
                  max_new_tokens=max_new_tokens, priority=priority,
                  deadline_s=deadline_s, arrival_s=time.time(),
                  on_token=on_token)
    if buckets:
        flag_truncation(req, buckets)
    if metrics is not None:
        metrics.record_arrival()
        if req.truncated:
            metrics.truncated += 1
    return req


class Scheduler:
    """Admission queue: ``fcfs`` (arrival order) or ``priority`` (lower
    ``Request.priority`` first, FCFS within a level).  Requests whose
    absolute ``deadline_s`` passed while queued are shed into
    ``self.expired`` instead of taking a slot."""

    def __init__(self, policy: str = "fcfs"):
        if policy not in ("fcfs", "priority"):
            raise ValueError(f"unknown scheduler policy {policy!r}")
        self.policy = policy
        self._heap: List[Tuple[Tuple[int, int], Request]] = []
        self._seq = 0
        self.expired: List[Request] = []

    def __len__(self) -> int:
        return len(self._heap)

    def submit(self, req: Request) -> None:
        self._seq += 1
        level = req.priority if self.policy == "priority" else 0
        heapq.heappush(self._heap, ((level, self._seq), req))

    def pop_ready(self, now: float) -> Optional[Request]:
        """Next admissible request, shedding any whose deadline passed."""
        while self._heap:
            _, req = heapq.heappop(self._heap)
            if req.deadline_s is not None and now > req.deadline_s:
                req.expired = True
                req.done = True
                req.status = "shed_deadline"
                self.expired.append(req)
                log.warning("request %d: deadline missed while queued; "
                            "shedding", req.uid)
                continue
            return req
        return None
