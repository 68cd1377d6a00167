"""Serving metrics: the subset of ``repro.serve.metrics`` that the two
engines, the CLI and ``launch/trace_report`` read, streaming snapshots
included.

Definitions (the JAX package's):

* **TTFT**        — arrival to first emitted token (includes queueing).
* **occupancy**   — live-slot-seconds / (slots x decode time).
* **goodput**     — tokens of *completed* requests per second of wall.
* **wall_source** — ``"measured"`` when the engine stamped
  ``record_wall``, else ``"decode_time"`` (an upper bound on throughput),
  or ``"none"``.
* **spec_accept_rate** — draft tokens the verify stream confirmed over
  draft tokens; **spec_tokens_per_verify** — tokens emitted per live row
  per verify call (a verify call counts as one decode step).
* **prefix_hits / misses / hit_tokens** — admissions that restored a
  cached prefix snapshot, those that did not, and the prompt tokens the
  hits skipped.

Latencies go into a log-bucketed :class:`StreamingHistogram` (constant
memory, percentiles interpolated within a bucket).  Under
``metrics_every`` per-poll gauges and emitted tokens go into sliding
time windows (:class:`WindowedGauge`, :class:`RateMeter`, O(1) a sample
and a reading), and every ``metrics_every`` polls ``maybe_snapshot``
appends a point-in-time snapshot to ``snapshots`` and, when tracing,
emits the ``serve_gauges`` counter sample and a ``metrics_snapshot``
instant; with ``metrics_every`` 0 nothing reads the windows and nothing
fills them (the JAX engine fills them on every poll).

The robustness counters are the JAX package's, under its names in
``summary()`` and the snapshots: ``rejected`` (the bounded queue refused a
submit), ``quarantined`` and ``poison_probes``, ``watchdog_fires``,
``watchdog_recoveries`` and ``retries``, ``overload_entries`` /
``overload_exits``, ``stragglers`` by program, and ``shed_reasons``, which
sums to ``shed``.  ``backend_fallbacks`` keeps its key and reads 0: the
port has no backend fallback.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.serve.tracing import NULL_TRACER

# The windowed gauges' and the token rate's trailing window (the JAX
# package's default).
GAUGE_WINDOW_S = 10.0


def _percentile(xs: List[float], q: float) -> float:
    """Linear-interpolation percentile of a list (numpy ``quantile``
    semantics)."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    pos = q * (len(ys) - 1)
    lo = int(math.floor(pos))
    hi = min(len(ys) - 1, lo + 1)
    frac = pos - lo
    return ys[lo] * (1.0 - frac) + ys[hi] * frac


class StreamingHistogram:
    """Log-bucketed streaming histogram for positive samples (a copy of
    the JAX package's): ``bins_per_decade`` geometric buckets between
    ``lo`` and ``hi``; exact count/mean/min/max."""

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 bins_per_decade: int = 32):
        self.lo = lo
        self.hi = hi
        self.bpd = bins_per_decade
        self._log_lo = math.log10(lo)
        self.nbins = int(math.ceil((math.log10(hi) - self._log_lo)
                                   * bins_per_decade)) + 1
        self.counts = [0] * self.nbins
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._summary = (0, None)       # (count, summary) of the last read

    def _bucket(self, x: float) -> int:
        if x <= self.lo:
            return 0
        if x >= self.hi:
            return self.nbins - 1
        return int((math.log10(x) - self._log_lo) * self.bpd)

    def add(self, x: float) -> None:
        self.counts[self._bucket(x)] += 1
        self.count += 1
        self.total += x
        self.vmin = min(self.vmin, x)
        self.vmax = max(self.vmax, x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Rank ``q * (count - 1)`` interpolated geometrically inside its
        bucket, clamped to the observed min/max."""
        return self.percentiles((q,))[0]

    def percentiles(self, qs: Sequence[float]) -> List[float]:
        """:meth:`percentile` of each of ``qs``, in one walk over the
        buckets between the min's and the max's, the only ones that can
        hold a sample (a snapshot reads four of each of three
        histograms)."""
        if not self.count:
            return [0.0] * len(qs)
        if self.count == 1:
            return [self.vmin] * len(qs)
        ranks = sorted((q * (self.count - 1), i) for i, q in enumerate(qs))
        out = [self.vmax] * len(qs)
        j, cum, m = 0, 0, len(ranks)
        counts = self.counts
        for b in range(self._bucket(self.vmin), self._bucket(self.vmax) + 1):
            n = counts[b]
            if not n:
                continue
            while j < m and ranks[j][0] < cum + n:
                rank, i = ranks[j]
                frac = (rank - cum + 0.5) / n
                lo_edge = 10.0 ** (self._log_lo + b / self.bpd)
                v = lo_edge * 10.0 ** (frac / self.bpd)
                out[i] = min(max(v, self.vmin), self.vmax)
                j += 1
            if j == m:
                break
            cum += n
        return out

    def summary(self) -> Dict[str, float]:
        """Count, mean, min, max and four percentiles; kept until the next
        sample (a snapshot reads three histograms, most of them
        unchanged since the last one)."""
        count, kept = self._summary
        if kept is None or count != self.count:
            p50, p90, p95, p99 = self.percentiles((0.50, 0.90, 0.95, 0.99))
            kept = {"count": self.count, "mean": self.mean,
                    "min": self.vmin if self.count else 0.0,
                    "max": self.vmax if self.count else 0.0,
                    "p50": p50, "p90": p90, "p95": p95, "p99": p99}
            self._summary = (self.count, kept)
        return dict(kept)


class WindowedGauge:
    """Sliding-time-window gauge: last / windowed mean / windowed max of a
    sampled value (queue depth, live slots, resident bytes, ...).

    The JAX package's readings at O(1) a sample: a running sum, from
    which expired points are taken as they leave the window, and a
    monotonic deque whose front is the window's max, so a snapshot costs
    the same with one sample in the window or a full server's thousands.
    The mean equals the JAX package's ``sum(window) / n`` exactly for
    integer samples (every gauge the engines observe: counts and bytes);
    float samples may part from it in the last bits."""

    def __init__(self, window_s: float = GAUGE_WINDOW_S):
        self.window_s = window_s
        self._pts: deque = deque()      # (t, value)
        self._top: deque = deque()      # (t, value), values decreasing
        self._sum = 0
        self.last = 0.0

    def record(self, value: float, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        self.last = value
        self._pts.append((now, value))
        self._sum += value
        top = self._top
        while top and top[-1][1] <= value:
            top.pop()
        top.append((now, value))
        self._trim(now)

    def _trim(self, now: float) -> None:
        cut = now - self.window_s
        pts, top = self._pts, self._top
        while pts and pts[0][0] < cut:
            self._sum -= pts.popleft()[1]
        while top and top[0][0] < cut:
            top.popleft()
        if not pts:
            self._sum = 0

    def snapshot(self, now: Optional[float] = None) -> Dict[str, float]:
        now = time.perf_counter() if now is None else now
        self._trim(now)
        n = len(self._pts)
        if not n:
            return {"last": self.last, "mean": self.last,
                    "max": self.last, "n": 0}
        return {"last": self.last, "mean": self._sum / n,
                "max": self._top[0][1], "n": n}


class RateMeter:
    """Sliding-window event rate (tokens/s) over the trailing
    ``window_s`` seconds; a running count, so a reading is O(1)."""

    def __init__(self, window_s: float = GAUGE_WINDOW_S):
        self.window_s = window_s
        self._pts: deque = deque()      # (t, n)
        self._sum = 0

    def record(self, n: int = 1, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        self._pts.append((now, n))
        self._sum += n
        self._trim(now)

    def _trim(self, now: float) -> None:
        cut = now - self.window_s
        pts = self._pts
        while pts and pts[0][0] < cut:
            self._sum -= pts.popleft()[1]
        if not pts:
            self._sum = 0

    def rate(self, now: Optional[float] = None) -> float:
        now = time.perf_counter() if now is None else now
        self._trim(now)
        if not self._pts:
            return 0.0
        span = max(now - self._pts[0][0], 1e-9)
        return self._sum / span


class ServeMetrics:
    def __init__(self, slots: int, tracer=NULL_TRACER,
                 metrics_every: int = 0):
        self.slots = max(1, slots)
        self.tracer = tracer
        self.metrics_every = metrics_every
        self.reset()

    def reset(self) -> None:
        self.arrivals = 0
        self.completed = 0
        self.shed = 0
        # Shed breakdown (sums to ``shed``): deadline | overload | poison |
        # retry_exhausted.
        self.shed_reasons: Dict[str, int] = {}
        self.rejected = 0           # submit() refused: the queue was full
        self.quarantined = 0        # slots reset after a poison probe hit
        self.poison_probes = 0      # probe passes run
        # The JAX engine's decode-mode fallbacks; the port has none (a
        # failed kernel raises), so this stays 0.
        self.backend_fallbacks = 0
        self.watchdog_recoveries = 0
        self.retries = 0            # requests requeued by recovery
        self.overload_entries = 0
        self.overload_exits = 0
        self.stragglers = {"decode": 0, "prefill": 0}
        self.watchdog_fires = 0
        self.truncated = 0
        self.emitted_tokens = 0
        self.completed_tokens = 0
        self.ttft = StreamingHistogram()
        self.latency = StreamingHistogram()
        self.step_hist = StreamingHistogram()
        self.prefill_hist = StreamingHistogram()
        self.decode_steps = 0
        self.decode_time_s = 0.0
        self.live_slot_s = 0.0
        self.wall_s = 0.0
        self.logit_rows = 0
        self.nonfinite_logit_rows = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.prefill_time_s = 0.0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.spec_bursts = 0
        self.spec_rows = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.spec_rollbacks = 0
        self.polls = 0
        self.gauges: Dict[str, WindowedGauge] = {}
        self.tok_rate = RateMeter()
        self.snapshots: List[dict] = []

    def record_arrival(self) -> None:
        self.arrivals += 1

    def record_first_token(self, ttft_s: float) -> None:
        self.ttft.add(ttft_s)

    def record_token(self, n: int = 1) -> None:
        self.emitted_tokens += n
        if self.metrics_every:
            self.tok_rate.record(n)

    def record_finish(self, latency_s: float, n_tokens: int) -> None:
        self.completed += 1
        self.completed_tokens += n_tokens
        self.latency.add(latency_s)

    def record_shed(self, reason: str = "deadline") -> None:
        """One shed request; ``shed_reasons`` counts them by reason."""
        self.shed += 1
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1

    def record_reject(self) -> None:
        """submit() refused a request (the bounded admission queue)."""
        self.rejected += 1

    def record_quarantine(self) -> None:
        """A poison probe hit: one slot reset, its request shed."""
        self.quarantined += 1

    def record_poison_probe(self) -> None:
        self.poison_probes += 1

    def record_watchdog_recovery(self, requeued: int) -> None:
        self.watchdog_recoveries += 1
        self.retries += requeued

    def record_overload(self, entered: bool) -> None:
        if entered:
            self.overload_entries += 1
        else:
            self.overload_exits += 1

    def record_straggler(self, kind: str) -> None:
        """A step monitor flagged one call of ``kind`` as a straggler."""
        self.stragglers[kind] = self.stragglers.get(kind, 0) + 1

    def record_step(self, live_slots: int, dt_s: float) -> None:
        """One decode step: ``live_slots`` rows produced useful tokens."""
        self.decode_steps += 1
        self.decode_time_s += dt_s
        self.live_slot_s += live_slots * dt_s
        self.step_hist.add(dt_s)

    def record_prefill(self, tokens: int, dt_s: float) -> None:
        """One prefill call (a monolithic bucket or one chunk) that
        consumed ``tokens`` prompt tokens (pad included) in ``dt_s``."""
        self.prefill_chunks += 1
        self.prefill_tokens += tokens
        self.prefill_time_s += dt_s
        self.prefill_hist.add(dt_s)

    def record_prefix_lookup(self, matched_tokens: int) -> None:
        """One prefix-cache admission lookup: ``matched_tokens`` prompt
        tokens were skipped by restoring a cached snapshot (0 = miss)."""
        if matched_tokens > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += matched_tokens
        else:
            self.prefix_misses += 1

    def record_speculative(self, rows: int, drafted: int, accepted: int,
                           emitted: int, rollbacks: int) -> None:
        """One speculative draft / verify burst (``serve/speculative.py``)
        across ``rows`` live slots: ``drafted`` draft tokens, ``accepted``
        of them confirmed by the verify stream, ``emitted`` tokens that
        entered request outputs (accepted + up to one correction a row),
        ``rollbacks`` rows restored to their pre-burst state."""
        self.spec_bursts += 1
        self.spec_rows += rows
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_emitted += emitted
        self.spec_rollbacks += rollbacks

    def record_wall(self, dt_s: float) -> None:
        self.wall_s += dt_s

    def record_logits(self, rows: int, nonfinite_rows: int) -> None:
        """One sampled batch of ``rows`` logit rows, ``nonfinite_rows`` of
        them holding a NaN or an Inf."""
        self.logit_rows += rows
        self.nonfinite_logit_rows += nonfinite_rows

    def observe_gauges(self, **values: float) -> None:
        """Per-poll gauge samples from the engine (queue depth, staging
        depth, live slots, prefix-cache resident bytes); kept only under
        ``metrics_every``, whose snapshots are their one reader."""
        if not self.metrics_every:
            return
        now = time.perf_counter()
        for key, v in values.items():
            g = self.gauges.get(key)
            if g is None:
                g = self.gauges[key] = WindowedGauge()
            g.record(v, now)

    def maybe_snapshot(self,
                       extra_fn: Optional[Callable[[], dict]] = None) -> None:
        """Count one engine poll; every ``metrics_every`` polls (0 = off)
        take a snapshot: appended to ``snapshots`` and, when tracing,
        emitted as a ``serve_gauges`` counter sample plus a
        ``metrics_snapshot`` instant carrying the whole snapshot."""
        self.polls += 1
        if not self.metrics_every or self.polls % self.metrics_every:
            return
        snap = self.snapshot()
        if extra_fn is not None:
            snap.update(extra_fn())
        self.snapshots.append(snap)
        if self.tracer.enabled:
            gauges = snap["gauges"]
            self.tracer.counter("serve_gauges", {
                "queue_depth": gauges.get("queue_depth", {}).get("last",
                                                                 0.0),
                "staging_depth": gauges.get("staging_depth",
                                            {}).get("last", 0.0),
                "live_slots": gauges.get("live_slots", {}).get("last", 0.0),
                "tokens_per_s": snap["tokens_per_s_window"],
                "prefix_resident_mb": gauges.get(
                    "prefix_resident_bytes", {}).get("last", 0.0) / 2 ** 20,
            })
            self.tracer.instant("metrics_snapshot", **snap)

    def snapshot(self) -> dict:
        """Point-in-time view: cumulative counters, windowed gauges and
        histogram quick stats."""
        return {
            "polls": self.polls,
            "arrivals": self.arrivals,
            "completed": self.completed,
            "shed": self.shed,
            "shed_reasons": dict(self.shed_reasons),
            "rejected": self.rejected,
            "quarantined": self.quarantined,
            "backend_fallbacks": self.backend_fallbacks,
            "watchdog_recoveries": self.watchdog_recoveries,
            "emitted_tokens": self.emitted_tokens,
            "tokens_per_s_window": self.tok_rate.rate(),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "spec_bursts": self.spec_bursts,
            "spec_accept_rate": (self.spec_accepted / self.spec_drafted
                                 if self.spec_drafted else 0.0),
            "stragglers": dict(self.stragglers),
            "watchdog_fires": self.watchdog_fires,
            "ttft": self.ttft.summary(),
            "decode_step": self.step_hist.summary(),
            "prefill_call": self.prefill_hist.summary(),
            "gauges": {k: g.snapshot() for k, g in self.gauges.items()},
        }

    def summary(self) -> Dict[str, float]:
        """Cumulative KPI rollup (keys as the JAX package's summary)."""
        wall = self.wall_s or self.decode_time_s
        wall_source = ("measured" if self.wall_s else
                       "decode_time" if self.decode_time_s else "none")
        return {
            "requests": self.arrivals,
            "completed": self.completed,
            "shed": self.shed,
            "shed_reasons": dict(self.shed_reasons),
            "rejected": self.rejected,
            "quarantined": self.quarantined,
            "poison_probes": self.poison_probes,
            "backend_fallbacks": self.backend_fallbacks,
            "watchdog_recoveries": self.watchdog_recoveries,
            "retries": self.retries,
            "overload_entries": self.overload_entries,
            "overload_exits": self.overload_exits,
            "truncated": self.truncated,
            "generated_tokens": self.emitted_tokens,
            "tokens_per_s": self.emitted_tokens / wall if wall else 0.0,
            "goodput_tokens_per_s":
                self.completed_tokens / wall if wall else 0.0,
            "ttft_mean_s": self.ttft.mean,
            "ttft_p50_s": self.ttft.percentile(0.50),
            "ttft_p99_s": self.ttft.percentile(0.99),
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "prefill_time_s": self.prefill_time_s,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "spec_bursts": self.spec_bursts,
            "spec_drafted_tokens": self.spec_drafted,
            "spec_accept_rate": (self.spec_accepted / self.spec_drafted
                                 if self.spec_drafted else 0.0),
            "spec_tokens_per_verify": (self.spec_emitted / self.spec_rows
                                       if self.spec_rows else 0.0),
            "spec_rollbacks": self.spec_rollbacks,
            "latency_mean_s": self.latency.mean,
            "decode_steps": self.decode_steps,
            "token_latency_s": (self.decode_time_s / self.decode_steps
                                if self.decode_steps else 0.0),
            "slot_occupancy": (self.live_slot_s /
                               (self.slots * self.decode_time_s)
                               if self.decode_time_s else 0.0),
            "logit_rows": self.logit_rows,
            "nonfinite_logit_rows": self.nonfinite_logit_rows,
            "stragglers_decode": self.stragglers.get("decode", 0),
            "stragglers_prefill": self.stragglers.get("prefill", 0),
            "watchdog_fires": self.watchdog_fires,
            "wall_s": wall,
            "wall_source": wall_source,
        }
