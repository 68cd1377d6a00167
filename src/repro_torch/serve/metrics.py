"""Serving metrics: the subset of ``repro.serve.metrics`` that the two
engines and the CLI read.

Definitions (the JAX package's):

* **TTFT**        — arrival to first emitted token (includes queueing).
* **occupancy**   — live-slot-seconds / (slots x decode time).
* **goodput**     — tokens of *completed* requests per second of wall.
* **wall_source** — ``"measured"`` when the engine stamped
  ``record_wall``, else ``"decode_time"`` (an upper bound on throughput),
  or ``"none"``.

Latencies go into a log-bucketed :class:`StreamingHistogram` (constant
memory, percentiles interpolated within a bucket).
"""
from __future__ import annotations

import math
from typing import Dict


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
        if not self.count:
            return 0.0
        if self.count == 1:
            return self.vmin
        rank = q * (self.count - 1)
        cum = 0
        for b, n in enumerate(self.counts):
            if not n:
                continue
            if rank < cum + n:
                frac = (rank - cum + 0.5) / n
                lo_edge = 10.0 ** (self._log_lo + b / self.bpd)
                v = lo_edge * 10.0 ** (frac / self.bpd)
                return min(max(v, self.vmin), self.vmax)
            cum += n
        return self.vmax


class ServeMetrics:
    def __init__(self, slots: int):
        self.slots = max(1, slots)
        self.reset()

    def reset(self) -> None:
        self.arrivals = 0
        self.completed = 0
        self.shed = 0
        self.truncated = 0
        self.emitted_tokens = 0
        self.completed_tokens = 0
        self.ttft = StreamingHistogram()
        self.latency = StreamingHistogram()
        self.decode_steps = 0
        self.decode_time_s = 0.0
        self.live_slot_s = 0.0
        self.wall_s = 0.0
        self.logit_rows = 0
        self.nonfinite_logit_rows = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.prefill_time_s = 0.0

    def record_arrival(self) -> None:
        self.arrivals += 1

    def record_first_token(self, ttft_s: float) -> None:
        self.ttft.add(ttft_s)

    def record_token(self, n: int = 1) -> None:
        self.emitted_tokens += n

    def record_finish(self, latency_s: float, n_tokens: int) -> None:
        self.completed += 1
        self.completed_tokens += n_tokens
        self.latency.add(latency_s)

    def record_shed(self) -> None:
        self.shed += 1

    def record_step(self, live_slots: int, dt_s: float) -> None:
        """One decode step: ``live_slots`` rows produced useful tokens."""
        self.decode_steps += 1
        self.decode_time_s += dt_s
        self.live_slot_s += live_slots * dt_s

    def record_prefill(self, tokens: int, dt_s: float) -> None:
        """One prefill call (a monolithic bucket or one chunk) that
        consumed ``tokens`` prompt tokens (pad included) in ``dt_s``."""
        self.prefill_chunks += 1
        self.prefill_tokens += tokens
        self.prefill_time_s += dt_s

    def record_wall(self, dt_s: float) -> None:
        self.wall_s += dt_s

    def record_logits(self, rows: int, nonfinite_rows: int) -> None:
        """One sampled batch of ``rows`` logit rows, ``nonfinite_rows`` of
        them holding a NaN or an Inf."""
        self.logit_rows += rows
        self.nonfinite_logit_rows += nonfinite_rows

    def summary(self) -> Dict[str, float]:
        """Cumulative KPI rollup (keys as the JAX package's summary)."""
        wall = self.wall_s or self.decode_time_s
        wall_source = ("measured" if self.wall_s else
                       "decode_time" if self.decode_time_s else "none")
        return {
            "requests": self.arrivals,
            "completed": self.completed,
            "shed": self.shed,
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
            "latency_mean_s": self.latency.mean,
            "decode_steps": self.decode_steps,
            "token_latency_s": (self.decode_time_s / self.decode_steps
                                if self.decode_steps else 0.0),
            "slot_occupancy": (self.live_slot_s /
                               (self.slots * self.decode_time_s)
                               if self.decode_time_s else 0.0),
            "logit_rows": self.logit_rows,
            "nonfinite_logit_rows": self.nonfinite_logit_rows,
            "wall_s": wall,
            "wall_source": wall_source,
        }
