"""Wave-mode serving engine (port of ``repro.serve.engine``'s ``Engine``).

Requests are grouped into fixed-size batches that prefill together
(bucketed, left-padded with ``pad_id``) and decode in lockstep; EOS'd
rows keep decoding into a sink but stop being reported.  Left-padding
keeps every live request of a wave at the same position.

The model runs on its own device; the engine moves token ids there and
logits back to the host for sampling (``serve/sampling.py``, numpy), so
greedy outputs are those of the JAX engine on the same weights.  The
continuous engine (``serve/continuous.py``) shares :class:`EngineBase`.

Observability (the JAX package's, ``serve/tracing.py``): with
``ServeConfig.trace`` the engines record spans (the wave engine's
``poll``, ``prefill_bucket`` and ``decode_step``, each request's
``queue``, ``staging`` and ``decode``) into ``engine.tracer``;
``metrics_every`` takes a metrics snapshot every N polls (waves); the
model calls go through :class:`~repro_torch.serve.tracing.TracedProgram`
wrappers whose recompile sentinels are checked after every poll and
re-armed by ``reset_stats()``, and ``strict_recompile`` makes a trip
raise.  The programs record call signatures only when tracing or under
``strict_recompile``; otherwise the sentinels are inert and count no
trips.  Spans around a model call close after the host sync that
sampling takes anyway (the logits' copy to the host); tracing adds no
sync.

Robustness (the JAX package's ``ServeConfig`` fields and defaults):
``max_queue_depth`` bounds admission in both engines (``submit`` returns
None and counts a ``reject``); the fault plan, poison probes, step
monitors, the watchdog and its recovery with retries, overload and
in-flight shedding and the flight recorder act in the continuous engine
(``serve/continuous.py``).  The one difference kept: there is no
``backend_fallback``; a failed kernel launch raises out of the engine.

Whisper (an encoder-decoder whose calls take frames beside the tokens)
is not served by these token-only engines, in the JAX package either:
both engines, and ``launch/serve``, refuse it before any work
(:func:`require_servable`).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.serve import sampling
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.program_registry import ProgramRegistry
from repro_torch.serve.scheduler import (Request, Scheduler, bucket_for,
                                         build_request)
from repro_torch.serve.state_pool import StatePool
from repro_torch.serve.tracing import (NULL_TRACER, TID_QUEUE, TID_SLOT0,
                                       RecompileSentinel, TracedProgram,
                                       Tracer)

log = logging.getLogger("repro_torch.serve")


@dataclasses.dataclass
class ServeConfig:
    """The JAX package's ``ServeConfig`` fields, with its defaults, but
    ``backend_fallback`` (passing it is a ``TypeError``): the port does
    not give way to plainer code when a kernel fails; the launch raises."""

    max_batch: int = 8
    prefill_buckets: Sequence[int] = (32, 128, 512)
    max_new_tokens: int = 32
    eos_id: int = -1            # -1: never stops early
    pad_id: int = 0
    temperature: float = 0.0    # 0 => greedy
    seed: int = 0
    policy: str = "fcfs"        # admission order: fcfs | priority
    # -- chunked prefill (continuous engine only; the wave engine ignores
    # both) -------------------------------------------------------------
    # Chunk size in tokens: prompts left-pad to a chunk multiple and
    # prefill one chunk call per poll, interleaved with the decode step.
    # None keeps the monolithic bucketed prefill.
    prefill_chunk: Optional[int] = None
    # Prompt tokens per poll, counted as chunk per prefilling slot per
    # chunk call; 0 = exactly one chunk call per poll.
    prefill_token_budget: int = 0
    # -- prefix-state cache (continuous engine, needs prefill_chunk) --------
    # Byte budget (MB) for cross-request reuse of chunk-boundary state
    # snapshots: admissions skip past any cached prompt prefix
    # (``serve/prefix_cache.py``; the snapshots stay on the model's
    # device).  0 disables.
    prefix_cache_mb: float = 0.0
    # Snapshot granularity in tokens: a multiple of prefill_chunk; None
    # means one snapshot per prefill chunk.  Coarser grains store fewer,
    # larger entries (less snapshot overhead, less sharing resolution).
    prefix_chunk: Optional[int] = None
    # -- self-speculative decoding (continuous engine only) -----------------
    # Draft this many tokens per burst with the cheap draft params (a W8
    # quantization of the serve params unless the engine is given its
    # own), verify them in ONE batched full-precision verify_chunk call,
    # emit the longest verified prefix + one correction token, and restore
    # mismatching rows from their pre-burst state.  Outputs are those of
    # the non-speculative path up to rounding (sampled ones too: the
    # continuous engine keys sampling noise on (seed, uid, position),
    # ``serve/sampling.py: sample_keyed``).  The verify window and the
    # decode step compute the same logits in different orders, so a pick
    # may part where the top two logits lie within their gap: at random
    # weights in bf16 that happens within a few tokens.  0 disables.  See
    # serve/speculative.py.
    speculate_k: int = 0
    # Quant mode for the derived draft params (``nn/quant.py``).
    speculate_draft: str = "w8"
    # -- observability (serve/tracing.py) -----------------------------------
    # Truthy enables span tracing: the engine records events in memory and
    # the caller saves them (``engine.tracer.save(path)``; launch/serve's
    # --trace PATH).  Falsy keeps the near-zero-overhead null tracer.
    trace: object = None
    # A metrics snapshot every N engine polls (0 = off): windowed gauges
    # and histogram quick stats into ``engine.metrics.snapshots`` and,
    # when tracing, the trace's counter track and event log.
    metrics_every: int = 0
    # Recompile sentinels raise RecompileError when a program meets a new
    # signature or builds a kernel after warmup, instead of counting.
    strict_recompile: bool = False
    # Deadline (seconds) of the continuous engine's hang watchdog: it
    # fires when no program call completes within it.  0 disables.
    watchdog_s: float = 0.0
    # -- fault tolerance (continuous engine) --------------------------------
    # Fault-injection plan: a FaultInjector, a spec string
    # (``runtime/faults.parse_plan``) or an iterable of FaultEvent.  None
    # serves with no injection hook on the path.
    fault_plan: object = None
    # Bounded admission queue: submit() refuses (returns None, counted in
    # metrics.rejected) once this many requests are queued.  0 =
    # unbounded.
    max_queue_depth: int = 0
    # Degraded overload mode: entered when the queue depth reaches
    # overload_queue_depth or TTFT p95 passes overload_ttft_p95_s (0
    # disables either trigger); while degraded the prefill token budget is
    # one chunk call a poll and speculative bursts pause.  Cleared when
    # the queue depth falls to overload_clear_frac * overload_queue_depth.
    overload_queue_depth: int = 0
    overload_ttft_p95_s: float = 0.0
    overload_clear_frac: float = 0.5
    # Poison quarantine probes: "off" | "logits" (the finiteness of the
    # step's host logits, which sampling takes anyway) | "state" (adds a
    # per-row finiteness reduction over the decode pool on the device).
    # A poisoned slot is reset and its request finished as "poisoned".
    poison_probe: str = "off"
    poison_check_every: int = 1   # probe every N polls
    # Watchdog escalation: "log" (metrics and a trace instant) or
    # "recover" (abort every in-flight request at the next poll and
    # requeue it, with bounded retries and exponential backoff).
    watchdog_action: str = "log"
    max_retries: int = 1
    retry_backoff_s: float = 0.0  # base of runtime/elastic.backoff_delay_s
    # Deadline shedding for requests in flight (staged or decoding), not
    # only queued ones.
    shed_inflight: bool = False
    # -- flight recorder (continuous engine; serve/flight_recorder.py) ------
    # Keep the last N finished-request timelines in a ring and dump them
    # (JSONL at flight_path) whenever a fault fires.  0 disables.
    flight_records: int = 0
    flight_path: Optional[str] = None


def require_servable(cfg) -> None:
    """Raise ``NotImplementedError`` for a family the token-only engines
    cannot serve: whisper, whose calls need its ``frames``."""
    if cfg.family == "whisper":
        raise NotImplementedError(
            f"{cfg.name}: the whisper family is not served by the "
            f"token-only engines (its prefill takes frames beside the "
            f"tokens); call its prefill / prefill_chunk / decode_step")


class EngineBase:
    """Plumbing the engines share: the model and params, the traced model
    programs, uid and sampling-step counters, submit-time bookkeeping,
    metrics, the tracer, the program registry and the recompile
    sentinels."""

    def __init__(self, model, params, cfg: ServeConfig):
        require_servable(model.cfg)
        self.model = model
        # Built once: every layer's kernel operands in fp32.
        self.params = model.decode_view(params)
        self.cfg = cfg
        self.device = model.device
        # Programs record call signatures only where something reads them.
        self._watch = bool(cfg.trace) or cfg.strict_recompile
        self._decode = TracedProgram("decode", model.decode_step,
                                     watch=self._watch)
        self._prefill = TracedProgram("prefill", model.prefill,
                                      watch=self._watch)
        self.tracer = Tracer() if cfg.trace else NULL_TRACER
        self._scheduler = Scheduler(cfg.policy, tracer=self.tracer)
        self._uid = 0
        self._step = 0              # sampling-rng step counter
        # Each row's finiteness in the last host logits, and the count of
        # non-finite rows (the poison probe reads both).
        self.rows_finite = np.ones(cfg.max_batch, bool)
        self.nonfinite_rows = 0
        self.metrics = ServeMetrics(cfg.max_batch, tracer=self.tracer,
                                    metrics_every=cfg.metrics_every)
        # Program ids ride in sentinels and spans; the wave engine
        # registers its programs by name only (its shapes vary by wave),
        # the continuous engine with its serve shapes.
        self.registry = ProgramRegistry()
        self.registry.register("decode", model.decode_step)
        self.registry.register("prefill", model.prefill)
        strict = cfg.strict_recompile
        self.sentinels = {
            name: RecompileSentinel(name, prog, strict=strict,
                                    program_id=self.registry.program_id(name))
            for name, prog in (("decode", self._decode),
                               ("prefill", self._prefill))}

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None, *,
               priority: int = 0, deadline_s: Optional[float] = None,
               on_token=None) -> Optional[int]:
        """Queue a request; returns its uid, or None when the bounded
        admission queue (``max_queue_depth``) is full: backpressure the
        caller must handle."""
        cap = self.cfg.max_queue_depth
        if cap and len(self._scheduler) >= cap:
            self.metrics.record_reject()
            self.tracer.instant("reject", queue_depth=len(self._scheduler))
            log.warning("admission queue full (%d): rejecting request", cap)
            return None
        self._uid += 1
        req = build_request(
            self._uid, prompt, max_new_tokens or self.cfg.max_new_tokens,
            priority=priority, deadline_s=deadline_s, on_token=on_token,
            buckets=self.cfg.prefill_buckets, metrics=self.metrics)
        self._scheduler.submit(req)
        return req.uid

    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        """Logits on the host as fp32 numpy, rows counted (non-finite
        ones apart) in the metrics; ``rows_finite`` and
        ``nonfinite_rows`` keep them for the poison probe."""
        host = logits.float().cpu().numpy()
        self.rows_finite = np.isfinite(host).all(axis=-1)
        self.nonfinite_rows = int((~self.rows_finite).sum())
        self.metrics.record_logits(host.shape[0], self.nonfinite_rows)
        return host

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        out = sampling.sample(self._host_logits(logits),
                              self.cfg.temperature,
                              sampling.step_rng(self.cfg.seed, self._step))
        self._step += 1
        return out

    def _sample_rows(self, logits, uids: Sequence[int],
                     positions: Sequence[int]) -> np.ndarray:
        """Keyed sampling (continuous engine): a row's noise is a function
        of ``(seed, uid, position)`` alone (``sampling.sample_keyed``).
        ``logits`` is a tensor, or host logits that ``_host_logits``
        already took."""
        if isinstance(logits, torch.Tensor):
            logits = self._host_logits(logits)
        return sampling.sample_keyed(logits, self.cfg.temperature,
                                     self.cfg.seed, uids, positions)

    @property
    def counters(self) -> dict:
        """Each sentinel's program's distinct signatures, the kernel
        libraries loaded in this process, and the sentinels' trips."""
        return {**{f"{name}_signatures": len(s._fn.signatures)
                   for name, s in self.sentinels.items()},
                "kernel_libraries": build.loaded(),
                "recompile_trips":
                {name: s.trips for name, s in self.sentinels.items()}}

    def check_sentinels(self) -> None:
        """Run every recompile sentinel (a set-size read each); nothing
        when the programs are not watched (the sentinels are inert)."""
        if not self._watch:
            return
        for s in self.sentinels.values():
            s.check(self.tracer)

    @property
    def expired(self) -> List[Request]:
        """Requests shed because their deadline passed while queued."""
        return self._scheduler.expired

    def reset_stats(self) -> None:
        """Drop accumulated metrics and trace events and re-arm the
        recompile sentinels (e.g. after a warmup run): what is observed
        afterwards is post-warmup."""
        self.metrics.reset()
        self.tracer.reset()
        for s in self.sentinels.values():
            s.arm()

    def close(self) -> None:
        """Release background resources (the continuous engine's watchdog
        thread); the engine stays readable afterwards."""


class Engine(EngineBase):
    def __init__(self, model, params, cfg: ServeConfig):
        super().__init__(model, params, cfg)
        self._wall_s = 0.0          # summed sequential wave wall time

    def reset_stats(self) -> None:
        self._wall_s = 0.0
        super().reset_stats()

    def run(self) -> List[Request]:
        """Serve everything in the queue; returns completed requests."""
        done: List[Request] = []
        with torch.inference_mode():
            while len(self._scheduler):
                wave: List[Request] = []
                now = time.time()
                n_shed0 = len(self._scheduler.expired)
                while len(wave) < self.cfg.max_batch and \
                        len(self._scheduler):
                    req = self._scheduler.pop_ready(now)
                    if req is None:
                        break
                    req.admit_pc = time.perf_counter()
                    if self.tracer.enabled:
                        self.tracer.complete(
                            "queue",
                            self.tracer.pc_from_walltime(req.arrival_s),
                            req.admit_pc, tid=TID_QUEUE, uid=req.uid)
                    wave.append(req)
                for _ in range(len(self._scheduler.expired) - n_shed0):
                    self.metrics.record_shed()
                if wave:
                    done.extend(self._run_wave(wave))
        return done

    def _run_wave(self, wave: List[Request]) -> List[Request]:
        cfg = self.cfg
        t0 = time.time()
        wave_span = self.tracer.span("poll", requests=len(wave))
        wave_span.__enter__()
        b = cfg.max_batch
        bucket = bucket_for(cfg.prefill_buckets,
                            max(len(r.prompt) for r in wave))[0]
        max_new = max(r.max_new_tokens for r in wave)

        # Left-pad prompts into the bucket (static shape).
        tokens = np.full((b, bucket), cfg.pad_id, np.int64)
        for i, r in enumerate(wave):
            r.bucket = bucket
            p = r.prompt[-bucket:]
            tokens[i, bucket - len(p):] = p

        pool = StatePool(self.model, b,
                         bucket + max(cfg.max_new_tokens, max_new),
                         self.model.cfg.dtype)
        with self.tracer.span("prefill_bucket", bucket=bucket,
                              rows=len(wave)):
            logits, cache = self._prefill(
                self.params,
                {"tokens": torch.from_numpy(tokens).to(self.device)},
                pool.cache)
            next_tok = self._sample(logits)

        def finish(r: Request, slot: int) -> None:
            r.done = True
            r.finish_s = time.time()
            r.latency_s = r.finish_s - r.arrival_s
            self.metrics.record_finish(r.latency_s, len(r.out_tokens))
            if self.tracer.enabled and r.decode_pc is not None:
                self.tracer.complete("decode", r.decode_pc,
                                     time.perf_counter(),
                                     tid=TID_SLOT0 + slot, uid=r.uid,
                                     tokens=len(r.out_tokens))

        alive = np.array([True] * len(wave) + [False] * (b - len(wave)))
        t_first = time.time()
        t_first_pc = time.perf_counter()
        for i, r in enumerate(wave):
            r.first_token_s = t_first
            r.decode_pc = t_first_pc
            self.metrics.record_first_token(t_first - r.arrival_s)
            self.metrics.record_token()
            if self.tracer.enabled and r.admit_pc is not None:
                self.tracer.complete("staging", r.admit_pc, t_first_pc,
                                     tid=TID_SLOT0 + i, uid=r.uid)
            r.emit(int(next_tok[i]))
            if (cfg.eos_id >= 0 and next_tok[i] == cfg.eos_id) or \
                    r.max_new_tokens == 1:
                alive[i] = False
                finish(r, i)

        for t in range(1, max_new):
            if not alive[:len(wave)].any():
                break
            ts0 = time.perf_counter()
            tok = torch.from_numpy(next_tok[:, None].astype(np.int64))
            logits, cache = self._decode(
                self.params, tok.to(self.device), cache, bucket + t - 1)
            next_tok = self._sample(logits)
            ts1 = time.perf_counter()
            self.tracer.complete("decode_step", ts0, ts1,
                                 live=int(alive[:len(wave)].sum()))
            self.metrics.record_step(int(alive[:len(wave)].sum()), ts1 - ts0)
            for i, r in enumerate(wave):
                if alive[i] and len(r.out_tokens) < r.max_new_tokens:
                    r.emit(int(next_tok[i]))
                    self.metrics.record_token()
                    if (cfg.eos_id >= 0 and next_tok[i] == cfg.eos_id) or \
                            len(r.out_tokens) >= r.max_new_tokens:
                        alive[i] = False
                        finish(r, i)

        for i, r in enumerate(wave):
            if not r.done:
                finish(r, i)
        dt = time.time() - t0
        self._wall_s += dt
        self.metrics.record_wall(dt)
        wave_span.__exit__(None, None, None)
        self.check_sentinels()
        self.metrics.maybe_snapshot()
        return wave

    def stats(self, requests: List[Request]) -> Dict[str, float]:
        """Throughput over the summed sequential wave time, and the
        recompile sentinels' trips."""
        toks = sum(len(r.out_tokens) for r in requests)
        wall = self._wall_s or (max((r.latency_s for r in requests),
                                    default=0.0))
        return {"requests": len(requests), "generated_tokens": toks,
                "tokens_per_s": toks / wall if wall else 0.0,
                "wall_s": wall,
                "recompile_trips": self.counters["recompile_trips"]}
