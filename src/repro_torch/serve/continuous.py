"""Continuous-batching engine: slot-level refill under static shapes (port
of the core of ``repro.serve.continuous``).

The engine keeps ``max_batch`` persistent slots in a
:class:`~repro_torch.serve.state_pool.StatePool`; the moment a slot's
request finishes (EOS or token budget), the next queued request is
admitted into it mid-decode.  Every call keeps the JAX engine's shapes:

* **decode** at ``(slots, 1)``: every slot steps each poll; dead slots
  keep decoding their last token into their own rows (their tokens are
  dropped), so each step runs the same shapes;
* **prefill**, monolithic: per bucket, always at batch ``slots`` (unused
  rows are padding), from a zeroed scratch cache; the request rows are
  copied into their slots;
* **prefill**, chunked (``ServeConfig.prefill_chunk``): admitted prompts
  left-pad to a chunk multiple (``chunk_span``) and advance one chunk
  call at ``(slots, chunk)`` per poll (or more, up to
  ``prefill_token_budget`` tokens) in a second pool; slot i stages in row
  i, so a request reserves its decode slot at admission.  A fully
  consumed row moves to the decode pool and its first token is sampled
  from the chunk's last logits.

* **speculative bursts** (``ServeConfig.speculate_k``): when no live row
  has tokens left to drain, a poll drafts ``k`` tokens per slot with the
  draft params (a W8 quantization of the serve params by default) on a
  scratch pool, verifies them in one ``verify_chunk`` call on the decode
  pool, emits each row's verified prefix plus one correction
  (``serve/speculative.py``) and restores rows that consumed a rejected
  draft from a pre-burst backup pool; their emitted tokens are then
  re-consumed one a poll by the ordinary decode step (the overflow
  drain);
* **prefix-state cache** (``ServeConfig.prefix_cache_mb``, chunked
  prefill only): an admission restores the longest cached chunk-boundary
  snapshot of its padded prompt into its staging row and resumes there
  (``serve/prefix_cache.py``); the staging rows' snapshots are inserted
  as they cross snapshot boundaries.

Tokens are sampled with noise keyed on ``(seed, uid, position)``
(``EngineBase._sample_rows``), so greedy and sampled outputs do not
depend on slot assignment or on the prefix cache, and on speculation only
through rounding: a verify window computes a decode step's logits in
another order, so a pick may part where the top two logits lie within
that gap (in bf16 at random weights, within a few tokens; in fp32 only at
near-ties).  Greedy outputs are those of the JAX ``ContinuousEngine`` on
the same weights, requests and options, up to the same rounding.

Observability (``serve/tracing.py``, the JAX engine's span names and
argument keys): with ``ServeConfig.trace`` every poll records ``poll``,
``host_gap``, ``admit``, ``prefix_lookup``, ``prefill_bucket`` /
``prefill_chunk``, ``decode_step`` or a burst's ``spec_copy``, ``draft``,
``verify`` and ``rollback``, the pools' row spans, and each request's
``queue``, ``staging`` and ``decode`` spans and ``finish`` instant; a
``prefill_chunk`` span closes once the chunk's logits are on the host,
``decode_step`` and ``verify`` once the logits reach the host for
sampling (the syncs the untraced engine takes too).  The programs
(``decode``, ``prefill``, ``prefill_chunk``, ``verify``, ``draft``,
``qmatmul`` and the decode pool's row ops) are registered in
``engine.registry`` under the JAX names, order and ids, and their
recompile sentinels are checked every poll (armed when tracing or under
``strict_recompile``, inert otherwise).

Fault tolerance (the JAX engine's, ``ServeConfig``'s robustness fields):
``fault_plan`` threads a :class:`~repro_torch.runtime.faults.FaultInjector`
through the polls (poison a live row, stall or fail a program call,
drop or corrupt a prefix snapshot); ``poison_probe`` quarantines a row
whose logits (the finiteness ``_host_logits`` takes anyway) or, in
``state`` mode, whose decode-pool state (one reduction a leaf on the
device) is non-finite, at the decode step, the staging rows' first-token
logits and the speculative verify; step monitors time each program call
up to its logits' arrival on the host (so a call's seconds include the
device's work, and a hung device is seen at that sync) and pet a
watchdog thread, which only sets flags, counts and writes the flight
dump; under ``watchdog_action="recover"`` the next poll aborts every
in-flight request and requeues it with bounded retries and exponential
backoff; ``overload_queue_depth`` / ``overload_ttft_p95_s`` enter a
degraded mode (one chunk call a poll, no bursts); ``shed_inflight``
sheds staged and decoding requests past their deadline; and
``flight_records`` keeps the last N request timelines, dumped as JSONL on
every fault (``serve/flight_recorder.py``).  The one difference kept:
there is no backend fallback (the JAX engine's decode-mode ladder); an
injected or real kernel failure raises out of ``poll()``.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.nn import quant
from repro_torch.runtime.elastic import backoff_delay_s
from repro_torch.runtime.faults import as_injector
from repro_torch.runtime.health import StepMonitor, Watchdog
from repro_torch.serve import state_pool
from repro_torch.serve.engine import EngineBase, ServeConfig
from repro_torch.serve.flight_recorder import FlightRecorder
from repro_torch.serve.prefix_cache import PrefixCache, chunk_key
from repro_torch.serve.program_registry import TensorSpec, budget_for
from repro_torch.serve.scheduler import Request, bucket_for, chunk_span
from repro_torch.serve.speculative import accept_lengths, emit_counts, \
    needs_rollback
from repro_torch.serve.state_pool import StatePool
from repro_torch.serve.tracing import (TID_HOST, TID_QUEUE, TID_SLOT0,
                                       RecompileSentinel, TracedProgram)

log = logging.getLogger("repro_torch.serve")


class ContinuousEngine(EngineBase):
    """Slot-scheduled serving over a shared per-slot state pool."""

    def __init__(self, model, params, cfg: ServeConfig, *,
                 draft_params=None):
        super().__init__(model, params, cfg)
        self.slots = cfg.max_batch
        self.buckets = tuple(sorted(cfg.prefill_buckets))
        self.chunk = cfg.prefill_chunk or None
        self.spec_k = int(cfg.speculate_k or 0)
        if self.spec_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {self.spec_k}")
        max_prompt = (chunk_span(self.buckets, self.chunk, self.buckets[-1])
                      if self.chunk else self.buckets[-1])
        # A burst near the output budget consumes up to k tokens past the
        # last decode position: attention caches get that headroom.
        self.max_seq = max_prompt + cfg.max_new_tokens + \
            (self.spec_k + 1 if self.spec_k else 0)
        dtype = model.cfg.dtype
        self.pool = StatePool(model, self.slots, self.max_seq, dtype,
                              tracer=self.tracer, watch=self._watch)
        # Zeroed prefill input cache, reused by every monolithic admission
        # (prefill writes a new cache; its rows are copied into the pool).
        self._scratch = model.init_cache(self.slots, self.max_seq, dtype)
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self._pos = np.zeros(self.slots, np.int64)
        self._next_tok = np.full(self.slots, cfg.pad_id, np.int64)
        self._finished: List[Request] = []
        if self.chunk:
            # Staging pool: row i accumulates slot i's prompt state chunk
            # by chunk until the prompt is consumed.
            self._ppool = StatePool(model, self.slots, self.max_seq, dtype,
                                    tracer=self.tracer)
            self._chunk_step = TracedProgram("prefill_chunk",
                                             model.prefill_chunk,
                                             watch=self._watch)
            self._pref_req: List[Optional[Request]] = [None] * self.slots
            self._pref_toks: List[Optional[np.ndarray]] = [None] * self.slots
            self._pref_off = np.zeros(self.slots, np.int64)
        if self.spec_k:
            # Draft params: the raw params quantized (``decode_view``'s
            # fp32 kernel operands must not be), unless the caller hands
            # in its own; then their decode view, built once.
            if draft_params is None:
                draft_params = quant.quantize_params_for_mode(
                    params, cfg.speculate_draft)
            self._draft_params = model.decode_view(draft_params)
            # The draft scratch rows (refreshed from the live rows each
            # burst) and the pre-burst backup rows rollback restores from.
            self._dpool = StatePool(model, self.slots, self.max_seq, dtype,
                                    tracer=self.tracer)
            self._bpool = StatePool(model, self.slots, self.max_seq, dtype,
                                    tracer=self.tracer)
            self._verify = TracedProgram("verify", model.verify_chunk,
                                         watch=self._watch)
            # A rolled-back row's emitted tokens, re-consumed one a poll by
            # the decode step; bursts run only when every live row drained.
            self._overflow: List[List[int]] = [[] for _ in range(self.slots)]
        self._pcache: Optional[PrefixCache] = None
        if cfg.prefix_cache_mb:
            if not self.chunk:
                raise ValueError(
                    "prefix_cache_mb requires chunked prefill: snapshots "
                    "live at chunk boundaries (set prefill_chunk)")
            grain = cfg.prefix_chunk or self.chunk
            if grain % self.chunk:
                raise ValueError(
                    f"prefix_chunk ({grain}) must be a multiple of "
                    f"prefill_chunk ({self.chunk}): snapshots are taken "
                    "between chunk calls")
            self._pcache = PrefixCache(int(cfg.prefix_cache_mb * 2 ** 20),
                                       grain, tracer=self.tracer)
            # Per-slot trie walk while staging: the chunk key of the
            # padded stream, the deepest visited node (new snapshots attach
            # under it), the pins released when the request leaves
            # staging, and an insert gate that closes when the budget
            # refuses a node (children would dangle).
            self._pref_key: List[Optional[list]] = [None] * self.slots
            self._pref_node: List[Optional[object]] = [None] * self.slots
            self._pref_pins: List[list] = [[] for _ in range(self.slots)]
            self._pref_insert_ok = [True] * self.slots
        # Flight recorder, created before the watchdog so that its thread
        # can always dump.
        self.flight: Optional[FlightRecorder] = None
        if cfg.flight_records:
            self.flight = FlightRecorder(cfg.flight_records, cfg.flight_path)
        # Sentinels in the JAX engine's order (verify before
        # prefill_chunk; the pool's row ops join in _register_programs).
        strict = cfg.strict_recompile
        if self.spec_k:
            self.sentinels["verify"] = RecompileSentinel(
                "verify", self._verify, strict=strict)
        if self.chunk:
            self.sentinels["prefill_chunk"] = RecompileSentinel(
                "prefill_chunk", self._chunk_step, strict=strict)
        self._register_programs()
        # Host scheduling gaps (the time between two polls) get their own
        # track, so that a phase breakdown accounts for all wall time.
        self._last_poll_end: Optional[float] = None
        # Step-time health: straggler flags on the program calls, and a
        # watchdog that fires when no call completes within watchdog_s.
        self.monitor_decode = StepMonitor()
        self.monitor_prefill = StepMonitor()
        self.monitor_spec = StepMonitor()
        self._watchdog: Optional[Watchdog] = None
        if cfg.watchdog_s:
            if cfg.watchdog_action not in ("log", "recover"):
                raise ValueError(
                    f"watchdog_action must be 'log' or 'recover', got "
                    f"{cfg.watchdog_action!r}")
            self._watchdog = Watchdog(cfg.watchdog_s, on_hang=self._on_hang)
        probe = cfg.poison_probe or "off"
        if probe not in ("off", "logits", "state"):
            raise ValueError(f"poison_probe must be off|logits|state, "
                             f"got {probe!r}")
        self._poison_probe = probe
        self._injector = as_injector(cfg.fault_plan)
        self._poll_idx = 0          # the poll clock fault plans count on
        self._overloaded = False    # degraded overload mode latch
        self._recover_pending = False   # the watchdog asked for a recovery

    @property
    def poll_index(self) -> int:
        """The engine's poll clock: fault-plan polls are absolute, so a
        harness arms a plan relative to this after a warmup."""
        return self._poll_idx

    def set_fault_plan(self, plan) -> None:
        """(Re)arm the fault injector mid-run (None disarms)."""
        self._injector = as_injector(plan)

    def _on_hang(self) -> None:
        """The watchdog's callback, on its thread: counters, a trace
        instant and the flight dump (host JSON); no tensor is touched.
        Under ``recover`` the next ``poll()`` does the abort."""
        self.metrics.watchdog_fires += 1
        self.tracer.instant("watchdog_hang", deadline_s=self.cfg.watchdog_s)
        log.error("serve watchdog: no program call completed within %.1fs "
                  "— engine may be hung", self.cfg.watchdog_s)
        if self.flight is not None:
            self.flight.record_fault("watchdog_hang",
                                     deadline_s=self.cfg.watchdog_s)
        if self.cfg.watchdog_action == "recover":
            self._recover_pending = True

    def close(self) -> None:
        """Stop the watchdog thread (idempotent); asserts that the thread
        joined, so a leaked watchdog fails loudly."""
        if self._watchdog is not None:
            wd = self._watchdog
            wd.stop()
            assert not wd.alive, "watchdog thread failed to join in close()"
            self._watchdog = None

    def reset_stats(self) -> None:
        # Fresh monitors: warmup calls would pollute the straggler
        # baseline.  The cleared poll stamp keeps the first post-warmup
        # poll from emitting a host_gap that spans the warmup.
        self.monitor_decode = StepMonitor()
        self.monitor_prefill = StepMonitor()
        self.monitor_spec = StepMonitor()
        self._last_poll_end = None
        super().reset_stats()

    # -- program registry -----------------------------------------------------
    def _register_programs(self) -> None:
        """Attach every program this engine calls to the registry at its
        serve shapes (specs only: cards build lazily, off the serve path),
        under the JAX engine's names and order so that the ids match; the
        sentinels learn their program ids, and the decode pool's row ops
        get sentinels of their own."""
        reg = self.registry
        model, dev, i64 = self.model, self.device, torch.int64
        tok = TensorSpec((self.slots, 1), i64, dev)
        pos = np.zeros(self.slots, np.int64)
        reg.register("decode", model.decode_step,
                     (tok, self.pool.cache, pos), weights=self.params,
                     budget=budget_for(model.cfg, "decode"))
        reg.register("prefill", model.prefill,
                     ({"tokens": TensorSpec((self.slots, self.buckets[-1]),
                                            i64, dev)}, self._scratch),
                     weights=self.params)
        if self.chunk:
            reg.register("prefill_chunk", model.prefill_chunk,
                         (TensorSpec((self.slots, self.chunk), i64, dev),
                          self._ppool.cache, pos), weights=self.params)
        if self.spec_k:
            reg.register("verify", model.verify_chunk,
                         (TensorSpec((self.slots, self.spec_k), i64, dev),
                          self.pool.cache, pos), weights=self.params)
            # The draft step is the decode program on the W8 weights.
            reg.register("draft", model.decode_step,
                         (tok, self.pool.cache, pos),
                         weights=self._draft_params)
            # The W8 dequant-matmul the draft calls, at a representative
            # (slots, d_model) x (d_model, d_model) shape: kernel 10 on
            # the card, its plain version on the CPU.
            d = model.cfg.d_model
            reg.register("qmatmul", ops.qmatmul,
                         (TensorSpec((self.slots, d), model.cfg.dtype, dev),
                          TensorSpec((d, d), torch.int8, dev),
                          TensorSpec((1, d), torch.float32, dev)))
        pool = self.pool
        row = TensorSpec((1,), i64, dev)
        reg.register("pool_insert",
                     lambda c, s, r, i: state_pool.insert_rows(c, s, r, i,
                                                               pool.axes),
                     (pool.cache, pool.cache, row, row))
        reg.register("pool_extract",
                     lambda c, i: state_pool.extract_rows(c, i, pool.axes),
                     (pool.cache, row))
        reg.register("pool_reset",
                     lambda c, i: state_pool.reset_rows(c, i, pool.axes),
                     (pool.cache, row))
        for name, s in self.sentinels.items():
            s.program_id = reg.program_id(name)
        for name, prog in (("pool_insert", pool.insert_program),
                           ("pool_reset", pool.reset_program)):
            self.sentinels[name] = RecompileSentinel(
                name, prog, strict=self.cfg.strict_recompile,
                program_id=reg.program_id(name))
        # Span args take these id strings: no registry lookup per call.
        self._pid_decode = reg.program_id("decode")
        self._pid_prefill = reg.program_id("prefill")
        self._pid_chunk = reg.program_id("prefill_chunk")
        self._pid_verify = reg.program_id("verify")
        self._pid_draft = reg.program_id("draft")

    def _snapshot_extra(self) -> dict:
        """Engine facts folded into each periodic metrics snapshot."""
        out = {"monitor_decode": self.monitor_decode.summary(),
               "monitor_prefill": self.monitor_prefill.summary(),
               "recompile_trips": {name: s.trips
                                   for name, s in self.sentinels.items()}}
        if self.spec_k:
            out["monitor_spec"] = self.monitor_spec.summary()
        if self._pcache is not None:
            out["prefix_cache"] = self._pcache.stats()
        if self._injector is not None:
            out["fault_injector"] = self._injector.summary()
        out["overloaded"] = self._overloaded
        return out

    # -- fault tolerance --------------------------------------------------------
    def _observe_step(self, monitor: StepMonitor, kind: str,
                      dt_s: float) -> None:
        """Feed one program call's seconds (up to its logits on the host)
        to its monitor; a straggler is counted and traced; the watchdog is
        petted."""
        if monitor.observe(None, dt_s).straggler:
            self.metrics.record_straggler(kind)
            self.tracer.instant(f"straggler_{kind}", seconds=dt_s)
        if self._watchdog is not None:
            self._watchdog.pet()

    def _guarded_call(self, program: str, fn, *args):
        """``fn(*args)`` behind the fault boundary: the injector's hook
        first (a stall sleeps inside the call's timing window, an injected
        failure raises before the program launches anything).  Nothing is
        caught: a failed call raises out of ``poll()``."""
        if self._injector is not None:
            self._injector.pre_call(program, self._poll_idx)
        return fn(*args)

    def _evict(self, slot: int) -> None:
        """Free a decoding slot: its pool row zeroed, its position, next
        token and overflow cleared."""
        self.pool.reset_rows([slot])
        self._pos[slot] = 0
        self._next_tok[slot] = self.cfg.pad_id
        if self.spec_k:
            self._overflow[slot] = []
        self._slot_req[slot] = None

    def _unstage(self, row: int) -> None:
        """Free a staging row (its trie pins released)."""
        if self._pcache is not None:
            self._prefix_release(row)
        self._pref_req[row] = None
        self._pref_toks[row] = None

    def _poisoned(self, req: Request, slot: int, now: float,
                  where: str) -> None:
        """Finish a request whose row was quarantined: status
        ``poisoned``, counted as shed (reason ``poison``), not completed."""
        req.done = True
        req.status = "poisoned"
        req.finish_s = now
        req.latency_s = now - req.arrival_s
        self.metrics.record_quarantine()
        self.metrics.record_shed("poison")
        self.tracer.instant("quarantine", uid=req.uid, slot=slot,
                            where=where, tokens=len(req.out_tokens))
        if self.flight is not None:
            self.flight.record_request(req, slot=slot, status="poisoned")
            self.flight.record_fault("quarantine", uid=req.uid, slot=slot,
                                     where=where)
        log.error("request %d: non-finite %s output in slot %d — "
                  "quarantined (row reset, request shed)", req.uid, where,
                  slot)
        self._finished.append(req)

    def _state_finite(self) -> np.ndarray:
        """bool[slots]: every state element of each decode-pool row is
        finite.  One reduction a leaf on the device (a row's min and max,
        read in one pass: NaN propagates into both, +-Inf into one), then
        one bool[slots] copy to the host."""
        ok = None
        for leaf, ax in zip(self.pool.cache, self.pool.axes):
            lo, hi = torch.aminmax(
                leaf.reshape(tuple(leaf.shape[:ax + 1]) + (-1,)), dim=-1)
            f = (lo.isfinite() & hi.isfinite()).movedim(ax, 0)
            f = f.reshape(self.slots, -1).all(-1)
            ok = f if ok is None else ok & f
        return ok.cpu().numpy()

    def _probe_rows(self, live: List[int], rows_ok: np.ndarray, n_bad: int,
                    now: float, where: str) -> List[int]:
        """Poison probe over one call's live rows: ``rows_ok`` is the
        finiteness of their logits and ``n_bad`` its count of non-finite
        rows (both taken by ``_host_logits`` for the metrics anyway), and
        in ``state`` mode the decode pool's rows are reduced too.
        Quarantines every hit; returns the quarantined slots."""
        if self._poison_probe == "off" or not live:
            return []
        if self._poll_idx % max(1, self.cfg.poison_check_every):
            return []
        self.metrics.record_poison_probe()
        state = self._poison_probe == "state"
        if not state and not n_bad:
            return []
        bad = {i for i in live if not rows_ok[i]}
        if state:
            finite = self._state_finite()
            bad.update(i for i in live if not finite[i])
        for i in sorted(bad):
            req = self._slot_req[i]
            self._evict(i)
            self._poisoned(req, i, now, where)
        return sorted(bad)

    def _inject_poison(self) -> None:
        """Apply due poison faults: a live row's snapshot, corrupted,
        written back (``clone_row`` / ``restore_row``)."""
        live = [i for i, r in enumerate(self._slot_req) if r is not None]
        for slot, mode in self._injector.poison_targets(self._poll_idx,
                                                        live):
            snap = self.pool.clone_row(slot)
            self.pool.restore_row(slot, self._injector.corrupt(snap, mode))

    @staticmethod
    def _snapshot_finite(snap) -> bool:
        """Whether every floating leaf of a prefix snapshot is finite:
        reduced on the device, one bool to the host."""
        flags = [torch.isfinite(x).all() for x in snap
                 if x.is_floating_point()]
        return bool(torch.stack(flags).all()) if flags else True

    def _update_overload(self) -> None:
        """Degraded-mode state machine: enter when the queue depth or the
        TTFT p95 crosses its threshold; while degraded the prefill budget
        is one chunk call a poll and bursts pause.  Exit on the queue depth
        alone, at ``overload_clear_frac`` of its threshold (TTFT p95 is
        cumulative and would latch forever)."""
        cfg = self.cfg
        q_thresh = cfg.overload_queue_depth
        t_thresh = cfg.overload_ttft_p95_s
        if not q_thresh and not t_thresh:
            return
        depth = len(self._scheduler)
        if not self._overloaded:
            trip = bool(q_thresh and depth >= q_thresh) or bool(
                t_thresh and self.metrics.ttft.count and
                self.metrics.ttft.percentile(0.95) > t_thresh)
            if trip:
                self._overloaded = True
                self.metrics.record_overload(True)
                self.tracer.instant("overload_enter", queue_depth=depth)
                log.warning("overload: entering degraded mode (queue "
                            "depth %d) — prefill budget 0, speculation "
                            "paused", depth)
        else:
            clear_at = cfg.overload_clear_frac * q_thresh if q_thresh else 0
            if depth <= clear_at:
                self._overloaded = False
                self.metrics.record_overload(False)
                self.tracer.instant("overload_exit", queue_depth=depth)
                log.info("overload cleared (queue depth %d): restoring "
                         "prefill budget and speculation", depth)

    def _shed_inflight(self, now: float) -> None:
        """Shed decoding and staged requests whose deadline passed: their
        capacity goes to work that can still meet its deadline."""
        for i, req in enumerate(self._slot_req):
            if req is None or req.deadline_s is None or \
                    now <= req.deadline_s:
                continue
            self._evict(i)
            self._shed_request(req, now, "deadline", "shed_deadline")
        if self.chunk:
            for i, req in enumerate(self._pref_req):
                if req is None or req.deadline_s is None or \
                        now <= req.deadline_s:
                    continue
                self._unstage(i)
                self._shed_request(req, now, "deadline", "shed_deadline")

    def _shed_request(self, req: Request, now: float, reason: str,
                      status: str) -> None:
        """An in-flight request finishes unsuccessfully (deadline, retries
        exhausted): it lands in the poll's finished list and in
        ``expired``."""
        req.done = True
        req.expired = True
        req.status = status
        req.finish_s = now
        req.latency_s = now - req.arrival_s
        self.metrics.record_shed(reason)
        self._scheduler.expired.append(req)
        self.tracer.instant("shed", uid=req.uid, reason=reason,
                            inflight=True)
        if self.flight is not None:
            self.flight.record_request(req, status=status)
            self.flight.record_fault("shed", uid=req.uid, reason=reason)
        log.warning("request %d: shed in flight (%s)", req.uid, reason)
        self._finished.append(req)

    def _watchdog_recover(self, now: float) -> None:
        """Recovery after a watchdog fire (``watchdog_action="recover"``):
        abort every decoding and staged request, reset their rows and
        requeue each with a bounded retry budget and backoff.  A requeued
        request starts again from its prompt; keyed sampling replays the
        same stream."""
        self._recover_pending = False
        requeued = 0
        for i, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._evict(i)
            requeued += self._retry_or_shed(req, now)
        if self.chunk:
            for i, req in enumerate(self._pref_req):
                if req is None:
                    continue
                self._unstage(i)
                requeued += self._retry_or_shed(req, now)
        self.metrics.record_watchdog_recovery(requeued)
        self.tracer.instant("watchdog_recover", requeued=requeued)
        if self.flight is not None:
            self.flight.record_fault("watchdog_recover", requeued=requeued)
        log.error("watchdog recovery: aborted stuck burst, requeued %d "
                  "request(s)", requeued)

    def _retry_or_shed(self, req: Request, now: float) -> int:
        """Requeue an aborted request (1), or shed it (0) once its retry
        budget is spent.  Its emitted tokens are dropped and its admission
        deferred by the backoff curve."""
        req.retries += 1
        if req.retries > self.cfg.max_retries:
            self._shed_request(req, now, "retry_exhausted",
                               "retry_exhausted")
            return 0
        req.out_tokens.clear()
        req.done = False
        req.first_token_s = None
        req.decode_pc = None
        req.admit_pc = None
        base = self.cfg.retry_backoff_s
        req.not_before_s = (now + backoff_delay_s(req.retries, base)
                            if base else None)
        self.tracer.instant("retry", uid=req.uid, attempt=req.retries)
        if self.flight is not None:
            self.flight.record_fault("retry", uid=req.uid,
                                     attempt=req.retries)
        self._scheduler.submit(req)
        return 1

    @property
    def prefix_cache(self) -> Optional[PrefixCache]:
        """The prefix-state cache (None when ``prefix_cache_mb`` is 0)."""
        return self._pcache

    @property
    def busy(self) -> bool:
        return (len(self._scheduler) > 0 or
                any(r is not None for r in self._slot_req) or
                (self.chunk is not None and
                 any(r is not None for r in self._pref_req)))

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(tokens).to(self.device)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req)
                if r is None and
                (self.chunk is None or self._pref_req[i] is None)]

    def _finish(self, req: Request, now: float, slot: int) -> None:
        req.done = True
        req.finish_s = now
        req.latency_s = now - req.arrival_s
        self.metrics.record_finish(req.latency_s, len(req.out_tokens))
        if self.flight is not None:
            self.flight.record_request(req, slot=slot, status=req.status)
        if self.tracer.enabled:
            if req.decode_pc is not None:
                self.tracer.complete("decode", req.decode_pc,
                                     time.perf_counter(),
                                     tid=TID_SLOT0 + slot, uid=req.uid,
                                     tokens=len(req.out_tokens))
            self.tracer.instant("finish", uid=req.uid,
                                tokens=len(req.out_tokens),
                                latency_s=req.latency_s)
        self._finished.append(req)

    def _start_tenant(self, slot: int, req: Request, span: int, tok: int,
                      t_first: float) -> None:
        """Clamp the output budget to the slot's remaining cache, stamp
        the first token and emit it; then either finish (EOS on the
        prefill token, or a 1-token budget: the slot stays free) or
        install the request as the slot's decoding tenant at ``span``."""
        cfg = self.cfg
        budget = max(1, min(req.max_new_tokens, self.max_seq - span))
        if budget < req.max_new_tokens:
            log.warning("request %d: max_new_tokens %d exceeds slot budget; "
                        "clamping to %d", req.uid, req.max_new_tokens, budget)
            req.max_new_tokens = budget
        req.first_token_s = t_first
        t_first_pc = time.perf_counter()
        if self.tracer.enabled and req.admit_pc is not None:
            # Staging residency: queue pop -> first token (the request's
            # prefill calls and the waits between them).
            self.tracer.complete("staging", req.admit_pc, t_first_pc,
                                 tid=TID_SLOT0 + slot, uid=req.uid,
                                 span=span)
        self.metrics.record_first_token(t_first - req.arrival_s)
        self.metrics.record_token()
        req.emit(tok)
        if (cfg.eos_id >= 0 and tok == cfg.eos_id) or \
                len(req.out_tokens) >= req.max_new_tokens:
            self._finish(req, t_first, slot)
        else:
            req.decode_pc = t_first_pc
            self._slot_req[slot] = req
            self._pos[slot] = span
            self._next_tok[slot] = tok

    def _pop_ready(self, now: float, free: List[int]) -> List[tuple]:
        """(slot, request) pairs for as many free slots as the queue
        fills; requests shed on their deadline are counted."""
        n_shed0 = len(self._scheduler.expired)
        batch = []
        while free and len(self._scheduler):
            req = self._scheduler.pop_ready(now)
            if req is None:
                break
            req.admit_pc = time.perf_counter()
            if self.tracer.enabled:
                self.tracer.complete(
                    "queue", self.tracer.pc_from_walltime(req.arrival_s),
                    req.admit_pc, tid=TID_QUEUE, uid=req.uid)
            batch.append((free.pop(0), req))
        for _ in range(len(self._scheduler.expired) - n_shed0):
            self.metrics.record_shed()
        return batch

    def _admit(self, now: float) -> int:
        """Monolithic admission: fill free slots from the queue, one
        bucketed prefill at batch ``slots`` per bucket; returns the
        requests admitted."""
        cfg = self.cfg
        batch = self._pop_ready(now, self._free_slots())
        groups = {}
        for slot, req in batch:
            b, _ = bucket_for(self.buckets, len(req.prompt))
            groups.setdefault(b, []).append((slot, req))
        for bucket, group in groups.items():
            tokens = np.full((self.slots, bucket), cfg.pad_id, np.int64)
            for row, (_, req) in enumerate(group):
                p = req.prompt[-bucket:]
                tokens[row, bucket - len(p):] = p
            t0 = time.perf_counter()
            logits, cache = self._guarded_call(
                "prefill", self._prefill, self.params,
                {"tokens": self._tokens(tokens)}, self._scratch)
            # First tokens sample at position = bucket (tokens consumed).
            uids = np.zeros(self.slots, np.int64)
            for row, (_, req) in enumerate(group):
                uids[row] = req.uid
            first = self._sample_rows(logits, uids,
                                      np.full(self.slots, bucket, np.int64))
            t1 = time.perf_counter()
            self.tracer.complete("prefill_bucket", t0, t1, bucket=bucket,
                                 rows=len(group),
                                 tokens=bucket * len(group),
                                 program=self._pid_prefill)
            self._observe_step(self.monitor_prefill, "prefill", t1 - t0)
            self.metrics.record_prefill(bucket * len(group), t1 - t0)
            self.pool.insert_rows(cache, range(len(group)),
                                  [slot for slot, _ in group])
            t_first = time.time()
            for row, (slot, req) in enumerate(group):
                req.bucket = bucket
                self._start_tenant(slot, req, bucket, int(first[row]),
                                   t_first)
        return len(batch)

    def _admit_chunked(self, now: float) -> int:
        """Reserve free slots for queued requests and stage their padded
        prompts; the chunks run in :meth:`_prefill_step`."""
        batch = self._pop_ready(now, self._free_slots())
        for slot, req in batch:
            p = req.prompt[-self.buckets[-1]:]
            span = chunk_span(self.buckets, self.chunk, len(p))
            toks = np.full(span, self.cfg.pad_id, np.int64)
            toks[span - len(p):] = p
            req.bucket = span
            off = 0
            if self._pcache is not None:
                off = self._prefix_match(slot, toks, span)
            if not off:
                # The row's previous tenant left state behind; the chunk
                # calls accumulate into the row, so it starts from zero (a
                # restore overwrites the whole row instead).
                self._ppool.reset_rows([slot])
            self._pref_req[slot] = req
            self._pref_toks[slot] = toks
            self._pref_off[slot] = off
        return len(batch)

    # -- prefix-state cache ---------------------------------------------------
    def _prefix_match(self, slot: int, toks: np.ndarray, span: int) -> int:
        """Longest-prefix lookup for a staged (padded) stream: restore the
        matched snapshot into the staging row and return the offset the
        chunks resume from (0 = miss).  The match is capped so that at
        least one chunk runs: its last logits give the first token."""
        cache = self._pcache
        with self.tracer.span("prefix_lookup") as sp:
            key = chunk_key(toks, cache.chunk)
            cap = max(0, (span - self.chunk) // cache.chunk)
            node, depth = cache.match(key, max_depth=cap)
            off = depth * cache.chunk
            sp.args["matched_tokens"] = off
        self.metrics.record_prefix_lookup(off)
        self._pref_key[slot] = key
        self._pref_node[slot] = node
        self._pref_pins[slot] = [node] if node is not None else []
        self._pref_insert_ok[slot] = True
        if node is not None:
            self._ppool.restore_row(slot, node.snapshot, index=off)
        return off

    def _prefix_insert(self, row: int) -> None:
        """After a chunk call: if the row crossed a snapshot boundary the
        cache has not seen, snapshot the staging row and attach it under
        the row's trie cursor.  A budget refusal closes the gate: deeper
        nodes would have no parent path."""
        cache = self._pcache
        off = int(self._pref_off[row])
        if off % cache.chunk or not self._pref_insert_ok[row]:
            return
        depth = off // cache.chunk
        key = self._pref_key[row]
        if depth > len(key):
            return
        nxt = cache.child(self._pref_node[row], key[depth - 1])
        if nxt is None:
            snap = self._ppool.clone_row(row, index=off)
            if self._injector is not None:
                fault = self._injector.snapshot_fault(self._poll_idx)
                if fault == "drop":
                    # A lost write closes the gate like a budget refusal.
                    self._pref_insert_ok[row] = False
                    return
                if fault == "corrupt":
                    snap = self._injector.corrupt(snap)
            if self._poison_probe != "off" and \
                    not self._snapshot_finite(snap):
                # A non-finite snapshot never enters the cross-request
                # cache; deeper nodes of this request are not attached.
                self._pref_insert_ok[row] = False
                self.tracer.instant("snapshot_poison_refused", slot=row,
                                    offset=off)
                log.error("prefix snapshot at offset %d (row %d) is "
                          "non-finite — refused", off, row)
                return
            nxt = cache.insert(self._pref_node[row], key[depth - 1], snap)
            if nxt is None:
                self._pref_insert_ok[row] = False
                return
        self._pref_node[row] = nxt
        self._pref_pins[row].append(nxt)

    def _prefix_release(self, row: int) -> None:
        """Staging is over: unpin the row's trie path, whose nodes become
        evictable again."""
        for node in self._pref_pins[row]:
            self._pcache.release(node)
        self._pref_pins[row] = []
        self._pref_node[row] = None
        self._pref_key[row] = None

    def _prefill_step(self) -> int:
        """Advance every staging row by one chunk (one call at ``(slots,
        chunk)``); finished prompts sample their first token and move
        their rows into the decode pool.  Returns the prompt tokens
        advanced (0 when nothing is staging)."""
        rows = [i for i, r in enumerate(self._pref_req) if r is not None]
        if not rows:
            return 0
        C = self.chunk
        tokens = np.full((self.slots, C), self.cfg.pad_id, np.int64)
        for i in rows:
            off = self._pref_off[i]
            tokens[i] = self._pref_toks[i][off:off + C]
        t0 = time.perf_counter()
        logits, self._ppool.cache = self._guarded_call(
            "prefill_chunk", self._chunk_step, self.params,
            self._tokens(tokens), self._ppool.cache, self._pref_off)
        host = logits.float().cpu()           # the call ends on the device
        t1 = time.perf_counter()
        self.tracer.complete("prefill_chunk", t0, t1, rows=len(rows),
                             tokens=C * len(rows), program=self._pid_chunk)
        self._observe_step(self.monitor_prefill, "prefill", t1 - t0)
        self.metrics.record_prefill(C * len(rows), t1 - t0)
        done_rows = []
        for i in rows:
            self._pref_off[i] += C
            if self._pcache is not None:
                self._prefix_insert(i)
            if self._pref_off[i] >= len(self._pref_toks[i]):
                if self._pcache is not None:
                    self._prefix_release(i)
                done_rows.append(i)
        if done_rows:
            lg = self._host_logits(host)
        if done_rows and self._poison_probe != "off":
            # Gate the staging -> decode handoff: a non-finite first-token
            # logits row means the staged state is poisoned; it never
            # reaches the decode pool.
            now_p = time.time()
            ok = self.rows_finite
            for i in [i for i in done_rows if not ok[i]]:
                req = self._pref_req[i]
                self._unstage(i)
                self._ppool.reset_rows([i])
                self._poisoned(req, i, now_p, "prefill")
            done_rows = [i for i in done_rows if ok[i]]
        if done_rows:
            uids = np.zeros(self.slots, np.int64)
            poss = np.zeros(self.slots, np.int64)
            for i in done_rows:
                uids[i] = self._pref_req[i].uid
                poss[i] = len(self._pref_toks[i])
            first = self._sample_rows(lg, uids, poss)
            # Staging row i becomes slot i's decode state.
            self.pool.insert_rows(self._ppool.cache, done_rows, done_rows)
            t_first = time.time()
            for i in done_rows:
                req = self._pref_req[i]
                span = len(self._pref_toks[i])
                self._pref_req[i] = None
                self._pref_toks[i] = None
                self._start_tenant(i, req, span, int(first[i]), t_first)
        return C * len(rows)

    def _row_uids(self) -> List[int]:
        """Per-slot owning-request uids (0 for dead and staging rows,
        whose sampled tokens are dropped)."""
        return [r.uid if r is not None else 0 for r in self._slot_req]

    def _spec_burst(self, live: List[int]) -> None:
        """One speculative burst across the live slots (accept rule and
        notation: ``serve/speculative.py``): back up the live rows, draft
        ``k`` tokens with the draft params on the scratch pool, verify all
        ``k`` in one chunk call on the decode pool, emit per row
        ``min(m + 1, k)`` verify-stream tokens, restore rows that consumed
        a rejected draft and park their emitted tokens in the overflow
        queue for the decode-step drain.  Dead and staging rows are left
        stale: the verify chunk advances them as sinks and a refill
        overwrites the whole row."""
        cfg = self.cfg
        k = self.spec_k
        uids = self._row_uids()
        # In-place row copies: the backup and scratch arenas never alias
        # the live one (``StatePool.insert_rows`` gathers fresh rows).
        with self.tracer.span("spec_copy", rows=len(live)):
            self._bpool.insert_rows(self.pool.cache, live, live)
            self._dpool.insert_rows(self.pool.cache, live, live)

        # The draft steps are the decode program on the draft weights.
        drafts = np.zeros((self.slots, k), np.int64)
        cur = self._next_tok.copy()
        t0 = time.perf_counter()
        for j in range(k):
            logits, self._dpool.cache = self._guarded_call(
                "draft", self._decode, self._draft_params,
                self._tokens(cur[:, None]), self._dpool.cache,
                self._pos + j)
            cur = self._sample_rows(logits, uids, self._pos + j + 1)
            drafts[:, j] = cur
        t1 = time.perf_counter()
        self.tracer.complete("draft", t0, t1, rows=len(live), k=k,
                             tokens=k * len(live), program=self._pid_draft)
        self._observe_step(self.monitor_spec, "draft", t1 - t0)

        # Verify: ONE chunk call over [t0, d_1 .. d_{k-1}] on the decode
        # pool; rows that keep their window inherit its state as it is.
        vtoks = np.concatenate([self._next_tok[:, None], drafts[:, :k - 1]],
                               axis=1)
        t0 = time.perf_counter()
        vlogits, self.pool.cache = self._guarded_call(
            "verify", self._verify, self.params, self._tokens(vtoks),
            self.pool.cache, self._pos)
        vl = vlogits.float().cpu()            # the call ends on the device
        t1 = time.perf_counter()
        self.tracer.complete("verify", t0, t1, rows=len(live),
                             tokens=k * len(live), program=self._pid_verify)
        self._observe_step(self.monitor_spec, "verify", t1 - t0)
        self.metrics.record_step(len(live), t1 - t0)

        # Position j's token samples with the key the plain decode step
        # would use there: (uid, pos + j + 1).
        verify = np.empty((self.slots, k), np.int64)
        rows_ok = np.ones(self.slots, bool)
        n_bad = 0
        for j in range(k):
            verify[:, j] = self._sample_rows(vl[:, j], uids,
                                             self._pos + j + 1)
            rows_ok &= self.rows_finite
            n_bad += self.nonfinite_rows
        m = accept_lengths(drafts, verify)
        n_emit = emit_counts(m, k)
        rollback = needs_rollback(m, k)
        now = time.time()
        # Poison probe on the verify logits: quarantined rows leave the
        # emit loop.
        self._probe_rows(live, rows_ok, n_bad, now, "verify")
        emitted_total = accepted = rollbacks = 0
        for i in live:
            req = self._slot_req[i]
            if req is None:         # quarantined by the probe
                continue
            accepted += int(m[i])
            emitted: List[int] = []
            finished = False
            for j in range(int(n_emit[i])):
                tok = int(verify[i, j])
                req.emit(tok)
                emitted.append(tok)
                self.metrics.record_token()
                if (cfg.eos_id >= 0 and tok == cfg.eos_id) or \
                        len(req.out_tokens) >= req.max_new_tokens:
                    self._finish(req, now, i)
                    self._slot_req[i] = None
                    finished = True
                    break
            emitted_total += len(emitted)
            if finished:
                self._overflow[i] = []
                continue
            if rollback[i]:
                rollbacks += 1
                with self.tracer.span("rollback", slot=i,
                                      accepted=int(m[i])):
                    self.pool.insert_rows(self._bpool.cache, [i], [i])
                # _pos / _next_tok stay pre-burst: the drain re-consumes
                # the emitted tokens from the restored state.
                self._overflow[i] = emitted
            else:
                # The chunk consumed exactly the emitted stream's prefix:
                # its state is the post-emission state.
                self._pos[i] = min(int(self._pos[i]) + k, self.max_seq - 1)
                self._next_tok[i] = int(verify[i, k - 1])
        self.metrics.record_speculative(
            rows=len(live), drafted=k * len(live), accepted=accepted,
            emitted=emitted_total, rollbacks=rollbacks)

    def poll(self) -> List[Request]:
        """Admit waiting requests (monolithic: prefill them; chunked: stage
        them and advance the staging rows by a chunk, or by the token
        budget), then run one decode step across all slots; returns the
        requests completed this poll."""
        cfg = self.cfg
        done0 = len(self._finished)
        t_poll0 = time.perf_counter()
        if self.tracer.enabled and self._last_poll_end is not None:
            # Host scheduling gap: everything between two polls (the
            # caller's loop, idle waits) on its own track.
            self.tracer.complete("host_gap", self._last_poll_end, t_poll0,
                                 tid=TID_HOST)
        poll_span = self.tracer.span("poll")
        poll_span.__enter__()
        now = time.time()
        # Fault-tolerance pre-work, in the JAX engine's order.
        self._poll_idx += 1
        if self._recover_pending:
            self._watchdog_recover(now)
        if self._injector is not None:
            self._inject_poison()
        if cfg.shed_inflight:
            self._shed_inflight(now)
        self._update_overload()
        if self.chunk:
            with self.tracer.span("admit") as sp:
                sp.args["admitted"] = self._admit_chunked(now)
            spent = self._prefill_step()
            # Degraded overload mode: one chunk call a poll.
            budget = 0 if self._overloaded else cfg.prefill_token_budget
            while spent and budget > spent:
                # An EOS-on-prefill finish frees its slot for the queue.
                with self.tracer.span("admit") as sp:
                    sp.args["admitted"] = self._admit_chunked(time.time())
                adv = self._prefill_step()
                if not adv:
                    break
                spent += adv
        else:
            # Re-admit until the slots are full or the queue drains (a
            # request that ends on its prefill token frees its slot).
            while self._free_slots() and len(self._scheduler):
                with self.tracer.span("admit") as sp:
                    n_admitted = sp.args["admitted"] = self._admit(now)
                if not n_admitted:
                    break
                now = time.time()

        live = [i for i, r in enumerate(self._slot_req) if r is not None]
        if live and self.spec_k and not self._overloaded and \
                not any(self._overflow[i] for i in live):
            self._spec_burst(live)
        elif live:
            t0 = time.perf_counter()
            tok = self._tokens(self._next_tok[:, None])
            logits, self.pool.cache = self._guarded_call(
                "decode", self._decode, self.params, tok, self.pool.cache,
                self._pos)
            nxt = self._sample_rows(logits, self._row_uids(), self._pos + 1)
            t1 = time.perf_counter()
            if self.tracer.enabled:
                self.tracer.complete("decode_step", t0, t1, live=len(live),
                                     tokens=len(live),
                                     program=self._pid_decode)
            self._observe_step(self.monitor_decode, "decode", t1 - t0)
            self.metrics.record_step(len(live), t1 - t0)
            # A dead slot's position pins to the last cache column until a
            # refill overwrites its row.
            self._pos = np.minimum(self._pos + 1, self.max_seq - 1)
            now = time.time()
            # Poison probe on this step's logits: quarantined rows leave
            # the emit loop.
            self._probe_rows(live, self.rows_finite, self.nonfinite_rows,
                             now, "decode")
            emitted = 0
            for i in live:
                req = self._slot_req[i]
                if req is None:     # quarantined by the probe
                    continue
                if self.spec_k and self._overflow[i]:
                    # Rollback drain: this step re-consumed a token the
                    # burst already emitted, re-advancing the restored
                    # state on the non-speculative trajectory; the token
                    # it sampled is dropped (once the queue is empty the
                    # next step computes it again from the same state).
                    self._next_tok[i] = self._overflow[i].pop(0)
                    continue
                tok_i = int(nxt[i])
                req.emit(tok_i)
                emitted += 1
                self._next_tok[i] = tok_i
                if (cfg.eos_id >= 0 and tok_i == cfg.eos_id) or \
                        len(req.out_tokens) >= req.max_new_tokens:
                    self._finish(req, now, i)
                    self._slot_req[i] = None
            if emitted:
                self.metrics.record_token(emitted)     # one sample a step
        poll_span.__exit__(None, None, None)
        self._last_poll_end = time.perf_counter()
        self.check_sentinels()
        if self.metrics.metrics_every:
            self.metrics.observe_gauges(
                queue_depth=len(self._scheduler),
                live_slots=len(live),
                overloaded=float(self._overloaded),
                staging_depth=(sum(r is not None for r in self._pref_req)
                               if self.chunk else 0),
                **({"prefix_resident_bytes": self._pcache.resident_bytes}
                   if self._pcache is not None else {}))
        self.metrics.maybe_snapshot(self._snapshot_extra)
        return self._finished[done0:]

    def run(self) -> List[Request]:
        """Serve until the queue and the slots drain; returns the
        completed requests."""
        t0 = time.perf_counter()
        done: List[Request] = []
        with torch.inference_mode():
            while self.busy:
                done.extend(self.poll())
        t1 = time.perf_counter()
        self.tracer.complete("serve.run", t0, t1)
        self.metrics.record_wall(t1 - t0)
        return done

    def stats(self, requests: Optional[List[Request]] = None) -> dict:
        """The metrics' summary and the recompile sentinels' trips
        (``requests`` is accepted for parity with the wave engine's
        ``stats``)."""
        del requests
        return dict(self.metrics.summary(),
                    recompile_trips=self.counters["recompile_trips"])
