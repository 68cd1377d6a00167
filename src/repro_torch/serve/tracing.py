"""Serve-stack span tracing: per-request timelines, engine phases,
recompile sentinels, behind a near-zero-overhead null tracer (port of
``repro.serve.tracing``; the span names, tracks and argument keys are the
JAX package's, so a trace from either package reads the same).

* :class:`Tracer` records complete events (``ph: "X"``) on a few tracks
  (engine, host, queue, one per slot), counter samples (``ph: "C"``) and
  instants (``ph: "i"``); ``save`` writes Chrome/Perfetto trace JSON and
  ``save_jsonl`` a JSON-lines event log.  ``launch/trace_report.py``
  folds a saved trace into phase breakdowns, TTFT decompositions and
  slot timelines.
* :class:`NullTracer` is the default: every method is a no-op and
  ``span`` returns a shared do-nothing context manager.
* :class:`RecompileSentinel` is the compile-once discipline as a check:
  it arms on a program's cache size and counts every later growth as a
  *trip* (raising :class:`RecompileError` in ``strict`` mode).

Eager PyTorch has no jit cache, so the port's programs are
:class:`TracedProgram` wrappers whose ``_cache_size()`` counts what would
have made ``jax.jit`` retrace: each distinct *signature* a call meets
(the shapes, dtypes and devices of its per-call tensor arguments: tokens,
positions, cache leaves, offsets; the types of its other arguments), plus
every kernel library that ``kernels/build.py: library`` loaded during one
of its calls (a mid-run ``nvcc`` build is the port's own compile).  The
weights are not part of a signature: a call never walks them.  The
engines watch their programs only when tracing or under
``strict_recompile``: a signature is a walk over the cache's leaves,
which the untraced serve loop does not pay for, and there the sentinels
are inert.

Where a span closes: CUDA launches are asynchronous, so a span around a
program call closes after the host sync the engine takes anyway (the
logits reaching the host for sampling), as the JAX span closes after its
``block_until_ready`` or host copy.  The state pool's spans time the
host's dispatch of the row copies only: the engine takes no sync there,
and neither does the JAX engine.

Span taxonomy (``docs/observability.md``'s table):

==================  ====================================================
``serve.run``       one engine ``run()`` drain (engine track)
``poll``            one engine scheduling iteration (engine track)
``admit``           admission: queue pops + staging + prefix lookup
``prefix_lookup``   radix-cache longest-prefix match for one admission
``snapshot_restore``/``snapshot_export``  prefix-cache state row moves
``prefill_bucket``  one monolithic bucketed prefill call
``prefill_chunk``   one chunked-prefill call (all staging rows)
``decode_step``     one decode call across all slots
``draft``/``verify``  a speculative burst's draft steps / verify call
``spec_copy``/``rollback``  a burst's row backups / one row's restore
``pool_insert``/``pool_reset``  state-pool row copy / zero
``host_gap``        time between polls (host track: idle + caller)
``queue``           per-request: arrival -> admission (queue track)
``staging``         per-request: admission -> first token (slot track)
``decode``          per-request: first token -> finish (slot track)
==================  ====================================================
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import build

# Track ("tid") layout inside the single serve process ("pid" 0).
TID_ENGINE = 0      # program calls + host scheduling sections
TID_HOST = 1        # gaps between polls (idle / caller time)
TID_QUEUE = 2       # per-request queue-wait spans (overlapping is fine)
TID_SLOT0 = 100     # slot i's residency spans live on TID_SLOT0 + i

_TRACK_NAMES = {TID_ENGINE: "engine", TID_HOST: "host", TID_QUEUE: "queue"}


class _Span:
    """Context manager recording one complete event on ``__exit__``;
    ``args`` stays mutable until then, for facts learnt mid-span."""

    __slots__ = ("_tr", "name", "tid", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, tid: int,
                 args: Dict[str, Any]):
        self._tr = tracer
        self.name = name
        self.tid = tid
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        # ``Tracer.complete``'s record, appended here without repacking
        # ``args`` as keywords.
        self._tr._raw.append(("X", self.name, self.tid, self._t0,
                              time.perf_counter(), self.args or None))


class _NullSpan:
    """Shared do-nothing span: ``with NULL_TRACER.span(...):`` costs two
    method calls and nothing else."""

    __slots__ = ("args",)

    def __init__(self):
        self.args: Dict[str, Any] = {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        self.args.clear()


class NullTracer:
    """No-op tracer, the default for untraced engines.  ``enabled`` lets
    hot paths skip even argument construction."""

    enabled = False

    def __init__(self):
        self._null_span = _NullSpan()

    def span(self, name: str, tid: int = TID_ENGINE, **args) -> _NullSpan:
        return self._null_span

    def complete(self, name, t0, t1, tid=TID_ENGINE, **args) -> None:
        pass

    def instant(self, name, tid=TID_ENGINE, **args) -> None:
        pass

    def counter(self, name, values) -> None:
        pass

    def reset(self) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """In-memory event recorder; timestamps are ``time.perf_counter()``
    seconds, written as trace microseconds from construction.

    The hot path appends flat ``(ph, name, tid, t0, t1, args)`` tuples;
    the Chrome-format dicts are built by :attr:`events` after the run
    (tuples of atoms leave the garbage collector's young generation at
    once, where a dict per event would age into the old ones)."""

    enabled = True

    def __init__(self):
        super().__init__()
        self._t0 = time.perf_counter()
        # time.time() <-> perf_counter offset, fixed once, so wall-clock
        # stamps (Request.arrival_s) convert onto the trace clock.
        self._epoch = time.time() - self._t0
        self._raw: List[tuple] = []

    # -- clocks ------------------------------------------------------------
    def _us(self, t_pc: float) -> float:
        return (t_pc - self._t0) * 1e6

    def pc_from_walltime(self, t_wall: float) -> float:
        """Convert a ``time.time()`` stamp to the perf_counter clock."""
        return t_wall - self._epoch

    # -- emitters ----------------------------------------------------------
    def span(self, name: str, tid: int = TID_ENGINE, **args) -> _Span:
        return _Span(self, name, tid, args)

    def complete(self, name: str, t0: float, t1: float,
                 tid: int = TID_ENGINE, **args) -> None:
        """Record a complete event from perf_counter stamps ``t0..t1``."""
        self._raw.append(("X", name, tid, t0, t1, args or None))

    def instant(self, name: str, tid: int = TID_ENGINE, **args) -> None:
        self._raw.append(("i", name, tid, time.perf_counter(), 0.0,
                          args or None))

    def counter(self, name: str, values: Dict[str, float]) -> None:
        """One counter sample (Perfetto renders each key as a series)."""
        self._raw.append(("C", name, 0, time.perf_counter(), 0.0, values))

    # -- materialization ---------------------------------------------------
    @property
    def events(self) -> List[Dict[str, Any]]:
        """The recorded events as Chrome-trace dicts, in emission order,
        each track's ``thread_name`` metadata at its first use (counter
        events carry no tid).  Rebuilt per access: read once, after the
        run."""
        out: List[Dict[str, Any]] = []
        named = set()
        for ph, name, tid, t0, t1, args in self._raw:
            if ph != "C" and tid not in named:
                named.add(tid)
                track = _TRACK_NAMES.get(tid, f"slot {tid - TID_SLOT0}")
                out.append({"name": "thread_name", "ph": "M", "pid": 0,
                            "tid": tid, "args": {"name": track}})
            if ph == "X":
                out.append({
                    "name": name, "cat": "serve", "ph": "X", "pid": 0,
                    "tid": tid, "ts": round(self._us(t0), 3),
                    "dur": round(max(0.0, (t1 - t0)) * 1e6, 3),
                    "args": args if args is not None else {}})
            elif ph == "i":
                out.append({
                    "name": name, "cat": "serve", "ph": "i", "s": "t",
                    "pid": 0, "tid": tid, "ts": round(self._us(t0), 3),
                    "args": args if args is not None else {}})
            else:
                out.append({
                    "name": name, "cat": "serve", "ph": "C", "pid": 0,
                    "ts": round(self._us(t0), 3), "args": args})
        return out

    def reset(self) -> None:
        """Drop recorded events (track names re-emit on next use); the
        clock keeps its origin.  Engines call this from ``reset_stats()``
        so that a post-warmup trace starts at the measured window."""
        self._raw.clear()

    # -- output ------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        """Chrome/Perfetto trace JSON (load in ui.perfetto.dev)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")

    def save_jsonl(self, path: str) -> None:
        """Structured event log: one JSON object per line, in emission
        order."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")


def signature(x):
    """A call signature: shape, dtype and device of a tensor or array,
    recursively for tuples (a cache's leaves), lists and dicts, the type
    of anything else (a scalar position's value never makes a new one)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.dtype, x.device)
    if isinstance(x, (tuple, list)):
        return tuple([signature(v) for v in x])
    if isinstance(x, np.ndarray):
        return (x.shape, x.dtype)
    if isinstance(x, dict):
        return tuple([(k, signature(v)) for k, v in x.items()])
    return type(x)


class TracedProgram:
    """One eager program the engine calls, with a jit-like cache probe.

    ``fn(*args)`` runs as it is.  While ``watch`` is set, each call also
    records the signature of its per-call arguments (``sig_args``, a
    slice; the default skips the leading weights) and the kernel
    libraries loaded during it, and :meth:`_cache_size` is the number of
    distinct signatures seen plus those libraries, the counterpart of
    ``jax.jit``'s trace count that :class:`RecompileSentinel` reads.
    Cost: a tuple per argument leaf (48 cache leaves on mamba2-130m) and
    two dict-size reads a call, so engines watch only when tracing or
    under ``strict_recompile``; an unwatched program reports no cache
    (size -1) and its sentinel is inert."""

    __slots__ = ("name", "fn", "sig_args", "watch", "signatures",
                 "libraries")

    def __init__(self, name: str, fn: Callable,
                 sig_args: slice = slice(1, None), watch: bool = True):
        self.name = name
        self.fn = fn
        self.sig_args = sig_args
        self.watch = watch
        self.signatures: set = set()
        self.libraries = 0

    def __call__(self, *args):
        if not self.watch:
            return self.fn(*args)
        n0 = build.loaded()
        out = self.fn(*args)
        self.libraries += build.loaded() - n0
        self.signatures.add(signature(args[self.sig_args]))
        return out

    def _cache_size(self) -> int:
        if not self.watch:
            return -1
        return len(self.signatures) + self.libraries


class RecompileError(RuntimeError):
    """A recompile sentinel tripped in strict mode."""


class RecompileSentinel:
    """Compile-once discipline as a checkable invariant.

    Wraps a program with a ``_cache_size()`` probe (a
    :class:`TracedProgram`); ``check()`` compares its current size with
    the armed baseline and counts growth as *trips*.  The first check (or
    :meth:`arm`) sets the baseline without counting, so warmup is free;
    engines re-arm on ``reset_stats()``.  In ``strict`` mode a trip
    raises :class:`RecompileError`.  A program without the probe makes
    the sentinel inert (``supported`` False, ``check()`` returns 0).

    ``program_id`` (a ``serve/program_registry`` id like ``p0:decode``)
    rides in the trip instant so that ``trace_report``'s recompile audit
    names the program.  A program still empty when armed lazy-arms at
    its first sight.
    """

    def __init__(self, name: str, fn, strict: bool = False, *,
                 program_id: Optional[str] = None):
        self.name = name
        self._fn = fn
        self._probe = getattr(fn, "_cache_size", None)
        self.strict = strict
        self.program_id = program_id
        self.trips = 0
        self._baseline: Optional[int] = None

    @property
    def supported(self) -> bool:
        return self._size() >= 0

    def _size(self) -> int:
        return self._probe() if self._probe is not None else -1

    def arm(self) -> None:
        """(Re)baseline at the current size; zero the trip count."""
        self._baseline = self._size()
        self.trips = 0

    def check(self, tracer: NullTracer = NULL_TRACER) -> int:
        """Count (and optionally raise on) growth since arming; returns
        the cumulative trip count."""
        n = self._size()
        if n < 0:
            return 0
        if self._baseline is None or (self._baseline < 1 and n > 0):
            # Lazy arm: the first time the program shows up, everything
            # it met so far is warmup.
            self._baseline = n
            return self.trips
        if n > self._baseline:
            new = n - self._baseline
            self._baseline = n
            self.trips += new
            extra = ({"program_id": self.program_id}
                     if self.program_id else {})
            tracer.instant("recompile", program=self.name, new_traces=new,
                           trips=self.trips, **extra)
            if self.strict:
                raise RecompileError(
                    f"program {self.name!r} met a new signature or built a "
                    f"kernel after warmup ({new} new, {self.trips} total "
                    f"trips)")
        return self.trips
