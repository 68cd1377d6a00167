"""Serving subsystem of the port: the wave and continuous engines over a
state pool.

:class:`Engine` (``engine.py``) batches requests into lockstep waves;
:class:`ContinuousEngine` (``continuous.py``) refills slots mid-decode,
with monolithic or chunked prefill, self-speculative bursts
(``speculative.py``) and the prefix-state cache (``prefix_cache.py``).
:class:`Scheduler` admits requests, :class:`StatePool` holds the decode
state on the model's device and moves its rows, ``sampling`` picks
tokens (numpy, the JAX package's streams) and :class:`ServeMetrics` keeps
TTFT, occupancy, goodput and the speculation and prefix-cache counters,
with windowed gauges and periodic snapshots.  :class:`Tracer` records the
JAX package's span taxonomy (Chrome/Perfetto JSON + JSONL, folded by
``launch/trace_report.py``), :class:`RecompileSentinel` checks that no
program meets a new signature or builds a kernel after warmup, and
``program_registry`` gives each program an id and, on demand, a cost
card.

Fault tolerance (the JAX package's): ``ServeConfig.fault_plan`` threads a
:class:`~repro_torch.runtime.faults.FaultInjector` schedule through the
continuous engine; ``max_queue_depth`` bounds admission with explicit
backpressure, ``overload_queue_depth`` adds a degraded overload mode,
``poison_probe`` quarantines NaN / Inf slots, ``watchdog_action="recover"``
escalates the hang watchdog to a recovery with bounded retries, and
:class:`FlightRecorder` dumps the last request timelines on each fault.
There is no backend fallback: a failed kernel raises.
"""
from repro_torch.runtime.faults import FaultEvent, FaultInjector, \
    InjectedBackendError, parse_plan
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.flight_recorder import FlightRecorder, load_flight
from repro_torch.serve.metrics import RateMeter, ServeMetrics, \
    StreamingHistogram, WindowedGauge
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.speculative import accept_lengths, emit_counts, \
    needs_rollback
from repro_torch.serve.state_pool import StatePool
from repro_torch.serve.tracing import NULL_TRACER, NullTracer, \
    RecompileError, RecompileSentinel, Tracer

__all__ = ["FaultEvent", "FaultInjector", "InjectedBackendError",
           "parse_plan", "FlightRecorder", "load_flight",
           "ContinuousEngine", "Engine", "ServeConfig", "ServeMetrics",
           "StreamingHistogram", "WindowedGauge", "RateMeter",
           "PrefixCache", "Request", "Scheduler", "StatePool",
           "accept_lengths", "emit_counts", "needs_rollback", "NULL_TRACER",
           "NullTracer", "RecompileError", "RecompileSentinel", "Tracer"]
