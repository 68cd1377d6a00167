"""Serving subsystem of the port: the wave and continuous engines over a
state pool.

:class:`Engine` (``engine.py``) batches requests into lockstep waves;
:class:`ContinuousEngine` (``continuous.py``) refills slots mid-decode,
with monolithic or chunked prefill.  :class:`Scheduler` admits requests,
:class:`StatePool` holds the decode state on the model's device and moves
its rows, ``sampling`` picks tokens (numpy, the JAX package's streams) and
:class:`ServeMetrics` keeps TTFT, occupancy and goodput.
"""
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.state_pool import StatePool

__all__ = ["ContinuousEngine", "Engine", "ServeConfig", "ServeMetrics",
           "Request", "Scheduler", "StatePool"]
