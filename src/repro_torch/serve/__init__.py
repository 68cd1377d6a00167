"""Serving subsystem of the port: the wave engine over a state pool.

:class:`Engine` (``engine.py``) batches requests into lockstep waves;
:class:`Scheduler` admits them, :class:`StatePool` allocates the decode
state on the model's device, ``sampling`` picks tokens (numpy, the JAX
package's streams) and :class:`ServeMetrics` keeps TTFT, occupancy and
goodput.  The continuous engine is not ported yet.
"""
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.state_pool import StatePool

__all__ = ["Engine", "ServeConfig", "ServeMetrics", "Request", "Scheduler",
           "StatePool"]
