"""Runtime helpers of the port's serve stack (the JAX package's
``repro.runtime``, serving part): the shared retry backoff, step-time
monitors and the hang watchdog, and the fault injector.  The training
restart loop and elastic resharding come with training."""
from repro_torch.runtime.elastic import backoff_delay_s
from repro_torch.runtime.faults import (FAULT_KINDS, FaultEvent,
                                        FaultInjector, InjectedBackendError,
                                        as_injector, parse_plan)
from repro_torch.runtime.health import StepMonitor, StepRecord, Watchdog

__all__ = ["backoff_delay_s", "FAULT_KINDS", "FaultEvent", "FaultInjector",
           "InjectedBackendError", "as_injector", "parse_plan",
           "StepMonitor", "StepRecord", "Watchdog"]
