"""Runtime helpers (the port of ``repro.runtime``): the shared retry
backoff and the training restart loop, step-time monitors and the hang
watchdog, and the fault injector.  Elastic resharding is not ported: one
card has no mesh."""
from repro_torch.runtime.elastic import RestartOutcome, RestartPolicy, \
    backoff_delay_s, run_with_restarts
from repro_torch.runtime.faults import (FAULT_KINDS, FaultEvent,
                                        FaultInjector, InjectedBackendError,
                                        as_injector, parse_plan)
from repro_torch.runtime.health import StepMonitor, StepRecord, Watchdog

__all__ = ["RestartOutcome", "RestartPolicy", "run_with_restarts",
           "backoff_delay_s", "FAULT_KINDS", "FaultEvent", "FaultInjector",
           "InjectedBackendError", "as_injector", "parse_plan",
           "StepMonitor", "StepRecord", "Watchdog"]
