"""Runtime helpers (the port of ``repro.runtime``): the shared retry
backoff and the training restart loop, step-time monitors and the hang
watchdog, the fault injector, and the elastic re-shard of a train state
onto a mesh (one device's, or a mesh of ranks)."""
from repro_torch.runtime.elastic import RestartOutcome, RestartPolicy, \
    backoff_delay_s, reshard_state, run_with_restarts
from repro_torch.runtime.faults import (FAULT_KINDS, FaultEvent,
                                        FaultInjector, InjectedBackendError,
                                        as_injector, parse_plan)
from repro_torch.runtime.health import StepMonitor, StepRecord, Watchdog

__all__ = ["RestartOutcome", "RestartPolicy", "run_with_restarts",
           "reshard_state",
           "backoff_delay_s", "FAULT_KINDS", "FaultEvent", "FaultInjector",
           "InjectedBackendError", "as_injector", "parse_plan",
           "StepMonitor", "StepRecord", "Watchdog"]
