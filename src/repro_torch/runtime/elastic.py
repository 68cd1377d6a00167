"""Fault tolerance: the checkpoint / restart loop and the shared retry
backoff (the port of ``repro.runtime.elastic``).

``run_with_restarts`` drives a training function under a crash policy:
any exception falls back to the latest atomic checkpoint and resumes, up
to ``max_restarts``, with exponential backoff between restarts
(``backoff_delay_s``, the same helper the serve-side retries in
``serve/continuous.py`` use).  A step that fails twice in a row is
*crash-loop* territory — deterministic poison, not a transient fault —
and gets a distinct log line plus an entry in the returned
``crash_loop_steps``.  Combined with :func:`reshard_state` a restart may
come back on another mesh: the state is placed onto the new mesh's
shardings.  On one card that mesh spans the card (or the CPU), so
resharding moves the state whole onto its device; a mesh wider than the
devices raises where it is made (``launch/mesh.py: make_mesh``).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

from repro_torch.checkpoint import ckpt
from repro_torch.distributed.sharding import Sharding, make_shardings, \
    per_layer_specs, place, shard_like

log = logging.getLogger(__name__)


def backoff_delay_s(attempt: int, base_s: float = 0.5,
                    cap_s: float = 30.0) -> float:
    """Exponential backoff: ``base * 2**(attempt-1)`` seconds for the
    ``attempt``-th retry (1-based), capped at ``cap_s``; 0 for
    ``attempt <= 0``.  Deterministic (no jitter), so retry schedules are
    reproducible in tests."""
    if attempt <= 0 or base_s <= 0:
        return 0.0
    return min(cap_s, base_s * (2.0 ** (attempt - 1)))


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 3
    # The JAX package's ``/tmp/repro_ckpt``, under this process's temp dir.
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    # Exponential backoff between restarts (``backoff_delay_s``); 0
    # disables the sleep (tests).
    backoff_base_s: float = 0.0
    backoff_cap_s: float = 30.0


class RestartOutcome(NamedTuple):
    """``run_with_restarts`` result: final state, step reached, restart
    count, and the steps at which a crash loop was detected (the same
    step failing twice consecutively — empty means every crash was
    transient)."""
    state: Any
    step: int
    restarts: int
    crash_loop_steps: List[int]


def reshard_state(state: Any, specs: Any, new_mesh) -> Any:
    """Place a train state (``{"params", "opt"}``, and any other entry
    as it is) onto ``new_mesh``: params and AdamW's ``m`` and ``v`` by
    the logical rules of ``specs`` (the model's ``param_specs()``), the
    step replicated (the elastic re-shard)."""
    param_sh, _ = make_shardings(per_layer_specs(specs), new_mesh)
    out = dict(state)
    out["params"] = shard_like(state["params"], param_sh)
    out["opt"] = {
        "step": place(state["opt"]["step"], Sharding(new_mesh, ())),
        "m": shard_like(state["opt"]["m"], param_sh),
        "v": shard_like(state["opt"]["v"], param_sh),
    }
    return out


def run_with_restarts(train_some_steps: Callable[[Any, int], Tuple[Any, int]],
                      init_state: Any,
                      policy: RestartPolicy,
                      save_every: int = 10,
                      target_steps: int = 100,
                      cfg=None) -> RestartOutcome:
    """Drive ``train_some_steps(state, start_step) -> (state, reached_step)``
    to ``target_steps`` with checkpoint / restart (``cfg``: the model's
    config, for checkpoints in the JAX layout, ``checkpoint/ckpt.py``).
    Restarts back off exponentially (``policy.backoff_base_s``); a step
    that fails twice in a row is logged as a crash loop and recorded in
    the returned ``crash_loop_steps`` (the loop still retries up to
    ``max_restarts`` — the caller decides whether a crash loop is
    fatal)."""
    restarts = 0
    state = init_state
    step = 0
    last_failed_step: Optional[int] = None
    consecutive_at_step = 0
    crash_loop_steps: List[int] = []
    # resume if a checkpoint exists
    last = ckpt.latest_step(policy.ckpt_dir)
    if last is not None:
        state, step, _ = ckpt.restore(policy.ckpt_dir, state, cfg=cfg)
        log.info("resumed from step %d", step)

    while step < target_steps:
        try:
            state, step = train_some_steps(state, step)
            ckpt.save(policy.ckpt_dir, step, state, cfg=cfg)
            last_failed_step = None
            consecutive_at_step = 0
        except Exception as e:  # noqa: BLE001 — the restart boundary
            restarts += 1
            if step == last_failed_step:
                consecutive_at_step += 1
            else:
                last_failed_step = step
                consecutive_at_step = 1
            if consecutive_at_step >= 2:
                # Same step, twice in a row: a deterministic fault, not a
                # transient one — restarting harder will not help.
                if step not in crash_loop_steps:
                    crash_loop_steps.append(step)
                log.error(
                    "CRASH LOOP: step %d failed %d times consecutively "
                    "(%s) — likely deterministic; restart %d/%d", step,
                    consecutive_at_step, e, restarts, policy.max_restarts)
            else:
                log.warning("step loop failed at ~%d: %s (restart %d/%d)",
                            step, e, restarts, policy.max_restarts)
            if restarts > policy.max_restarts:
                raise
            delay = backoff_delay_s(restarts, policy.backoff_base_s,
                                    policy.backoff_cap_s)
            if delay:
                log.info("backing off %.2fs before restart", delay)
                time.sleep(delay)
            last = ckpt.latest_step(policy.ckpt_dir)
            if last is not None:
                state, step, _ = ckpt.restore(policy.ckpt_dir, state,
                                              cfg=cfg)
            # else: restart from the initial state
    return RestartOutcome(state, step, restarts, crash_loop_steps)
