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
shardings.  A one-device mesh takes the state whole; on a mesh of ranks
(``launch/mesh.py``) each rank keeps its shards, and a rank that leaves
the mesh hands its shards over before it goes.  With ``shardings`` the
restart loop writes the gathered state on rank 0 and restores the
checkpoint onto whatever mesh the shardings name (``checkpoint/ckpt.py``).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import tempfile
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import Sharding, gather_like, \
    make_shardings, per_layer_specs, place, shard_like
from repro_torch.nn.params import tree_leaves, tree_map

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


@dataclasses.dataclass(frozen=True)
class _Like:
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    @property
    def padded(self) -> int:
        return -(-self.nbytes // 8) * 8


def _whole(state, old_sh, old_mesh, new_mesh) -> Optional[list]:
    """``[params, m, v, step]`` whole: gathered over ``old_mesh``'s groups
    by its members, then broadcast from world rank 0 to the world (one
    flat buffer of every leaf's bytes, each padded to 8) when ``new_mesh``
    holds ranks that ``old_mesh`` does not (both take ranks 0 to n - 1).
    ``None`` on a rank that gets nothing."""
    member = old_mesh.member
    whole = None
    if member:
        whole = [gather_like(state["params"], old_sh),
                 gather_like(state["opt"]["m"], old_sh),
                 gather_like(state["opt"]["v"], old_sh),
                 state["opt"]["step"]]
    if new_mesh.size <= old_mesh.size:
        return whole
    meta = collectives.broadcast_object(tree_map(
        lambda t: _Like(tuple(t.shape), t.dtype), whole) if member else None)
    likes = tree_leaves(meta)
    flat = None
    if member:
        flat = torch.cat([torch.nn.functional.pad(
            t.detach().contiguous().reshape(-1).view(torch.uint8),
            (0, x.padded - x.nbytes))
            for t, x in zip(tree_leaves(whole), likes)])
    dev = new_mesh.device if new_mesh.member else torch.device("cpu")
    flat = collectives.broadcast(
        flat, new_mesh, 0, ((sum(x.padded for x in likes),), torch.uint8),
        dev)
    pieces = iter(flat.split([x.padded for x in likes]))
    return tree_map(lambda x: next(pieces)[:x.nbytes].view(x.dtype)
                    .view(x.shape), meta)


def reshard_state(state: Any, specs: Any, new_mesh, old_mesh=None,
                  replicated=()) -> Any:
    """Place a train state (``{"params", "opt"}``, and any other entry
    as it is) onto ``new_mesh``: params and AdamW's ``m`` and ``v`` by
    the logical rules of ``specs`` (the model's ``param_specs()``;
    ``replicated`` axes left out of them), the step replicated (the
    elastic re-shard).  ``old_mesh``: the mesh of ranks ``state`` is
    sharded on (None: ``state`` is whole).  Every rank of the world calls
    this; a rank outside ``old_mesh`` passes ``state=None``, and a rank
    outside ``new_mesh`` gets ``None`` back."""
    param_sh, _ = make_shardings(per_layer_specs(specs), new_mesh,
                                 replicated)
    if old_mesh is not None and old_mesh.ranked:
        old_sh, _ = make_shardings(per_layer_specs(specs), old_mesh,
                                   replicated)
        whole = _whole(state, old_sh, old_mesh, new_mesh)
        if not new_mesh.member:
            return None
        params, m, v, step = whole
        state = dict(state or {}, params=params,
                     opt=dict((state or {}).get("opt", {}), m=m, v=v,
                              step=step))
    if getattr(new_mesh, "ranked", False) and not new_mesh.member:
        return None
    out = dict(state)
    out["params"] = shard_like(state["params"], param_sh)
    out["opt"] = dict(state["opt"])
    out["opt"].update(
        step=place(state["opt"]["step"], Sharding(new_mesh, ())),
        m=shard_like(state["opt"]["m"], param_sh),
        v=shard_like(state["opt"]["v"], param_sh))
    return out


def run_with_restarts(train_some_steps: Callable[[Any, int], Tuple[Any, int]],
                      init_state: Any,
                      policy: RestartPolicy,
                      save_every: int = 10,
                      target_steps: int = 100,
                      cfg=None, shardings=None) -> RestartOutcome:
    """Drive ``train_some_steps(state, start_step) -> (state, reached_step)``
    to ``target_steps`` with checkpoint / restart (``cfg``: the model's
    config, for checkpoints in the JAX layout, ``checkpoint/ckpt.py``;
    ``shardings``: the params' shardings on a mesh of ranks, whose every
    rank runs the loop: checkpoints are gathered and written by rank 0,
    and a restart restores onto these shardings' mesh, whatever mesh
    wrote the checkpoint).
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
        state, step, _ = ckpt.restore(policy.ckpt_dir, state, cfg=cfg,
                                      shardings=shardings)
        log.info("resumed from step %d", step)

    while step < target_steps:
        try:
            state, step = train_some_steps(state, step)
            ckpt.save(policy.ckpt_dir, step, state, cfg=cfg,
                      shardings=shardings)
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
                                              cfg=cfg, shardings=shardings)
            # else: restart from the initial state
    return RestartOutcome(state, step, restarts, crash_loop_steps)
