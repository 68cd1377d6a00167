"""Fault injection for the serve stack (the port's copy of
``repro.runtime.faults``: the same kinds, plan grammar, error messages and
seeded payloads).

Faults are events on the continuous engine's poll clock, threaded in
through ``ServeConfig.fault_plan``; each fires once, at the first chance
from its poll on, so a chaotic run is reproducible and comparable with a
fault-free control run:

====================  =====================================================
``poison``            overwrite one live slot's state with NaN / Inf; the
                      engine's poison probes must contain it
``fail``              raise :class:`InjectedBackendError` before one
                      program launches anything; the port has no backend
                      fallback, so the error leaves ``poll()``
``stall``             sleep inside one program call's timing window; the
                      step monitor must see it, and past ``watchdog_s``
                      the watchdog fires
``snap_drop``         drop one prefix-cache snapshot insert (a lost write)
``snap_corrupt``      corrupt one prefix-cache snapshot before its insert;
                      the poison gate must refuse it
====================  =====================================================

``summary()`` reports what fired, so a test can assert that the plan ran.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger("repro_torch.serve")

FAULT_KINDS = ("poison", "fail", "stall", "snap_drop", "snap_corrupt")


class InjectedBackendError(RuntimeError):
    """Simulated failure of a program call (a kernel crash, a lost
    device)."""


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault.  ``poll`` is the engine poll index at which
    the fault arms; it fires at the first chance from that poll on (a
    ``poison`` needs a live slot) and then never again."""
    kind: str
    poll: int
    slot: int = 0                 # poison: target slot (clamped to live)
    program: str = "decode"       # fail / stall: which program
    stall_s: float = 0.1          # stall: the injected sleep
    mode: str = "nan"             # poison / snap_corrupt payload: nan | inf
    fired: bool = False

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        if self.mode not in ("nan", "inf"):
            raise ValueError(f"poison mode {self.mode!r} not in (nan, inf)")


def _parse_event(token: str) -> FaultEvent:
    """One spec token: ``kind@poll[:k=v[,k=v...]]``, e.g.
    ``poison@5:slot=1,mode=inf`` or ``fail@8:program=decode``."""
    head, _, tail = token.partition(":")
    kind, _, at = head.partition("@")
    if not at:
        raise ValueError(
            f"fault spec {token!r}: expected kind@poll[:k=v,...]")
    kw = {}
    if tail:
        for pair in tail.split(","):
            k, _, v = pair.partition("=")
            if k in ("slot", "poll"):
                kw[k] = int(v)
            elif k == "stall_s":
                kw[k] = float(v)
            elif k in ("program", "mode"):
                kw[k] = v
            else:
                raise ValueError(f"fault spec {token!r}: unknown key {k!r}")
    return FaultEvent(kind=kind.strip(), poll=int(at), **kw)


def parse_plan(spec: str) -> List[FaultEvent]:
    """A plan spec: ``;``-separated event tokens (:func:`_parse_event`);
    whitespace is ignored."""
    return [_parse_event(tok.strip())
            for tok in spec.split(";") if tok.strip()]


def _map_leaves(fn, tree):
    """``fn`` over a snapshot's leaves (tuples, named tuples, lists and
    dicts nest; dict keys in sorted order, as ``jax.tree.map`` visits
    them), the structure kept."""
    if isinstance(tree, dict):
        out = {k: _map_leaves(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, x) for x in tree)
    return fn(tree)


class FaultInjector:
    """Schedule-driven fault injector for one engine.

    ``plan`` is a sequence of :class:`FaultEvent` or a spec string
    (:func:`parse_plan`).  ``seed`` derives the poison payloads (seeded
    noise with NaN / Inf sprinkled in, so no probe passes by accident of a
    special value): the JAX package's ``np.random.default_rng(seed)``
    sequence, so a seed gives the same fp32 payload in both packages.
    The hooks are host-side list scans over the plan."""

    def __init__(self, plan: Iterable[FaultEvent] | str, seed: int = 0):
        if isinstance(plan, str):
            plan = parse_plan(plan)
        self.plan: List[FaultEvent] = list(plan)
        for ev in self.plan:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"fault plan entries must be FaultEvent, "
                                f"got {type(ev).__name__}")
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    # -- hooks (called by ContinuousEngine) --------------------------------
    def _due(self, kind: str, poll: int,
             program: Optional[str] = None) -> Optional[FaultEvent]:
        for ev in self.plan:
            if (ev.kind == kind and not ev.fired and poll >= ev.poll and
                    (program is None or ev.program == program)):
                return ev
        return None

    def poison_targets(self, poll: int,
                       live_slots: Sequence[int]) -> List[Tuple[int, str]]:
        """Due ``poison`` events as ``[(slot, mode)]``.  A poison waits for
        a live slot (a dead row's corruption would be invisible); the
        target clamps onto the live set deterministically."""
        out = []
        while True:
            ev = self._due("poison", poll)
            if ev is None or not live_slots:
                return out
            slot = (ev.slot if ev.slot in live_slots
                    else live_slots[ev.slot % len(live_slots)])
            ev.fired = True
            log.warning("FAULT INJECTED: poison(%s) slot %d at poll %d",
                        ev.mode, slot, poll)
            out.append((slot, ev.mode))

    def poison_payload(self, shape, mode: str) -> np.ndarray:
        """Seeded fp32 payload: noise with NaN / Inf at ~25%% of the
        positions (at least one)."""
        x = self._rng.standard_normal(shape).astype(np.float32)
        bad = self._rng.random(shape) < 0.25
        flat = bad.reshape(-1)
        if not flat.any():
            flat[self._rng.integers(flat.size)] = True
        x[bad.reshape(x.shape)] = np.nan if mode == "nan" else np.inf
        return x

    def corrupt(self, snapshot, mode: str = "nan"):
        """The snapshot (``StatePool.clone_row``'s tensors) with every
        floating leaf replaced by a payload in the leaf's dtype on the
        leaf's device; other leaves are returned as they are."""
        def leaf(x):
            if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
                return x
            payload = self.poison_payload(tuple(x.shape), mode)
            return torch.from_numpy(payload).to(x.device, x.dtype)

        return _map_leaves(leaf, snapshot)

    def pre_call(self, program: str, poll: int) -> None:
        """Hook before a program launches anything: stall (sleep inside
        the call's timing window) and / or raise a simulated failure."""
        ev = self._due("stall", poll, program)
        if ev is not None:
            ev.fired = True
            log.warning("FAULT INJECTED: stall %.3fs in %s at poll %d",
                        ev.stall_s, program, poll)
            time.sleep(ev.stall_s)
        ev = self._due("fail", poll, program)
        if ev is not None:
            ev.fired = True
            log.warning("FAULT INJECTED: %s backend failure at poll %d",
                        program, poll)
            raise InjectedBackendError(
                f"injected {program} failure at poll {poll}")

    def snapshot_fault(self, poll: int) -> Optional[str]:
        """Due prefix-snapshot fault for an insert this poll: ``"drop"``,
        ``"corrupt"`` or None."""
        ev = self._due("snap_drop", poll)
        if ev is not None:
            ev.fired = True
            log.warning("FAULT INJECTED: snapshot drop at poll %d", poll)
            return "drop"
        ev = self._due("snap_corrupt", poll)
        if ev is not None:
            ev.fired = True
            log.warning("FAULT INJECTED: snapshot corrupt at poll %d", poll)
            return "corrupt"
        return None

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        """Fired and pending counts by kind."""
        fired = {k: 0 for k in FAULT_KINDS}
        pending = {k: 0 for k in FAULT_KINDS}
        for ev in self.plan:
            (fired if ev.fired else pending)[ev.kind] += 1
        return {"fired": {k: v for k, v in fired.items() if v},
                "pending": {k: v for k, v in pending.items() if v},
                "events": len(self.plan)}


def as_injector(plan) -> Optional[FaultInjector]:
    """``ServeConfig.fault_plan`` (None, a FaultInjector, a spec string or
    an iterable of FaultEvent) as a FaultInjector, or None."""
    if plan is None:
        return None
    if isinstance(plan, FaultInjector):
        return plan
    return FaultInjector(plan)
