"""Step-time health: straggler flags and a hang watchdog (the port's copy
of ``repro.runtime.health``).

:class:`StepMonitor` keeps a rolling window of step durations, flags a
step slower than ``straggler_factor`` x the window's median (after
``warmup_steps``) and reports cumulative counts from O(1) accumulators,
so a server's monitors stay constant-size however long it runs.
:class:`Watchdog` runs a thread that calls ``on_hang`` when ``pet()`` has
not been called for ``deadline_s``; it fires once a hang and latches
until the next ``pet()``.  The continuous engine pets it after each
program call's host sync; its ``on_hang`` only sets flags and counters
and writes the flight dump (host JSON): nothing on the watchdog thread
touches a tensor or launches work on the device.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StepRecord:
    step: int
    seconds: float
    straggler: bool


class StepMonitor:
    def __init__(self, window: int = 50, straggler_factor: float = 2.0,
                 warmup_steps: int = 3):
        self.window = window
        self.factor = straggler_factor
        self.warmup = warmup_steps
        # Rolling views, trimmed to ``window``...
        self.records: List[StepRecord] = []
        self._durations: List[float] = []
        # ...and cumulative accumulators for summary().
        self.total_steps = 0
        self.total_time_s = 0.0
        self.total_stragglers = 0
        self.max_s = 0.0

    def observe(self, step: Optional[int] = None,
                seconds: float = 0.0) -> StepRecord:
        """Record one step; ``step`` defaults to the cumulative count."""
        if step is None:
            step = self.total_steps
        baseline = self._durations[-self.window:]
        is_straggler = False
        if len(baseline) >= self.warmup:
            is_straggler = seconds > self.factor * statistics.median(
                baseline)
        self._durations.append(seconds)
        rec = StepRecord(step, seconds, is_straggler)
        self.records.append(rec)
        if len(self._durations) > self.window:
            del self._durations[:-self.window]
            del self.records[:-self.window]
        self.total_steps += 1
        self.total_time_s += seconds
        self.max_s = max(self.max_s, seconds)
        if is_straggler:
            self.total_stragglers += 1
        return rec

    @property
    def straggler_steps(self) -> List[int]:
        """Straggler step indices within the rolling window (the
        cumulative count is ``summary()['stragglers']``)."""
        return [r.step for r in self.records if r.straggler]

    def summary(self) -> dict:
        """Cumulative count, mean, max and stragglers over every step ever
        observed, and the rolling window's median."""
        if not self.total_steps:
            return {"steps": 0}
        return {
            "steps": self.total_steps,
            "mean_s": self.total_time_s / self.total_steps,
            "median_s": statistics.median(self._durations),
            "max_s": self.max_s,
            "stragglers": self.total_stragglers,
        }


class Watchdog:
    """Calls ``on_hang`` if ``pet()`` is not called within ``deadline_s``.

    The callback fires at most once a hang: after a fire the watchdog
    latches until the next ``pet()``, so a slow recovery is not re-entered
    by its own trigger.  ``fired`` stays True once any hang was seen."""

    def __init__(self, deadline_s: float,
                 on_hang: Optional[Callable[[], None]] = None):
        self.deadline_s = deadline_s
        self.on_hang = on_hang
        self._last = time.monotonic()
        self._stop = threading.Event()
        self.fired = False
        self._latched = False       # fired for the current hang; pet() clears
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def pet(self):
        self._last = time.monotonic()
        self._latched = False

    def _run(self):
        while not self._stop.wait(min(self.deadline_s / 4, 1.0)):
            if self._latched:
                continue
            if time.monotonic() - self._last > self.deadline_s:
                self.fired = True
                self._latched = True
                if self.on_hang:
                    self.on_hang()

    @property
    def alive(self) -> bool:
        """Whether the thread still runs (False after a joined ``stop``)."""
        return self._thread.is_alive()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
