"""Retry backoff shared by the serve stack's requeues (the port's copy of
``repro.runtime.elastic.backoff_delay_s``; the training restart loop and
resharding that share it in the JAX package come with training)."""
from __future__ import annotations


def backoff_delay_s(attempt: int, base_s: float = 0.5,
                    cap_s: float = 30.0) -> float:
    """Exponential backoff: ``base * 2**(attempt-1)`` seconds for the
    ``attempt``-th retry (1-based), capped at ``cap_s``; 0 for
    ``attempt <= 0``.  Deterministic (no jitter), so retry schedules are
    reproducible in tests."""
    if attempt <= 0 or base_s <= 0:
        return 0.0
    return min(cap_s, base_s * (2.0 ** (attempt - 1)))
