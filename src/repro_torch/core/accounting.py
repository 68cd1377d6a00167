"""Accounting mode (the port of ``repro.core.accounting``): the JAX
package's switch that unrolls inner ``lax.scan`` loops so XLA's cost
analysis counts every iteration.

The port's loops are Python loops: every layer, chunk and microbatch
runs, and a dispatch mode sees each op it issues.  So nothing in the
model code consults :func:`inner_unroll`; the dry run
(``launch/dryrun.py``) enters :func:`unroll_inner_scans` around its
counting pass as JAX's does, and the flag keeps its semantics for code
that asks.
"""
from __future__ import annotations

import contextlib
import contextvars

_UNROLL: contextvars.ContextVar = contextvars.ContextVar(
    "unroll_inner_scans", default=False)


@contextlib.contextmanager
def unroll_inner_scans():
    token = _UNROLL.set(True)
    try:
        yield
    finally:
        _UNROLL.reset(token)


def inner_unroll(n_steps: int) -> int:
    """The unroll factor of an inner loop of ``n_steps``: all of them
    inside :func:`unroll_inner_scans`, else 1."""
    return n_steps if _UNROLL.get() else 1
