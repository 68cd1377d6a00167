"""Per-slot cache state pool (port of ``repro.serve.state_pool``).

The pool allocates the model's decode-state cache once, on the model's
device, for ``slots`` rows, and moves rows in and out of it:

* ``insert_rows``  — copy freshly prefilled rows into live slots,
* ``extract_rows`` — gather slot rows out,
* ``reset_rows``   — zero slot rows,
* ``clone_row`` / ``restore_row`` — snapshot one row and its inverse
  (``model.export_state`` / ``model.import_state``).

Where the JAX package donates the arena into compiled scatters, the port
writes the arena in place (``index_copy_`` / ``index_fill_`` along each
leaf's batch axis, ``model.cache_batch_axes``).  Rows that are extracted
or cloned are fresh tensors, never views of the arena.  An engine step
returns a new cache and the engine rebinds ``pool.cache`` to it, so the
row ops always act on the live arena.  The wave engine takes one pool per
wave as the zero state its prefill starts from; the continuous engine
keeps a decode pool and, under chunked prefill, a staging pool.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.serve.tracing import NULL_TRACER, TracedProgram


def insert_rows(cache, src_cache, src: torch.Tensor, dst: torch.Tensor,
                axes):
    """Copy ``src_cache`` rows ``src`` into ``cache`` rows ``dst`` in
    place along each leaf's batch axis; returns ``cache``."""
    for leaf, s, ax in zip(cache, src_cache, axes):
        leaf.index_copy_(ax, dst, s.index_select(ax, src).to(leaf.dtype))
    return cache


def extract_rows(cache, idx: torch.Tensor, axes):
    """Rows ``idx`` of ``cache`` as a fresh cache."""
    return type(cache)(*(leaf.index_select(ax, idx)
                         for leaf, ax in zip(cache, axes)))


def reset_rows(cache, idx: torch.Tensor, axes):
    """Zero rows ``idx`` of ``cache`` in place; returns ``cache``."""
    for leaf, ax in zip(cache, axes):
        leaf.index_fill_(ax, idx, 0)
    return cache


class StatePool:
    """Slot-indexed decode-state arena for one model.

    ``tracer`` (``serve/tracing.py``) gets the JAX pool's spans:
    ``pool_insert``, ``pool_reset``, ``snapshot_export`` and
    ``snapshot_restore``; they time the host's dispatch of the row copies
    (no sync is taken).  The insert and reset calls go through
    :class:`TracedProgram` wrappers (``insert_program``,
    ``reset_program``) whose signatures the engine's ``pool_insert`` and
    ``pool_reset`` recompile sentinels read while ``watch`` is set: a
    source cache of another shape is a new one, the row indices are
    not."""

    def __init__(self, model, slots: int, max_seq: int, dtype: torch.dtype,
                 tracer=NULL_TRACER, watch: bool = False):
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.dtype = dtype
        self.tracer = tracer
        self.cache = model.init_cache(slots, max_seq, dtype)
        self.axes = model.cache_batch_axes(self.cache)
        self.insert_program = TracedProgram("pool_insert", insert_rows,
                                            slice(1, 2), watch)
        self.reset_program = TracedProgram("pool_reset", reset_rows,
                                           slice(0, 0), watch)

    def _index(self, rows: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(rows), dtype=torch.long,
                               device=self.cache[0].device)

    def insert_rows(self, src_cache, src_rows: Sequence[int],
                    slots: Sequence[int]) -> None:
        """Copy ``src_cache`` row ``src_rows[i]`` into slot ``slots[i]``."""
        with self.tracer.span("pool_insert", rows=len(slots)):
            self.insert_program(self.cache, src_cache,
                                self._index(src_rows), self._index(slots),
                                self.axes)

    def extract_rows(self, slots: Sequence[int]):
        """Slot rows as a fresh cache with batch ``len(slots)``."""
        return extract_rows(self.cache, self._index(slots), self.axes)

    def reset_rows(self, slots: Sequence[int]) -> None:
        """Zero slot rows."""
        with self.tracer.span("pool_reset", rows=len(slots)):
            self.reset_program(self.cache, self._index(slots), self.axes)

    def clone_row(self, slot: int, index=None):
        """Snapshot of one slot row (``model.export_state``)."""
        with self.tracer.span("snapshot_export", slot=slot):
            return self.model.export_state(self.cache, index, [slot])

    def restore_row(self, slot: int, snapshot, index=None) -> None:
        """Write a :meth:`clone_row` snapshot back into one slot row."""
        with self.tracer.span("snapshot_restore", slot=slot):
            self.cache = self.model.import_state(self.cache, index, [slot],
                                                 snapshot)
