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


class StatePool:
    """Slot-indexed decode-state arena for one model."""

    def __init__(self, model, slots: int, max_seq: int, dtype: torch.dtype):
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.dtype = dtype
        self.cache = model.init_cache(slots, max_seq, dtype)

    def _index(self, rows: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(rows), dtype=torch.long,
                               device=self.cache[0].device)

    def _axes(self):
        return self.model.cache_batch_axes(self.cache)

    def insert_rows(self, src_cache, src_rows: Sequence[int],
                    slots: Sequence[int]) -> None:
        """Copy ``src_cache`` row ``src_rows[i]`` into slot ``slots[i]``."""
        src, dst = self._index(src_rows), self._index(slots)
        for leaf, s, ax in zip(self.cache, src_cache, self._axes()):
            leaf.index_copy_(ax, dst, s.index_select(ax, src).to(leaf.dtype))

    def extract_rows(self, slots: Sequence[int]):
        """Slot rows as a fresh cache with batch ``len(slots)``."""
        idx = self._index(slots)
        return type(self.cache)(*(leaf.index_select(ax, idx) for leaf, ax in
                                  zip(self.cache, self._axes())))

    def reset_rows(self, slots: Sequence[int]) -> None:
        """Zero slot rows."""
        idx = self._index(slots)
        for leaf, ax in zip(self.cache, self._axes()):
            leaf.index_fill_(ax, idx, 0)

    def clone_row(self, slot: int, index=None):
        """Snapshot of one slot row (``model.export_state``)."""
        return self.model.export_state(self.cache, index, [slot])

    def restore_row(self, slot: int, snapshot, index=None) -> None:
        """Write a :meth:`clone_row` snapshot back into one slot row."""
        self.cache = self.model.import_state(self.cache, index, [slot],
                                             snapshot)
