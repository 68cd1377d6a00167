"""Per-slot cache state pool (port of ``repro.serve.state_pool``).

The pool allocates the model's decode-state cache once, on the model's
device, for ``slots`` rows.  The wave engine takes one per wave as the
zero state its prefill starts from.  The row primitives (insert /
extract / reset / snapshot) that the continuous engine needs come with
that engine.
"""
from __future__ import annotations

import torch


class StatePool:
    """Slot-indexed decode-state arena for one model."""

    def __init__(self, model, slots: int, max_seq: int, dtype: torch.dtype):
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.dtype = dtype
        self.cache = model.init_cache(slots, max_seq, dtype)
