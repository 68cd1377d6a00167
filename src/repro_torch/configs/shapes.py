"""``ShapeSpec`` of the JAX package's ``repro.configs.shapes``: the fields
``launch/flops.py`` reads.  Its shape cells and abstract input builders
(the dry-run's) are not ported."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

