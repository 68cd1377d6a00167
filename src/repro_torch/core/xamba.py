"""XAMBA technique configuration (a copy of ``repro.core.xamba``).

The mode names and their validation are the JAX package's, so a config
written for one package reads the same in the other.  The port runs a
subset of them:

* ``decode`` / ``prefill`` modes ``cumba``, ``pallas`` and
  ``pallas_interpret`` all go through the kernel wrappers
  (``kernels/ops.py``).  On the GPU the hot path is the hand-written
  kernel whatever the mode says; on the CPU it is the kernel's plain
  PyTorch version.
* ``naive`` (the unfused op chains), ``actiba=True`` (piecewise-linear
  activations) and ``quant != "none"`` (W8 weights) are not ported yet:
  :meth:`XambaConfig.require_ported` raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

CUMSUM_MODES = ("naive", "cumba", "pallas", "pallas_interpret")
REDUCE_MODES = ("naive", "reduba", "pallas", "pallas_interpret")
DECODE_MODES = ("naive", "cumba", "pallas", "pallas_interpret")
PREFILL_MODES = ("naive", "cumba", "pallas", "pallas_interpret")
QUANT_MODES = ("none", "w8", "w8_pallas", "w8_pallas_interpret")


@dataclasses.dataclass(frozen=True)
class XambaConfig:
    """Technique flags for the XAMBA operator remappings."""

    cumba: str = "cumba"
    reduba: str = "reduba"
    decode: str = "cumba"
    prefill: str = "cumba"
    actiba: bool = False
    actiba_segments: int = 32
    actiba_range: Tuple[float, float] = (-10.0, 10.0)
    actiba_adaptive: bool = True
    quant: str = "none"

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant mode {self.quant!r} not in {QUANT_MODES}")
        if self.cumba not in CUMSUM_MODES:
            raise ValueError(f"cumba mode {self.cumba!r} not in {CUMSUM_MODES}")
        if self.reduba not in REDUCE_MODES:
            raise ValueError(f"reduba mode {self.reduba!r} not in {REDUCE_MODES}")
        if self.decode not in DECODE_MODES:
            raise ValueError(f"decode mode {self.decode!r} not in {DECODE_MODES}")
        if self.prefill not in PREFILL_MODES:
            raise ValueError(
                f"prefill mode {self.prefill!r} not in {PREFILL_MODES}")
        if self.actiba_segments < 2:
            raise ValueError("actiba_segments must be >= 2")

    def require_ported(self) -> None:
        """Raise ``NotImplementedError`` for options the port lacks."""
        for field in ("decode", "prefill"):
            if getattr(self, field) == "naive":
                raise NotImplementedError(
                    f"{field} mode 'naive' (the unfused op chain) is not "
                    "ported yet")
        if self.actiba:
            raise NotImplementedError(
                "actiba=True (piecewise-linear activations) is not ported yet")
        if self.quant != "none":
            raise NotImplementedError(
                f"quant mode {self.quant!r} (W8 weights) is not ported yet")

    @classmethod
    def optimized(cls) -> "XambaConfig":
        """CumBA + ReduBA (paper step-2, exact numerics)."""
        return cls(cumba="cumba", reduba="reduba", decode="cumba",
                   prefill="cumba", actiba=False)
