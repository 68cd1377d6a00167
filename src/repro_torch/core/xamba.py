"""XAMBA technique configuration (a copy of ``repro.core.xamba``).

The mode names, presets and validation are the JAX package's, so a
config written for one package reads the same in the other.  How the
port runs them:

* ``decode`` / ``prefill`` modes ``cumba``, ``pallas`` and
  ``pallas_interpret`` go through the fused kernel wrappers
  (``kernels/ops.py``): the hand-written kernel on the GPU, its plain
  PyTorch version on the CPU.  ``naive`` runs the unfused op chains
  (``nn/ssm.py``), as does a prefill shape the fused path does not take.
* ``cumba`` / ``reduba`` pick how the unfused chain's cumulative sums and
  contractions run (``core/segsum.py``, ``core/reduce.py``); ``pallas``
  there means the hand-written ``cumsum_last`` and ``ssd_chunk`` kernels.
* ``actiba=True`` swaps SiLU and softplus for their piecewise-linear
  tables (``core/pwl.py``), inside the fused kernels and elementwise in
  the unfused chain.
* ``quant`` (W8 weights): the CLI and callers quantize the params with
  ``nn/quant.py: quantize_params_for_mode``; every mode applies a
  quantized weight through ``quant.qdot``, the hand-written ``qmatmul``
  kernel on the GPU (whatever its backend tag) and the JAX XLA backend's
  arithmetic on the CPU.
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

    # ---- presets (the JAX package's) ---------------------------------------
    @classmethod
    def baseline(cls) -> "XambaConfig":
        """The unoptimized NPU-style execution (paper's baseline)."""
        return cls(cumba="naive", reduba="naive", decode="naive",
                   prefill="naive", actiba=False)

    @classmethod
    def optimized(cls) -> "XambaConfig":
        """CumBA + ReduBA (paper step-2, exact numerics)."""
        return cls(cumba="cumba", reduba="reduba", decode="cumba",
                   prefill="cumba", actiba=False)

    @classmethod
    def full(cls, segments: int = 32) -> "XambaConfig":
        """CumBA + ReduBA + ActiBA (paper step-2 + step-3)."""
        return cls(cumba="cumba", reduba="reduba", decode="cumba",
                   prefill="cumba", actiba=True, actiba_segments=segments)

    @classmethod
    def pallas(cls, interpret: bool = False) -> "XambaConfig":
        """Kernel-backed variants: the hand-written kernels on the GPU
        (``interpret`` only names the mode; the CPU runs the plain
        versions either way)."""
        mode = "pallas_interpret" if interpret else "pallas"
        return cls(cumba=mode, reduba=mode, decode=mode, prefill=mode,
                   actiba=True)
