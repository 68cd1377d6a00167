"""Model configuration: the ``repro.models.base.ModelConfig`` fields that
the Mamba-1 and Mamba-2 families use, with ``dtype`` as a
``torch.dtype``."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.xamba import XambaConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Mamba subset of the JAX package's one-config-for-all-families."""

    name: str = "model"
    family: str = "mamba2"
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    tie_embeddings: bool = True

    # -- SSM (mamba / mamba2) -------------------------------------------------
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    chunk_size: int = 256
    dt_rank: int = 0              # 0 -> ceil(d_model/16) (mamba1)
    # mamba1 prefill: core/selective_scan.py mode (associative | sequential
    # | chunked).
    scan_mode: str = "associative"
    ssd_dtype: str = "float32"    # SSD big-matmul dtype (bf16 = perf mode)

    param_dtype: str = "bfloat16"
    # A one-token call with a state takes the prefill path, not the step.
    force_prefill_path: bool = False
    xamba: XambaConfig = XambaConfig()

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_decode_mode(self, mode: str) -> "ModelConfig":
        """Config with ``XambaConfig.decode`` overridden (CLI plumbing)."""
        return self.replace(xamba=dataclasses.replace(self.xamba,
                                                      decode=mode))

    def with_prefill_mode(self, mode: str) -> "ModelConfig":
        """Config with ``XambaConfig.prefill`` overridden (CLI plumbing)."""
        return self.replace(xamba=dataclasses.replace(self.xamba,
                                                      prefill=mode))

    def with_quant(self, mode: str) -> "ModelConfig":
        """Config with ``XambaConfig.quant`` overridden (CLI plumbing)."""
        return self.replace(xamba=dataclasses.replace(self.xamba,
                                                      quant=mode))
