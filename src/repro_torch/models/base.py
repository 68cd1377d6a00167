"""Model configuration: the ``repro.models.base.ModelConfig`` fields that
the Mamba-1, Mamba-2, RecurrentGemma and dense transformer families use,
with ``dtype`` as a ``torch.dtype``; and the shared helpers
``chunk_positions`` and ``cross_entropy_loss``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.xamba import XambaConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def chunk_positions(index, batch: int, seq: int) -> np.ndarray:
    """(b, s) absolute positions (int64, on the host) of a prefill chunk
    whose first token sits at ``index`` (an int or ``(b,)``)."""
    idx = np.asarray(index, np.int64)
    if idx.ndim == 0:
        idx = np.full((batch,), idx, np.int64)
    return idx[:, None] + np.arange(seq, dtype=np.int64)[None, :]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 1e-4) -> Tuple[torch.Tensor, dict]:
    """Token-level CE with the z-loss; labels < 0 are ignored (the JAX
    package's ``cross_entropy_loss``)."""
    logits = logits.float()
    valid = labels >= 0
    labels_safe = labels.clamp_min(0)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse.square()
    denom = valid.sum().clamp_min(1)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    loss = torch.where(valid, nll, zero).sum() / denom
    hit = (logits.argmax(-1) == labels_safe).to(logits.dtype)
    acc = torch.where(valid, hit, zero).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The subset of the JAX package's one-config-for-all-families that the
    ported families read."""

    name: str = "model"
    family: str = "mamba2"
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    tie_embeddings: bool = True

    # -- attention (the transformer; recurrentgemma's local attention) --------
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    attn_probs_bf16: bool = False  # cast softmax probs to bf16 before PV

    # -- mlp ------------------------------------------------------------------
    d_ff: int = 2048
    mlp_type: str = "swiglu"      # swiglu | geglu

    # -- norms / embeddings ---------------------------------------------------
    norm_type: str = "rmsnorm"    # rmsnorm | gemma_rmsnorm
    embed_scale: bool = False     # gemma: x *= sqrt(d_model)

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

    # -- recurrentgemma -------------------------------------------------------
    lru_width: int = 0
    block_pattern: Tuple[str, ...] = ()   # e.g. ("recurrent", "recurrent",
    #                                       "attention")

    # -- transformer variants that are not ported (the model refuses them) ----
    moe: bool = False
    frontend: Optional[str] = None        # vision_stub | audio_stub

    # -- execution policies ---------------------------------------------------
    param_dtype: str = "bfloat16"
    # The JAX package's training / layout knobs, kept for parity: the port
    # never rematerializes and always walks its layers in a Python loop.
    remat: str = "none"
    scan_layers: bool = True
    # Whole-sequence attention without a logit soft-cap runs the flash
    # attention kernel (TPU kernel 9; ``nn/attention.py: full_attention``).
    use_flash: bool = False
    # Kept as a name only: the device decides what runs (the kernel on a
    # CUDA tensor, its plain version on a CPU one), as with the
    # ``pallas_interpret`` modes.
    flash_interpret: bool = False
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
