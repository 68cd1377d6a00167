"""Model factory: family -> model class."""
from __future__ import annotations

from repro_torch.core.device import DeviceLike
from repro_torch.models.base import ModelConfig
from repro_torch.models.mamba_lm import MambaLM
from repro_torch.models.recurrentgemma import RecurrentGemma
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.whisper import Whisper

_FAMILIES = {"mamba": MambaLM, "mamba2": MambaLM,
             "recurrentgemma": RecurrentGemma, "transformer": TransformerLM,
             "whisper": Whisper}


def build_model(cfg: ModelConfig, device: DeviceLike = None):
    """The model for ``cfg`` on ``device`` (default ``cuda``)."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; "
            f"have {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family](cfg, device)
