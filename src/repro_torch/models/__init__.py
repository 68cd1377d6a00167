"""Models of the port."""
from repro_torch.models.base import ModelConfig
from repro_torch.models.registry import build_model

__all__ = ["ModelConfig", "build_model"]
