"""Model configurations of the port."""
from repro_torch.configs.registry import get_config

__all__ = ["get_config"]
