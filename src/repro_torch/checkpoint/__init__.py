"""Atomic and asynchronous checkpoints in the JAX package's layout (the
port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.async_writer import AsyncCheckpointer  # noqa: F401
from repro_torch.checkpoint.ckpt import (all_steps, latest_step,  # noqa: F401
                                         restore, save)
