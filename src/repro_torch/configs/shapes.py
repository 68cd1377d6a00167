"""Assigned input shapes and abstract input builders for the dry run (the
port of ``repro.configs.shapes``).

Every LM-family arch is paired with four shape cells:

  train_4k     seq=4096    batch=256   -> train_step
  prefill_32k  seq=32768   batch=32    -> prefill
  decode_32k   seq=32768   batch=128   -> decode_step (1 token, full cache)
  long_500k    seq=524288  batch=1     -> decode_step; SSM/hybrid archs only

The builders return tensors on ``meta`` (shape and dtype, nothing
allocated), the port's stand-ins for the JAX package's
``ShapeDtypeStruct``; token ids are int64, the dtype the port's
embeddings index with (JAX's are int32).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# Archs with a sub-quadratic sequence path (may run long_500k).
SUBQUADRATIC_FAMILIES = ("mamba", "mamba2", "recurrentgemma")

TOKEN_DTYPE = torch.int64


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return ("pure full-attention arch: O(L^2) attention at 524k is "
                "out of scope per assignment (sub-quadratic archs only)")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _stubs(cfg: ModelConfig, b: int, s: int) -> tuple:
    """(whisper's frames or llava's image_embeds, when the arch takes
    them; the text length that leaves)."""
    out = {}
    if cfg.family == "whisper":
        out["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    elif cfg.frontend == "vision_stub":
        out["image_embeds"] = _meta((b, cfg.num_patches, cfg.d_model),
                                    cfg.dtype)
        s = max(s - cfg.num_patches, 1)  # patches + text = the shape's seq
    return out, s


def batch_inputs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Abstract batch for ``loss`` / ``train_step``: tokens + labels (+
    stubs)."""
    b = shape.global_batch
    out, s = _stubs(cfg, b, shape.seq_len)
    out["tokens"] = _meta((b, s), TOKEN_DTYPE)
    out["labels"] = _meta((b, s), TOKEN_DTYPE)
    return out


def prefill_inputs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b = shape.global_batch
    out, s = _stubs(cfg, b, shape.seq_len)
    out["tokens"] = _meta((b, s), TOKEN_DTYPE)
    return out


def decode_inputs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return {"token": _meta((shape.global_batch, 1), TOKEN_DTYPE)}


def abstract_cache(model, cfg: ModelConfig, shape: ShapeSpec,
                   dtype: torch.dtype = torch.bfloat16):
    """``model.init_cache`` on ``meta``: the cache's leaves' shapes and
    dtypes, nothing allocated.  ``model`` must be built on ``meta``."""
    if model.device.type != "meta":
        raise ValueError(f"abstract_cache takes a model on meta, not "
                         f"{model.device}")
    return model.init_cache(shape.global_batch, shape.seq_len, dtype)
