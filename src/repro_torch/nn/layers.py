"""Functional layers: linear (with an optional bias), RMSNorm and the
Gemma RMSNorm, RoPE, embeddings and the causal depthwise conv1d (ports of
``repro.nn.layers``).

Params are plain dicts of tensors; every function keeps the JAX
package's rounding points (fp32 interiors, output cast back to the
stream dtype).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.nn import quant
from repro_torch.nn.params import ParamSpec


def linear_specs(d_in: int, d_out: int, *, bias: bool = False) -> dict:
    specs = {"w": ParamSpec((d_in, d_out))}
    if bias:
        specs["b"] = ParamSpec((d_out,), init="zeros")
    return specs


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype; a quantized weight (``nn/quant.py``)
    goes through ``quant.qdot``.  With a bias ``b`` the product is taken
    in fp32, the bias added in fp32 and the sum cast once, as the JAX
    package does (``repro/nn/layers.py:33-45``); without one,
    ``torch.matmul`` in the stream dtype rounds its fp32 sums once too."""
    w = p["w"]
    if quant.is_quantized(w):
        y = quant.qdot(x, w)
    elif "b" in p:
        y = torch.matmul(x.float(), w.float())
    else:
        return torch.matmul(x, w.to(x.dtype))
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(x.dtype)


def norm_specs(d: int, *, norm_type: str = "rmsnorm") -> dict:
    """The Gemma RMSNorm stores ``scale - 1``, so it starts at zeros."""
    return {"scale": ParamSpec((d,), init="zeros"
                               if norm_type == "gemma_rmsnorm" else "ones")}


def norm(p: dict, x: torch.Tensor, *, norm_type: str = "rmsnorm",
         eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (``gemma_rmsnorm``: scale + 1) with an fp32 interior; the
    output is cast back."""
    if norm_type not in ("rmsnorm", "gemma_rmsnorm"):
        raise NotImplementedError(f"norm_type {norm_type!r} is not ported")
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    scale = p["scale"].float()
    if norm_type == "gemma_rmsnorm":
        scale = scale + 1.0
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


_ROPE_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    """The JAX package's fp32 frequencies (computed in numpy, as it does),
    moved to ``device`` once: a copy to the card waits for its stream."""
    key = (half, float(theta), torch.device(device))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        freqs = _ROPE_FREQS[key] = torch.from_numpy(
            1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
        ).to(device)
    return freqs


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding, the half-split form: x (..., seq, heads,
    head_dim); positions (..., seq).  Angles and the rotation in fp32,
    the output cast back."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, theta, x.device)
    angles = positions.float()[..., None] * freqs       # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def embed_specs(vocab: int, d: int) -> dict:
    return {"table": ParamSpec((vocab, d), scale=0.02)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied logits ``x @ table^T`` accumulated and returned in fp32."""
    table = p["table"].to(x.dtype)
    return torch.matmul(x.float(), table.float().t())


def conv1d_specs(d: int, width: int) -> dict:
    return {"w": ParamSpec((width, d), scale=0.5),
            "b": ParamSpec((d,), init="zeros")}


def causal_conv1d(p: dict, x: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, d); state: (b, width-1, d), the incoming tail (zeros when
    ``None``).  Returns (y (b, l, d), new_state (b, width-1, d))."""
    width = p["w"].shape[0]
    l = x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (b, l+w-1, d)
    w = p["w"].float()
    y = sum(xp[:, i:i + l].float() * w[i] for i in range(width))
    y = y + p["b"].float()
    return y.to(x.dtype), xp[:, l:]


def causal_conv1d_step(p: dict, x: torch.Tensor, state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of :func:`causal_conv1d` without the seq axis.

    x: (b, d); state: (b, width-1, d).  Returns (y (b, d), new_state).
    """
    win = torch.cat([state.to(x.dtype), x[:, None]], dim=1)  # (b, width, d)
    y = torch.sum(win.float() * p["w"].float()[None], dim=1) + p["b"].float()
    return y.to(x.dtype), win[:, 1:]
