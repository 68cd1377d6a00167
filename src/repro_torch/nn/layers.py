"""Functional layers of the Mamba-2 path: linear, RMSNorm, embeddings and
the causal depthwise conv1d (ports of ``repro.nn.layers``).

Params are plain dicts of tensors; every function keeps the JAX
package's rounding points (fp32 interiors, output cast back to the
stream dtype).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.nn import quant
from repro_torch.nn.params import ParamSpec


def linear_specs(d_in: int, d_out: int) -> dict:
    return {"w": ParamSpec((d_in, d_out))}


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype (the Mamba-2 projections have no bias);
    a quantized weight (``nn/quant.py``) goes through ``quant.qdot``."""
    w = p["w"]
    if quant.is_quantized(w):
        return quant.qdot(x, w).to(x.dtype)
    return torch.matmul(x, w.to(x.dtype))


def norm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), init="ones")}


def norm(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with an fp32 interior; the output is cast back."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"].float()).to(x.dtype)


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


def causal_conv1d(p: dict, x: torch.Tensor, state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, d); state: (b, width-1, d), the incoming tail.
    Returns (y (b, l, d), new_state (b, width-1, d))."""
    width = p["w"].shape[0]
    l = x.shape[1]
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
