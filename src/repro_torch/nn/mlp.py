"""Gated MLPs (SwiGLU / GeGLU), ActiBA-aware: a port of ``repro.nn.mlp``
(its plain, ungated ``mlp`` type is not ported).

The gated form is ``act(x @ wg) * (x @ wi)`` then ``wo``.  Under
ActiBA with a ``pallas`` CumBA mode (``XambaConfig.pallas()``) the gated
unit runs as one ``matmul_pwl`` call (TPU kernel 11: the activation's PWL
table in the product's drain, ``kernels/ops.py``), as the JAX package
dispatches it (``mlp.py:39-40``); otherwise the products run in the
stream dtype and the activation (``core/pwl.py: activation``) after.
GeLU is the tanh approximation, as ``jax.nn.gelu``'s default.
"""
from __future__ import annotations

import torch

from repro_torch.core import pwl
from repro_torch.kernels import ops
from repro_torch.nn import layers, quant

_ACT_FOR_MLP = {"swiglu": "silu", "geglu": "gelu"}


def mlp_specs(cfg) -> dict:
    if cfg.mlp_type not in _ACT_FOR_MLP:
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported")
    d, f = cfg.d_model, cfg.d_ff
    return {"wi": layers.linear_specs(d, f), "wg": layers.linear_specs(d, f),
            "wo": layers.linear_specs(f, d)}


def apply(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    act_name = _ACT_FOR_MLP[cfg.mlp_type]
    xamba = cfg.xamba
    if xamba.actiba and xamba.cumba in ("pallas", "pallas_interpret"):
        wg, wi = params["wg"]["w"], params["wi"]["w"]
        if quant.is_quantized(wg) or quant.is_quantized(wi):
            raise NotImplementedError(
                "W8 weights in the ActiBA gated MLP are not ported")
        h = ops.matmul_pwl(x.reshape(-1, x.shape[-1]), wg,
                           pwl.table_for(act_name, xamba), wi)
        h = h.reshape(x.shape[:-1] + (h.shape[-1],))
    else:
        act = pwl.activation(act_name, xamba)
        h = act(layers.linear(params["wg"], x)) * \
            layers.linear(params["wi"], x)
    return layers.linear(params["wo"], h.to(x.dtype))
