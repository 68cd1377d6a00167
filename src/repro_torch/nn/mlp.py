"""MLPs, gated (SwiGLU / GeGLU) and plain (``mlp``: whisper's GeLU MLP),
ActiBA-aware: a port of ``repro.nn.mlp``.

The plain form is ``act(x @ wi)`` then ``wo``; its activation goes
through ``core/pwl.py: activation`` under every mode (kernel 12 under
ActiBA on the card), never through ``matmul_pwl``, as in the JAX
package.  The gated form is ``act(x @ wg) * (x @ wi)`` then ``wo``.  Under
ActiBA with a ``pallas`` CumBA mode (``XambaConfig.pallas()``) the gated
unit runs as one ``matmul_pwl`` call (TPU kernel 11: the activation's PWL
table in the product's drain, ``kernels/ops.py``), or with W8 weights as
one ``qmatmul`` call in its gated PWL form (TPU kernel 10), as the JAX
package dispatches them (``mlp.py:52-58``); otherwise the products run
in the stream dtype (``layers.linear``: ``qdot`` for a W8 weight) and the
activation (``core/pwl.py: activation``) after.
GeLU is the tanh approximation, as ``jax.nn.gelu``'s default.
"""
from __future__ import annotations

import torch

from repro_torch.core import pwl
from repro_torch.kernels import ops
from repro_torch.nn import layers, quant

_ACT_FOR_MLP = {"swiglu": "silu", "geglu": "gelu", "mlp": "gelu"}


def mlp_specs(cfg) -> dict:
    if cfg.mlp_type not in _ACT_FOR_MLP:
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported")
    d, f = cfg.d_model, cfg.d_ff
    specs = {"wi": layers.linear_specs(d, f),
             "wo": layers.linear_specs(f, d, axes=("mlp", "embed"))}
    if cfg.mlp_type != "mlp":
        specs["wg"] = layers.linear_specs(d, f)
    return specs


def apply(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    act_name = _ACT_FOR_MLP[cfg.mlp_type]
    xamba = cfg.xamba
    if cfg.mlp_type == "mlp":
        h = pwl.activation(act_name, xamba)(layers.linear(params["wi"], x))
    elif xamba.actiba and xamba.cumba in ("pallas", "pallas_interpret"):
        wg, wi = params["wg"]["w"], params["wi"]["w"]
        x2 = x.reshape(-1, x.shape[-1])
        table = pwl.table_for(act_name, xamba)
        if quant.is_quantized(wg):
            # W8 and ActiBA composed: kernel 10's gated form, the int8
            # weights widened in the kernel and the PWL table applied to
            # the scaled gate sums in its drain.
            h = ops.qmatmul(x2, wg.q, wg.scale.reshape(-1), table=table,
                            qv=wi.q, vscale=wi.scale.reshape(-1))
        else:
            h = ops.matmul_pwl(x2, wg, table, wi)
        h = h.reshape(x.shape[:-1] + (h.shape[-1],))
    else:
        act = pwl.activation(act_name, xamba)
        h = act(layers.linear(params["wg"], x)) * \
            layers.linear(params["wi"], x)
    return layers.linear(params["wo"], h.to(x.dtype))
