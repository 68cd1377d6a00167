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

Inside the train step's split over ``model``
(``distributed/collectives.py: model_split``), with ``d_ff`` split over
the model ranks: ``wi`` and ``wg`` column-parallel, the activation on the
rank's columns (kernel 11 on them under ActiBA's ``pallas`` modes: it is
elementwise a column), ``wo`` row-parallel.
"""
from __future__ import annotations

import torch

from repro_torch.core import pwl
from repro_torch.distributed import collectives
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
    group = collectives.model_group()
    if group is not None and group.splits(cfg.d_ff):
        return _apply_split(params, cfg, x, group)
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


def _apply_split(params: dict, cfg, x: torch.Tensor, group) -> torch.Tensor:
    """:func:`apply` on each rank's ``d_ff`` columns."""
    act_name = _ACT_FOR_MLP[cfg.mlp_type]
    xamba, f, dt = cfg.xamba, cfg.d_ff, x.dtype
    if cfg.mlp_type != "mlp" and xamba.actiba and \
            xamba.cumba in ("pallas", "pallas_interpret"):
        table = pwl.table_for(act_name, xamba)
        hs = [ops.matmul_pwl(xc.reshape(-1, xc.shape[-1]), wg, table, wi)
              .reshape(xc.shape[:-1] + (-1,)) for xc, wg, wi in zip(
                  group.copy(x), group.held(params["wg"]["w"], 1, f),
                  group.held(params["wi"]["w"], 1, f))]
    else:
        xs = group.copy(x.float())
        act = pwl.activation(act_name, xamba)
        up = layers.linear_column(params["wi"], xs, group, f, dt)
        hs = [act(u) for u in up] if cfg.mlp_type == "mlp" else [
            act(g) * u for g, u in zip(
                layers.linear_column(params["wg"], xs, group, f, dt), up)]
    return layers.linear_row(params["wo"], [h.to(dt) for h in hs], group, f)
