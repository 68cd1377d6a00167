"""The Mamba-2 (SSD) mixer: port of the Mamba-2 part of ``repro.nn.ssm``.

``mamba2_apply`` handles both the multi-token prefill (with or without a
carried state) and the single-token decode step with the same params.
Both go through the kernel dispatch in ``kernels/ops.py``: the
hand-written CUDA kernels on the GPU, their plain versions on the CPU.

The prefill gate is the port's own: ``l % min(chunk_size, l) == 0``.  A
shape that fails it raises; the JAX package's unfused fallback chain is
not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.nn import layers
from repro_torch.nn.params import ParamSpec


class Mamba2State(NamedTuple):
    conv: torch.Tensor   # (b, d_conv-1, d_conv_dim), stream dtype
    ssm: torch.Tensor    # (b, nheads, headdim, d_state), fp32


def mamba2_dims(cfg):
    d_inner = cfg.expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_ngroups, cfg.d_state


def mamba2_specs(cfg) -> dict:
    d = cfg.d_model
    d_inner, nheads, g, n = mamba2_dims(cfg)
    d_xbc = d_inner + 2 * g * n
    d_in_proj = 2 * d_inner + 2 * g * n + nheads
    return {
        "in_proj": layers.linear_specs(d, d_in_proj),
        "conv": layers.conv1d_specs(d_xbc, cfg.d_conv),
        "dt_bias": ParamSpec((nheads,), init="zeros"),
        "A_log": ParamSpec((nheads,), init="ones"),
        "D": ParamSpec((nheads,), init="ones"),
        "norm": layers.norm_specs(d_inner),
        "out_proj": layers.linear_specs(d_inner, d),
    }


def mamba2_init_state(cfg, batch: int, dtype: torch.dtype,
                      device: torch.device) -> Mamba2State:
    d_inner, nheads, g, n = mamba2_dims(cfg)
    d_xbc = d_inner + 2 * g * n
    return Mamba2State(
        conv=torch.zeros((batch, cfg.d_conv - 1, d_xbc), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, nheads, cfg.ssm_head_dim, n),
                        dtype=torch.float32, device=device))


def mamba2_kernel_operands(params: dict) -> dict:
    """The mixer's small parameters as the kernels take them: contiguous
    fp32, with the decay rate ``A = -exp(A_log)``.  The model's
    ``decode_view`` builds them once per weight set; ``mamba2_apply``
    builds them per call only for params without that view."""
    def f32(t):
        return t.float().contiguous()
    return {"conv_w": f32(params["conv"]["w"]),
            "conv_b": f32(params["conv"]["b"]),
            "dt_bias": f32(params["dt_bias"]),
            "A": -torch.exp(params["A_log"].float()),
            "D": f32(params["D"]),
            "norm_scale": f32(params["norm"]["scale"])}


def _operands(params: dict) -> dict:
    return params["kernel"] if "kernel" in params else \
        mamba2_kernel_operands(params)


def _mamba2_decode(params: dict, cfg, x: torch.Tensor, state: Mamba2State,
                   out: Optional[Mamba2State]
                   ) -> Tuple[torch.Tensor, Mamba2State]:
    """Fused single-token step on (b, d) operands; x: (b, 1, d)."""
    d_inner, nheads, g, n = mamba2_dims(cfg)
    zxbcdt = layers.linear(params["in_proj"], x[:, 0])       # (b, d_in_proj)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * g * n, nheads],
                             dim=-1)
    y, new_conv, new_ssm = ops.mamba2_decode_step(
        z, xbc, dt, state.conv, state.ssm, **_operands(params), ngroups=g,
        head_dim=cfg.ssm_head_dim, out=out)
    h = layers.linear(params["out_proj"], y.to(x.dtype))[:, None]
    return h, Mamba2State(new_conv, new_ssm)


def mamba2_apply(params: dict, cfg, x: torch.Tensor,
                 state: Optional[Mamba2State] = None,
                 out: Optional[Mamba2State] = None,
                 ) -> Tuple[torch.Tensor, Optional[Mamba2State]]:
    """x: (b, l, d).  l == 1 with a state -> decode step; else prefill.
    ``out``: buffers that receive the new state (with ``state`` only)."""
    b, l, _ = x.shape
    d_inner, nheads, g, n = mamba2_dims(cfg)
    if state is not None and l == 1:
        return _mamba2_decode(params, cfg, x, state, out)

    chunk = min(cfg.chunk_size, l)
    if l % chunk:
        raise NotImplementedError(
            f"prefill of seqlen {l} is not a multiple of chunk {chunk}; the "
            "unfused prefill chain is not ported yet")
    if state is None:
        init = mamba2_init_state(cfg, b, x.dtype, x.device)
    else:
        init = state
    y, new_conv, new_ssm = ops.mamba2_prefill(
        x, params["in_proj"]["w"], init.conv, init.ssm, **_operands(params),
        ngroups=g, head_dim=cfg.ssm_head_dim, chunk=chunk, out=out)
    h = layers.linear(params["out_proj"], y.to(x.dtype))
    new_state = Mamba2State(new_conv, new_ssm) if state is not None else None
    return h, new_state
