"""Fused Mamba-2 single-token step: the CUDA kernel and its plain version.

Port of ``repro.kernels.decode_step.mamba2_step`` (the TPU kernel) and
its oracle ``repro.kernels.ref.mamba2_step_ref``:

* :func:`mamba2_step` — the wrapper around ``csrc/decode_step.cu``
  (conv shift + SiLU + softplus(dt) + SSD update + D skip, grid (batch,
  head)) followed by ``csrc/gated_norm.cu`` (gated RMSNorm over whole
  rows).  It takes CUDA tensors only and counts its calls in
  ``mamba2_step.launches``.
* :func:`mamba2_step_plain` — the same function in plain PyTorch, fp32
  throughout; the CPU path, and what the kernel is held to on the card.

ActiBA: the plain version takes SiLU and softplus as callables (as the
TPU kernel does, ``decode_step.py:159-160``), the kernel takes their PWL
tables (``None`` = exact) and evaluates them in its body.

Shapes (the JAX package's): z (b, di), xbc (b, dxbc), dt (b, h) — the
``in_proj`` splits, in the stream dtype; conv_state (b, w-1, dxbc) in the
stream dtype; ssm_state (b, h, p, n) fp32; conv_w (w, dxbc); conv_b
(dxbc,); dt_bias / A / D (h,); norm_scale (di,).  ``A`` is the negative
decay rate ``-exp(A_log)``.  Returns (y (b, di) gated, pre-``out_proj``;
new_conv; new_ssm).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import common
from repro_torch.kernels.actiba import table_args
from repro_torch.kernels.gated_norm import gated_norm_cuda, gated_norm_plain
from repro_torch.nn import layers

_LAUNCH = ("decode_step", "mamba2_step_launch",
           [common.I, common.P, common.I, common.P, common.I]
           + [common.P] * 10 + [common.I] * 6
           + [common.P, common.I, common.P, common.I, common.P])


def mamba2_step_plain(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                      dt_bias, A, D, norm_scale, *, ngroups: int,
                      head_dim: int, eps: float = 1e-6,
                      silu: Callable = F.silu, softplus: Callable = F.softplus):
    """Plain PyTorch port of ``mamba2_step_ref`` (fp32 interior)."""
    b, di = z.shape
    g, p = ngroups, head_dim
    n = ssm_state.shape[-1]
    h = dt.shape[1]
    conv_out, new_conv = layers.causal_conv1d_step(
        {"w": conv_w, "b": conv_b}, xbc.float(), conv_state.float())
    act = silu(conv_out)
    xs = act[:, :di].reshape(b, h, p)
    B = act[:, di:di + g * n].reshape(b, g, n).repeat_interleave(h // g, 1)
    C = act[:, di + g * n:].reshape(b, g, n).repeat_interleave(h // g, 1)
    dt_f = softplus(dt.float() + dt_bias.float()[None])
    decay = torch.exp(dt_f * A.float()[None])
    new = ssm_state.float() * decay[..., None, None] + \
        dt_f[..., None, None] * B[:, :, None, :] * xs[..., None]
    y = torch.einsum("bhpn,bhn->bhp", new, C) + D.float()[None, :, None] * xs
    out = gated_norm_plain(y.reshape(b, di), z, norm_scale,
                           round_stream=False, eps=eps, silu=silu)
    return out, new_conv.to(conv_state.dtype), new


def mamba2_step(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b, dt_bias,
                A, D, norm_scale, *, ngroups: int, head_dim: int,
                eps: float = 1e-6, out=None,
                silu_table: Optional[PWLTable] = None,
                softplus_table: Optional[PWLTable] = None):
    """The CUDA kernel (contract as :func:`mamba2_step_plain`, with the
    activations' ActiBA tables in place of callables, ``None`` = exact).
    The small parameters (conv_w, conv_b, dt_bias, A, D, norm_scale) must
    be contiguous fp32.  ``out`` = (new_conv, new_ssm) buffers to write
    the new state into instead of fresh ones."""
    dev = z.device
    common.require(dev.type == "cuda", "mamba2_step takes CUDA tensors; "
                   "the CPU path is mamba2_step_plain")
    b, di = z.shape
    g, p = ngroups, head_dim
    h = dt.shape[-1]
    n = ssm_state.shape[-1]
    width = conv_w.shape[0]
    dxbc = di + 2 * g * n
    common.check_f32("mamba2_step", conv_w=conv_w, conv_b=conv_b,
                     dt_bias=dt_bias, A=A, D=D)
    common.check_cuda(dev, xbc=xbc, dt=dt, conv_state=conv_state,
                      ssm_state=ssm_state, conv_w=conv_w, conv_b=conv_b,
                      dt_bias=dt_bias, A=A, D=D, norm_scale=norm_scale)
    for name, t in (("xbc", xbc), ("dt", dt), ("conv_state", conv_state)):
        common.require(t.dtype == z.dtype,
                       f"mamba2_step: {name} is {t.dtype}, z is {z.dtype}")
    common.require(di == h * p and h % g == 0,
                   f"mamba2_step: di {di} != h {h} x p {p} or h % g")
    common.require(xbc.shape == (b, dxbc) and dt.shape == (b, h),
                   "mamba2_step: xbc must be (b, di+2gn), dt (b, h)")
    common.require(tuple(conv_state.shape) == (b, width - 1, dxbc)
                   and conv_state.is_contiguous(),
                   "mamba2_step: conv_state must be contiguous (b, w-1, dxbc)")
    common.require(tuple(ssm_state.shape) == (b, h, p, n)
                   and ssm_state.dtype == torch.float32
                   and ssm_state.is_contiguous(),
                   "mamba2_step: ssm_state must be contiguous fp32 (b,h,p,n)")
    common.require(conv_w.shape == (width, dxbc) and conv_b.shape == (dxbc,)
                   and dt_bias.shape == A.shape == D.shape == (h,),
                   "mamba2_step: parameter shapes")
    ypre = torch.empty((b, di), dtype=torch.float32, device=dev)
    new_conv, new_ssm = common.outputs(out, conv_state, ssm_state,
                                       "mamba2_step")
    fn = common.launcher(*_LAUNCH)
    err = fn(common.stream_code(z), common.ptr(xbc),
             common.row_stride(xbc, "xbc"), common.ptr(dt),
             common.row_stride(dt, "dt"), common.ptr(conv_state),
             common.ptr(ssm_state), common.ptr(conv_w), common.ptr(conv_b),
             common.ptr(dt_bias), common.ptr(A), common.ptr(D),
             common.ptr(ypre), common.ptr(new_conv), common.ptr(new_ssm),
             b, h, p, g, n, width, *table_args(silu_table, dev),
             *table_args(softplus_table, dev), common.stream(dev))
    common.check_launch(err, "decode_step", "mamba2_step kernel")
    out = gated_norm_cuda(ypre, z, norm_scale, round_stream=False, eps=eps,
                          silu_table=silu_table)
    mamba2_step.launches += 1
    return out, new_conv, new_ssm


mamba2_step.launches = 0
