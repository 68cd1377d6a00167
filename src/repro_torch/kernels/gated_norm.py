"""Gated RMSNorm epilogue shared by the decode-step and prefill kernels.

``out = rmsnorm(y) * scale * SiLU(z)`` over whole rows of ``d_inner``
values.  The mean spans every head of a row (``repro`` kernels
``decode_step.py:196-199`` and ``prefill_chunk.py:278-283``), so on the
GPU it runs as its own pass (``csrc/gated_norm.cu``) after the per-head
blocks.  It is part of the ``mamba2_step`` and ``mamba2_prefill``
wrappers and counts under their launches.

Two rounding disciplines, as in the JAX package:

* decode (``round_stream=False``): fp32 throughout, one cast at the end;
* prefill (``round_stream=True``): the normalised row and SiLU(z) are
  rounded to the stream dtype before their product (which rounds too).

Under ActiBA the gate's SiLU is a PWL table: a callable in the plain
version, the table (``kernels/actiba.py: table_args``) in the kernel.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import common
from repro_torch.kernels.actiba import table_args

_LAUNCH = ("gated_norm", "gated_norm_launch",
           [common.I, common.I, common.P, common.P, common.I, common.P,
            common.P, common.I, common.I, common.F, common.P, common.I,
            common.P])


def gated_norm_plain(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                     *, round_stream: bool, eps: float = 1e-6,
                     silu: Callable = F.silu) -> torch.Tensor:
    """y (..., d) fp32; z (..., d) in the stream dtype; out in z's dtype."""
    yf = y.float()
    ms = torch.mean(yf * yf, dim=-1, keepdim=True)
    yn = yf * torch.rsqrt(ms + eps) * scale.float()
    if round_stream:
        return yn.to(z.dtype) * silu(z)
    return (yn * silu(z.float())).to(z.dtype)


def gated_norm_cuda(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                    *, round_stream: bool, eps: float = 1e-6,
                    silu_table: Optional[PWLTable] = None) -> torch.Tensor:
    """The kernel: y (..., d) contiguous fp32, z rows of d values, scale
    (d,) contiguous fp32; ``silu_table`` the gate's ActiBA table or
    ``None`` for the exact SiLU."""
    d = y.shape[-1]
    common.require(y.dtype == torch.float32 and y.is_contiguous(),
                   "gated_norm: y must be contiguous fp32")
    common.require(z.shape == y.shape, f"gated_norm: z {tuple(z.shape)} vs "
                   f"y {tuple(y.shape)}")
    common.check_f32("gated_norm", scale=scale)
    common.require(scale.shape == (d,), "gated_norm: scale must be (d,)")
    common.check_cuda(y.device, z=z, scale=scale)
    out = torch.empty(y.shape, dtype=z.dtype, device=y.device)
    rows = y.numel() // d if d else 0
    fn = common.launcher(*_LAUNCH)
    err = fn(common.stream_code(z), int(round_stream), common.ptr(y),
             common.ptr(z), common.row_stride(z, "z"), common.ptr(scale),
             common.ptr(out), rows, d, eps,
             *table_args(silu_table, y.device), common.stream(y.device))
    common.check_launch(err, "gated_norm", "gated_norm kernel")
    return out
