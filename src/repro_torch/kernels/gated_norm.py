"""Gated RMSNorm epilogue of the decode-step and prefill kernels.

``out = rmsnorm(y) * scale * SiLU(z)`` over whole rows of ``d_inner``
values.  The mean spans every head of a row (``repro`` kernels
``decode_step.py:196-199`` and ``prefill_chunk.py:278-283``).  The decode
step fuses it (``csrc/decode_step.cu``); the prefill runs it as its own
pass (:func:`gated_norm_cuda`, ``csrc/gated_norm.cu``) after the per-head
blocks, as part of the ``mamba2_prefill`` wrapper, counted under its
launches.

Two rounding disciplines, as in the JAX package (the plain version takes
both; the kernel is the prefill's):

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

_LAUNCH = common.Launcher(
    "gated_norm", "gated_norm_launch",
    [common.I, common.P, common.P, common.I, common.P, common.P, common.I,
     common.I, common.F, common.P, common.I, common.P])


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
                    *, eps: float = 1e-6,
                    silu_table: Optional[PWLTable] = None) -> torch.Tensor:
    """The kernel, with the prefill's rounding (``round_stream=True``): y
    (..., d) contiguous in z's dtype (the prefill's output, a value of
    that dtype already); z rows of d values; scale (d,) contiguous fp32;
    ``silu_table`` the gate's ActiBA table or ``None`` for the exact SiLU.
    The checks format a message only when they fail."""
    d = y.shape[-1]
    if not (y.dtype == z.dtype and y.is_contiguous() and z.shape == y.shape
            and scale.dtype == torch.float32 and scale.is_contiguous()
            and scale.shape == (d,) and (y.is_cuda or y.is_meta)
            and z.device == y.device and scale.device == y.device):
        common.require(y.dtype == z.dtype and y.is_contiguous(),
                       f"gated_norm: y must be contiguous {z.dtype} like z, "
                       f"got {y.dtype}")
        common.require(z.shape == y.shape, f"gated_norm: z {tuple(z.shape)} "
                       f"vs y {tuple(y.shape)}")
        common.check_f32("gated_norm", scale=scale)
        common.require(scale.shape == (d,), "gated_norm: scale must be (d,)")
        common.check_cuda(y.device, z=z, scale=scale)
        raise ValueError("gated_norm: inputs refused")
    out = torch.empty(y.shape, dtype=z.dtype, device=y.device)
    if y.is_meta:       # the dry run: mamba2_prefill records the cost
        return out
    rows = y.numel() // d if d else 0
    err = _LAUNCH(common.stream_code(z), y.data_ptr(), z.data_ptr(),
                  common.row_stride(z, "z"), scale.data_ptr(),
                  out.data_ptr(), rows, d, eps,
                  *table_args(silu_table, y.device), common.stream(y.device))
    if err:
        common.check_launch(err, "gated_norm", "gated_norm kernel")
    return out
