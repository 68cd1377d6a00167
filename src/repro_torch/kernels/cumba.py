"""CumBA: the last-axis cumulative sum, the CUDA kernel and its plain
version.

Port of ``repro.kernels.cumba.cumsum_last`` (the TPU kernel) and its
oracle ``repro.kernels.ref.cumsum_last_ref``:

* :func:`cumsum_last` — the wrapper around ``csrc/cumba.cu``: any leading
  shape, fp32 or bf16, fp32 accumulation, the output in the input's
  dtype.  CUDA tensors only; launches are counted in
  ``cumsum_last.launches``.
* :func:`cumsum_last_plain` — ``torch.cumsum`` in fp32, cast back; the CPU
  path, and what the kernel is held to on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common

_LAUNCH = ("cumba", "cumsum_last_launch",
           [common.I, common.P, common.P, common.I, common.I, common.P])


def cumsum_last_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``cumsum_last_ref``)."""
    return torch.cumsum(x.float(), dim=-1).to(x.dtype)


def cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (contract as :func:`cumsum_last_plain`); ``x``
    contiguous."""
    dev = x.device
    common.require(dev.type == "cuda", "cumsum_last takes CUDA tensors; "
                   "the CPU path is cumsum_last_plain")
    common.require(x.dim() >= 1 and x.is_contiguous(),
                   "cumsum_last: x must be contiguous with at least one dim")
    t = x.shape[-1]
    rows = x.numel() // t if t else 0
    out = torch.empty_like(x)
    fn = common.launcher(*_LAUNCH)
    err = fn(common.stream_code(x), common.ptr(x), common.ptr(out), rows, t,
             common.stream(dev))
    common.check_launch(err, "cumba", "cumsum_last kernel")
    cumsum_last.launches += 1
    return out


cumsum_last.launches = 0
