"""CumBA: the last-axis cumulative sum, the CUDA kernel and its plain
version.

Port of ``repro.kernels.cumba.cumsum_last`` (the TPU kernel) and its
oracle ``repro.kernels.ref.cumsum_last_ref``:

* :func:`cumsum_last` — the wrapper around ``csrc/cumba.cu``: any leading
  shape, fp32 or bf16, fp32 accumulation, the output in the input's
  dtype; a lane scans a strip of :func:`strip` elements of its row.  CUDA
  tensors only; launches are counted in ``cumsum_last.launches``.
* :func:`cumsum_last_plain` — ``torch.cumsum`` in fp32, cast back; the CPU
  path, and what the kernel is held to on the card.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.kernels import common, cost

# The launcher takes one pointer to its arguments packed as 64-bit fields
# (csrc/cumba.cu: CumsumArgs): dtype, x, out, rows, t, strip, vec, stream.
_ARGS = struct.Struct("<q2Q4qQ")
_LAUNCH = common.Launcher("cumba", "cumsum_last_launch", [ctypes.c_char_p])
MAX_STRIP = 16          # csrc/cumba.cu: elements a lane takes in one pass


@functools.lru_cache(maxsize=None)
def strip(t: int) -> int:
    """Elements a lane scans in one pass of a row of ``t``: the least power
    of two whose 32 strips cover the row, at most ``MAX_STRIP`` (longer
    rows take several passes, carrying the running total)."""
    s = 1
    while 32 * s < t and s < MAX_STRIP:
        s *= 2
    return s


def cumsum_last_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``cumsum_last_ref``)."""
    return torch.cumsum(x.float(), dim=-1).to(x.dtype)


def cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (contract as :func:`cumsum_last_plain`); ``x``
    contiguous.  The strips go by 16-byte loads where both bases and the
    rows are 16-byte aligned.  The checks format their messages only when
    they fail: the ``pallas()`` forward calls this once a layer."""
    if not (x.is_cuda or x.is_meta):
        raise ValueError("cumsum_last takes CUDA tensors; the CPU path is "
                         "cumsum_last_plain")
    if not x.ndim or not x.is_contiguous():
        raise ValueError("cumsum_last: x must be contiguous with at least "
                         "one dim")
    code = common.STREAM_DTYPES.get(x.dtype)
    if code is None:
        common.stream_code(x)                   # raises with the message
    t = x.shape[-1]
    rows = x.numel() // t if t else 0
    out = torch.empty_like(x)
    if x.is_meta:
        cost.record("cumsum_last", x.numel(), cost._bytes(x, out))
        return out
    xp, op = x.data_ptr(), out.data_ptr()
    err = _LAUNCH(_ARGS.pack(code, xp, op, rows, t, strip(t),
                             (xp | op | t * x.element_size()) % 16 == 0,
                             common.stream(x.device)))
    if err:
        common.check_launch(err, "cumba", "cumsum_last kernel")
    cumsum_last.launches += 1
    return out


cumsum_last.launches = 0
