"""ReduBA's reduction, the sum over axis 0 of a 2-D array: the CUDA kernel
and its plain version.

Port of ``repro.kernels.reduba.reduce_rows`` (TPU kernel 14) and its
oracle ``repro.kernels.ref.reduce_rows_ref``: x (m, n) fp32 or bf16 ->
(n,) in x's dtype, the sums in fp32.  ``kernels/ops.py: reduba_sum``
reduces a last axis through it (``core/reduce.py: reduce_sum`` and
``mean`` in the ``pallas`` modes).

* :func:`reduce_rows` — the wrapper around ``csrc/reduba.cu`` (a column
  per thread, rows in order; a tall x in row ranges whose fp32 partials a
  second pass sums in order).  CUDA tensors only; a non-contiguous x is
  copied first.  Calls are counted in ``reduce_rows.launches``.
* :func:`reduce_rows_plain` — ``torch.sum`` in fp32: the CPU path, and
  what the kernel is held to on the card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import common

_LAUNCH = ("reduba", "reduce_rows_launch",
           [common.I, common.P, common.P, common.P, common.I, common.I,
            common.I, common.I, common.P])
# Columns per block (csrc/reduba.cu: NT), the blocks to aim for (about
# four per SM of an H100) and the fewest rows a split sums.
_COLS, _BLOCKS, _MIN_ROWS = 128, 528, 64


def _row_splits(m: int, n: int) -> Tuple[int, int]:
    """(rows per split, splits) for an (m, n) input, from its shape
    alone."""
    strips = math.ceil(n / _COLS)
    splits = max(1, min(math.ceil(m / _MIN_ROWS), math.ceil(_BLOCKS / strips)))
    rows = math.ceil(m / splits)
    return rows, math.ceil(m / rows)


def reduce_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``reduce_rows_ref``)."""
    return x.float().sum(dim=0).to(x.dtype)


def reduce_rows(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (contract as :func:`reduce_rows_plain`)."""
    dev = x.device
    common.require(dev.type == "cuda", "reduce_rows takes CUDA tensors; the "
                   "CPU path is reduce_rows_plain")
    common.require(x.ndim == 2 and x.shape[0] >= 1,
                   f"reduce_rows: x must be (m, n) with m >= 1, got "
                   f"{tuple(x.shape)}")
    x = x.contiguous()
    m, n = x.shape
    rows, splits = _row_splits(m, n)
    out = torch.empty((n,), dtype=x.dtype, device=dev)
    partial = torch.empty((splits if splits > 1 else 0, n),
                          dtype=torch.float32, device=dev)
    err = common.launcher(*_LAUNCH)(
        common.stream_code(x), common.ptr(x), common.ptr(partial),
        common.ptr(out), m, n, rows, splits, common.stream(dev))
    common.check_launch(err, "reduba", "reduce_rows kernel")
    reduce_rows.launches += 1
    return out


reduce_rows.launches = 0
