"""ActiBA: the elementwise PWL activation, the CUDA kernel and its plain
version.

Port of ``repro.kernels.actiba.pwl_activate`` (the TPU kernel) and its
oracle ``repro.kernels.ref.pwl_activate_ref``:

* :func:`pwl_activate` — the wrapper around ``csrc/actiba.cu``: any shape,
  fp32 or bf16, fp32 inside, the output in the input's dtype.  CUDA
  tensors only; launches are counted in ``pwl_activate.launches``.
* :func:`pwl_activate_plain` — ``core/pwl.py: eval_pwl``, the same sum in
  the same order; the CPU path, and what the kernel is held to on the card.
* :func:`table_tensor` — a table as the kernels read it: one small fp32
  device tensor ``[b_0..b_{K-2}, dm_0..dm_{K-2}, m0, c0]``, built once per
  (table, device) and cached, so no call copies it to the card again.
  The decode-step and prefill kernels take the same tensor for their PWL
  epilogue.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.pwl import PWLTable, eval_pwl
from repro_torch.kernels import common

_LAUNCH = ("actiba", "pwl_activate_launch",
           [common.I, common.P, common.P, common.LL, common.P, common.I,
            common.P])
MAX_SEGMENTS = 128           # csrc/actiba.cu MAX_NK + 1

_TABLES: Dict[Tuple[PWLTable, torch.device], torch.Tensor] = {}


def table_tensor(table: PWLTable, device: torch.device) -> torch.Tensor:
    """``table`` packed as fp32 on ``device`` (cached per table and
    device)."""
    key = (table, torch.device(device))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.from_numpy(table.packed_f32()).to(device)
    return t


# (pointer, nk) of each (table, device) a kernel was given, looked up once:
# keyed by the table's id, the entry holds the table so the id stays its.
_ARGS: Dict[Tuple[int, torch.device], Tuple[PWLTable, int, int]] = {}


def table_args(table: Optional[PWLTable], device: torch.device
               ) -> Tuple[int, int]:
    """(pointer, nk) of a table for a kernel's PWL epilogue; (0, 0) — a
    null pointer, the exact activation — for ``None``.  Found once per
    (table, device) and kept: the decode step passes its tables once a
    layer, and hashing a table's breakpoints is host time on that path."""
    if table is None:
        return 0, 0
    got = _ARGS.get((id(table), device))
    if got is None:
        common.require(table.num_segments <= MAX_SEGMENTS,
                       f"PWL table {table.name}: {table.num_segments} "
                       f"segments > {MAX_SEGMENTS}")
        got = _ARGS[(id(table), device)] = (
            table, common.ptr(table_tensor(table, device)),
            table.num_segments - 1)
    return got[1], got[2]


def pwl_activate_plain(x: torch.Tensor, table: PWLTable) -> torch.Tensor:
    """Plain PyTorch version (``eval_pwl``)."""
    return eval_pwl(table, x)


def pwl_activate(x: torch.Tensor, table: PWLTable) -> torch.Tensor:
    """The CUDA kernel (contract as :func:`pwl_activate_plain`); ``x``
    contiguous."""
    dev = x.device
    common.require(dev.type == "cuda", "pwl_activate takes CUDA tensors; "
                   "the CPU path is pwl_activate_plain")
    common.require(x.is_contiguous(), "pwl_activate: x must be contiguous")
    ptr, nk = table_args(table, dev)
    out = torch.empty_like(x)
    fn = common.launcher(*_LAUNCH)
    err = fn(common.stream_code(x), common.ptr(x), common.ptr(out), x.numel(),
             ptr, nk, common.stream(dev))
    common.check_launch(err, "actiba", "pwl_activate kernel")
    pwl_activate.launches += 1
    return out


pwl_activate.launches = 0
