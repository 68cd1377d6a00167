"""ActiBA: the elementwise PWL activation, the CUDA kernel and its plain
version.

Port of ``repro.kernels.actiba.pwl_activate`` (the TPU kernel) and its
oracle ``repro.kernels.ref.pwl_activate_ref``:

* :func:`pwl_activate` — the wrapper around ``csrc/actiba.cu``: any shape,
  fp32 or bf16, fp32 inside, the output in the input's dtype.  The table
  goes to the kernel by value (its host floats, :func:`host_table`, kept
  per table), the term loop unrolled for the next instantiated count.  One
  packed-argument launch (``PWL_FIELDS``) on one of two bodies that
  :func:`path` names: 16-byte vectors where the base is 16-byte aligned,
  else scalars.  CUDA (or meta) tensors only; launches are counted in
  ``pwl_activate.launches`` and, by body, in
  ``pwl_activate.path_launches``.
* :func:`pwl_activate_plain` — ``core/pwl.py: eval_pwl``, the same sum in
  the same order; the CPU path, and what the kernel is held to on the card
  (fp32 bit for bit).
* :class:`PwlActivate` — the ``torch.autograd.Function`` an ActiBA
  activation reaches on the card under grad (``kernels/ops.py``): the
  kernel forward, the backward the autograd of :func:`pwl_activate_plain`.
* :func:`table_tensor` — a table as the fused kernels' PWL epilogues read
  it: one small fp32 device tensor ``[b_0..b_{K-2}, dm_0..dm_{K-2}, m0,
  c0]``, built once per (table, device) and cached, so no call copies it
  to the card again.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pwl import PWLTable, eval_pwl
from repro_torch.kernels import common, cost

# The launcher takes one pointer to its arguments packed as 64-bit fields
# in this order (csrc/actiba.cu: PwlLaunch).
PWL_FIELDS = ("dtype", "x", "out", "n", "vec", "tab", "nk", "stream")
_PWL_ARGS = struct.Struct("<" + "q" * len(PWL_FIELDS))
_LAUNCH = common.Launcher("actiba", "pwl_activate_launch", [ctypes.c_char_p])
MAX_SEGMENTS = 128           # csrc/actiba.cu MAX_NK + 1

_TABLES: Dict[Tuple[PWLTable, torch.device], torch.Tensor] = {}


def _check_size(table: PWLTable) -> None:
    common.require(table.num_segments <= MAX_SEGMENTS,
                   f"PWL table {table.name}: {table.num_segments} "
                   f"segments > {MAX_SEGMENTS}")


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
        _check_size(table)
        got = _ARGS[(id(table), device)] = (
            table, common.ptr(table_tensor(table, device)),
            table.num_segments - 1)
    return got[1], got[2]


# Each table's packed fp32 floats in host memory, for the kernel's
# by-value parameter: keyed by the table's id, the entry holds the table
# (so the id stays its) and the array (so the address stays valid).
_HOST: Dict[int, Tuple[PWLTable, np.ndarray, int, int]] = {}


def host_table(table: PWLTable) -> Tuple[int, int]:
    """(address, nk) of ``table.packed_f32()`` in host memory, built once
    per table; nk = K - 1 for K segments, at most ``MAX_SEGMENTS`` - 1."""
    got = _HOST.get(id(table))
    if got is None:
        _check_size(table)
        arr = np.ascontiguousarray(table.packed_f32())
        got = _HOST[id(table)] = (table, arr, arr.ctypes.data,
                                  table.num_segments - 1)
    return got[2], got[3]


def path(x: torch.Tensor) -> str:
    """The body a call on ``x`` takes: ``"vector"`` (16-byte loads and
    stores) where x's base is 16-byte aligned, else ``"scalar"``.  The
    output is a fresh allocation, aligned."""
    return "scalar" if x.data_ptr() % 16 else "vector"


def pwl_activate_plain(x: torch.Tensor, table: PWLTable) -> torch.Tensor:
    """Plain PyTorch version (``eval_pwl``)."""
    return eval_pwl(table, x)


def pwl_activate(x: torch.Tensor, table: PWLTable) -> torch.Tensor:
    """The CUDA kernel (contract as :func:`pwl_activate_plain`); ``x``
    contiguous.  The checks format their messages only when they fail: the
    ``pallas()`` forward calls this three times a layer."""
    if not (x.is_cuda or x.is_meta):
        raise ValueError("pwl_activate takes CUDA tensors; the CPU path is "
                         "pwl_activate_plain")
    if not x.is_contiguous():
        raise ValueError("pwl_activate: x must be contiguous")
    code = common.STREAM_DTYPES.get(x.dtype)
    if code is None:
        common.stream_code(x)                   # raises with the message
    tab, nk = host_table(table)
    out = torch.empty_like(x)
    if x.is_meta:
        cost.record("pwl_activate", cost.pwl_ops(x.numel(), table),
                    cost._bytes(x, out))
        return out
    xp, op = x.data_ptr(), out.data_ptr()
    vec = (xp | op) % 16 == 0
    err = _LAUNCH(_PWL_ARGS.pack(
        code, xp, op, x.numel(), vec, tab, nk,
        torch._C._cuda_getCurrentRawStream(x.get_device())))
    if err:
        common.check_launch(err, "actiba", "pwl_activate kernel")
    pwl_activate.launches += 1
    pwl_activate.path_launches["vector" if vec else "scalar"] += 1
    return out


pwl_activate.launches = 0
# The same calls by the body they took (16-byte vectors, scalars).
pwl_activate.path_launches = {"vector": 0, "scalar": 0}


class PwlActivate(torch.autograd.Function):
    """Kernel 12 under autograd: ``apply(table, x)``.

    The forward is the hand-written kernel, unchanged, and counts its
    launch.  The backward recomputes :func:`pwl_activate_plain`
    (``eval_pwl``, the PWL function XLA runs in the JAX package's ActiBA
    training) from the saved x and returns ``torch.autograd.grad`` of it,
    as the JAX package's ``flash_attention`` ``_bwd`` differentiates
    ``attention_ref``.  This backward is the one place where the plain
    version runs on the card outside a comparison; no backward kernel
    exists (``jax.grad`` of the Pallas kernel fails)."""

    @staticmethod
    def forward(ctx, table, x):
        ctx.table = table
        ctx.save_for_backward(x)
        return pwl_activate(x, table)

    @staticmethod
    def backward(ctx, grad):
        def plain(x):
            return pwl_activate_plain(x, ctx.table)
        return (None,) + common.plain_vjp(plain, ctx.saved_tensors,
                                          ctx.needs_input_grad[1:], (grad,))
