"""ActiBA's drain-fused matrix product: the CUDA kernel and its plain
version.

Port of ``repro.kernels.matmul_pwl.matmul_pwl`` (TPU kernel 11) and its
oracle ``repro.kernels.ref.matmul_pwl_ref``:

    out = pwl(x @ w) [* (x @ v)]

x (m, k) fp32 or bf16; w, v (k, n) fp32 or bf16 (one dtype); the output
in x's dtype.  ``pwl`` is an ActiBA table; ``v`` gives the gated form of
the GeGLU / SwiGLU MLPs.

* :func:`matmul_pwl` — the wrapper around ``csrc/matmul_pwl.cu``: the
  cluster GEMV for m <= 8 (decode, ``gemm.cuh``; one launch, its column
  group and k split from ``qmatmul.gemv_plan``), and above it (prefill)
  the bf16 tensor-core body (``wgmma`` fed by TMA) when x, w and v are
  all bf16 and TMA can read them, else the SIMT tiled product of
  ``gemm.cuh`` (fp32 operands, and shapes TMA cannot read).
  :func:`path` names the body from dtypes, shapes and alignment alone.
  CUDA (or meta) tensors only; calls are counted in
  ``matmul_pwl.launches`` and, by the body they took, in
  ``matmul_pwl.path_launches``.
* :func:`matmul_pwl_plain` — the same arithmetic in PyTorch: fp32 sums,
  the PWL table in ``eval_pwl``'s order, the gate multiplied once; the
  CPU path, and what the kernel is held to on the card.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional

import torch

from repro_torch.core.pwl import PWLTable, eval_pwl
from repro_torch.kernels import common, cost
from repro_torch.kernels.actiba import table_args
from repro_torch.kernels.qmatmul import GEMV_M, gemv_plan, load_bytes

# The GEMV / SIMT launcher takes one pointer to its arguments packed as
# 64-bit fields (csrc/matmul_pwl.cu: MpwlArgs): dtype, wdtype, x, w, v,
# out, m, k, n, lanes, splits, vec, table, nk, stream; null pointers are 0.
_ARGS = struct.Struct("<2q4Q6qQqQ")
_LAUNCH = common.Launcher("matmul_pwl", "matmul_pwl_launch",
                          [ctypes.c_char_p])
_WGMMA = common.Launcher(
    "matmul_pwl", "matmul_pwl_wgmma_launch",
    [common.P] * 4 + [common.I] * 3 + [common.P, common.I, common.P])


def matmul_pwl_plain(x: torch.Tensor, w: torch.Tensor, table: PWLTable,
                     v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version (``matmul_pwl_ref``)."""
    xf = x.float()
    out = eval_pwl(table, torch.matmul(xf, w.float()))
    if v is not None:
        out = out * torch.matmul(xf, v.float())
    return out.to(x.dtype)


def path(x: torch.Tensor, w: torch.Tensor,
         v: Optional[torch.Tensor] = None) -> str:
    """The body a call takes, from dtypes, shapes and alignment alone:
    ``"gemv"`` for m <= ``GEMV_M``; ``"wgmma"`` when x, w (and v) are all
    bf16, k and n are multiples of 8 and every base is 16-byte aligned
    (TMA's rule for the tensor maps); else ``"tiled"``, the SIMT body."""
    m, k = x.shape
    n = w.shape[-1]
    if m <= GEMV_M:
        return "gemv"
    ts = (x, w) if v is None else (x, w, v)
    if all(t.dtype == torch.bfloat16 for t in ts) and k % 8 == 0 \
            and n % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in ts):
        return "wgmma"
    return "tiled"


def matmul_pwl(x: torch.Tensor, w: torch.Tensor, table: PWLTable,
               v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CUDA kernel (contract as :func:`matmul_pwl_plain`); ``x``,
    ``w`` and ``v`` contiguous."""
    dev = x.device
    common.require(dev.type in ("cuda", "meta"), "matmul_pwl takes CUDA "
                   "tensors; the CPU path is matmul_pwl_plain")
    common.require(x.ndim == 2 and x.is_contiguous(),
                   f"matmul_pwl: x must be contiguous (m, k), got "
                   f"{tuple(x.shape)}")
    common.require(table is not None, "matmul_pwl: a PWL table is required")
    m, k = x.shape
    n = w.shape[-1]
    weights = dict(w=w) if v is None else dict(w=w, v=v)
    for name, t in weights.items():
        common.require(t.dtype in common.STREAM_DTYPES and t.dtype == w.dtype
                       and t.is_contiguous() and tuple(t.shape) == (k, n),
                       f"matmul_pwl: {name} must be contiguous fp32 or bf16 "
                       f"({k}, {n}) like w, got {t.dtype} {tuple(t.shape)}")
    common.check_cuda(dev, **weights)
    body = path(x, w, v)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if dev.type == "meta":
        cost.record("matmul_pwl", 2 * m * k * n * len(weights),
                    cost._bytes(x, w, v, out), cost.rate_of(x.dtype))
        return out
    vp = common.ptr(v) if v is not None else None
    if body == "wgmma":
        err = _WGMMA(common.ptr(x), common.ptr(w), vp, common.ptr(out), m, k,
                     n, *table_args(table, dev), common.stream(dev))
    else:
        es = w.element_size()
        lanes, splits = gemv_plan(k, n, 16 // es)
        err = _LAUNCH(_ARGS.pack(
            common.stream_code(x), common.stream_code(w), common.ptr(x),
            common.ptr(w), vp or 0, common.ptr(out), m, k, n, lanes, splits,
            load_bytes(n, es, *weights.values()), *table_args(table, dev),
            common.stream(dev)))
    if err:
        common.check_launch(err, "matmul_pwl", f"matmul_pwl {body} kernel")
    matmul_pwl.launches += 1
    matmul_pwl.path_launches[body] += 1
    return out


matmul_pwl.launches = 0
# The same calls by the body they took (GEMV, bf16 tensor-core, SIMT tiled).
matmul_pwl.path_launches = {"gemv": 0, "wgmma": 0, "tiled": 0}
