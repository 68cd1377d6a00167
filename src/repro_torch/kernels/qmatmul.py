"""W8 dequant-matmul: the CUDA kernel and its plain version.

Port of ``repro.kernels.qmatmul.qmatmul`` (the TPU kernel) and its oracle
``repro.kernels.ref.qmatmul_ref``:

    out = epi((x @ q) * scale) [* ((x @ qv) * vscale)]

x (m, k) fp32 or bf16; q, qv (k, n) int8; scale, vscale (n,) fp32; the
output in x's dtype.  ``epi`` is the ActiBA PWL table (``table``) or the
identity; ``qv`` / ``vscale`` give the gated two-weight form of the MLPs.

* :func:`qmatmul` — the wrapper around ``csrc/qmatmul.cu``: a split-k GEMV
  for m <= 8 (decode) and a tiled product above (prefill).  CUDA tensors
  only; calls are counted in ``qmatmul.launches`` and, by the path they
  took, in ``qmatmul.path_launches``.
* :func:`qmatmul_plain` — the same arithmetic in PyTorch: fp32 sums, the
  scale multiplied once into them, the PWL table in ``eval_pwl``'s order;
  the CPU path, and what the kernel is held to on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.pwl import PWLTable, eval_pwl
from repro_torch.kernels import common
from repro_torch.kernels.actiba import table_args

_LAUNCH = ("qmatmul", "qmatmul_launch",
           [common.I] + [common.P] * 7 + [common.I] * 5
           + [common.P, common.I, common.P])
GEMV_M = 8                   # csrc/qmatmul.cu: rows the GEMV path takes
GEMV_COLS = 128              # columns per GEMV block
GEMV_MAX_KS = 1024           # k rows per split (the x slice in smem)
SMS = 132                    # H100 SXM streaming multiprocessors


def split_k(m: int, k: int, n: int) -> int:
    """Blocks over k for the GEMV path: about two blocks per SM, as long
    as the fp32 partials (splits x m x n x 8 bytes written and read) stay
    within a quarter of the int8 weight's k x n bytes, and at most
    ``GEMV_MAX_KS`` rows of k per block.  A function of the shapes alone,
    so a shape always takes the same sums in the same order."""
    if m > GEMV_M:
        return 1
    want = math.ceil(2 * SMS / math.ceil(n / GEMV_COLS))
    cap = max(1, k // (32 * m))
    splits = max(min(want, cap), math.ceil(k / GEMV_MAX_KS))
    return math.ceil(k / math.ceil(k / splits))      # no empty split


def qmatmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                  table: Optional[PWLTable] = None,
                  qv: Optional[torch.Tensor] = None,
                  vscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version (the kernel's arithmetic)."""
    xf = x.float()
    y = torch.matmul(xf, q.float()) * scale.reshape(-1).float()
    if table is not None:
        y = eval_pwl(table, y)
    if qv is not None:
        y = y * (torch.matmul(xf, qv.float()) * vscale.reshape(-1).float())
    return y.to(x.dtype)


def qmatmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
            table: Optional[PWLTable] = None,
            qv: Optional[torch.Tensor] = None,
            vscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CUDA kernel (contract as :func:`qmatmul_plain`); ``x``, ``q``,
    ``qv`` contiguous, ``scale`` / ``vscale`` contiguous fp32 of n
    elements."""
    dev = x.device
    common.require(dev.type == "cuda", "qmatmul takes CUDA tensors; the "
                   "CPU path is qmatmul_plain")
    common.require(x.ndim == 2 and x.is_contiguous(),
                   f"qmatmul: x must be contiguous (m, k), got "
                   f"{tuple(x.shape)}")
    m, k = x.shape
    gated = qv is not None
    weights = dict(q=q, qv=qv) if gated else dict(q=q)
    scales = dict(scale=scale, vscale=vscale) if gated else dict(scale=scale)
    common.require(gated == (vscale is not None),
                   "qmatmul: qv and vscale come together")
    n = q.shape[-1]
    for name, w in weights.items():
        common.require(w.dtype == torch.int8 and w.is_contiguous()
                       and tuple(w.shape) == (k, n),
                       f"qmatmul: {name} must be contiguous int8 ({k}, {n}), "
                       f"got {w.dtype} {tuple(w.shape)}")
    for name, s in scales.items():
        common.require(s.numel() == n, f"qmatmul: {name} must hold {n} "
                       f"values, got {tuple(s.shape)}")
    common.check_f32("qmatmul", **scales)
    common.check_cuda(dev, **weights, **scales)
    splits = split_k(m, k, n)
    partial = torch.empty((splits * (2 if gated else 1), m, n),
                          dtype=torch.float32, device=dev) \
        if splits > 1 else None
    vec4 = n % 4 == 0 and all(w.data_ptr() % 4 == 0
                              for w in weights.values())
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    fn = common.launcher(*_LAUNCH)
    err = fn(common.stream_code(x), common.ptr(x), common.ptr(q),
             common.ptr(scale), common.ptr(qv) if gated else None,
             common.ptr(vscale) if gated else None, common.ptr(out),
             common.ptr(partial) if partial is not None else None,
             m, k, n, splits, int(vec4), *table_args(table, dev),
             common.stream(dev))
    common.check_launch(err, "qmatmul", "qmatmul kernel")
    qmatmul.launches += 1
    qmatmul.path_launches["gemv" if m <= GEMV_M else "tiled"] += 1
    return out


qmatmul.launches = 0
# The same calls by the path they took (GEMV or tiled kernel).
qmatmul.path_launches = {"gemv": 0, "tiled": 0}
