"""W8 dequant-matmul: the CUDA kernel and its plain version.

Port of ``repro.kernels.qmatmul.qmatmul`` (the TPU kernel) and its oracle
``repro.kernels.ref.qmatmul_ref``:

    out = epi((x @ q) * scale) [* ((x @ qv) * vscale)]

x (m, k) fp32 or bf16; q, qv (k, n) int8; scale, vscale (n,) fp32; the
output in x's dtype.  ``epi`` is the ActiBA PWL table (``table``) or the
identity; ``qv`` / ``vscale`` give the gated two-weight form of the MLPs.

* :func:`qmatmul` — the wrapper around ``csrc/qmatmul.cu``, one launch a
  call on one of three bodies that :func:`path` names from dtypes, shapes
  and alignment alone: the cluster GEMV for m <= 8 (decode; its column
  group and k split from :func:`gemv_plan`), the bf16 tensor-core body
  (``wgmma``; its k split from :func:`wgmma_splits`) for bf16 x above,
  else the SIMT tiled product.  CUDA tensors only; calls are counted in
  ``qmatmul.launches`` and, by body, in ``qmatmul.path_launches``.
* :func:`qmatmul_plain` — the same arithmetic in PyTorch: fp32 sums, the
  scale multiplied once into them, the PWL table in ``eval_pwl``'s order;
  the CPU path, and what the kernel is held to on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Optional, Tuple

import torch

from repro_torch.core.pwl import PWLTable, eval_pwl
from repro_torch.kernels import common
from repro_torch.kernels.actiba import table_args

# The launchers take one pointer to their arguments packed as 64-bit
# fields (csrc/qmatmul.cu: QmmArgs): dtype, x, q, scale, qv, vscale, out,
# m, k, n, lanes, splits, vec, table, nk, stream; null pointers are 0.
_ARGS = struct.Struct("<q6Q6qQqQ")
_LAUNCH = common.Launcher("qmatmul", "qmatmul_launch", [ctypes.c_char_p])
_WGMMA = common.Launcher("qmatmul", "qmatmul_wgmma_launch",
                         [ctypes.c_char_p])
GEMV_M = 8                   # csrc/gemm.cuh: rows the GEMV takes
GEMV_LANES = (32, 16, 8, 4)  # lanes of a column group, widest first
GEMV_SPLITS = (1, 2, 4)      # GEMV clusters: sizes that pack the SMs
GEMV_WARPS = 8               # warps of a GEMV block
MAX_SPLITS = 8               # blocks of a cluster (the portable limit)
WGMMA_TILE = (64, 128, 64)   # csrc/qmatmul.cu: rows, columns, k step
SMS = 132                    # H100 SXM streaming multiprocessors


@functools.lru_cache(maxsize=None)
def gemv_plan(k: int, n: int, lc: int) -> Tuple[int, int]:
    """(lanes, splits) of the cluster GEMV at ``lc`` weight columns a lane
    (16 bytes: 16 int8, 8 bf16, 4 fp32): the column group of ``lanes``
    lanes (a block takes lanes x lc columns) and the blocks over k (a
    cluster of 1, 2 or 4: clusters of 5 or 8 left SMs idle on the H100)
    that give the most blocks in one wave of the 132 SMs (at most one
    block an SM), each k lane keeping at least one row; the widest group
    wins a tie.  A function of the shapes alone, so a shape always takes
    the same sums in the same order (m, at most 8, does not enter it)."""
    best = (0, GEMV_LANES[0], 1)     # no plan fits a wave: the fewest blocks
    for lanes in GEMV_LANES:
        tiles = math.ceil(n / (lanes * lc))
        klanes = GEMV_WARPS * 32 // lanes
        for splits in GEMV_SPLITS:
            blocks = tiles * splits
            if blocks <= SMS and blocks > best[0] and \
                    (splits == 1 or k >= splits * klanes):
                best = (blocks, lanes, splits)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def wgmma_splits(m: int, k: int, n: int) -> int:
    """k splits (blocks of a cluster) of the ``wgmma`` body: the least
    power of two that gives the 64 x 128 output tiles at least one block
    an SM (two fit an SM; clusters of 3, 5 or 6 measured slower than the
    next power of two), at most ``MAX_SPLITS`` and at most half the k
    steps of 64, none of them empty.  A function of the shapes alone."""
    tm, tn, tk = WGMMA_TILE
    tiles = math.ceil(m / tm) * math.ceil(n / tn)
    steps = math.ceil(k / tk)
    splits = 1
    while splits * tiles < SMS and splits * 2 <= min(MAX_SPLITS, steps // 2):
        splits *= 2
    while (splits - 1) * math.ceil(steps / splits) >= steps:   # none empty
        splits //= 2
    return splits


def load_bytes(n: int, esize: int, *ts: torch.Tensor) -> int:
    """Bytes a GEMV lane reads at once from weights of ``n`` columns of
    ``esize`` bytes: 16 where the rows and every base allow it, else 8,
    else 0 (element by element)."""
    for b in (16, 8):
        if (n * esize) % b == 0 and all(t.data_ptr() % b == 0 for t in ts):
            return b
    return 0


def path(x: torch.Tensor, q: torch.Tensor,
         qv: Optional[torch.Tensor] = None) -> str:
    """The body a call takes, from dtypes, shapes and alignment alone:
    ``"gemv"`` for m <= ``GEMV_M``; ``"wgmma"`` for bf16 x when k and n
    are multiples of 8 (x's TMA stride, the 8-byte int8 pieces) and every
    base is 16-byte aligned; else ``"tiled"``, the SIMT body (fp32 x)."""
    m, k = x.shape
    n = q.shape[-1]
    if m <= GEMV_M:
        return "gemv"
    if x.dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 \
            and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0 \
            and (qv is None or qv.data_ptr() % 16 == 0):
        return "wgmma"
    return "tiled"


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
    elements.  The checks format their messages only when they fail: this
    runs twice a layer in every decode step."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("qmatmul takes CUDA tensors; the CPU path is "
                         "qmatmul_plain")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"qmatmul: x must be contiguous (m, k), got "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    n = q.shape[-1]
    gated = qv is not None
    if gated != (vscale is not None):
        raise ValueError("qmatmul: qv and vscale come together")
    for name, w in (("q", q), ("qv", qv)) if gated else (("q", q),):
        if w.dtype != torch.int8 or not w.is_contiguous() \
                or w.shape != (k, n):
            raise ValueError(f"qmatmul: {name} must be contiguous int8 "
                             f"({k}, {n}), got {w.dtype} {tuple(w.shape)}")
    scales = dict(scale=scale, vscale=vscale) if gated else dict(scale=scale)
    for name, s in scales.items():
        if s.numel() != n:
            raise ValueError(f"qmatmul: {name} must hold {n} values, got "
                             f"{tuple(s.shape)}")
    common.check_f32("qmatmul", **scales)
    common.check_cuda(dev, q=q, **scales, **(dict(qv=qv) if gated else {}))
    body = path(x, q, qv)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    qvp, vsp = (qv.data_ptr(), vscale.data_ptr()) if gated else (0, 0)
    tab, nk = table_args(table, dev)
    if body == "wgmma":
        lanes, splits, vec = 0, wgmma_splits(m, k, n), 0
    else:
        lanes, splits = gemv_plan(k, n, 16)
        vec = load_bytes(n, 1, q, qv) if gated else load_bytes(n, 1, q)
    err = (_WGMMA if body == "wgmma" else _LAUNCH)(_ARGS.pack(
        common.stream_code(x), x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        qvp, vsp, out.data_ptr(), m, k, n, lanes, splits, vec, tab, nk,
        common.stream(dev)))
    if err:
        common.check_launch(err, "qmatmul", f"qmatmul {body} kernel")
    qmatmul.launches += 1
    qmatmul.path_launches[body] += 1
    return out


qmatmul.launches = 0
# The same calls by the body they took (GEMV, bf16 tensor-core, SIMT tiled).
qmatmul.path_launches = {"gemv": 0, "wgmma": 0, "tiled": 0}
