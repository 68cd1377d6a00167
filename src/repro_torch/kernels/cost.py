"""Operations and bytes of the port's kernels: one source for the bounds
``chip_smoke.py`` prints (PERF.md §6's bound column) and for the counts
the dry run (``launch/dryrun.py``) adds for each kernel launch.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the H100's HBM rate, and
its operations over the peak rate of the units its design computes on.
The rates are NVIDIA's data-sheet peaks of the H100 SXM (dense).

On ``meta`` tensors every kernel wrapper records one :class:`KernelCost`
in place of its launch into the log :func:`counting` opened (none is
open outside it), with the operations and bytes of the functions below,
computed from the call's shapes.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # CUDA cores
BF16_TC_FLOP_PER_S = 989e12      # tensor cores, dense
# fp32-accurate products on the bf16 tensor cores: six bf16 products of
# three-term splits each (csrc/ssd_tc.cuh), kernel 7's ``wgmma`` body.
SPLIT_TC_FLOP_PER_S = BF16_TC_FLOP_PER_S / 6


@dataclasses.dataclass(frozen=True)
class KernelCost:
    name: str
    ops: float
    nbytes: int
    flop_per_s: float


_LOG: contextvars.ContextVar = contextvars.ContextVar("kernel_costs",
                                                      default=None)


@contextlib.contextmanager
def counting():
    """Collect the :class:`KernelCost` of every meta kernel call inside
    the block into the list it yields."""
    log: List[KernelCost] = []
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def record(name: str, ops: float, nbytes: int,
           flop_per_s: float = FP32_FLOP_PER_S) -> None:
    log: Optional[list] = _LOG.get()
    if log is not None:
        log.append(KernelCost(name, float(ops), int(nbytes), flop_per_s))


def _bytes(*ts) -> int:
    """Bytes of the tensors (``None`` skipped), each counted whole."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _bound(nbytes, ops, flop_per_s=FP32_FLOP_PER_S):
    """(ms, 'bytes'|'operations'): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate_of(dtype) -> float:
    """The product rate a stream dtype allows: bf16 on the tensor cores,
    else fp32 on the CUDA cores."""
    import torch
    return BF16_TC_FLOP_PER_S if dtype == torch.bfloat16 else \
        FP32_FLOP_PER_S


# ---------------------------------------------------------------------------
# Operations, kernel by kernel
# ---------------------------------------------------------------------------

def decode_ops(b, h, p, n, dxbc, di) -> int:
    """Kernel 1: ~5 fp32 operations per state element (decay, x*dt, *B,
    +, *C and its sum) plus the conv and the norm."""
    return 5 * b * h * p * n + 10 * b * dxbc + 10 * b * di


def decode_bound(ins, outs):
    """Kernel 1's (ms, 'bytes'|'operations'): inputs read once and outputs
    written once over HBM, vs :func:`decode_ops` over fp32 peak."""
    b, h, p, n = ins["ssm_state"].shape
    ops = decode_ops(b, h, p, n, ins["xbc"].shape[-1], ins["z"].shape[-1])
    return _bound(_bytes(*ins.values(), *outs), ops)


def prefill_tc_ops(b, l, chunk, h, p, n, g) -> int:
    """Kernel 2's products on the tensor cores: per chunk the lower
    triangle of C B^T once per group (one bf16 product: bf16-exact
    streams), and per head the folded scores times x, the carried-state
    term and the chunk state, three bf16 products each (the fp32
    operand's three terms)."""
    L, c = chunk, l // chunk
    tri = L * (L + 1) // 2
    return b * c * (g * 2 * n * tri + h * 3 * (2 * p * tri + 4 * L * n * p))


def prefill_tc_bound(ins, outs, chunk):
    """Kernel 2's bound for the tensor-core design, from the run's tensors:
    the bytes (inputs read once, outputs written once) at 3.35 TB/s beside
    :func:`prefill_tc_ops` at 989 TFLOP/s.  Returns (ms, by, bytes ms,
    operations ms, GFLOP)."""
    b, l, di = ins["z"].shape
    _, h, p, n = ins["ssm_state"].shape
    g = (ins["xbc"].shape[-1] - di) // (2 * n)
    ops = prefill_tc_ops(b, l, chunk, h, p, n, g)
    t_bytes = _bytes(*ins.values(), *outs) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_TC_FLOP_PER_S * 1e3
    ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return ms, by, t_bytes, t_ops, ops / 1e9


def ssd_chunk_ops(b, c, L, h, g, p, n) -> int:
    """Kernel 7, the least work of the intra-chunk pass: the lower
    triangle (with its diagonal) of C B^T once per group, its decay (a
    difference and an exp per pair) and its product with x per head, and
    the state product (2 operations per multiply-add)."""
    tri = L * (L + 1) // 2
    return b * c * (g * 2 * n * tri + h * (2 * p * tri + 2 * tri +
                                           2 * L * p * n + L * p))


def pwl_ops(numel, table) -> int:
    """Kernel 12: m0*x + c0, then a subtraction, max, product and sum per
    breakpoint."""
    return numel * (2 + 4 * (table.num_segments - 1))


def mamba1_ops(b, di, n, r, width) -> int:
    """Kernel 5's fp32 operations: per row the conv (2 w di), x_proj
    (2 di (r+2n)), dt_proj (2 r di), ~7 per state element (dt*A, exp, the
    decay, dt*u*B and the sum, *C and its sum) and ~20 per channel for
    the activations, the D skip and the gate."""
    return b * (2 * width * di + 2 * di * (r + 2 * n) + 2 * r * di
                + 7 * di * n + 20 * di)


def mamba1_bound(ins, outs):
    """Kernel 5's bound: inputs once and outputs once over HBM, vs
    :func:`mamba1_ops` over fp32 peak."""
    b, di = ins["z"].shape
    ops = mamba1_ops(b, di, ins["ssm_state"].shape[-1],
                     ins["dtproj_w"].shape[0], ins["conv_w"].shape[0])
    return _bound(_bytes(*ins.values(), *outs), ops)


def ssd_step_ops(b, h, p, n) -> int:
    """Kernel 3: ~5 operations per state element and 2 per (head, row)."""
    return (5 * n + 2) * b * h * p


def sscan_step_ops(b, d, n) -> int:
    """Kernel 4: ~7 operations per state element and 2 per channel."""
    return (7 * n + 2) * b * d


def rglru_step_ops(b, w) -> int:
    """Kernel 6: the two gate products (2 w^2 each a row) and ~40
    operations per channel."""
    return 2 * 2 * b * w * w + 40 * b * w


def attention_pairs(lq: int, lk: int, causal: bool,
                    window: Optional[int]) -> int:
    """(query, key) pairs a left-aligned mask keeps: query i sees keys up
    to i (causal) and from i - window + 1 (a window)."""
    i = np.arange(lq, dtype=np.int64)
    hi = np.minimum(i, lk - 1) if causal else np.full(lq, lk - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(lq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_ops(b, hq, lq, lk, d, causal, window) -> int:
    """Kernel 9: 4 d operations (q k and p v, a multiply-add each) per
    kept pair and query head."""
    return 4 * d * attention_pairs(lq, lk, causal, window) * b * hq
