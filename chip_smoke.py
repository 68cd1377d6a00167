#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives ``src/repro_torch`` (never JAX) at the full width of mamba2-130m,
of mamba-130m (Mamba-1), of recurrentgemma-2b, of gemma-2b and of
qwen1.5-4b:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — ``nvcc`` builds every kernel from ``src/repro_torch/csrc``;
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, in fp32 and bf16: the decode step (one launch, the norm
   fused) at b = 1 and 4 and with the ActiBA tables, each run twice for
   the same bits; the prefill (``PREFILL_CASES``) on its tensor-core body
   at l = 128 (one chunk of 128), l = 64 (one of 64), l = 512 at chunk 256
   and l = 256 at chunk 64 (the state carried between chunks; a nonzero
   incoming state everywhere) and with the ActiBA tables, on its SIMT
   body at chunk 32, each twice on the body its ``path()`` names;
   ``cumsum_last`` on the SSD chain's (4, 24, 2, 256) prefix sums,
   ``ssd_chunk`` at b = 4, two chunks of 256 (twice, the same bits, on
   the body its ``path()`` names), kernel 2's seed-280 card-test case
   (bf16) from both bodies and the plain version held to an fp64 witness
   of the function (``witness_prefill``: every element within
   ``PREFILL_WITNESS_X`` of the limit, fewer than ``PREFILL_WITNESS_OFF``
   of them off), and ``pwl_activate`` with the SiLU and softplus tables
   on the chain's xBC, dt and gate streams, with 12- and 100-segment
   tables (padded terms) and on an operand one element off alignment
   (the scalar body), each twice on the body its ``path()`` names, fp32
   bit for bit;
   ``rglru_step`` at recurrentgemma-2b's width (b = 1 and 4, exact and
   with the sigmoid / softplus / gelu tables), ``rg_lru_scan`` at (4,
   256, 2560) and (4, 300, 2560), ``matmul_pwl`` (gelu table, plain and
   gated) at m = 4 and 512 against (2560, 7680), each run twice for the
   same bits;
   ``qmatmul`` (W8) at mamba2-130m's in_proj and out_proj shapes with
   m = 4, 8, 256 and 512, at mamba2-2.7b's at m = 4, and in its PWL and
   gated forms at (512, 768) x (768, 2048), each run twice and held to
   give the same bits; ``mamba1_step`` at mamba-130m's widths (b = 1 and
   4, and with the ActiBA tables), ``sscan_step`` at (4, 1536, 16) with
   and without D and with the state an offset view (the element path),
   ``ssd_step`` at mamba2-130m's step widths (b = 4), each also run twice
   for the same bits; ``flash_attention`` at gemma-2b's prefill (b = 4, L
   = 128, 8 query heads and 1 KV head of 256), ragged (L = 300), under a
   64-token window, not causal (L = 100), at qwen1.5-4b's MHA (20 heads of
   128, L = 512), at b = 1, L = 4096 and with q an offset view (the SIMT
   body); ``reduce_rows`` at (2048, 2048) and (1000, 300); each twice.
   Kernels 9, 10 and 11 print the body each case took by their path
   counts (kernel 9: bf16 the ``wgmma`` body, fp32 the ``wgmma_fp32``
   body, views TMA cannot read the SIMT body; 10 and 11: the tensor-core
   ``wgmma`` body above the GEMV's m <= 8, fp32 the SIMT body), kernel 7
   likewise (its tensor-core ``wgmma`` body at the chain's shape), and
   fail a case that took another than the wrapper's ``path()`` names;
4. serve   — the wave engine through ``repro_torch.launch.serve``: 8
   requests, batch 4, prompts of 4-128 tokens, 16 new tokens, greedy,
   bf16 weights from ``--seed``; every token in the vocabulary, every
   logit finite, and each kernel launched 24 times per decode step and
   per wave, every ``mamba2_prefill`` launch of every serve phase on its
   tensor-core body.  Then a short CLI run with ``--prefill-mode naive
   --decode-mode naive`` (no fused kernel launched) and an ``Engine`` run
   under ``XambaConfig.pallas()`` (ActiBA in the fused kernels).  Then
   the continuous engine through the CLI with ``--prefill-chunk 64``,
   with ``--quant w8`` and without: 12 requests, batch 4, 16 new tokens;
   24 ``mamba2_step`` launches per decode step, 24 ``mamba2_prefill`` per
   chunk call, and 48 ``qmatmul`` per decode step (the GEMV) and per
   chunk call (the ``wgmma`` body, none on the SIMT body) under W8 (none
   without).  4c: mamba-130m through the same CLI, the
   continuous engine (chunk 64, 12 requests, with and without W8) and
   the wave engine: 24 ``mamba1_step`` launches per decode step, 48
   ``qmatmul`` per decode step and per chunk call under W8, no mamba2
   kernel.  4d: recurrentgemma-2b at full width and depth, bf16, through
   the CLI's wave engine (8 requests) and continuous engine (chunk 64,
   12 requests): 18 ``rglru_step`` launches per decode step and no other
   kernel; then on the same weights an ``Engine`` under ``pallas()`` (18
   ``rglru_step`` + 26 ``matmul_pwl`` per decode step, 26 ``matmul_pwl``
   per prefill on the ``wgmma`` body), ``RecurrentGemma.loss`` at b = 2,
   l = 256 under ``pallas()`` (18 ``rg_lru_scan``, 26 ``matmul_pwl``) and
   without ActiBA (a finite loss), and one continuous request with a
   2304-token prompt in chunks of 256 (the 2048-slot ring wraps) and 16
   new tokens.
   4e: gemma-2b at full width and depth, bf16, ``use_flash=True``, one
   weight set: the wave engine (4 requests, prompts 4-128, 16 greedy
   tokens; 18 ``flash_attention`` launches for its prefill, none per
   decode step), the continuous engine with chunk 64 (no kernel), one
   4096-token prompt at b = 1 (past the 2048-key blocked threshold: 18
   launches) and the ``loss`` forward at b = 1, l = 512 (18 launches).
   4f: qwen1.5-4b at full width, depth 4 (of 40), untied ``lm_head``,
   the wave engine: 4 launches for its prefill;
5. parity  — the same model in fp32, kernel path on the card against the
   plain path on the CPU, teacher-forced over 16 greedy tokens of 4
   prompts, with fp32 weights and with W8 weights: tokens agree
   wherever the plain path's top-2 margin exceeds the logit tolerance.
   Then the continuous engine (monolithic prefill) against the wave
   engine on the card, fp32: the same tokens until the first position
   whose top-2 margin is within the logit tolerance.  5b: the same for
   mamba-130m, held to an fp64 witness (``witness_mamba1``): the card
   no farther from it than ``M1_WITNESS_X`` times the CPU plain path
   is (and at least ``LOGIT_TOL``).  5c: ``ssd_decode_step`` and
   ``selective_scan_decode_step`` in ``pallas`` mode, one launch of
   kernels 3 and 4 each, against their ``naive`` modes.  5d:
   recurrentgemma-2b at full width and depth 5 in fp32, the card against
   the CPU's plain path within ``RG_SENS_X`` times the CPU's response to
   a one-ulp move of the embeddings, the loss under ``pallas()`` (with
   and without ActiBA) the same way, and continuous against wave.  5e:
   gemma-2b at full width and depth 2 in fp32 with ``use_flash``, the
   card against the CPU's plain path the same way (every kernel-9 launch
   on the ``wgmma_fp32`` body, none on the SIMT body), and on the card
   ``use_flash`` on against off.  5f: ``reduce_sum`` and ``mean`` in
   ``pallas`` mode at (2048, 2048), one launch of kernel 14 each,
   against their ``naive`` modes;
6. ablation — the paper's Fig. 4a variants (``examples/xamba_ablation.py``:
   baseline, +CumBA, +ReduBA, +CumBA+ReduBA, +ActiBA) and ``pallas()``
   through ``repro_torch.launch.ablation``: ``MambaLM.forward`` of the fp32
   model at b = 4, l = 300 (not a chunk multiple: the unfused chain,
   padded to 512 inside ``ssd``), with each variant's device time by
   kernel.  Every variant, and ``pallas()`` on the CPU's plain path, is
   held against an fp64 witness of its function written apart from the
   port, and the exact remaps against each other (``LOGIT_TOL``,
   ``PREFIX_SUM_TOL``); under ``pallas()`` each layer launches one
   ``cumsum_last``, one ``ssd_chunk`` (on its ``wgmma`` body) and three
   ``pwl_activate`` (every one on its vector body, under ``+ActiBA``
   too), and the first two are held to the phase-3 limits on the
   operands that forward gave them;
7. times   — each kernel and its plain version at the shapes its path
   gives it (CUDA events, median), launches, the bound, and a PyTorch
   call computing the same function where there is one; kernels 1 and 2
   with their host microseconds a call (kernel 1 also into the caller's
   state buffers, as the engine calls it), kernel 2 at l = 128 and 64 with
   its SIMT body on the same inputs (``simt_prefill``, not counted), its
   device time by kernel and its bound restated for the tensor-core
   design (``prefill_tc_bound``); the decode step
   and prefill of each model, bf16 beside W8, and the engines' serve
   metrics side by side; the SIMT bodies of kernels 9, 10 and 11 on the
   same bf16 inputs beside their ``wgmma`` bodies, and kernel 7's on the
   same fp32 inputs beside its ``wgmma`` body (with its head-set size, its
   launches by body and its bound at both rates), and ptxas's report of
   the ``wgmma`` bodies and the cluster GEMV; beside kernel 10's rows
   (GEMV and ``wgmma``, in_proj and out_proj), kernel 11's GEMV row and
   kernel 13's row, the wrapper's host microseconds per call and
   ``torch.matmul``'s (``torch.cumsum``'s for kernel 13; 1000 calls, no
   synchronisation), and kernel 10's GEMV also with its
   weights cold (a rotation of copies larger than the 50 MB L2); kernels
   5 and 6 with their host microseconds a call (one launch each now),
   kernel 6 also cold (three weight sets in turn, 78.6 MB), and ptxas's
   report of both; kernel 12 at the ``pallas()`` forward's three fp32
   operands and phase 4's 32-bucket bf16 xBC (call, device, host, its
   byte bound and its instruction floor, ptxas); kernels 3 and 4 with
   their host microseconds and ptxas; kernel 9's fp32 body at phase 5e's
   shape and at b = 1, L = 4096 with the SIMT body on the same inputs
   beside it (``simt_flash``, not counted), its shared memory and ptxas.
   Each phase's seconds are printed after it.

Any failure raises (exit code 1).  Without a GPU it exits 1 before doing
anything.  The second line from the end is the ``kernels`` JSON record,
the last line the device record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 CUDA-core FLOP/s
# and bf16 tensor-core FLOP/s (dense).  The fused kernels compute in fp32
# on the CUDA cores; qmatmul's bound takes the rate its stream dtype
# allows (bf16 in the serve path: the int8 weights widen exactly to bf16).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# fp32 instructions that are not fused multiply-adds (a subtraction, a max,
# a product, a sum), one a lane a cycle: 132 SMs x 4 schedulers x 32 lanes
# at the 1.98 GHz boost clock.  Kernel 12's instruction floor.
FP32_ISSUE_PER_S = 132 * 4 * 32 * 1.98e9
BF16_TC_FLOP_PER_S = 989e12
# fp32-accurate products on the bf16 tensor cores: six bf16 products of
# three-term splits each (csrc/ssd_tc.cuh), kernel 7's ``wgmma`` body.
SPLIT_TC_FLOP_PER_S = BF16_TC_FLOP_PER_S / 6

# Kernel vs plain version on the same inputs, element by element:
#     |kernel - plain| <= rtol * (|plain| + ATOL_RMS * rms(plain))
# rtol of each element, plus an atol of ATOL_RMS x rtol at the output's
# typical magnitude.  The atol is for elements near zero: the pre-norm y
# is a sum of up to 256 products and a carried term, its error follows the
# size of those terms, and where they cancel the element is small but its
# error is not.  rtol is keyed by the case's stream dtype and the output:
# "stream" = y and the conv tail (in the stream dtype), "state" = the
# fp32 SSM state (fp32 in both cases, so 1e-4 in both).
#   fp32: the two take the same sums in other orders: 1e-4.
#   bf16 streams: one bf16 step (2^-7 of a value at most).  A value that
#     lies within the fp32 difference of a bf16 rounding boundary rounds
#     the other way at one of the stream dtype's rounding points (y, the
#     D skip, the norm, the gate).  That happens to few elements, so the
#     share of elements that are not bit-equal is held to MAX_OFF_SHARE
#     besides: a fault smaller than a step (a missing rounding point, a
#     lost D skip) moves most elements.
# The chip readings each limit was set from are in PERF.md.
TOL = {("float32", "stream"): 1e-4, ("float32", "state"): 1e-4,
       ("bfloat16", "stream"): 2.0 ** -7, ("bfloat16", "state"): 1e-4}
ATOL_RMS = 4.0
MAX_OFF_SHARE = 0.005
# Logit tolerance of the fp32 path-parity phase (absolute).
LOGIT_TOL = 2e-3
# The ablation: each variant against the fp64 witness of its function
# (``witness_forward``: no chunks, no prefix sums), absolute, on logits up
# to ~3.3.  The function is well conditioned (a 2^-24 relative change of
# the embeddings moves the witness's logits by 7.8e-9 on an H100); what
# sets a variant's fp32 error is where its decays exp(sum of dt*A) come
# from:
# * segment sums of dt*A (cumba mode "naive": baseline, +ReduBA) keep
#   fp32 precision, and are held to LOGIT_TOL (H100: 4.1e-4 and 4.9e-4);
# * differences of fp32 prefix sums cs (CumBA and kernels 13 and 7, the
#   JAX package's form) lose the digits of |cs|: up to ~3.7e3 in this
#   random model, whose ulp is 2.4e-4 in the exponent, and a one-ulp
#   change anywhere upstream redraws that rounding in every later layer.
#   PREFIX_SUM_TOL is 1.8x the largest of the five H100 readings (3.4e-3
#   to 4.5e-3); the JAX package loses the same digits
#   (tests/test_torch_xamba.py).
# Two variants are held to LOGIT_TOL if both take segment sums, else to
# the sum of their limits (the triangle inequality), and each to top-1
# agreement on ABLATION_TOP1 of the positions.
PREFIX_SUM_TOL = 8e-3
ABLATION_TOP1 = 0.99
# Kernel 2 against an fp64 witness of its function (``witness_prefill``)
# on the card test's seed-280 bf16 case: every element within
# PREFILL_WITNESS_X of the element-wise limit above, and fewer than
# PREFILL_WITNESS_OFF of the elements off the witness at all.  Both
# bodies and the plain version read 1.0065 of the limit on one element
# (where y and the D skip cancel, a bf16 step from a rounding point; the
# order of the fp32 prefix sums decides its side) and 0.043-0.053% of
# the elements off on the H100 (PERF.md);
# tests/test_torch_prefill_tc.py holds the plain version by the same rule
# on the CPU.
PREFILL_WITNESS_X = 1.25
PREFILL_WITNESS_OFF = 0.001

N_HEADS, HEAD_DIM, D_STATE, N_GROUPS, WIDTH = 24, 64, 128, 1, 4
D_MODEL = 768
D_INNER = N_HEADS * HEAD_DIM
D_XBC = D_INNER + 2 * N_GROUPS * D_STATE
D_IN_PROJ = D_INNER + D_XBC + N_HEADS            # 3352
# qmatmul's cases (name, k, n, m values): mamba2-130m's projections at
# the decode (m = slots) and chunked-prefill (m = slots x chunk) widths,
# mamba2-2.7b's (d_model 2560: src/repro/configs/mamba2_2p7b.py) at
# decode, a GEMV over 27 MB of int8.
QMM_CASES = (("in_proj", D_MODEL, D_IN_PROJ, (4, 8, 256, 512)),
             ("out_proj", D_INNER, D_MODEL, (4, 8, 256, 512)),
             ("2.7b in_proj", 2560, 10576, (4,)),
             ("2.7b out_proj", 5120, 2560, (4,)))
# The PWL and gated forms at an MLP-like shape: (m, k, n).
QMM_MLP = (512, 768, 2048)
# mamba-130m's mixer (src/repro/configs/mamba_130m.py): d_inner 1536,
# d_state 16, dt_rank 48, conv width 4.
M1_D_INNER, M1_D_STATE, M1_DT_RANK = 2 * D_MODEL, 16, 48
# The mamba-130m parity phase holds the card's logits to an fp64 witness
# of the function (``witness_mamba1``): no farther from it than
# M1_WITNESS_X times the CPU plain path's distance from it, and at least
# LOGIT_TOL.  This random model amplifies fp32 rounding: its states reach
# ~1e5, and a one-ulp (2^-24) relative change of the embeddings moves its
# fp32 logits by up to 6.7e-3 on the CPU (PERF.md), so the card and the
# CPU, which round differently in every layer, are compared through
# their accuracy, not with each other at LOGIT_TOL.
M1_WITNESS_X = 2.0
# recurrentgemma-2b (src/repro/configs/recurrentgemma_2b.py): lru_width =
# d_model = 2560, d_ff 7680 (GeGLU), 18 recurrent and 8 attention layers.
RG_W, RG_D_FF = 2560, 7680
# Its fp32 parity phase (depth 5) holds the card to the CPU plain path
# within RG_SENS_X times the CPU's own response to moving every embedding
# element by one ulp (and at least LOGIT_TOL): the card and the CPU round
# differently in every layer, and that reading says how far this random
# model carries one rounding to the logits.
RG_SENS_X = 4.0
# The ring phase: one prompt longer than the 2048-token window, chunked.
RG_RING_PROMPT, RG_RING_CHUNK = 2304, 256
# Kernel 9's cases (label, b, hq, hkv, L, head_dim, causal, window):
# gemma-2b's prefill (src/repro/configs/gemma_2b.py: 8 query heads, 1 KV
# head of 256) at the wave engine's bucket, ragged, under a window and not
# causal (held to attention_ref's plain version); qwen1.5-4b's MHA (20
# heads of 128); gemma's 4096-token prompt.
FLASH_CASES = (("gemma prefill", 4, 8, 1, 128, 256, True, None),
               ("ragged", 4, 8, 1, 300, 256, True, None),
               ("qwen MHA", 4, 20, 20, 512, 128, True, None),
               ("window 64", 4, 8, 1, 300, 256, True, 64),
               ("non-causal", 4, 8, 1, 100, 256, False, None),
               ("long", 1, 8, 1, 4096, 256, True, None))
# Kernel 14's cases: paper Fig. 1's ReduceSum
# (benchmarks/bench_fig1_op_breakdown.py) and a ragged one, (m, n).
REDUCE_CASES = ((2048, 2048), (1000, 300))
# The gemma-2b phases: the 4096-token prompt (past the blocked-attention
# threshold of 2048 keys) and the loss forward's length.
GEMMA_LONG, GEMMA_LOSS_L = 4096, 512
# qwen1.5-4b is served at full width and this depth (of 40), for the
# script's time.
QWEN_DEPTH = 4
# The gemma-2b parity phase's depth (fp32, full width; the CPU holds a
# second copy of the weights).
GEMMA_PARITY_DEPTH = 2


def reset_counts(counters) -> None:
    """Every wrapper's launch count to 0 (qmatmul's by path too)."""
    for fn in counters.values():
        fn.launches = 0
        for k in getattr(fn, "path_launches", {}):
            fn.path_launches[k] = 0


def read_counts(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _rand(gen, shape, scale, dev, dtype):
    import torch
    return (torch.randn(shape, generator=gen) * scale).to(dev).to(dtype)


def decode_inputs(b, dev, dtype, seed):
    """Full-width decode-step operands (the JAX tests' recipe); streams in
    ``dtype``, the state and the small parameters in fp32, as the model's
    ``decode_view`` hands them to the kernels."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    return dict(
        z=_rand(g, (b, D_INNER), 1.0, dev, dtype),
        xbc=_rand(g, (b, D_XBC), 1.0, dev, dtype),
        dt=_rand(g, (b, N_HEADS), 1.0, dev, dtype),
        conv_state=_rand(g, (b, WIDTH - 1, D_XBC), 1.0, dev, dtype),
        ssm_state=_rand(g, (b, N_HEADS, HEAD_DIM, D_STATE), 1.0, dev, f32),
        conv_w=_rand(g, (WIDTH, D_XBC), 0.3, dev, f32),
        conv_b=_rand(g, (D_XBC,), 0.1, dev, f32),
        dt_bias=_rand(g, (N_HEADS,), 0.1, dev, f32),
        A=-torch.rand(N_HEADS, generator=g).mul(1.9).add(0.1).to(dev),
        D=_rand(g, (N_HEADS,), 1.0, dev, f32),
        norm_scale=_rand(g, (D_INNER,), 1.0, dev, f32))


def prefill_inputs(b, l, dev, dtype, seed):
    """Full-width prefill operands with a nonzero carried state (dtypes
    as :func:`decode_inputs`)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    return dict(
        z=_rand(g, (b, l, D_INNER), 1.0, dev, dtype),
        xbc=_rand(g, (b, l, D_XBC), 1.0, dev, dtype),
        dt=_rand(g, (b, l, N_HEADS), 1.0, dev, dtype),
        conv_state=_rand(g, (b, WIDTH - 1, D_XBC), 1.0, dev, dtype),
        ssm_state=_rand(g, (b, N_HEADS, HEAD_DIM, D_STATE), 0.1, dev, f32),
        conv_w=_rand(g, (WIDTH, D_XBC), 0.3, dev, f32),
        conv_b=_rand(g, (D_XBC,), 0.1, dev, f32),
        dt_bias=_rand(g, (N_HEADS,), 0.1, dev, f32),
        A=-torch.exp(torch.randn(N_HEADS, generator=g) * 0.3).to(dev),
        D=_rand(g, (N_HEADS,), 0.2, dev, f32),
        norm_scale=(torch.randn(D_INNER, generator=g).abs() + 0.5).to(dev))


def mamba1_inputs(b, dev, dtype, seed):
    """Full-width mamba-130m step operands: xs_raw and z as the halves of
    one in_proj output (strided views, as the model hands them over), the
    streams in ``dtype``, the state and parameters fp32 as the model's
    ``decode_view`` gives them."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    di, n, r = M1_D_INNER, M1_D_STATE, M1_DT_RANK
    xz = _rand(g, (b, 2 * di), 1.0, dev, dtype)
    return dict(
        xs_raw=xz[:, :di], z=xz[:, di:],
        conv_state=_rand(g, (b, WIDTH - 1, di), 1.0, dev, dtype),
        ssm_state=_rand(g, (b, di, n), 1.0, dev, f32),
        conv_w=_rand(g, (WIDTH, di), 0.3, dev, f32),
        conv_b=_rand(g, (di,), 0.1, dev, f32),
        xproj_w=_rand(g, (di, r + 2 * n), di ** -0.5, dev, f32),
        dtproj_w=_rand(g, (r, di), 0.1, dev, f32),
        dtproj_b=_rand(g, (di,), 0.1, dev, f32),
        A=-torch.exp(torch.randn(di, n, generator=g) * 0.5).to(dev),
        D=_rand(g, (di,), 1.0, dev, f32))


def sscan_inputs(b, dev, dtype, seed, with_d=True):
    """Kernel 4's operands at mamba-130m's widths: state (b, 1536, 16)
    fp32, u (b, 1536) in ``dtype``, dt, A, B, C (and D) fp32."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    di, n = M1_D_INNER, M1_D_STATE
    return (_rand(g, (b, di, n), 1.0, dev, f32), _rand(g, (b, di), 1.0, dev,
                                                        dtype),
            torch.rand(b, di, generator=g).mul(0.5).to(dev),
            -torch.exp(torch.randn(di, n, generator=g) * 0.5).to(dev),
            _rand(g, (b, n), 1.0, dev, f32), _rand(g, (b, n), 1.0, dev, f32),
            _rand(g, (di,), 1.0, dev, f32) if with_d else None)


def ssd_step_inputs(b, dev, dtype, seed):
    """Kernel 3's operands at mamba2-130m's step widths: state (b, 24, 64,
    128) fp32, x (b, 24, 64) in ``dtype``, dt (b, 24), A (24,), B, C (b,
    1, 128) fp32."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    return (_rand(g, (b, N_HEADS, HEAD_DIM, D_STATE), 1.0, dev, f32),
            _rand(g, (b, N_HEADS, HEAD_DIM), 1.0, dev, dtype),
            torch.rand(b, N_HEADS, generator=g).mul(0.5).to(dev),
            -torch.rand(N_HEADS, generator=g).mul(1.9).add(0.1).to(dev),
            _rand(g, (b, N_GROUPS, D_STATE), 1.0, dev, f32),
            _rand(g, (b, N_GROUPS, D_STATE), 1.0, dev, f32))


def rglru_inputs(b, dev, dtype, seed):
    """Kernel 6's operands at recurrentgemma-2b's width: u, gate and the
    conv tail in ``dtype``, h fp32, the gate weights in ``dtype`` (as the
    model stores them) at std 1/sqrt(w), so that the gates sit in the
    sigmoid's working range; the small parameters fp32, as the model's
    ``decode_view`` hands them over."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32, w = torch.float32, RG_W
    return dict(
        u=_rand(g, (b, w), 1.0, dev, dtype),
        gate=_rand(g, (b, w), 1.0, dev, dtype),
        conv_state=_rand(g, (b, WIDTH - 1, w), 1.0, dev, dtype),
        h_state=_rand(g, (b, w), 1.0, dev, f32),
        conv_w=_rand(g, (WIDTH, w), 0.5, dev, f32),
        conv_b=_rand(g, (w,), 0.1, dev, f32),
        rg_w=_rand(g, (w, w), w ** -0.5, dev, dtype),
        rg_b=_rand(g, (w,), 0.1, dev, f32),
        ig_w=_rand(g, (w, w), w ** -0.5, dev, dtype),
        ig_b=_rand(g, (w,), 0.1, dev, f32),
        lam=_rand(g, (w,), 0.5, dev, f32))


def rglru_cold(step, ins, sets=3):
    """Kernel 6 with its gate weights cold: a call of ``step`` on ``ins``
    that takes the next of ``sets`` copies of rg_w and ig_w in turn (three
    at recurrentgemma-2b's bf16 width: 78.6 MB, past the 50 MB L2, as the
    model's 18 layers find their gates), and the copies' MB."""
    copies = [(ins["rg_w"], ins["ig_w"])] + [
        (ins["rg_w"].clone(), ins["ig_w"].clone()) for _ in range(sets - 1)]
    turn = itertools.cycle(copies)

    def cold():
        w, v = next(turn)
        return step(**dict(ins, rg_w=w, ig_w=v))
    mb = sum(2 * w.numel() * w.element_size() for w, _ in copies) / 1e6
    return cold, mb


def rg_scan_inputs(b, l, dev, dtype, seed):
    """Kernel 8's operands: decays a in (0, 1) and inputs b, (b, l, 2560)
    in ``dtype``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b, l, RG_W), generator=g).to(dev).to(dtype),
            _rand(g, (b, l, RG_W), 1.0, dev, dtype))


def mpwl_inputs(m, dev, dtype, seed, gated):
    """Kernel 11's operands at recurrentgemma-2b's MLP: x (m, 2560), wg
    (and wi, gated) (2560, 7680) at std 1/sqrt(2560), all in ``dtype``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    x = _rand(g, (m, RG_W), 1.0, dev, dtype)
    w = _rand(g, (RG_W, RG_D_FF), RG_W ** -0.5, dev, dtype)
    v = _rand(g, (RG_W, RG_D_FF), RG_W ** -0.5, dev, dtype) if gated else None
    return x, w, v


def flash_inputs(b, hq, hkv, l, d, dev, dtype, seed):
    """Kernel 9's q, k, v as the model hands them over: (b, l, h, d)
    projections seen as (b, h, l, d), no copy."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return tuple(_rand(g, (b, l, h, d), 1.0, dev, dtype).transpose(1, 2)
                 for h in (hq, hkv, hkv))


def _bf16_steps(diff, r):
    """``diff`` in bf16 steps at ``|r|`` (the spacing of bf16 values
    there: 2^(floor(log2|r|) - 7))."""
    import torch
    e = torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
    return diff / torch.exp2(e - 7)


FUSED_OUTS = (("y", "stream"), ("conv", "stream"), ("ssm", "state"))


def compare(name, got, want, dtype_name, outs=FUSED_OUTS):
    """Each output element by element against the plain version (``TOL``,
    ``ATOL_RMS``, ``MAX_OFF_SHARE``); prints the readings and returns
    (worst abs error, names of the outputs that failed).  ``outs`` names
    each output and its kind ("stream" in the case's dtype, "state"
    fp32)."""
    import torch
    worst, fails = 0.0, []
    for (out_name, kind), a, r in zip(outs, got, want):
        rtol = TOL[dtype_name, kind]
        a32, r32 = a.float(), r.float()
        diff = (a32 - r32).abs()
        rms = float(r32.square().mean().sqrt())
        tol = rtol * (r32.abs() + ATOL_RMS * rms)
        used = float((diff / tol.clamp_min(1e-30)).max())
        # The atol each element needs at this rtol, in units of rms.
        need = float(((diff / rtol - r32.abs()) / max(rms, 1e-30)).max())
        err = float(diff.max())
        ok = used <= 1.0 and a.dtype == r.dtype and a.shape == r.shape
        msg = (f"  {name} {out_name}: max_abs_err {err:.3e}; worst element "
               f"at {used:.4f} of its tolerance (rtol {rtol:.3g}, atol "
               f"needed {max(need, 0.0):.3f} x rms of {ATOL_RMS:g})")
        if a.dtype == torch.bfloat16:
            n_off = int((diff > 0).sum())
            n_over = int((_bf16_steps(diff, r32) > 1).sum())
            msg += (f"; {n_off} of {diff.numel()} elements differ "
                    f"({n_off / diff.numel():.4%}), {n_over} by more than "
                    f"one bf16 step")
            ok = ok and n_off <= max(2, MAX_OFF_SHARE * diff.numel())
        print(msg + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            fails.append(f"{name} {out_name}")
        worst = max(worst, err)
    return worst, fails


# The SSD chain's shapes in the ablation phase (b = 4, l = 300 padded to
# two chunks of 256 inside ``ssd``).
CHAIN_B, CHAIN_L, CHUNK = 4, 300, 256
CHAIN_C = -(-CHAIN_L // CHUNK)


def chain_inputs(dev, dtype, seed):
    """Operands of kernels 13, 7 and 12 at the chain's full width: the
    per-chunk log decays a_c (b, h, c, L) and their prefix sums, the
    dt-scaled x, B and C of ``ssd``, and the xBC, dt and gate streams the
    SiLU and softplus tables act on (the ``pallas()`` forward's three
    ``pwl_activate`` calls a layer)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    b, c, L = CHAIN_B, CHAIN_C, CHUNK
    a_c = (-torch.rand(b, N_HEADS, c, L, generator=g) * 0.95 - 0.05)
    return dict(
        a_c=a_c.to(dev).to(dtype),
        A_cum=torch.cumsum(a_c, dim=-1).to(dev),
        x_c=_rand(g, (b, c, L, N_HEADS, HEAD_DIM), 0.5, dev, dtype),
        B_c=_rand(g, (b, c, L, N_GROUPS, D_STATE), 0.5, dev, dtype),
        C_c=_rand(g, (b, c, L, N_GROUPS, D_STATE), 0.5, dev, dtype),
        xbc=_rand(g, (b, CHAIN_L, D_XBC), 2.0, dev, dtype),
        dt=_rand(g, (b, CHAIN_L, N_HEADS), 2.0, dev, dtype),
        z=_rand(g, (b, CHAIN_L, D_INNER), 2.0, dev, dtype))


# Kernel 2's phase-3 cases (b, l, chunk, ActiBA): the wave serve's call
# (one chunk of 128), the continuous engine's (one chunk of 64), two chunks
# of 256 and four of 64 (the carried state between chunks; all with a
# nonzero incoming state) on the tensor-core body; a chunk of 32 on the
# SIMT body; the ActiBA tables at one and two chunks.
PREFILL_CASES = ((4, 128, 128, False), (4, 64, 64, False),
                 (4, 512, 256, False), (2, 256, 64, False),
                 (4, 128, 32, False), (4, 128, 128, True),
                 (4, 512, 256, True))


def card_case_inputs(dev, dtype, b, l, h, p, g, n, w, seed):
    """``tests/test_torch_cuda.py: _inputs``'s operands, drawn in its
    order (its seed-280 case is the wave serve's kernel-2 call: b 4, l
    128, chunk 128, 24 heads of 64, d_state 128)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    di = h * p
    dxbc = di + 2 * g * n
    r = lambda *s, scale=1.0, dtype=dtype: (        # noqa: E731
        torch.randn(s, generator=gen) * scale).to(dev).to(dtype)
    return dict(
        z=r(b, l, di), xbc=r(b, l, dxbc), dt=r(b, l, h),
        conv_state=r(b, w - 1, dxbc),
        ssm_state=(torch.randn(b, h, p, n, generator=gen) * 0.1).to(dev),
        conv_w=r(w, dxbc, scale=0.3, dtype=f32),
        conv_b=r(dxbc, scale=0.1, dtype=f32),
        dt_bias=r(h, scale=0.1, dtype=f32),
        A=-torch.exp(torch.randn(h, generator=gen) * 0.3).to(dev),
        D=r(h, scale=0.2, dtype=f32), norm_scale=r(di, dtype=f32).abs() + 0.5)


def witness_prefill(ins, *, ngroups, head_dim, eps=1e-6):
    """Kernel 2's function in fp64, written apart from the port: the
    causal conv over the carried tail, the SSD recurrence token by token
    (no chunks, no prefix sums), the D skip and the gated norm, with the
    stream dtype's rounding points where ``mamba2_prefill_plain`` and the
    TPU kernel take them (the activated streams, y, the D skip's product
    and sum, the normalised row, SiLU(z) and the gate's product).
    Returns (out in the stream dtype, the new state fp64)."""
    import torch
    F = torch.nn.functional
    z, xbc, dt = ins["z"], ins["xbc"], ins["dt"]
    sd = z.dtype

    def d(t):
        return t.double()

    def rnd(t):
        return t.to(sd).double()
    b, l, di = z.shape
    h, g, p = dt.shape[-1], ngroups, head_dim
    n = (xbc.shape[-1] - di) // (2 * g)
    w = ins["conv_w"].shape[0]
    full = torch.cat([d(ins["conv_state"]), d(xbc)], dim=1)
    conv = sum(full[:, j:j + l] * d(ins["conv_w"][j]) for j in range(w)) \
        + d(ins["conv_b"])
    act = rnd(F.silu(rnd(conv)))
    xs = act[..., :di].reshape(b, l, h, p)
    B = act[..., di:di + g * n].reshape(b, l, g, n).repeat_interleave(
        h // g, dim=2)
    C = act[..., di + g * n:].reshape(b, l, g, n).repeat_interleave(
        h // g, dim=2)
    dtf = F.softplus(d(dt) + d(ins["dt_bias"]))
    A = d(ins["A"])
    state = d(ins["ssm_state"])
    ys = []
    for t in range(l):
        state = state * torch.exp(dtf[:, t] * A)[..., None, None] + \
            (dtf[:, t, :, None] * xs[:, t])[..., None] * B[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t]))
    y = torch.stack(ys, dim=1)
    y = rnd(rnd(y) + rnd(xs * rnd(d(ins["D"]))[None, None, :, None]))
    y = y.reshape(b, l, di)
    yn = rnd(y * torch.rsqrt((y * y).mean(-1, keepdim=True) + eps)
             * d(ins["norm_scale"]))
    return rnd(yn * rnd(F.silu(d(z)))).to(sd), state


def prefill_witness_check(dev, kernels):
    """Phase 3's check of kernel 2 against its function: the card test's
    seed-280 inputs (bf16), the output of both kernel bodies and of
    ``mamba2_prefill_plain``, each held to the fp64 witness
    (``witness_prefill``): every element within ``PREFILL_WITNESS_X`` of
    the phase's element-wise limit, and fewer than
    ``PREFILL_WITNESS_OFF`` of the elements off it at all.  Returns the
    names of the outputs that failed."""
    import torch
    kw = dict(ngroups=1, head_dim=64, chunk=128)
    ins = card_case_inputs(dev, torch.bfloat16, 4, 128, 24, 64, 1, 128, 4,
                           seed=280)
    want = witness_prefill(ins, ngroups=1, head_dim=64)[0].float()
    got = {"wgmma body": kernels["mamba2_prefill"](**ins, **kw),
           "SIMT body": simt_prefill(ins, 128),
           "plain": kernels["mamba2_prefill_plain"](**ins, **kw)}
    torch.cuda.synchronize(dev)
    rms = float(want.square().mean().sqrt())
    print("  kernel 2's seed-280 case (bf16, b=4 l=128 chunk 128) against "
          f"the fp64 witness: every element within {PREFILL_WITNESS_X} of "
          f"the phase-3 limit, fewer than {PREFILL_WITNESS_OFF:.1%} of "
          "them off it", flush=True)
    fails = []
    for label, outs in got.items():
        diff = (outs[0].float() - want).abs()
        used = float((diff / (TOL["bfloat16", "stream"] * (
            want.abs() + ATOL_RMS * rms))).max())
        n_off = int((diff > 0).sum())
        ok = used < PREFILL_WITNESS_X and \
            n_off < PREFILL_WITNESS_OFF * diff.numel()
        print(f"    {label}: worst element at {used:.4f} of the limit; "
              f"{n_off} of {diff.numel()} elements differ, "
              f"{int((_bf16_steps(diff, want) > 1).sum())} by more than one "
              f"bf16 step" + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            fails.append(f"mamba2_prefill {label} vs witness")
    return fails


def offset_view(x):
    """A copy of ``x`` whose base lies one element past a fresh (aligned)
    allocation: contiguous, not 16-byte aligned."""
    import torch
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = base[1:].view(x.shape)
    view.copy_(x)
    return view


def kernel_cases(dev, kernels, tables):
    """Phase 3: every kernel against its plain version on the card.  Every
    case is printed; the phase fails at its end if any output failed.
    ``tables``: the ActiBA tables (``silu``, ``softplus``, ``sigmoid``,
    ``gelu``) of ``XambaConfig.pallas()``."""
    import torch
    from repro_torch.core.pwl import get_table
    from repro_torch.kernels.actiba import path as actiba_path
    from repro_torch.kernels.flash_attention import path as flash_path
    from repro_torch.kernels.prefill_chunk import path as prefill_path
    from repro_torch.kernels.qmatmul import path as qmatmul_path
    from repro_torch.kernels.ssd_chunk import path as ssd_chunk_path
    kw = dict(ngroups=N_GROUPS, head_dim=HEAD_DIM)
    worst = {k: 0.0 for k in ("mamba2_step", "mamba2_prefill", "cumsum_last",
                              "ssd_chunk", "pwl_activate", "qmatmul",
                              "mamba1_step", "sscan_step", "ssd_step",
                              "rglru_step", "rg_lru_scan", "matmul_pwl",
                              "flash_attention", "reduce_rows")}
    fails = []
    ktab = dict(silu_table=tables["silu"], softplus_table=tables["softplus"])
    pact = {k: (lambda v, t=tables[k]: kernels["pwl_activate_plain"](v, t))
            for k in ("silu", "softplus")}

    def check(kernel, case, got, want, dn, outs=FUSED_OUTS):
        err, bad = compare(f"{kernel} {case}", got, want, dn, outs)
        worst[kernel] = max(worst[kernel], err)
        fails.extend(bad)

    def twice(kernel, case, call, plain, dn, outs=FUSED_OUTS):
        """``call()`` twice (the same bits both times) against
        ``plain()``."""
        got, again = call(), call()
        want = plain()
        torch.cuda.synchronize(dev)
        check(kernel, case, got, want, dn, outs)
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            print(f"  {kernel} {case}: a second call gave other bits FAIL")
            fails.append(f"{kernel} {case} repeat")

    def routed(kernel, case, rule, call, plain, dn, outs):
        """``twice``, with the body both calls took by the wrapper's path
        counts: it must be ``rule``, the body the shape rule names (the
        tensor-core ``wgmma`` body for bf16 operands it can read)."""
        counts = kernels[kernel].path_launches
        before = dict(counts)
        twice(kernel, case, call, plain, dn, outs)
        took = {k: v - before[k] for k, v in counts.items() if v != before[k]}
        ok = took == {rule: 2}
        print(f"    body: {took} (the shape rule names {rule})"
              + ("" if ok else " FAIL"), flush=True)
        if not ok:
            fails.append(f"{kernel} {case} body")

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b in (1, 4):
            ins = decode_inputs(b, dev, dtype, seed=10 + b)
            twice("mamba2_step", f"{dn} b={b}",
                  lambda: kernels["mamba2_step"](**ins, **kw),
                  lambda: kernels["mamba2_step_plain"](**ins, **kw), dn)
        twice("mamba2_step", f"{dn} b=4 actiba",
              lambda: kernels["mamba2_step"](**ins, **kw, **ktab),
              lambda: kernels["mamba2_step_plain"](**ins, **kw, **pact), dn)
        for b, l, chunk, actiba in PREFILL_CASES:
            ins = prefill_inputs(b, l, dev, dtype, seed=20 + l)
            tk, tp = (ktab, pact) if actiba else ({}, {})
            routed("mamba2_prefill", f"{dn} b={b} l={l} chunk={chunk}"
                   + (" actiba" if actiba else ""),
                   prefill_path(ins["xbc"], ins["ssm_state"], chunk=chunk,
                                head_dim=HEAD_DIM),
                   lambda: kernels["mamba2_prefill"](**ins, chunk=chunk,
                                                     **kw, **tk),
                   lambda: kernels["mamba2_prefill_plain"](
                       **ins, chunk=chunk, **kw, **tp), dn, FUSED_OUTS)

        if dtype == torch.bfloat16:
            fails.extend(prefill_witness_check(dev, kernels))

        ch = chain_inputs(dev, dtype, seed=30)
        got = kernels["cumsum_last"](ch["a_c"])
        want = kernels["cumsum_last_plain"](ch["a_c"])
        torch.cuda.synchronize(dev)
        check("cumsum_last", f"{dn} {tuple(ch['a_c'].shape)}", (got,),
              (want,), dn, (("A_cum", "stream"),))
        args = (ch["x_c"], ch["A_cum"], ch["B_c"], ch["C_c"])
        routed("ssd_chunk", f"{dn} inputs b={CHAIN_B} c={CHAIN_C} L={CHUNK}",
               ssd_chunk_path(*args), lambda: kernels["ssd_chunk"](*args),
               lambda: kernels["ssd_chunk_plain"](*args), dn,
               (("y_diag", "state"), ("states", "state")))
        pwl_cases = [(name, f"{name} table", tables[name], x)
                     for name, x in (("silu", ch["xbc"]),
                                     ("softplus", ch["dt"]),
                                     ("silu", ch["z"]))]
        # Tables padded to 15 and 127 terms, and an operand 4 bytes off
        # 16-byte alignment (the scalar body).
        pwl_cases += [("silu", f"silu {k} segments", get_table("silu",
                                                               segments=k),
                       ch["xbc"]) for k in (12, 100)]
        pwl_cases.append(("silu", "silu table, offset view", tables["silu"],
                          offset_view(ch["xbc"])))
        for name, label, table, x in pwl_cases:
            routed("pwl_activate", f"{dn} {label} {tuple(x.shape)}",
                   actiba_path(x),
                   lambda: (kernels["pwl_activate"](x, table),),
                   lambda: (kernels["pwl_activate_plain"](x, table),), dn,
                   ((name, "stream"),))
            if dtype == torch.float32:
                same = torch.equal(kernels["pwl_activate"](x, table),
                                   kernels["pwl_activate_plain"](x, table))
                print(f"    bit-identical to the plain version: {same}"
                      + ("" if same else " FAIL"), flush=True)
                if not same:
                    fails.append(f"pwl_activate {dn} {label} bits")
        m1kw = dict(dt_rank=M1_DT_RANK)
        for b in (1, 4):
            ins = mamba1_inputs(b, dev, dtype, seed=50 + b)
            twice("mamba1_step", f"{dn} b={b}",
                  lambda: kernels["mamba1_step"](**ins, **m1kw),
                  lambda: kernels["mamba1_step_plain"](**ins, **m1kw), dn)
        twice("mamba1_step", f"{dn} b=4 actiba",
              lambda: kernels["mamba1_step"](**ins, **m1kw, **ktab),
              lambda: kernels["mamba1_step_plain"](**ins, **m1kw, **pact), dn)
        bare = (("ssm", "state"), ("y", "stream"))
        for with_d in (True, False):
            args = sscan_inputs(4, dev, dtype, seed=60, with_d=with_d)
            twice("sscan_step", f"{dn} b=4 d={M1_D_INNER} n={M1_D_STATE} "
                  + ("with D" if with_d else "without D"),
                  lambda: kernels["sscan_step"](*args),
                  lambda: kernels["sscan_step_plain"](*args), dn, bare)
        args = sscan_inputs(4, dev, dtype, seed=64)
        args = (offset_view(args[0]),) + args[1:]
        twice("sscan_step", f"{dn} b=4 d={M1_D_INNER} n={M1_D_STATE} with D, "
              f"the state an offset view (the element path)",
              lambda: kernels["sscan_step"](*args),
              lambda: kernels["sscan_step_plain"](*args), dn, bare)
        args = ssd_step_inputs(4, dev, dtype, seed=61)
        twice("ssd_step", f"{dn} b=4 h={N_HEADS} p={HEAD_DIM} n={D_STATE} "
              f"g={N_GROUPS}", lambda: kernels["ssd_step"](*args),
              lambda: kernels["ssd_step_plain"](*args), dn, bare)
        rtab = {f"{k}_table": tables[k] for k in ("sigmoid", "softplus",
                                                    "gelu")}
        ract = {k: (lambda v, t=tables[k]: kernels["pwl_activate_plain"](
            v, t)) for k in ("sigmoid", "softplus", "gelu")}
        rg_outs = (("y", "stream"), ("conv", "stream"), ("h", "state"))
        for b in (1, 4):
            ins = rglru_inputs(b, dev, dtype, seed=80 + b)
            twice("rglru_step", f"{dn} b={b} w={RG_W}",
                  lambda: kernels["rglru_step"](**ins),
                  lambda: kernels["rglru_step_plain"](**ins), dn, rg_outs)
            twice("rglru_step", f"{dn} b={b} w={RG_W} actiba",
                  lambda: kernels["rglru_step"](**ins, **rtab),
                  lambda: kernels["rglru_step_plain"](**ins, **ract), dn,
                  rg_outs)
        for l in (256, 300):
            a, bb = rg_scan_inputs(4, l, dev, dtype, seed=90 + l)
            twice("rg_lru_scan", f"{dn} (4, {l}, {RG_W})",
                  lambda: (kernels["rg_lru_scan"](a, bb),),
                  lambda: (kernels["rg_lru_scan_plain"](a, bb),), dn,
                  (("h", "stream"),))
        for m in (4, 512):
            for gated in (False, True):
                x, w, v = mpwl_inputs(m, dev, dtype, seed=m + gated,
                                      gated=gated)
                rule = "gemv" if m <= 8 else (
                    "wgmma" if dtype == torch.bfloat16 else "tiled")
                routed("matmul_pwl", f"{dn} {'gated' if gated else 'pwl'} "
                       f"(gelu table) x ({m}, {RG_W}) w ({RG_W}, {RG_D_FF})",
                       rule,
                       lambda: (kernels["matmul_pwl"](x, w, tables["gelu"],
                                                      v),),
                       lambda: (kernels["matmul_pwl_plain"](
                           x, w, tables["gelu"], v),), dn,
                       (("out", "stream"),))
        for label, b, hq, hkv, l, d, causal, window in FLASH_CASES:
            q, k, v = flash_inputs(b, hq, hkv, l, d, dev, dtype,
                                   seed=l + d + hq)
            fkw = dict(causal=causal, window=window)
            routed("flash_attention", f"{dn} {label}: b={b} hq={hq} "
                   f"hkv={hkv} L={l} d={d}"
                   + ("" if causal else " not causal")
                   + (f" window {window}" if window else ""),
                   flash_path(q, k, v),
                   lambda: (kernels["flash_attention"](q, k, v, **fkw),),
                   lambda: (kernels["flash_attention_plain"](q, k, v,
                                                             **fkw),),
                   dn, (("out", "stream"),))
        # The SIMT body: gemma's prefill shape with q one element into its
        # buffer (TMA cannot read it).
        q, k, v = flash_inputs(4, 8, 1, 128, 256, dev, dtype, seed=300)
        q = offset_view(q)
        routed("flash_attention", f"{dn} gemma prefill, q an offset view: "
               f"b=4 hq=8 hkv=1 L=128 d=256", flash_path(q, k, v),
               lambda: (kernels["flash_attention"](q, k, v, causal=True),),
               lambda: (kernels["flash_attention_plain"](q, k, v,
                                                         causal=True),),
               dn, (("out", "stream"),))
        for m, n in REDUCE_CASES:
            x = _rand(torch.Generator().manual_seed(m + n), (m, n), 1.0, dev,
                      dtype)
            twice("reduce_rows", f"{dn} ({m}, {n})",
                  lambda: (kernels["reduce_rows"](x),),
                  lambda: (kernels["reduce_rows_plain"](x),), dn,
                  (("sum", "stream"),))
        for case, args, qkw in qmatmul_cases(dev, dtype, tables):
            routed("qmatmul", f"{dn} {case}",
                   qmatmul_path(*args[:2], qkw.get("qv")),
                   lambda: (kernels["qmatmul"](*args, **qkw),),
                   lambda: (kernels["qmatmul_plain"](*args, **qkw),), dn,
                   (("out", "stream"),))
    if fails:
        raise AssertionError(f"kernels vs plain: {fails}")
    return worst


def qmatmul_inputs(m, k, n, dev, dtype, seed, gated=False):
    """x (m, k) in ``dtype``; the int8 weight and scale of a random (k, n)
    weight (and a second one, gated) as ``nn/quant.py`` makes them."""
    import torch
    from repro_torch.nn.quant import quantize_tensor
    g = torch.Generator().manual_seed(seed)
    x = _rand(g, (m, k), 1.0, dev, dtype)
    ws = [quantize_tensor(_rand(g, (k, n), 1.0, dev, torch.float32))
          for _ in range(2 if gated else 1)]
    args = (x, ws[0].q, ws[0].scale.reshape(-1))
    kw = dict(qv=ws[1].q, vscale=ws[1].scale.reshape(-1)) if gated else {}
    return args, kw


def qmatmul_cases(dev, dtype, tables):
    """Phase 3's qmatmul cases: (label, args, kwargs)."""
    out = []
    for name, k, n, ms in QMM_CASES:
        for m in ms:
            args, kw = qmatmul_inputs(m, k, n, dev, dtype, seed=m + k + n)
            out.append((f"{name} x ({m}, {k}) q ({k}, {n})", args, kw))
    m, k, n = QMM_MLP
    for form in ("pwl", "gated"):
        args, kw = qmatmul_inputs(m, k, n, dev, dtype, seed=7,
                                  gated=form == "gated")
        out.append((f"{form} (silu table) x ({m}, {k}) q ({k}, {n})", args,
                    dict(kw, table=tables["silu"])))
    return out


SERVE_ARGV = ["--arch", "mamba2-130m", "--requests", "8", "--batch", "4",
              "--prompt-len", "128", "--max-new", "16", "--temperature", "0",
              "--seed", "0"]


def path_launches(cfg, steps, prefills, w8=False) -> dict:
    """The launches a serve run of ``cfg`` must make: each decode step
    runs the family's fused step once a layer (recurrentgemma: once a
    recurrent layer); a mamba2 prefill (a wave or a chunk call) the fused
    prefill once a layer (mamba1's and recurrentgemma's prefills are
    plain ops); under W8 every decode step and prefill call runs two
    qmatmuls a layer (in_proj, out_proj); under ActiBA with a ``pallas``
    CumBA mode recurrentgemma's MLP runs ``matmul_pwl`` once a layer in
    every decode step and prefill call."""
    n = cfg.n_layers
    if cfg.family == "recurrentgemma":
        pattern = cfg.block_pattern
        n_rec = sum(pattern[i % len(pattern)] == "recurrent"
                    for i in range(n))
        want = {"rglru_step": n_rec * steps}
        if cfg.xamba.actiba and cfg.xamba.cumba.startswith("pallas"):
            want["matmul_pwl"] = n * (steps + prefills)
        return want
    step = "mamba2_step" if cfg.family == "mamba2" else "mamba1_step"
    want = {step: n * steps}
    if cfg.family == "mamba2":
        want["mamba2_prefill"] = n * prefills
    if w8:
        want["qmatmul"] = 2 * n * (steps + prefills)
    return want


def prefill_bodies(counters, label):
    """Every ``mamba2_prefill`` launch of the run just made took the
    tensor-core body (the serve shapes: one chunk of 128 or of 64)."""
    fn = counters["mamba2_prefill"]
    bodies = dict(fn.path_launches)
    print(f"  mamba2_prefill by body: {bodies} (all {fn.launches} on the "
          f"wgmma body expected)", flush=True)
    assert bodies == {"wgmma": fn.launches, "simt": 0}, \
        f"{label}: mamba2_prefill off the tensor-core body"


def serve_phase(serve_main, counters, argv):
    """Phase 4: the CLI's wave engine; returns (engine, launches, steps,
    waves)."""
    import torch
    reset_counts(counters)
    t0 = time.perf_counter()
    engine, done = serve_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    cfg = engine.model.cfg
    m = engine.metrics.summary()
    waves = math.ceil(len(done) / engine.cfg.max_batch)
    steps = m["decode_steps"]
    toks = [t for r in done for t in r.out_tokens]
    assert len(done) == 8 and all(len(r.out_tokens) == 16 for r in done), \
        "serve: every request must get 16 tokens"
    assert all(0 <= t < cfg.vocab_size for t in toks), "serve: token id"
    assert m["logit_rows"] > 0 and m["nonfinite_logit_rows"] == 0, \
        f"serve: non-finite logits {m['nonfinite_logit_rows']}"
    want = dict({k: 0 for k in launches}, **path_launches(
        cfg, steps=steps, prefills=waves))
    print(f"  launches {launches} expected {want} "
          f"({waves} waves, {steps} decode steps, {cfg.n_layers} layers)")
    assert launches == want, "serve: kernel launch counts"
    prefill_bodies(counters, "serve")
    assert steps > 0 and waves > 0, "serve: a kernel idle"
    st = engine.stats(done)
    print(f"  generated {st['generated_tokens']} tokens in "
          f"{st['wall_s']:.4f} s of waves: {st['tokens_per_s']:.1f} tok/s; "
          f"ttft_mean_s {m['ttft_mean_s']:.4f} ttft_p99_s "
          f"{m['ttft_p99_s']:.4f}; decode step mean "
          f"{m['token_latency_s'] * 1e3:.3f} ms; call wall {wall:.3f} s "
          f"(weights included)", flush=True)
    return engine, launches, steps, waves


def serve_modes_phase(serve_main, counters, cfg, dev):
    """Phase 4, continued: the CLI's unfused modes, then an ``Engine``
    under ``XambaConfig.pallas()`` (prompts in both buckets: the 128
    bucket takes the fused prefill with ActiBA tables, the 32 bucket's
    chunk 32 is below the kernels' 64-row tiles and takes the unfused
    chain with ``pwl_activate`` and ``cumsum_last``)."""
    import numpy as np
    import torch
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    from repro_torch.serve import Engine, ServeConfig

    reset_counts(counters)
    argv = SERVE_ARGV[:] + ["--prefill-mode", "naive", "--decode-mode",
                            "naive"]
    argv[argv.index("--requests") + 1] = "4"
    argv[argv.index("--max-new") + 1] = "4"
    t0 = time.perf_counter()
    _, done = serve_main(argv)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    toks = [t for r in done for t in r.out_tokens]
    print(f"  naive modes (CLI): {len(done)} requests, {len(toks)} tokens "
          f"in {time.perf_counter() - t0:.3f} s; launches {launches}",
          flush=True)
    assert len(done) == 4 and all(len(r.out_tokens) == 4 for r in done)
    assert all(0 <= t < cfg.vocab_size for t in toks)
    assert all(v == 0 for v in launches.values()), \
        "naive modes must launch no kernel"

    pcfg = cfg.replace(xamba=XambaConfig.pallas())
    model = build_model(pcfg, dev)
    params = init_params(model.param_specs(), 0, pcfg.dtype, dev)
    engine = Engine(model, params, ServeConfig(
        max_batch=4, prefill_buckets=(32, 128), max_new_tokens=6))
    rng = np.random.default_rng(5)
    for n in (20, 7, 30, 12, 100, 128, 90, 64):   # a 32 wave, a 128 one
        engine.submit(rng.integers(1, pcfg.vocab_size, n).tolist())
    reset_counts(counters)
    done = engine.run()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    m = engine.metrics.summary()
    toks = [t for r in done for t in r.out_tokens]
    print(f"  pallas() + ActiBA (Engine): {len(done)} requests, "
          f"{len(toks)} tokens, {m['decode_steps']} decode steps; launches "
          f"{launches}", flush=True)
    assert len(done) == 8 and all(len(r.out_tokens) == 6 for r in done)
    assert all(0 <= t < pcfg.vocab_size for t in toks)
    assert m["nonfinite_logit_rows"] == 0
    assert launches["mamba2_step"] == pcfg.n_layers * m["decode_steps"]
    for k in ("mamba2_prefill", "pwl_activate", "cumsum_last"):
        assert launches[k] > 0, f"pallas serve: {k} idle"
    prefill_bodies(counters, "pallas serve")
    print(f"  pallas serve: pwl_activate launches by body "
          f"{dict(counters['pwl_activate'].path_launches)}", flush=True)


CONT_ARGV = ["--arch", "mamba2-130m", "--engine", "continuous",
             "--prefill-chunk", "64", "--requests", "12", "--batch", "4",
             "--prompt-len", "128", "--max-new", "16", "--temperature", "0",
             "--seed", "0"]


def continuous_phase(serve_main, counters, argv):
    """Phase 4, continued: the continuous engine with chunked prefill
    through the CLI.  Returns (engine, launches, qmatmul launches by
    path)."""
    import torch
    reset_counts(counters)
    t0 = time.perf_counter()
    engine, done = serve_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    paths = dict(counters["qmatmul"].path_launches)
    cfg = engine.model.cfg
    m = engine.metrics.summary()
    steps, calls = m["decode_steps"], m["prefill_chunks"]
    w8 = "--quant" in argv
    label = "W8" if w8 else "bf16"
    toks = [t for r in done for t in r.out_tokens]
    assert len(done) == 12 and all(len(r.out_tokens) == 16 for r in done), \
        f"continuous {label}: every request must get 16 tokens"
    assert all(0 <= t < cfg.vocab_size for t in toks), "continuous: token"
    assert m["logit_rows"] > 0 and m["nonfinite_logit_rows"] == 0, \
        f"continuous {label}: non-finite logits {m['nonfinite_logit_rows']}"
    n = cfg.n_layers
    want = dict({k: 0 for k in launches}, **path_launches(
        cfg, steps=steps, prefills=calls, w8=w8))
    want_paths = dict(gemv=2 * n * steps if w8 else 0,
                      wgmma=2 * n * calls if w8 else 0, tiled=0)
    print(f"  continuous {cfg.name} {label} (chunk 64): launches "
          f"{launches}, qmatmul "
          f"by path {paths}; expected {want}, {want_paths} ({steps} decode "
          f"steps, {calls} chunk calls, {n} layers)")
    assert launches == want and paths == want_paths, \
        f"continuous {label}: kernel launch counts"
    prefill_bodies(counters, f"continuous {label}")
    assert steps > 0 and calls > 0, f"continuous {label}: a path idle"
    print(f"  generated {m['generated_tokens']} tokens: "
          f"{m['tokens_per_s']:.1f} tok/s; ttft_mean_s "
          f"{m['ttft_mean_s']:.4f} ttft_p99_s {m['ttft_p99_s']:.4f}; "
          f"occupancy {m['slot_occupancy']:.4f}; decode step mean "
          f"{m['token_latency_s'] * 1e3:.3f} ms; {m['prefill_tokens']} "
          f"prompt tokens in {m['prefill_time_s']:.4f} s of chunk calls; "
          f"call wall {wall:.3f} s", flush=True)
    return engine, launches, paths


def parity_phase(dev, seed, cfg, counters, quant_mode="none"):
    """Phase 5: fp32 kernel path (card) vs plain path (CPU), teacher
    forced over the kernel path's own greedy tokens; ``quant_mode``
    quantizes the fp32 weights first (the same int8 weights on both).
    The logit tolerance is ``LOGIT_TOL``; for mamba1 (family ``mamba``)
    the card is held to the fp64 witness instead, within ``M1_WITNESS_X``
    times the CPU plain path's distance from it (at least
    ``LOGIT_TOL``).  Returns the tolerance used for the margins."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.nn import quant
    from repro_torch.nn.params import init_params

    cfg = cfg.replace(param_dtype="float32").with_quant(quant_mode)
    gpu = build_model(cfg, dev)
    cpu = build_model(cfg, "cpu")
    params = quant.quantize_params_for_mode(
        init_params(gpu.param_specs(), seed, torch.float32, dev), quant_mode)
    cparams = _move(params, "cpu")
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(4, 128)).astype(np.int64))

    def run(model, p, device, forced):
        cache = model.init_cache(4, dtype=torch.float32)
        logits, cache = model.prefill(p, {"tokens": prompts.to(device)},
                                      cache)
        outs = [logits.cpu()]
        for t in range(15):
            tok = forced[:, t:t + 1] if forced is not None else \
                outs[-1].argmax(-1, keepdim=True)
            logits, cache = model.decode_step(p, tok.to(device), cache, t)
            outs.append(logits.cpu())
        return torch.stack(outs, 1)                  # (4, 16, vocab)

    with torch.inference_mode():
        reset_counts(counters)
        lk = run(gpu, params, dev, None)
        counts = read_counts(counters)
        forced = lk.argmax(-1)                       # kernel path's tokens
        lp = run(cpu, cparams, "cpu", forced)
    tol, err = LOGIT_TOL, float((lk - lp).abs().max())
    if cfg.family == "mamba":
        t0 = time.perf_counter()
        lw = witness_mamba1(cparams, cfg, prompts, forced)
        cpu_err = float((lp.double() - lw).abs().max())
        tol = max(LOGIT_TOL, M1_WITNESS_X * cpu_err)
        card_err = float((lk.double() - lw).abs().max())
        print(f"  fp64 witness ({time.perf_counter() - t0:.1f} s): CPU plain "
              f"path {cpu_err:.3e} from it, the card {card_err:.3e} (tol "
              f"{tol:.3e}); card vs CPU {err:.3e}")
        assert card_err <= tol, f"parity: card {card_err} from the witness"
        err = card_err
    want = dict({k: 0 for k in counts}, **path_launches(
        cfg, steps=15, prefills=1, w8=quant_mode != "none"))
    print(f"  {cfg.name}, weights "
          f"{quant_mode if quant_mode != 'none' else 'fp32'}: launches on "
          f"the card {counts} (expected {want})")
    assert counts == want, "parity: launches"
    top2 = lp.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    confident = margin > tol
    agree = (lk.argmax(-1) == lp.argmax(-1))
    print(f"  logits max_abs_err {err:.3e} (tol {tol:.3e}"
          + (", against the witness" if cfg.family == "mamba" else "")
          + "); "
          f"{int(confident.sum())}/{confident.numel()} positions above the "
          f"margin, {int(agree[confident].sum())} agree; "
          f"{int(agree.sum())}/{agree.numel()} agree overall", flush=True)
    assert torch.isfinite(lk).all() and torch.isfinite(lp).all()
    assert err <= tol, f"parity: logit error {err}"
    assert bool(agree[confident].all()), "parity: confident token differs"
    return tol


def witness_mamba1(params, cfg, prompts, forced):
    """fp64 logits (b, 16, V) of a Mamba-1 model on the CPU, written out
    apart from the port: fed token by token (the prompt, then the 15
    forced tokens), each block as Mamba-1 defines it (RMSNorm,
    in-projection, causal conv, SiLU, x_proj, softplus of dt_proj, the
    selective-scan recurrence, the D skip, the SiLU(z) gate,
    out-projection, residual); the final RMSNorm and the tied unembed at
    the last prompt position and after each forced token."""
    import torch

    def d(t):
        return t.detach().to("cpu", torch.float64)

    def rms(x, s):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * s

    di, n = cfg.expand * cfg.d_model, cfg.d_state
    r = cfg.dt_rank or math.ceil(cfg.d_model / 16)
    table = d(params["embed"]["table"])
    lays = [{"ln": d(p["ln"]["scale"]), "in": d(p["mixer"]["in_proj"]["w"]),
             "cw": d(p["mixer"]["conv"]["w"]), "cb": d(p["mixer"]["conv"]["b"]),
             "xp": d(p["mixer"]["x_proj"]["w"]),
             "dw": d(p["mixer"]["dt_proj"]["w"]),
             "db": d(p["mixer"]["dt_proj"]["b"]),
             "A": -torch.exp(d(p["mixer"]["A_log"])), "D": d(p["mixer"]["D"]),
             "out": d(p["mixer"]["out_proj"]["w"])} for p in params["layers"]]
    fnorm = d(params["final_norm"]["scale"])
    seq = torch.cat([prompts.cpu(), forced[:, :15].cpu()], dim=1)
    b = seq.shape[0]
    conv = [torch.zeros(b, cfg.d_conv - 1, di, dtype=torch.float64)
            for _ in lays]
    ssm = [torch.zeros(b, di, n, dtype=torch.float64) for _ in lays]
    outs = []
    for t in range(seq.shape[1]):
        x = table[seq[:, t]]
        for i, L in enumerate(lays):
            xz = rms(x, L["ln"]) @ L["in"]
            win = torch.cat([conv[i], xz[:, None, :di]], dim=1)
            conv[i] = win[:, 1:]
            u = (win * L["cw"]).sum(1) + L["cb"]
            u = u * torch.sigmoid(u)
            dbc = u @ L["xp"]
            dt = torch.nn.functional.softplus(dbc[:, :r] @ L["dw"] + L["db"])
            ssm[i] = ssm[i] * torch.exp(dt[..., None] * L["A"]) + \
                (dt * u)[..., None] * dbc[:, None, r:r + n]
            y = (ssm[i] * dbc[:, None, r + n:]).sum(-1) + L["D"] * u
            z = xz[:, di:]
            x = x + (y * z * torch.sigmoid(z)) @ L["out"]
        if t >= prompts.shape[1] - 1:
            outs.append(rms(x, fnorm) @ table.t())
    return torch.stack(outs, 1)


def engines_phase(dev, seed, cfg, tol=LOGIT_TOL):
    """Phase 5, continued: the continuous engine (monolithic prefill)
    against the wave engine on the card, fp32, the same 8 requests (all in
    the 128 bucket, so both engines prefill each prompt padded alike).
    Each request's tokens must agree up to the first position whose top-2
    margin (the model re-run on that request alone) is within ``tol``
    (the parity phase's); past it the two continue from different
    tokens."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig

    cfg = cfg.replace(param_dtype="float32")
    model = build_model(cfg, dev)
    params = init_params(model.param_specs(), seed, torch.float32, dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(33, 129, 8)]
    kw = dict(max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16)
    outs = []
    for cls in (Engine, ContinuousEngine):
        eng = cls(model, params, ServeConfig(**kw))
        for p in prompts:
            eng.submit(p)
        outs.append({r.uid: r.out_tokens for r in eng.run()})
    torch.cuda.synchronize()
    wave, cont = outs
    assert sorted(wave) == sorted(cont) == list(range(1, 9))
    view = model.decode_view(params)
    same, margins = 0, []
    with torch.inference_mode():
        for uid in sorted(wave):
            a, b = wave[uid], cont[uid]
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None and len(a) == len(b) == 16:
                same += 1
                continue
            assert j is not None, f"engines: request {uid} lengths differ"
            toks = torch.zeros((1, 128), dtype=torch.long, device=dev)
            toks[0, 128 - len(prompts[uid - 1]):] = torch.tensor(
                prompts[uid - 1])
            logits, cache = model.prefill(
                view, {"tokens": toks}, model.init_cache(1, 128 + 16,
                                                         torch.float32))
            for i, t in enumerate(a[:j]):
                logits, cache = model.decode_step(
                    view, torch.tensor([[t]], device=dev), cache, 128 + i)
            top2 = logits[0].topk(2).values
            margins.append((uid, j, float(top2[0] - top2[1])))
    print(f"  {cfg.name} continuous (monolithic) vs wave, fp32: {same}/8 "
          f"requests token-identical; first divergences (request, "
          f"position, top-2 margin): {margins}", flush=True)
    assert all(mg <= tol for _, _, mg in margins), \
        "engines: tokens differ where the margin exceeds the tolerance"


RG_SERVE_ARGV = ["--arch", "recurrentgemma-2b", "--requests", "8", "--batch",
                 "4", "--prompt-len", "128", "--max-new", "16",
                 "--temperature", "0", "--seed", "0"]
RG_CONT_ARGV = ["--arch", "recurrentgemma-2b", "--engine", "continuous",
                "--prefill-chunk", "64", "--requests", "12", "--batch", "4",
                "--prompt-len", "128", "--max-new", "16", "--temperature",
                "0", "--seed", "0"]


def rgemma_modes_phase(engine, counters, dev):
    """Phase 4d, continued, on the served full-width bf16 weights
    (``engine``'s): an ``Engine`` under ``XambaConfig.pallas()`` (18
    ``rglru_step`` per decode step; 26 ``matmul_pwl`` per decode step,
    GEMV, and per prefill, the bf16 ``wgmma`` body); one
    ``RecurrentGemma.loss`` forward under ``pallas()`` at b = 2, l = 256
    (18 ``rg_lru_scan``, 26 ``matmul_pwl``, ``wgmma``), and under
    ``pallas()`` without ActiBA (kernel 8 with the exact activations),
    whose loss must be finite; then one continuous request with a
    2304-token prompt in chunks of 256, past the 2048-slot ring, and 16
    new tokens.  Returns the launches of kernels 8 and 11 and
    kernel 11's by path, and the ``pallas()`` engine.

    Under ActiBA the outputs are counted, not required finite: at this
    random init the RG-LRU gates' pre-activations lie far below the
    sigmoid table's fitted range (-6.26), where the table extrapolates
    its end slope and goes negative, so a = exp(-8 softplus(lam) r)
    exceeds 1 and the recurrence overflows.  That is the function the
    JAX package defines (``core/pwl.py``: no clamp), not a kernel fault:
    phase 3 holds every kernel to its plain version in range."""
    import numpy as np
    import torch
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig

    model, params = engine.model, engine.params
    cfg = model.cfg
    n, n_rec = cfg.n_layers, model.n_rec
    pmodel = build_model(cfg.replace(xamba=XambaConfig.pallas()), dev)
    eng = Engine(pmodel, params, ServeConfig(
        max_batch=4, prefill_buckets=(32, 128), max_new_tokens=6))
    rng = np.random.default_rng(5)
    for length in (20, 7, 30, 12, 100, 128, 90, 64):   # a 32 wave, a 128 one
        eng.submit(rng.integers(1, cfg.vocab_size, length).tolist())
    reset_counts(counters)
    done = eng.run()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    paths = dict(counters["matmul_pwl"].path_launches)
    m = eng.metrics.summary()
    steps, waves = m["decode_steps"], 2
    toks = [t for r in done for t in r.out_tokens]
    print(f"  pallas() + ActiBA (Engine): {len(done)} requests, {len(toks)} "
          f"tokens, {steps} decode steps, {waves} waves; "
          f"{m['nonfinite_logit_rows']} of {m['logit_rows']} logit rows not "
          f"finite; launches {dict((k, v) for k, v in launches.items() if v)}"
          f", matmul_pwl by path {paths}", flush=True)
    assert len(done) == 8 and all(len(r.out_tokens) == 6 for r in done)
    assert all(0 <= t < cfg.vocab_size for t in toks)
    assert launches["rglru_step"] == n_rec * steps
    assert launches["matmul_pwl"] == n * (steps + waves)
    assert paths == {"gemv": n * steps, "wgmma": n * waves, "tiled": 0}
    assert launches["rg_lru_scan"] == 0
    out = {"matmul_pwl": launches["matmul_pwl"], "matmul_pwl_paths": paths}

    g = torch.Generator().manual_seed(6)
    toks = torch.randint(1, cfg.vocab_size, (2, 256), generator=g).to(dev)
    exact = build_model(cfg.replace(xamba=dataclasses.replace(
        XambaConfig.pallas(), actiba=False)), dev)
    for label, mdl, want in (("pallas()", pmodel, (n_rec, n)),
                             ("pallas() without ActiBA", exact, (n_rec, 0))):
        reset_counts(counters)
        loss, met = mdl.loss(params, {"tokens": toks, "labels": toks})
        torch.cuda.synchronize()
        launches = read_counts(counters)
        paths = dict(counters["matmul_pwl"].path_launches)
        print(f"  loss under {label} (b=2, l=256): {float(loss):.4f}, "
              f"accuracy {float(met['accuracy']):.4f}; launches "
              f"{dict((k, v) for k, v in launches.items() if v)}, "
              f"matmul_pwl by path {paths}", flush=True)
        assert paths == {"gemv": 0, "wgmma": want[1], "tiled": 0}
        assert (launches["rg_lru_scan"], launches["matmul_pwl"]) == want
        assert launches["rglru_step"] == 0
    assert bool(torch.isfinite(loss)), "loss: not finite"
    out["rg_lru_scan"] = n_rec

    ring = ContinuousEngine(model, params, ServeConfig(
        max_batch=4, prefill_buckets=(RG_RING_PROMPT,), max_new_tokens=16,
        prefill_chunk=RG_RING_CHUNK))
    T = ring.pool.cache.k.shape[2]
    assert T == cfg.sliding_window < ring.max_seq, "ring: the cache layout"
    ring.submit(rng.integers(1, cfg.vocab_size, RG_RING_PROMPT).tolist())
    reset_counts(counters)
    t0 = time.perf_counter()
    done = ring.run()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    m = ring.metrics.summary()
    toks = done[0].out_tokens if done else []
    print(f"  ring: a {RG_RING_PROMPT}-token prompt in {m['prefill_chunks']} "
          f"chunk calls of {RG_RING_CHUNK} into a {T}-slot ring, "
          f"{len(toks)} tokens {toks[:8]}... in "
          f"{time.perf_counter() - t0:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    assert len(done) == 1 and len(toks) == 16
    assert all(0 <= t < cfg.vocab_size for t in toks)
    assert m["nonfinite_logit_rows"] == 0 and m["logit_rows"] > 0
    assert m["prefill_chunks"] == RG_RING_PROMPT // RG_RING_CHUNK
    assert launches["rglru_step"] == n_rec * m["decode_steps"]
    return out, eng


def _rg_logits(model, params, prompts, forced, device):
    """(b, 16, V) logits: the prompt's last, then 15 teacher-forced decode
    steps at their positions."""
    import torch
    b, l = prompts.shape
    cache = model.init_cache(b, l + 16, torch.float32)
    logits, cache = model.prefill(params, {"tokens": prompts.to(device)},
                                  cache)
    outs = [logits.cpu()]
    for t in range(15):
        tok = forced[:, t:t + 1] if forced is not None else \
            outs[-1].argmax(-1, keepdim=True)
        logits, cache = model.decode_step(params, tok.to(device), cache,
                                          l + t)
        outs.append(logits.cpu())
    return torch.stack(outs, 1)


def _nudged(params):
    """``params`` with every embedding element moved up by one ulp."""
    import torch
    table = params["embed"]["table"]
    return dict(params, embed={"table": torch.nextafter(
        table, torch.full_like(table, float("inf")))})


def rgemma_parity_phase(dev, seed, counters):
    """Phase 5d: recurrentgemma-2b at full width and depth 5 (one group
    and a two-layer tail), fp32.  The card against the CPU plain path,
    teacher-forced over 16 greedy tokens of 4 prompts of 64, within
    ``RG_SENS_X`` times the CPU's response to a one-ulp move of every
    embedding element; then ``loss`` under ``pallas()`` (4 launches of
    kernel 8, 5 of kernel 11) at b = 2, l = 128, held the same way.
    Returns the logit tolerance."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params

    cfg = get_config("recurrentgemma-2b").replace(n_layers=5,
                                                  param_dtype="float32")
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    params = init_params(gpu.param_specs(), seed, torch.float32, "cpu")
    gparams = gpu.decode_view(_move(params, dev))
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(4, 64)).astype(np.int64))
    with torch.inference_mode():
        reset_counts(counters)
        lk = _rg_logits(gpu, gparams, prompts, None, dev)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        forced = lk.argmax(-1)
        t0 = time.perf_counter()
        lp = _rg_logits(cpu, params, prompts, forced, "cpu")
        lp1 = _rg_logits(cpu, _nudged(params), prompts, forced, "cpu")
    sens = float((lp1 - lp).abs().max())
    tol = max(LOGIT_TOL, RG_SENS_X * sens)
    err = float((lk - lp).abs().max())
    want = dict({k: 0 for k in counts}, **path_launches(cfg, 15, 1))
    top2 = lp.topk(2, dim=-1).values
    confident = (top2[..., 0] - top2[..., 1]) > tol
    agree = lk.argmax(-1) == lp.argmax(-1)
    print(f"  depth 5 fp32, logits up to {float(lp.abs().max()):.3f}: a "
          f"one-ulp move of the embeddings moves the CPU's logits by "
          f"{sens:.3e} ({time.perf_counter() - t0:.1f} s on the CPU); card "
          f"vs CPU {err:.3e} (tol {tol:.3e}); "
          f"{int(confident.sum())}/{confident.numel()} positions above the "
          f"margin, {int(agree[confident].sum())} agree; "
          f"{int(agree.sum())}/{agree.numel()} agree overall; launches on "
          f"the card {counts} (expected {want})", flush=True)
    assert counts == want, "rgemma parity: launches"
    assert torch.isfinite(lk).all() and torch.isfinite(lp).all()
    assert err <= tol, f"rgemma parity: logit error {err}"
    assert bool(agree[confident].all()), "rgemma parity: token differs"

    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(1, cfg.vocab_size, (2, 128), generator=g)
    batch = {"tokens": toks, "labels": toks}
    for label, xamba, want in (
            ("pallas()", XambaConfig.pallas(), (4, 5)),
            ("pallas() without ActiBA", dataclasses.replace(
                XambaConfig.pallas(), actiba=False), (4, 0))):
        pcfg = cfg.replace(xamba=xamba)
        pgpu, pcpu = build_model(pcfg, dev), build_model(pcfg, "cpu")
        with torch.inference_mode():
            reset_counts(counters)
            lg = float(pgpu.loss(gparams, {k: v.to(dev) for k, v in
                                           batch.items()})[0])
            counts = read_counts(counters)
            lc = float(pcpu.loss(params, batch)[0])
            lc1 = float(pcpu.loss(_nudged(params), batch)[0])
        ltol = max(LOGIT_TOL, RG_SENS_X * abs(lc1 - lc))
        print(f"  loss under {label} (b=2, l=128): card {lg:.6f}, CPU "
              f"{lc:.6f} (one-ulp move {abs(lc1 - lc):.3e}; tol "
              f"{ltol:.3e}); launches "
              f"{dict((k, v) for k, v in counts.items() if v)}", flush=True)
        assert (counts["rg_lru_scan"], counts["matmul_pwl"]) == want
        if math.isfinite(lc):
            assert abs(lg - lc) <= ltol, f"rgemma parity: loss ({label})"
        else:
            # ActiBA's overflow at this init (rgemma_modes_phase): the
            # card computes the same function, so it overflows too.
            assert xamba.actiba and not math.isfinite(lg), \
                f"rgemma parity: loss ({label}) not finite"
    return tol


def rgemma_times(dev, kernels, launches, worst, tables):
    """Phase 7's rows for kernels 6, 8 and 11 at recurrentgemma-2b's serve
    shapes: kernel 6 at b = 4, bf16 (launches of the continuous bf16 CLI
    run); kernel 8 at (4, 256, 2560) fp32 (the loss run's launches);
    kernel 11 gated with the gelu table, bf16, GEMV at m = 4 and tiled at
    m = 512 (the pallas() Engine run's launches by path).  Library for
    kernel 11: its two ``torch.matmul`` products alone."""
    import torch
    from repro_torch.kernels import decode_step
    rows = []
    ins = rglru_inputs(4, dev, torch.bfloat16, seed=100)
    outs = kernels["rglru_step"](**ins)
    ms = time_call(lambda: kernels["rglru_step"](**ins))
    plain_ms = time_call(lambda: kernels["rglru_step_plain"](**ins))
    dev_ms = _ours(device_profile(lambda: kernels["rglru_step"](**ins)))
    us = host_us(lambda: kernels["rglru_step"](**ins))
    cold, cold_mb = rglru_cold(kernels["rglru_step"], ins)
    cold_ms = time_call(cold)
    cold_dev = _ours(device_profile(cold, n=30))
    del cold
    ops = 2 * 2 * 4 * RG_W * RG_W + 40 * 4 * RG_W
    bound_ms, bound_by = _bound(_bytes(*ins.values(), *outs), ops)
    rows.append(dict(
        name="rglru_step", route="cuda",
        source="src/repro_torch/csrc/rglru_step.cu",
        replaces="src/repro/kernels/decode_step.py:282",
        launches=launches["rglru_step"], max_abs_err=worst["rglru_step"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None))
    print(f"  rglru_step b=4 bf16 w={RG_W}: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms warm, one launch of the cluster GEMV, plan "
          f"{decode_step.rglru_plan(RG_W, 2)}; targets 0.05 and 0.015), "
          f"weights cold "
          f"({cold_mb:.1f} MB in turn): kernel {cold_ms:.4f} ms, device "
          f"{cold_dev:.4f} ms (target 0.018), host {us:.1f} us a call "
          f"(target 30), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); library: no single PyTorch call; "
          f"{launches['rglru_step']} launches in the continuous serve run; "
          f"the two-launch body it replaced read device 0.0345 ms warm, "
          f"call 0.1362 ms (PERF.md's table)", flush=True)
    rtab = {f"{k}_table": tables[k] for k in ("sigmoid", "softplus", "gelu")}
    ms_a = time_call(lambda: kernels["rglru_step"](**ins, **rtab))
    dev_a = _ours(device_profile(lambda: kernels["rglru_step"](**ins,
                                                               **rtab)))
    print(f"  rglru_step b=4 bf16 with the ActiBA tables: kernel {ms_a:.4f} "
          f"ms (device {dev_a:.4f} ms)", flush=True)

    a, bb = rg_scan_inputs(4, 256, dev, torch.float32, seed=101)
    h = kernels["rg_lru_scan"](a, bb)
    ms = time_call(lambda: kernels["rg_lru_scan"](a, bb))
    plain_ms = time_call(lambda: kernels["rg_lru_scan_plain"](a, bb), n=5)
    dev_ms = _ours(device_profile(lambda: kernels["rg_lru_scan"](a, bb)))
    bound_ms, bound_by = _bound(_bytes(a, bb, h), 2 * a.numel())
    rows.append(dict(
        name="rg_lru_scan", route="cuda", source="src/repro_torch/csrc/rg_lru.cu",
        replaces="src/repro/kernels/rg_lru.py:55",
        launches=launches["rg_lru_scan"], max_abs_err=worst["rg_lru_scan"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None))
    print(f"  rg_lru_scan fp32 {tuple(a.shape)}: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}); library: no single PyTorch call; "
          f"{launches['rg_lru_scan']} launches in the pallas() loss",
          flush=True)

    paths = launches["matmul_pwl_paths"]
    for path, m in (("gemv", 4), ("tiled", 512)):
        x, w, v = mpwl_inputs(m, dev, torch.bfloat16, seed=102 + m,
                              gated=True)
        args = (x, w, tables["gelu"], v)
        body = "gemv" if path == "gemv" else "wgmma"
        out = kernels["matmul_pwl"](*args)
        ms = time_call(lambda: kernels["matmul_pwl"](*args))
        plain_ms = time_call(lambda: kernels["matmul_pwl_plain"](*args))
        dev_ms = _ours(device_profile(lambda: kernels["matmul_pwl"](*args)))
        lib = lambda: (torch.matmul(x, w), torch.matmul(x, v))  # noqa: E731
        lib_ms = time_call(lib)
        host = ""
        if path == "gemv":
            host = (f"; host {host_us(lambda: kernels['matmul_pwl'](*args)):.1f}"
                    f" us a call, the library's two products "
                    f"{host_us(lib):.1f} us, their device time "
                    f"{sum(device_profile(lib).values()):.4f} ms")
        bound_ms, bound_by = _bound(_bytes(x, w, v, out),
                                    2 * 2 * m * RG_W * RG_D_FF,
                                    BF16_TC_FLOP_PER_S)
        rows.append(dict(
            name=f"matmul_pwl_{path}", route="cuda",
            source="src/repro_torch/csrc/matmul_pwl.cu",
            replaces="src/repro/kernels/matmul_pwl.py:69",
            launches=paths[body], max_abs_err=worst["matmul_pwl"], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms))
        print(f"  matmul_pwl {path} ({body} body) gated bf16 x ({m}, {RG_W}) "
              f"w, v ({RG_W}, {RG_D_FF}): kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), library {lib_ms:.4f} ms (its "
              f"two torch.matmul products alone){host}; {paths[body]} "
              f"launches of this body in the pallas() Engine run", flush=True)
    # The SIMT tiled body (PR 16's) on the same bf16 operands, same card.
    simt_ms = time_call(lambda: simt_matmul_pwl(*args))
    simt_dev = _ours(device_profile(lambda: simt_matmul_pwl(*args)))
    print(f"  matmul_pwl m=512 gated bf16 on the SIMT tiled body (not "
          f"counted): kernel {simt_ms:.4f} ms (device {simt_dev:.4f} ms): "
          f"the wgmma body is {simt_dev / max(dev_ms, 1e-9):.1f}x faster in "
          f"device time", flush=True)
    for gated in (0, 1):
        print(f"  matmul_pwl wgmma body ({'gated' if gated else 'pwl'}): "
              f"{wgmma_smem('matmul_pwl', 'matmul_pwl_wgmma_smem', gated)} "
              f"bytes of dynamic shared memory", flush=True)
    for needle in ("matmul_pwl_wgmma_kernel", "gemv_cluster_kernel"):
        for line in ptxas_lines("matmul_pwl", needle):
            print(f"    ptxas {line}")
    for line in ptxas_lines("rglru_step", "rglru_step_kernel"):
        print(f"    ptxas {line}")
    return rows



def _count_params(params):
    """Elements of every tensor in a params tree (dicts and lists)."""
    if isinstance(params, dict):
        return sum(_count_params(v) for v in params.values())
    if isinstance(params, list):
        return sum(_count_params(v) for v in params)
    return params.numel()


def _transformer(arch, dev, **overrides):
    """(model, params) of ``arch`` at full width with ``use_flash=True``,
    bf16 weights from seed 0, built once."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    cfg = get_config(arch, use_flash=True, **overrides)
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    params = init_params(model.param_specs(), 0, cfg.dtype, dev)
    torch.cuda.synchronize()
    print(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{_count_params(params) / 1e9:.3f} B parameters in bf16 "
          f"({'tied' if cfg.tie_embeddings else 'untied lm_head'}), init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model, params


def transformer_serve(engine, counters, prompts, want_flash, label):
    """Serve ``prompts`` through ``engine`` (16 tokens each unless the
    engine says fewer); every token in the vocabulary, every logit row
    finite, and ``flash_attention`` launched exactly ``want_flash(metrics)``
    times, no other kernel.  Returns the launches."""
    import torch
    cfg = engine.model.cfg
    for p in prompts:
        engine.submit(p)
    reset_counts(counters)
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    m = engine.metrics.summary()
    new = engine.cfg.max_new_tokens
    toks = [t for r in done for t in r.out_tokens]
    assert len(done) == len(prompts) and all(
        len(r.out_tokens) == new for r in done), f"{label}: token counts"
    assert all(0 <= t < cfg.vocab_size for t in toks), f"{label}: token id"
    assert m["logit_rows"] > 0 and m["nonfinite_logit_rows"] == 0, \
        f"{label}: non-finite logits {m['nonfinite_logit_rows']}"
    want = dict({k: 0 for k in launches}, flash_attention=want_flash(m))
    body = "wgmma" if cfg.dtype == torch.bfloat16 else "wgmma_fp32"
    paths = dict(counters["flash_attention"].path_launches)
    print(f"  {label}: {len(done)} requests (prompts "
          f"{sorted(len(p) for p in prompts)}), {len(toks)} tokens, "
          f"{m['decode_steps']} decode steps, {m['prefill_chunks']} chunk "
          f"calls; launches {({k: v for k, v in launches.items() if v})} "
          f"(expected flash_attention {want['flash_attention']}, by body "
          f"{paths}); "
          f"{m['tokens_per_s']:.1f} tok/s, ttft_mean_s {m['ttft_mean_s']:.4f}"
          f", ttft_p99_s {m['ttft_p99_s']:.4f}, decode step mean "
          f"{m['token_latency_s'] * 1e3:.3f} ms; wall {wall:.3f} s",
          flush=True)
    assert launches == want, f"{label}: kernel launch counts"
    assert paths == dict({"wgmma": 0, "wgmma_fp32": 0, "simt": 0},
                         **{body: want["flash_attention"]}), \
        f"{label}: kernel 9's bodies"
    return launches


def gemma_phase(dev, counters):
    """Phase 4e: gemma-2b at full width and depth, bf16, ``use_flash``,
    one weight set: the wave engine (4 requests, prompts 4-128, 16 greedy
    tokens: 18 ``flash_attention`` launches for its one prefill, none per
    decode step), the continuous engine with chunk 64 (no kernel: the
    chunked prefill attends with tensor code, as in JAX), one 4096-token
    prompt at b = 1 through the wave engine (past the 2048-key blocked
    threshold: 18 launches) and the ``loss`` forward at b = 1, l = 512
    (18 launches, finite).  Returns (wave engine, continuous engine,
    launches of kernel 9 by run)."""
    import numpy as np
    import torch
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig

    model, params = _transformer("gemma-2b", dev)
    n, vocab = model.cfg.n_layers, model.cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, vocab, int(n_)).tolist()
               for n_ in [128] + rng.integers(4, 129, 3).tolist()]
    kw = dict(max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16)
    wave = Engine(model, params, ServeConfig(**kw))
    out = {"flash_attention": transformer_serve(
        wave, counters, prompts, lambda m: n, "wave (one prefill)")[
            "flash_attention"]}
    cont = ContinuousEngine(model, params, ServeConfig(**kw,
                                                       prefill_chunk=64))
    transformer_serve(cont, counters, prompts, lambda m: 0,
                      "continuous, chunk 64")
    long = Engine(model, params, ServeConfig(
        max_batch=1, prefill_buckets=(GEMMA_LONG,), max_new_tokens=4))
    out["flash_attention_long"] = transformer_serve(
        long, counters, [rng.integers(1, vocab, GEMMA_LONG).tolist()],
        lambda m: n, f"wave, one {GEMMA_LONG}-token prompt")[
            "flash_attention"]
    toks = torch.from_numpy(rng.integers(1, vocab, (1, GEMMA_LOSS_L))).to(dev)
    reset_counts(counters)
    with torch.inference_mode():
        loss, met = model.loss(params, {"tokens": toks, "labels": toks})
    torch.cuda.synchronize()
    launches = read_counts(counters)
    paths = dict(counters["flash_attention"].path_launches)
    print(f"  loss (b=1, l={GEMMA_LOSS_L}): {float(loss):.4f}, accuracy "
          f"{float(met['accuracy']):.4f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }, kernel 9 by body "
          f"{paths}", flush=True)
    assert launches == dict({k: 0 for k in launches}, flash_attention=n), \
        "gemma loss: launches"
    assert paths == {"wgmma": n, "wgmma_fp32": 0, "simt": 0}, \
        "gemma loss: kernel 9's body"
    assert bool(torch.isfinite(loss)), "gemma loss: not finite"
    return wave, cont, out


def qwen_phase(dev, counters):
    """Phase 4f: qwen1.5-4b at full width and depth ``QWEN_DEPTH`` (of 40:
    cut for the script's time), bf16, ``use_flash``: the wave engine, 4
    requests of 4-128 tokens and 16 greedy tokens through the untied
    ``lm_head``, ``QWEN_DEPTH`` launches of kernel 9 for its prefill.
    Returns the engine."""
    import numpy as np
    from repro_torch.serve import Engine, ServeConfig
    model, params = _transformer("qwen1.5-4b", dev, n_layers=QWEN_DEPTH)
    print(f"  depth cut to {QWEN_DEPTH} of 40 layers for the script's time",
          flush=True)
    assert "lm_head" in params, "qwen: the lm_head is untied"
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, model.cfg.vocab_size, int(n_)).tolist()
               for n_ in [128] + rng.integers(4, 129, 3).tolist()]
    eng = Engine(model, params, ServeConfig(
        max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16))
    transformer_serve(eng, counters, prompts, lambda m: QWEN_DEPTH,
                      "wave (one prefill)")
    return eng


def gemma_parity_phase(dev, seed, counters):
    """Phase 5e: gemma-2b at full width and depth ``GEMMA_PARITY_DEPTH``,
    fp32, ``use_flash``.  The card (kernel 9 in each prefill) against the
    CPU's plain path, teacher-forced over 16 greedy tokens of 4 prompts of
    64, within ``RG_SENS_X`` times the CPU's response to a one-ulp move of
    every embedding element (at least ``LOGIT_TOL``); then on the card
    ``use_flash`` on against off, each greedy on its own: the same tokens
    up to the first position whose top-2 margin is within that
    tolerance.  Every kernel-9 launch must take the fp32 tensor-core body
    (``wgmma_fp32``), none the SIMT body.  Returns kernel 9's launches on
    the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params

    cfg = get_config("gemma-2b", use_flash=True).replace(
        n_layers=GEMMA_PARITY_DEPTH, param_dtype="float32")
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    off = build_model(cfg.replace(use_flash=False), dev)
    params = init_params(gpu.param_specs(), seed, torch.float32, "cpu")
    gparams = _move(params, dev)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(4, 64)).astype(np.int64))
    with torch.inference_mode():
        reset_counts(counters)
        lk = _rg_logits(gpu, gparams, prompts, None, dev)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        paths = dict(counters["flash_attention"].path_launches)
        lo = _rg_logits(off, gparams, prompts, None, dev)
        forced = lk.argmax(-1)
        t0 = time.perf_counter()
        lp = _rg_logits(cpu, params, prompts, forced, "cpu")
        lp1 = _rg_logits(cpu, _nudged(params), prompts, forced, "cpu")
    sens = float((lp1 - lp).abs().max())
    tol = max(LOGIT_TOL, RG_SENS_X * sens)
    err = float((lk - lp).abs().max())
    top2 = lp.topk(2, dim=-1).values
    confident = (top2[..., 0] - top2[..., 1]) > tol
    agree = lk.argmax(-1) == lp.argmax(-1)
    want = dict({k: 0 for k in counts}, flash_attention=cfg.n_layers)
    cpu_s = time.perf_counter() - t0
    print(f"  depth {cfg.n_layers} fp32, logits up to "
          f"{float(lp.abs().max()):.3f}: a one-ulp move of the embeddings "
          f"moves the CPU's logits by {sens:.3e} ({cpu_s:.1f} s on the "
          f"CPU); card vs CPU {err:.3e} (tol {tol:.3e}); "
          f"{int(confident.sum())}/{confident.numel()} positions above the "
          f"margin, {int(agree[confident].sum())} agree; launches on the "
          f"card {({k: v for k, v in counts.items() if v})} (expected "
          f"{cfg.n_layers} flash_attention, fp32: the wgmma_fp32 body; by body "
          f"{paths})", flush=True)
    assert counts == want, "gemma parity: launches"
    assert paths == {"wgmma": 0, "wgmma_fp32": cfg.n_layers, "simt": 0}, \
        "gemma parity: kernel 9's body"
    assert torch.isfinite(lk).all() and torch.isfinite(lp).all()
    assert err <= tol, f"gemma parity: logit error {err}"
    assert bool(agree[confident].all()), "gemma parity: token differs"
    same, firsts = 0, []
    ton, toff = lk.argmax(-1), lo.argmax(-1)
    for i in range(ton.shape[0]):
        diff = (ton[i] != toff[i]).nonzero()
        if not len(diff):
            same += 1
            continue
        j = int(diff[0])
        t2 = lk[i, j].topk(2).values
        firsts.append((i, j, float(t2[0] - t2[1])))
    before = float((lk - lo).abs().max()) if not firsts else float(
        (lk[:, :min(j for _, j, _ in firsts)] -
         lo[:, :min(j for _, j, _ in firsts)]).abs().max())
    print(f"  use_flash on vs off on the card: {same}/4 prompts "
          f"token-identical over 16 tokens; logits {before:.3e} apart "
          f"before any divergence; first divergences (prompt, position, "
          f"top-2 margin): {firsts}", flush=True)
    assert before <= tol, "use_flash on vs off: logits"
    assert all(mg <= tol for _, _, mg in firsts), \
        "use_flash on vs off: tokens differ above the margin"
    return paths["wgmma_fp32"]


def reduba_phase(dev, counters):
    """Phase 5f: ``core/reduce.py: reduce_sum(mode="pallas")`` over axis 0
    and ``mean(mode="pallas")`` over the last axis (the transpose a copy)
    of paper Fig. 1's (2048, 2048) fp32 operand on the card: each
    launches kernel 14 once and matches its ``naive`` mode within phase
    3's limits.  Returns the launches."""
    import torch
    from repro_torch.core import reduce as red
    x = _rand(torch.Generator().manual_seed(7), REDUCE_CASES[0], 1.0, dev,
              torch.float32)
    fails, total = [], 0
    for name, fn, axis in (("reduce_sum", red.reduce_sum, 0),
                           ("mean", red.mean, -1)):
        reset_counts(counters)
        got = fn(x, axis=axis, mode="pallas")
        torch.cuda.synchronize(dev)
        counts = read_counts(counters)
        want = fn(x, axis=axis, mode="naive")
        print(f"  {name}(mode='pallas', axis={axis}) of "
              f"{tuple(x.shape)}: launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        assert counts == dict({k: 0 for k in counts}, reduce_rows=1), \
            f"reduba: {name} launches"
        total += counts["reduce_rows"]
        fails += compare(f"{name} pallas vs naive", (got,), (want,),
                         "float32", (("out", "stream"),))[1]
    assert not fails, f"reduba: {fails}"
    return {"reduce_rows": total}


def transformer_times(dev, kernels, launches, worst):
    """Phase 7's rows for kernels 9 and 14.  Kernel 9 in bf16 at
    gemma-2b's wave prefill (b = 4, L = 128) and at its 4096-token prompt
    (b = 1), causal, the (b, s, h, d) layout (the ``wgmma`` body): bound by
    the bytes of q, k, v and out, or the operations of the causal pairs
    this run needs (4 d a pair: q.k and p.v) at the bf16 tensor-core rate
    (the fp32 CUDA-core time, the design's own 6 d a pair at the bf16
    rate, and the SIMT body on the same inputs printed beside it); and the
    fp32 tensor-core body at phase 5e's shape (b = 4, L = 64, bound at the
    fp32 CUDA-core rate, the launches of 5e; the row) and at b = 1, L =
    ``GEMMA_LONG``, with its host microseconds, the design's rate (six
    bf16 products a product) and the SIMT body on the same inputs; library:
    ``scaled_dot_product_attention`` (``enable_gqa``), timed only.
    Kernel 14 at (2048, 2048) fp32 over four operands in turn (past the
    L2; the launches of phase 5f); library: ``torch.sum(x, 0)``."""
    import torch
    import torch.nn.functional as F
    rows = []
    for name, (b, l), runs in (
            ("flash_attention", (4, 128), "the gemma-2b wave serve's prefill"),
            ("flash_attention_long", (1, GEMMA_LONG),
             f"the {GEMMA_LONG}-token prompt's prefill")):
        hq, hkv, d = 8, 1, 256
        q, k, v = flash_inputs(b, hq, hkv, l, d, dev, torch.bfloat16,
                               seed=200 + l)
        out = kernels["flash_attention"](q, k, v, causal=True)
        ms = time_call(lambda: kernels["flash_attention"](q, k, v,
                                                          causal=True))
        plain_ms = time_call(lambda: kernels["flash_attention_plain"](
            q, k, v, causal=True), n=10)
        dev_ms = _ours(device_profile(lambda: kernels["flash_attention"](
            q, k, v, causal=True)))
        lib_ms = time_call(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        ops = 4 * d * (l * (l + 1) // 2) * b * hq
        nbytes = _bytes(q, k, v, out)
        bound_ms, bound_by = _bound(nbytes, ops, BF16_TC_FLOP_PER_S)
        fp32_ms = ops / FP32_FLOP_PER_S * 1e3
        # The design's own tensor-core work: P V in two bf16 terms.
        design_ms = 1.5 * ops / BF16_TC_FLOP_PER_S * 1e3
        simt_ms = time_call(lambda: simt_flash(q, k, v), n=10)
        simt_dev = _ours(device_profile(lambda: simt_flash(q, k, v)))
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:92",
            launches=launches[name], max_abs_err=worst["flash_attention"],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms))
        print(f"  flash_attention bf16 b={b} hq={hq} hkv={hkv} L={l} d={d} "
              f"causal: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP; "
              f"{fp32_ms:.4f} ms at the fp32 CUDA-core rate; the design's "
              f"6 d operations a pair {design_ms:.4f} ms at the bf16 rate), "
              f"library {lib_ms:.4f} ms (scaled_dot_product_attention); "
              f"{launches[name]} launches in {runs}; the SIMT body (PR "
              f"16's, not counted) {simt_ms:.4f} ms (device {simt_dev:.4f} "
              f"ms, {simt_dev / max(dev_ms, 1e-9):.1f}x the wgmma body's)",
              flush=True)
    # The fp32 tensor-core body at phase 5e's shape (gemma-2b, b = 4, L =
    # 64: the row) and at b = 1, L = GEMMA_LONG, each with the SIMT body
    # (the one these shapes took before; not counted) on the same inputs.
    hq, hkv, d = 8, 1, 256
    for b, l in ((4, 64), (1, GEMMA_LONG)):
        q, k, v = flash_inputs(b, hq, hkv, l, d, dev, torch.float32,
                               seed=200 + l)
        out = kernels["flash_attention"](q, k, v, causal=True)
        ms = time_call(lambda: kernels["flash_attention"](q, k, v,
                                                          causal=True))
        plain_ms = time_call(lambda: kernels["flash_attention_plain"](
            q, k, v, causal=True), n=30 if l == 64 else 10)
        dev_ms = _ours(device_profile(lambda: kernels["flash_attention"](
            q, k, v, causal=True)))
        us = host_us(lambda: kernels["flash_attention"](q, k, v,
                                                        causal=True),
                     n=1000 if l == 64 else 20)
        lib_ms = time_call(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        simt_ms = time_call(lambda: simt_flash(q, k, v),
                            n=30 if l == 64 else 10)
        simt_dev = _ours(device_profile(lambda: simt_flash(q, k, v)))
        ops = 4 * d * (l * (l + 1) // 2) * b * hq
        nbytes = _bytes(q, k, v, out)
        bound_ms, bound_by = _bound(nbytes, ops)
        split_ms = ops / SPLIT_TC_FLOP_PER_S * 1e3
        if l == 64:
            rows.append(dict(
                name="flash_attention_fp32", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:92",
                launches=launches["flash_attention_fp32"],
                max_abs_err=worst["flash_attention"], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms))
        print(f"  flash_attention fp32 (wgmma_fp32 body: {d // 64} units "
              f"of 64 columns, clusters of {max(1, d // 128)}, "
              f"{fp32_clusters(d)} clusters at once) b={b} hq={hq} "
              f"hkv={hkv} L={l} d={d} causal: "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms), host "
              f"{us:.1f} us a call, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP at the fp32 CUDA-core rate; the "
              f"design's six bf16 products a product {split_ms:.4f} ms), "
              f"library {lib_ms:.4f} ms (scaled_dot_product_attention, "
              f"fp32); "
              + (f"{launches['flash_attention_fp32']} launches in phase 5e"
                 if l == 64 else "no model path at this length in fp32")
              + f"; the SIMT body on the same inputs (not counted) "
              f"{simt_ms:.4f} ms (device {simt_dev:.4f} ms, "
              f"{simt_dev / max(dev_ms, 1e-9):.1f}x the fp32 body's)",
              flush=True)
    for fp32, label in ((0, "wgmma body"), (1, "wgmma_fp32 body")):
        print(f"  flash_attention {label} at d = 256: "
              f"{wgmma_smem('flash_attention', 'flash_attention_wgmma_smem', 256, fp32)}"
              f" bytes of dynamic shared memory", flush=True)
    for needle in ("flash_attention_wgmma_kernel",
                   "flash_attention_fp32_wgmma_kernel"):
        for line in ptxas_lines("flash_attention", needle):
            print(f"    ptxas {line}")

    # Four operands in turn (67 MB, past the 50 MB L2), so that each call
    # reads its input from HBM as the bound assumes: one 16.8 MB operand
    # timed alone stays in L2.
    m, n = REDUCE_CASES[0]
    g = torch.Generator().manual_seed(201)
    xs = itertools.cycle([_rand(g, (m, n), 1.0, dev, torch.float32)
                          for _ in range(4)])
    x = next(xs)
    out = kernels["reduce_rows"](x)
    ms = time_call(lambda: kernels["reduce_rows"](next(xs)))
    plain_ms = time_call(lambda: kernels["reduce_rows_plain"](next(xs)))
    dev_ms = _ours(device_profile(lambda: kernels["reduce_rows"](next(xs)),
                                  n=12))
    lib_ms = time_call(lambda: torch.sum(next(xs), 0))
    bound_ms, bound_by = _bound(_bytes(x, out), m * n)
    rows.append(dict(
        name="reduce_rows", route="cuda",
        source="src/repro_torch/csrc/reduba.cu",
        replaces="src/repro/kernels/reduba.py:35",
        launches=launches["reduce_rows"], max_abs_err=worst["reduce_rows"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=lib_ms))
    print(f"  reduce_rows fp32 ({m}, {n}): kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}), library {lib_ms:.4f} ms (torch.sum(x, 0)); "
          f"four operands in turn, past the L2; {launches['reduce_rows']} "
          f"launches in phase 5f", flush=True)
    return rows


def bare_updates_phase(dev, counters):
    """Phase 5c: one call each of ``ssd_decode_step(mode="pallas")`` (at
    mamba2-130m's step widths) and ``selective_scan_decode_step(mode=
    "pallas")`` (mamba-130m's) on the card, fp32, b = 4: each launches
    its kernel exactly once and matches the function's ``naive`` mode
    within phase 3's limits.  Returns the launches by kernel."""
    import torch
    from repro_torch.core import selective_scan, ssd
    launches, fails = {}, []
    for name, fn, args in (
            ("ssd_step", ssd.ssd_decode_step,
             ssd_step_inputs(4, dev, torch.float32, seed=62)),
            ("sscan_step", selective_scan.selective_scan_decode_step,
             sscan_inputs(4, dev, torch.float32, seed=63))):
        reset_counts(counters)
        got = fn(*args, mode="pallas")
        torch.cuda.synchronize(dev)
        counts = read_counts(counters)
        want = fn(*args, mode="naive")
        launches[name] = counts[name]
        print(f"  {fn.__name__}(mode='pallas'): launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        assert counts == dict({k: 0 for k in counts}, **{name: 1}), \
            f"bare updates: {name} launches"
        fails += compare(f"{fn.__name__} pallas vs naive", got, want,
                         "float32", (("ssm", "state"), ("y", "stream")))[1]
    assert not fails, f"bare updates: {fails}"
    return launches


def ablation_phase(dev, seed, cfg, counters, kernels, worst):
    """Phase 6: ``forward`` of the fp32 model at b = 4, l = 300 under each
    variant of ``repro_torch.launch.ablation``, each held against the fp64
    witness of its function; then ``cumsum_last`` and ``ssd_chunk``
    against their plain versions on the operands the ``pallas()`` forward
    gave them.  Returns the chain kernels' launches in the ``pallas()``
    run, with kernel 7's by body under ``ssd_chunk_paths``."""
    import torch
    from repro_torch.core.pwl import table_for
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import ablation
    from repro_torch.models import build_model

    launches, paths, pwl_paths, by_kernel, shared = {}, {}, {}, {}, {}
    calls = {"cumba_cumsum": [], "ssd_chunk": []}

    def first_forward(name, model, params, tokens):
        shared.update(params=params, tokens=tokens)
        reset_counts(counters)
        out = model.forward(params, tokens)
        torch.cuda.synchronize()
        launches[name] = read_counts(counters)
        paths[name] = dict(counters["ssd_chunk"].path_launches)
        pwl_paths[name] = dict(counters["pwl_activate"].path_launches)
        by_kernel[name] = device_profile(
            lambda: model.forward(params, tokens), n=2)
        if name == "pallas":
            with recording(ops, calls):
                model.forward(params, tokens)
        return out

    res = ablation.run(cfg, dev, batch=CHAIN_B, seqlen=CHAIN_L, seed=seed,
                       iters=3, first_forward=first_forward)
    params, tokens = shared["params"], shared["tokens"]
    logits = {k: r["logits"] for k, r in res.items()}
    t_base = res["baseline"]["ms"]
    print(f"  {'variant':16s} {'ms/fwd':>9s} {'speedup':>8s} "
          f"{'top1 vs exact':>14s}  launches", flush=True)
    for name, r in res.items():
        assert torch.isfinite(logits[name]).all(), f"ablation {name}: inf"
        assert logits[name].shape == (CHAIN_B, CHAIN_L, cfg.vocab_size)
        top1 = float((logits[name].argmax(-1) ==
                      logits["baseline"].argmax(-1)).float().mean())
        print(f"  {name:16s} {r['ms']:9.3f} {t_base / r['ms']:7.2f}x "
              f"{top1:14.4f}  "
              f"{ {k: v for k, v in launches[name].items() if v} }")
        by = by_kernel[name]
        dev_ms = sum(by.values())
        top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
        print(f"    device {dev_ms:.3f} ms per forward ({100 * dev_ms / r['ms']:.1f}"
              f"% of the event time); " + "; ".join(
                  f"{v:.3f} ms {k[:60]}" for k, v in top), flush=True)
    torch.cuda.empty_cache()

    cpu = build_model(cfg.replace(param_dtype="float32",
                                  xamba=XambaConfig.pallas()), "cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits["pallas (CPU plain)"] = cpu.forward(_move(params, "cpu"),
                                                   tokens.cpu())
    print(f"  CPU forward of pallas() {time.perf_counter() - t0:.1f} s",
          flush=True)

    # The fp64 witness of each function the variants compute (exact, and
    # with the PWL tables), and its response to a one-ulp (2^-24) relative
    # change of the embeddings: how far fp32 rounding alone can move it.
    xambas = dict(ablation.VARIANTS, **{"pallas (CPU plain)":
                                        XambaConfig.pallas()})
    witness = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for name, xamba in xambas.items():
            key = tuple(table_for(k, xamba) for k in ("silu", "softplus"))
            if key not in witness:
                tabs = None if key[0] is None else dict(zip(
                    ("silu", "softplus"), key))
                witness[key] = witness_forward(params, cfg, tokens,
                                               tabs).cpu()
        exact = witness[(None, None)]
        moved = float((witness_forward(params, cfg, tokens, None,
                                       perturb=2.0 ** -24).cpu() -
                       exact).abs().max())
    print(f"  fp64 witness: {len(witness) + 1} forwards in "
          f"{time.perf_counter() - t0:.1f} s; a 2^-24 relative change of "
          f"the embeddings moves its logits by {moved:.3e}; logits up to "
          f"{float(exact.abs().max()):.3f}", flush=True)
    def tol(*names):
        segment = [xambas[k].cumba == "naive" for k in names]
        if all(segment):
            return LOGIT_TOL
        return sum(LOGIT_TOL if seg else PREFIX_SUM_TOL for seg in segment)

    fails = []
    pairs = [(name, None) for name in xambas] + [
        ("baseline", "+ReduBA"), ("+CumBA", "+CumBA+ReduBA"),
        ("baseline", "+CumBA+ReduBA"), ("+ActiBA (k=32)", "pallas"),
        ("pallas", "pallas (CPU plain)")]
    for a, b in pairs:
        if b is None:
            key = tuple(table_for(k, xambas[a]) for k in ("silu", "softplus"))
            other, label, limit = witness[key], "its fp64 witness", tol(a)
        else:
            other, label, limit = logits[b].double(), b, tol(a, b)
        err = float((logits[a].double() - other).abs().max())
        top1 = float((logits[a].argmax(-1) == other.argmax(-1)).float()
                     .mean())
        ok = err <= limit and top1 >= ABLATION_TOP1
        print(f"  {a} vs {label}: logits max_abs_err {err:.3e} (tol "
              f"{limit:.0e}), top-1 agreement {top1:.4f} (at least "
              f"{ABLATION_TOP1}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fails.append(f"{a} vs {label}")

    # Kernels 13 and 7 against their plain versions on the pallas()
    # forward's own operands, all layers at once.
    a_all = [a for (a,) in calls["cumba_cumsum"]]
    cs = [c[1] for c in calls["ssd_chunk"]]
    assert len(a_all) == len(cs) == cfg.n_layers
    with torch.inference_mode():
        cases = (
            ("cumsum_last", (("A_cum", "stream"),),
             [(kernels["cumsum_last"](a),) for a in a_all],
             [(kernels["cumsum_last_plain"](a),) for a in a_all]),
            ("ssd_chunk", (("y_diag", "state"), ("states", "state")),
             [kernels["ssd_chunk"](*c) for c in calls["ssd_chunk"]],
             [kernels["ssd_chunk_plain"](*c) for c in calls["ssd_chunk"]]))
        torch.cuda.synchronize()
        for kernel, outs, got, want in cases:
            err, bad = compare(
                f"{kernel} fp32 on the pallas() forward's operands "
                f"({cfg.n_layers} layers)",
                [torch.stack(t) for t in zip(*got)],
                [torch.stack(t) for t in zip(*want)], "float32", outs)
            worst[kernel] = max(worst[kernel], err)
            fails.extend(bad)
        # How well the prefix sums keep one step's decay: exp(cs_i -
        # cs_{i-1}) in fp32 against exp(dt_i A) in fp64.
        rel = max(float(((torch.exp(c[..., 1:] - c[..., :-1]).double() /
                          torch.exp(a[..., 1:].double())) - 1).abs().max())
                  for a, c in zip(a_all, cs))
    print(f"  largest |cs| (SSD prefix sums) over the {cfg.n_layers} layers "
          f"{max(float(c.abs().max()) for c in cs):.1f}; one step's decay "
          f"from their difference off by up to {rel:.3e} (relative)",
          flush=True)
    assert not fails, f"ablation: {fails}"

    n = cfg.n_layers
    want = {"pallas": dict(cumsum_last=n, ssd_chunk=n, pwl_activate=3 * n,
                           mamba2_step=0, mamba2_prefill=0, qmatmul=0),
            "+ActiBA (k=32)": dict(cumsum_last=0, ssd_chunk=0,
                                   pwl_activate=3 * n, mamba2_step=0,
                                   mamba2_prefill=0, qmatmul=0)}
    for name, w in want.items():
        w = dict({k: 0 for k in launches[name]}, **w)
        assert launches[name] == w, f"ablation {name}: launches " \
            f"{launches[name]} expected {w}"
    for name, _ in ablation.VARIANTS[:4]:
        assert not any(launches[name].values()), f"ablation {name}: kernel"
    # Every layer's kernel 7 on the tensor-core body, none on the SIMT one.
    print(f"  ssd_chunk launches by body in the pallas() forward: "
          f"{paths['pallas']}", flush=True)
    assert paths["pallas"] == {"wgmma": n, "simt": 0}, \
        f"ablation pallas: ssd_chunk bodies {paths['pallas']}"
    # Every kernel-12 launch of both ActiBA forwards on the vector body.
    for name in ("pallas", "+ActiBA (k=32)"):
        print(f"  pwl_activate launches by body in the {name} forward: "
              f"{pwl_paths[name]}", flush=True)
        assert pwl_paths[name] == {"vector": 3 * n, "scalar": 0}, \
            f"ablation {name}: pwl_activate bodies {pwl_paths[name]}"
    return dict(launches["pallas"], ssd_chunk_paths=paths["pallas"],
                pwl_activate_paths=pwl_paths["pallas"])


@contextlib.contextmanager
def recording(module, calls):
    """While open, each call of ``module.<name>`` for ``name`` in
    ``calls`` appends its arguments to ``calls[name]`` (the SSD chain looks
    these functions up on ``kernels/ops.py`` at call time)."""
    saved = {k: getattr(module, k) for k in calls}

    def recorder(name, fn):
        def rec(*args):
            calls[name].append(args)
            return fn(*args)
        return rec
    for k, fn in saved.items():
        setattr(module, k, recorder(k, fn))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)


def witness_forward(params, cfg, tokens, tables=None, perturb=0.0):
    """fp64 logits of the model, written out apart from the port: each
    block as the unfused chain defines it (RMSNorm, in-projection, causal
    conv, SiLU, softplus of dt, the SSD, the D skip, RMSNorm then the SiLU
    gate, out-projection, residual), with the SSD as its recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, one step at
    a time: no chunks and no prefix sums.  ``tables`` (``silu``,
    ``softplus``): those PWL tables, evaluated in fp64 on their fp32
    coefficients, in place of the exact activations.  ``perturb``: a
    relative change of the embeddings."""
    import torch
    import torch.nn.functional as F
    f64 = torch.float64

    def d(t):
        return t.to(f64)

    def rms(x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * \
            d(scale)

    def pwl(tab):
        k = tab.num_segments - 1
        c = torch.from_numpy(tab.packed_f32()).to(tokens.device, f64)

        def f(x):
            y = c[2 * k] * x + c[2 * k + 1]
            for i in range(k):
                y = y + c[k + i] * torch.clamp_min(x - c[i], 0.0)
            return y
        return f

    silu, softplus = (F.silu, F.softplus) if tables is None else \
        (pwl(tables["silu"]), pwl(tables["softplus"]))
    b, l = tokens.shape
    di = cfg.expand * cfg.d_model
    h, p, g, n = di // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_ngroups, \
        cfg.d_state
    x = d(params["embed"]["table"])[tokens] * (1.0 + perturb)
    for lp in params["layers"]:
        m = lp["mixer"]
        z, xbc, dt = torch.split(rms(x, lp["ln"]["scale"]) @
                                 d(m["in_proj"]["w"]),
                                 [di, di + 2 * g * n, h], dim=-1)
        w = d(m["conv"]["w"])
        xp = F.pad(xbc, (0, 0, w.shape[0] - 1, 0))
        xbc = silu(sum(xp[:, i:i + l] * w[i] for i in range(w.shape[0])) +
                   d(m["conv"]["b"]))
        xs, B, C = torch.split(xbc, [di, g * n, g * n], dim=-1)
        xs = xs.reshape(b, l, h, p)
        B = B.reshape(b, l, g, n).repeat_interleave(h // g, dim=2)
        C = C.reshape(b, l, g, n).repeat_interleave(h // g, dim=2)
        dt = softplus(dt + d(m["dt_bias"]))                  # (b, l, h)
        decay = torch.exp(dt * -torch.exp(d(m["A_log"])))
        state = torch.zeros((b, h, p, n), dtype=f64, device=x.device)
        ys = []
        for t in range(l):
            state = state * decay[:, t, :, None, None] + \
                (dt[:, t, :, None] * xs[:, t])[..., None] * B[:, t, :, None]
            ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t]))
        y = torch.stack(ys, dim=1) + xs * d(m["D"])[:, None]
        y = rms(y.reshape(b, l, di), m["norm"]["scale"]) * silu(z)
        x = x + y @ d(m["out_proj"]["w"])
    return rms(x, params["final_norm"]["scale"]) @ \
        d(params["embed"]["table"]).t()


def _move(tree, device):
    """``tree`` (params, a list or a ``QuantTensor``) on ``device``."""
    from repro_torch.nn.quant import QuantTensor
    if isinstance(tree, dict):
        return {k: _move(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_move(v, device) for v in tree]
    if isinstance(tree, QuantTensor):
        return tree.apply(lambda a: a.to(device))
    return tree.to(device)


def time_call(fn, n=30, warmup=3):
    """Median milliseconds of ``fn()`` over ``n`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


OUR_KERNELS = ("mamba2_step_kernel", "gated_norm_kernel", "conv_act_kernel",
               "ssd_scan_kernel", "ssd_prefill_wgmma_kernel",
               "state_pass_kernel", "cumsum_last_kernel", "ssd_chunk_kernel",
               "ssd_chunk_wgmma_kernel",
               "pwl_activate_kernel", "gemm::gemv_cluster_kernel",
               "gemm::tiled_kernel", "qmatmul_wgmma_kernel",
               "matmul_pwl_wgmma_kernel", "flash_attention_wgmma_kernel",
               "mamba1_step_kernel", "sscan_step_kernel", "ssd_step_kernel",
               "rglru_step_kernel", "rg_lru_scan_kernel",
               "flash_attention_kernel", "flash_attention_fp32_wgmma_kernel",
               "reduce_rows_kernel",
               "reduce_partials_kernel")


def device_profile(fn, n=10):
    """Device milliseconds per call of ``fn()`` by kernel name, from
    ``torch.profiler`` (CUDA activity only); empty when the profiler saw
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by[ev.key] = by.get(ev.key, 0.0) + us / 1e3 / n
    return by


def _ours(by):
    return sum(v for k, v in by.items() if any(o in k for o in OUR_KERNELS))


def step_breakdown(engine, label):
    """One full-width decode step and one prefill (b = 4, l = 128) of the
    served model (``label``: its weights): host wall per call, device
    time per call from the profiler, the device's busy share, and the
    largest kernels."""
    import torch
    model, params = engine.model, engine.params
    b = engine.cfg.max_batch
    toks = torch.ones((b, 128), dtype=torch.long, device=model.device)

    def prefill():
        return model.prefill(params, {"tokens": toks},
                             model.init_cache(b, 129, model.cfg.dtype))

    _, cache = prefill()
    tok = toks[:, :1]

    def decode():
        return model.decode_step(params, tok, cache, 128)

    for name, fn in (("decode step", decode), ("prefill l=128", prefill)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        by = device_profile(fn)
        dev_ms = sum(by.values())
        if not by:
            print(f"  {name}: host {host_ms:.3f} ms per call; device time "
                  f"not measured (the profiler saw none)")
            continue
        top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
        print(f"  {name} (b={b}, {label} model): wall {host_ms:.3f} ms, device "
              f"{dev_ms:.3f} ms ({100 * dev_ms / host_ms:.1f}% busy), "
              f"ported kernels {_ours(by):.3f} ms", flush=True)
        for k, v in top:
            print(f"    {v:.4f} ms  {k[:90]}")


def simt_matmul_pwl(x, w, table, v):
    """Kernel 11's SIMT tiled body on bf16 operands, through its C
    launcher (the shape rule sends them to the ``wgmma`` body): the PR 16
    body timed beside the new one on the same card; not counted."""
    import torch
    from repro_torch.kernels import common, matmul_pwl
    from repro_torch.kernels.actiba import table_args
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    vp = v.data_ptr() if v is not None else None
    err = matmul_pwl._LAUNCH(matmul_pwl._ARGS.pack(
        1, 1, x.data_ptr(), w.data_ptr(), vp or 0, out.data_ptr(), m, k, n,
        32, 1, 0, *table_args(table, x.device), common.stream(x.device)))
    common.check_launch(err, "matmul_pwl", "matmul_pwl SIMT body")
    return out


def simt_qmatmul(x, q, scale):
    """Kernel 10's SIMT tiled body on bf16 x (m > 8), through its C
    launcher (the shape rule sends it to the ``wgmma`` body): the body
    these shapes took before the ``wgmma`` one, timed beside it on the
    same card; not counted."""
    import torch
    from repro_torch.kernels import common, qmatmul
    (m, k), n = x.shape, q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = qmatmul._LAUNCH(qmatmul._ARGS.pack(
        1, x.data_ptr(), q.data_ptr(), scale.data_ptr(), 0, 0,
        out.data_ptr(), m, k, n, 32, 1, 0, 0, 0, common.stream(x.device)))
    common.check_launch(err, "qmatmul", "qmatmul SIMT body")
    return out


def simt_ssd_chunk(x_c, A_cum, B_c, C_c):
    """Kernel 7's SIMT body on fp32 operands that the shape rule sends to
    the ``wgmma`` body, through its C launcher: the body these shapes took
    before the ``wgmma`` one, timed beside it on the same card; not
    counted."""
    import torch
    from repro_torch.kernels import common, ssd_chunk
    b, c, L, h, p = x_c.shape
    g, n = B_c.shape[3], B_c.shape[4]
    y = torch.empty_like(x_c)
    states = torch.empty((b, c, h, p, n), device=x_c.device)
    err = ssd_chunk._LAUNCH(
        x_c.data_ptr(), A_cum.data_ptr(), B_c.data_ptr(), C_c.data_ptr(),
        y.data_ptr(), states.data_ptr(), b, c, L, h, p, g, n,
        common.stream(x_c.device))
    common.check_launch(err, "ssd_chunk", "ssd_chunk SIMT body")
    return y, states


def host_us(fn, n=1000):
    """Host microseconds per call of ``fn()``: ``time.perf_counter`` over
    ``n`` calls with no synchronisation between them, then one
    synchronisation (outside the clock)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def simt_flash(q, k, v):
    """Kernel 9's SIMT body on q, k, v (causal, bf16 or fp32) that the
    shape rule sends to a tensor-core body, through its C launcher, as
    ``simt_matmul_pwl``."""
    import torch
    from repro_torch.kernels import common, flash_attention as fa
    out = torch.empty_like(q)
    (b, hq, lq, d), (hkv, lk) = q.shape, k.shape[1:3]
    err = fa._LAUNCHERS["simt"](fa._FLASH_ARGS.pack(
        common.stream_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), *(t.stride(i) for t in (q, k, v, out)
                          for i in range(3)),
        b, hq, hkv, lq, lk, d, 1, 0, d ** -0.5, common.stream(q.device)))
    common.check_launch(err, "flash_attention", "flash_attention SIMT body")
    return out


def ptxas_lines(source, needle):
    """ptxas's report (registers, spills) of each entry function of
    ``source`` whose name holds ``needle``, from this run's build log."""
    from repro_torch.kernels import build
    out, cur = [], None
    for line in str(build.BUILD_LOG.get(source, "")).splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if needle in line else None
        elif cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.strip()}")
    return out or [f"{source}: not built in this run"]


def fp32_clusters(d):
    """Clusters of kernel 9's fp32 body at head_dim d the card holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    return wgmma_smem("flash_attention", "flash_attention_fp32_clusters", d)


def wgmma_smem(source, fn_name, *args):
    """The dynamic shared memory a ``wgmma`` body's launch asks for."""
    import ctypes
    from repro_torch.kernels import build
    fn = getattr(build.library(source), fn_name)
    fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_int
    return fn(*args)


def simt_prefill(ins, chunk):
    """Kernel 2's SIMT body on bf16 operands that the shape rule sends to
    the tensor-core body, through its C launcher, then the gated norm: the
    body these shapes took before, timed beside the new one on the same
    card; not counted."""
    import torch
    from repro_torch.kernels import common, prefill_chunk as pc
    from repro_torch.kernels.gated_norm import gated_norm_cuda
    z, xbc, dt = ins["z"], ins["xbc"], ins["dt"]
    b, l, di = z.shape
    st = ins["ssm_state"]
    h, n = st.shape[1], st.shape[-1]
    act = torch.empty_like(xbc)
    y = torch.empty_like(z)
    new_conv = torch.empty_like(ins["conv_state"])
    new_ssm = torch.empty_like(st)
    err = pc._LAUNCH(pc._PREFILL_ARGS.pack(
        common.stream_code(z), 0, xbc.data_ptr(), xbc.shape[-1],
        dt.data_ptr(), h, ins["conv_state"].data_ptr(), st.data_ptr(),
        *(ins[k].data_ptr() for k in ("conv_w", "conv_b", "dt_bias", "A",
                                      "D")),
        act.data_ptr(), y.data_ptr(), new_conv.data_ptr(),
        new_ssm.data_ptr(), 0, 0, 0, b, l, chunk, h, HEAD_DIM, N_GROUPS, n,
        ins["conv_w"].shape[0], 0, 0, 0, 0, 0, common.stream(z.device)))
    common.check_launch(err, "prefill_chunk", "mamba2_prefill SIMT body")
    out = gated_norm_cuda(y, z, ins["norm_scale"])
    return out, new_conv, new_ssm


def prefill_tc_bound(ins, outs, chunk):
    """Kernel 2's bound for the tensor-core design, from the run's tensors:
    the bytes (inputs read once, outputs written once) at 3.35 TB/s beside
    the bf16 tensor-core products it needs at 989 TFLOP/s: per chunk the
    lower triangle of C B^T once per group (one bf16 product: bf16-exact
    streams), and per head the folded scores times x, the carried-state
    term and the chunk state, three bf16 products each (the fp32 operand's
    three terms).  Returns (ms, by, bytes ms, operations ms, GFLOP)."""
    b, l, _ = ins["z"].shape
    L, c = chunk, l // chunk
    tri = L * (L + 1) // 2
    ops = b * c * (N_GROUPS * 2 * D_STATE * tri + N_HEADS * 3 * (
        2 * HEAD_DIM * tri + 4 * L * D_STATE * HEAD_DIM))
    t_bytes = _bytes(*ins.values(), *outs) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_TC_FLOP_PER_S * 1e3
    ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return ms, by, t_bytes, t_ops, ops / 1e9


def _bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def decode_bound(ins, outs):
    """(ms, 'bytes'|'operations'): inputs read once and outputs written
    once over HBM, vs ~5 fp32 operations per state element (decay, x*dt,
    *B, +, *C and its sum) plus the conv and the norm, over fp32 peak."""
    b, h, p, n = ins["ssm_state"].shape
    ops = 5 * b * h * p * n + 10 * b * D_XBC + 10 * b * D_INNER
    return _bound(_bytes(*ins.values(), *outs), ops)


def ssd_chunk_ops(b, c, L, h, g, p, n):
    """The least work of the intra-chunk pass: the lower triangle (with
    its diagonal) of C B^T once per group, its decay (a difference and an
    exp per pair) and its product with x per head, and the state product
    (2 operations per multiply-add)."""
    tri = L * (L + 1) // 2
    return b * c * (g * 2 * n * tri + h * (2 * p * tri + 2 * tri +
                                           2 * L * p * n + L * p))


def pwl_ops(numel, table):
    """m0*x + c0, then a subtraction, max, product and sum per breakpoint."""
    return numel * (2 + 4 * (table.num_segments - 1))


def mamba1_bound(ins, outs):
    """Kernel 5's bound: inputs once and outputs once over HBM, vs its
    fp32 operations: per row the conv (2 w di), x_proj (2 di (r+2n)),
    dt_proj (2 r di), ~7 per state element (dt*A, exp, the decay, dt*u*B
    and the sum, *C and its sum) and ~20 per channel for the
    activations, the D skip and the gate."""
    b = ins["z"].shape[0]
    di, n, r = M1_D_INNER, M1_D_STATE, M1_DT_RANK
    ops = b * (2 * WIDTH * di + 2 * di * (r + 2 * n) + 2 * r * di
               + 7 * di * n + 20 * di)
    return _bound(_bytes(*ins.values(), *outs), ops)


def _bound(nbytes, ops, flop_per_s=FP32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qmatmul_times(dev, kernels, paths, worst):
    """Phase 7's qmatmul rows: the serve path's shapes in bf16, decode (m =
    4 slots, the GEMV) and chunked prefill (m = 4 x 64, the ``wgmma``
    body), in_proj and out_proj, a row each.  Beside each: the wrapper's
    host microseconds per call and ``torch.matmul``'s; the GEMV also with
    its weights cold (a rotation of copies whose bytes exceed the 50 MB
    L2, as the 24 layers' ~91 MB of int8 projections find them in a
    decode step); at m = 256 the SIMT tiled body on the same inputs, not
    counted.  Bound: bytes (x, q, scale, out once) at HBM
    rate or 2 m k n operations at bf16 tensor-core rate (the int8 weights
    widen exactly to bf16).  Library: one ``torch.matmul`` of x with the
    int8 payload cast once to bf16 (the same contraction, before the
    per-channel scale)."""
    import torch
    rows = []
    for body, m in (("gemv", 4), ("wgmma", 256)):
        for proj, k, n in (("in_proj", D_MODEL, D_IN_PROJ),
                           ("out_proj", D_INNER, D_MODEL)):
            args, _ = qmatmul_inputs(m, k, n, dev, torch.bfloat16,
                                     seed=40 + m + n)
            x, q, scale = args
            call = lambda: kernels["qmatmul"](*args)   # noqa: E731
            out = call()
            ms = time_call(call)
            plain_ms = time_call(lambda: kernels["qmatmul_plain"](*args))
            dev_ms = _ours(device_profile(call))
            qc = q.to(x.dtype)
            lib = lambda: torch.matmul(x, qc)          # noqa: E731
            lib_ms = time_call(lib)
            lib_dev = sum(device_profile(lib).values())
            us, lib_us = host_us(call), host_us(lib)
            bound_ms, bound_by = _bound(_bytes(x, q, scale, out),
                                        2 * m * k * n, BF16_TC_FLOP_PER_S)
            print(f"  qmatmul {body} {proj} bf16 x ({m}, {k}) q ({k}, {n}): "
                  f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms; host "
                  f"{us:.1f} us a call), plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}), library {lib_ms:.4f} ms "
                  f"(torch.matmul on the bf16 cast; device {lib_dev:.4f} "
                  f"ms, host {lib_us:.1f} us a call); {paths[body]} "
                  f"launches of this body in the W8 continuous serve run",
                  flush=True)
            if body == "gemv":
                copies = [q.clone() for _ in range(
                    math.ceil(64e6 / q.numel()))]
                turn = itertools.cycle(copies)
                cold = lambda: kernels["qmatmul"](x, next(turn), scale)  # noqa
                cold_ms = time_call(cold, n=len(copies))
                cold_dev = _ours(device_profile(cold, n=len(copies)))
                print(f"    weights cold ({len(copies)} copies, "
                      f"{len(copies) * q.numel() / 1e6:.1f} MB in turn): "
                      f"kernel {cold_ms:.4f} ms (device {cold_dev:.4f} ms)",
                      flush=True)
                del copies, turn
            else:
                simt_ms = time_call(lambda: simt_qmatmul(*args))
                simt_dev = _ours(device_profile(lambda: simt_qmatmul(*args)))
                print(f"    the SIMT tiled body on the same inputs (not "
                      f"counted): kernel {simt_ms:.4f} ms (device "
                      f"{simt_dev:.4f} ms): the wgmma body is "
                      f"{simt_dev / max(dev_ms, 1e-9):.1f}x faster in device "
                      f"time", flush=True)
            rows.append(dict(
                name=f"qmatmul_{body}_{proj}", route="cuda",
                source="src/repro_torch/csrc/qmatmul.cu",
                replaces="src/repro/kernels/qmatmul.py:85",
                launches=paths[body], max_abs_err=worst["qmatmul"],
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms))
    for gated in (0, 1):
        print(f"  qmatmul wgmma body ({'gated' if gated else 'plain'}): "
              f"{wgmma_smem('qmatmul', 'qmatmul_wgmma_smem', gated)} bytes "
              f"of dynamic shared memory", flush=True)
    for needle in ("qmatmul_wgmma_kernel", "gemv_cluster_kernel"):
        for line in ptxas_lines("qmatmul", needle):
            print(f"    ptxas {line}")
    return rows


def ssd_times(dev, kernels, args, outs, launches, dev_ms, rate):
    """Phase 7's extra lines for kernel 7 at the chain's shape: the body
    and head-set size its rule picks, its launches by body in the
    ``pallas()`` forward, the SIMT body on the same inputs (not counted),
    the bound at the CUDA cores' fp32 rate beside the tensor cores' split
    rate, and ptxas's report and the shared memory of the ``wgmma``
    body."""
    from repro_torch.kernels import ssd_chunk
    x_c, B_c = args[0], args[2]
    b, c, L, h, _ = x_c.shape
    g = B_c.shape[3]
    print(f"    body {ssd_chunk.path(*args)}, {ssd_chunk.heads_per_set(b, c, L, h, g)}"
          f" heads a y block ({b * c * (L // 64)} query tiles x "
          f"{h // ssd_chunk.heads_per_set(b, c, L, h, g)} head sets and "
          f"{b * c * h} state blocks); launches by body in the pallas() "
          f"forward {launches['ssd_chunk_paths']}", flush=True)
    simt = lambda: simt_ssd_chunk(*args)                   # noqa: E731
    simt_ms = time_call(simt)
    simt_dev = _ours(device_profile(simt))
    _, fails = compare("ssd_chunk SIMT body vs plain", simt(),
                       kernels["ssd_chunk_plain"](*args), "float32",
                       (("y_diag", "state"), ("states", "state")))
    assert not fails, f"times: {fails}"
    print(f"    the SIMT body on the same inputs (not counted): kernel "
          f"{simt_ms:.4f} ms (device {simt_dev:.4f} ms): the wgmma body is "
          f"{simt_dev / max(dev_ms, 1e-9):.1f}x faster in device time",
          flush=True)
    ops = ssd_chunk_ops(CHAIN_B, CHAIN_C, CHUNK, N_HEADS, N_GROUPS, HEAD_DIM,
                        D_STATE)
    nbytes = _bytes(*args, *outs)
    for label, r in (("fp32-accurate tensor-core products (six bf16 "
                      "products each)", rate),
                     ("the fp32 CUDA cores", FP32_FLOP_PER_S)):
        t, by = _bound(nbytes, ops, r)
        print(f"    bound at {r / 1e12:.1f} TFLOP/s ({label}): {t:.4f} ms "
              f"({by}); {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB",
              flush=True)
    print(f"    wgmma body: {wgmma_smem('ssd_chunk', 'ssd_chunk_wgmma_smem', L)}"
          f" bytes of dynamic shared memory at L = {L}", flush=True)
    for line in ptxas_lines("ssd_chunk", "ssd_chunk_wgmma_kernel"):
        print(f"    ptxas {line}")


def pwl_floor_ms(numel, table):
    """Kernel 12's instruction floor in its kept order: ``pwl_ops``
    instructions an element (none fused), each a lane's issue slot."""
    return pwl_ops(numel, table) / FP32_ISSUE_PER_S * 1e3


def pwl_times(dev, kernels, launches, tables):
    """Phase 7's extra lines for kernel 12: the ``pallas()`` forward's
    three operands in fp32 (xBC's and the gate's SiLU, dt's softplus) and
    phase 4's 32-bucket xBC in bf16 beside the forward's, each with its
    call, device and host time, its byte bound and its instruction floor;
    the launches by body in the forward; ptxas's report."""
    import torch
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        ch = chain_inputs(dev, dtype, seed=34)
        if dtype == torch.float32:
            cases += [("silu", ch["xbc"]), ("silu", ch["z"]),
                      ("softplus", ch["dt"])]
        else:
            cases += [("silu", ch["xbc"][:, :32].contiguous()),
                      ("silu", ch["xbc"])]
    for name, x in cases:
        call = lambda: kernels["pwl_activate"](x, tables[name])  # noqa
        out = call()
        ms = time_call(call)
        dev_ms = _ours(device_profile(call))
        us = host_us(call)
        bytes_ms, _ = _bound(_bytes(x, out), 0)
        print(f"  pwl_activate {str(x.dtype).split('.')[-1]} {name} "
              f"{tuple(x.shape)}: kernel {ms:.4f} ms (device {dev_ms:.4f} "
              f"ms), host {us:.1f} us a call; bytes {bytes_ms:.4f} ms, "
              f"instruction floor {pwl_floor_ms(x.numel(), tables[name]):.4f}"
              f" ms ({2 + 4 * (tables[name].num_segments - 1)} an element)",
              flush=True)
    print(f"    launches by body in the pallas() forward "
          f"{launches['pwl_activate_paths']}", flush=True)
    for line in ptxas_lines("actiba", "pwl_activate_kernel"):
        print(f"    ptxas {line}")


def times_phase(dev, kernels, launches, steps, waves, worst, tables):
    """Phase 7: kernel and plain times at the shapes each path gives the
    kernel (serve: bf16, b=4, prefill l=128, one chunk; the ablation's
    chain: fp32, b=4, l=300 in two chunks of 256) and the kernels
    record."""
    import torch
    from repro_torch.kernels.prefill_chunk import heads_per_set
    from repro_torch.kernels.prefill_chunk import path as prefill_chunk_path
    kw = dict(ngroups=N_GROUPS, head_dim=HEAD_DIM)
    dtype = torch.bfloat16
    rows = []
    ins = decode_inputs(4, dev, dtype, seed=31)
    step = lambda: kernels["mamba2_step"](**ins, **kw)          # noqa: E731
    outs = step()
    ms = time_call(step)
    plain_ms = time_call(lambda: kernels["mamba2_step_plain"](**ins, **kw))
    dev_ms = _ours(device_profile(step))
    us = host_us(step)
    bufs = (torch.empty_like(ins["conv_state"]),
            torch.empty_like(ins["ssm_state"]))
    us_out = host_us(lambda: kernels["mamba2_step"](**ins, **kw, out=bufs))
    bound_ms, bound_by = decode_bound(ins, outs)
    rows.append(dict(
        name="mamba2_step", route="cuda",
        source="src/repro_torch/csrc/decode_step.cu",
        replaces="src/repro/kernels/decode_step.py:155",
        launches=launches["mamba2_step"],
        max_abs_err=worst["mamba2_step"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    print(f"  mamba2_step b=4 bf16: kernel {ms:.4f} ms (device {dev_ms:.4f} "
          f"ms, one launch, the norm fused; targets 0.03 and 0.005), host "
          f"{us:.1f} us a call with fresh states, {us_out:.1f} us into the "
          f"caller's buffers as the engine calls it (target 20), plain "
          f"{plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); "
          f"{launches['mamba2_step'] / steps:.0f} launches per decode step; "
          f"PR 11's two launches are gone (PERF.md's table: device 0.0136 "
          f"ms, call 0.1877 ms)", flush=True)
    ktab = dict(silu_table=tables["silu"], softplus_table=tables["softplus"])
    ms_a = time_call(lambda: kernels["mamba2_step"](**ins, **kw, **ktab))
    dev_a = _ours(device_profile(
        lambda: kernels["mamba2_step"](**ins, **kw, **ktab)))
    print(f"  mamba2_step b=4 bf16 with the ActiBA tables: kernel {ms_a:.4f} "
          f"ms (device {dev_a:.4f} ms)", flush=True)

    for l in (128, 64):             # the wave's call, the continuous chunks
        ins = prefill_inputs(4, l, dev, dtype, seed=32)
        call = lambda: kernels["mamba2_prefill"](         # noqa: E731
            **ins, chunk=l, **kw)
        outs = call()
        ms = time_call(call)
        by = device_profile(call)
        dev_ms = _ours(by)
        us = host_us(call)
        simt = lambda: simt_prefill(ins, l)                # noqa: E731
        simt_ms = time_call(simt)
        simt_dev = _ours(device_profile(simt))
        _, fails = compare(f"mamba2_prefill SIMT body l={l} vs plain",
                           simt(), kernels["mamba2_prefill_plain"](
                               **ins, chunk=l, **kw), "bfloat16")
        assert not fails, f"times: {fails}"
        bound_ms, bound_by, t_bytes, t_ops, gflop = prefill_tc_bound(
            ins, outs, l)
        body = prefill_chunk_path(ins["xbc"], ins["ssm_state"], chunk=l,
                                  head_dim=HEAD_DIM)
        print(f"  mamba2_prefill b=4 l={l} bf16 ({body} body, "
              f"{heads_per_set(4, 1, l, N_HEADS, N_GROUPS)} heads a y "
              f"block): kernel {ms:.4f} ms (device of its kernels "
              f"{dev_ms:.4f} ms; target 0.05 at l = 128), host {us:.1f} us "
              f"a call; the SIMT body on the same inputs (not counted): "
              f"kernel {simt_ms:.4f} ms (device {simt_dev:.4f} ms), "
              f"{simt_dev / max(dev_ms, 1e-9):.1f}x the tensor-core body's "
              f"device time; bound {bound_ms:.4f} ms ({bound_by}: "
              f"{t_bytes:.4f} ms of bytes, {t_ops:.4f} ms for {gflop:.3f} "
              f"GFLOP of bf16 products)", flush=True)
        for k, v in sorted(by.items(), key=lambda kv: -kv[1]):
            if any(o in k for o in OUR_KERNELS):
                print(f"    {v:.4f} ms  {k[:90]}")
        if l == 128:
            plain_ms = time_call(lambda: kernels["mamba2_prefill_plain"](
                **ins, chunk=128, **kw))
            rows.append(dict(
                name="mamba2_prefill", route="cuda",
                source="src/repro_torch/csrc/prefill_chunk.cu",
                replaces="src/repro/kernels/prefill_chunk.py:294",
                launches=launches["mamba2_prefill"],
                max_abs_err=worst["mamba2_prefill"], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None))
            print(f"    plain {plain_ms:.4f} ms; "
                  f"{launches['mamba2_prefill'] / waves:.0f} launches per "
                  f"prefill; library: no single PyTorch call", flush=True)
            ms_a = time_call(lambda: kernels["mamba2_prefill"](
                **ins, chunk=128, **kw, **ktab))
            dev_a = _ours(device_profile(lambda: kernels["mamba2_prefill"](
                **ins, chunk=128, **kw, **ktab)))
            print(f"  mamba2_prefill b=4 l=128 bf16 with the ActiBA tables: "
                  f"kernel {ms_a:.4f} ms (device {dev_a:.4f} ms)", flush=True)
    print(f"    wgmma body: {wgmma_smem('prefill_chunk', 'mamba2_prefill_wgmma_smem', 1, 128)}"
          f" bytes of dynamic shared memory at bf16, chunk 128", flush=True)
    for line in ptxas_lines("prefill_chunk", "ssd_prefill_wgmma_kernel"):
        print(f"    ptxas {line}")
    for line in ptxas_lines("decode_step", "mamba2_step_kernel"):
        print(f"    ptxas {line}")

    # The chain's kernels at the ablation's shapes (fp32, b=4, l=300).
    # Kernel 7's bound takes the rate of fp32-accurate tensor-core products
    # (its wgmma body's split); the others' the fp32 CUDA cores'.
    ch = chain_inputs(dev, torch.float32, seed=33)
    chain = (
        ("cumsum_last", "cumba.cu", "src/repro/kernels/cumba.py:51",
         (ch["a_c"],), lambda o: 0.0 + ch["a_c"].numel(),
         lambda: torch.cumsum(ch["a_c"], dim=-1), FP32_FLOP_PER_S),
        ("ssd_chunk", "ssd_chunk.cu", "src/repro/kernels/ssd_chunk.py:62",
         (ch["x_c"], ch["A_cum"], ch["B_c"], ch["C_c"]),
         lambda o: ssd_chunk_ops(CHAIN_B, CHAIN_C, CHUNK, N_HEADS, N_GROUPS,
                                 HEAD_DIM, D_STATE), None,
         SPLIT_TC_FLOP_PER_S),
        ("pwl_activate", "actiba.cu", "src/repro/kernels/actiba.py:52",
         (ch["xbc"], tables["silu"]),
         lambda o: pwl_ops(ch["xbc"].numel(), tables["silu"]), None,
         FP32_FLOP_PER_S),
    )
    for name, src, where, args, ops, library, rate in chain:
        outs = kernels[name](*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        ms = time_call(lambda: kernels[name](*args))
        plain_ms = time_call(lambda: kernels[name + "_plain"](*args))
        dev_ms = _ours(device_profile(lambda: kernels[name](*args)))
        lib_ms = time_call(library) if library else None
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        bound_ms, bound_by = _bound(_bytes(*tensors, *outs), ops(outs), rate)
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=where, launches=launches[name],
            max_abs_err=worst[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))
        shapes = ", ".join(str(tuple(a.shape)) for a in tensors)
        print(f"  {name} fp32 {shapes}: kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), library "
              + (f"{lib_ms:.4f} ms (torch.cumsum)" if lib_ms is not None
                 else "none: no single PyTorch call")
              + f"; {launches[name]} launches in the pallas() forward",
              flush=True)
        if name == "cumsum_last":
            print(f"    host: the wrapper {host_us(lambda: kernels[name](*args)):.1f}"
                  f" us a call, torch.cumsum {host_us(library):.1f} us; "
                  f"library device time "
                  f"{sum(device_profile(library).values()):.4f} ms",
                  flush=True)
        elif name == "ssd_chunk":
            ssd_times(dev, kernels, args, outs, launches, dev_ms, rate)
        elif name == "pwl_activate":
            pwl_times(dev, kernels, launches, tables)
    return rows + qmatmul_times(dev, kernels, launches["qmatmul_paths"],
                                worst)


def mamba1_times(dev, kernels, launches, steps, worst, tables):
    """Phase 7's rows for kernels 5, 4 and 3: kernel 5 at the mamba-130m
    serve shapes (b = 4, bf16; launches and steps of the continuous bf16
    run), the bare updates at b = 4 in fp32 (launches of phase 5c)."""
    import torch
    rows = []
    kw = dict(dt_rank=M1_DT_RANK)
    ins = mamba1_inputs(4, dev, torch.bfloat16, seed=70)
    outs = kernels["mamba1_step"](**ins, **kw)
    ms = time_call(lambda: kernels["mamba1_step"](**ins, **kw))
    plain_ms = time_call(lambda: kernels["mamba1_step_plain"](**ins, **kw))
    dev_ms = _ours(device_profile(lambda: kernels["mamba1_step"](**ins,
                                                                 **kw)))
    us = host_us(lambda: kernels["mamba1_step"](**ins, **kw))
    bufs = (torch.empty_like(ins["conv_state"]),
            torch.empty_like(ins["ssm_state"]))
    us_out = host_us(lambda: kernels["mamba1_step"](**ins, **kw, out=bufs))
    bound_ms, bound_by = mamba1_bound(ins, outs)
    rows.append(dict(
        name="mamba1_step", route="cuda",
        source="src/repro_torch/csrc/mamba1_step.cu",
        replaces="src/repro/kernels/decode_step.py:221",
        launches=launches["mamba1_step"], max_abs_err=worst["mamba1_step"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None))
    print(f"  mamba1_step b=4 bf16: kernel {ms:.4f} ms (device {dev_ms:.4f} "
          f"ms, one launch, a cluster of 16 blocks a row; target 0.005), host {us:.1f} us a call with fresh states, "
          f"{us_out:.1f} us into the caller's buffers (target 30), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{launches['mamba1_step'] / steps:.0f} launches per decode step; "
          f"library: no single PyTorch call; the two-launch body it replaced "
          f"read device 0.0116 ms, call 0.1130 ms (PERF.md's table)",
          flush=True)
    ktab = dict(silu_table=tables["silu"], softplus_table=tables["softplus"])
    ms_a = time_call(lambda: kernels["mamba1_step"](**ins, **kw, **ktab))
    dev_a = _ours(device_profile(
        lambda: kernels["mamba1_step"](**ins, **kw, **ktab)))
    print(f"  mamba1_step b=4 bf16 with the ActiBA tables: kernel {ms_a:.4f} "
          f"ms (device {dev_a:.4f} ms)", flush=True)
    for line in ptxas_lines("mamba1_step", "mamba1_step_kernel"):
        print(f"    ptxas {line}")
    for name, src, where, args, ops, was in (
            ("sscan_step", "mamba1_step.cu",
             "src/repro/kernels/decode_step.py:113",
             sscan_inputs(4, dev, torch.float32, seed=71),
             (7 * M1_D_STATE + 2) * 4 * M1_D_INNER,
             "; kernel 5's four-lanes-a-channel stream; the one-thread-a-"
             "channel body it replaced read device 0.0033 ms, call 0.0767 "
             "ms (PERF.md's table)"),
            ("ssd_step", "decode_step.cu",
             "src/repro/kernels/decode_step.py:76",
             ssd_step_inputs(4, dev, torch.float32, seed=72),
             (5 * D_STATE + 2) * 4 * N_HEADS * HEAD_DIM, "")):
        outs = kernels[name](*args)
        ms = time_call(lambda: kernels[name](*args))
        plain_ms = time_call(lambda: kernels[name + "_plain"](*args))
        dev_ms = _ours(device_profile(lambda: kernels[name](*args)))
        tensors = [a for a in args if a is not None]
        bound_ms, bound_by = _bound(_bytes(*tensors, *outs), ops)
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=where, launches=launches[name], max_abs_err=worst[name],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
        print(f"  {name} fp32 state {tuple(args[0].shape)}: kernel {ms:.4f} "
              f"ms (device {dev_ms:.4f} ms), host "
              f"{host_us(lambda: kernels[name](*args)):.1f} us a call, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
              f"library: no single PyTorch call; {launches[name]} launch in "
              f"phase 5c{was}", flush=True)
    for source, needle in (("mamba1_step", "sscan_step_kernel"),
                           ("decode_step", "ssd_step_kernel")):
        for line in ptxas_lines(source, needle):
            print(f"    ptxas {line}")
    return rows


def engines_summary(engines):
    """The serve metrics of each engine run side by side."""
    keys = ("requests", "generated_tokens", "tokens_per_s", "ttft_mean_s",
            "ttft_p99_s", "slot_occupancy", "token_latency_s")
    for label, eng in engines:
        m = eng.metrics.summary()
        print(f"  {label:34s} " + ", ".join(
            f"{k} {m[k]:.4f}" if isinstance(m[k], float) else f"{k} {m[k]}"
            for k in keys), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.pwl import table_for
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.kernels import actiba, build, cumba, decode_step, \
        flash_attention, matmul_pwl, prefill_chunk, qmatmul, reduba, rg_lru, \
        ssd_chunk
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    print("== 1. device", flush=True)
    smi = _nvidia_smi()
    print(smi, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    print("== 2. build", flush=True)
    secs = build.build_all()
    print(f"  nvcc built {list(build.SOURCES)} in {secs:.1f} s", flush=True)
    for name in build.SOURCES:
        for line in str(build.BUILD_LOG.get(name, "")).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = {
        "mamba2_step": decode_step.mamba2_step,
        "mamba2_step_plain": decode_step.mamba2_step_plain,
        "mamba2_prefill": prefill_chunk.mamba2_prefill,
        "mamba2_prefill_plain": prefill_chunk.mamba2_prefill_plain,
        "cumsum_last": cumba.cumsum_last,
        "cumsum_last_plain": cumba.cumsum_last_plain,
        "ssd_chunk": ssd_chunk.ssd_chunk,
        "ssd_chunk_plain": ssd_chunk.ssd_chunk_plain,
        "pwl_activate": actiba.pwl_activate,
        "pwl_activate_plain": actiba.pwl_activate_plain,
        "qmatmul": qmatmul.qmatmul,
        "qmatmul_plain": qmatmul.qmatmul_plain,
        "mamba1_step": decode_step.mamba1_step,
        "mamba1_step_plain": decode_step.mamba1_step_plain,
        "sscan_step": decode_step.sscan_step,
        "sscan_step_plain": decode_step.sscan_step_plain,
        "ssd_step": decode_step.ssd_step,
        "ssd_step_plain": decode_step.ssd_step_plain,
        "rglru_step": decode_step.rglru_step,
        "rglru_step_plain": decode_step.rglru_step_plain,
        "rg_lru_scan": rg_lru.rg_lru_scan,
        "rg_lru_scan_plain": rg_lru.rg_lru_scan_plain,
        "matmul_pwl": matmul_pwl.matmul_pwl,
        "matmul_pwl_plain": matmul_pwl.matmul_pwl_plain,
        "flash_attention": flash_attention.flash_attention,
        "flash_attention_plain": flash_attention.flash_attention_plain,
        "reduce_rows": reduba.reduce_rows,
        "reduce_rows_plain": reduba.reduce_rows_plain,
    }
    counters = {"mamba2_step": decode_step.mamba2_step,
                "mamba2_prefill": prefill_chunk.mamba2_prefill,
                "cumsum_last": cumba.cumsum_last,
                "ssd_chunk": ssd_chunk.ssd_chunk,
                "pwl_activate": actiba.pwl_activate,
                "qmatmul": qmatmul.qmatmul,
                "mamba1_step": decode_step.mamba1_step,
                "sscan_step": decode_step.sscan_step,
                "ssd_step": decode_step.ssd_step,
                "rglru_step": decode_step.rglru_step,
                "rg_lru_scan": rg_lru.rg_lru_scan,
                "matmul_pwl": matmul_pwl.matmul_pwl,
                "flash_attention": flash_attention.flash_attention,
                "reduce_rows": reduba.reduce_rows}
    secs = {}

    def phase(title):
        """Print a phase's heading and the seconds the last one took."""
        now = time.perf_counter()
        if secs:
            last = next(reversed(secs))
            secs[last] = now - secs[last]
            print(f"  ({last}: {secs[last]:.1f} s)", flush=True)
        if title:
            print(f"== {title}", flush=True)
            secs[title] = now
    pallas = XambaConfig.pallas()
    tables = {k: table_for(k, pallas) for k in ("silu", "softplus",
                                                "sigmoid", "gelu")}

    phase("3. kernels vs plain (full width)")
    with torch.inference_mode():
        worst = kernel_cases(dev, kernels, tables)

    phase("4. serve (mamba2-130m, bf16, wave engine)")
    engine, launches, steps, waves = serve_phase(serve.main, counters,
                                                 SERVE_ARGV)
    with torch.inference_mode():
        serve_modes_phase(serve.main, counters, get_config("mamba2-130m"),
                          dev)
    phase("4b. serve (mamba2-130m, continuous engine, chunk 64)")
    w8_engine, w8_launches, qmm_paths = continuous_phase(
        serve.main, counters, CONT_ARGV + ["--quant", "w8"])
    launches.update(qmatmul=w8_launches["qmatmul"], qmatmul_paths=qmm_paths)
    cont_engine, _, _ = continuous_phase(serve.main, counters, CONT_ARGV)

    phase("4c. serve (mamba-130m: wave, continuous chunk 64, W8)")
    m1_argv = [a if a != "mamba2-130m" else "mamba-130m" for a in CONT_ARGV]
    m1_engine, m1_launches, _ = continuous_phase(serve.main, counters,
                                                 m1_argv)
    launches["mamba1_step"] = m1_launches["mamba1_step"]
    m1_steps = m1_engine.metrics.summary()["decode_steps"]
    m1_w8_engine, _, _ = continuous_phase(serve.main, counters,
                                          m1_argv + ["--quant", "w8"])
    m1_wave, _, _, _ = serve_phase(
        serve.main, counters,
        [a if a != "mamba2-130m" else "mamba-130m" for a in SERVE_ARGV])

    phase("4d. serve (recurrentgemma-2b: wave, continuous chunk 64, "
          "pallas(), loss, ring)")
    rg_wave, _, _, _ = serve_phase(serve.main, counters, RG_SERVE_ARGV)
    rg_engine, rg_launches, _ = continuous_phase(serve.main, counters,
                                                 RG_CONT_ARGV)
    launches["rglru_step"] = rg_launches["rglru_step"]
    with torch.inference_mode():
        rg_modes, rg_pallas = rgemma_modes_phase(rg_engine, counters, dev)
    launches.update(rg_modes)

    phase("4e. serve (gemma-2b, use_flash: wave, continuous chunk 64, "
          f"{GEMMA_LONG}-token prompt, loss)")
    gemma_wave, gemma_cont, gemma_launches = gemma_phase(dev, counters)
    launches.update(gemma_launches)
    phase(f"4f. serve (qwen1.5-4b, depth {QWEN_DEPTH}, use_flash, wave)")
    qwen_wave = qwen_phase(dev, counters)

    phase("5. path parity (fp32, kernel path vs plain path)")
    parity_phase(dev, 1, get_config("mamba2-130m"), counters)
    parity_phase(dev, 1, get_config("mamba2-130m"), counters, "w8")
    engines_phase(dev, 3, get_config("mamba2-130m"))
    phase("5b. path parity (mamba-130m, fp32)")
    m1_tol = parity_phase(dev, 1, get_config("mamba-130m"), counters)
    engines_phase(dev, 3, get_config("mamba-130m"), m1_tol)
    phase("5c. bare updates (kernels 3 and 4 through core/)")
    with torch.inference_mode():
        launches.update(bare_updates_phase(dev, counters))
    phase("5d. path parity (recurrentgemma-2b, depth 5, fp32)")
    rg_tol = rgemma_parity_phase(dev, 1, counters)
    engines_phase(dev, 3, get_config("recurrentgemma-2b").replace(n_layers=5),
                  rg_tol)
    phase(f"5e. path parity (gemma-2b, depth {GEMMA_PARITY_DEPTH}, fp32, "
          "use_flash)")
    launches["flash_attention_fp32"] = gemma_parity_phase(dev, 1, counters)
    phase("5f. ReduBA (kernel 14 through core/reduce.py)")
    with torch.inference_mode():
        launches.update(reduba_phase(dev, counters))

    phase("6. ablation (fp32 forward, b=4, l=300)")
    launches.update({k: v for k, v in ablation_phase(
        dev, 2, get_config("mamba2-130m"), counters, kernels, worst).items()
        if k in ("cumsum_last", "ssd_chunk", "pwl_activate",
                 "ssd_chunk_paths", "pwl_activate_paths")})

    phase("7. times")
    with torch.inference_mode():
        rows = times_phase(dev, kernels, launches, steps, waves, worst,
                           tables)
        rows += mamba1_times(dev, kernels, launches, m1_steps, worst, tables)
        rows += rgemma_times(dev, kernels, launches, worst, tables)
        rows += transformer_times(dev, kernels, launches, worst)
        step_breakdown(engine, "mamba2-130m bf16")
        step_breakdown(w8_engine, "mamba2-130m W8")
        step_breakdown(m1_engine, "mamba-130m bf16")
        step_breakdown(m1_w8_engine, "mamba-130m W8")
        step_breakdown(rg_engine, "recurrentgemma-2b bf16")
        step_breakdown(rg_pallas, "recurrentgemma-2b bf16 pallas()")
        step_breakdown(gemma_wave, "gemma-2b bf16 use_flash")
    engines_summary((("mamba2 wave, bf16 (8 requests)", engine),
                     ("mamba2 continuous 64, bf16 (12)", cont_engine),
                     ("mamba2 continuous 64, W8 (12)", w8_engine),
                     ("mamba1 wave, bf16 (8 requests)", m1_wave),
                     ("mamba1 continuous 64, bf16 (12)", m1_engine),
                     ("mamba1 continuous 64, W8 (12)", m1_w8_engine),
                     ("rgemma wave, bf16 (8 requests)", rg_wave),
                     ("rgemma continuous 64, bf16 (12)", rg_engine),
                     ("gemma wave, bf16 flash (4)", gemma_wave),
                     ("gemma continuous 64, bf16 (4)", gemma_cont),
                     (f"qwen wave, depth {QWEN_DEPTH}, flash (4)",
                      qwen_wave)))
    phase(None)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
