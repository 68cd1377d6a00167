"""The RG-LRU linear recurrence over a sequence: the CUDA kernel and its
plain version.

Port of ``repro.kernels.rg_lru.rg_lru_scan`` (TPU kernel 8) and its
oracle ``repro.kernels.ref.rg_lru_scan_ref``:

    h_t = a_t h_{t-1} + b_t,   h_{-1} = 0

a, b (B, L, D) fp32 or bf16 (one dtype) -> h (B, L, D) in a's dtype, the
carry in fp32.  The JAX package runs it on recurrentgemma's cache-less
trunk (``RecurrentGemma.loss``) under a ``pallas`` CumBA mode.

* :func:`rg_lru_scan` — the wrapper around ``csrc/rg_lru.cu`` (one thread
  per (batch, channel), the time steps in order).  CUDA tensors only;
  calls are counted in ``rg_lru_scan.launches``.
* :func:`rg_lru_scan_plain` — the sequential oracle in PyTorch, each
  multiply and add rounded as the kernel rounds them; the CPU path, and
  what the kernel is held to on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common

_LAUNCH = ("rg_lru", "rg_lru_scan_launch",
           [common.I, common.P, common.P, common.P, common.I, common.I,
            common.I, common.P])


def rg_lru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``rg_lru_scan_ref``)."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    out = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (contract as :func:`rg_lru_scan_plain`)."""
    dev = a.device
    common.require(dev.type == "cuda", "rg_lru_scan takes CUDA tensors; the "
                   "CPU path is rg_lru_scan_plain")
    common.require(a.ndim == 3 and a.shape == b.shape and a.dtype == b.dtype,
                   f"rg_lru_scan: a and b must be (B, L, D) of one dtype, got "
                   f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} "
                   f"{b.dtype}")
    common.check_cuda(dev, b=b)
    a, b = a.contiguous(), b.contiguous()
    B, L, D = a.shape
    h = torch.empty_like(a)
    err = common.launcher(*_LAUNCH)(
        common.stream_code(a), common.ptr(a), common.ptr(b), common.ptr(h),
        B, L, D, common.stream(dev))
    common.check_launch(err, "rg_lru", "rg_lru_scan kernel")
    rg_lru_scan.launches += 1
    return h


rg_lru_scan.launches = 0
