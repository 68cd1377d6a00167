"""SSD intra-chunk pass: the CUDA kernel and its plain version.

Port of ``repro.kernels.ssd_chunk.ssd_chunk`` (the TPU kernel) and its
oracle ``repro.kernels.ref.ssd_chunk_ref``:

* :func:`ssd_chunk` — the wrapper around ``csrc/ssd_chunk.cu``, one block
  per (batch, chunk, head).  Inputs are cast to fp32 as the JAX wrapper
  casts them.  CUDA tensors only; launches are counted in
  ``ssd_chunk.launches``.
* :func:`ssd_chunk_plain` — ``ssd_chunk_ref`` in PyTorch; the CPU path,
  and what the kernel is held to on the card.

Shapes (the JAX package's):
  x_c   (b, c, L, h, p)  dt-scaled values
  A_cum (b, h, c, L)     inclusive prefix sums of the log decays
  B_c   (b, c, L, g, n)
  C_c   (b, c, L, g, n)
Returns (y_diag (b, c, L, h, p), states (b, c, h, p, n)), fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import common

_LAUNCH = ("ssd_chunk", "ssd_chunk_launch",
           [common.P] * 6 + [common.I] * 7 + [common.P])


def ssd_chunk_plain(x_c: torch.Tensor, A_cum: torch.Tensor,
                    B_c: torch.Tensor, C_c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (``ssd_chunk_ref``), fp32."""
    b, c, L, h, p = x_c.shape
    hpg = h // B_c.shape[3]
    xf = x_c.float()
    cs = A_cum.float()                                       # (b, h, c, L)
    Bh = B_c.float().repeat_interleave(hpg, dim=3)           # (b, c, L, h, n)
    Ch = C_c.float().repeat_interleave(hpg, dim=3)
    seg = cs[..., :, None] - cs[..., None, :]                # (b, h, c, L, L)
    tril = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x_c.device))
    decay = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
    scores = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh)
    y = torch.einsum("bhcls,bcshp->bclhp", scores * decay, xf)
    dstate = torch.exp(cs[..., -1:] - cs).permute(0, 2, 3, 1)  # (b, c, L, h)
    states = torch.einsum("bclhp,bclh,bclhn->bchpn", xf, dstate, Bh)
    return y, states


def ssd_chunk(x_c: torch.Tensor, A_cum: torch.Tensor, B_c: torch.Tensor,
              C_c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel (contract as :func:`ssd_chunk_plain`)."""
    dev = x_c.device
    common.require(dev.type == "cuda", "ssd_chunk takes CUDA tensors; "
                   "the CPU path is ssd_chunk_plain")
    b, c, L, h, p = x_c.shape
    g, n = B_c.shape[3], B_c.shape[4]
    common.require(tuple(A_cum.shape) == (b, h, c, L),
                   f"ssd_chunk: A_cum {tuple(A_cum.shape)} != "
                   f"{(b, h, c, L)}")
    common.require(tuple(B_c.shape) == tuple(C_c.shape) == (b, c, L, g, n),
                   "ssd_chunk: B_c and C_c must be (b, c, L, g, n)")
    common.require(g > 0 and h % g == 0, f"ssd_chunk: h {h} % g {g}")
    common.require(p <= 64 and p * n <= 8192,
                   f"ssd_chunk: head_dim {p} > 64 or p*n {p * n} > 8192")
    common.check_cuda(dev, A_cum=A_cum, B_c=B_c, C_c=C_c)
    xf, af, bf, cf = (t.float().contiguous() for t in (x_c, A_cum, B_c, C_c))
    y = torch.empty((b, c, L, h, p), dtype=torch.float32, device=dev)
    states = torch.empty((b, c, h, p, n), dtype=torch.float32, device=dev)
    fn = common.launcher(*_LAUNCH)
    err = fn(common.ptr(xf), common.ptr(af), common.ptr(bf), common.ptr(cf),
             common.ptr(y), common.ptr(states), b, c, L, h, p, g, n,
             common.stream(dev))
    common.check_launch(err, "ssd_chunk", "ssd_chunk kernel")
    ssd_chunk.launches += 1
    return y, states


ssd_chunk.launches = 0
