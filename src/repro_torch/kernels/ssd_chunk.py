"""SSD intra-chunk pass: the CUDA kernel and its plain version.

Port of ``repro.kernels.ssd_chunk.ssd_chunk`` (the TPU kernel) and its
oracle ``repro.kernels.ref.ssd_chunk_ref``:

* :func:`ssd_chunk` — the wrapper around ``csrc/ssd_chunk.cu``, one launch
  a call on one of two bodies that :func:`path` names from shapes and
  alignment alone: the tensor-core body (``wgmma``: split-precision bf16
  products, each group's C B^T once per set of :func:`heads_per_set`
  heads) or the SIMT body (one block per (batch, chunk, head), fp32 on the
  CUDA cores).  Inputs are cast to fp32 as the JAX wrapper casts them.
  CUDA (or meta) tensors only; launches are counted in
  ``ssd_chunk.launches`` and, by body, in ``ssd_chunk.path_launches``.
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

import functools
from typing import Tuple

import torch

from repro_torch.kernels import common, cost

_LAUNCH = common.Launcher("ssd_chunk", "ssd_chunk_launch",
                          [common.P] * 6 + [common.I] * 7 + [common.P])
_WGMMA = common.Launcher("ssd_chunk", "ssd_chunk_wgmma_launch",
                         [common.P] * 6 + [common.I] * 8 + [common.P])
WGMMA_P = 64            # csrc/ssd_chunk.cu: the head_dim the wgmma body takes
WGMMA_N = (64, 128)     # the d_state values it takes
WGMMA_MAX_L = 4096      # its longest chunk (shared memory)
TILE = 64               # query and key rows of a tile
SMS = 132               # H100 SXM streaming multiprocessors


@functools.lru_cache(maxsize=None)
def heads_per_set(b: int, c: int, L: int, h: int, g: int) -> int:
    """Heads a y block of the ``wgmma`` body takes (csrc/ssd_chunk.cu): the
    smallest divisor of the heads per group whose y blocks, b c (L / 64)
    (h / hs), fit in one wave of the 132 SMs (one block an SM), else all
    of a group's heads.  Every y block then starts at once, the heaviest
    first, and the state blocks fill the SMs as they free up; a y block
    computes its group's score tiles once for its set, so a smaller set
    recomputes them more often (h / hs times) for more parallel blocks.  A
    function of the shapes alone: a shape always takes the same sums in
    the same order."""
    tiles = b * c * (L // TILE)
    for hs in range(1, h // g + 1):
        if (h // g) % hs == 0 and tiles * (h // hs) <= SMS:
            return hs
    return h // g


def path(x_c: torch.Tensor, A_cum: torch.Tensor, B_c: torch.Tensor,
         C_c: torch.Tensor) -> str:
    """The body a call takes, from shapes and alignment alone: ``"wgmma"``
    for p == 64, n 64 or 128, L a multiple of 64 up to 4096 and 16-byte
    aligned x, B and C as the kernel reads them (fp32 and contiguous: an
    operand that needs a cast or a copy gets a fresh, aligned one); else
    ``"simt"``."""
    L, p = x_c.shape[2], x_c.shape[4]
    n = B_c.shape[4]
    if p != WGMMA_P or n not in WGMMA_N or L % TILE or not \
            TILE <= L <= WGMMA_MAX_L:
        return "simt"
    for t in (x_c, B_c, C_c):
        if t.dtype == torch.float32 and t.is_contiguous() and \
                t.data_ptr() % 16:
            return "simt"
    return "wgmma"


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
    """The CUDA kernel (contract as :func:`ssd_chunk_plain`).  The checks
    format their messages only when they fail: the ``pallas()`` forward
    calls this once a layer."""
    dev = x_c.device
    if dev.type != "cuda" and dev.type != "meta":
        raise ValueError("ssd_chunk takes CUDA tensors; the CPU path is "
                         "ssd_chunk_plain")
    b, c, L, h, p = x_c.shape
    g, n = B_c.shape[3], B_c.shape[4]
    if A_cum.shape != (b, h, c, L):
        raise ValueError(f"ssd_chunk: A_cum {tuple(A_cum.shape)} != "
                         f"{(b, h, c, L)}")
    if B_c.shape != (b, c, L, g, n) or C_c.shape != (b, c, L, g, n):
        raise ValueError("ssd_chunk: B_c and C_c must be (b, c, L, g, n)")
    if g <= 0 or h % g:
        raise ValueError(f"ssd_chunk: h {h} % g {g}")
    if p > 64 or p * n > 8192:
        raise ValueError(f"ssd_chunk: head_dim {p} > 64 or p*n {p * n} > "
                         "8192")
    if A_cum.device != dev or B_c.device != dev or C_c.device != dev:
        common.check_cuda(dev, A_cum=A_cum, B_c=B_c, C_c=C_c)   # raises
    body = path(x_c, A_cum, B_c, C_c)
    xf, af, bf, cf = (t.float().contiguous() for t in (x_c, A_cum, B_c, C_c))
    y = torch.empty((b, c, L, h, p), dtype=torch.float32, device=dev)
    states = torch.empty((b, c, h, p, n), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        cost.record("ssd_chunk", cost.ssd_chunk_ops(b, c, L, h, g, p, n),
                    cost._bytes(xf, af, bf, cf, y, states),
                    cost.SPLIT_TC_FLOP_PER_S if body == "wgmma"
                    else cost.FP32_FLOP_PER_S)
        return y, states
    args = (xf.data_ptr(), af.data_ptr(), bf.data_ptr(), cf.data_ptr(),
            y.data_ptr(), states.data_ptr(), b, c, L, h, p, g, n)
    if body == "wgmma":
        err = _WGMMA(*args, heads_per_set(b, c, L, h, g), common.stream(dev))
    else:
        err = _LAUNCH(*args, common.stream(dev))
    if err:
        common.check_launch(err, "ssd_chunk", f"ssd_chunk {body} kernel")
    ssd_chunk.launches += 1
    ssd_chunk.path_launches[body] += 1
    return y, states


ssd_chunk.launches = 0
# The same calls by the body they took (tensor-core, SIMT).
ssd_chunk.path_launches = {"wgmma": 0, "simt": 0}
