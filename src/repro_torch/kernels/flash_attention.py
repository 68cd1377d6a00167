"""Flash attention (causal / sliding window / GQA), forward: the CUDA
kernel and its plain version.

Port of ``repro.kernels.flash_attention._flash_forward`` (TPU kernel 9)
and its oracle ``repro.kernels.ref.attention_ref``.  Layouts are the JAX
package's: q (b, hq, Lq, d); k, v (b, hkv, Lk, d) with hq % hkv == 0;
query head h reads key / value head h // (hq / hkv).  Scores in fp32
(q scaled by ``scale``, default d^-0.5, before the product), masked at
-1e30, softmax, the product with v in fp32, the output in q's dtype.
Masks are left-aligned: query i and key j are both positions from 0.

* :func:`flash_attention` — the wrapper around ``csrc/flash_attention.cu``
  (online softmax over 64-key tiles), three bodies that :func:`path`
  names from dtypes, head_dim, strides and alignment alone:

  - ``"wgmma"``: bf16 q, k and v that TMA can read, on the tensor cores
    (S = q k^T in bf16 with fp32 sums, P V with P split into two bf16
    terms);
  - ``"wgmma_fp32"``: fp32 q, k and v that TMA can read at head_dim 64,
    128 or 256, on the tensor cores with fp32-accurate products (every
    operand in three bf16 terms, six products each), one warpgroup a
    64-column unit of the head, two units a block, and at d = 256 each
    64-query tile a cluster of two blocks whose partial scores meet in
    distributed shared memory;
  - ``"simt"``: the rest (fp32 at head_dim 32, views TMA cannot read),
    fp32 FMAs on the CUDA cores.

  CUDA tensors only; any strides whose last axis is contiguous, so
  ``nn/attention.py`` hands it the (b, s, h, d) projections moved to (b,
  h, s, d) without a copy, and the output keeps q's layout.  Its
  arguments go packed into one buffer (``FLASH_FIELDS``) through cached
  launchers.  Calls are counted in ``flash_attention.launches`` and, by
  body, in ``flash_attention.path_launches``.
* :func:`flash_attention_plain` — ``attention_ref`` in PyTorch: the CPU
  path, and what the kernel is held to on the card.

Keys past Lk are always masked, so both equal ``attention_ref`` in every
case.  The TPU kernel does not mask its zero-padded keys when attention
is not causal: there, with Lk no multiple of 128, it attends to them.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional

import torch

from repro_torch.kernels import common

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)

FP32_HEAD_DIMS = (64, 128, 256)   # the fp32 tensor-core body's
# The launchers take one pointer to their arguments packed as 64-bit
# fields in this order (csrc/flash_attention.cu: FlashArgs).
FLASH_FIELDS = ("dtype", "q", "k", "v", "out", "q_b", "q_h", "q_s", "k_b",
                "k_h", "k_s", "v_b", "v_h", "v_s", "o_b", "o_h", "o_s", "b",
                "hq", "hkv", "lq", "lk", "d", "causal", "window", "scale",
                "stream")
_FLASH_ARGS = struct.Struct("<" + "".join("d" if f == "scale" else "q"
                                          for f in FLASH_FIELDS))
_LAUNCHERS = {body: common.Launcher("flash_attention", fn, [ctypes.c_char_p])
              for body, fn in (("simt", "flash_attention_launch"),
                               ("wgmma", "flash_attention_wgmma_launch"),
                               ("wgmma_fp32",
                                "flash_attention_fp32_wgmma_launch"))}


def _mask(lq: int, lk: int, causal: bool, window: Optional[int], dev
          ) -> torch.Tensor:
    q_ids = torch.arange(lq, device=dev)[:, None]
    k_ids = torch.arange(lk, device=dev)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (k_ids <= q_ids)
    if window is not None:
        mask = mask & (k_ids > q_ids - window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version (``attention_ref``); the query heads of a
    group attend to their key / value head without replicating it."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else d ** -0.5)
    qg = (q.float() * scale).reshape(b, hkv, hq // hkv, lq, d)
    s = torch.einsum("bgqld,bgkd->bgqlk", qg, k.float())
    s = torch.where(_mask(lq, lk, causal, window, q.device), s, NEG_INF)
    out = torch.einsum("bgqlk,bgkd->bgqld", torch.softmax(s, dim=-1),
                       v.float())
    return out.reshape(b, hq, lq, d).to(q.dtype)


def _tma_strides(t: torch.Tensor) -> tuple:
    """Element strides of ``t``'s (b, h, s) axes as the tensor maps take
    them: an axis of extent 1 is never stepped, so it gets the span of the
    axes inside it (TMA wants every stride a multiple of 16 bytes)."""
    b, h, s, d = t.shape
    ss = t.stride(2) if s > 1 else d
    hs = t.stride(1) if h > 1 else ss * s
    return (t.stride(0) if b > 1 else hs * h), hs, ss


def path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The body a call takes, from dtypes, head_dim, strides and alignment
    alone: where q, k and v have 16-byte aligned bases and (b, h, s)
    strides that are multiples of 16 bytes (TMA's rule; every model
    path), ``"wgmma"`` for bf16 and ``"wgmma_fp32"`` for fp32 at a head_dim
    in ``FP32_HEAD_DIMS``; else ``"simt"``."""
    ts = (q, k, v)
    dtype = q.dtype
    if not all(t.dtype == dtype for t in ts):
        return "simt"
    body = {torch.bfloat16: "wgmma", torch.float32: "wgmma_fp32"}.get(dtype)
    if body is None or (body == "wgmma_fp32"
                        and q.shape[-1] not in FP32_HEAD_DIMS):
        return "simt"
    per16 = 16 // q.element_size()
    if all(t.data_ptr() % 16 == 0
           and all(st % per16 == 0 for st in _tma_strides(t)) for t in ts):
        return body
    return "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The CUDA kernel (contract as :func:`flash_attention_plain`)."""
    dev = q.device
    common.require(dev.type == "cuda", "flash_attention takes CUDA tensors; "
                   "the CPU path is flash_attention_plain")
    common.check_cuda(dev, k=k, v=v)
    common.require(q.ndim == 4 and k.ndim == 4 and k.shape == v.shape,
                   f"flash_attention: q (b, hq, Lq, d), k and v (b, hkv, Lk, "
                   f"d), got {tuple(q.shape)}, {tuple(k.shape)}, "
                   f"{tuple(v.shape)}")
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    common.require(k.shape[0] == b and k.shape[3] == d and hq % hkv == 0
                   and lk >= 1, f"flash_attention: k / v {tuple(k.shape)} "
                   f"do not match q {tuple(q.shape)}")
    common.require(d in HEAD_DIMS, f"flash_attention: head_dim {d} not in "
                   f"{HEAD_DIMS}")
    common.require(q.dtype == k.dtype == v.dtype,
                   f"flash_attention: one dtype, got {q.dtype}, {k.dtype}, "
                   f"{v.dtype}")
    common.require(window is None or window >= 1,
                   f"flash_attention: window {window}")
    common.require(b * hq <= 65535, f"flash_attention: b * hq = {b * hq} "
                   f"past the grid's limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        common.require(t.stride(-1) == 1, f"flash_attention: {name}'s last "
                       f"axis must be contiguous, strides {t.stride()}")
    # empty_like keeps a dense q's layout: a (b, s, h, d) buffer seen as
    # (b, h, s, d) comes back the same way.
    out = torch.empty_like(q)
    body = path(q, k, v)
    ins = [t.stride()[:3] if body == "simt" else _tma_strides(t)
           for t in (q, k, v)]
    scale = float(scale if scale is not None else d ** -0.5)
    err = _LAUNCHERS[body](_FLASH_ARGS.pack(
        common.stream_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), *ins[0], *ins[1], *ins[2], *out.stride()[:3], b, hq,
        hkv, lq, lk, d, int(causal), 0 if window is None else int(window),
        scale, common.stream(dev)))
    if err:
        common.check_launch(err, "flash_attention", f"flash_attention {body} "
                            f"kernel")
    flash_attention.launches += 1
    flash_attention.path_launches[body] += 1
    return out


flash_attention.launches = 0
# The same calls by the body they took (bf16 tensor cores, fp32 tensor
# cores, SIMT).
flash_attention.path_launches = {"wgmma": 0, "wgmma_fp32": 0, "simt": 0}
