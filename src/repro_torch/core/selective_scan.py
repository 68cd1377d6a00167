"""Mamba-1 selective scan: a port of ``repro.core.selective_scan``.

The scan is a per-channel linear recurrence

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t ,   y_t = C_t . h_t + D u_t

run three ways, as in the JAX package:

* ``sequential``  — a time loop, the exact oracle;
* ``associative`` — a log-depth scan over time (Hillis–Steele over the
                    ``(decay, dBu)`` pairs).  It reassociates the products,
                    so it matches the JAX package's
                    ``jax.lax.associative_scan`` tree to fp32 rounding at
                    the state's size, not bit for bit;
* ``chunked``     — CumBA-style: within a chunk the decay products are
                    ``exp(segsum(dt*A))`` (``core/segsum.py`` under
                    ``xamba.cumba``), so the intra-chunk part is a
                    contraction, and a chunk-level recurrence carries the
                    state.  It builds a (b, c, d, n, L, L) decay tensor:
                    6.4 GB of fp32 at mamba-130m's full width with b = 4,
                    l = 128 and chunk 128 (the JAX package's form has the
                    same size), so it is meant for reduced widths.

``initial_state`` + ``return_final_state`` make every mode resumable:
feeding a sequence in slices, threading each call's final ``h`` into the
next, matches one whole-sequence call.

:func:`selective_scan_decode_step` is the one-token update: ``naive``
(multiply + ReduceSum), ``cumba`` (one einsum) or ``pallas*`` (TPU
kernel 4 through ``kernels/ops.py: sscan_step``: the hand-written kernel
on a CUDA tensor, its plain version on a CPU tensor).

Shapes (Mamba-1 convention):
  u:     (batch, seqlen, dinner)
  delta: (batch, seqlen, dinner)   -- post-softplus
  A:     (dinner, dstate)          -- negative
  B, C:  (batch, seqlen, dstate)
  D:     (dinner,)
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core import segsum as xsegsum
from repro_torch.core.xamba import XambaConfig


def linear_scan(decay: torch.Tensor, dBu: torch.Tensor, h0: torch.Tensor
                ) -> torch.Tensor:
    """Inclusive scan of ``(a, b) . (a', b') = (a a', b a' + b')`` over the
    time axis 1 (Hillis–Steele: log2(l) rounds), with the initial state
    ``h0`` (the operands without their time axis) folded in afterwards:
    every state ``h_t = a_t h_{t-1} + b_t``, shaped like ``decay``.  Also
    the RG-LRU's carried-state prefill (``nn/ssm.py``)."""
    a, h = decay, dBu
    l = a.shape[1]
    off = 1
    while off < l:
        h = torch.cat([h[:, :off], h[:, :-off] * a[:, off:] + h[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return h + a * h0[:, None]


def _chunked(dA: torch.Tensor, dBu: torch.Tensor, C: torch.Tensor,
             h0: torch.Tensor, chunk: int, cumba: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CumBA form; dt = 0 padding to a chunk multiple (decay 1, input
    0) leaves the outputs kept and the final state exact."""
    b, l, d, n = dA.shape
    pad = (-l) % chunk
    if pad:
        def zpad(t):
            return torch.cat([t, t.new_zeros((b, pad) + tuple(t.shape[2:]))],
                             dim=1)
        dA, dBu, C = zpad(dA), zpad(dBu), zpad(C)
    lp = l + pad
    c = lp // chunk
    dA_c = dA.reshape(b, c, chunk, d, n)
    dBu_c = dBu.reshape(b, c, chunk, d, n)
    C_c = C.reshape(b, c, chunk, n)
    a_perm = dA_c.permute(0, 1, 3, 4, 2)                   # (b, c, d, n, L)
    L_mat = torch.exp(xsegsum.segsum(a_perm, mode=cumba))  # (b,c,d,n,L,L)
    h_intra = torch.einsum("bcdnts,bcsdn->bctdn", L_mat, dBu_c)
    cum = xsegsum.cumsum(a_perm, axis=-1, mode=cumba)      # (b, c, d, n, L)
    chunk_decay = torch.exp(cum[..., -1])                  # (b, c, d, n)
    chunk_state = h_intra[:, :, -1]
    h, enter = h0, []
    for k in range(c):
        enter.append(h)                                    # state entering k
        h = chunk_decay[:, k] * h + chunk_state[:, k]
    h_enter = torch.stack(enter, dim=1)                    # (b, c, d, n)
    h_all = h_intra + torch.exp(cum).permute(0, 1, 4, 2, 3) * \
        h_enter[:, :, None]
    y = torch.einsum("bctdn,bctn->bctd", h_all, C_c)
    return y.reshape(b, lp, d)[:, :l], h


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None, *,
                   mode: str = "associative", chunk_size: int = 128,
                   initial_state: Optional[torch.Tensor] = None,
                   xamba: XambaConfig = XambaConfig(),
                   return_final_state: bool = False,
                   ) -> Union[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """Returns y (b, l, d) in ``u``'s dtype [and the final state (b, d, n)
    fp32]."""
    b, l, d = u.shape
    n = A.shape[-1]
    uf, df = u.float(), delta.float()
    Bf, Cf = B.float(), C.float()
    # Discretize (ZOH on A, Euler on B, as in Mamba).
    dA = df[..., None] * A.float()[None, None]             # (b, l, d, n)
    dBu = (df * uf)[..., None] * Bf[:, :, None, :]         # (b, l, d, n)
    h0 = (torch.zeros((b, d, n), dtype=torch.float32, device=u.device)
          if initial_state is None else initial_state.float())

    if mode == "sequential":
        h, ys = h0, []
        for t in range(l):
            h = torch.exp(dA[:, t]) * h + dBu[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
        y = torch.stack(ys, dim=1) if ys else uf.new_zeros((b, 0, d))
        hT = h
    elif mode == "associative":
        h_all = linear_scan(torch.exp(dA), dBu, h0)
        y = torch.einsum("bldn,bln->bld", h_all, Cf)
        hT = h_all[:, -1]
    elif mode == "chunked":
        y, hT = _chunked(dA, dBu, Cf, h0, chunk_size, xamba.cumba)
    else:
        raise ValueError(f"unknown selective_scan mode {mode!r}")

    if D is not None:
        y = y + uf * D.float()[None, None]
    y = y.to(u.dtype)
    if return_final_state:
        return y, hT
    return y


def selective_scan_decode_step(state: torch.Tensor, u_t: torch.Tensor,
                               delta_t: torch.Tensor, A: torch.Tensor,
                               B_t: torch.Tensor, C_t: torch.Tensor,
                               D: Optional[torch.Tensor] = None, *,
                               mode: str = "cumba"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token update.  state (b, d, n); u_t, delta_t (b, d); A (d, n);
    B_t, C_t (b, n); D (d,) or ``None``.  Returns (new_state fp32, y_t
    (b, d) in ``u_t``'s dtype)."""
    if mode in ("pallas", "pallas_interpret"):
        from repro_torch.kernels import ops
        return ops.sscan_step(state, u_t, delta_t, A, B_t, C_t, D)
    if mode not in ("naive", "cumba"):
        raise ValueError(f"unknown decode mode {mode!r}")
    dtf = delta_t.float()
    decay = torch.exp(dtf[..., None] * A.float()[None])
    dBu = (dtf * u_t.float())[..., None] * B_t.float()[:, None, :]
    new_state = state.float() * decay + dBu
    Cf = C_t.float()
    if mode == "naive":
        y = torch.sum(new_state * Cf[:, None, :], dim=-1)
    else:
        y = torch.einsum("bdn,bn->bd", new_state, Cf)
    if D is not None:
        y = y + u_t.float() * D.float()[None]
    return new_state, y.to(u_t.dtype)
