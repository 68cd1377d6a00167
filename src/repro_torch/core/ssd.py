"""Mamba-2 SSD (structured state-space duality), technique-parameterized:
a port of ``repro.core.ssd``.

* :func:`ssd` — the chunked SSD forward pass of the unfused prefill chain,
  with every XAMBA remapping the JAX package exposes: the prefix sums in
  ``naive`` / ``cumba`` / ``pallas`` mode (``core/segsum.py``; ``pallas``
  is kernel 13), every contraction in ``naive`` / ``reduba`` mode
  (``core/reduce.py``), and the fused intra-chunk kernel 7
  (``kernels/ssd_chunk.py``) when the cumsum mode is ``pallas*`` and the
  chunk is a multiple of 64.
* :func:`ssd_reference` — the exact sequential recurrence, the oracle.
* :func:`ssd_decode_step` — the single-token update in ``naive`` /
  ``cumba`` mode, and in ``pallas`` modes TPU kernel 3 through
  ``kernels/ops.py: ssd_step`` (the hand-written kernel on a CUDA tensor,
  its plain version on a CPU tensor); no model path calls it.

Shapes follow the Mamba-2 convention:
  x:  (batch, seqlen, nheads, headdim)        -- values
  dt: (batch, seqlen, nheads)                 -- softplus'd step sizes
  A:  (nheads,)                                -- negative decay rates
  B:  (batch, seqlen, ngroups, dstate)
  C:  (batch, seqlen, ngroups, dstate)
SSD internals run in fp32 (segsum differences are cancellation-prone);
inputs and outputs keep the caller's dtype.
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import reduce as xreduce, segsum as xsegsum
from repro_torch.core.xamba import XambaConfig

log = logging.getLogger("repro_torch.ssd")
_LOGGED = set()    # (mode, chunk) of the kernel gate's refusals, logged once


def _split_chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    b, l = x.shape[0], x.shape[1]
    return x.reshape((b, l // chunk, chunk) + tuple(x.shape[2:]))


def _intra(x_k, a_k, cs_k, B_k, C_k, *, g: int, cs_mode: str, rd_mode: str,
           mm_dtype: torch.dtype):
    """Chunks folded into the batch axis: x (b,L,h,p), a/cs (b,h,L), B/C
    (b,L,g,n) -> (y_diag (b,L,h,p), states (b,h,p,n)), both fp32."""
    bq, Lk, h, _ = x_k.shape
    hpg = h // g
    if cs_mode == "naive":
        seg = xsegsum.segsum(a_k, mode="naive")             # (b, h, L, L)
    else:
        seg = cs_k[..., :, None] - cs_k[..., None, :]
    tril = torch.tril(torch.ones((Lk, Lk), dtype=torch.bool,
                                 device=x_k.device))
    L_mat = torch.exp(torch.where(tril, seg, -1e30))
    L_g = L_mat.reshape(bq, g, hpg, Lk, Lk).to(mm_dtype)
    CB = xreduce.contract("blgn,bsgn->bgls", C_k.to(mm_dtype),
                          B_k.to(mm_dtype), mode=rd_mode)
    M = CB[:, :, None] * L_g                                # (b, g, q, L, S)
    x_r = x_k.reshape(bq, Lk, g, hpg, -1).to(mm_dtype)
    y_k = xreduce.contract("bgqls,bsgqp->blgqp", M, x_r, mode=rd_mode)
    y_k = y_k.reshape(bq, Lk, h, -1).float()
    dstates = torch.exp(cs_k[..., -1:] - cs_k)              # (b, h, L)
    xw = x_r * dstates.permute(0, 2, 1).reshape(bq, Lk, g, hpg)[
        ..., None].to(mm_dtype)
    st_k = xreduce.contract("blgn,blgqp->bgqpn", B_k.to(mm_dtype), xw,
                            mode=rd_mode)
    st_k = st_k.reshape(bq, h, st_k.shape[-2], -1).float()
    return y_k, st_k


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, *, chunk_size: int = 256,
        initial_state: Optional[torch.Tensor] = None,
        xamba: XambaConfig = XambaConfig(),
        return_final_state: bool = False,
        matmul_dtype: Optional[torch.dtype] = None,
        ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Chunked SSD forward pass.  Returns y (batch, seqlen, nheads,
    headdim) in ``x``'s dtype and, with ``return_final_state``, the final
    state (batch, nheads, headdim, dstate) in fp32."""
    in_dtype = x.dtype
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"nheads {h} not divisible by ngroups {g}")

    # Pad the sequence to a chunk multiple: dt = 0 on padded steps makes
    # them exact no-ops for the outputs kept and for the final state.
    l_orig = l
    pad = (-l) % chunk_size
    if pad:
        def zpad(t):
            return torch.cat([t, t.new_zeros((b, pad) + tuple(t.shape[2:]))],
                             dim=1)
        x, dt, B, C = zpad(x), zpad(dt), zpad(B), zpad(C)
        l = l + pad

    cs_mode, rd_mode = xamba.cumba, xamba.reduba
    store_dtype = matmul_dtype or torch.float32
    mm_dtype = matmul_dtype or torch.float32

    # Discretize: per-step log decay (fp32) and the dt-scaled input, the
    # wide streams stored in ``matmul_dtype``.
    dt_f = dt.float()
    a = dt_f * A.float()[None, None, :]                     # (b, l, h)
    xdt = (x.float() * dt_f[..., None]).to(store_dtype)

    a_c = _split_chunks(a, chunk_size).permute(0, 3, 1, 2).contiguous()
    x_c = _split_chunks(xdt, chunk_size)                    # (b, c, L, h, p)
    B_c = _split_chunks(B.to(store_dtype), chunk_size)      # (b, c, L, g, n)
    C_c = _split_chunks(C.to(store_dtype), chunk_size)
    nchunks = l // chunk_size

    A_cum = xsegsum.cumsum(a_c, axis=-1, mode=cs_mode)      # (b, h, c, L)

    # ---- 1+2. intra-chunk (diagonal blocks) + per-chunk states -----------
    # 64-multiples tile the kernel's 64 x 64 score blocks; below that the
    # chain runs instead, logged so a pallas request never silently runs
    # unfused (the JAX package's gate, core/ssd.py:157-160).
    use_kernel = cs_mode in ("pallas", "pallas_interpret")
    if use_kernel and chunk_size % 64:
        if (cs_mode, chunk_size) not in _LOGGED:
            _LOGGED.add((cs_mode, chunk_size))
            log.info("ssd_chunk kernel (%s) skipped: chunk %d not a "
                     "multiple of 64 — running the op chain", cs_mode,
                     chunk_size)
        use_kernel = False
    kw = dict(g=g, cs_mode=cs_mode, rd_mode=rd_mode, mm_dtype=mm_dtype)
    if use_kernel:
        from repro_torch.kernels import ops
        y_diag, states = ops.ssd_chunk(x_c, A_cum, B_c, C_c)
    elif nchunks > 8:
        # Looped over chunks (the JAX package's scan): one chunk's
        # temporaries at a time.
        outs = [_intra(x_c[:, c], a_c[:, :, c], A_cum[:, :, c], B_c[:, c],
                       C_c[:, c], **kw) for c in range(nchunks)]
        y_diag = torch.stack([o[0] for o in outs], dim=1)
        states = torch.stack([o[1] for o in outs], dim=1)
    else:
        # Batched over chunks (the JAX package's vmap): chunks folded into
        # the batch axis.
        def fold(t):
            return t.reshape((b * nchunks,) + tuple(t.shape[2:]))

        def fold_h(t):                                      # (b, h, c, L)
            return t.permute(0, 2, 1, 3).reshape(b * nchunks, h, chunk_size)
        y_f, st_f = _intra(fold(x_c), fold_h(a_c), fold_h(A_cum), fold(B_c),
                           fold(C_c), **kw)
        y_diag = y_f.reshape(b, nchunks, chunk_size, h, p)
        states = st_f.reshape(b, nchunks, h, p, n)

    # ---- 3. inter-chunk recurrence: s_c = exp(d_c) s_{c-1} + states_c ----
    decays = torch.exp(A_cum[..., -1])                      # (b, h, c)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nchunks):
        prev.append(carry)
        carry = carry * decays[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (b, c, h, p, n)
    final_state = carry

    # ---- 4. state -> output ----------------------------------------------
    hpg = h // g
    ps_g = prev_states.reshape(b, nchunks, g, hpg, p, n).to(mm_dtype)
    y_off = xreduce.contract("bclgn,bcgqpn->bclgqp", C_c.to(mm_dtype), ps_g,
                             mode=rd_mode)
    y_off = y_off.reshape(b, nchunks, chunk_size, h, p).float()
    sdo = torch.exp(A_cum).permute(0, 2, 3, 1)              # (b, c, L, h)
    y_off = y_off * sdo[..., None]

    y = (y_diag + y_off).reshape(b, l, h, p).to(in_dtype)
    if pad:
        y = y[:, :l_orig]
    if return_final_state:
        return y, final_state
    return y


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *,
                  initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(L) sequential recurrence, fp32 throughout.

    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``;  ``y_t = C_t . h_t``.
    x: (b, l, h, p); dt: (b, l, h); A: (h,); B, C: (b, l, g, n).
    Returns (y (b, l, h, p) in x's dtype, final state (b, h, p, n) fp32).
    """
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = B.float().repeat_interleave(hpg, dim=2)              # (b, l, h, n)
    Cf = C.float().repeat_interleave(hpg, dim=2)
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(l):
        dtt = dtf[:, t]                                       # (b, h)
        decay = torch.exp(dtt * Af[None, :])
        dBx = dtt[..., None, None] * Bf[:, t, :, None, :] * \
            xf[:, t, ..., None]
        state = state * decay[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor, *, mode: str = "cumba"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent update.

    * ``naive`` — the state->output contraction as broadcast-multiply +
      ReduceSum (the dense op structure the paper measured);
    * ``cumba`` — that contraction as one einsum over grouped heads;
    * ``pallas`` / ``pallas_interpret`` — the bare-update kernel 3.

    state: (b, h, p, n); x_t: (b, h, p); dt_t: (b, h); B_t, C_t: (b, g, n).
    Returns (new_state fp32, y_t (b, h, p) in ``x_t``'s dtype).
    """
    if mode in ("pallas", "pallas_interpret"):
        from repro_torch.kernels import ops
        return ops.ssd_step(state, x_t, dt_t, A, B_t, C_t)
    b, h, p, n = state.shape
    g = B_t.shape[1]
    hpg = h // g
    dtf = dt_t.float()
    decay = torch.exp(dtf * A.float()[None, :])             # (b, h)
    st_g = state.float().reshape(b, g, hpg, p, n)
    x_g = x_t.float().reshape(b, g, hpg, p)
    dt_g = dtf.reshape(b, g, hpg)
    Bf, Cf = B_t.float(), C_t.float()                       # (b, g, n)
    dBx = (dt_g[..., None] * x_g)[..., None] * Bf[:, :, None, None, :]
    new_g = st_g * decay.reshape(b, g, hpg)[..., None, None] + dBx
    y_g = xreduce.contract("bgqpn,bgn->bgqp", new_g, Cf,
                           mode="naive" if mode == "naive" else "reduba")
    return new_g.reshape(b, h, p, n), y_g.reshape(b, h, p).to(x_t.dtype)
