"""Fused Mamba-2 multi-token prefill: the CUDA kernel and its plain version.

Port of ``repro.kernels.prefill_chunk``:

* :func:`project_in` — the in-projection that produces the z / xbc / dt
  streams (a plain matmul, as XLA ran it in the JAX package, or under W8
  the ``qmatmul`` kernel);
* :func:`mamba2_prefill` — the wrapper around ``csrc/prefill_chunk.cu``
  (causal conv + SiLU over the sequence, then one block per (batch, head)
  walking the chunks in order with the state in shared memory) followed
  by ``csrc/gated_norm.cu`` over the ``b*l`` rows.  CUDA tensors only;
  calls are counted in ``mamba2_prefill.launches``.  Replaces the TPU
  kernel ``mamba2_prefill_pallas``;
* :func:`mamba2_prefill_plain` — a port of ``mamba2_prefill_xla``: the
  same CumBA triangular-matmul cumsum per chunk, the same carried state,
  and the same stream-dtype rounding points (``prefill_chunk.py:176-186``
  and ``:278-283``).

ActiBA: the plain version takes SiLU and softplus as callables (as the
TPU kernel does, ``prefill_chunk.py:178,182,283``), the kernel takes
their PWL tables (``None`` = exact).

Shapes: z (b, l, di); xbc (b, l, dxbc); dt (b, l, h) RAW (pre-softplus);
conv_state (b, w-1, dxbc); ssm_state (b, h, p, n).  Returns (y (b, l, di)
in the stream dtype, new_conv (b, w-1, dxbc), new_ssm fp32).  ``l`` must
be a multiple of ``chunk``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import common
from repro_torch.kernels.actiba import table_args
from repro_torch.kernels.gated_norm import gated_norm_cuda, gated_norm_plain
from repro_torch.nn import layers

_LAUNCH = ("prefill_chunk", "mamba2_prefill_launch",
           [common.I, common.P, common.I, common.P, common.I]
           + [common.P] * 11 + [common.I] * 8
           + [common.P, common.I, common.P, common.I, common.P])


def project_in(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` producing the z/xbc/dt streams, in ``x``'s dtype; ``w``
    an fp weight or a ``QuantTensor`` (W8: ``quant.qdot``, the qmatmul
    kernel on the GPU), as ``nn/layers.py: linear``."""
    return layers.linear({"w": w}, x)


def _chunk_scan(xdt, a, B, C, state, g: int):
    """One chunk of the SSD recurrence with an incoming state (fp32).

    xdt: (b, L, h, p); a: (b, L, h) log decays; B, C: (b, L, g, n);
    state: (b, h, p, n).  Returns (y (b, L, h, p), new_state).
    """
    b, L, h, p = xdt.shape
    n = B.shape[-1]
    hpg = h // g
    tril = torch.tril(torch.ones(L, L, dtype=torch.float32,
                                 device=xdt.device))
    # CumBA: inclusive prefix sums as one triangular matmul.
    cs = torch.einsum("ls,bsh->blh", tril, a)                 # (b, L, h)
    seg = cs[:, :, None, :] - cs[:, None, :, :]               # (b, L, S, h)
    trilb = (tril > 0)[None, :, :, None]
    decay = torch.where(trilb, torch.exp(torch.where(trilb, seg, 0.0)), 0.0)
    CB = torch.einsum("blgn,bsgn->blsg", C, B)                # (b, L, S, g)
    x_r = xdt.reshape(b, L, g, hpg, p)
    M = CB[..., None] * decay.reshape(b, L, L, g, hpg)
    y = torch.einsum("blsgq,bsgqp->blgqp", M, x_r).reshape(b, L, h, p)
    # Carried state -> this chunk's outputs.
    st_g = state.reshape(b, g, hpg, p, n)
    y_off = torch.einsum("blgn,bgqpn->blgqp", C, st_g)
    y = y + y_off.reshape(b, L, h, p) * torch.exp(cs)[..., None]
    # Outgoing state: decayed incoming state + this chunk's contribution.
    dstate = torch.exp(cs[:, -1:, :] - cs)                    # (b, L, h)
    xw = (xdt * dstate[..., None]).reshape(b, L, g, hpg, p)
    st_new = torch.einsum("blgn,blgqp->bgqpn", B, xw).reshape(b, h, p, n)
    return y, st_new + state * torch.exp(cs[:, -1])[..., None, None]


def mamba2_prefill_plain(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                         dt_bias, A, D, norm_scale, *, ngroups: int,
                         head_dim: int, chunk: int, eps: float = 1e-6,
                         silu: Callable = F.silu,
                         softplus: Callable = F.softplus
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch port of ``mamba2_prefill_xla``."""
    b, l, di = z.shape
    g, p = ngroups, head_dim
    h = dt.shape[-1]
    n = (xbc.shape[-1] - di) // (2 * g)
    sd = z.dtype
    if l % chunk:
        raise ValueError(f"seqlen {l} is not a multiple of chunk {chunk}")
    conv, new_tail = layers.causal_conv1d(
        {"w": conv_w, "b": conv_b}, xbc.float(), conv_state.float())
    # Activated streams round to the stream dtype before the fp32 scan.
    act = silu(conv.to(sd))
    xs = act[..., :di].reshape(b, l, h, p)
    B = act[..., di:di + g * n].reshape(b, l, g, n).float()
    C = act[..., di + g * n:].reshape(b, l, g, n).float()
    dt_f = softplus(dt.float() + dt_bias.float())             # (b, l, h)
    a = dt_f * A.float()
    xdt = xs.float() * dt_f[..., None]
    state = ssm_state.float()
    ys = []
    for c0 in range(0, l, chunk):
        sl = slice(c0, c0 + chunk)
        y_c, state = _chunk_scan(xdt[:, sl], a[:, sl], B[:, sl], C[:, sl],
                                 state, g)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    # D skip in the stream dtype, then the norm with its fp32 interior.
    y = y.to(sd) + xs * D.to(sd)[None, None, :, None]
    out = gated_norm_plain(y.reshape(b, l, di), z, norm_scale,
                           round_stream=True, eps=eps, silu=silu)
    return out, new_tail.to(conv_state.dtype), state


def mamba2_prefill(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                   dt_bias, A, D, norm_scale, *, ngroups: int, head_dim: int,
                   chunk: int, eps: float = 1e-6, out=None,
                   silu_table: Optional[PWLTable] = None,
                   softplus_table: Optional[PWLTable] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel (contract as :func:`mamba2_prefill_plain`, with
    the activations' ActiBA tables in place of callables, ``None`` =
    exact).  The small parameters (conv_w, conv_b, dt_bias, A, D,
    norm_scale) must be contiguous fp32.  ``out`` = (new_conv, new_ssm)
    buffers to write the new state into instead of fresh ones."""
    dev = z.device
    common.require(dev.type == "cuda", "mamba2_prefill takes CUDA tensors; "
                   "the CPU path is mamba2_prefill_plain")
    b, l, di = z.shape
    g, p = ngroups, head_dim
    h = dt.shape[-1]
    n = ssm_state.shape[-1]
    width = conv_w.shape[0]
    dxbc = di + 2 * g * n
    common.check_f32("mamba2_prefill", conv_w=conv_w, conv_b=conv_b,
                     dt_bias=dt_bias, A=A, D=D)
    common.check_cuda(dev, xbc=xbc, dt=dt, conv_state=conv_state,
                      ssm_state=ssm_state, conv_w=conv_w, conv_b=conv_b,
                      dt_bias=dt_bias, A=A, D=D, norm_scale=norm_scale)
    for name, t in (("xbc", xbc), ("dt", dt), ("conv_state", conv_state)):
        common.require(t.dtype == z.dtype,
                       f"mamba2_prefill: {name} is {t.dtype}, z is {z.dtype}")
    common.require(di == h * p and h % g == 0,
                   f"mamba2_prefill: di {di} != h {h} x p {p} or h % g")
    common.require(chunk > 0 and l % chunk == 0,
                   f"mamba2_prefill: seqlen {l} not a multiple of {chunk}")
    common.require(p <= 64 and p * n <= 8192,
                   f"mamba2_prefill: head_dim {p} > 64 or p*n {p * n} > 8192")
    common.require(xbc.shape == (b, l, dxbc) and dt.shape == (b, l, h),
                   "mamba2_prefill: xbc must be (b, l, di+2gn), dt (b, l, h)")
    common.require(tuple(conv_state.shape) == (b, width - 1, dxbc)
                   and conv_state.is_contiguous(),
                   "mamba2_prefill: conv_state must be contiguous "
                   "(b, w-1, dxbc)")
    common.require(tuple(ssm_state.shape) == (b, h, p, n)
                   and ssm_state.dtype == torch.float32
                   and ssm_state.is_contiguous(),
                   "mamba2_prefill: ssm_state must be contiguous fp32 "
                   "(b, h, p, n)")
    common.require(conv_w.shape == (width, dxbc) and conv_b.shape == (dxbc,)
                   and dt_bias.shape == A.shape == D.shape == (h,),
                   "mamba2_prefill: parameter shapes")
    act = torch.empty((b, l, dxbc), dtype=z.dtype, device=dev)
    ypre = torch.empty((b, l, di), dtype=torch.float32, device=dev)
    new_conv, new_ssm = common.outputs(out, conv_state, ssm_state,
                                       "mamba2_prefill")
    fn = common.launcher(*_LAUNCH)
    err = fn(common.stream_code(z), common.ptr(xbc),
             common.row_stride(xbc, "xbc"), common.ptr(dt),
             common.row_stride(dt, "dt"), common.ptr(conv_state),
             common.ptr(ssm_state), common.ptr(conv_w), common.ptr(conv_b),
             common.ptr(dt_bias), common.ptr(A), common.ptr(D),
             common.ptr(act), common.ptr(ypre), common.ptr(new_conv),
             common.ptr(new_ssm), b, l, chunk, h, p, g, n, width,
             *table_args(silu_table, dev), *table_args(softplus_table, dev),
             common.stream(dev))
    common.check_launch(err, "prefill_chunk", "mamba2_prefill kernel")
    out = gated_norm_cuda(ypre, z, norm_scale, round_stream=True, eps=eps,
                          silu_table=silu_table)
    mamba2_prefill.launches += 1
    return out, new_conv, new_ssm


mamba2_prefill.launches = 0
