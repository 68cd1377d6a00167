"""Fused Mamba-2 multi-token prefill: the CUDA kernel and its plain version.

Port of ``repro.kernels.prefill_chunk``:

* :func:`project_in` — the in-projection that produces the z / xbc / dt
  streams (a plain matmul, as XLA ran it in the JAX package, or under W8
  the ``qmatmul`` kernel);
* :func:`mamba2_prefill` — the wrapper around ``csrc/prefill_chunk.cu``
  (causal conv + SiLU over the sequence, then one of two bodies that
  :func:`path` names from shapes and alignment alone: the tensor-core body
  ``wgmma``, the SSD split of kernel 7 extended by the carried state on
  ``csrc/ssd_tc.cuh``'s tiles, or the SIMT body, one block per (batch,
  head) walking the chunks in order with the state in shared memory)
  followed by ``csrc/gated_norm.cu`` over the ``b*l`` rows.  Its
  arguments go packed into one buffer (``PREFILL_FIELDS``) through a
  cached launcher.  CUDA (or meta) tensors only; calls are counted in
  ``mamba2_prefill.launches`` and, by body, in
  ``mamba2_prefill.path_launches``.  Replaces the TPU kernel
  ``mamba2_prefill_pallas``;
* :func:`mamba2_prefill_plain` — a port of ``mamba2_prefill_xla``: the
  same prefix sums per chunk (a running sum in the kernels' order where
  the JAX package takes CumBA's triangular product), the same carried
  state, and the same stream-dtype rounding points
  (``prefill_chunk.py:176-186`` and ``:278-283``).

* :class:`Mamba2Prefill` — the ``torch.autograd.Function`` the training
  forward reaches on the card (``kernels/ops.py``): its forward is
  :func:`mamba2_prefill` unchanged (counted), its backward the autograd of
  :func:`mamba2_prefill_plain` recomputed from the saved inputs.

ActiBA: the plain version takes SiLU and softplus as callables (as the
TPU kernel does, ``prefill_chunk.py:178,182,283``), the kernel takes
their PWL tables (``None`` = exact).

Shapes: z (b, l, di); xbc (b, l, dxbc); dt (b, l, h) RAW (pre-softplus);
conv_state (b, w-1, dxbc); ssm_state (b, h, p, n).  Returns (y (b, l, di)
in the stream dtype, new_conv (b, w-1, dxbc), new_ssm fp32).  ``l`` must
be a multiple of ``chunk``.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.pwl import PWLTable, eval_pwl
from repro_torch.kernels import common, cost
from repro_torch.kernels.actiba import table_args
from repro_torch.kernels.gated_norm import gated_norm_cuda, gated_norm_plain
from repro_torch.nn import layers

# The launcher takes one pointer to its arguments packed as 64-bit fields
# in this order (csrc/prefill_chunk.cu: PrefillArgs).
PREFILL_FIELDS = ("dtype", "body", "xbc", "xbc_rs", "dt", "dt_rs",
                  "conv_state", "state_in", "conv_w", "conv_b", "dt_bias",
                  "A", "D", "act", "y", "new_conv", "state_out", "cs", "dtv",
                  "chunk_states", "b", "l", "chunk", "h", "p", "g", "n",
                  "width", "hs", "silu_tab", "silu_nk", "sp_tab", "sp_nk",
                  "stream")
_PREFILL_ARGS = struct.Struct("<" + "q" * len(PREFILL_FIELDS))
_LAUNCH = common.Launcher("prefill_chunk", "mamba2_prefill_launch",
                          [ctypes.c_char_p])
BODIES = ("simt", "wgmma")     # the launcher's body codes 0 and 1
WGMMA_P = 64            # csrc/prefill_chunk.cu: the head_dim the wgmma body takes
WGMMA_N = (64, 128)     # the d_state values it takes
TILE = 64               # query and key rows of a tile
MAX_CHUNK = 256         # its longest chunk (shared memory)
SMS = 132               # H100 SXM streaming multiprocessors
WAVE = 2 * SMS          # blocks in flight: two an SM (bf16, chunks <= 128)
_F32 = torch.float32


@functools.lru_cache(maxsize=None)
def heads_per_set(b: int, c: int, L: int, h: int, g: int) -> int:
    """Heads a y block of the ``wgmma`` body takes: the smallest divisor of
    the heads per group whose launch fits one wave of ``WAVE`` blocks: the
    y blocks, b c (L / 64) (h / hs), beside the b h state blocks that share
    a single chunk's launch (several chunks launch them apart).  Else all
    of a group's heads.  A y block computes its group's score tiles once
    for its set, so a smaller set recomputes them more often for more
    blocks in flight.  A function of the shapes alone: a shape always takes
    the same sums in the same order."""
    hpg = h // g
    tiles = b * c * (L // TILE)
    beside = b * h if c == 1 else 0
    for hs in range(1, hpg + 1):
        if hpg % hs == 0 and tiles * (h // hs) + beside <= WAVE:
            return hs
    return hpg


def path(xbc: torch.Tensor, ssm_state: torch.Tensor, *, chunk: int,
         head_dim: int) -> str:
    """The body a call takes, from shapes and alignment alone: ``"wgmma"``
    for head_dim 64, d_state 64 or 128, a chunk that is a multiple of 64
    up to ``MAX_CHUNK`` and divides l, fp32 or bf16 streams whose rows
    (dxbc values) TMA can step by (16-byte multiples; x, B and C then start
    at 16-byte multiples too, at these widths) and a 16-byte aligned
    incoming state (TMA reads it); else ``"simt"``."""
    n, l = ssm_state.shape[-1], xbc.shape[1]
    if head_dim != WGMMA_P or n not in WGMMA_N or chunk % TILE or not \
            TILE <= chunk <= MAX_CHUNK or l % chunk or \
            xbc.dtype not in common.STREAM_DTYPES or \
            xbc.shape[-1] * xbc.element_size() % 16 or \
            ssm_state.data_ptr() % 16:
        return "simt"
    return "wgmma"


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
    # The inclusive prefix sums (CumBA's triangular product in the JAX
    # package) in the kernels' order: on the card one running fp32 sum per
    # (batch, head), as both kernel bodies take it (PyTorch scans a dim
    # that is not the innermost one thread a column, in order); a product
    # summed in cuBLAS's order moves cs ~ -190 by a few ulps, and a bf16
    # output element by a step where y and the D skip cancel.
    cs = torch.cumsum(a, dim=1)                               # (b, L, h)
    seg = cs[:, :, None, :] - cs[:, None, :, :]               # (b, L, S, h)
    trilb = torch.ones(L, L, dtype=torch.bool,
                       device=xdt.device).tril()[None, :, :, None]
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


def _prefill_refusal(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                     dt_bias, A, D, norm_scale, g, p, chunk) -> None:
    """Raise with the reason :func:`mamba2_prefill` refuses its inputs
    (run only once its one combined check failed)."""
    dev = z.device
    b, l, di = z.shape
    h, n, width = dt.shape[-1], ssm_state.shape[-1], conv_w.shape[0]
    dxbc = di + 2 * g * n
    common.stream_code(z)
    common.check_f32("mamba2_prefill", conv_w=conv_w, conv_b=conv_b,
                     dt_bias=dt_bias, A=A, D=D, norm_scale=norm_scale)
    common.check_cuda(dev, xbc=xbc, dt=dt, conv_state=conv_state,
                      ssm_state=ssm_state, conv_w=conv_w, conv_b=conv_b,
                      dt_bias=dt_bias, A=A, D=D, norm_scale=norm_scale)
    for name, t in (("xbc", xbc), ("dt", dt), ("conv_state", conv_state)):
        common.require(t.dtype == z.dtype,
                       f"mamba2_prefill: {name} is {t.dtype}, z is {z.dtype}")
    common.require(g > 0 and di == h * p and h % g == 0,
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
                   and ssm_state.dtype == _F32 and ssm_state.is_contiguous(),
                   "mamba2_prefill: ssm_state must be contiguous fp32 "
                   "(b, h, p, n)")
    common.require(conv_w.shape == (width, dxbc) and conv_b.shape == (dxbc,)
                   and dt_bias.shape == A.shape == D.shape == (h,)
                   and norm_scale.shape == (di,),
                   "mamba2_prefill: parameter shapes")
    raise ValueError("mamba2_prefill: inputs refused")


def mamba2_prefill(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                   dt_bias, A, D, norm_scale, *, ngroups: int, head_dim: int,
                   chunk: int, eps: float = 1e-6, out=None,
                   silu_table: Optional[PWLTable] = None,
                   softplus_table: Optional[PWLTable] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel (contract as :func:`mamba2_prefill_plain`, with
    the activations' ActiBA tables in place of callables, ``None`` =
    exact) on the body :func:`path` names.  The small parameters (conv_w,
    conv_b, dt_bias, A, D, norm_scale) must be contiguous fp32; z, xbc and
    dt may be views of one projection.  ``out`` = (new_conv, new_ssm)
    buffers to write the new state into instead of fresh ones.  The
    inputs are checked at once and a message is formatted only when that
    check fails."""
    if not (z.is_cuda or z.is_meta):
        raise ValueError("mamba2_prefill takes CUDA tensors; the CPU path "
                         "is mamba2_prefill_plain")
    b, l, di = z.shape
    g, p = ngroups, head_dim
    h, n, width = dt.shape[-1], ssm_state.shape[-1], conv_w.shape[0]
    dxbc = di + 2 * g * n
    sd = z.dtype
    code = common.STREAM_DTYPES.get(sd)
    idx = z.get_device()
    if (code is None or xbc.dtype != sd or dt.dtype != sd
            or conv_state.dtype != sd or ssm_state.dtype != _F32
            or g <= 0 or di != h * p or h % g or chunk <= 0 or l % chunk
            or p > 64 or p * n > 8192
            or xbc.shape != (b, l, dxbc) or dt.shape != (b, l, h)
            or conv_state.shape != (b, width - 1, dxbc)
            or ssm_state.shape != (b, h, p, n)
            or conv_w.shape != (width, dxbc) or conv_b.shape != (dxbc,)
            or dt_bias.shape != (h,) or A.shape != (h,) or D.shape != (h,)
            or norm_scale.shape != (di,)
            or not (conv_state.is_contiguous() and ssm_state.is_contiguous())
            or any(t.dtype != _F32 or not t.is_contiguous()
                   for t in (conv_w, conv_b, dt_bias, A, D, norm_scale))
            or any(t.get_device() != idx
                   for t in (xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                             dt_bias, A, D, norm_scale))):
        _prefill_refusal(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                         dt_bias, A, D, norm_scale, g, p, chunk)
    dev = z.device
    body = path(xbc, ssm_state, chunk=chunk, head_dim=p)
    c = l // chunk
    act = torch.empty((b, l, dxbc), dtype=sd, device=dev)
    y = torch.empty((b, l, di), dtype=sd, device=dev)
    if out is None:
        new_conv = torch.empty_like(conv_state)
        new_ssm = torch.empty_like(ssm_state)
    else:
        new_conv, new_ssm = common.outputs(out, conv_state, ssm_state,
                                           "mamba2_prefill")
    cs_p = dtv_p = states_p = 0
    hs = 0
    if body == "wgmma":
        scan = torch.empty((2, b, h, l), dtype=_F32, device=dev)
        cs_p, dtv_p = scan[0].data_ptr(), scan[1].data_ptr()
        if c > 1:
            states = torch.empty((b, c, h, p, n), dtype=_F32, device=dev)
            states_p = states.data_ptr()
        hs = heads_per_set(b, c, chunk, h, g)
    if idx < 0:
        out = gated_norm_cuda(y, z, norm_scale, eps=eps)
        cost.record("mamba2_prefill", cost.prefill_tc_ops(
            b, l, chunk, h, p, n, g), cost._bytes(
            z, xbc, dt, conv_state, ssm_state, conv_w, conv_b, dt_bias, A, D,
            norm_scale, out, new_conv, new_ssm), cost.BF16_TC_FLOP_PER_S)
        return out, new_conv, new_ssm
    silu_p, silu_nk = table_args(silu_table, dev)
    sp_p, sp_nk = table_args(softplus_table, dev)
    err = _LAUNCH(_PREFILL_ARGS.pack(
        code, BODIES.index(body), xbc.data_ptr(),
        common.row_stride(xbc, "xbc"), dt.data_ptr(),
        common.row_stride(dt, "dt"), conv_state.data_ptr(),
        ssm_state.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
        dt_bias.data_ptr(), A.data_ptr(), D.data_ptr(), act.data_ptr(),
        y.data_ptr(), new_conv.data_ptr(), new_ssm.data_ptr(), cs_p, dtv_p,
        states_p, b, l, chunk, h, p, g, n, width, hs, silu_p, silu_nk, sp_p,
        sp_nk, common.stream(dev)))
    if err:
        common.check_launch(err, "prefill_chunk",
                            f"mamba2_prefill {body} kernel")
    out = gated_norm_cuda(y, z, norm_scale, eps=eps, silu_table=silu_table)
    mamba2_prefill.launches += 1
    mamba2_prefill.path_launches[body] += 1
    return out, new_conv, new_ssm


mamba2_prefill.launches = 0
# The same calls by the body they took (tensor-core, SIMT).
mamba2_prefill.path_launches = {"wgmma": 0, "simt": 0}


def _act(table: Optional[PWLTable], exact: Callable) -> Callable:
    """The plain activation of a kernel's table: ``eval_pwl`` on the same
    table, or the exact function for ``None``."""
    if table is None:
        return exact
    return lambda x: eval_pwl(table, x)


class Mamba2Prefill(torch.autograd.Function):
    """Kernel 2 under autograd: ``apply(spec, z, xbc, dt, conv_state,
    ssm_state, conv_w, conv_b, dt_bias, A, D, norm_scale)`` with ``spec``
    the keyword arguments of :func:`mamba2_prefill` (``ngroups``,
    ``head_dim``, ``chunk`` and the ActiBA tables; no ``out``).

    The forward is the hand-written kernel, unchanged, and counts its
    launch.  The backward recomputes the plain version,
    :func:`mamba2_prefill_plain` (the port of ``mamba2_prefill_xla``, the
    function the JAX package differentiates) with the same activations
    (exact, or ``eval_pwl`` on the kernel's tables), from the saved inputs
    and returns ``torch.autograd.grad`` of it for all 11 tensor inputs:
    what JAX's ``flash_attention`` ``_bwd`` does with ``attention_ref``.
    This backward is the one place where a plain version runs on the
    card outside a comparison; no backward kernel exists (in JAX either,
    where ``jax.grad`` of the Pallas prefill fails)."""

    @staticmethod
    def forward(ctx, spec, *ins):
        ctx.spec = spec
        ctx.save_for_backward(*ins)
        ctx.set_materialize_grads(False)
        return mamba2_prefill(*ins, **spec)

    @staticmethod
    def backward(ctx, *grads):
        spec = dict(ctx.spec)
        spec["silu"] = _act(spec.pop("silu_table", None), F.silu)
        spec["softplus"] = _act(spec.pop("softplus_table", None), F.softplus)
        return (None,) + common.plain_vjp(
            functools.partial(mamba2_prefill_plain, **spec),
            ctx.saved_tensors, ctx.needs_input_grad[1:], grads)
