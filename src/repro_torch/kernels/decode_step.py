"""Single-token steps: the CUDA kernels and their plain versions.

Ports of the TPU kernels of ``repro.kernels.decode_step`` and their
oracles in ``repro.kernels.ref``:

* :func:`mamba2_step` (TPU kernel 1), :func:`mamba1_step` (kernel 5) and
  :func:`rglru_step` (kernel 6, recurrentgemma's RG-LRU): the fused mixer
  steps, below;
* :func:`ssd_step` (kernel 3) and :func:`sscan_step` (kernel 4): the bare
  SSD and selective-scan updates (``csrc/decode_step.cu`` and
  ``csrc/mamba1_step.cu``), reached through ``core/ssd.py:
  ssd_decode_step`` and ``core/selective_scan.py:
  selective_scan_decode_step`` in ``pallas`` modes.

Each wrapper takes CUDA tensors only and counts its calls in
``.launches``; each ``*_plain`` version is the same function in plain
PyTorch with an fp32 interior, the CPU path and what the kernel is held
to on the card.

The Mamba-2 step (``mamba2_step`` / ``mamba2_step_ref``):

* :func:`mamba2_step` — the wrapper around ``csrc/decode_step.cu``: one
  launch (conv shift + SiLU + softplus(dt) + SSD update + D skip + the
  gated RMSNorm over whole rows), grid (p / :func:`step_rows`, head,
  batch), its arguments packed into one buffer (``STEP_FIELDS``) through
  a cached launcher.  It takes CUDA tensors only and counts its calls in
  ``mamba2_step.launches``.
* :func:`mamba2_step_plain` — the same function in plain PyTorch, fp32
  throughout; the CPU path, and what the kernel is held to on the card.

ActiBA: the plain version takes SiLU and softplus as callables (as the
TPU kernel does, ``decode_step.py:159-160``), the kernel takes their PWL
tables (``None`` = exact) and evaluates them in its body.

Shapes (the JAX package's): z (b, di), xbc (b, dxbc), dt (b, h) — the
``in_proj`` splits, in the stream dtype; conv_state (b, w-1, dxbc) in the
stream dtype; ssm_state (b, h, p, n) fp32; conv_w (w, dxbc); conv_b
(dxbc,); dt_bias / A / D (h,); norm_scale (di,).  ``A`` is the negative
decay rate ``-exp(A_log)``.  Returns (y (b, di) gated, pre-``out_proj``;
new_conv; new_ssm).

The Mamba-1 step (``mamba1_step`` / ``mamba1_step_ref``): xs_raw, z
(b, di) — the ``in_proj`` halves; conv_state (b, w-1, di); ssm_state
(b, di, n) fp32; xproj_w (di, r+2n); dtproj_w (r, di); dtproj_b (di,); A
(di, n) negative; D (di,).  Returns (y (b, di) = (s'.C + D u) silu(z),
formed in fp32 and cast once to z's dtype; new_conv in conv_state's
dtype; new_ssm fp32).

The RG-LRU step (``rglru_step`` / ``rglru_step_ref``): u, gate (b, w) —
the ``in_x`` / ``in_gate`` projections; conv_state (b, wc-1, w) in u's
dtype; h_state (b, w) fp32; conv_w (wc, w), conv_b (w,); rg_w, ig_w (w, w)
with (w,) biases; lam (w,).  Returns (y (b, w) = h' gelu(gate), formed in
fp32 and cast once to u's dtype, pre-``out``; new_conv; new_h fp32).  The
conv has no SiLU; gelu is the tanh form.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import common
from repro_torch.kernels.actiba import table_args
from repro_torch.kernels.gated_norm import gated_norm_plain
from repro_torch.kernels.qmatmul import GEMV_M, SMS
from repro_torch.nn import layers

# The launcher takes one pointer to its arguments packed as 64-bit fields
# in this order (csrc/decode_step.cu: StepArgs; eps a double, the rest
# integers and pointers).
STEP_FIELDS = ("dtype", "xbc", "xbc_rs", "dt", "dt_rs", "z", "z_rs",
               "conv_state", "ssm_state", "conv_w", "conv_b", "dt_bias",
               "A", "D", "norm_scale", "out", "new_conv", "new_ssm", "ypre",
               "counts", "b", "h", "p", "g", "n", "width", "rows", "vec",
               "eps", "silu_tab", "silu_nk", "sp_tab", "sp_nk", "stream")
_STEP_ARGS = struct.Struct("<" + "".join("d" if f == "eps" else "q"
                                         for f in STEP_FIELDS))
_STEP = common.Launcher("decode_step", "mamba2_step_launch",
                        [ctypes.c_char_p])
MAX_ROWS = 16           # csrc/decode_step.cu: state rows a block (8 warps)
_F32 = torch.float32


@functools.lru_cache(maxsize=None)
def step_rows(p: int) -> int:
    """State rows a block of the step kernel takes (8 warps, a warp rows w
    and w + 8): the largest divisor of ``p`` up to ``MAX_ROWS``.  At p = 64
    that is 16, so b = 4 runs 384 blocks of 256 threads in one wave, the
    whole state in flight."""
    return max(r for r in range(1, min(p, MAX_ROWS) + 1) if p % r == 0)


# The fused norm's scratch per device: (row counters, int32, zero between
# calls; per batch row its pre-norm y and its blocks' sums of squares,
# fp32), grown to the largest call so far.  Calls on one stream share it
# in turn.
_SCRATCH: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def _step_scratch(dev: int, b: int, row: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    got = _SCRATCH.get(dev)
    if got is None or got[0].numel() < b or got[1].numel() < b * row:
        nb = max(b, got[0].numel() if got else 0)
        ny = max(b * row, got[1].numel() if got else 0)
        got = _SCRATCH[dev] = (
            torch.zeros(nb, dtype=torch.int32, device=dev),
            torch.empty(ny, dtype=_F32, device=dev))
    return got


# The parameter tensors of each weight set a call has seen (conv_w, conv_b,
# dt_bias, A, D, norm_scale: the model's decode_view hands the same ones
# every step), checked once and kept with their pointers; a call re-reads
# only the pointers, so a tensor given new storage is checked again.
_PARAMS: Dict[Tuple[int, ...], Tuple[tuple, Tuple[int, ...]]] = {}
_MAX_PARAMS = 1024


def mamba2_step_plain(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                      dt_bias, A, D, norm_scale, *, ngroups: int,
                      head_dim: int, eps: float = 1e-6,
                      silu: Callable = F.silu, softplus: Callable = F.softplus):
    """Plain PyTorch port of ``mamba2_step_ref`` (fp32 interior)."""
    b, di = z.shape
    g, p = ngroups, head_dim
    n = ssm_state.shape[-1]
    h = dt.shape[1]
    conv_out, new_conv = layers.causal_conv1d_step(
        {"w": conv_w, "b": conv_b}, xbc.float(), conv_state.float())
    act = silu(conv_out)
    xs = act[:, :di].reshape(b, h, p)
    B = act[:, di:di + g * n].reshape(b, g, n).repeat_interleave(h // g, 1)
    C = act[:, di + g * n:].reshape(b, g, n).repeat_interleave(h // g, 1)
    dt_f = softplus(dt.float() + dt_bias.float()[None])
    decay = torch.exp(dt_f * A.float()[None])
    new = ssm_state.float() * decay[..., None, None] + \
        dt_f[..., None, None] * B[:, :, None, :] * xs[..., None]
    y = torch.einsum("bhpn,bhn->bhp", new, C) + D.float()[None, :, None] * xs
    out = gated_norm_plain(y.reshape(b, di), z, norm_scale,
                           round_stream=False, eps=eps, silu=silu)
    return out, new_conv.to(conv_state.dtype), new


def _step_refusal(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                  dt_bias, A, D, norm_scale, g, p) -> None:
    """Raise with the reason :func:`mamba2_step` refuses its inputs (run
    only once its one combined check failed)."""
    dev = z.device
    b, di = z.shape
    h, n, width = dt.shape[-1], ssm_state.shape[-1], conv_w.shape[0]
    dxbc = di + 2 * g * n
    common.stream_code(z)
    common.check_f32("mamba2_step", conv_w=conv_w, conv_b=conv_b,
                     dt_bias=dt_bias, A=A, D=D, norm_scale=norm_scale)
    common.check_cuda(dev, xbc=xbc, dt=dt, conv_state=conv_state,
                      ssm_state=ssm_state, conv_w=conv_w, conv_b=conv_b,
                      dt_bias=dt_bias, A=A, D=D, norm_scale=norm_scale)
    for name, t in (("xbc", xbc), ("dt", dt), ("conv_state", conv_state)):
        common.require(t.dtype == z.dtype,
                       f"mamba2_step: {name} is {t.dtype}, z is {z.dtype}")
    common.require(g > 0 and di == h * p and h % g == 0,
                   f"mamba2_step: di {di} != h {h} x p {p} or h % g")
    common.require(xbc.shape == (b, dxbc) and dt.shape == (b, h),
                   "mamba2_step: xbc must be (b, di+2gn), dt (b, h)")
    for name, t in (("z", z), ("xbc", xbc), ("dt", dt)):
        common.require(t.stride(-1) == 1, f"mamba2_step: {name}'s rows "
                       f"must be contiguous, strides {t.stride()}")
    common.require(tuple(conv_state.shape) == (b, width - 1, dxbc)
                   and conv_state.is_contiguous(),
                   "mamba2_step: conv_state must be contiguous (b, w-1, dxbc)")
    common.require(tuple(ssm_state.shape) == (b, h, p, n)
                   and ssm_state.dtype == _F32 and ssm_state.is_contiguous(),
                   "mamba2_step: ssm_state must be contiguous fp32 (b,h,p,n)")
    common.require(conv_w.shape == (width, dxbc) and conv_b.shape == (dxbc,)
                   and dt_bias.shape == A.shape == D.shape == (h,)
                   and norm_scale.shape == (di,),
                   "mamba2_step: parameter shapes")
    raise ValueError("mamba2_step: inputs refused")


def _params(conv_w, conv_b, dt_bias, A, D, norm_scale, idx, h, di, dxbc,
            width) -> Optional[Tuple[int, ...]]:
    """The six parameters' pointers when they are contiguous fp32 of the
    call's shapes on device ``idx`` (checked once per weight set), else
    ``None``."""
    ts = (conv_w, conv_b, dt_bias, A, D, norm_scale)
    key = tuple(map(id, ts))
    got = _PARAMS.get(key)
    ptrs = tuple(t.data_ptr() for t in ts)
    if got is not None and got[1] == ptrs and got[2] == (idx, h, di, dxbc,
                                                         width):
        return ptrs
    if (conv_w.shape != (width, dxbc) or conv_b.shape != (dxbc,)
            or dt_bias.shape != (h,) or A.shape != (h,) or D.shape != (h,)
            or norm_scale.shape != (di,)
            or any(t.dtype != _F32 or not t.is_contiguous()
                   or t.get_device() != idx for t in ts)):
        return None
    if len(_PARAMS) >= _MAX_PARAMS:
        _PARAMS.clear()
    _PARAMS[key] = (ts, ptrs, (idx, h, di, dxbc, width))
    return ptrs


def mamba2_step(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b, dt_bias,
                A, D, norm_scale, *, ngroups: int, head_dim: int,
                eps: float = 1e-6, out=None,
                silu_table: Optional[PWLTable] = None,
                softplus_table: Optional[PWLTable] = None):
    """The CUDA kernel (contract as :func:`mamba2_step_plain`, with the
    activations' ActiBA tables in place of callables, ``None`` = exact):
    one launch, the gated norm fused.  The small parameters (conv_w,
    conv_b, dt_bias, A, D, norm_scale) must be contiguous fp32; z, xbc and
    dt may be row views of one projection.  ``out`` = (new_conv, new_ssm)
    buffers to write the new state into instead of fresh ones.  The
    inputs are checked at once (the parameters once per weight set) and a
    message is formatted only when a check fails: the decode step calls
    this once a layer."""
    if not z.is_cuda:
        raise ValueError("mamba2_step takes CUDA tensors; the CPU path is "
                         "mamba2_step_plain")
    b, di = z.shape
    g, p = ngroups, head_dim
    h, n, width = dt.shape[-1], ssm_state.shape[-1], conv_w.shape[0]
    dxbc = di + 2 * g * n
    sd = z.dtype
    code = common.STREAM_DTYPES.get(sd)
    idx = z.get_device()
    params = None
    if (code is not None and xbc.dtype == sd and dt.dtype == sd
            and conv_state.dtype == sd and ssm_state.dtype == _F32
            and g > 0 and di == h * p and h % g == 0
            and xbc.shape == (b, dxbc) and dt.shape == (b, h)
            and conv_state.shape == (b, width - 1, dxbc)
            and ssm_state.shape == (b, h, p, n)
            and z.stride(-1) == 1 and xbc.stride(-1) == 1
            and dt.stride(-1) == 1 and conv_state.is_contiguous()
            and ssm_state.is_contiguous() and xbc.get_device() == idx
            and dt.get_device() == idx and conv_state.get_device() == idx
            and ssm_state.get_device() == idx):
        params = _params(conv_w, conv_b, dt_bias, A, D, norm_scale, idx, h,
                         di, dxbc, width)
    if params is None:
        _step_refusal(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                      dt_bias, A, D, norm_scale, g, p)
    if out is None:
        new_conv = torch.empty_like(conv_state)
        new_ssm = torch.empty_like(ssm_state)
    else:
        new_conv, new_ssm = out
        if not (new_conv.shape == conv_state.shape
                and new_ssm.shape == ssm_state.shape
                and new_conv.dtype == sd and new_ssm.dtype == _F32
                and new_conv.is_contiguous() and new_ssm.is_contiguous()
                and new_conv.get_device() == idx
                and new_ssm.get_device() == idx
                and new_conv.data_ptr() != conv_state.data_ptr()
                and new_ssm.data_ptr() != ssm_state.data_ptr()):
            common.outputs(out, conv_state, ssm_state, "mamba2_step")
    y = torch.empty((b, di), dtype=sd, device=idx)
    rows = step_rows(p)
    counts, ypre = _step_scratch(idx, b, di + di // rows)
    sp, snp = ssm_state.data_ptr(), new_ssm.data_ptr()
    silu_p, silu_nk = table_args(silu_table, z.device)
    sp_p, sp_nk = table_args(softplus_table, z.device)
    err = _STEP(_STEP_ARGS.pack(
        code, xbc.data_ptr(), xbc.stride(0), dt.data_ptr(), dt.stride(0),
        z.data_ptr(), z.stride(0), conv_state.data_ptr(), sp, *params,
        y.data_ptr(), new_conv.data_ptr(), snp, ypre.data_ptr(),
        counts.data_ptr(), b, h, p, g, n, width, rows,
        n % 4 == 0 and (sp | snp) % 16 == 0, eps, silu_p, silu_nk, sp_p,
        sp_nk, torch._C._cuda_getCurrentRawStream(idx)))
    if err:
        common.check_launch(err, "decode_step", "mamba2_step kernel")
    mamba2_step.launches += 1
    return y, new_conv, new_ssm


mamba2_step.launches = 0


# ---------------------------------------------------------------------------
# Bare updates: kernels 3 and 4
# ---------------------------------------------------------------------------
_SSD_LAUNCH = ("decode_step", "ssd_step_launch",
               [common.I] + [common.P] * 8 + [common.I] * 5 + [common.P])
_SSCAN_LAUNCH = ("mamba1_step", "sscan_step_launch",
                 [common.I] + [common.P] * 9 + [common.I] * 3 + [common.P])


def ssd_step_plain(state, x_t, dt_t, A, B_t, C_t):
    """Plain PyTorch port of ``ssd_step_ref``: state (b, h, p, n); x_t
    (b, h, p); dt_t (b, h) (no softplus); A (h,); B_t, C_t (b, g, n).
    Returns (new_state fp32, y (b, h, p) in x_t's dtype)."""
    hpg = state.shape[1] // B_t.shape[1]
    Bh = B_t.float().repeat_interleave(hpg, dim=1)
    Ch = C_t.float().repeat_interleave(hpg, dim=1)
    dtf = dt_t.float()
    decay = torch.exp(dtf * A.float()[None, :])
    dBx = dtf[..., None, None] * Bh[:, :, None, :] * x_t.float()[..., None]
    new = state.float() * decay[..., None, None] + dBx
    y = torch.einsum("bhpn,bhn->bhp", new, Ch)
    return new, y.to(x_t.dtype)


def _f32(t):
    return t.float().contiguous()


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """The CUDA kernel (contract as :func:`ssd_step_plain`); grid (batch,
    head), the mamba2 step's head update.  dt, A, B and C are read as
    fp32 (cast here if they are not)."""
    dev = state.device
    common.require(dev.type == "cuda", "ssd_step takes CUDA tensors; the "
                   "CPU path is ssd_step_plain")
    b, h, p, n = state.shape
    g = B_t.shape[1]
    common.check_cuda(dev, x_t=x_t, dt_t=dt_t, A=A, B_t=B_t, C_t=C_t)
    common.require(state.dtype == torch.float32 and state.is_contiguous(),
                   "ssd_step: state must be contiguous fp32 (b, h, p, n)")
    common.require(tuple(x_t.shape) == (b, h, p)
                   and tuple(dt_t.shape) == (b, h) and tuple(A.shape) == (h,)
                   and tuple(B_t.shape) == tuple(C_t.shape) == (b, g, n)
                   and h % g == 0, "ssd_step: shapes")
    x_t = x_t.contiguous()
    new = torch.empty_like(state)
    y = torch.empty_like(x_t)
    dt_t, A, B_t, C_t = (_f32(t) for t in (dt_t, A, B_t, C_t))
    err = common.launcher(*_SSD_LAUNCH)(
        common.stream_code(x_t), common.ptr(state), common.ptr(x_t),
        common.ptr(dt_t), common.ptr(A), common.ptr(B_t), common.ptr(C_t),
        common.ptr(new), common.ptr(y), b, h, p, g, n, common.stream(dev))
    common.check_launch(err, "decode_step", "ssd_step kernel")
    ssd_step.launches += 1
    return new, y


ssd_step.launches = 0


def sscan_step_plain(state, u_t, delta_t, A, B_t, C_t, D=None):
    """Plain PyTorch port of ``sscan_step_ref``: state (b, d, n); u_t,
    delta_t (b, d); A (d, n); B_t, C_t (b, n); D (d,) or ``None``.
    Returns (new_state fp32, y (b, d) in u_t's dtype)."""
    dtf = delta_t.float()
    decay = torch.exp(dtf[..., None] * A.float()[None])
    dBu = (dtf * u_t.float())[..., None] * B_t.float()[:, None, :]
    new = state.float() * decay + dBu
    y = torch.einsum("bdn,bn->bd", new, C_t.float())
    if D is not None:
        y = y + u_t.float() * D.float()[None]
    return new, y.to(u_t.dtype)


def sscan_step(state, u_t, delta_t, A, B_t, C_t, D=None):
    """The CUDA kernel (contract as :func:`sscan_step_plain`); one thread
    per (row, channel).  delta, A, B, C and D are read as fp32 (cast here
    if they are not); ``D=None`` is passed as a null pointer, no skip."""
    dev = state.device
    common.require(dev.type == "cuda", "sscan_step takes CUDA tensors; the "
                   "CPU path is sscan_step_plain")
    b, d, n = state.shape
    common.check_cuda(dev, u_t=u_t, delta_t=delta_t, A=A, B_t=B_t, C_t=C_t,
                      **({} if D is None else {"D": D}))
    common.require(state.dtype == torch.float32 and state.is_contiguous(),
                   "sscan_step: state must be contiguous fp32 (b, d, n)")
    common.require(tuple(u_t.shape) == tuple(delta_t.shape) == (b, d)
                   and tuple(A.shape) == (d, n)
                   and tuple(B_t.shape) == tuple(C_t.shape) == (b, n)
                   and (D is None or tuple(D.shape) == (d,)),
                   "sscan_step: shapes")
    u_t = u_t.contiguous()
    new = torch.empty_like(state)
    y = torch.empty_like(u_t)
    delta_t, A, B_t, C_t = (_f32(t) for t in (delta_t, A, B_t, C_t))
    d_ptr = 0 if D is None else common.ptr(_f32(D))
    err = common.launcher(*_SSCAN_LAUNCH)(
        common.stream_code(u_t), common.ptr(state), common.ptr(u_t),
        common.ptr(delta_t), common.ptr(A), common.ptr(B_t),
        common.ptr(C_t), d_ptr, common.ptr(new), common.ptr(y), b, d, n,
        common.stream(dev))
    common.check_launch(err, "mamba1_step", "sscan_step kernel")
    sscan_step.launches += 1
    return new, y


sscan_step.launches = 0


# ---------------------------------------------------------------------------
# The fused Mamba-1 step: kernel 5
# ---------------------------------------------------------------------------
_M1_LAUNCH = ("mamba1_step", "mamba1_step_launch",
              [common.I, common.P, common.I, common.P, common.I]
              + [common.P] * 13 + [common.I] * 5
              + [common.P, common.I, common.P, common.I, common.P])
M1_CONV_CH = 64          # csrc/mamba1_step.cu CONV_CH: channels per block


def mamba1_step_plain(xs_raw, z, conv_state, ssm_state, conv_w, conv_b,
                      xproj_w, dtproj_w, dtproj_b, A, D, *, dt_rank: int,
                      silu: Callable = F.silu,
                      softplus: Callable = F.softplus):
    """Plain PyTorch port of ``mamba1_step_ref`` (fp32 interior)."""
    n = ssm_state.shape[-1]
    r = dt_rank
    conv_out, new_conv = layers.causal_conv1d_step(
        {"w": conv_w, "b": conv_b}, xs_raw.float(), conv_state.float())
    xs = silu(conv_out)
    dbc = torch.matmul(xs, xproj_w.float())
    dt_low, B, C = torch.split(dbc, [r, n, n], dim=-1)
    dt = softplus(torch.matmul(dt_low, dtproj_w.float())
                  + dtproj_b.float()[None])
    new, y = sscan_step_plain(ssm_state, xs, dt, A, B, C, D)
    out = y * silu(z.float())
    return out.to(z.dtype), new_conv.to(conv_state.dtype), new


def mamba1_step(xs_raw, z, conv_state, ssm_state, conv_w, conv_b, xproj_w,
                dtproj_w, dtproj_b, A, D, *, dt_rank: int, out=None,
                silu_table: Optional[PWLTable] = None,
                softplus_table: Optional[PWLTable] = None):
    """The CUDA kernel (contract as :func:`mamba1_step_plain`, with the
    activations' ActiBA tables in place of callables, ``None`` = exact):
    two launches, conv + SiLU + x_proj partial sums over 64-channel
    blocks, then their fixed-order sum, dt_proj, softplus, the update and
    the gate over 128-channel blocks.  The parameters (conv_w, conv_b,
    xproj_w, dtproj_w, dtproj_b, A, D) must be contiguous fp32; xs_raw and
    z may be views of one ``in_proj`` output.  ``out`` = (new_conv,
    new_ssm) buffers to write the new state into instead of fresh ones."""
    dev = z.device
    common.require(dev.type == "cuda", "mamba1_step takes CUDA tensors; "
                   "the CPU path is mamba1_step_plain")
    b, di = z.shape
    n = ssm_state.shape[-1]
    r = dt_rank
    width = conv_w.shape[0]
    common.check_f32("mamba1_step", conv_w=conv_w, conv_b=conv_b,
                     xproj_w=xproj_w, dtproj_w=dtproj_w, dtproj_b=dtproj_b,
                     A=A, D=D)
    common.check_cuda(dev, xs_raw=xs_raw, conv_state=conv_state,
                      ssm_state=ssm_state, conv_w=conv_w, conv_b=conv_b,
                      xproj_w=xproj_w, dtproj_w=dtproj_w, dtproj_b=dtproj_b,
                      A=A, D=D)
    for name, t in (("xs_raw", xs_raw), ("conv_state", conv_state)):
        common.require(t.dtype == z.dtype,
                       f"mamba1_step: {name} is {t.dtype}, z is {z.dtype}")
    common.require(tuple(xs_raw.shape) == (b, di),
                   "mamba1_step: xs_raw must be (b, di) like z")
    common.require(tuple(conv_state.shape) == (b, width - 1, di)
                   and conv_state.is_contiguous(),
                   "mamba1_step: conv_state must be contiguous (b, w-1, di)")
    common.require(tuple(ssm_state.shape) == (b, di, n)
                   and ssm_state.dtype == torch.float32
                   and ssm_state.is_contiguous(),
                   "mamba1_step: ssm_state must be contiguous fp32 (b, di, n)")
    common.require(conv_w.shape == (width, di) and conv_b.shape == (di,)
                   and xproj_w.shape == (di, r + 2 * n)
                   and dtproj_w.shape == (r, di)
                   and dtproj_b.shape == D.shape == (di,)
                   and A.shape == (di, n), "mamba1_step: parameter shapes")
    nblk = -(-di // M1_CONV_CH)
    scratch = torch.empty(b * (di + nblk * (r + 2 * n)), dtype=torch.float32,
                          device=dev)
    y = torch.empty((b, di), dtype=z.dtype, device=dev)
    new_conv, new_ssm = common.outputs(out, conv_state, ssm_state,
                                       "mamba1_step")
    err = common.launcher(*_M1_LAUNCH)(
        common.stream_code(z), common.ptr(xs_raw),
        common.row_stride(xs_raw, "xs_raw"), common.ptr(z),
        common.row_stride(z, "z"), common.ptr(conv_state),
        common.ptr(ssm_state), common.ptr(conv_w), common.ptr(conv_b),
        common.ptr(xproj_w), common.ptr(dtproj_w), common.ptr(dtproj_b),
        common.ptr(A), common.ptr(D), common.ptr(scratch), common.ptr(y),
        common.ptr(new_conv), common.ptr(new_ssm), b, di, n, r, width,
        *table_args(silu_table, dev), *table_args(softplus_table, dev),
        common.stream(dev))
    common.check_launch(err, "mamba1_step", "mamba1_step kernels")
    mamba1_step.launches += 1
    return y, new_conv, new_ssm


mamba1_step.launches = 0


# ---------------------------------------------------------------------------
# The fused RG-LRU step: kernel 6
# ---------------------------------------------------------------------------
_RG_LAUNCH = ("rglru_step", "rglru_step_launch",
              [common.I, common.I] + [common.P] * 15 + [common.I] * 5
              + [common.P, common.I] * 3 + [common.P])
RG_LRU_C = 8.0             # Griffin's fixed gate exponent


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def rglru_step_plain(u, gate, conv_state, h_state, conv_w, conv_b, rg_w,
                     rg_b, ig_w, ig_b, lam, *,
                     sigmoid: Callable = torch.sigmoid,
                     softplus: Callable = F.softplus,
                     gelu: Callable = _gelu_tanh):
    """Plain PyTorch port of ``rglru_step_ref`` (fp32 interior)."""
    u_c, new_conv = layers.causal_conv1d_step(
        {"w": conv_w, "b": conv_b}, u.float(), conv_state.float())
    r = sigmoid(torch.matmul(u_c, rg_w.float()) + rg_b.float()[None])
    i = sigmoid(torch.matmul(u_c, ig_w.float()) + ig_b.float()[None])
    log_a = -RG_LRU_C * softplus(lam.float())[None] * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                          1e-12)) * (i * u_c)
    h_new = a * h_state.float() + gated_in
    out = h_new * gelu(gate.float())
    return out.to(u.dtype), new_conv.to(conv_state.dtype), h_new


GATE_COLS = 128             # csrc/gemm.cuh: GV_COLS, columns a block
GATE_MAX_KS = 1024          # GV_MAX_KS, k rows a split


def gate_splits(m: int, k: int, n: int) -> int:
    """Blocks over k of kernel 6's gate GEMV (``gemm::gemv_sums``, its
    partials summed by its own second launch): about two blocks per SM, as
    long as the fp32 partials (splits x m x n x 8 bytes written and read)
    stay within a quarter of a weight's k x n bytes, and at most
    ``GATE_MAX_KS`` rows of k per block.  A function of the shapes alone,
    so a shape always takes the same sums in the same order."""
    want = math.ceil(2 * SMS / math.ceil(n / GATE_COLS))
    cap = max(1, k // (32 * m))
    splits = max(min(want, cap), math.ceil(k / GATE_MAX_KS))
    return math.ceil(k / math.ceil(k / splits))      # no empty split


def rglru_step(u, gate, conv_state, h_state, conv_w, conv_b, rg_w, rg_b,
               ig_w, ig_b, lam, *, out=None,
               sigmoid_table: Optional[PWLTable] = None,
               softplus_table: Optional[PWLTable] = None,
               gelu_table: Optional[PWLTable] = None):
    """The CUDA kernel (contract as :func:`rglru_step_plain`, with the
    activations' ActiBA tables in place of callables, ``None`` = exact):
    two launches, the split-k GEMV of both gate weights (the conv step
    computed as its input), then the update, one thread per (row,
    channel).  conv_w, conv_b, rg_b, ig_b and lam must be contiguous fp32
    (the model's ``decode_view``); rg_w and ig_w contiguous fp32 or bf16,
    read as they are stored.  ``out`` = (new_conv, new_h) buffers to write
    the new state into instead of fresh ones."""
    dev = u.device
    common.require(dev.type == "cuda", "rglru_step takes CUDA tensors; the "
                   "CPU path is rglru_step_plain")
    b, w = u.shape
    width = conv_w.shape[0]
    common.check_f32("rglru_step", conv_w=conv_w, conv_b=conv_b, rg_b=rg_b,
                     ig_b=ig_b, lam=lam, h_state=h_state)
    common.check_cuda(dev, gate=gate, conv_state=conv_state, h_state=h_state,
                      conv_w=conv_w, conv_b=conv_b, rg_w=rg_w, rg_b=rg_b,
                      ig_w=ig_w, ig_b=ig_b, lam=lam)
    for name, t in (("gate", gate), ("conv_state", conv_state)):
        common.require(t.dtype == u.dtype,
                       f"rglru_step: {name} is {t.dtype}, u is {u.dtype}")
    common.require(u.is_contiguous() and gate.is_contiguous()
                   and tuple(gate.shape) == (b, w),
                   "rglru_step: u and gate must be contiguous (b, w)")
    common.require(tuple(conv_state.shape) == (b, width - 1, w)
                   and conv_state.is_contiguous(),
                   "rglru_step: conv_state must be contiguous (b, wc-1, w)")
    common.require(tuple(h_state.shape) == (b, w), "rglru_step: h_state "
                   "must be (b, w)")
    common.require(conv_w.shape == (width, w) and width >= 2
                   and conv_b.shape == rg_b.shape == ig_b.shape == lam.shape
                   == (w,), "rglru_step: parameter shapes")
    for name, t in (("rg_w", rg_w), ("ig_w", ig_w)):
        common.require(t.dtype in common.STREAM_DTYPES and t.dtype == rg_w.dtype
                       and t.is_contiguous() and tuple(t.shape) == (w, w),
                       f"rglru_step: {name} must be contiguous fp32 or bf16 "
                       f"({w}, {w}) like rg_w, got {t.dtype} "
                       f"{tuple(t.shape)}")
    splits = gate_splits(min(b, GEMV_M), w, w)
    partial = torch.empty((splits * 2 * min(b, GEMV_M) * w,),
                          dtype=torch.float32, device=dev)
    vec4 = w % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                              for t in (rg_w, ig_w))
    y = torch.empty_like(u)
    new_conv, new_h = common.outputs(out, conv_state, h_state, "rglru_step")
    err = common.launcher(*_RG_LAUNCH)(
        common.stream_code(u), common.stream_code(rg_w), common.ptr(u),
        common.ptr(gate), common.ptr(conv_state), common.ptr(h_state),
        common.ptr(conv_w), common.ptr(conv_b), common.ptr(rg_w),
        common.ptr(rg_b), common.ptr(ig_w), common.ptr(ig_b),
        common.ptr(lam), common.ptr(partial), common.ptr(y),
        common.ptr(new_conv), common.ptr(new_h), b, w, width, splits,
        int(vec4), *table_args(sigmoid_table, dev),
        *table_args(softplus_table, dev), *table_args(gelu_table, dev),
        common.stream(dev))
    common.check_launch(err, "rglru_step", "rglru_step kernels")
    rglru_step.launches += 1
    return y, new_conv, new_h


rglru_step.launches = 0
