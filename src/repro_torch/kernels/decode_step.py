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

Each wrapper takes CUDA tensors and counts its calls in ``.launches``;
on ``meta`` tensors (the dry run's) it allocates what it allocates on
the card, records its cost (``kernels/cost.py``) and launches nothing.
Each ``*_plain`` version is the same function in plain PyTorch with an
fp32 interior, the CPU path and what the kernel is held to on the card.

The Mamba-2 step (``mamba2_step`` / ``mamba2_step_ref``):

* :func:`mamba2_step` — the wrapper around ``csrc/decode_step.cu``: one
  launch (conv shift + SiLU + softplus(dt) + SSD update + D skip + the
  gated RMSNorm over whole rows), grid (p / :func:`step_rows`, head,
  batch), its arguments packed into one buffer (``STEP_FIELDS``) through
  a cached launcher.  It takes CUDA (or meta) tensors only and counts
  its calls in ``mamba2_step.launches``.
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
import struct
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import common, cost
from repro_torch.kernels.actiba import table_args
from repro_torch.kernels.gated_norm import gated_norm_plain
from repro_torch.kernels.qmatmul import SMS
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
_F32_6 = (_F32,) * 6


@functools.lru_cache(maxsize=None)
def step_rows(p: int) -> int:
    """State rows a block of the step kernel takes (8 warps, a warp rows w
    and w + 8): the largest divisor of ``p`` up to ``MAX_ROWS``.  At p = 64
    that is 16, so b = 4 runs 384 blocks of 256 threads in one wave, the
    whole state in flight."""
    return max(r for r in range(1, min(p, MAX_ROWS) + 1) if p % r == 0)


# The fused norm's scratch per device (-1: meta): (row counters, int32,
# zero between calls; per batch row its pre-norm y and its blocks' sums
# of squares, fp32), grown to the largest call so far.  Calls on one
# stream share it in turn.
_SCRATCH: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def _step_scratch(dev: int, b: int, row: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    got = _SCRATCH.get(dev)
    if got is None or got[0].numel() < b or got[1].numel() < b * row:
        nb = max(b, got[0].numel() if got else 0)
        ny = max(b * row, got[1].numel() if got else 0)
        where = dev if dev >= 0 else "meta"
        got = _SCRATCH[dev] = (
            torch.zeros(nb, dtype=torch.int32, device=where),
            torch.empty(ny, dtype=_F32, device=where))
    return got


# The parameter tensors of each weight set a call has seen (the model's
# decode_view hands the same ones every step), checked once and kept with
# their pointers by the three fused steps (kernels 1, 5 and 6); a call
# re-reads only the pointers, so a tensor given new storage is checked
# again.
_PARAMS: Dict[Tuple[int, ...], Tuple[tuple, Tuple[int, ...], tuple]] = {}
_MAX_PARAMS = 1024


def _params(ts: tuple, shapes: tuple, dtypes: tuple, idx: int
            ) -> Optional[Tuple[int, ...]]:
    """The pointers of the parameter tensors ``ts`` when each is
    contiguous, of its shape in ``shapes`` and its dtype in ``dtypes``, on
    device ``idx`` (checked once per weight set), else ``None``."""
    key = tuple(map(id, ts))
    ptrs = tuple(t.data_ptr() for t in ts)
    meta = (idx, shapes, dtypes)
    got = _PARAMS.get(key)
    if got is not None and got[1] == ptrs and got[2] == meta:
        return ptrs
    if any(t.shape != shape or t.dtype != dtype or not t.is_contiguous()
           or t.get_device() != idx
           for t, shape, dtype in zip(ts, shapes, dtypes)):
        return None
    if len(_PARAMS) >= _MAX_PARAMS:
        _PARAMS.clear()
    _PARAMS[key] = (ts, ptrs, meta)
    return ptrs


def _outputs(out, conv_state, state, idx: int, what: str):
    """``common.outputs`` with its checks in one expression (the message
    formatted only when they fail)."""
    if out is None:
        return torch.empty_like(conv_state), torch.empty_like(state)
    new_conv, new_state = out
    if (new_conv.shape == conv_state.shape and new_state.shape == state.shape
            and new_conv.dtype == conv_state.dtype
            and new_state.dtype == state.dtype
            and new_conv.is_contiguous() and new_state.is_contiguous()
            and new_conv.get_device() == idx
            and new_state.get_device() == idx
            and new_conv.data_ptr() != conv_state.data_ptr()
            and new_state.data_ptr() != state.data_ptr()):
        return new_conv, new_state
    return common.outputs(out, conv_state, state, what)


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
    if not (z.is_cuda or z.is_meta):
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
        params = _params((conv_w, conv_b, dt_bias, A, D, norm_scale),
                         ((width, dxbc), (dxbc,), (h,), (h,), (h,), (di,)),
                         _F32_6, idx)
    if params is None:
        _step_refusal(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                      dt_bias, A, D, norm_scale, g, p)
    new_conv, new_ssm = _outputs(out, conv_state, ssm_state, idx,
                                 "mamba2_step")
    y = torch.empty_like(z, memory_format=torch.contiguous_format)
    rows = step_rows(p)
    counts, ypre = _step_scratch(idx, b, di + di // rows)
    if idx < 0:
        cost.record("mamba2_step", cost.decode_ops(b, h, p, n, dxbc, di),
                    cost._bytes(z, xbc, dt, conv_state, ssm_state, conv_w,
                                conv_b, dt_bias, A, D, norm_scale, y,
                                new_conv, new_ssm))
        return y, new_conv, new_ssm
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
# Kernel 3's launcher takes one pointer to its arguments packed as 64-bit
# fields in this order (csrc/decode_step.cu: SsdArgs).
SSD_FIELDS = ("dtype", "state", "x", "dt", "A", "B", "C", "new_state", "y",
              "b", "h", "p", "g", "n", "rows", "vec", "stream")
_SSD_ARGS = struct.Struct("<" + "q" * len(SSD_FIELDS))
_SSD = common.Launcher("decode_step", "ssd_step_launch", [ctypes.c_char_p])
# Kernel 4's likewise (csrc/mamba1_step.cu: SscanArgs).
SSCAN_FIELDS = ("dtype", "state", "u", "dt", "A", "B", "C", "D", "new_state",
                "y", "b", "d", "n", "vec", "stream")
_SSCAN_ARGS = struct.Struct("<" + "q" * len(SSCAN_FIELDS))
_SSCAN = common.Launcher("mamba1_step", "sscan_step_launch",
                         [ctypes.c_char_p])


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
    """``t`` as contiguous fp32, itself when it already is."""
    return t if t.dtype == _F32 and t.is_contiguous() else \
        t.float().contiguous()


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """The CUDA kernel (contract as :func:`ssd_step_plain`): kernel 1's
    state stream, grid (p / :func:`step_rows`, head, batch), its arguments
    packed into one buffer (``SSD_FIELDS``).  dt, A, B and C are read as
    fp32 (cast here if they are not)."""
    dev = state.device
    common.require(dev.type in ("cuda", "meta"), "ssd_step takes CUDA "
                   "tensors; the CPU path is ssd_step_plain")
    b, h, p, n = state.shape
    g = B_t.shape[1]
    common.check_cuda(dev, x_t=x_t, dt_t=dt_t, A=A, B_t=B_t, C_t=C_t)
    common.require(state.dtype == _F32 and state.is_contiguous(),
                   "ssd_step: state must be contiguous fp32 (b, h, p, n)")
    common.require(x_t.shape == (b, h, p) and dt_t.shape == (b, h)
                   and A.shape == (h,) and B_t.shape == C_t.shape == (b, g, n)
                   and g > 0 and h % g == 0, "ssd_step: shapes")
    code = common.stream_code(x_t)
    if not x_t.is_contiguous():
        x_t = x_t.contiguous()
    new = torch.empty_like(state)
    y = torch.empty_like(x_t)
    dt_t, A, B_t, C_t = _f32(dt_t), _f32(A), _f32(B_t), _f32(C_t)
    if dev.type == "meta":
        cost.record("ssd_step", cost.ssd_step_ops(b, h, p, n), cost._bytes(
            state, x_t, dt_t, A, B_t, C_t, new, y))
        return new, y
    sp, snp = state.data_ptr(), new.data_ptr()
    err = _SSD(_SSD_ARGS.pack(
        code, sp, x_t.data_ptr(), dt_t.data_ptr(), A.data_ptr(),
        B_t.data_ptr(), C_t.data_ptr(), snp, y.data_ptr(), b, h, p, g, n,
        step_rows(p), n % 4 == 0 and (sp | snp) % 16 == 0,
        torch._C._cuda_getCurrentRawStream(dev.index)))
    if err:
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
    """The CUDA kernel (contract as :func:`sscan_step_plain`): kernel 5's
    state stream alone, four threads a (row, channel), its arguments packed
    into one buffer (``SSCAN_FIELDS``).  delta, A, B, C and D are read as
    fp32 (cast here if they are not); ``D=None`` is passed as a null
    pointer, no skip."""
    dev = state.device
    common.require(dev.type in ("cuda", "meta"), "sscan_step takes CUDA "
                   "tensors; the CPU path is sscan_step_plain")
    b, d, n = state.shape
    common.check_cuda(dev, u_t=u_t, delta_t=delta_t, A=A, B_t=B_t, C_t=C_t,
                      **({} if D is None else {"D": D}))
    common.require(state.dtype == _F32 and state.is_contiguous(),
                   "sscan_step: state must be contiguous fp32 (b, d, n)")
    common.require(tuple(u_t.shape) == tuple(delta_t.shape) == (b, d)
                   and tuple(A.shape) == (d, n)
                   and tuple(B_t.shape) == tuple(C_t.shape) == (b, n)
                   and (D is None or tuple(D.shape) == (d,)),
                   "sscan_step: shapes")
    code = common.stream_code(u_t)
    if not u_t.is_contiguous():
        u_t = u_t.contiguous()
    new = torch.empty_like(state)
    y = torch.empty_like(u_t)
    delta_t, A, B_t, C_t = _f32(delta_t), _f32(A), _f32(B_t), _f32(C_t)
    D = None if D is None else _f32(D)
    if dev.type == "meta":
        cost.record("sscan_step", cost.sscan_step_ops(b, d, n), cost._bytes(
            state, u_t, delta_t, A, B_t, C_t, D, new, y))
        return new, y
    sp, snp, ap = state.data_ptr(), new.data_ptr(), A.data_ptr()
    err = _SSCAN(_SSCAN_ARGS.pack(
        code, sp, u_t.data_ptr(), delta_t.data_ptr(), ap, B_t.data_ptr(),
        C_t.data_ptr(), 0 if D is None else D.data_ptr(), snp,
        y.data_ptr(), b, d, n, n % 4 == 0 and (sp | snp | ap) % 16 == 0,
        torch._C._cuda_getCurrentRawStream(dev.index)))
    if err:
        common.check_launch(err, "mamba1_step", "sscan_step kernel")
    sscan_step.launches += 1
    return new, y


sscan_step.launches = 0


# ---------------------------------------------------------------------------
# The fused Mamba-1 step: kernel 5
# ---------------------------------------------------------------------------
# The launcher takes one pointer to its arguments packed as 64-bit fields
# in this order (csrc/mamba1_step.cu: M1Args).
M1_FIELDS = ("dtype", "xs_raw", "x_rs", "z", "z_rs", "conv_state",
             "ssm_state", "conv_w", "conv_b", "xproj_w", "dtproj_w",
             "dtproj_b", "A", "D", "y", "new_conv", "new_ssm", "b", "di", "n",
             "r", "width", "vec", "silu_tab", "silu_nk", "sp_tab", "sp_nk",
             "stream")
_M1_ARGS = struct.Struct("<" + "q" * len(M1_FIELDS))
_M1 = common.Launcher("mamba1_step", "mamba1_step_launch", [ctypes.c_char_p])
MAX_CONV = 4              # kernels 5 and 6: the widest conv (loads unrolled)
_F32_7 = (_F32,) * 7


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


def _m1_refusal(xs_raw, z, conv_state, ssm_state, conv_w, conv_b, xproj_w,
                dtproj_w, dtproj_b, A, D, r) -> None:
    """Raise with the reason :func:`mamba1_step` refuses its inputs (run
    only once its one combined check failed)."""
    dev = z.device
    b, di = z.shape
    n = ssm_state.shape[-1]
    width = conv_w.shape[0]
    common.stream_code(z)
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
    common.row_stride(xs_raw, "xs_raw")
    common.row_stride(z, "z")
    common.require(tuple(conv_state.shape) == (b, width - 1, di)
                   and conv_state.is_contiguous(),
                   "mamba1_step: conv_state must be contiguous (b, w-1, di)")
    common.require(tuple(ssm_state.shape) == (b, di, n)
                   and ssm_state.dtype == _F32 and ssm_state.is_contiguous(),
                   "mamba1_step: ssm_state must be contiguous fp32 (b, di, n)")
    common.require(conv_w.shape == (width, di) and conv_b.shape == (di,)
                   and xproj_w.shape == (di, r + 2 * n)
                   and dtproj_w.shape == (r, di)
                   and dtproj_b.shape == D.shape == (di,)
                   and A.shape == (di, n), "mamba1_step: parameter shapes")
    common.require(1 <= width <= MAX_CONV, f"mamba1_step: conv width "
                   f"{width} not in 1..{MAX_CONV}")
    raise ValueError("mamba1_step: inputs refused")


def mamba1_step(xs_raw, z, conv_state, ssm_state, conv_w, conv_b, xproj_w,
                dtproj_w, dtproj_b, A, D, *, dt_rank: int, out=None,
                silu_table: Optional[PWLTable] = None,
                softplus_table: Optional[PWLTable] = None):
    """The CUDA kernel (contract as :func:`mamba1_step_plain`, with the
    activations' ActiBA tables in place of callables, ``None`` = exact):
    one launch, each batch row a thread-block cluster of 16 blocks over
    d_inner (``csrc/mamba1_step.cu``: ``M1_CLUSTER``) whose x_proj partial
    sums meet in distributed shared memory.  The parameters (conv_w,
    conv_b, xproj_w, dtproj_w, dtproj_b, A, D) must be contiguous fp32;
    xs_raw and z may be row views of one ``in_proj`` output.  ``out`` = (new_conv,
    new_ssm) buffers to write the new state into instead of fresh ones.
    The inputs are checked at once (the parameters once per weight set)
    and a message is formatted only when a check fails; only the outputs
    are allocated."""
    if not (z.is_cuda or z.is_meta):
        raise ValueError("mamba1_step takes CUDA tensors; the CPU path is "
                         "mamba1_step_plain")
    b, di = z.shape
    n = ssm_state.shape[-1]
    r = dt_rank
    width = conv_w.shape[0]
    sd = z.dtype
    code = common.STREAM_DTYPES.get(sd)
    idx = z.get_device()
    xst, zst = xs_raw.stride(), z.stride()
    params = None
    if (code is not None and xs_raw.dtype == sd and conv_state.dtype == sd
            and ssm_state.dtype == _F32 and 1 <= width <= MAX_CONV
            and xs_raw.shape == (b, di)
            and conv_state.shape == (b, width - 1, di)
            and ssm_state.shape == (b, di, n) and xst[1] == 1 and zst[1] == 1
            and conv_state.is_contiguous() and ssm_state.is_contiguous()
            and xs_raw.get_device() == idx and conv_state.get_device() == idx
            and ssm_state.get_device() == idx):
        params = _params(
            (conv_w, conv_b, xproj_w, dtproj_w, dtproj_b, A, D),
            ((width, di), (di,), (di, r + 2 * n), (r, di), (di,), (di, n),
             (di,)), _F32_7, idx)
    if params is None:
        _m1_refusal(xs_raw, z, conv_state, ssm_state, conv_w, conv_b,
                    xproj_w, dtproj_w, dtproj_b, A, D, r)
    new_conv, new_ssm = _outputs(out, conv_state, ssm_state, idx,
                                 "mamba1_step")
    y = torch.empty_like(z, memory_format=torch.contiguous_format)
    if idx < 0:
        cost.record("mamba1_step", cost.mamba1_ops(b, di, n, r, width),
                    cost._bytes(xs_raw, z, conv_state, ssm_state, conv_w,
                                conv_b, xproj_w, dtproj_w, dtproj_b, A, D,
                                y, new_conv, new_ssm))
        return y, new_conv, new_ssm
    sp, snp = ssm_state.data_ptr(), new_ssm.data_ptr()
    dev = z.device
    silu_p, silu_nk = table_args(silu_table, dev)
    sp_p, sp_nk = table_args(softplus_table, dev)
    err = _M1(_M1_ARGS.pack(
        code, xs_raw.data_ptr(), xst[0], z.data_ptr(), zst[0],
        conv_state.data_ptr(), sp, *params, y.data_ptr(),
        new_conv.data_ptr(), snp, b, di, n, r, width,
        n % 4 == 0 and (sp | snp | params[5]) % 16 == 0, silu_p, silu_nk,
        sp_p, sp_nk, torch._C._cuda_getCurrentRawStream(idx)))
    if err:
        common.check_launch(err, "mamba1_step", "mamba1_step kernel")
    mamba1_step.launches += 1
    return y, new_conv, new_ssm


mamba1_step.launches = 0


# ---------------------------------------------------------------------------
# The fused RG-LRU step: kernel 6
# ---------------------------------------------------------------------------
# The launcher takes one pointer to its arguments packed as 64-bit fields
# in this order (csrc/rglru_step.cu: RgArgs).
RG_FIELDS = ("dtype", "wdtype", "u", "gate", "conv_state", "h", "conv_w",
             "conv_b", "rg_w", "rg_b", "ig_w", "ig_b", "lam", "y", "new_conv",
             "new_h", "b", "w", "wc", "lanes", "splits", "vec", "sig_tab",
             "sig_nk", "sp_tab", "sp_nk", "gelu_tab", "gelu_nk", "stream")
_RG_ARGS = struct.Struct("<" + "q" * len(RG_FIELDS))
_RG = common.Launcher("rglru_step", "rglru_step_launch", [ctypes.c_char_p])
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


RG_COLS = 128             # kernel 6: weight columns a GEMV block takes
RG_SPLITS = (5, 4, 2, 1)  # its clusters over k, largest first


@functools.lru_cache(maxsize=None)
def rglru_plan(w: int, esize: int) -> Tuple[int, int]:
    """(lanes, splits) of kernel 6's gate GEMV over (w, w) weights of
    ``esize`` bytes: ``RG_COLS`` columns a block (16 lanes of 8 bf16, 32 of
    4 fp32) and the most k splits of ``RG_SPLITS`` whose blocks fit one
    wave of the 132 SMs, each k lane keeping a row and no split empty: (16,
    5), 100 blocks, at recurrentgemma-2b's bf16 2560 (clusters of 5
    measured faster there than 4, 3, 2 or 6, and than 32 or 8 lanes).  A
    function of the shapes alone, so a shape always takes the same sums in
    the same order."""
    lanes = min(32, RG_COLS // (16 // esize))
    tiles = -(-w // RG_COLS)
    klanes = 8 * 32 // lanes
    for splits in RG_SPLITS:
        if splits == 1 or (tiles * splits <= SMS and w >= splits * klanes
                           and (splits - 1) * -(-w // splits) < w):
            return lanes, splits
    return lanes, 1


def _rg_refusal(u, gate, conv_state, h_state, conv_w, conv_b, rg_w, rg_b,
                ig_w, ig_b, lam) -> None:
    """Raise with the reason :func:`rglru_step` refuses its inputs (run
    only once its one combined check failed)."""
    dev = u.device
    b, w = u.shape
    width = conv_w.shape[0]
    common.stream_code(u)
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
    common.require(conv_w.shape == (width, w) and 2 <= width <= MAX_CONV
                   and conv_b.shape == rg_b.shape == ig_b.shape == lam.shape
                   == (w,), "rglru_step: parameter shapes (conv width 2 to "
                   f"{MAX_CONV})")
    for name, t in (("rg_w", rg_w), ("ig_w", ig_w)):
        common.require(t.dtype in common.STREAM_DTYPES and t.dtype == rg_w.dtype
                       and t.is_contiguous() and tuple(t.shape) == (w, w),
                       f"rglru_step: {name} must be contiguous fp32 or bf16 "
                       f"({w}, {w}) like rg_w, got {t.dtype} "
                       f"{tuple(t.shape)}")
    raise ValueError("rglru_step: inputs refused")


def rglru_step(u, gate, conv_state, h_state, conv_w, conv_b, rg_w, rg_b,
               ig_w, ig_b, lam, *, out=None,
               sigmoid_table: Optional[PWLTable] = None,
               softplus_table: Optional[PWLTable] = None,
               gelu_table: Optional[PWLTable] = None):
    """The CUDA kernel (contract as :func:`rglru_step_plain`, with the
    activations' ActiBA tables in place of callables, ``None`` = exact):
    one launch a group of 8 rows (every serve batch is one group) of the
    cluster GEMV over both gate weights, its x the conv step and its
    epilogue the whole update (plan: :func:`rglru_plan`).  conv_w, conv_b,
    rg_b, ig_b and lam must be contiguous fp32 (the model's
    ``decode_view``); rg_w and ig_w contiguous fp32 or bf16, read as they
    are stored.  ``out`` = (new_conv, new_h) buffers to write the new state
    into instead of fresh ones.  The inputs are checked at once (the
    parameters once per weight set) and a message is formatted only when a
    check fails; only the outputs are allocated."""
    if not (u.is_cuda or u.is_meta):
        raise ValueError("rglru_step takes CUDA tensors; the CPU path is "
                         "rglru_step_plain")
    b, w = u.shape
    width = conv_w.shape[0]
    sd, wd = u.dtype, rg_w.dtype
    code, wcode = common.STREAM_DTYPES.get(sd), common.STREAM_DTYPES.get(wd)
    idx = u.get_device()
    params = None
    if (code is not None and wcode is not None and gate.dtype == sd
            and conv_state.dtype == sd and h_state.dtype == _F32
            and gate.shape == (b, w) and conv_state.shape == (b, width - 1, w)
            and h_state.shape == (b, w) and 2 <= width <= MAX_CONV
            and u.is_contiguous() and gate.is_contiguous()
            and conv_state.is_contiguous() and h_state.is_contiguous()
            and gate.get_device() == idx and conv_state.get_device() == idx
            and h_state.get_device() == idx):
        params = _params((conv_w, conv_b, rg_w, rg_b, ig_w, ig_b, lam),
                         ((width, w), (w,), (w, w), (w,), (w, w), (w,), (w,)),
                         (_F32, _F32, wd, _F32, wd, _F32, _F32), idx)
    if params is None:
        _rg_refusal(u, gate, conv_state, h_state, conv_w, conv_b, rg_w, rg_b,
                    ig_w, ig_b, lam)
    new_conv, new_h = _outputs(out, conv_state, h_state, idx, "rglru_step")
    y = torch.empty_like(u)
    if idx < 0:
        cost.record("rglru_step", cost.rglru_step_ops(b, w), cost._bytes(
            u, gate, conv_state, h_state, conv_w, conv_b, rg_w, rg_b, ig_w,
            ig_b, lam, y, new_conv, new_h))
        return y, new_conv, new_h
    esize = rg_w.element_size()
    lanes, splits = rglru_plan(w, esize)
    base, row = params[2] | params[4], w * esize
    vec = 16 if row % 16 == 0 and base % 16 == 0 else \
        8 if row % 8 == 0 and base % 8 == 0 else 0
    dev = u.device
    err = _RG(_RG_ARGS.pack(
        code, wcode, u.data_ptr(), gate.data_ptr(), conv_state.data_ptr(),
        h_state.data_ptr(), *params, y.data_ptr(), new_conv.data_ptr(),
        new_h.data_ptr(), b, w, width, lanes, splits, vec,
        *table_args(sigmoid_table, dev), *table_args(softplus_table, dev),
        *table_args(gelu_table, dev), torch._C._cuda_getCurrentRawStream(idx)))
    if err:
        common.check_launch(err, "rglru_step", "rglru_step kernel")
    rglru_step.launches += 1
    return y, new_conv, new_h


rglru_step.launches = 0
