"""The Mamba-2 (SSD) and Mamba-1 (selective-scan) mixers and the RG-LRU
recurrent block: ports of ``repro.nn.ssm``.

``mamba2_apply`` handles both the multi-token prefill (with or without a
carried state) and the single-token decode step with the same params:

* decode, modes ``cumba`` / ``pallas*``: the fused step through
  ``kernels/ops.py`` (the hand-written kernel on the GPU, its plain
  version on the CPU); mode ``naive``: the unfused dense step
  (``_mamba2_decode_naive``);
* prefill: the fused prefill through ``kernels/ops.py`` when the JAX
  package's gate admits the shape, else the unfused chain (projection ->
  conv -> activations -> ``core/ssd.py: ssd`` -> gate), as the JAX
  package falls back to it: ``prefill="naive"``, ``ssd_dtype`` other than
  fp32, a seqlen that is not a chunk multiple, or a ``pallas`` chunk that
  is not a multiple of 64.  Each reason is logged once per shape.

``mamba1_apply`` is the Mamba-1 mixer with the same contract:

* decode, modes ``cumba`` / ``pallas*``: the fused step (kernel 5 on the
  GPU) through ``kernels/ops.py``; mode ``naive``: the unfused dense step
  (``_mamba1_decode_naive``);
* prefill: plain ops, as in the JAX package (which has no Pallas kernel
  there): in_proj -> conv -> SiLU -> x_proj -> dt_proj -> softplus ->
  ``core/selective_scan.py: selective_scan(mode=cfg.scan_mode)`` ->
  SiLU(z) gate -> out_proj.

``rglru_apply`` is recurrentgemma's RG-LRU block (Griffin), with the
same contract:

* decode, modes ``cumba`` / ``pallas*``: the fused step (kernel 6 on the
  GPU) through ``kernels/ops.py``; mode ``naive``: the unfused dense step
  (``_rglru_decode_naive``);
* prefill: in_x / in_gate projections -> causal conv (no SiLU) -> the
  sigmoid gates -> the recurrence h_t = a_t h_{t-1} + b_t -> GeLU(gate)
  -> out.  With a carried state the recurrence is the associative scan
  (``core/selective_scan.py: linear_scan``) from ``h0``; without one
  (the cache-less trunk) under a ``pallas`` CumBA mode it is kernel 8
  (``ops.rg_lru_scan``), exactly where the JAX package dispatches it.

ActiBA reaches the fused kernels as PWL tables (``xamba``) and the
unfused chains through ``core/pwl.py: activation`` (kernel 12 on the GPU).
"""
from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import pwl, selective_scan as sscan, ssd as ssd_mod
from repro_torch.kernels import ops
from repro_torch.nn import layers
from repro_torch.nn.params import ParamSpec

log = logging.getLogger("repro_torch.ssm")
_LOGGED = set()    # (mode, reason, b, l) already logged


class Mamba2State(NamedTuple):
    conv: torch.Tensor   # (b, d_conv-1, d_conv_dim), stream dtype
    ssm: torch.Tensor    # (b, nheads, headdim, d_state), fp32


def mamba2_dims(cfg):
    d_inner = cfg.expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_ngroups, cfg.d_state


def mamba2_specs(cfg) -> dict:
    d = cfg.d_model
    d_inner, nheads, g, n = mamba2_dims(cfg)
    d_xbc = d_inner + 2 * g * n
    d_in_proj = 2 * d_inner + 2 * g * n + nheads
    return {
        "in_proj": layers.linear_specs(d, d_in_proj),
        "conv": layers.conv1d_specs(d_xbc, cfg.d_conv),
        "dt_bias": ParamSpec((nheads,), init="zeros"),
        "A_log": ParamSpec((nheads,), init="ones"),
        "D": ParamSpec((nheads,), init="ones"),
        "norm": layers.norm_specs(d_inner),
        "out_proj": layers.linear_specs(d_inner, d),
    }


def mamba2_init_state(cfg, batch: int, dtype: torch.dtype,
                      device: torch.device) -> Mamba2State:
    d_inner, nheads, g, n = mamba2_dims(cfg)
    d_xbc = d_inner + 2 * g * n
    return Mamba2State(
        conv=torch.zeros((batch, cfg.d_conv - 1, d_xbc), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, nheads, cfg.ssm_head_dim, n),
                        dtype=torch.float32, device=device))


def mamba2_kernel_operands(params: dict) -> dict:
    """The mixer's small parameters as the kernels take them: contiguous
    fp32, with the decay rate ``A = -exp(A_log)``.  The model's
    ``decode_view`` builds them once per weight set; ``mamba2_apply``
    builds them per call only for params without that view."""
    def f32(t):
        return t.float().contiguous()
    return {"conv_w": f32(params["conv"]["w"]),
            "conv_b": f32(params["conv"]["b"]),
            "dt_bias": f32(params["dt_bias"]),
            "A": -torch.exp(params["A_log"].float()),
            "D": f32(params["D"]),
            "norm_scale": f32(params["norm"]["scale"])}


def _operands(params: dict, build=None) -> dict:
    """The view's kernel operands, else ``build(params)`` (default
    :func:`mamba2_kernel_operands`)."""
    if "kernel" in params:
        return params["kernel"]
    return (build or mamba2_kernel_operands)(params)


def _into(out, new):
    """The new state (any of the mixers' two-leaf states) written into the
    caller's ``out`` buffers, if any (the fused kernels write there
    directly)."""
    if out is None:
        return new
    for o, n in zip(out, new):
        o.copy_(n)
    return out


def _unfused_streams(params: dict, cfg, x: torch.Tensor,
                     conv_state: torch.Tensor):
    """The unfused chain up to the SSD: in-projection, causal conv over
    [tail; x], the activations (``core/pwl.py``) and the splits.  Returns
    (z, xs (b, l, h, p), B, C (b, l, g, n), dt (b, l, h) fp32, A, the new
    conv tail, the SiLU in use)."""
    b, l, _ = x.shape
    d_inner, nheads, g, n = mamba2_dims(cfg)
    silu = pwl.activation("silu", cfg.xamba)
    softplus = pwl.activation("softplus", cfg.xamba)
    z, xbc, dt = torch.split(layers.linear(params["in_proj"], x),
                             [d_inner, d_inner + 2 * g * n, nheads], dim=-1)
    xbc_conv, new_conv = layers.causal_conv1d(params["conv"], xbc, conv_state)
    xs, B, C = torch.split(silu(xbc_conv), [d_inner, g * n, g * n], dim=-1)
    dt = softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    return (z, xs.reshape(b, l, nheads, cfg.ssm_head_dim),
            B.reshape(b, l, g, n), C.reshape(b, l, g, n), dt, A, new_conv,
            silu)


def _gate_out(params: dict, x, y, xs, z, silu) -> torch.Tensor:
    """D skip, gated RMSNorm and the out-projection of the unfused chain."""
    b, l = x.shape[:2]
    y = y + xs * params["D"].to(x.dtype)[None, None, :, None]
    y = layers.norm(params["norm"], y.reshape(b, l, -1)) * silu(z)
    return layers.linear(params["out_proj"], y.to(x.dtype))


def _mamba2_decode_naive(params: dict, cfg, x: torch.Tensor,
                         state: Mamba2State, out: Optional[Mamba2State]
                         ) -> Tuple[torch.Tensor, Mamba2State]:
    """The unfused dense step (the NPU-baseline op chain): seq-axis
    (b, 1, d) operands end to end, per-tap conv slices, and the state
    contraction as broadcast-multiply + ReduceSum."""
    z, xs, B, C, dt, A, new_conv, silu = _unfused_streams(params, cfg, x,
                                                          state.conv)
    new_ssm, y = ssd_mod.ssd_decode_step(state.ssm, xs[:, 0], dt[:, 0], A,
                                         B[:, 0], C[:, 0], mode="naive")
    h = _gate_out(params, x, y[:, None], xs, z, silu)
    return h, _into(out, Mamba2State(new_conv, new_ssm))


def _mamba2_decode(params: dict, cfg, x: torch.Tensor, state: Mamba2State,
                   out: Optional[Mamba2State]
                   ) -> Tuple[torch.Tensor, Mamba2State]:
    """Single-token step; x: (b, 1, d).  ``naive`` runs the unfused
    chain; ``cumba`` and ``pallas*`` the fused step on (b, d) operands."""
    if cfg.xamba.decode == "naive":
        return _mamba2_decode_naive(params, cfg, x, state, out)
    d_inner, nheads, g, n = mamba2_dims(cfg)
    zxbcdt = layers.linear(params["in_proj"], x[:, 0])       # (b, d_in_proj)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * g * n, nheads],
                             dim=-1)
    y, new_conv, new_ssm = ops.mamba2_decode_step(
        z, xbc, dt, state.conv, state.ssm, **_operands(params), ngroups=g,
        head_dim=cfg.ssm_head_dim, xamba=cfg.xamba, out=out)
    h = layers.linear(params["out_proj"], y.to(x.dtype))[:, None]
    return h, Mamba2State(new_conv, new_ssm)


def _fused_prefill_refusal(cfg, l: int) -> Optional[str]:
    """Why the fused prefill does not take this shape (the JAX package's
    gate, ``nn/ssm.py:174-184``), or ``None`` when it does."""
    mode = cfg.xamba.prefill
    if mode == "naive":
        return "prefill mode naive"
    chunk = min(cfg.chunk_size, l)
    if cfg.ssd_dtype != "float32":
        return f"ssd_dtype={cfg.ssd_dtype} (fused prefill is fp32-only)"
    if l % chunk:
        return f"seqlen {l} not a multiple of chunk {chunk}"
    if mode == "pallas" and chunk % 64:
        return f"chunk {chunk} not a multiple of 64 (kernel tiling)"
    return None


def _mamba2_prefill_unfused(params: dict, cfg, x: torch.Tensor,
                            init: Mamba2State, out: Optional[Mamba2State]
                            ) -> Tuple[torch.Tensor, Mamba2State]:
    """The unfused chain (``repro`` ``nn/ssm.py:207-237``)."""
    z, xs, B, C, dt, A, new_conv, silu = _unfused_streams(params, cfg, x,
                                                          init.conv)
    y, new_ssm = ssd_mod.ssd(
        xs, dt, A, B, C, chunk_size=min(cfg.chunk_size, x.shape[1]),
        initial_state=init.ssm, xamba=cfg.xamba, return_final_state=True,
        matmul_dtype=torch.bfloat16 if cfg.ssd_dtype == "bfloat16" else None)
    h = _gate_out(params, x, y, xs, z, silu)
    return h, _into(out, Mamba2State(new_conv.to(init.conv.dtype), new_ssm))


def mamba2_apply(params: dict, cfg, x: torch.Tensor,
                 state: Optional[Mamba2State] = None,
                 out: Optional[Mamba2State] = None,
                 ) -> Tuple[torch.Tensor, Optional[Mamba2State]]:
    """x: (b, l, d).  l == 1 with a state -> decode step (unless
    ``cfg.force_prefill_path``); else prefill, fused or unfused.
    ``out``: buffers that receive the new state (with ``state`` only)."""
    b, l, _ = x.shape
    d_inner, nheads, g, n = mamba2_dims(cfg)
    if state is not None and l == 1 and not cfg.force_prefill_path:
        return _mamba2_decode(params, cfg, x, state, out)

    init = state if state is not None else \
        mamba2_init_state(cfg, b, x.dtype, x.device)
    reason = _fused_prefill_refusal(cfg, l)
    if reason is not None:
        key = (cfg.xamba.prefill, reason, b, l)
        if cfg.xamba.prefill != "naive" and key not in _LOGGED:
            _LOGGED.add(key)
            log.info("fused prefill (%s) skipped: %s — running the unfused "
                     "chain", cfg.xamba.prefill, reason)
        h, new_state = _mamba2_prefill_unfused(params, cfg, x, init, out)
    else:
        y, new_conv, new_ssm = ops.mamba2_prefill(
            x, params["in_proj"]["w"], init.conv, init.ssm,
            **_operands(params), ngroups=g, head_dim=cfg.ssm_head_dim,
            chunk=min(cfg.chunk_size, l), xamba=cfg.xamba, out=out)
        h = layers.linear(params["out_proj"], y.to(x.dtype))
        new_state = Mamba2State(new_conv, new_ssm)
    return h, new_state if state is not None else None


# ============================================================================
# Mamba-1 mixer (selective scan)
# ============================================================================

class Mamba1State(NamedTuple):
    conv: torch.Tensor   # (b, d_conv-1, d_inner), stream dtype
    ssm: torch.Tensor    # (b, d_inner, d_state), fp32


def mamba1_dims(cfg):
    """(d_inner, d_state, dt_rank); dt_rank 0 means ceil(d_model / 16)."""
    return (cfg.expand * cfg.d_model, cfg.d_state,
            cfg.dt_rank or math.ceil(cfg.d_model / 16))


def mamba1_specs(cfg) -> dict:
    d = cfg.d_model
    d_inner, n, r = mamba1_dims(cfg)
    return {
        "in_proj": layers.linear_specs(d, 2 * d_inner),
        "conv": layers.conv1d_specs(d_inner, cfg.d_conv),
        "x_proj": layers.linear_specs(d_inner, r + 2 * n),
        "dt_proj": {"w": ParamSpec((r, d_inner), scale=0.1),
                    "b": ParamSpec((d_inner,), init="small_normal")},
        "A_log": ParamSpec((d_inner, n), init="ones"),
        "D": ParamSpec((d_inner,), init="ones"),
        "out_proj": layers.linear_specs(d_inner, d),
    }


def mamba1_init_state(cfg, batch: int, dtype: torch.dtype,
                      device: torch.device) -> Mamba1State:
    d_inner, n, _ = mamba1_dims(cfg)
    return Mamba1State(
        conv=torch.zeros((batch, cfg.d_conv - 1, d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, d_inner, n), dtype=torch.float32,
                        device=device))


def mamba1_kernel_operands(params: dict) -> dict:
    """The Mamba-1 mixer's parameters as kernel 5 takes them: contiguous
    fp32, with ``A = -exp(A_log)`` (d_inner, n); built once per weight set
    by the model's ``decode_view``, as :func:`mamba2_kernel_operands`."""
    def f32(t):
        return t.float().contiguous()
    return {"conv_w": f32(params["conv"]["w"]),
            "conv_b": f32(params["conv"]["b"]),
            "xproj_w": f32(params["x_proj"]["w"]),
            "dtproj_w": f32(params["dt_proj"]["w"]),
            "dtproj_b": f32(params["dt_proj"]["b"]),
            "A": -torch.exp(params["A_log"].float()),
            "D": f32(params["D"])}


def _mamba1_dt(params: dict, cfg, xs: torch.Tensor, softplus):
    """x_proj -> (dt_low, B, C); dt = softplus(dt_low @ dt_proj + b), the
    products in the stream dtype and the softplus in fp32, as the JAX
    package's unfused chain takes them."""
    _, n, r = mamba1_dims(cfg)
    dt, B, C = torch.split(layers.linear(params["x_proj"], xs), [r, n, n],
                           dim=-1)
    dt = torch.matmul(dt, params["dt_proj"]["w"].to(dt.dtype)) + \
        params["dt_proj"]["b"].to(dt.dtype)
    return softplus(dt.float()), B, C


def _mamba1_decode_naive(params: dict, cfg, x: torch.Tensor,
                         state: Mamba1State, out: Optional[Mamba1State]
                         ) -> Tuple[torch.Tensor, Mamba1State]:
    """The unfused dense step (the NPU-baseline op chain): seq-axis
    (b, 1, d) operands, per-tap conv slices, and the state contraction as
    multiply + ReduceSum."""
    silu = pwl.activation("silu", cfg.xamba)
    softplus = pwl.activation("softplus", cfg.xamba)
    xs, z = torch.chunk(layers.linear(params["in_proj"], x), 2, dim=-1)
    xs, new_conv = layers.causal_conv1d(params["conv"], xs, state.conv)
    xs = silu(xs)
    dt, B, C = _mamba1_dt(params, cfg, xs, softplus)
    new_ssm, y = sscan.selective_scan_decode_step(
        state.ssm, xs[:, 0], dt[:, 0], -torch.exp(params["A_log"].float()),
        B[:, 0], C[:, 0], params["D"], mode="naive")
    y = y[:, None] * silu(z)
    h = layers.linear(params["out_proj"], y.to(x.dtype))
    return h, _into(out, Mamba1State(new_conv, new_ssm))


def _mamba1_decode(params: dict, cfg, x: torch.Tensor, state: Mamba1State,
                   out: Optional[Mamba1State]
                   ) -> Tuple[torch.Tensor, Mamba1State]:
    """Single-token step; x: (b, 1, d).  ``naive`` runs the unfused chain;
    ``cumba`` and ``pallas*`` the fused step on (b, d) operands."""
    if cfg.xamba.decode == "naive":
        return _mamba1_decode_naive(params, cfg, x, state, out)
    _, _, r = mamba1_dims(cfg)
    xs_raw, z = torch.chunk(layers.linear(params["in_proj"], x[:, 0]), 2,
                            dim=-1)
    y, new_conv, new_ssm = ops.mamba1_decode_step(
        xs_raw, z, state.conv, state.ssm,
        **_operands(params, mamba1_kernel_operands), dt_rank=r,
        xamba=cfg.xamba, out=out)
    h = layers.linear(params["out_proj"], y.to(x.dtype))[:, None]
    return h, Mamba1State(new_conv, new_ssm)


def mamba1_apply(params: dict, cfg, x: torch.Tensor,
                 state: Optional[Mamba1State] = None,
                 out: Optional[Mamba1State] = None,
                 ) -> Tuple[torch.Tensor, Optional[Mamba1State]]:
    """x: (b, l, d).  l == 1 with a state -> decode step (unless
    ``cfg.force_prefill_path``); else the prefill chain.  ``out``:
    buffers that receive the new state (with ``state`` only)."""
    b, l, _ = x.shape
    if state is not None and l == 1 and not cfg.force_prefill_path:
        return _mamba1_decode(params, cfg, x, state, out)

    init = state if state is not None else \
        mamba1_init_state(cfg, b, x.dtype, x.device)
    silu = pwl.activation("silu", cfg.xamba)
    softplus = pwl.activation("softplus", cfg.xamba)
    xs, z = torch.chunk(layers.linear(params["in_proj"], x), 2, dim=-1)
    xs, new_conv = layers.causal_conv1d(params["conv"], xs, init.conv)
    xs = silu(xs)
    dt, B, C = _mamba1_dt(params, cfg, xs, softplus)
    y, new_ssm = sscan.selective_scan(
        xs, dt, -torch.exp(params["A_log"].float()), B, C, params["D"],
        mode=cfg.scan_mode, initial_state=init.ssm, xamba=cfg.xamba,
        return_final_state=True)
    y = y * silu(z)
    h = layers.linear(params["out_proj"], y.to(x.dtype))
    if state is None:
        return h, None
    return h, _into(out, Mamba1State(new_conv.to(init.conv.dtype), new_ssm))


# ============================================================================
# RG-LRU recurrent block (recurrentgemma / Griffin)
# ============================================================================
# Griffin's fixed gate exponent (``repro.kernels.common.RG_LRU_C``).
_RG_C = 8.0


class RGLRUState(NamedTuple):
    conv: torch.Tensor   # (b, d_conv-1, lru_width), cache dtype
    h: torch.Tensor      # (b, lru_width), fp32


def rglru_specs(cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "in_x": layers.linear_specs(d, w),
        "in_gate": layers.linear_specs(d, w),
        "conv": layers.conv1d_specs(w, cfg.d_conv),
        "rg": layers.linear_specs(w, w, bias=True),
        "ig": layers.linear_specs(w, w, bias=True),
        "lam": ParamSpec((w,), init="ones", scale=1.0),
        "out": layers.linear_specs(w, d),
    }


def rglru_init_state(cfg, batch: int, dtype: torch.dtype,
                     device: torch.device) -> RGLRUState:
    return RGLRUState(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.lru_width), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                      device=device))


def rglru_kernel_operands(params: dict) -> dict:
    """The block's step operands as kernel 6 takes them: the small ones
    (conv, biases, ``lam``) contiguous fp32, the w x w gate weights as they
    are stored (the kernel widens bf16 exactly; an fp32 copy would double
    its bytes).  Built once per weight set by the model's
    ``decode_view``."""
    def f32(t):
        return t.float().contiguous()
    return {"conv_w": f32(params["conv"]["w"]),
            "conv_b": f32(params["conv"]["b"]),
            "rg_w": params["rg"]["w"].contiguous(),
            "rg_b": f32(params["rg"]["b"]),
            "ig_w": params["ig"]["w"].contiguous(),
            "ig_b": f32(params["ig"]["b"]),
            "lam": f32(params["lam"])}


def _rglru_gates(params: dict, cfg, u: torch.Tensor):
    """(a, gated input) of the recurrence from the conv output ``u`` (the
    stream dtype), in fp32: the sigmoid gates r, i through the biased
    rg / ig projections, a = exp(-8 softplus(lam) r)."""
    sigmoid = pwl.activation("sigmoid", cfg.xamba)
    softplus = pwl.activation("softplus", cfg.xamba)
    r = sigmoid(layers.linear(params["rg"], u).float())
    i = sigmoid(layers.linear(params["ig"], u).float())
    log_a = -_RG_C * softplus(params["lam"].float()) * r
    gated_in = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                          1e-12)) * (i * u.float())
    return torch.exp(log_a), gated_in


def _rglru_decode_naive(params: dict, cfg, x: torch.Tensor,
                        state: RGLRUState, out: Optional[RGLRUState]
                        ) -> Tuple[torch.Tensor, RGLRUState]:
    """The unfused dense step (the NPU-baseline op chain): seq-axis
    (b, 1, d) operands and the per-tap conv."""
    gelu = pwl.activation("gelu", cfg.xamba)
    u = layers.linear(params["in_x"], x)                     # (b, 1, w)
    gate = layers.linear(params["in_gate"], x)
    u, new_conv = layers.causal_conv1d(params["conv"], u, state.conv)
    a, gated_in = _rglru_gates(params, cfg, u)
    h_new = a[:, 0] * state.h + gated_in[:, 0]
    y = h_new[:, None].to(x.dtype) * gelu(gate)
    h = layers.linear(params["out"], y)
    return h, _into(out, RGLRUState(new_conv.to(state.conv.dtype), h_new))


def _rglru_decode(params: dict, cfg, x: torch.Tensor, state: RGLRUState,
                  out: Optional[RGLRUState]
                  ) -> Tuple[torch.Tensor, RGLRUState]:
    """Single-token step; x: (b, 1, d).  ``naive`` runs the unfused chain;
    ``cumba`` and ``pallas*`` the fused step on (b, w) operands (its
    output y = h' gelu(gate) formed in fp32 and cast once, as the TPU
    kernel forms it)."""
    if cfg.xamba.decode == "naive":
        return _rglru_decode_naive(params, cfg, x, state, out)
    u = layers.linear(params["in_x"], x[:, 0])
    gate = layers.linear(params["in_gate"], x[:, 0])
    y, new_conv, h_new = ops.rglru_decode_step(
        u, gate, state.conv, state.h,
        **_operands(params, rglru_kernel_operands), xamba=cfg.xamba, out=out)
    h = layers.linear(params["out"], y.to(x.dtype))[:, None]
    return h, RGLRUState(new_conv, h_new)


def rglru_apply(params: dict, cfg, x: torch.Tensor,
                state: Optional[RGLRUState] = None,
                out: Optional[RGLRUState] = None,
                ) -> Tuple[torch.Tensor, Optional[RGLRUState]]:
    """x: (b, l, d).  l == 1 with a state -> decode step (unless
    ``cfg.force_prefill_path``); else the prefill chain.  ``out``:
    buffers that receive the new state (with ``state`` only)."""
    b, l, _ = x.shape
    xamba = cfg.xamba
    if state is not None and l == 1 and not cfg.force_prefill_path:
        return _rglru_decode(params, cfg, x, state, out)
    gelu = pwl.activation("gelu", xamba)
    u = layers.linear(params["in_x"], x)                     # (b, l, w)
    gate = layers.linear(params["in_gate"], x)
    u, new_conv = layers.causal_conv1d(
        params["conv"], u, None if state is None else state.conv)
    a, gated_in = _rglru_gates(params, cfg, u)
    if state is None and xamba.cumba in ("pallas", "pallas_interpret"):
        h = ops.rg_lru_scan(a, gated_in)
    else:
        h0 = state.h if state is not None else \
            a.new_zeros((b, cfg.lru_width))
        h = sscan.linear_scan(a, gated_in, h0)
    y = h.to(x.dtype) * gelu(gate)
    o = layers.linear(params["out"], y)
    if state is None:
        return o, None
    return o, _into(out, RGLRUState(new_conv.to(state.conv.dtype),
                                    h[:, -1]))
