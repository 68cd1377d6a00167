"""Dispatch for the port's kernels: a CUDA tensor goes to the hand-written
kernel (which launches or raises), a CPU tensor to its plain PyTorch
version.  There is no fallback from the one to the other and no mode
string that picks the plain version on the card.

Gradients.  Under grad mode, with an input that requires grad, kernels
2 (``mamba2_prefill``), 9 (``flash_attention``) and 12
(``actiba_activate``) run through their ``torch.autograd.Function``
(the kernel forward, the plain version's autograd backward, as the JAX
package's ``flash_attention`` ``custom_vjp``); every other kernel raises
``NotImplementedError`` naming itself (:func:`_no_grad`), as ``jax.grad``
of its Pallas kernel fails: none returns a detached output.  Under
``torch.inference_mode()`` or ``no_grad``, or when no input requires
grad, every kernel is called directly.

``xamba`` (an ``XambaConfig``) carries ActiBA into the fused kernels: the
kernel takes the PWL tables of its activations (SiLU and softplus; the
RG-LRU step sigmoid, softplus and GeLU), the plain version the
activations of ``core/pwl.py: activation``.

A ``meta`` tensor (the dry run's, ``launch/dryrun.py``) goes to the
kernel's wrapper as a CUDA tensor does: the wrapper allocates its
outputs and scratch, records the kernel's operations and bytes
(``kernels/cost.py``) and launches nothing.  The plain version, whose
temporaries the card never holds, runs on meta only as the backward of
kernels 2, 9 and 12.
"""
from __future__ import annotations

import torch

from repro_torch.core import pwl
from repro_torch.core.pwl import PWLTable
from repro_torch.kernels import actiba as _act, cumba as _cumba, \
    decode_step as _ds, flash_attention as _fa, matmul_pwl as _mpwl, \
    prefill_chunk as _pc, qmatmul as _qm, reduba as _red, rg_lru as _rg, \
    ssd_chunk as _ssd


def _grad_wanted(*ts) -> bool:
    """Whether a call must be differentiable: grad mode on and an input
    that requires grad (``is_grad_enabled`` first: under
    ``inference_mode`` the serve path reads nothing else)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _no_grad(kernel: str, *ts) -> None:
    """Raise when a kernel without a gradient is called under grad with an
    input that requires grad (its output would come back detached)."""
    if _grad_wanted(*ts):
        raise NotImplementedError(
            f"{kernel} has no gradient: its CUDA kernel is forward-only (as "
            f"the JAX package's Pallas kernel); call it under no_grad, or "
            f"train in a mode that does not reach it")


def _plain_into(out, res):
    """The plain version's new state copied into the caller's buffers."""
    if out is None:
        return res
    y, conv, ssm = res
    out[0].copy_(conv)
    out[1].copy_(ssm)
    return y, out[0], out[1]


def _activations(xamba, on_card: bool) -> dict:
    """The fused kernels' activation arguments under ``xamba``: tables for
    the kernel (CUDA or meta), callables for the plain version."""
    if on_card:
        return dict(silu_table=pwl.table_for("silu", xamba),
                    softplus_table=pwl.table_for("softplus", xamba))
    return dict(silu=pwl.activation("silu", xamba),
                softplus=pwl.activation("softplus", xamba))


def mamba2_decode_step(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                       dt_bias, A, D, norm_scale, *, ngroups: int,
                       head_dim: int, xamba=None, out=None):
    """Fused Mamba-2 single-token step (conv + SiLU + softplus + SSD +
    gated norm); shapes as ``kernels/decode_step.py``.  ``out`` =
    (new_conv, new_ssm) buffers that receive the new state."""
    args = (z, xbc, dt, conv_state, ssm_state, conv_w, conv_b, dt_bias, A,
            D, norm_scale)
    on_card = z.is_cuda or z.is_meta
    kw = dict(ngroups=ngroups, head_dim=head_dim,
              **_activations(xamba, on_card))
    if on_card:
        _no_grad("kernel 1 (mamba2_step)", *args)
        return _ds.mamba2_step(*args, **kw, out=out)
    return _plain_into(out, _ds.mamba2_step_plain(*args, **kw))


def mamba1_decode_step(xs_raw, z, conv_state, ssm_state, conv_w, conv_b,
                       xproj_w, dtproj_w, dtproj_b, A, D, *, dt_rank: int,
                       xamba=None, out=None):
    """Fused Mamba-1 single-token step (conv + SiLU + x_proj / dt_proj +
    softplus + selective scan + SiLU(z) gate, kernel 5); shapes as
    ``kernels/decode_step.py``.  ``out`` = (new_conv, new_ssm) buffers
    that receive the new state."""
    args = (xs_raw, z, conv_state, ssm_state, conv_w, conv_b, xproj_w,
            dtproj_w, dtproj_b, A, D)
    on_card = z.is_cuda or z.is_meta
    kw = dict(dt_rank=dt_rank, **_activations(xamba, on_card))
    if on_card:
        _no_grad("kernel 5 (mamba1_step)", *args)
        return _ds.mamba1_step(*args, **kw, out=out)
    return _plain_into(out, _ds.mamba1_step_plain(*args, **kw))


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """The bare SSD update (kernel 3) -> (new_state fp32, y)."""
    if state.is_cuda or state.is_meta:
        _no_grad("kernel 3 (ssd_step)", state, x_t, dt_t, A, B_t, C_t)
        return _ds.ssd_step(state, x_t, dt_t, A, B_t, C_t)
    return _ds.ssd_step_plain(state, x_t, dt_t, A, B_t, C_t)


def sscan_step(state, u_t, delta_t, A, B_t, C_t, D=None):
    """The bare selective-scan update (kernel 4) -> (new_state fp32, y)."""
    if state.is_cuda or state.is_meta:
        _no_grad("kernel 4 (sscan_step)", state, u_t, delta_t, A, B_t, C_t,
                 D)
        return _ds.sscan_step(state, u_t, delta_t, A, B_t, C_t, D)
    return _ds.sscan_step_plain(state, u_t, delta_t, A, B_t, C_t, D)


def mamba2_prefill(x, in_w, conv_state, ssm_state, conv_w, conv_b, dt_bias,
                   A, D, norm_scale, *, ngroups: int, head_dim: int,
                   chunk: int, xamba=None, out=None):
    """In-projection + the fused Mamba-2 prefill; returns ``(y, new_conv,
    new_ssm)`` with ``y`` the gated, pre-``out_proj`` mixer output
    (b, l, d_inner) in ``x``'s dtype.  ``out`` as for
    :func:`mamba2_decode_step`."""
    di, h, n = norm_scale.shape[-1], dt_bias.shape[-1], ssm_state.shape[-1]
    z, xbc, dt = torch.split(_pc.project_in(x, in_w),
                             [di, di + 2 * ngroups * n, h], dim=-1)
    args = (z, xbc, dt, conv_state, ssm_state, conv_w, conv_b, dt_bias, A,
            D, norm_scale)
    on_card = x.is_cuda or x.is_meta
    kw = dict(ngroups=ngroups, head_dim=head_dim, chunk=chunk,
              **_activations(xamba, on_card))
    if on_card:
        if _grad_wanted(*args):
            return _plain_into(out, _pc.Mamba2Prefill.apply(kw, *args))
        return _pc.mamba2_prefill(*args, **kw, out=out)
    return _plain_into(out, _pc.mamba2_prefill_plain(*args, **kw))


def rglru_decode_step(u, gate, conv_state, h_state, conv_w, conv_b, rg_w,
                      rg_b, ig_w, ig_b, lam, *, xamba=None, out=None):
    """Fused RG-LRU single-token step (conv + sigmoid gates + recurrence +
    GeLU output gate, kernel 6); shapes as ``kernels/decode_step.py``.
    ``out`` = (new_conv, new_h) buffers that receive the new state."""
    args = (u, gate, conv_state, h_state, conv_w, conv_b, rg_w, rg_b, ig_w,
            ig_b, lam)
    names = ("sigmoid", "softplus", "gelu")
    if u.is_cuda or u.is_meta:
        _no_grad("kernel 6 (rglru_step)", *args)
        return _ds.rglru_step(*args, out=out, **{
            f"{k}_table": pwl.table_for(k, xamba) for k in names})
    return _plain_into(out, _ds.rglru_step_plain(*args, **{
        k: pwl.activation(k, xamba) for k in names}))


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The RG-LRU recurrence h_t = a_t h_{t-1} + b_t from zero over axis 1
    (kernel 8)."""
    if a.is_cuda or a.is_meta:
        _no_grad("kernel 8 (rg_lru_scan)", a, b)
        return _rg.rg_lru_scan(a, b)
    return _rg.rg_lru_scan_plain(a, b)


def matmul_pwl(x: torch.Tensor, w: torch.Tensor, table: PWLTable,
               v=None) -> torch.Tensor:
    """ActiBA's drain-fused product ``pwl(x @ w) [* (x @ v)]`` in ``x``'s
    dtype (kernel 11); x (m, k), w / v (k, n)."""
    if x.is_cuda or x.is_meta:
        _no_grad("kernel 11 (matmul_pwl)", x, w, v)
        return _mpwl.matmul_pwl(x.contiguous(), w, table, v)
    return _mpwl.matmul_pwl_plain(x, w, table, v)


def actiba_activate(x: torch.Tensor, table: PWLTable) -> torch.Tensor:
    """ActiBA: the elementwise PWL activation (kernel 12)."""
    if x.is_cuda or x.is_meta:
        if _grad_wanted(x):
            return _act.PwlActivate.apply(table, x.contiguous())
        return _act.pwl_activate(x.contiguous(), table)
    return _act.pwl_activate_plain(x, table)


def cumba_cumsum(x: torch.Tensor) -> torch.Tensor:
    """CumBA: the cumulative sum along the trailing axis (kernel 13)."""
    if x.is_cuda or x.is_meta:
        _no_grad("kernel 13 (cumsum_last)", x)
        return _cumba.cumsum_last(x.contiguous())
    return _cumba.cumsum_last_plain(x)


def reduba_sum(x: torch.Tensor) -> torch.Tensor:
    """ReduBA: the sum over the trailing axis, as ``reduce_rows`` (kernel
    14) of the (last, rest) transpose."""
    x2 = x.reshape(-1, x.shape[-1]).t()
    if x.is_cpu:
        return _red.reduce_rows_plain(x2).reshape(x.shape[:-1])
    _no_grad("kernel 14 (reduce_rows)", x)
    out = _red.reduce_rows(x2)
    return out.reshape(x.shape[:-1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, scale=None
                    ) -> torch.Tensor:
    """Flash attention (kernel 9): q (b, hq, Lq, d), k / v (b, hkv, Lk, d)
    -> (b, hq, Lq, d) in q's dtype; masks left-aligned."""
    kw = dict(causal=causal, window=window, scale=scale)
    if q.is_cuda or q.is_meta:
        if _grad_wanted(q, k, v):
            return _fa.FlashAttention.apply(kw, q, k, v)
        return _fa.flash_attention(q, k, v, **kw)
    return _fa.flash_attention_plain(q, k, v, **kw)


def ssd_chunk(x_c, A_cum, B_c, C_c):
    """The fused SSD intra-chunk pass (kernel 7) -> (y_diag, chunk
    states), from the per-chunk prefix sums ``A_cum`` of the log decays."""
    if x_c.is_cuda or x_c.is_meta:
        _no_grad("kernel 7 (ssd_chunk)", x_c, A_cum, B_c, C_c)
        return _ssd.ssd_chunk(x_c, A_cum, B_c, C_c)
    return _ssd.ssd_chunk_plain(x_c, A_cum, B_c, C_c)


def qmatmul(x, q, scale, *, table=None, qv=None, vscale=None):
    """W8 dequant-matmul (kernel 10): ``epi((x @ q) * scale) [* ((x @ qv)
    * vscale)]`` in ``x``'s dtype; x (m, k), q / qv (k, n) int8, scale /
    vscale (n,) fp32."""
    kw = dict(table=table, qv=qv, vscale=vscale)
    if x.is_cuda or x.is_meta:
        _no_grad("kernel 10 (qmatmul)", x, scale, vscale)
        return _qm.qmatmul(x.contiguous(), q, scale, **kw)
    return _qm.qmatmul_plain(x, q, scale, **kw)
