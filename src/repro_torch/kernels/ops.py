"""Dispatch for the port's kernels: a CUDA tensor goes to the hand-written
kernel (which launches or raises), a CPU tensor to its plain PyTorch
version.  There is no fallback from the one to the other and no mode
string that picks the plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_step as _ds, prefill_chunk as _pc


def _plain_into(out, res):
    """The plain version's new state copied into the caller's buffers."""
    if out is None:
        return res
    y, conv, ssm = res
    out[0].copy_(conv)
    out[1].copy_(ssm)
    return y, out[0], out[1]


def mamba2_decode_step(z, xbc, dt, conv_state, ssm_state, conv_w, conv_b,
                       dt_bias, A, D, norm_scale, *, ngroups: int,
                       head_dim: int, out=None):
    """Fused Mamba-2 single-token step (conv + SiLU + softplus + SSD +
    gated norm); shapes as ``kernels/decode_step.py``.  ``out`` =
    (new_conv, new_ssm) buffers that receive the new state."""
    args = (z, xbc, dt, conv_state, ssm_state, conv_w, conv_b, dt_bias, A,
            D, norm_scale)
    if z.is_cuda:
        return _ds.mamba2_step(*args, ngroups=ngroups, head_dim=head_dim,
                               out=out)
    return _plain_into(out, _ds.mamba2_step_plain(
        *args, ngroups=ngroups, head_dim=head_dim))


def mamba2_prefill(x, in_w, conv_state, ssm_state, conv_w, conv_b, dt_bias,
                   A, D, norm_scale, *, ngroups: int, head_dim: int,
                   chunk: int, out=None):
    """In-projection + the fused Mamba-2 prefill; returns ``(y, new_conv,
    new_ssm)`` with ``y`` the gated, pre-``out_proj`` mixer output
    (b, l, d_inner) in ``x``'s dtype.  ``out`` as for
    :func:`mamba2_decode_step`."""
    di, h, n = norm_scale.shape[-1], dt_bias.shape[-1], ssm_state.shape[-1]
    z, xbc, dt = torch.split(_pc.project_in(x, in_w),
                             [di, di + 2 * ngroups * n, h], dim=-1)
    args = (z, xbc, dt, conv_state, ssm_state, conv_w, conv_b, dt_bias, A,
            D, norm_scale)
    kw = dict(ngroups=ngroups, head_dim=head_dim, chunk=chunk)
    if x.is_cuda:
        return _pc.mamba2_prefill(*args, **kw, out=out)
    return _plain_into(out, _pc.mamba2_prefill_plain(*args, **kw))
