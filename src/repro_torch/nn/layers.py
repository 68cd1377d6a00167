"""Functional layers: linear (with an optional bias), RMSNorm, the Gemma
RMSNorm and LayerNorm, RoPE, sinusoidal positions, embeddings and the
causal depthwise conv1d (ports of ``repro.nn.layers``).

Params are plain dicts of tensors; every function keeps the JAX
package's rounding points (fp32 interiors, output cast back to the
stream dtype).

The split forms run the train step's compute over the mesh's ``model``
axis (``distributed/collectives.py: ModelGroup``; GSPMD's split of the
same products in the JAX package), each on the list of pieces this
process computes: :func:`linear_column` (the output dim split),
:func:`linear_row` (the input dim split, the partial products summed
over ``model``), :func:`embed_split` and :func:`unembed_split` (the
vocab rows split).  JAX rounds ``x @ w`` once from fp32 sums: a product
whose every sum is whole (the column form's output, the row form's input
gradient, every weight gradient) rounds once; a partial sum (the row
form's output, the column form's input gradient) is kept in fp32, added
over ``model`` in fp32 and cast once; a bias is added once, after the
sum.  The column form and the logits run in :class:`_Product` (the
forward in the stream dtype, as :func:`linear`); the row form in fp32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.nn import quant
from repro_torch.nn.params import ParamSpec


def linear_specs(d_in: int, d_out: int, *, axes=("embed", "mlp"),
                 bias: bool = False) -> dict:
    specs = {"w": ParamSpec((d_in, d_out), axes)}
    if bias:
        specs["b"] = ParamSpec((d_out,), (axes[1],), init="zeros")
    return specs


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype; a quantized weight (``nn/quant.py``)
    goes through ``quant.qdot``.  With a bias ``b`` the product is taken
    in fp32, the bias added in fp32 and the sum cast once, as the JAX
    package does (``repro/nn/layers.py:33-45``); without one,
    ``torch.matmul`` in the stream dtype rounds its fp32 sums once too."""
    w = p["w"]
    if quant.is_quantized(w):
        y = quant.qdot(x, w)
    elif "b" in p:
        y = torch.matmul(x.float(), w.float())
    else:
        return torch.matmul(x, w.to(x.dtype))
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(x.dtype)


def _float_weight(w):
    if quant.is_quantized(w):
        raise NotImplementedError("W8 weights serve only: the split train "
                                  "step takes float weights")
    return w


def _f32_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``a`` (..., k), ``b`` (k, n), one dtype) returned as its
    fp32 sums, unrounded: bf16 operands on the card through cuBLAS's GEMM
    with an fp32 output (the tensor cores' fp32 accumulators), any other
    on fp32 copies (the products of bf16 values are exact in fp32)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.view(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


class _Product(torch.autograd.Function):
    """``x @ w`` of one rank's piece of a column-parallel product, both
    taken in ``dtype``: ``apply(x, w, dtype, f32_out)``.  The output is
    its fp32 sums (``f32_out``: a product a bias joins, or the logits) or
    rounded once to ``dtype``; ``x``'s gradient is the rank's partial, its
    fp32 sums unrounded (``ModelGroup.copy`` adds the ranks' in fp32),
    returned in ``x``'s dtype; ``w``'s is a whole sum over the tokens,
    rounded once in ``dtype`` and returned in ``w``'s.  Saves ``x`` and
    ``w`` as given, no widened copies."""

    @staticmethod
    def forward(ctx, x, w, dtype, f32_out):
        ctx.save_for_backward(x, w)
        ctx.dtype = dtype
        xd, wd = x.to(dtype), w.to(dtype)
        return _f32_sums(xd, wd) if f32_out else torch.matmul(xd, wd)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dt = ctx.dtype
        xd, wd, gd = x.to(dt), w.to(dt), g.to(dt)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _f32_sums(gd, wd.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(xd.reshape(-1, xd.shape[-1]).t(),
                              gd.reshape(-1, gd.shape[-1])).to(w.dtype)
        return dx, dw, None, None


def linear_column(p: dict, xs, group, n: int, dtype) -> list:
    """Column-parallel :func:`linear`: ``xs`` each rank's input in fp32
    (``group.copy(x.float())``: the ranks' partial input gradients then
    add in fp32 and round once), ``p``'s ``w`` (and ``b``) held split
    along the output dim of ``n`` -> each rank's output columns in
    ``dtype``, each a whole sum rounded once (with a bias, the fp32 sums
    plus the bias, cast once)."""
    ws = group.held(_float_weight(p["w"]), 1, n)
    bs = group.held(p["b"], 0, n) if "b" in p else [None] * len(ws)
    out = []
    for x, w, b in zip(xs, ws, bs):
        y = _Product.apply(x, w, dtype, b is not None)
        if b is not None:
            y = (y + b.float()).to(dtype)
        out.append(y)
    return out


def linear_row(p: dict, parts, group, n: int) -> torch.Tensor:
    """Row-parallel :func:`linear`: ``parts`` each rank's columns of the
    input, ``p``'s ``w`` held split along the input dim of ``n`` -> the
    whole output on every rank, the fp32 partial products summed over
    ``model`` in rank order, the bias added, cast once.  The partial
    products are fp32 GEMMs on widened operands, autograd's own: under
    ``remat`` the recompute of a layer stops before its last product, as
    in the whole step, where a custom Function's forward would run
    again."""
    ws = group.held(_float_weight(p["w"]), 0, n)
    y = group.reduce([torch.matmul(x.float(), w.float())
                      for x, w in zip(parts, ws)])
    if "b" in p:
        y = y + p["b"].float()
    return y.to(parts[0].dtype)


def norm_specs(d: int, *, norm_type: str = "rmsnorm") -> dict:
    """The Gemma RMSNorm stores ``scale - 1``, so it starts at zeros;
    LayerNorm adds a ``bias`` (zeros)."""
    specs = {"scale": ParamSpec((d,), ("embed",), init="zeros"
                                if norm_type == "gemma_rmsnorm" else "ones")}
    if norm_type == "layernorm":
        specs["bias"] = ParamSpec((d,), ("embed",), init="zeros")
    return specs


def norm(p: dict, x: torch.Tensor, *, norm_type: str = "rmsnorm",
         eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (``gemma_rmsnorm``: scale + 1) or LayerNorm (the mean and
    the biased variance, then scale and bias) with an fp32 interior; the
    output is cast back."""
    if norm_type not in ("rmsnorm", "gemma_rmsnorm", "layernorm"):
        raise NotImplementedError(f"norm_type {norm_type!r} is not ported")
    xf = x.float()
    if norm_type == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        xc = xf - mu
        var = torch.mean(xc * xc, dim=-1, keepdim=True)
        return (xc * torch.rsqrt(var + eps) * p["scale"].float()
                + p["bias"].float()).to(x.dtype)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    scale = p["scale"].float()
    if norm_type == "gemma_rmsnorm":
        scale = scale + 1.0
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


_ROPE_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    """The JAX package's fp32 frequencies (computed in numpy, as it does),
    moved to ``device`` once: a copy to the card waits for its stream."""
    key = (half, float(theta), torch.device(device))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        freqs = _ROPE_FREQS[key] = torch.from_numpy(
            1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
        ).to(device)
    return freqs


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding, the half-split form: x (..., seq, heads,
    head_dim); positions (..., seq).  Angles and the rotation in fp32,
    the output cast back."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, theta, x.device)
    angles = positions.float()[..., None] * freqs       # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


_SIN_INV: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def _sin_inv(d: int, base: float, device) -> torch.Tensor:
    """The sinusoids' (d/2,) inverse frequencies, computed in numpy fp32
    as the JAX package computes them, moved to ``device`` once (as
    :func:`_rope_freqs`)."""
    key = (d, float(base), torch.device(device))
    inv = _SIN_INV.get(key)
    if inv is None:
        inv = _SIN_INV[key] = torch.from_numpy(
            1.0 / (base ** (np.arange(0, d, 2, dtype=np.float32) / d))
        ).to(device)
    return inv


def _sin_cos(ang: torch.Tensor) -> torch.Tensor:
    """(..., d/2) angles -> (..., d): sin and cos interleaved per pair."""
    return torch.stack([torch.sin(ang), torch.cos(ang)],
                       dim=-1).reshape(ang.shape[:-1] + (-1,))


def sinusoidal_positions(seq: int, d: int, base: float = 1e4,
                         device=None) -> torch.Tensor:
    """(seq, d) fp32 sinusoidal table: position p's angles p * inv in
    fp32, ``[sin, cos]`` interleaved per pair."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    return _sin_cos(pos * _sin_inv(d, base, pos.device)[None, :])


def sinusoidal_position_at(index, d: int, base: float = 1e4
                           ) -> torch.Tensor:
    """(d,) fp32 sinusoidal embedding of one position ``index`` (an int,
    or a 0-d tensor, whose device it takes)."""
    idx = torch.as_tensor(index).float()
    return _sin_cos(idx * _sin_inv(d, base, idx.device))


def sinusoidal_positions_at(positions: torch.Tensor, d: int,
                            base: float = 1e4) -> torch.Tensor:
    """(..., d) fp32 sinusoidal embeddings of a tensor of positions (a
    prefill chunk's absolute positions), on its device."""
    ang = positions.float()[..., None] * _sin_inv(d, base, positions.device)
    return _sin_cos(ang)


def embed_specs(vocab: int, d: int) -> dict:
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), scale=0.02)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied logits ``x @ table^T`` accumulated and returned in fp32."""
    table = p["table"].to(x.dtype)
    return torch.matmul(x.float(), table.float().t())


def embed_split(p: dict, tokens: torch.Tensor, group,
                vocab: int) -> torch.Tensor:
    """Vocab-parallel :func:`embed`: each rank looks up the tokens of its
    vocab rows and zeroes the rest; the rows summed over ``model`` (one
    term of each sum is not zero, so the sum is exact)."""
    parts = []
    for t, off in zip(group.held(p["table"], 0, vocab),
                      group.offsets(vocab)):
        idx = tokens - off
        mine = (idx >= 0) & (idx < t.shape[0])
        rows = t[idx.clamp(0, t.shape[0] - 1)]
        parts.append(torch.where(mine[..., None], rows, rows.new_zeros(())))
    return group.reduce(parts)


def unembed_split(p: dict, x: torch.Tensor, group, vocab: int) -> list:
    """Vocab-parallel :func:`unembed`: each rank's logits over its vocab
    rows, fp32 as :func:`unembed` takes them (x's gradient as
    :func:`linear_column`'s: the ranks' fp32 partials summed, then rounded
    once; over half the vocab a partial can be far larger than the sum).
    The table's pieces are widened inside :class:`_Product`, not kept."""
    return [_Product.apply(xc, t.to(x.dtype).t(), torch.float32, True)
            for xc, t in zip(group.copy(x.float()),
                             group.held(p["table"], 0, vocab))]


def conv1d_specs(d: int, width: int) -> dict:
    return {"w": ParamSpec((width, d), (None, "mlp"), scale=0.5),
            "b": ParamSpec((d,), ("mlp",), init="zeros")}


def causal_conv1d(p: dict, x: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, d); state: (b, width-1, d), the incoming tail (zeros when
    ``None``).  Returns (y (b, l, d), new_state (b, width-1, d))."""
    width = p["w"].shape[0]
    l = x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (b, l+w-1, d)
    w = p["w"].float()
    y = sum(xp[:, i:i + l].float() * w[i] for i in range(width))
    y = y + p["b"].float()
    return y.to(x.dtype), xp[:, l:]


def causal_conv1d_step(p: dict, x: torch.Tensor, state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of :func:`causal_conv1d` without the seq axis.

    x: (b, d); state: (b, width-1, d).  Returns (y (b, d), new_state).
    """
    win = torch.cat([state.to(x.dtype), x[:, None]], dim=1)  # (b, width, d)
    y = torch.sum(win.float() * p["w"].float()[None], dim=1) + p["b"].float()
    return y.to(x.dtype), win[:, 1:]
