"""W8 weight-only quantization: int8 per-channel symmetric weights (port of
``repro.nn.quant``).

Scheme (the JAX package's):

* **per-channel symmetric**: a ``(k, n)`` linear weight stores ``q[:, j] =
  round(w[:, j] / scale[j])`` with ``scale[j] = max|w[:, j]| / 127``, an
  int8 payload and an fp32 scale row.  Rounding is half to even and the
  scale is taken in fp32, as ``jnp.round`` and the JAX code take them, so
  the same fp32 weight gives the same ``q`` and ``scale`` bits in both
  packages.
* **weight-only**: activations stay fp32 / bf16; dequantization is exact
  (``q * scale``), so the only error is the rounding at quantize time.
* **skip-list**: norms, embeddings, biases, convs and the small SSM
  parameters stay fp (``DEFAULT_SKIP``, ``DEFAULT_MIN_DIM``).

:func:`qdot` is the one place a quantized weight is applied.  On a CPU
tensor it is the JAX XLA backend's arithmetic, ``(x @ q) * scale`` in
fp32; on a CUDA tensor it is the hand-written kernel (TPU kernel 10,
``kernels/ops.py: qmatmul``) whatever the ``backend`` tag says: the tags
``xla`` / ``pallas`` / ``pallas_interpret`` are kept so configs read the
same in both packages, and no tag picks a plain version on the card.

The port's params hold the layer trunk as a per-layer list, so a weight
quantizes per layer; a JAX ``QuantTensor`` stacked over layers (``q`` (L,
k, n), ``scale`` (L, 1, n)) comes across through
``nn/params.py: from_jax_params`` as one ``QuantTensor`` per layer.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

QUANT_BACKENDS = ("xla", "pallas", "pallas_interpret")

# ``XambaConfig.quant`` mode -> backend tag.
MODE_BACKENDS = {
    "w8": "xla",
    "w8_pallas": "pallas",
    "w8_pallas_interpret": "pallas_interpret",
}

# Param-tree path components whose linear weights stay fp.
DEFAULT_SKIP = frozenset({"conv", "dt_proj", "x_proj", "router", "embed"})

# Smallest weight worth quantizing.
DEFAULT_MIN_DIM = 32


class QuantTensor:
    """int8 payload + fp32 per-channel scale for one linear weight.

    ``q``: int8 ``(..., k, n)``; ``scale``: fp32 ``(..., 1, n)``;
    ``backend``: the JAX package's execution tag (see module docstring)."""

    __slots__ = ("q", "scale", "backend")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 backend: str = "xla"):
        if backend not in QUANT_BACKENDS:
            raise ValueError(f"backend {backend!r} not in {QUANT_BACKENDS}")
        self.q = q
        self.scale = scale
        self.backend = backend

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.q.shape)

    def apply(self, fn: Callable[[torch.Tensor], torch.Tensor]
              ) -> "QuantTensor":
        """``fn`` on both leaves (a layer slice, a device move)."""
        return QuantTensor(fn(self.q), fn(self.scale), self.backend)

    def __repr__(self):
        return f"QuantTensor(shape={self.shape}, backend={self.backend!r})"


def is_quantized(x) -> bool:
    return isinstance(x, QuantTensor)


def quantize_tensor(w: torch.Tensor, backend: str = "xla") -> QuantTensor:
    """Per-channel symmetric int8 over the last axis of ``w`` (ndim >= 2),
    reduced over the contraction axis (-2) only."""
    if w.ndim < 2:
        raise ValueError(f"quantize_tensor needs ndim >= 2, got "
                         f"{tuple(w.shape)}")
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)                # (..., 1, n)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantTensor(q, scale, backend)


def dequantize(qt: QuantTensor) -> torch.Tensor:
    """Exact fp32 reconstruction of the quantized weight."""
    return qt.q.float() * qt.scale


def maybe_dequant(w):
    """Raw tensors pass through; a ``QuantTensor`` becomes fp32."""
    return dequantize(w) if is_quantized(w) else w


def roundtrip_error_bound(qt: QuantTensor) -> torch.Tensor:
    """Elementwise bound on ``|w - dequantize(quantize(w))|``: half a step
    per channel, plus float slack."""
    return 0.5 * qt.scale + 1e-6


def _should_quantize(path: Tuple[str, ...], node: dict, skip, min_dim: int
                     ) -> bool:
    w = node.get("w")
    if not isinstance(w, torch.Tensor) or w.ndim < 2:
        return False
    if any(part in skip for part in path):
        return False
    return min(w.shape[-1], w.shape[-2]) >= min_dim


def quantize_params(params: Any, *, backend: str = "xla",
                    skip: Sequence[str] = DEFAULT_SKIP,
                    min_dim: int = DEFAULT_MIN_DIM) -> Any:
    """Quantize every big linear weight (a dict's ``"w"``) of a params
    tree, per layer, unless a path component is on the skip-list or the
    weight is too small; everything else passes through."""
    if backend not in QUANT_BACKENDS:
        raise ValueError(f"backend {backend!r} not in {QUANT_BACKENDS}")
    skip = frozenset(skip)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: quantize_tensor(v, backend)
                    if k == "w" and _should_quantize(path, node, skip,
                                                     min_dim)
                    else walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        return node

    return walk(params, ())


def quantize_params_for_mode(params: Any, quant_mode: str, **kw) -> Any:
    """``XambaConfig.quant``-keyed entry point: ``"none"`` passes params
    through, the ``w8*`` modes quantize with the matching backend tag."""
    if quant_mode in (None, "none"):
        return params
    if quant_mode not in MODE_BACKENDS:
        raise ValueError(f"quant mode {quant_mode!r} not in "
                         f"{('none',) + tuple(MODE_BACKENDS)}")
    return quantize_params(params, backend=MODE_BACKENDS[quant_mode], **kw)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quant_summary(params: Any) -> Dict[str, float]:
    """Byte accounting for logging: stored bytes vs the same tree all in
    fp32 (every element at 4 bytes on that side)."""
    n_q = n_fp = 0
    bytes_q = bytes_fp = fp32_equiv = 0
    for leaf in _leaves(params):
        if is_quantized(leaf):
            n_q += 1
            bytes_q += leaf.q.numel() * leaf.q.element_size() + \
                leaf.scale.numel() * leaf.scale.element_size()
            fp32_equiv += leaf.q.numel() * 4
        else:
            n_fp += 1
            bytes_fp += leaf.numel() * leaf.element_size()
            fp32_equiv += leaf.numel() * 4
    total = bytes_q + bytes_fp
    return {"quantized_tensors": n_q, "fp_tensors": n_fp,
            "bytes": total, "bytes_fp32_equiv": fp32_equiv,
            "compression": round(fp32_equiv / total, 2) if total else 1.0}


def qdot(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """``x @ dequantize(qt)`` with the scale applied to the fp32 sums.

    ``x``: ``(..., k)``; ``qt.q``: ``(k, n)`` (one layer's weight).  On the
    CPU: fp32 out, the JAX XLA backend's arithmetic.  On the GPU: the
    kernel, out in ``x``'s dtype (as the JAX Pallas backend)."""
    if qt.q.ndim != 2:
        raise ValueError(f"qdot needs one layer's 2-D weight, got "
                         f"{qt.shape}")
    if x.is_cuda:
        # kernels/ops.py reaches this module through nn/layers.py.  The
        # (1, n) scale goes in as it is (n contiguous values), and a 2-D x
        # (the decode step's) without views: each view is host time on the
        # decode path, twice a layer a step.
        from repro_torch.kernels import ops
        if x.ndim == 2:
            return ops.qmatmul(x, qt.q, qt.scale)
        y = ops.qmatmul(x.reshape(-1, x.shape[-1]), qt.q, qt.scale)
        return y.reshape(x.shape[:-1] + (qt.q.shape[-1],))
    return torch.matmul(x.float(), qt.q.float()) * qt.scale.reshape(-1)
