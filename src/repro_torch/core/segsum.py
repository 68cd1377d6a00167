"""CumBA: cumulative sums and segment sums (a port of ``repro.core.segsum``).

Modes:

* ``naive``            — ``torch.cumsum`` (the DSP-like baseline);
* ``cumba``            — the triangular-mask matmul (the paper's
                         ``C = M_CumBA @ X``);
* ``pallas`` / ``pallas_interpret`` — kernel 13 (``kernels/cumba.py``)
                         through ``kernels/ops.py: cumba_cumsum``: the
                         hand-written kernel on a CUDA tensor, its plain
                         version on a CPU tensor.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30  # used instead of -inf so exp() never sees nan from inf-inf
_HALF = (torch.bfloat16, torch.float16)


def _tri_mask(t: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The CumBA mask: M[i, j] = 1 if j <= i else 0."""
    return torch.tril(torch.ones((t, t), dtype=dtype, device=device))


def cumsum(x: torch.Tensor, axis: int = -1, mode: str = "cumba"
           ) -> torch.Tensor:
    """Cumulative sum along ``axis`` under a CumBA mode."""
    if mode == "naive":
        return torch.cumsum(x, dim=axis)
    x = torch.movedim(x, axis, -1)
    if mode == "cumba":
        # out[..., i] = sum_j x[..., j] M[i, j], accumulated in fp32 for
        # half types (the JAX package's preferred_element_type).
        acc = torch.float32 if x.dtype in _HALF else x.dtype
        mask = _tri_mask(x.shape[-1], acc, x.device)
        out = torch.matmul(x.to(acc), mask.t()).to(x.dtype)
    elif mode in ("pallas", "pallas_interpret"):
        from repro_torch.kernels import ops
        out = ops.cumba_cumsum(x.contiguous())
    else:
        raise ValueError(f"unknown cumsum mode {mode!r}")
    return torch.movedim(out, -1, axis)


def segsum(a: torch.Tensor, mode: str = "cumba") -> torch.Tensor:
    """Segment sum over the trailing axis.

    ``segsum(a)[..., i, j] = sum_{k=j+1..i} a[..., k]`` for ``i >= j`` and
    ``_NEG_INF`` above the diagonal: the log of SSD's decay matrix.

    * ``naive`` is Mamba-2's Listing-1 form: broadcast ``a`` to (T, T),
      mask strictly-lower, masked cumsum down the rows (the paper's
      ``CumSum_b``).
    * ``cumba``/``pallas`` take the prefix sum once and broadcast its
      differences: ``S_ij = cs_i - cs_j``.
    """
    t = a.shape[-1]
    lower = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    if mode == "naive":
        x = a[..., :, None].expand(a.shape + (t,))         # x[..., k, j] = a_k
        strict = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=a.device), -1)
        x = torch.where(strict, x, 0.0)
        s = torch.cumsum(x, dim=-2)                        # over k
        return torch.where(lower, s, _NEG_INF)
    if mode in ("cumba", "pallas", "pallas_interpret"):
        cs = cumsum(a.float(), axis=-1, mode=mode)
        out = cs[..., :, None] - cs[..., None, :]
        return torch.where(lower, out, _NEG_INF)
    raise ValueError(f"unknown segsum mode {mode!r}")


def decay_matrix(a: torch.Tensor, mode: str = "cumba") -> torch.Tensor:
    """``L = exp(segsum(a))`` — the semiseparable decay matrix."""
    return torch.exp(segsum(a, mode=mode))
