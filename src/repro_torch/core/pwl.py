"""ActiBA: piecewise-linear activation tables (a copy of ``repro.core.pwl``).

The NPU's Piecewise-Linear Unit evaluates ``f(x) ~= m_k * x + c_k`` on
interval ``[x_k, x_{k+1}]`` from a lookup table of slopes and intercepts.
The port evaluates the same function in the gather-free basis form

    f(x) = m_0 * x + c_0 + sum_k (m_k - m_{k-1}) * relu(x - b_k)

which is exact for a continuous PWL function.  Tables are fitted with the
same float64 numpy code as the JAX package's, so the two packages hold
bit-identical tables; every coefficient is rounded to fp32 once, as the
JAX package's traced constants are, and the evaluation keeps its order:
``m0*x + c0``, then ``+ dm[k]*max(x - b_k, 0)`` for k ascending.

:func:`activation` returns the exact PyTorch activation or, under ActiBA,
the PWL one through ``kernels/ops.py: actiba_activate`` (the hand-written
kernel on a CUDA tensor, :func:`eval_pwl` on a CPU tensor).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PWLTable:
    """Compile-time C-LUT: interior breakpoints + per-segment slope/intercept.

    ``breakpoints`` has K-1 entries for K segments; segment 0 covers
    ``(-inf, b_0]`` and segment K-1 covers ``(b_{K-2}, inf)`` (linear
    extension outside the fitted range, as the PLU does).
    """

    name: str
    breakpoints: Tuple[float, ...]  # ascending, length K-1
    slopes: Tuple[float, ...]       # length K
    intercepts: Tuple[float, ...]   # length K

    @property
    def num_segments(self) -> int:
        return len(self.slopes)

    def basis(self) -> Tuple[np.ndarray, float, float]:
        """Basis-form coefficients ``(dm (K-1,), m0, c0)`` in float64."""
        m = np.asarray(self.slopes, np.float64)
        dm = m[1:] - m[:-1]
        return dm, float(m[0]), float(self.intercepts[0])

    def packed_f32(self) -> np.ndarray:
        """``[b_0..b_{K-2}, dm_0..dm_{K-2}, m0, c0]`` rounded to fp32 once:
        the operand the CUDA kernels read (``csrc/common.cuh: pwl_eval``)."""
        dm, m0, c0 = self.basis()
        return np.concatenate([np.asarray(self.breakpoints, np.float64), dm,
                               [m0, c0]]).astype(np.float32)


# ----------------------------------------------------------------------------
# Fitting (float64 numpy, as the JAX package's)
# ----------------------------------------------------------------------------

def _uniform_knots(lo: float, hi: float, segments: int) -> np.ndarray:
    return np.linspace(lo, hi, segments + 1)


def _adaptive_knots(fn: Callable[[np.ndarray], np.ndarray], lo: float,
                    hi: float, segments: int, grid: int = 4097) -> np.ndarray:
    """Knot density proportional to sqrt(|f''|) (equalizes per-segment error)."""
    xs = np.linspace(lo, hi, grid)
    h = xs[1] - xs[0]
    ys = fn(xs)
    d2 = np.gradient(np.gradient(ys, h), h)
    w = np.sqrt(np.abs(d2)) + 1e-6          # avoid zero density on flat spans
    cdf = np.concatenate([[0.0], np.cumsum((w[1:] + w[:-1]) * 0.5 * h)])
    cdf /= cdf[-1]
    targets = np.linspace(0.0, 1.0, segments + 1)
    knots = np.interp(targets, cdf, xs)
    knots[0], knots[-1] = lo, hi
    # De-duplicate pathological collisions.
    for i in range(1, len(knots)):
        if knots[i] <= knots[i - 1]:
            knots[i] = knots[i - 1] + 1e-6
    return knots


def fit_pwl(fn: Callable[[np.ndarray], np.ndarray], *, name: str,
            lo: float = -10.0, hi: float = 10.0, segments: int = 32,
            adaptive: bool = True) -> PWLTable:
    """Fit a continuous interpolating PWL table to ``fn`` on ``[lo, hi]``."""
    knots = (_adaptive_knots(fn, lo, hi, segments) if adaptive
             else _uniform_knots(lo, hi, segments))
    ys = fn(knots)
    slopes, intercepts = [], []
    for k in range(segments):
        x0, x1 = knots[k], knots[k + 1]
        y0, y1 = ys[k], ys[k + 1]
        m = (y1 - y0) / (x1 - x0)
        slopes.append(float(m))
        intercepts.append(float(y0 - m * x0))
    return PWLTable(name=name, breakpoints=tuple(float(b) for b in knots[1:-1]),
                    slopes=tuple(slopes), intercepts=tuple(intercepts))


# ----------------------------------------------------------------------------
# Evaluation
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _coefficients(table: PWLTable) -> Tuple[float, ...]:
    """``table.packed_f32()`` as Python floats, rounded to fp32 once per
    table (tables are few: ``get_table`` caches them too)."""
    return tuple(float(v) for v in table.packed_f32())


def eval_pwl(table: PWLTable, x: torch.Tensor) -> torch.Tensor:
    """The PWL function on a tensor in the basis form: fp32 inside, the
    output in ``x``'s dtype.  The plain version of kernel 12
    (``kernels/actiba.py``) and of the kernels' PWL epilogue."""
    tab = _coefficients(table)
    nk = table.num_segments - 1
    xf = x.float()
    y = tab[2 * nk] * xf + tab[2 * nk + 1]
    for k in range(nk):
        y = y + tab[nk + k] * torch.clamp_min(xf - tab[k], 0.0)
    return y.to(x.dtype)


def eval_pwl_reference(table: PWLTable, x: np.ndarray) -> np.ndarray:
    """Segment-indexed (LUT-style) numpy evaluation — the literal NPU PLU."""
    bps = np.asarray(table.breakpoints, np.float64)
    idx = np.searchsorted(bps, x, side="right")
    m = np.asarray(table.slopes, np.float64)[idx]
    c = np.asarray(table.intercepts, np.float64)[idx]
    return m * x + c


def pwl_error(fn: Callable[[np.ndarray], np.ndarray], table: PWLTable,
              lo: Optional[float] = None, hi: Optional[float] = None,
              n: int = 100_001) -> Dict[str, float]:
    lo = table.breakpoints[0] - 1.0 if lo is None else lo
    hi = table.breakpoints[-1] + 1.0 if hi is None else hi
    xs = np.linspace(lo, hi, n)
    exact = fn(xs)
    approx = eval_pwl_reference(table, xs)
    err = np.abs(exact - approx)
    denom = np.maximum(np.abs(exact), 1e-3)
    return {"max_abs": float(err.max()),
            "mean_abs": float(err.mean()),
            "max_rel": float((err / denom).max())}


# ----------------------------------------------------------------------------
# The activations the paper targets
# ----------------------------------------------------------------------------

def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -60, 60)))


def _np_silu(x):
    return x * _np_sigmoid(x)


def _np_softplus(x):
    return np.logaddexp(0.0, x)


def _np_gelu_tanh(x):
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3)))


_NP_FNS: Dict[str, Callable] = {
    "silu": _np_silu,
    "softplus": _np_softplus,
    "gelu": _np_gelu_tanh,
    "sigmoid": _np_sigmoid,
}

_EXACT_FNS: Dict[str, Callable] = {
    "silu": F.silu,
    "softplus": F.softplus,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
}

_TABLE_CACHE: Dict[Tuple, PWLTable] = {}


def get_table(name: str, *, segments: int = 32, lo: float = -10.0,
              hi: float = 10.0, adaptive: bool = True) -> PWLTable:
    key = (name, segments, lo, hi, adaptive)
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = fit_pwl(_NP_FNS[name], name=name, lo=lo, hi=hi,
                                    segments=segments, adaptive=adaptive)
    return _TABLE_CACHE[key]


def numpy_fn(name: str) -> Callable[[np.ndarray], np.ndarray]:
    return _NP_FNS[name]


def table_for(name: str, xamba) -> Optional[PWLTable]:
    """``name``'s table under ``xamba``, or ``None`` when ActiBA is off."""
    if xamba is None or not getattr(xamba, "actiba", False):
        return None
    return get_table(name, segments=xamba.actiba_segments,
                     lo=xamba.actiba_range[0], hi=xamba.actiba_range[1],
                     adaptive=xamba.actiba_adaptive)


def activation(name: str, xamba=None) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """``name``'s activation under the given XambaConfig: the PWL one
    (ActiBA, through ``kernels/ops.py: actiba_activate``) or the exact
    PyTorch function."""
    table = table_for(name, xamba)
    if table is None:
        return _EXACT_FNS[name]
    from repro_torch.kernels import ops

    def act(x: torch.Tensor) -> torch.Tensor:
        return ops.actiba_activate(x, table)

    return act
