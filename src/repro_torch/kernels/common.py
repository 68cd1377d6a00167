"""Argument checks and ``ctypes`` plumbing shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build

# dtype codes of the kernels' streams (and of bf16 / fp32 weights).
STREAM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float


def launcher(lib_name: str, fn_name: str, argtypes: Sequence) -> object:
    """The C launcher ``fn_name`` of library ``lib_name`` with its
    ``argtypes`` set (pointers and the stream as ``c_void_p``, so ctypes
    never cuts them to 32 bits)."""
    fn = getattr(build.library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


class Launcher:
    """:func:`launcher`, looked up at the first call and kept: the decode
    path's wrappers call their launchers once a layer per step, and the
    lookup (library, symbol, argtypes) is host time on that path."""

    __slots__ = ("args", "fn")

    def __init__(self, lib_name: str, fn_name: str, argtypes: Sequence):
        self.args = (lib_name, fn_name, argtypes)
        self.fn = None

    def __call__(self, *args) -> int:
        if self.fn is None:
            self.fn = launcher(*self.args)
        return self.fn(*args)


def check_launch(err: int, lib_name: str, what: str) -> None:
    """Raise when a launcher returned a ``cudaError_t`` other than 0."""
    if err != 0:
        name = build.library(lib_name).kernel_error_string
        name.restype = ctypes.c_char_p
        name.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({name(err).decode()})")


def stream_code(t: torch.Tensor) -> int:
    if t.dtype not in STREAM_DTYPES:
        raise TypeError(f"stream dtype {t.dtype} not supported; "
                        f"have {sorted(map(str, STREAM_DTYPES))}")
    return STREAM_DTYPES[t.dtype]


def row_stride(t: torch.Tensor, name: str) -> int:
    """Row stride (in elements) of ``t`` seen as (rows, last-dim) rows.

    The kernels take the ``in_proj`` splits (z / xbc / dt) as views into
    one projection, without a copy: each row must be contiguous and the
    leading dims must flatten onto one evenly strided row axis."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous, "
                         f"strides {t.stride()}")
    try:
        rows = t.view(-1, t.shape[-1])
    except RuntimeError as e:
        raise ValueError(f"{name}: leading dims do not flatten onto one "
                         f"row axis (shape {tuple(t.shape)}, strides "
                         f"{t.stride()})") from e
    return rows.stride(0) if rows.shape[0] > 1 else t.shape[-1]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda(device: torch.device, **tensors: torch.Tensor) -> None:
    """Every tensor on the same CUDA device."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def check_f32(what: str, **tensors: torch.Tensor) -> None:
    """Small parameters reach the kernels as contiguous fp32 (the model's
    ``decode_view`` casts them once per weight set, not per call)."""
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous fp32, got "
                             f"{t.dtype} (contiguous={t.is_contiguous()})")


def outputs(out, conv_state: torch.Tensor, ssm_state: torch.Tensor, what: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (new_conv, new_ssm) buffers a kernel writes: ``out`` when the
    caller passes its own (contiguous, shaped and typed like the incoming
    states, and not the same memory), else fresh ``torch.empty`` ones."""
    if out is None:
        return torch.empty_like(conv_state), torch.empty_like(ssm_state)
    for o, s, name in zip(out, (conv_state, ssm_state), ("conv", "ssm")):
        if o.shape != s.shape or o.dtype != s.dtype or o.device != s.device \
                or not o.is_contiguous() or o.data_ptr() == s.data_ptr():
            raise ValueError(f"{what}: out {name} must be a contiguous "
                             f"{s.dtype} {tuple(s.shape)} buffer on "
                             f"{s.device} apart from the incoming state")
    return out[0], out[1]


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream."""
    return torch._C._cuda_getCurrentRawStream(device.index)
