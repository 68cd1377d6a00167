"""Program registry: per-program cost cards and quality budgets (port of
``repro.serve.program_registry``).

Engines ``register()`` each program they call (the decode step, the
bucketed prefill, ``prefill_chunk``, ``verify_chunk``, the draft step,
the W8 dequant-matmul, the state pool's row ops) with the shapes of its
per-call arguments; the registry gives each a stable **program id**
(``p<N>:<name>``, the same when a name is registered again) that rides in
recompile sentinels and trace spans, so that ``launch/trace_report``
attributes wall time per program.  The ids match the JAX engine's for
the same options.

On demand, never on the serve path, :func:`build_card` builds a
**program card**, PyTorch's counterpart of the JAX package's AOT card.
It allocates fresh zero buffers of the registered shapes (the weights are
the engine's own, by reference; no live pool or cache is touched, as JAX
lowers from ``ShapeDtypeStruct``s), runs one warm call and then one
measured call under ``torch.profiler`` (on the card between two spin
kernels, and again, up to twice, when the profiler lost or misdated one:
:func:`profile_bracketed`), and reads:

* ``ops``: the device operations the measured call launched, by name and
  count (on the CPU: the profiler's top-level CPU ops, those the program
  itself called);
* ``copies`` / ``copy_bytes``: the operations the program issues that
  move or cast bytes without arithmetic (``copy_``, casts and host
  transfers through ``to`` / ``_to_copy``, ``clone``, a ``contiguous`` or
  ``reshape`` that copies), each one copy kernel or ``Memcpy`` on the
  card, counted by a dispatch mode over one more call, and the bytes they
  write;
* ``argument_bytes`` / ``output_bytes``: the bytes of the call's argument
  tensors (weights included, each storage once) and of what it returns;
* ``temp_bytes``: the peak the caching allocator reached during the
  measured call, less what was allocated before it and less its new
  outputs (``torch.cuda.reset_peak_memory_stats`` /
  ``max_memory_allocated``);
* ``device_ms``: the summed device time of the measured call's
  operations, ``None`` when the profiler lost or misdated events (see
  :func:`profile_bracketed`);
* ``roofline``: ``memory_s``, argument plus output bytes at the H100's
  3.35 TB/s.

On the CPU the device fields (``device_ms``, ``temp_bytes``,
``roofline``) are ``None`` or empty.  Fields of the JAX card with no
PyTorch counterpart are ``None``: ``flops`` and ``bytes_accessed`` (XLA's
cost analysis), ``instructions`` and ``opcodes`` (the HLO fingerprint),
``generated_code_bytes``; ``compile_s`` is the warm call's seconds.

Building a card leaves every kernel wrapper's launch counters
(``.launches``, ``.path_launches``, ``.gated_launches``) as it found
them, and records nothing into the engine's programs or sentinels: it
calls the model's functions, not the engine's :class:`TracedProgram`
wrappers.
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

MB = 2 ** 20
HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (roofline model)
# torch.profiler on the card was seen to drop the first events of a
# session (more of them as the process ages) and, in some sessions, to
# misdate device events (durations off by 0.5-1.4x): a session starts with
# PROFILE_ABSORB empty spin kernels for the profiler to drop, brackets its
# work with two spin kernels of SPIN_CYCLES, and stands only when both
# brackets are kept at their duration by CUDA events, within
# PROFILE_SPIN_TOL; else it is taken again, up to PROFILE_TRIES times
# (profile_bracketed).
PROFILE_ABSORB = 1000
PROFILE_TRIES = 3
PROFILE_SPIN_TOL = 0.1
SPIN_CYCLES = 1_000_000
SPIN = "spin_kernel"            # torch.cuda._sleep's kernel

# Budgets for the full-width decode programs, keyed on the FULL d_model so
# that reduced test configs never inherit them.  Ceilings sit above the
# good layout with headroom and far below the cliff.  The reading (the
# decode card at the continuous engine's serve shapes, b = 4, bf16 and W8,
# on an H100 80GB HBM3 at 700 W, ``chip_smoke.py`` phase 4h): 77 copies
# writing 147.85 MiB, 147.33 of them the tied unembed's fp32 cast of the
# 50288 x 768 table (``nn/layers.py: unembed``), and 147.35-148.02 MiB
# of temporaries (two calls), that cast table; mamba-130m's 77 copies,
# 147.83 and 147.33-148.02 MiB.  Headroom: +19 copies (a quarter) and
# +44 MiB (three tenths); one more cast of the table, or a copy of every
# layer's state, trips them.
DEFAULT_BUDGETS = {
    ("mamba2-130m", "decode"): {"max_copies": 96,
                                "max_temp_bytes": 192 * MB,
                                "min_d_model": 768},
    ("mamba-130m", "decode"): {"max_copies": 96,
                               "max_temp_bytes": 192 * MB,
                               "min_d_model": 768},
}

_COUNTER_DICTS = ("path_launches", "gated_launches")

# The aten ops that move or cast bytes without arithmetic.  Under
# inference mode the composite ones (``to``, ``contiguous``, ``reshape``,
# ``type_as``) reach the dispatch mode undecomposed: they count where their
# output is a new tensor.
_COPY_OPS = ("copy_", "_to_copy", "clone", "to", "contiguous", "reshape",
             "type_as")


def budget_for(cfg, program: str) -> Optional["ProgramBudget"]:
    """Default budget for ``(model config, program name)``; None for a
    reduced variant (budgets describe full-width programs)."""
    spec = DEFAULT_BUDGETS.get((getattr(cfg, "name", None), program))
    if spec is None:
        return None
    if getattr(cfg, "d_model", 0) < spec["min_d_model"]:
        return None
    return ProgramBudget(max_copies=spec["max_copies"],
                         max_temp_bytes=spec["max_temp_bytes"])


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor argument's shape, dtype and device (registration keeps
    no live buffer)."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """A numpy argument's shape and dtype (the engine's host vectors)."""
    shape: tuple
    dtype: np.dtype


def shape_args(args: Sequence[Any]) -> tuple:
    """Example arguments -> specs, leaf by leaf (tuples, lists, named
    tuples and dicts are walked); other leaves are kept as they are."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return TensorSpec(tuple(x.shape), x.dtype, x.device)
        if isinstance(x, np.ndarray):
            return ArraySpec(x.shape, x.dtype)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(leaf(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(leaf(v) for v in x)
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        return x
    return tuple(leaf(a) for a in args)


def _fresh(spec):
    """Zero buffers for a spec tree."""
    if isinstance(spec, TensorSpec):
        return torch.zeros(spec.shape, dtype=spec.dtype, device=spec.device)
    if isinstance(spec, ArraySpec):
        return np.zeros(spec.shape, spec.dtype)
    if isinstance(spec, tuple) and hasattr(spec, "_fields"):
        return type(spec)(*(_fresh(v) for v in spec))
    if isinstance(spec, (tuple, list)):
        return type(spec)(_fresh(v) for v in spec)
    if isinstance(spec, dict):
        return {k: _fresh(v) for k, v in spec.items()}
    return spec


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    else:                                   # QuantTensor's slots
        for name in getattr(type(tree), "__slots__", ()):
            yield from _tensors(getattr(tree, name, None))


def _storages(tree) -> Dict[int, int]:
    """Storage data pointer -> bytes, each storage once."""
    out: Dict[int, int] = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        out[s.data_ptr()] = s.nbytes()
    return out


def _counters() -> list:
    """Every kernel wrapper's launch counters, to restore after a card."""
    from repro_torch import kernels
    saved = []
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for fn in vars(mod).values():
            if callable(fn) and hasattr(fn, "launches"):
                saved.append((fn, fn.launches,
                              {k: dict(getattr(fn, k)) for k in
                               _COUNTER_DICTS if hasattr(fn, k)}))
    return saved


def _restore(saved) -> None:
    for fn, launches, dicts in saved:
        fn.launches = launches
        for k, v in dicts.items():
            getattr(fn, k).clear()
            getattr(fn, k).update(v)


class _CopyCounter(TorchDispatchMode):
    """Counts the copy ops a call makes and the bytes they write (a
    handler runs with the mode off, so a copy inside ``_to_copy`` is not
    counted twice)."""

    def __init__(self):
        super().__init__()
        self.copies = 0
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name == "copy_":
            dst = args[0]
        elif name in _COPY_OPS and isinstance(out, torch.Tensor) and (
                out.untyped_storage().data_ptr()
                != args[0].untyped_storage().data_ptr()):
            dst = out
        else:
            return out
        self.copies += 1
        self.nbytes += dst.numel() * dst.element_size()
        return out


@dataclasses.dataclass(frozen=True)
class ProgramBudget:
    """Quality ceilings for one program; ``None`` disables a dimension.
    The copy count catches a layout or cast regression, the temp ceiling
    an allocation blow-up the op mix cannot see."""

    max_copies: Optional[int] = None
    max_temp_bytes: Optional[int] = None

    def to_dict(self) -> dict:
        return {"max_copies": self.max_copies,
                "max_temp_bytes": self.max_temp_bytes}


@dataclasses.dataclass
class ProgramCard:
    """One program's cost and quality card (see the module docstring)."""

    name: str
    program_id: str
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    instructions: Optional[int] = None
    opcodes: Optional[int] = None
    copies: int = 0
    copy_bytes: int = 0
    compile_s: float = 0.0
    device_ms: Optional[float] = None
    ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    roofline: Dict[str, Any] = dataclasses.field(default_factory=dict)
    budget: Optional[ProgramBudget] = None

    @property
    def roofline_s(self) -> float:
        """Modelled best-case seconds per call: the binding roofline term
        (only the memory term is modelled here)."""
        return max(self.roofline.get("compute_s") or 0.0,
                   self.roofline.get("memory_s") or 0.0)

    def check_budget(self) -> List[str]:
        """Budget violations (empty = within budget, or no budget)."""
        out: List[str] = []
        b = self.budget
        if b is None:
            return out
        if b.max_copies is not None and self.copies > b.max_copies:
            out.append(
                f"program {self.name!r} ({self.program_id}): {self.copies} "
                f"copy ops exceed budget {b.max_copies}: a layout or cast "
                f"regression")
        if b.max_temp_bytes is not None and self.temp_bytes is not None \
                and self.temp_bytes > b.max_temp_bytes:
            out.append(
                f"program {self.name!r} ({self.program_id}): temp bytes "
                f"{self.temp_bytes / MB:.1f} MB exceed budget "
                f"{b.max_temp_bytes / MB:.1f} MB")
        return out

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["budget"] = self.budget.to_dict() if self.budget else None
        out["roofline_s"] = self.roofline_s
        out["budget_violations"] = self.check_budget()
        return out


def _spin_ms() -> float:
    """One bracket's milliseconds on the card by CUDA events (median of
    five)."""
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SPIN_CYCLES)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[2]


def profile_bracketed(run: Callable, activities) -> tuple:
    """Profile ``run()`` on the card between ``PROFILE_ABSORB`` empty spin
    kernels and two brackets, up to ``PROFILE_TRIES`` times, until a
    session keeps both brackets at their CUDA-event duration (every device
    event between them is then kept and dated at the right rate).
    Returns (profile, whether that session stood, how many of its
    absorbers the profiler dropped, the last ``run()``'s output).  Spin
    kernels are ``SPIN`` events in the profile."""
    from torch.profiler import profile

    spin_ms = _spin_ms()
    for _ in range(PROFILE_TRIES):
        out = None      # a retry must not hold the last try's output
        with profile(activities=activities) as prof:
            for _ in range(PROFILE_ABSORB):
                torch.cuda._sleep(0)
            torch.cuda._sleep(SPIN_CYCLES)
            out = run()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        spins = [e.duration_ns() / 1e6
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and SPIN in e.name()]
        brackets = [ms for ms in spins if ms > spin_ms / 2]
        dropped = PROFILE_ABSORB - (len(spins) - len(brackets))
        if len(brackets) == 2 and all(
                abs(ms / spin_ms - 1) <= PROFILE_SPIN_TOL for ms in brackets):
            return prof, True, dropped, out
    return prof, False, dropped, out


def build_card(name: str, program_id: str, fn: Callable, example_args,
               budget: Optional[ProgramBudget] = None,
               weights: Any = None) -> ProgramCard:
    """Run ``fn`` ([weights,] *fresh buffers of example_args) once warm,
    once under the copy counter and once under the profiler, and read the
    card (module docstring).  Leaves the kernel launch counters as it
    found them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = _fresh(example_args)
    call_args = args if weights is None else (weights,) + tuple(args)
    devices = {t.device for t in _tensors(args)}
    cuda = any(d.type == "cuda" for d in devices)
    saved = _counters()
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            fn(*call_args)
            if cuda:
                torch.cuda.synchronize()
            compile_s = time.perf_counter() - t0
            with _CopyCounter() as counted:
                fn(*call_args)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
            if cuda:
                prof, stood, _, out = profile_bracketed(
                    lambda: fn(*call_args),
                    [ProfilerActivity.CPU, ProfilerActivity.CUDA])
                peak = torch.cuda.max_memory_allocated()
            else:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    out = fn(*call_args)
    finally:
        _restore(saved)

    arg_stor = _storages(call_args)
    out_stor = _storages(out)
    new_out = sum(b for p, b in out_stor.items() if p not in arg_stor)
    events = prof.events()
    if cuda:
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and SPIN not in e.name]
        ops = Counter(e.name for e in dev)
        device_ms = (sum(e.time_range.elapsed_us() for e in dev) / 1e3
                     if stood else None)
        temp = max(0, peak - before - new_out)
        roofline = {"memory_s": (sum(arg_stor.values()) +
                                 sum(out_stor.values())) / HBM_BYTES_PER_S}
    else:
        cpu = [e for e in events if e.device_type == DeviceType.CPU
               and e.cpu_parent is None]
        ops = Counter(e.name for e in cpu)
        device_ms = temp = None
        roofline = {}
    return ProgramCard(
        name=name, program_id=program_id,
        argument_bytes=sum(arg_stor.values()),
        output_bytes=sum(out_stor.values()), temp_bytes=temp,
        copies=counted.copies, copy_bytes=counted.nbytes,
        compile_s=round(compile_s, 4), device_ms=device_ms,
        ops=dict(ops.most_common()), roofline=roofline, budget=budget)


class ProgramRegistry:
    """Name -> (program id, call recipe, budget) for every program one
    engine calls.  Registration records shapes only; cards build lazily
    and are kept until the name is registered again."""

    def __init__(self):
        self._entries: Dict[str, dict] = {}
        self._order: List[str] = []

    # -- registration ------------------------------------------------------
    def register(self, name: str, fn: Callable, example_args=None, *,
                 budget: Optional[ProgramBudget] = None,
                 weights: Any = None) -> str:
        """Register (or refresh) a program: ``fn`` called as
        ``fn([weights,] *args)``.  ``example_args`` are the per-call
        arguments, kept as specs; ``weights`` is kept by reference.
        Registering a name again keeps its id."""
        if name in self._entries:
            entry = self._entries[name]
        else:
            entry = {"id": f"p{len(self._order)}:{name}"}
            self._entries[name] = entry
            self._order.append(name)
        entry["fn"] = fn
        entry["example_args"] = (shape_args(example_args)
                                 if example_args is not None else None)
        entry["weights"] = weights
        if budget is not None or "budget" not in entry:
            entry["budget"] = budget
        entry.pop("card", None)      # recipe changed -> stale card
        return entry["id"]

    # -- lookups -----------------------------------------------------------
    def names(self) -> List[str]:
        return list(self._order)

    def program_id(self, name: str) -> Optional[str]:
        entry = self._entries.get(name)
        return entry["id"] if entry else None

    # -- cards -------------------------------------------------------------
    def card(self, name: str, rebuild: bool = False) -> ProgramCard:
        """Build (or return the kept) card of one program.  ``KeyError``
        for an unknown name, ``ValueError`` for a program registered
        without example args."""
        entry = self._entries[name]
        if not rebuild and "card" in entry:
            return entry["card"]
        if entry.get("example_args") is None:
            raise ValueError(
                f"program {name!r} registered without example args: no "
                f"shapes to build the card from")
        entry["card"] = build_card(name, entry["id"], entry["fn"],
                                   entry["example_args"],
                                   budget=entry.get("budget"),
                                   weights=entry.get("weights"))
        return entry["card"]

    def cards(self, names: Optional[Sequence[str]] = None,
              rebuild: bool = False) -> Dict[str, ProgramCard]:
        """Cards for ``names`` (default: every program with example
        args)."""
        if names is None:
            names = [n for n in self._order
                     if self._entries[n].get("example_args") is not None]
        return {n: self.card(n, rebuild=rebuild) for n in names}

    # -- budgets -----------------------------------------------------------
    def check_budgets(self, names: Optional[Sequence[str]] = None
                      ) -> List[str]:
        """Build the cards of every budgeted program and collect the
        violations (empty = all budgets hold)."""
        out: List[str] = []
        targets = names if names is not None else [
            n for n in self._order
            if self._entries[n].get("budget") is not None]
        for n in targets:
            out.extend(self.card(n).check_budget())
        return out

    def assert_budgets(self, names: Optional[Sequence[str]] = None) -> None:
        problems = self.check_budgets(names)
        if problems:
            raise RuntimeError("program budget violation(s):\n  " +
                               "\n  ".join(problems))

    def to_dict(self) -> Dict[str, dict]:
        """Every built card as plain dicts (call :meth:`cards` first)."""
        return {n: self._entries[n]["card"].to_dict()
                for n in self._order if "card" in self._entries[n]}
