"""Op-stream analysis of the port's programs: roofline terms, collective
accounting and per-op program fingerprints (the port of
``repro.launch.hlo_analysis``, ``make hlo-diff``).

The card runs no compiled module, so there is no HLO to parse.  What
PyTorch exposes in its place is the op stream one call issues: the
ordered aten ops and, for each hand-written kernel, the launch its
wrapper records (``kernels/cost.py``).  :func:`program_compiled` records
that stream by a ``TorchDispatchMode`` over one call of the program on
``meta`` tensors (nothing is allocated, and the kernel wrappers name
themselves on meta), each entry ``(op, output_bytes)``.  The JAX package's
fingerprints and diffs then read it as they read HLO instructions.

The collectives are the ones a mesh of ranks issued:
:func:`parse_collectives` reads the record ``distributed/collectives.py``
keeps of them (none on one card, so zeros without a record).
``buffer_assignment_stats`` reads the allocator figures of a program card
(``serve/program_registry.py: build_card``).

The port's model code is one eager program whatever ``scan_layers``
says (the flag names only the JAX package's checkpoint layout of the
trunk), so the two layouts issue the same op stream; ``main`` prints
that and exits 0 when it holds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cost

# H100 SXM peaks (NVIDIA data sheet, dense): the bf16 tensor cores and
# HBM3 (``kernels/cost.py``; the fp32 CUDA cores' 67 TFLOP/s there too).
PEAK_FLOPS = cost.BF16_TC_FLOP_PER_S     # 989e12
HBM_BW = cost.HBM_BYTES_PER_S            # 3.35e12 bytes/s
# NVLink 4, one direction of one GPU's 18 links (900 GB/s both ways; the
# same data sheet).  One card issues no collective, so its term is zero.
# (The ranks of a mesh that share one card talk through the host over
# gloo; this rate is the one a card a rank would give.)
LINK_BW = 450e9


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    operand_bytes: Dict[str, int]
    wire_bytes: Dict[str, int]
    details: List[dict]

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_wire_bytes(self) -> int:
        return sum(self.wire_bytes.values())


def parse_collectives(trace=None) -> CollectiveStats:
    """The collectives of a ``distributed/collectives.py`` record (the
    list ``collectives.recording()`` yields): per op its count, operand
    bytes and wire bytes, and one detail row a call.  No record (one
    card's op stream): none."""
    counts: Dict[str, int] = {}
    op_bytes: Dict[str, int] = {}
    wire: Dict[str, int] = {}
    details: List[dict] = []
    for rec in trace or ():
        counts[rec.op] = counts.get(rec.op, 0) + 1
        op_bytes[rec.op] = op_bytes.get(rec.op, 0) + rec.operand_bytes
        wire[rec.op] = wire.get(rec.op, 0) + rec.wire_bytes
        details.append({"op": rec.op, "axes": list(rec.axes),
                        "operand_bytes": rec.operand_bytes,
                        "wire_bytes": rec.wire_bytes})
    return CollectiveStats(counts, op_bytes, wire, details)


# ----------------------------------------------------------------------------
# Op streams and their fingerprints
# ----------------------------------------------------------------------------

def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_out_bytes(o) for o in out)
    return 0


class OpTrace(TorchDispatchMode):
    """The ordered ``(op, output_bytes)`` stream of the calls under it:
    each aten op by its overload name (``aten.mm.default``), and each
    kernel launch the meta dispatch records (``kernels/cost.py``) as
    ``kernel:<name>`` with no bytes of its own (its outputs are the
    allocations just before it), in the order they happen."""

    def __init__(self, log: list):
        super().__init__()
        self.log = log
        self.seen = 0
        self.events: List[Tuple[str, int]] = []

    def flush(self) -> None:
        for k in self.log[self.seen:]:
            self.events.append((f"kernel:{k.name}", 0))
        self.seen = len(self.log)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.flush()
        out = func(*args, **(kwargs or {}))
        self.events.append((str(func), _out_bytes(out)))
        return out


def op_fingerprint(trace: List[Tuple[str, int]]) -> Dict[str, Dict[str, int]]:
    """``{op: {"count", "bytes"}}`` over an op stream (output bytes
    summed).  Deterministic for a fixed program, so two dumps diff
    cleanly."""
    out: Dict[str, Dict[str, int]] = {}
    for op, b in trace:
        slot = out.setdefault(op, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += b
    return out


def fingerprint_diff(a: Dict[str, Dict[str, int]],
                     b: Dict[str, Dict[str, int]]) -> List[dict]:
    """Per-op rows where the two fingerprints disagree, biggest
    |count delta| first (count drift is the program-quality signal;
    byte-identical programs can still schedule very differently)."""
    rows = []
    for op in sorted(set(a) | set(b)):
        ca, cb = a.get(op, {"count": 0, "bytes": 0}), \
            b.get(op, {"count": 0, "bytes": 0})
        if ca == cb:
            continue
        rows.append({"op": op,
                     "count_a": ca["count"], "count_b": cb["count"],
                     "bytes_a": ca["bytes"], "bytes_b": cb["bytes"]})
    rows.sort(key=lambda r: (-abs(r["count_a"] - r["count_b"]),
                             -abs(r["bytes_a"] - r["bytes_b"])))
    return rows


def schedule_fingerprint(trace: List[Tuple[str, int]]
                         ) -> List[Tuple[str, int]]:
    """The ordered ``(op, output_bytes)`` sequence: the op stream itself
    (an eager program issues its ops in the order it runs them)."""
    return list(trace)


def schedule_diff(a: List[Tuple[str, int]],
                  b: List[Tuple[str, int]]) -> dict:
    """Order-sensitive comparison of two schedule fingerprints.

    ``similarity`` is difflib's ratio over the opcode sequences;
    ``first_divergence`` is the instruction index where the op streams
    first disagree (with a few ops of context from each side); ``moved``
    summarizes the largest replaced/inserted/deleted blocks — runs of
    ops one schedule has where the other has something else, which is
    where copy/bitcast insertion and fusion-boundary drift show up even
    at identical op counts and bytes."""
    import difflib

    ops_a = [op for op, _ in a]
    ops_b = [op for op, _ in b]
    sm = difflib.SequenceMatcher(a=ops_a, b=ops_b, autojunk=False)
    first = next((i for i, (x, y) in enumerate(zip(ops_a, ops_b))
                  if x != y), min(len(ops_a), len(ops_b)))
    moved = []
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        moved.append({
            "tag": tag, "at_a": i1, "at_b": j1,
            "ops_a": ops_a[i1:i2][:6], "ops_b": ops_b[j1:j2][:6],
            "len_a": i2 - i1, "len_b": j2 - j1,
            "bytes_a": sum(x for _, x in a[i1:i2]),
            "bytes_b": sum(x for _, x in b[j1:j2]),
        })
    moved.sort(key=lambda r: -(r["len_a"] + r["len_b"]))
    return {
        "n_instructions_a": len(a),
        "n_instructions_b": len(b),
        "similarity": round(sm.ratio(), 4),
        "first_divergence": first,
        "context_a": ops_a[max(0, first - 2):first + 4],
        "context_b": ops_b[max(0, first - 2):first + 4],
        "n_diff_blocks": len(moved),
        "moved": moved[:12],
    }


def buffer_assignment_stats(card) -> dict:
    """A program card's allocator figures (``build_card``: the caching
    allocator's peak on the card, None on the CPU) under the JAX
    package's keys; the fields with no PyTorch counterpart are None."""
    return {"argument_size_in_bytes": card.argument_bytes,
            "output_size_in_bytes": card.output_bytes,
            "temp_size_in_bytes": card.temp_bytes,
            "alias_size_in_bytes": None,
            "generated_code_size_in_bytes": None}


# Serve programs the analysis can run (``--program``); the names match the
# engines' program registry (``serve/program_registry.py``).
ANALYZABLE_PROGRAMS = ("decode", "prefill", "prefill_chunk", "verify_chunk")


def program_lowering(arch: str, program: str = "decode", *,
                     scan_layers: bool, reduced: bool = False,
                     slots: int = 1, max_seq: int = 64, bucket: int = 32,
                     chunk: int = 8, k: int = 4, device="meta"):
    """``(fn, example_args, model cfg)`` for an analyzable serve program
    of ``arch`` with fp32 params under the given ``scan_layers``, at the
    JAX tool's shapes (per-row positions; the decode program takes the
    model's ``decode_view``).  ``fn(*example_args)`` runs it; the first
    argument is the weights.  On ``meta`` (the default) nothing is
    allocated; on a device the params are drawn from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.params import abstract_params, init_params

    cfg = get_config(arch, reduced=reduced).replace(
        param_dtype="float32", scan_layers=scan_layers)
    model = build_model(cfg, device)
    dt, i64 = torch.float32, torch.int64
    if model.device.type == "meta":
        params = abstract_params(model.param_specs(), dt)
    else:
        params = init_params(model.param_specs(), 0, dt, model.device)
    cache = model.init_cache(slots, max_seq, dt)
    pos = np.zeros(slots, np.int64)

    def tokens(n):
        return torch.zeros((slots, n), dtype=i64, device=model.device)
    if program == "decode":
        return (model.decode_step,
                (model.decode_view(params), tokens(1), cache, pos), cfg)
    if program == "prefill":
        return (model.prefill, (params, {"tokens": tokens(bucket)}, cache),
                cfg)
    if program == "prefill_chunk":
        return (model.prefill_chunk, (params, tokens(chunk), cache, pos),
                cfg)
    if program in ("verify_chunk", "verify"):
        return model.verify_chunk, (params, tokens(k), cache, pos), cfg
    raise ValueError(f"unknown program {program!r}; analyzable: "
                     f"{', '.join(ANALYZABLE_PROGRAMS)}")


def program_compiled(arch: str, program: str = "decode", *,
                     scan_layers: bool, reduced: bool = False, **shapes
                     ) -> List[Tuple[str, int]]:
    """The op stream (``(op, output_bytes)``, :class:`OpTrace`) of one
    call of an analyzable serve program on ``meta``: what stands in for
    the compiled executable.  The call traced is the second: the first
    makes what a process allocates once (kernel 1's norm scratch)."""
    fn, ex, _ = program_lowering(arch, program, scan_layers=scan_layers,
                                 reduced=reduced, **shapes)
    with cost.counting() as log, torch.inference_mode():
        fn(*ex)
        log.clear()
        with OpTrace(log) as trace:
            fn(*ex)
        trace.flush()
    return trace.events


LAYOUTS = (("scan_stacked", True), ("per_layer", False))


def check_budgets(arch: str, program: str, reduced: bool, device) -> bool:
    """Build the program card under both layouts on ``device`` and check
    it against the registry's quality budget; returns whether every card
    is within it (a config without a budget passes)."""
    from repro_torch.serve.program_registry import (budget_for, build_card,
                                                    shape_args)
    ok = True
    for name, scan in LAYOUTS:
        fn, ex, cfg = program_lowering(arch, program, scan_layers=scan,
                                       reduced=reduced, device=device)
        budget = budget_for(cfg, program)
        card = build_card(program, f"hlo:{program}", fn, shape_args(ex[1:]),
                          budget=budget, weights=ex[0])
        temp = "n/a" if card.temp_bytes is None else \
            f"{card.temp_bytes / 1e6:.1f}MB"
        print(f"{arch}/{program} [{name}] on {device}: "
              f"copies={card.copies} temp={temp} "
              f"args={card.argument_bytes / 1e6:.1f}MB")
        if budget is None:
            print("  no budget for this config (reduced or unbudgeted "
                  "program) -- informational only")
            continue
        violations = card.check_budget()
        for v in violations:
            print(f"  BUDGET VIOLATION: {v}")
        if not violations:
            print(f"  within budget (max_copies={budget.max_copies}, "
                  f"max_temp={budget.max_temp_bytes / 1e6:.0f}MB)")
        ok = ok and not violations
    return ok


def main(argv=None):
    """``python -m repro_torch.launch.hlo_analysis --arch mamba2-130m``:
    the per-op fingerprint of the decode step's op stream under BOTH
    ``scan_layers`` settings and their diff; ``--schedule`` adds the
    order-sensitive view and the cards' allocator figures;
    ``--check-budgets`` builds the program card on ``--device`` (default
    ``cuda``) under both and checks the registry's budget, exit 1 on a
    violation."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--program", default="decode",
                    choices=ANALYZABLE_PROGRAMS,
                    help="which serve program to trace and diff")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (fast)")
    ap.add_argument("--schedule", action="store_true",
                    help="also diff op ORDER and the cards' allocator "
                         "figures, not just op counts")
    ap.add_argument("--check-budgets", action="store_true",
                    help="build the program card under BOTH layouts and "
                         "check it against the registry quality budget; "
                         "exit 1 on any violation")
    ap.add_argument("--device", default="cuda",
                    help="device of the cards (--check-budgets, "
                         "--schedule); the op streams run on meta")
    ap.add_argument("--dump", default=None,
                    help="write the two fingerprints + diff as JSON here")
    args = ap.parse_args(argv)

    if args.check_budgets:
        if not check_budgets(args.arch, args.program, args.reduced,
                             args.device):
            raise SystemExit(1)
        return None

    fps, scheds, bufs = {}, {}, {}
    for name, scan in LAYOUTS:
        trace = program_compiled(args.arch, args.program, scan_layers=scan,
                                 reduced=args.reduced)
        fps[name] = op_fingerprint(trace)
        scheds[name] = schedule_fingerprint(trace)
        total = sum(v["count"] for v in fps[name].values())
        print(f"{args.arch}/{args.program} [{name}]: {total} ops, "
              f"{len(fps[name])} distinct")
        if args.schedule:
            from repro_torch.serve.program_registry import build_card, \
                shape_args
            fn, ex, _ = program_lowering(args.arch, args.program,
                                         scan_layers=scan,
                                         reduced=args.reduced,
                                         device=args.device)
            bufs[name] = buffer_assignment_stats(build_card(
                args.program, f"hlo:{args.program}", fn, shape_args(ex[1:]),
                weights=ex[0]))
    diff = fingerprint_diff(fps["scan_stacked"], fps["per_layer"])
    sdiff = schedule_diff(scheds["scan_stacked"], scheds["per_layer"])
    if not diff and sdiff["n_diff_blocks"] == 0:
        print("\nscan_stacked and per_layer issue the same op stream: the "
              "port's eager step does not depend on scan_layers (it names "
              "only the JAX package's checkpoint layout)")
    else:
        print(f"\nop-mix drift (scan_stacked vs per_layer), "
              f"{len(diff)} differing ops:")
        print(f"{'op':<40}{'n(scan)':>9}{'n(layer)':>9}"
              f"{'MB(scan)':>10}{'MB(layer)':>10}")
        for r in diff[:20]:
            print(f"{r['op']:<40}{r['count_a']:>9}{r['count_b']:>9}"
                  f"{r['bytes_a'] / 1e6:>10.2f}{r['bytes_b'] / 1e6:>10.2f}")
    if args.schedule:
        print(f"\nschedule diff (scan_stacked vs per_layer): "
              f"similarity {sdiff['similarity']}, first divergence at op "
              f"{sdiff['first_divergence']}, {sdiff['n_diff_blocks']} "
              f"differing blocks")
        for r in sdiff["moved"][:8]:
            print(f"  {r['tag']:<8} @a{r['at_a']}/b{r['at_b']} "
                  f"len {r['len_a']}->{r['len_b']} "
                  f"bytes {r['bytes_a']}->{r['bytes_b']} "
                  f"a={r['ops_a']} b={r['ops_b']}")
        print("buffer assignment (bytes):")
        for name, _ in LAYOUTS:
            print(f"  {name}: {bufs[name]}")
    if args.dump:
        with open(args.dump, "w") as f:
            json.dump({"arch": args.arch, "program": args.program,
                       "fingerprints": fps, "diff": diff,
                       "schedule_diff": sdiff,
                       "buffer_assignment": bufs or None}, f, indent=2)
        print(f"\nwrote {args.dump}")
    return diff


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_operand_bytes: float,
                   collective_wire_bytes: float,
                   flop_per_s: float = PEAK_FLOPS) -> dict:
    """The three roofline terms in seconds, on one H100: operations at
    ``flop_per_s`` (default the bf16 tensor-core peak; the dry run passes
    its cell's blend of rates), bytes at HBM rate, collectives at the
    NVLink rate."""
    compute_s = flops_per_device / flop_per_s
    memory_s = bytes_per_device / HBM_BW
    collective_s = collective_operand_bytes / LINK_BW
    collective_wire_s = collective_wire_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s,
             "collective_wire_s": collective_wire_s}
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom
    denom = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["roofline_fraction"] = compute_s / denom if denom else 0.0
    return terms


if __name__ == "__main__":
    main()
