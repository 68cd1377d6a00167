"""The dry run of one card: does an (arch x shape) cell fit the H100's
memory, with how many microbatches, and what are its FLOPs, bytes and
roofline terms?  Nothing is allocated (the port of
``repro.launch.dryrun``).

For each cell the model is built on ``meta``; its arguments are
``train/step.py: abstract_state`` (train cells) or the params and
``configs/shapes.py: abstract_cache`` (prefill and decode), plus the
shape's inputs (``configs/shapes.py``).  One step (``train_step``,
``prefill`` or ``decode_step``, as :func:`_lower_cell` picks) runs on
those meta tensors under ``core/accounting.unroll_inner_scans()`` and
three counters:

1. live bytes (:class:`LiveBytes`): each storage's bytes from its
   allocation to its free (views share a storage and count once) ->
   ``argument_bytes``, ``output_bytes``, ``temp_bytes`` (the peak less
   the arguments) and ``total_bytes``;
2. FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` for the aten
   products, plus each kernel's operations (``kernels/cost.py``; the
   kernel dispatches record them on meta, ``kernels/ops.py``);
3. bytes accessed: each aten op's inputs and outputs (views and
   allocations move nothing and are skipped), plus each kernel's bytes.

On meta the kernel wrappers allocate what they allocate on the card,
record their cost and launch nothing; the plain versions never run
(but as a backward), so the counts describe the program the card runs.
Train cells retry with 1, 2, 4 and 8 microbatches until the step fits
``hbm_bytes`` (the card's ``total_memory`` when a card is present, else
:data:`H100_HBM_BYTES`); a run stops at the op that takes its live bytes
past the budget.  A cell that never fits is costed as the JAX dry run
costs every cell, at one and two layers extrapolated over the stack
(``acct_mode`` ``"marginal"``).
``--mesh multi`` is recorded as skipped (:data:`MULTI_SKIP`): its cells
wait for a per-device count of compute split over ``model``.

Run one cell:   python -m repro_torch.launch.dryrun --arch mamba2-130m \\
                    --shape decode_32k
Run the matrix: python -m repro_torch.launch.dryrun --all --jobs 2
(records under ``build/dryrun/``, one JSON file a cell).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, shapes as shp
from repro_torch.configs.registry import ASSIGNED, list_archs
from repro_torch.core import accounting
from repro_torch.distributed.sharding import make_shardings
from repro_torch.kernels import cost
from repro_torch.launch import flops as flops_mod, hlo_analysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.nn.params import abstract_params, count_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, abstract_state, make_train_step

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun"
# ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
# 80GB HBM3 (700 W, torch 2.11.0+cu128; ``chip_smoke.py`` phase 4m prints
# it): the budget a cell is held to where no card is present.
H100_HBM_BYTES = 85_017_493_504
# The CUDA caching allocator hands out blocks in multiples of 512 bytes.
ALLOC_GRANULE = 512
MICROBATCHES = (1, 2, 4, 8)
MULTI_SKIP = ("--mesh multi: a cell of the (pod, data, model) mesh is "
              "counted per device, which needs the per-device count of "
              "compute split over the model axis (the next slice); the "
              "ranks of a mesh run today, and compute the same rows "
              "along model")
# Ops that allocate or re-view a storage and move no bytes.
_NO_BYTES = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default,
             torch.ops.aten.new_empty.default}


def _tensors(tree):
    """The tensors of a tree (dicts, lists, tuples and named tuples)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def storages(tree) -> dict:
    """Storage key -> bytes, each storage once (a storage's key is its
    ``_cdata``: the Python wrapper ``untyped_storage()`` returns is not
    the identity)."""
    out = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        out[s._cdata] = s.nbytes()
    return out


def alloc_bytes(sizes) -> int:
    """The bytes the caching allocator reserves for storages of these
    sizes (each rounded up to :data:`ALLOC_GRANULE`)."""
    return sum(-(-n // ALLOC_GRANULE) * ALLOC_GRANULE for n in sizes)


class PastBudget(Exception):
    """Raised by :class:`LiveBytes` once its live bytes pass its limit."""


class LiveBytes(TorchDispatchMode):
    """Live storage bytes on ``device`` over the ops run under it: a
    storage counts from the first op that returns it until it is freed
    (``weakref.finalize`` on the storage's Python object, which PyTorch
    keeps for the storage's life), each storage once; ``peak`` is the
    most at once.  Also sums each op's input and output bytes
    (``bytes_accessed``).  With a ``limit`` it raises :class:`PastBudget`
    at the op that takes the live bytes past it."""

    def __init__(self, args, device="meta", limit: Optional[int] = None):
        super().__init__()
        self.device = torch.device(device)
        self.live = dict(storages(args))
        self.args = dict(self.live)
        self.now = self.peak = sum(self.live.values())
        self.limit = limit
        self.bytes_accessed = 0

    def _free(self, key):
        self.now -= self.live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            return
        s = t.untyped_storage()
        key, n = s._cdata, s.nbytes()
        if key in self.live:
            self.now += n - self.live[key]      # a resize
            self.live[key] = n
        else:
            self.live[key] = n
            self.now += n
            weakref.finalize(s, self._free, key)
        if self.now > self.peak:
            self.peak = self.now
            if self.limit is not None and self.now > self.limit:
                raise PastBudget(self.now)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        for t in outs:
            self._track(t)
        if func not in _NO_BYTES and not getattr(func, "is_view", False):
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in (*_tensors(args), *_tensors(kwargs), *outs))
        return out


def count_step(fn, args, device="meta", limit: Optional[int] = None
               ) -> dict:
    """Run ``fn(*args)`` once under the three counters; returns the
    memory, FLOP and byte counts and the kernels' records.  With a
    ``limit`` the run stops at the op whose output takes the live bytes
    past it: ``complete`` is then false, ``total_bytes`` the bytes live
    at that op (a lower bound of the step's peak) and ``output_bytes``
    ``None``."""
    live = LiveBytes(args, device, limit)
    flop_counter = FlopCounterMode(display=False)
    out_stor, complete = {}, True
    with accounting.unroll_inner_scans(), cost.counting() as kernels, \
            flop_counter, live:
        try:
            out_stor = storages(fn(*args))
        except PastBudget:
            complete = False
    new_out = {k: n for k, n in out_stor.items() if k not in live.args}
    arg_b = sum(live.args.values())
    return {
        "complete": complete,
        "argument_bytes": arg_b,
        "argument_alloc_bytes": alloc_bytes(live.args.values()),
        "output_bytes": sum(new_out.values()) if complete else None,
        "temp_bytes": live.peak - arg_b,
        "total_bytes": live.peak,
        "aten_flops": float(flop_counter.get_total_flops()),
        "aten_bytes": float(live.bytes_accessed),
        "kernels": kernels,
    }


def hbm_bytes() -> int:
    """The budget a cell is held to: the card's memory, else the H100's
    as an H100 80GB HBM3 reports it."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_HBM_BYTES


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def step_fn(model, shape, train_cfg, mesh=None):
    """The step a cell runs: ``train_step(state, batch)``,
    ``prefill(params, batch, cache)`` or ``decode(params, token, cache)``
    (at the cache's last position), on whatever device the model is."""
    if shape.kind == "train":
        return make_train_step(model, train_cfg, mesh)
    if shape.kind == "prefill":
        def prefill(params, batch, cache):
            with torch.no_grad():
                return model.prefill(params, batch, cache)
        return prefill

    def decode(params, token, cache):
        with torch.no_grad():
            return model.decode_step(params, token, cache,
                                     shape.seq_len - 1)
    return decode


def abstract_args(model, cfg, shape, train_cfg) -> tuple:
    """The arguments of :func:`step_fn` on ``meta`` (``model`` built
    there)."""
    if shape.kind == "train":
        return (abstract_state(model, train_cfg),
                shp.batch_inputs(cfg, shape))
    params = abstract_params(model.param_specs(), cfg.dtype)
    cache = shp.abstract_cache(model, cfg, shape, cfg.dtype)
    if shape.kind == "prefill":
        return params, shp.prefill_inputs(cfg, shape), cache
    return params, shp.decode_inputs(cfg, shape)["token"], cache


def _lower_cell(cfg, shape, mesh, model, train_cfg):
    """The step of a cell and its abstract arguments: (fn, args,
    sharding report)."""
    _, report = make_shardings(model.param_specs(), mesh)
    return (step_fn(model, shape, train_cfg, mesh),
            abstract_args(model, cfg, shape, train_cfg), report)


def opt_config(total_params: int) -> AdamWConfig:
    """The JAX package's optimizer dtype policy: >64B-param archs
    (grok-1) hold Adam moments in bf16."""
    md = "bfloat16" if total_params > 64e9 else "float32"
    return AdamWConfig(m_dtype=md, v_dtype=md)


def _totals(cfg, counts) -> dict:
    """A count's cost figures: FLOPs and bytes (aten ops plus kernels),
    seconds at peak (aten products at the rate of the model's dtype, each
    kernel's at its design's rate, ``kernels/cost.py``) and launches by
    kernel."""
    kern = counts["kernels"]
    launches: dict = {}
    for k in kern:
        launches[k.name] = launches.get(k.name, 0) + 1
    kernel_flops = sum(k.ops for k in kern)
    kernel_bytes = sum(k.nbytes for k in kern)
    return {"flops": counts["aten_flops"] + kernel_flops,
            "bytes": counts["aten_bytes"] + kernel_bytes,
            "aten_flops": counts["aten_flops"],
            "kernel_flops": kernel_flops, "kernel_bytes": kernel_bytes,
            "compute_s": counts["aten_flops"] / cost.rate_of(cfg.dtype)
            + sum(k.ops / k.flop_per_s for k in kern),
            "launches": launches}


def _marginal(cfg, shape, mesh, train_cfg) -> Tuple[dict, dict]:
    """The cost of a step whose run stopped at the budget, as the JAX dry
    run counts every cell: the step at ``base`` and ``base + period``
    layers, extrapolated linearly over the stack (exact for a stack of
    identical layers; whisper's encoder follows its decoder).  Returns
    (totals, the ``acct_*`` keys)."""
    if cfg.family == "recurrentgemma":
        base_l, period = 2, len(cfg.block_pattern or ("r", "r", "a"))
    else:
        base_l, period = 1, 1

    def measure(n_layers):
        kw = {"n_layers": n_layers}
        if cfg.family == "whisper":
            kw["encoder_layers"] = n_layers
        cfg_a = cfg.replace(**kw)
        model_a = build_model(cfg_a, "meta")
        fn, args, _ = _lower_cell(cfg_a, shape, mesh, model_a, train_cfg)
        return _totals(cfg_a, count_step(fn, args))

    if cfg.n_layers <= base_l + period:
        return measure(cfg.n_layers), {"acct_mode": "full"}
    lo, hi = measure(base_l), measure(base_l + period)
    n = (cfg.n_layers - base_l) // period

    def extrap(a, b):
        if isinstance(a, dict):
            return {k: extrap(a.get(k, 0), b.get(k, 0))
                    for k in set(a) | set(b)}
        return a + n * (b - a)
    return extrap(lo, hi), {"acct_mode": "marginal",
                            "acct_layers": [base_l, base_l + period],
                            "n_periods": n}


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single",
             overrides=None, shape: Optional[shp.ShapeSpec] = None) -> dict:
    """One cell's record (module docstring).  ``shape`` stands in for
    ``SHAPES[shape_name]`` (a cell outside the assigned four).

    Each microbatch count's run stops once its live bytes pass the
    budget (the cell does not fit at that count).  A cell that fits
    takes its cost from the run that fitted (``acct_mode`` ``"full"``);
    one that never fits takes the cost of its last count from
    :func:`_marginal`."""
    t0 = time.time()
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape or shp.SHAPES[shape_name]
    skip = shp.applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": shape.kind, "ok": False}
    if mesh_kind == "multi":
        skip = skip or MULTI_SKIP
    if skip:
        rec.update(ok=True, skipped=True, skip_reason=skip)
        return rec

    mesh = make_mesh((1, 1), ("data", "model"))
    model = build_model(cfg, "meta")
    total_params = count_params(model.param_specs())
    rec["params"] = total_params
    opt_cfg = opt_config(total_params)
    budget = hbm_bytes()
    mb_candidates = MICROBATCHES if shape.kind == "train" else (1,)
    for mb in mb_candidates:
        train_cfg = TrainConfig(optimizer=opt_cfg, microbatches=mb)
        fn, args, report = _lower_cell(cfg, shape, mesh, model, train_cfg)
        t1 = time.time()
        counts = count_step(fn, args, limit=budget)
        rec["sharding_fallbacks"] = report.fallbacks
        rec["count_s"] = round(time.time() - t1, 2)
        mem = {k: counts[k] for k in ("argument_bytes",
                                      "argument_alloc_bytes",
                                      "output_bytes", "temp_bytes",
                                      "total_bytes", "complete")}
        mem["alias_bytes"] = 0
        mem["total_gb"] = round(mem["total_bytes"] / 2**30, 3)
        mem["hbm_bytes"] = budget
        mem["fits_hbm"] = counts["complete"]
        mem["microbatches"] = mb
        rec["memory"] = mem
        if mem["fits_hbm"]:
            break

    if counts["complete"]:
        tot, acct = _totals(cfg, counts), {"acct_mode": "full"}
    else:
        t1 = time.time()
        tot, acct = _marginal(cfg, shape, mesh, train_cfg)
        rec["count_acct_s"] = round(time.time() - t1, 2)
    flops, nbytes = tot["flops"], tot["bytes"]
    rec["cost"] = {"flops_per_device": flops, "bytes_per_device": nbytes,
                   "aten_flops": tot["aten_flops"],
                   "kernel_flops": tot["kernel_flops"],
                   "kernel_bytes": tot["kernel_bytes"],
                   "kernel_launches": tot["launches"], **acct}
    coll = hlo_analysis.parse_collectives()
    rec["collectives"] = {"counts": coll.counts,
                          "total_operand_bytes": coll.total_operand_bytes,
                          "total_wire_bytes": coll.total_wire_bytes}
    compute_s = tot["compute_s"]
    terms = hlo_analysis.roofline_terms(
        flops, nbytes, coll.total_operand_bytes, coll.total_wire_bytes,
        flop_per_s=flops / compute_s if compute_s else
        hlo_analysis.PEAK_FLOPS)
    mf = flops_mod.model_flops(cfg, shape, total_params)
    terms["model_flops"] = mf
    terms["hlo_flops_global"] = flops
    terms["useful_ratio"] = mf / flops if flops else 0.0
    rec["roofline"] = terms
    rec["chips"] = 1
    rec["device"] = "meta"
    rec["ok"] = True
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

def cell_path(out_dir: Path, arch, shape, mesh_kind, tag="") -> Path:
    suffix = f"-{tag}" if tag else ""
    return out_dir / f"{arch}__{shape}__{mesh_kind}{suffix}.json"


def _write(path: Path, rec: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))


def run_matrix(archs, shape_names, mesh_kinds, out_dir: Path, jobs: int,
               skip_existing: bool, tag: str = "", extra_args=()):
    """Every (arch, shape, mesh) cell, ``jobs`` subprocesses at a time;
    skips (``applicable``, ``--mesh multi``) are written without one.
    Returns the number of failed cells."""
    cells = []
    for arch in archs:
        cfg = get_config(arch)
        for sname in shape_names:
            for mk in mesh_kinds:
                p = cell_path(out_dir, arch, sname, mk, tag)
                reason = shp.applicable(cfg, shp.SHAPES[sname]) or (
                    MULTI_SKIP if mk == "multi" else None)
                if reason:
                    _write(p, {"arch": arch, "shape": sname, "mesh": mk,
                               "kind": shp.SHAPES[sname].kind, "ok": True,
                               "skipped": True, "skip_reason": reason})
                    continue
                if skip_existing and p.exists():
                    try:
                        if json.loads(p.read_text()).get("ok"):
                            continue
                    except json.JSONDecodeError:
                        pass
                cells.append((arch, sname, mk, p))

    print(f"[dryrun] {len(cells)} cells to run, jobs={jobs}", flush=True)
    running, idx, failures = [], 0, 0
    while idx < len(cells) or running:
        while idx < len(cells) and len(running) < jobs:
            arch, sname, mk, p = cells[idx]
            idx += 1
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", sname, "--mesh", mk,
                   "--out", str(out_dir)]
            if tag:
                cmd += ["--tag", tag]
            cmd += list(extra_args)
            p.parent.mkdir(parents=True, exist_ok=True)
            with p.with_suffix(".log").open("w") as log:
                proc = subprocess.Popen(cmd, stdout=log, stderr=log)
            running.append((proc, arch, sname, mk, p, time.time()))
            print(f"[dryrun] start {arch} {sname} {mk}", flush=True)
        time.sleep(1)
        still = []
        for proc, arch, sname, mk, p, ts in running:
            if proc.poll() is None:
                still.append((proc, arch, sname, mk, p, ts))
                continue
            ok = p.exists() and json.loads(p.read_text()).get("ok", False)
            failures += not ok
            print(f"[dryrun] done  {arch} {sname} {mk}: "
                  f"{'OK' if ok else f'FAIL(rc={proc.returncode})'} "
                  f"({time.time() - ts:.0f}s)", flush=True)
        running = still
    print(f"[dryrun] matrix complete, {failures} failure(s)", flush=True)
    return failures


def _parse_override(kv):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("true", "false"):
        return k, v == "true"
    return k, v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(shp.SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--assigned-only", action="store_true",
                    help="only the 10 assigned archs (skip 130m cells)")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--no-skip-existing", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig override key=value")
    args = ap.parse_args(argv)

    overrides = dict(_parse_override(kv) for kv in args.override) or None
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all or args.arch is None:
        archs = ASSIGNED if args.assigned_only else list_archs()
        if args.arch:
            archs = [args.arch]
        extra = [a for kv in args.override for a in ("--override", kv)]
        rc = run_matrix(archs, list(shp.SHAPES), ["single", "multi"],
                        out_dir, args.jobs, not args.no_skip_existing,
                        args.tag, extra)
        sys.exit(1 if rc else 0)

    rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
           "ok": False}
    try:
        rec = run_cell(args.arch, args.shape, args.mesh,
                       overrides=overrides)
        rec["overrides"] = overrides
    except Exception as e:  # noqa: BLE001 — recorded per cell
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
        print(rec["traceback"])
    path = cell_path(out_dir, args.arch, args.shape, args.mesh, args.tag)
    _write(path, rec)
    mem = rec.get("memory", {})
    print(f"[dryrun] wrote {path} ok={rec['ok']} "
          f"fits_hbm={mem.get('fits_hbm')} mb={mem.get('microbatches')} "
          f"total_gb={mem.get('total_gb')}")
    sys.exit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
