"""Rank programs for ``distributed/launch.py: spawn``, and the one-process
emulation of what the ranks compute.

Each program is ``fn(rank, world, job)``, a module-level function so
that the spawned ranks can import it:

* :func:`train_cli_rank`: ``launch/train.py``'s ``main`` on one rank of
  its ``--mesh``;
* :func:`train_rank`: train steps of a model on meshes of ranks, each run
  then checked against :func:`emulate_steps` (a one process loop of the
  ranks' arithmetic: their rows' gradients apart, summed in rank order,
  divided, the compressed sync pod by pod) and, optionally, resharded
  over a chain of meshes and back;
* :func:`psum_rank`: ``compressed_pod_psum`` over a ``pod`` axis;
* :func:`reshard_rank`: a train state over a chain of meshes and back;
* :func:`pipeline_rank`: ``pipeline_apply`` with its stage axis over the
  ranks, and its gradients;
* :func:`restart_rank`: ``run_with_restarts`` on one mesh, then resumed
  from its checkpoint on a smaller one;
* :func:`sequence_rank`: several of these, one after another, in the
  same ranks.

Results come back on the CPU.  ``job`` is a plain dict (it pickles).
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data import host_local_slice, to_device_batch
from repro_torch.distributed import collectives, pipeline
from repro_torch.distributed.sharding import Sharding, gather_like, \
    shard_like
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.nn.params import jax_layout, per_layer, tree_leaves, \
    tree_map
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw, \
    schedule as sched
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import compute_grads, param_shardings, \
    shard_state

BATCH_AXES = ("pod", "data")


def _cpu(tree):
    return tree_map(lambda t: t.detach().to("cpu") if isinstance(
        t, torch.Tensor) else t, tree)


def _device(job) -> torch.device:
    d = torch.device(job.get("device", "cpu"))
    return torch.device("cuda", 0) if d.type == "cuda" else d


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def train_cli_rank(rank: int, world: int, argv: List[str]):
    """``launch/train.py --mesh`` on one rank: rank 0's ``(state,
    monitor)``, the state gathered whole on the CPU; ``None`` elsewhere."""
    from repro_torch.launch import train
    state, monitor = train.main(argv)
    return (_cpu(state), monitor) if rank == 0 else None


# ---------------------------------------------------------------------------
# Train steps on meshes of ranks, and their one-process emulation
# ---------------------------------------------------------------------------

def model_of(spec: dict, dev):
    """``spec``: ``arch``, ``reduced``, ``overrides``."""
    cfg = get_config(spec["arch"], reduced=spec.get("reduced", False))
    if spec.get("overrides"):
        cfg = cfg.replace(**spec["overrides"])
    return build_model(cfg, dev)


def train_config(spec: dict, compressed: bool = False) -> TrainConfig:
    return TrainConfig(optimizer=AdamWConfig(),
                       schedule=ScheduleConfig(**spec.get("schedule", {})),
                       microbatches=spec.get("microbatches", 1),
                       compressed_cross_pod=compressed)


def initial_state(model, spec: dict, tc: TrainConfig) -> dict:
    """The whole state every rank starts from: ``spec["params"]`` (numpy
    or tensors, the port's layout) or ``init_params`` of ``spec["seed"]``;
    AdamW's moments zero; ``err`` zero under the compressed sync."""
    if spec.get("params") is not None:
        params = tree_map(lambda a: (a if isinstance(a, torch.Tensor) else
                                     torch.from_numpy(np.array(a))).to(
            model.device), spec["params"])
        state = {"params": params, "opt": adamw.init(params, tc.optimizer)}
        if tc.compressed_cross_pod:
            state["err"] = collectives.init_errors(params)
        return state
    return init_state(model, spec.get("seed", 0), tc)


def _rows(batch: dict, rows: slice, dev) -> dict:
    return to_device_batch({k: np.asarray(v)[rows] for k, v in
                            batch.items()}, dev)


def _leaf_names(tree, pre="") -> List[str]:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k],
                                                             f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{pre}/{i}")]
    return [pre]


def differences(got, want) -> List[tuple]:
    """``(leaf, max |got - want|, elements that differ)`` of every leaf
    whose bits differ; empty when the trees are equal bit for bit."""
    out = []
    for name, a, b in zip(_leaf_names(want), tree_leaves(got),
                          tree_leaves(want)):
        a, b = a.detach(), b.detach().to(a.device)
        if a.shape != b.shape or a.dtype != b.dtype:
            out.append((name, float("inf"), -1))
        elif not torch.equal(a, b):
            d = (a.double() - b.double()).abs()
            out.append((name, float(d.max()), int((d > 0).sum())))
    return out


def emulate_steps(model, tc: TrainConfig, state: dict, batches: list,
                  shape: Dict[str, int], errs: Optional[list] = None):
    """What the ranks of a mesh of ``shape`` compute, in one process:
    each rank's rows' gradients (``compute_grads``, its microbatches)
    apart; their fp32 sum in rank order over the batch axes, divided by
    their count; under the compressed sync that over ``data`` only, then
    each pod's int8 round trip with its own residual (``errs``, one tree
    a pod), the pods' ``sent`` summed in pod order and divided by the pod
    count; the clip's norm of that gradient; AdamW.  Returns the state,
    the per-pod residuals and each step's metrics."""
    dev = model.device
    podwise = tc.compressed_cross_pod and "pod" in shape
    axes = [a for a in BATCH_AXES if a in shape]
    n_batch = math.prod(shape[a] for a in axes)
    n_pod = shape.get("pod", 1) if podwise else 1
    n_mean = n_batch // n_pod
    cfg = model.cfg
    if podwise and errs is None:
        errs = [state["err"]] * n_pod
    history = []
    for batch in batches:
        rows = len(next(iter(batch.values()))) // n_batch
        params = state["params"]
        pod_grads, mets = [], []
        for p in range(n_pod):
            parts = []
            for d in range(n_mean):
                i = p * n_mean + d
                g, m = compute_grads(model, params, _rows(
                    batch, slice(i * rows, (i + 1) * rows), dev),
                    tc.microbatches)
                parts.append(g)
                mets.append(m)
            if n_mean > 1:
                acc = tree_map(lambda g: g.float(), parts[0])
                for g in parts[1:]:
                    acc = tree_map(lambda a, b: a + b.float(), acc, g)
                parts[0] = tree_map(lambda a: a / n_mean, acc)
            pod_grads.append(parts[0])
        metrics = {n: torch.stack([m[n] for m in mets]).float().mean(0)
                   for n in mets[0]}
        grads = pod_grads[0]
        if podwise:
            sent = []
            for p in range(n_pod):
                red, errs[p] = collectives.compressed_pod_psum(
                    jax_layout(pod_grads[p], cfg), jax_layout(errs[p], cfg))
                sent.append(red)
                errs[p] = per_layer(errs[p])
            total = sent[0]
            for s in sent[1:]:
                total = tree_map(lambda a, b: a + b, total, s)
            grads = tree_map(lambda g: g / n_pod, per_layer(total))
        lr = sched.lr_at(state["opt"]["step"], tc.schedule)
        new_params, new_opt, stats = adamw.update(
            grads, state["opt"], params, lr, tc.optimizer)
        state = dict(state, params=new_params, opt=new_opt)
        metrics.update(stats)
        history.append({k: float(v) for k, v in metrics.items()})
    if podwise:
        state["err"] = errs[0]
    return state, errs, history


def _kernel_launches() -> Dict[str, int]:
    from repro_torch.kernels import prefill_chunk
    return {"mamba2_prefill": prefill_chunk.mamba2_prefill.launches}


def _reset_launches() -> None:
    from repro_torch.kernels import prefill_chunk
    prefill_chunk.mamba2_prefill.launches = 0


def train_rank(rank: int, world: int, job: dict) -> dict:
    """``job``: ``device``, ``batches`` (global numpy batches) and
    ``runs``, each a model spec (:func:`model_of`, :func:`train_config`,
    :func:`initial_state`) plus ``shape`` and ``axes`` of a mesh over the
    world, ``compressed``, and the checks to run after its steps:
    ``emulate`` (rank 0 holds the gathered state to
    :func:`emulate_steps`'s bits), ``whole_batch`` (rank 1 runs the
    one-process step on the whole batches beside it), ``reshard`` (a chain
    of ``(shape, axes)`` meshes the state moves over and back) and
    ``return_state`` (rank 0 returns the gathered state).  Returns, per
    run, the metrics of every step, the step seconds, kernel 2's launches,
    the peak memory and the collectives a step, and the checks' reports."""
    dev = _device(job)
    cuda = dev.type == "cuda"
    out, drawn = [], {}
    for run in job["runs"]:
        t = {"start": time.time()}
        model = model_of(run, dev)
        tc = train_config(run, run.get("compressed", False))
        mesh = make_mesh(run["shape"], run["axes"],
                         devices=[dev] * math.prod(run["shape"]))
        # Runs of one model from one seed start from one draw.
        key = repr((run["arch"], run.get("overrides"), run.get("seed")))
        if run.get("params") is None and key in drawn:
            start = initial_state(model, dict(run, params=drawn[key]), tc)
        else:
            start = initial_state(model, run, tc)
            drawn[key] = start["params"]
        t["state"] = time.time()
        state = shard_state(start, model, tc, mesh)
        step = make_train_step(model, tc, mesh)
        rows = host_local_slice(len(job["batches"][0]["tokens"]), mesh)
        rec: Dict[str, Any] = {"metrics": [], "secs": [], "collectives": []}
        _reset_launches()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        sh = param_shardings(model, tc, mesh)
        # Every group's first collective connects its ranks: done here, so
        # that the step seconds hold none of it.
        gather_like(state["params"], sh)
        t["connected"] = time.time()
        snaps = []
        for batch in job["batches"]:
            b = _rows(batch, rows, dev)
            with collectives.recording() as log:
                _sync(dev)
                t0 = time.perf_counter()
                state, met = step(state, b)
                _sync(dev)
                rec["secs"].append(time.perf_counter() - t0)
            rec["collectives"].append(collectives.summary(log))
            rec["metrics"].append({k: float(v) for k, v in met.items()})
            if run.get("snapshots"):
                snap = {"params": gather_like(state["params"], sh)}
                if tc.compressed_cross_pod:
                    snap["errs"] = _pod_errs(state, mesh)
                snaps.append(_cpu(snap) if rank == 0 else None)
        rec["launches"] = _kernel_launches()
        if cuda:
            rec["peak_bytes"] = torch.cuda.max_memory_allocated() - held
        if rank == 0 and snaps:
            rec["snapshots"] = snaps
        t["steps"] = time.time()
        whole = ckpt.gathered(state, sh)
        errs = _pod_errs(state, mesh) if tc.compressed_cross_pod else None
        t["gathered"] = time.time()
        if run.get("emulate") and rank == 0:
            want, want_errs, hist = emulate_steps(
                model, tc, start, job["batches"],
                dict(zip(run["axes"], run["shape"])))
            rec["emulation"] = {
                "state": differences(
                    {k: whole[k] for k in ("params", "opt")},
                    {k: want[k] for k in ("params", "opt")}),
                "metrics": hist}
            if errs is not None:
                rec["emulation"]["err"] = [
                    (p, differences(e, w))
                    for p, (e, w) in enumerate(zip(errs, want_errs))]
            del want, want_errs
        t["emulated"] = time.time()
        # Rank 1 (beside rank 0's emulation) runs the whole-batch steps.
        if run.get("whole_batch") and rank == min(1, world - 1):
            rec["whole_batch"] = whole_batch_steps(
                model, TrainConfig(optimizer=tc.optimizer,
                                   schedule=tc.schedule),
                start, job["batches"], whole)
        t["whole_batch"] = time.time()
        del start
        if run.get("reshard"):
            rec["reshard"] = _reshard_chain(state, model, tc, mesh,
                                            run["reshard"], dev)
        t["resharded"] = time.time()
        if run.get("return_state") and rank == 0:
            rec["state"] = _cpu(whole)
            if errs is not None:
                rec["errs"] = [_cpu(e) for e in errs]
        rec["timeline"] = {k: v - t["start"] for k, v in t.items()}
        out.append(rec)
        del state, whole, step, model
        if cuda:
            torch.cuda.empty_cache()
    return out


def _pod_errs(state, mesh) -> list:
    """Every pod's residual tree, gathered over ``pod`` (one tree a pod,
    in pod order)."""
    flat = torch.cat([t.reshape(-1) for t in tree_leaves(state["err"])])
    out = []
    for whole in collectives.all_gather(flat, mesh, ("pod",)):
        parts = iter(whole.split([t.numel() for t in
                                  tree_leaves(state["err"])]))
        out.append(tree_map(lambda t: next(parts).view(t.shape),
                            state["err"]))
    return out


def whole_batch_steps(model, tc: TrainConfig, start: dict, batches: list,
                      got: dict) -> dict:
    """The one-process step from ``start`` on the whole batches and, as a
    control that a wrong step fails, on their first half only: the
    metrics and step seconds of each, and how far ``got`` (the ranks'
    gathered ``params`` and ``opt``) and the control sit from the whole
    batch's state (:func:`departures`)."""
    step = make_train_step(model, tc)

    def steps(rows):
        state, hist, secs = start, [], []
        for batch in batches:
            b = _rows(batch, rows, model.device)
            _sync(model.device)
            t0 = time.perf_counter()
            state, met = step(state, b)
            _sync(model.device)
            secs.append(time.perf_counter() - t0)
            hist.append({k: float(v) for k, v in met.items()})
        return state, hist, secs
    state, hist, secs = steps(slice(None))
    half, half_hist, _ = steps(slice(0, len(batches[0]["tokens"]) // 2))
    return {"metrics": hist, "secs": secs,
            "got": departures(got, state, start),
            "control": dict(departures(half, state, start),
                            metrics=half_hist)}


def departures(got: dict, want: dict, start: dict) -> dict:
    """How far the train state ``got`` sits from ``want``, both stepped
    from ``start``, each as |got - want| / |want| in the L2 norm over the
    whole tree (fp64): ``moments``, the larger of AdamW's ``m`` and ``v``;
    ``update``, of the params' update (params - ``start``'s); and
    ``leaf``, the moment leaf where that ratio is largest, with it.  The
    moments are fp32 whatever the params' dtype, so they keep the
    gradients that bf16 params round away."""
    def apart(pairs):
        num = den = 0.0
        for a, b in pairs:
            num += float((a - b).square().sum())
            den += float(b.square().sum())
        return math.sqrt(num / den) if den else float(num > 0)
    moments, leaf = 0.0, (0.0, "")
    for part in ("m", "v"):
        pairs = [(a.double(), b.double()) for a, b in zip(
            tree_leaves(got["opt"][part]), tree_leaves(want["opt"][part]))]
        moments = max(moments, apart(pairs))
        for name, pair in zip(_leaf_names(want["opt"][part]), pairs):
            r = apart([pair])
            if r > leaf[0]:
                leaf = (r, f"{part}{name}")
    update = apart([(a.double() - s.double(), b.double() - s.double())
                    for a, b, s in zip(tree_leaves(got["params"]),
                                       tree_leaves(want["params"]),
                                       tree_leaves(start["params"]))])
    return {"moments": moments, "update": update, "leaf": leaf}


def _reshard_chain(state, model, tc, mesh, chain, dev) -> dict:
    """``state`` moved over each ``(shape, axes)`` of ``chain`` in turn and
    back onto ``mesh``: the leaves of this rank's shards whose bits
    changed (every rank checks its own, so together every leaf)."""
    before, cur = state, mesh
    for shape, axes in list(chain) + [(tuple(mesh.shape.values()),
                                       tuple(mesh.shape))]:
        new = make_mesh(shape, axes, devices=[dev] * math.prod(shape))
        state = shard_state(state, model, tc, new, old_mesh=cur)
        cur = new
    return {"changed": differences(
        {k: state[k] for k in ("params", "opt")},
        {k: before[k] for k in ("params", "opt")}),
        "meshes": [list(s) for s, _ in chain]}


# ---------------------------------------------------------------------------
# The compressed pod sync, the re-shard and the pipeline on their own
# ---------------------------------------------------------------------------

def psum_rank(rank: int, world: int, job: dict) -> dict:
    """``compressed_pod_psum`` of ``job["grads"]`` (a tree of numpy
    arrays whose leading dim splits over the ``pod`` axis, as JAX's
    ``P("pod")``) on a mesh of ``job["shape"]`` over ``job["axes"]``: this
    rank's rows of ``g``, its ``sent`` (the wire before the sum), the sum
    and the residual."""
    mesh = make_mesh(job["shape"], job["axes"],
                     devices=["cpu"] * math.prod(job["shape"]))
    n, p = mesh.shape["pod"], mesh.coords["pod"]
    g = tree_map(lambda a: torch.from_numpy(np.array(
        np.split(a, n)[p])), job["grads"])
    err = collectives.init_errors(g)
    sent = tree_map(lambda x, e: collectives.quantize_leaf(x, e)[0], g, err)
    with collectives.recording() as log:
        red, new_err = collectives.compressed_pod_psum(g, err, "pod", mesh)
    return {"pod": p, "coords": mesh.coords, "sent": sent, "sum": red,
            "err": new_err, "log": log}


def reshard_rank(rank: int, world: int, job: dict) -> dict:
    """A whole train state (``job``'s model spec, params from its seed or
    ``params``, AdamW's moments drawn from ``job["moment_seed"]``) placed
    on the first mesh of ``job["chain"]`` and moved along the rest: the
    shapes this rank held on each, and the leaves whose bits changed
    against the whole state once back on the first mesh."""
    model = model_of(job, "cpu")
    tc = train_config(job)
    state = initial_state(model, job, tc)
    gen = torch.Generator().manual_seed(job.get("moment_seed", 1))
    state["opt"]["m"] = tree_map(lambda p: torch.randn(
        p.shape, generator=gen).to(p.dtype), state["params"])
    whole = state
    (shape, axes), rest = job["chain"][0], job["chain"][1:]
    mesh = make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))
    state = shard_state(whole, model, tc, mesh)
    held = [[tuple(t.shape) for t in tree_leaves(state["params"])]]
    cur = mesh
    for shape, axes in rest:
        new = make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))
        state = shard_state(state, model, tc, new, old_mesh=cur)
        held.append(None if state is None else
                    [tuple(t.shape) for t in tree_leaves(state["params"])])
        cur = new
    out = {"held": held, "member": state is not None}
    if state is not None:
        back = ckpt.gathered(state, param_shardings(model, tc, cur))
        out["changed"] = differences(
            {k: back[k] for k in ("params", "opt")},
            {k: whole[k] for k in ("params", "opt")})
    return out


def restart_rank(rank: int, world: int, job: dict) -> dict:
    """``run_with_restarts`` over ``job["batches"]`` (one step a call) on
    the mesh ``job["first"]`` to ``job["steps"]``, failing once on every
    rank at ``job["fail_at"]`` (a restart from the last checkpoint), with
    checkpoints under ``job["dir"]``; then, on the ranks of the smaller
    mesh ``job["second"]``, the checkpoint restored there and the loop
    resumed for one more step.  Returns the outcomes, and whether the
    restored state equals, bit for bit, the state the first mesh
    reached."""
    from repro_torch.runtime.elastic import RestartPolicy, \
        run_with_restarts
    model = model_of(job, "cpu")
    tc = train_config(job)
    start = initial_state(model, job, tc)
    failed = []

    def loop_on(mesh):
        step = make_train_step(model, tc, mesh)
        rows = host_local_slice(len(job["batches"][0]["tokens"]), mesh)

        def some(state, at):
            if at == job["fail_at"] and not failed:
                failed.append(at)
                raise RuntimeError(f"injected failure at step {at}")
            state, _ = step(state, _rows(job["batches"][at], rows, "cpu"))
            return state, at + 1
        return some

    out = {}
    policy = RestartPolicy(max_restarts=2, ckpt_dir=job["dir"])
    for name, target in (("first", job["steps"]),
                         ("second", job["steps"] + 1)):
        shape, axes = job[name]
        mesh = make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))
        if not mesh.member:
            continue
        sh = param_shardings(model, tc, mesh)
        state = shard_state(start, model, tc, mesh)
        if name == "second":
            restored, at, _ = ckpt.restore(job["dir"], state, cfg=model.cfg,
                                           shardings=sh)
            out["restored_step"] = at
            out["restored_changed"] = differences(
                {k: v for k, v in ckpt.gathered(restored, sh).items()
                 if k in ("params", "opt")}, reached)
        res = run_with_restarts(loop_on(mesh), state, policy,
                                target_steps=target, cfg=model.cfg,
                                shardings=sh)
        out[name] = {"step": res.step, "restarts": res.restarts}
        if name == "first":
            reached = {k: v for k, v in ckpt.gathered(res.state, sh).items()
                       if k in ("params", "opt")}
    return out


def sequence_rank(rank: int, world: int, programs: list) -> list:
    """``programs``: ``(fn, job)`` pairs run one after another in these
    ranks; their results in order."""
    return [fn(rank, world, job) for fn, job in programs]


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_rank(rank: int, world: int, job: dict) -> list:
    """For each case of ``job["cases"]`` (numpy ``params`` stacked over S
    stages, ``microbatches``, a cotangent ``cot``): ``pipeline_apply``
    with the stage axis over the world's S ranks, then the gradients of
    ``sum(out * cot)`` on every rank.  Returns this rank's output, its
    stage's gradients and (rank 0) the microbatches' gradient."""
    mesh = make_mesh((world,), ("stage",), devices=["cpu"] * world)
    s = mesh.coords["stage"]
    sh = Sharding(mesh, ("stage",))
    out = []
    for case in job["cases"]:
        params = {k: shard_like(torch.from_numpy(v), sh).requires_grad_()
                  for k, v in case["params"].items()}
        x = torch.from_numpy(case["microbatches"]).requires_grad_()
        y = pipeline.pipeline_apply(_stage, params, x, mesh, "stage")
        loss = (y * torch.from_numpy(case["cot"])).sum()
        gw, gb, gx = torch.autograd.grad(loss, [params["w"], params["b"],
                                                x], allow_unused=True)
        out.append({"stage": s, "out": y.detach(), "w": gw, "b": gb,
                    "x": gx})
    return out
