"""Meshes over ranks: the runtime, the compressed pod sync over a real
``pod`` axis, the elastic re-shard, the staged pipeline, the batch's rows
and ``launch/train.py --mesh``, against the JAX package.

The ranks are ``gloo`` processes on the CPU (``distributed/launch.py:
spawn``), one per mesh device, as JAX's ``tests/test_distributed.py``
runs its meshes on fake CPU devices.  Each spawn is shared by the tests
of one module-scoped fixture.  The train step's ranks are in
``tests/test_torch_multirank_train.py``.
"""
import json
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import collectives as jcoll, pipeline as jpipeline
from repro.models import build_model as jbuild
from repro.nn import params as jparams
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM, host_local_slice
from repro_torch.distributed import launch, programs
from repro_torch.kernels import build
from repro_torch.launch import mesh as mesh_mod, train as train_cli
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.train import TrainConfig, init_state
from repro_torch.nn.params import from_jax_params, tree_leaves

CPU8 = (torch.device("cpu"),) * 8


# ---------------------------------------------------------------------------
# World of 8: the compressed pod sync on (4, 2) and the re-shard
# ---------------------------------------------------------------------------

PSUM_GRADS = {"w": np.random.default_rng(0).standard_normal(
    (4, 512)).astype(np.float32)}
GEMMA = dict(arch="gemma-2b", reduced=True,
             overrides=dict(param_dtype="float32"))
RESHARD_CHAIN = [((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
                 ((4, 2), ("data", "model"))]


MAMBA = dict(arch="mamba2-130m", reduced=True,
             overrides=dict(param_dtype="float32", d_model=64,
                            ssm_head_dim=16), seed=0)


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    jcfg = jget_config("gemma-2b", reduced=True).replace(
        param_dtype="float32")
    jp = jparams.init_params(jbuild(jcfg).param_specs(),
                             jax.random.PRNGKey(0), jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jp),
                             get_config("gemma-2b", reduced=True).replace(
                                 param_dtype="float32"), "cpu")
    reshard = dict(GEMMA, params=jax.tree.map(np.asarray, jax.tree.map(
        lambda t: t.numpy(), params)), chain=RESHARD_CHAIN)
    toks = np.random.default_rng(3).integers(1, 512, (3, 8, 16))
    ckdir = tmp_path_factory.mktemp("restarts")
    restart = dict(MAMBA, dir=str(ckdir), steps=2, fail_at=1,
                   first=((4, 2), ("data", "model")),
                   second=((2, 2), ("data", "model")),
                   batches=[{"tokens": t, "labels": t} for t in toks])
    res = launch.spawn(programs.sequence_rank, 8, ([
        (programs.psum_rank, {"shape": (4, 2), "axes": ("pod", "data"),
                              "grads": PSUM_GRADS}),
        (programs.reshard_rank, reshard),
        (programs.restart_rank, restart)],), timeout_s=240)
    return {"psum": [r[0] for r in res], "reshard": [r[1] for r in res],
            "restart": [r[2] for r in res], "params": params,
            "ckdir": ckdir}


def test_ranks_sit_at_row_major_coordinates(world8):
    """Rank r holds the row-major coordinate of the (pod, data) = (4, 2)
    mesh, as ``jax.make_mesh`` orders its devices."""
    got = [(r["coords"]["pod"], r["coords"]["data"]) for r in
           world8["psum"]]
    assert got == [(r // 2, r % 2) for r in range(8)]
    shape = {"pod": 4, "data": 2}
    for r in range(8):
        assert mesh_mod.rank_of(shape, mesh_mod.coords_of(shape, r)) == r


def test_compressed_pod_psum_over_four_pods(world8):
    """(4, 2) pod x data (tests/test_distributed.py:130): each pod's wire
    and residual bit for bit with JAX's one-device quantization of its
    rows; the all-reduced sum within 4 fp32 ulps of the sum in pod order
    (the ring adds in its own order) and the same bits on every rank; the
    JAX test's bounds against the exact psum; one all-reduce a leaf."""
    res = world8["psum"]
    g = PSUM_GRADS["w"]
    in_order = None
    for r in res:
        p = r["pod"]
        jsent, jerr = _jax_pod(g[p:p + 1])
        np.testing.assert_array_equal(r["sent"]["w"].numpy(), jsent)
        np.testing.assert_array_equal(r["err"]["w"].numpy(), jerr)
    sents = [res[2 * p]["sent"]["w"] for p in range(4)]
    in_order = ((sents[0] + sents[1]) + sents[2]) + sents[3]
    got = res[0]["sum"]["w"]
    for r in res:
        assert torch.equal(r["sum"]["w"], got)
    ulp = torch.finfo(torch.float32).eps * in_order.abs().max()
    assert float((got - in_order).abs().max()) <= 4 * ulp
    exact = g.sum(0, keepdims=True)
    rel = float(np.abs(got.numpy() - exact).max() /
                (np.abs(exact).max() + 1e-9))
    assert rel < 0.05, rel
    assert max(float(r["err"]["w"].abs().max()) for r in res) < 0.05
    assert [(c.op, c.axes, c.operand_bytes, c.wire_bytes)
            for c in res[0]["log"]] == [("all_reduce", ("pod",), 2048,
                                         2 * 3 * 2048 // 4)]


def _jax_pod(rows):
    """JAX's one-device ``compressed_pod_psum`` pieces on one pod's rows:
    the wire (``sent``) and the residual."""
    flat = jnp.asarray(rows).reshape(-1)
    q, scale = jcoll._quantize(jnp.pad(flat, (0, (-flat.size) % 256)))
    sent = np.asarray(jcoll._dequantize(q, scale))[:flat.size].reshape(
        rows.shape)
    mesh = jax.make_mesh((1,), ("pod",))
    _, err = jax.jit(jcoll.shard_map(
        lambda g, e: jcoll.compressed_pod_psum(g, e, "pod"), mesh=mesh,
        axis_names={"pod"}, in_specs=(jax.sharding.PartitionSpec(),) * 2,
        out_specs=(jax.sharding.PartitionSpec(),) * 2))(
        {"w": jnp.asarray(rows)}, {"w": jnp.zeros(rows.shape)})
    return sent, np.asarray(err["w"])


def test_reshard_state_across_meshes(world8):
    """gemma-2b reduced, fp32 (tests/test_distributed.py:165): (4, 2) ->
    (2, 2) -> (4, 2) in a world of 8; every leaf of params and AdamW's
    state comes back bit for bit on every rank; ranks 4-7 leave the (2, 2)
    mesh and come back; the slices follow the logical rules."""
    res = world8["reshard"]
    for r, out in enumerate(res):
        assert out["member"] and out["changed"] == [], (r, out["changed"])
        assert (out["held"][1] is None) == (r >= 4)
    params = world8["params"]
    whole = [tuple(t.shape) for t in tree_leaves(params)]
    from repro_torch.distributed.sharding import make_shardings, \
        per_layer_specs
    specs = per_layer_specs(build_model(get_config("gemma-2b", reduced=True),
                                        "meta").param_specs())
    for mesh_i, (shape, axes) in enumerate(RESHARD_CHAIN[:2]):
        sh, _ = make_shardings(specs, mesh_mod.make_mesh(shape, axes))
        sizes = dict(zip(axes, shape))
        for w, spec, got in zip(whole, [s.spec for s in tree_leaves(sh)],
                                res[0]["held"][mesh_i]):
            want = tuple(d // math.prod(sizes[a] for a in (
                (e,) if isinstance(e, str) else e)) if e else d
                for d, e in zip(w, spec))
            assert got == want


def test_restarts_and_checkpoints_move_to_a_smaller_mesh(world8):
    """``run_with_restarts`` on (4, 2) ranks (one injected failure on every
    rank: a restart from the last checkpoint) to step 2; rank 0 writes the
    gathered state in the JAX layout; ranks 0-3 restore it on (2, 2),
    bit for bit the state the 8 ranks reached, and resume to step 3;
    ranks 4-7 sit the second loop out."""
    from repro_torch.checkpoint import all_steps
    res = world8["restart"]
    for r, out in enumerate(res):
        assert out["first"] == {"step": 2, "restarts": 1}
        if r < 4:
            assert out["second"] == {"step": 3, "restarts": 0}
            assert out["restored_step"] == 2 and \
                out["restored_changed"] == []
        else:
            assert "second" not in out
    assert all_steps(world8["ckdir"]) == [1, 2, 3]
    keys = json.loads((world8["ckdir"] / "step_00000003" /
                       "manifest.json").read_text())["keys"]
    assert "['params']['layers']['mixer']['in_proj']['w']" in keys


# ---------------------------------------------------------------------------
# World of 4: the staged pipeline
# ---------------------------------------------------------------------------

PIPE_CASES = [(4, 6), (4, 2)]


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _pipe_case(stages, micro):
    rng = np.random.default_rng(stages * 10 + micro)
    d = 8
    params = {"w": (rng.standard_normal((stages, d, d)) / 3).astype(
        np.float32), "b": rng.standard_normal((stages, d)).astype(
        np.float32) * 0.1}
    return dict(params=params,
                microbatches=rng.standard_normal((micro, 3, d)).astype(
                    np.float32),
                cot=rng.standard_normal((micro, 3, d)).astype(np.float32))


@pytest.fixture(scope="module")
def pipe4():
    cases = [_pipe_case(*c) for c in PIPE_CASES]
    return cases, launch.spawn(programs.pipeline_rank, 4,
                               ({"cases": cases},), timeout_s=180)


@pytest.mark.parametrize("case", range(len(PIPE_CASES)),
                         ids=[f"{s}x{m}" for s, m in PIPE_CASES])
def test_staged_pipeline_matches_jax_and_its_gradients(pipe4, case):
    """``pipeline_apply`` with its 4 stages on 4 ranks (the rotation a
    send to the next rank, the backward through the ``autograd.Function``
    around each send and receive) against JAX's ``pipeline_apply`` and
    ``jax.grad`` of it at 1e-5: the last rank's output, every rank's
    stage gradients, rank 0's microbatch gradient."""
    cases, res = pipe4
    c = cases[case]
    jout = jpipeline.pipeline_apply(_jstage, c["params"],
                                    jnp.asarray(c["microbatches"]))
    jg = jax.grad(lambda p, x: jnp.sum(jpipeline.pipeline_apply(
        _jstage, p, x) * c["cot"]), argnums=(0, 1))(
        c["params"], jnp.asarray(c["microbatches"]))
    ranks = [r[case] for r in res]
    assert [r["stage"] for r in ranks] == [0, 1, 2, 3]
    np.testing.assert_allclose(ranks[3]["out"].numpy(), np.asarray(jout),
                               atol=1e-5)
    for s, r in enumerate(ranks):
        np.testing.assert_allclose(r["w"][0].numpy(),
                                   np.asarray(jg[0]["w"][s]), atol=1e-5)
        np.testing.assert_allclose(r["b"][0].numpy(),
                                   np.asarray(jg[0]["b"][s]), atol=1e-5)
        assert (r["x"] is None) == (s > 0)
    np.testing.assert_allclose(ranks[0]["x"].numpy(), np.asarray(jg[1]),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Without spawning: the batch's rows, the runtime's failures, the build lock
# ---------------------------------------------------------------------------

def test_host_local_slice_splits_over_the_batch_axes_only():
    """On (data, model) = (2, 2) ranks along ``model`` take the same rows
    (JAX shards the batch over (pod, data) only); the world's rank alone
    would give each of the 4 ranks its own quarter."""
    devs = (torch.device("cpu"),) * 4
    got = [host_local_slice(8, mesh_mod.Mesh({"data": 2, "model": 2}, devs,
                                             rank=r)) for r in range(4)]
    assert got == [slice(0, 4), slice(0, 4), slice(4, 8), slice(4, 8)]
    pods = [host_local_slice(8, mesh_mod.Mesh(
        {"pod": 2, "data": 2, "model": 2}, CPU8, rank=r)) for r in range(8)]
    assert pods == [slice(2 * (r // 2), 2 * (r // 2) + 2) for r in range(8)]
    with pytest.raises(ValueError, match="does not split"):
        host_local_slice(6, mesh_mod.Mesh({"data": 4, "model": 2}, CPU8,
                                          rank=0))


def test_a_failing_rank_raises_its_traceback():
    with pytest.raises(launch.RankError, match="of 2 ranks failed") as exc:
        launch.spawn(programs.sequence_rank, 2, ([(
            programs.psum_rank, {"shape": (2, 1), "axes": ("pod", "nope"),
                                 "grads": {"w": np.zeros((3, 4),
                                                         np.float32)}})],),
            timeout_s=60)
    assert "Traceback" in str(exc.value)


def _racing_clock(monkeypatch):
    """``spawn``'s clock jumps an hour at every reading: any finite
    deadline passes at its second poll."""
    import itertools
    import time
    import types
    hours = itertools.count(0.0, 3600.0)
    monkeypatch.setattr(launch, "time", types.SimpleNamespace(
        monotonic=lambda: next(hours), sleep=time.sleep))


@pytest.mark.parametrize("timeout_s", [60.0, None])
def test_spawn_without_a_deadline_outlives_any_clock(monkeypatch, timeout_s):
    """On a clock that runs an hour a poll, a deadline stops the ranks
    and ``timeout_s=None`` lets them end."""
    _racing_clock(monkeypatch)
    job = [(programs.sequence_rank, [])]
    if timeout_s is None:
        assert launch.spawn(programs.sequence_rank, 2, (job,),
                            timeout_s=None) == [[[]], [[]]]
    else:
        with pytest.raises(launch.RankError, match="still running"):
            launch.spawn(programs.sequence_rank, 2, (job,),
                         timeout_s=timeout_s)


def test_build_all_compiles_once_under_its_lock(tmp_path, monkeypatch):
    """Three threads (as three ranks) call ``build_all`` on missing
    libraries: one runs the compiler on every source, the others wait on
    the lock and then find the libraries."""
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nsleep 0.3\nout=''\nwhile [ $# -gt 0 ]; do "
                    "if [ \"$1\" = -o ]; then out=$2; fi; shift; done\n"
                    f"echo x >> {calls}\ntouch \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    errors = []

    def one():
        try:
            build.build_all()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(calls.read_text().split()) == len(build.SOURCES)
    assert all(build._target(n).exists() for n in build.SOURCES)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_train_cli_mesh_2x2(capfd, monkeypatch):
    """``launch/train.py --mesh 2x2:data,model`` starts 4 ranks and trains
    2 steps with its compute split over ``model``: its logged losses and
    final state equal, bit for bit, the one-process emulation of the
    ranks' arithmetic (``programs.emulate_steps``: the two data ranks'
    rows apart, each with both model ranks' pieces) on the CLI's batches
    and initial state, in one thread as each rank runs; it logs what ran
    split.  The ranks' run has no deadline, as the run without ``--mesh``
    has none: ``spawn``'s clock here passes an hour at every poll."""
    argv = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "4",
            "--seq", "16", "--log-every", "1"]
    with monkeypatch.context() as m:
        _racing_clock(m)
        state, monitor = train_cli.main(argv + ["--mesh", "2x2:data,model"])
    mesh_log = capfd.readouterr().err
    cfg = get_config("mamba2-130m", reduced=True)
    model = build_model(cfg, "cpu")
    tc = TrainConfig(optimizer=AdamWConfig(), schedule=ScheduleConfig(
        base_lr=3e-4, warmup_steps=10, total_steps=2))
    data = iter(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=16, global_batch=4, seed=0)))
    batches = [next(data) for _ in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, _, hist = programs.emulate_steps(
            model, tc, init_state(model, 0, tc), batches,
            {"data": 2, "model": 2})
    finally:
        torch.set_num_threads(threads)
    logged = [line.split("loss")[1].split()[0] for line in
              mesh_log.splitlines() if line.startswith("step")]
    assert logged == [f"{h['loss']:.4f}" for h in hist] and len(hist) == 2
    assert "data=2 x model=2 (4 ranks)" in mesh_log
    assert "compute split over 2 model ranks" in mesh_log
    assert monitor.summary()["steps"] == 2
    assert programs.differences(
        {k: state[k] for k in ("params", "opt")},
        {k: want[k] for k in ("params", "opt")}) == []


def test_parse_collectives_reads_the_record():
    """``hlo_analysis.parse_collectives`` over a ``collectives.recording()``
    log: counts, operand and wire bytes per op, a detail row a call; none
    without a record (one card)."""
    from repro_torch.distributed.collectives import CollectiveRecord
    from repro_torch.launch import hlo_analysis
    log = [CollectiveRecord("all_gather", ("data",), 100, 100),
           CollectiveRecord("all_reduce", ("pod",), 64, 64),
           CollectiveRecord("all_gather", ("data", "model"), 10, 30)]
    stats = hlo_analysis.parse_collectives(log)
    assert stats.counts == {"all_gather": 2, "all_reduce": 1}
    assert stats.operand_bytes == {"all_gather": 110, "all_reduce": 64}
    assert stats.total_wire_bytes == 194
    assert stats.details[2] == {"op": "all_gather", "axes": ["data", "model"],
                                "operand_bytes": 10, "wire_bytes": 30}
    assert hlo_analysis.parse_collectives().total_wire_bytes == 0
