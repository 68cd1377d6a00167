"""The train step on meshes of ranks against the JAX package: mamba2 on a
(data, model) = (2, 4) mesh, deepseek-7b and gemma-2b on 8 ranks against
one device, each with its compute split over ``model``, and the
compressed cross-pod sync on (pod, data) = (2, 2).

The ranks are ``gloo`` processes on the CPU (``distributed/launch.py``),
each one thread.  Every run is held bit for bit to the port's one-process
emulation of the ranks' arithmetic (``distributed/programs.py:
emulate_steps``, run on rank 0), and to the JAX package at the tolerance
its own comparisons use: ``tests/test_torch_train.py``'s for the
one-device step, ``tests/test_distributed.py``'s 1e-3 for multi against
single device, ``tests/test_torch_distributed.py``'s flip rule for the
compressed step.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.nn import params as jparams
from repro.optim import AdamWConfig as JAdamW, ScheduleConfig as JSched, \
    adamw as jadamw
from repro.train import TrainConfig as JTrainConfig, \
    make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.distributed import launch, programs
from repro_torch.models import build_model
from repro_torch.nn.params import from_jax_params, to_jax_params, tree_map

SRC = str(Path(__file__).resolve().parents[1] / "src")
SCHED = dict(base_lr=1e-3, warmup_steps=2, total_steps=50)
MAMBA = dict(arch="mamba2-130m", reduced=True,
             overrides=dict(param_dtype="float32", d_model=64,
                            ssm_head_dim=16))
DEEPSEEK = dict(arch="deepseek-7b", reduced=True,
                overrides=dict(param_dtype="float32"))
GEMMA = dict(arch="gemma-2b", reduced=True,
             overrides=dict(param_dtype="float32"))
COMPRESSED = dict(arch="mamba2-130m", reduced=True,
                  overrides=dict(param_dtype="float32"))
# The multi-rank loss is the mean of the ranks' means over their rows; the
# one-process loss the mean over all rows: the same sum in another order.
# Measured |difference| on deepseek-7b reduced: 4.77e-7 (JAX: 2.86e-6).
LOSS_ORDER_TOL = 1e-5


def _jax_pair(spec, seed=0):
    """JAX's model and params from ``seed``; the port's config and the
    params carried across (numpy, the port's layout)."""
    jcfg = jget_config(spec["arch"], reduced=True).replace(
        **spec["overrides"])
    jm = jbuild(jcfg)
    jp = jparams.init_params(jm.param_specs(), jax.random.PRNGKey(seed),
                             jnp.float32)
    cfg = get_config(spec["arch"], reduced=True).replace(
        **spec["overrides"])
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, cfg, tree_map(lambda t: t.numpy(), tp)


def _batches(n, b, l, vocab, seed):
    out = []
    for s in range(n):
        toks = np.random.default_rng(seed + s).integers(
            1, vocab, (b, l)).astype(np.int32)
        out.append({"tokens": toks, "labels": toks})
    return out


# ---------------------------------------------------------------------------
# World of 8: mamba2, deepseek-7b and gemma-2b on (2, 4)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world8():
    jm, jp, cfg, tp = _jax_pair(MAMBA)
    dm, dp, dcfg, dtp = _jax_pair(DEEPSEEK)
    gm, gp, gcfg, gtp = _jax_pair(GEMMA)
    batches = _batches(2, 8, 32, cfg.vocab_size, 10)
    mesh = dict(shape=(2, 4), axes=("data", "model"), emulate=True,
                count_flops=True)
    runs = [dict(MAMBA, params=tp, schedule=SCHED, return_state=True,
                 whole_batch=True, **mesh),
            dict(DEEPSEEK, params=dtp, schedule=SCHED, **mesh),
            dict(GEMMA, params=gtp, schedule=SCHED, **mesh)]
    # deepseek and gemma take the first batch only: the JAX test's one
    # step.
    res = launch.spawn(programs.sequence_rank, 8, ([
        (programs.train_rank, {"batches": batches, "runs": runs[:1]}),
        (programs.train_rank, {"batches": batches[:1], "runs": runs[1:]})],),
        timeout_s=300)
    return dict(mamba=[r[0][0] for r in res], deepseek=[r[1][0] for r in res],
                gemma=[r[1][1] for r in res], batches=batches, jm=jm, jp=jp,
                cfg=cfg, tp=tp, dm=dm, dp=dp, dcfg=dcfg, dtp=dtp, gm=gm,
                gp=gp, gcfg=gcfg, gtp=gtp)


def test_train_step_on_2x4_is_its_emulation_bit_for_bit(world8):
    """mamba2 reduced (d_model 64, head_dim 16, fp32) on (data, model) =
    (2, 4), 2 steps (tests/test_distributed.py:51), its compute split over
    ``model``: params, AdamW's moments and every step's metrics equal, bit
    for bit, one process that computes each data rank's rows apart with
    every model rank's pieces (``collectives.EmulatedGroup``), adds the
    gradients in rank order and halves them; every rank reports the same
    metrics."""
    ranks = world8["mamba"]
    emu = ranks[0]["emulation"]
    assert emu["state"] == []
    assert ranks[0]["metrics"] == emu["metrics"]
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["model_split"]["split"]
    # A step's collectives.  all_gather: the params over data (one flat
    # gather), kernel 2's operands over model (one), the gradients' mean
    # over the two data ranks (one) and the loss's 4 metrics.  Over model:
    # model_sum, the vocab-parallel embedding's sum, each layer's
    # row-parallel out-projection (the recompute under remat "full" stops
    # before it: its output is saved by nothing), the logits' input
    # gradient, the loss's sums and the clip norm's squares; model_values
    # the loss's maxima and argmaxes; model_gather each layer's y
    # gradient (the cut's backward).
    col = ranks[0]["collectives"][1]
    n = world8["cfg"].n_layers
    assert {op: c["count"] for op, c in col.items()} == {
        "all_gather": 1 + 1 + 1 + 4, "model_sum": 1 + n + 1 + 1 + 1,
        "model_values": 1, "model_gather": n}


def _split_flops(cfg, m: int, b: int, l: int) -> int:
    """The FLOPs, as ``FlopCounterMode`` counts them (a product of M x K
    by K x N: 2MKN forward, twice that backward), of one step's products
    that the split divides over ``m`` model ranks, on b x l tokens: the
    Mamba-2 out-projection; the attention's q / k / v (k, v where the kv
    heads split) and out products, its scores and values (batched over
    the heads), the MLP's three; the logits."""
    tokens, d, V = b * l, cfg.d_model, cfg.vocab_size
    if cfg.family == "mamba2":
        per_layer = 6 * tokens * cfg.expand * d * d
    else:
        nq, nkv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
        kv = 2 * d * nkv * hd if nkv % m == 0 else 0
        per_layer = 6 * tokens * (d * nq * hd + kv + nq * hd * d + 3 * d * f) \
            + 6 * 2 * b * nq * l * l * hd
    return cfg.n_layers * per_layer + 6 * tokens * d * V


@pytest.mark.parametrize("run,spec", [("mamba", MAMBA),
                                      ("deepseek", DEEPSEEK),
                                      ("gemma", GEMMA)])
def test_each_rank_computes_its_share_of_the_split_products(world8, run,
                                                            spec):
    """Each rank's ``FlopCounterMode`` total for one step is the
    one-device step's on its rows less (m - 1) / m of the products the
    split divides (``_split_flops``), exactly; and the leaves it gathered
    over ``model`` are exactly kernel 2's operands (mamba2), the kv
    projections whose split cuts gemma-2b's one kv head, and none of
    deepseek-7b's."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg, params = world8[{"mamba": "cfg", "deepseek": "dcfg",
                          "gemma": "gcfg"}[run]], \
        world8[{"mamba": "tp", "deepseek": "dtp", "gemma": "gtp"}[run]]
    model = build_model(cfg, "cpu")
    tc = programs.train_config(dict(spec, schedule=SCHED))
    state = programs.initial_state(model, dict(spec, params=params), tc)
    rows = programs._rows(world8["batches"][0], slice(0, 4), "cpu")
    with FlopCounterMode(display=False) as counter:
        programs.make_train_step(model, tc)(state, rows)
    one = counter.get_total_flops()
    split = _split_flops(cfg, 4, 4, 32)
    assert split % 4 == 0 and 0 < split <= one
    for r in world8[run]:
        assert r["flops"] == one - 3 * split // 4
    # A layer's leaves, its "['layers'][i]" prefix dropped.
    gathered = {p.split("]", 2)[2]
                for p in world8[run][0]["model_split"]["gathered"]}
    assert gathered == {
        "mamba": {"['mixer']['in_proj']['w']", "['mixer']['conv']['w']",
                  "['mixer']['conv']['b']"},
        "deepseek": set(),
        "gemma": {"['attn']['wk']['w']", "['attn']['wv']['w']"}}[run]
    assert len(world8[run][0]["model_split"]["gathered"]) == \
        {"mamba": 3, "deepseek": 0, "gemma": 2}[run] * cfg.n_layers


def test_whole_batch_check_fails_a_half_batch_step(world8):
    """``programs.whole_batch_steps`` (chip_smoke.py's check of the ranks
    against the one-process step on the whole batch, its compute split
    over ``model`` as the ranks split it): the ranks' AdamW moments and
    update sit at the fp32 noise of the batch split's reordered sums
    (measured 9.51e-8 and 3.52e-6 of their norms here; 9.34e-8 and
    3.52e-6 before the split over ``model``), while the control, that step
    on half the batch, sits far (0.590 and 0.831); the losses within
    ``LOSS_ORDER_TOL`` of the split reference and of the plain one-process
    step (which the split reference's moments and update sit 1.48e-5 and
    3.77e-5 from: the split's reordered sums, carried as the gradients
    carry fp32 rounding, ``test_torch_tensor_parallel.py:
    test_split_departs_from_the_whole_step_by_its_rounding``); and the
    first batch's gradient split over the 4 model ranks against whole
    (``programs.split_fp32_departures``) within 1e-4 of its norm, the
    half-batch control past 0.1."""
    wb = world8["mamba"][1]["whole_batch"]
    assert wb["split"]
    assert wb["fp32"]["split"] <= 1e-4 and wb["fp32"]["control"] > 0.1
    assert wb["got"]["moments"] <= 1e-5 and wb["got"]["update"] <= 1e-5
    assert wb["control"]["moments"] > 0.1 and wb["control"]["update"] > 0.1
    losses = [m["loss"] for m in world8["mamba"][0]["metrics"]]
    for ref in (wb["metrics"], wb["plain"]["metrics"]):
        np.testing.assert_allclose(losses, [m["loss"] for m in ref],
                                   rtol=0, atol=LOSS_ORDER_TOL)


def test_train_step_on_2x4_matches_jax_one_device(world8):
    """The same run against JAX's one-device ``make_train_step`` on the
    whole batch, at tests/test_torch_train.py's tolerance: losses, grad
    norms and lr at rtol 1e-4; params within 1e-5 of each leaf's largest
    value plus 5% of the base learning rate."""
    w = world8
    jtc = JTrainConfig(optimizer=JAdamW(), schedule=JSched(**SCHED))
    jstate = {"params": w["jp"], "opt": jadamw.init(w["jp"], jtc.optimizer)}
    jstep = jax.jit(jmake_train_step(w["jm"], jtc))
    for s, batch in enumerate(w["batches"]):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        got = w["mamba"][0]["metrics"][s]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], float(jmet[k]), rtol=1e-4,
                                       err_msg=(s, k))
    got = to_jax_params(w["mamba"][0]["state"]["params"], w["cfg"])
    for path, ref in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jstate["params"]))[0]:
        node = got
        for k in path:
            node = node[k.key]
        err = np.abs(node - ref).max()
        assert err <= 1e-5 * np.abs(ref).max() + 0.05 * 1e-3, (
            jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("run", ["deepseek", "gemma"])
def test_multidevice_matches_single_device(world8, run):
    """deepseek-7b (4 kv heads: every projection split) and gemma-2b (MQA:
    ``wk`` / ``wv`` gathered over ``model``) reduced, fp32, on 8 ranks
    with their compute split over ``model``: the loss within 1e-3 of
    JAX's one-device loss on the same weights (tests/test_distributed.py:
    88), within ``LOSS_ORDER_TOL`` of the port's one-process loss, and the
    step bit for bit with its emulation."""
    w = world8
    jm, jp, cfg, tp = {"deepseek": ("dm", "dp", "dcfg", "dtp"),
                       "gemma": ("gm", "gp", "gcfg", "gtp")}[run]
    batch = w["batches"][0]
    got = w[run][0]["metrics"][0]["loss"]
    jl, _ = w[jm].loss(w[jp], {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(got - float(jl)) < 1e-3, (got, float(jl))
    model = build_model(w[cfg], "cpu")
    params = tree_map(torch.from_numpy, w[tp])
    tl, _ = model.loss(params, {k: torch.from_numpy(v).long()
                                for k, v in batch.items()})
    assert abs(got - float(tl)) < LOSS_ORDER_TOL, (got, float(tl))
    assert w[run][0]["emulation"]["state"] == []
    assert w[run][0]["metrics"] == w[run][0]["emulation"]["metrics"]
    assert all(r["model_split"]["split"] for r in w[run])


# ---------------------------------------------------------------------------
# World of 4: the compressed cross-pod sync on (pod, data) = (2, 2)
# ---------------------------------------------------------------------------

JAX_COMPRESSED = """
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.distributed import collectives
    from repro.models import build_model
    from repro.nn.params import init_params
    from repro.optim import AdamWConfig, ScheduleConfig, adamw
    from repro.train import TrainConfig, make_train_step

    out, sched = sys.argv[1], json.loads(sys.argv[2])
    cfg = get_config("mamba2-130m", reduced=True).replace(
        param_dtype="float32")
    model = build_model(cfg)
    params = init_params(model.param_specs(), jax.random.PRNGKey(0),
                         jnp.float32)
    tc = TrainConfig(optimizer=AdamWConfig(),
                     schedule=ScheduleConfig(**sched),
                     compressed_cross_pod=True)
    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    state = {"params": params, "opt": adamw.init(params, tc.optimizer),
             "err": collectives.init_errors(params)}
    step = jax.jit(make_train_step(model, tc, mesh))
    pod_of = {d: p for p in range(2) for d in mesh.devices[p]}
    saved = {}
    for s in range(3):
        toks = np.random.default_rng(10 + s).integers(
            1, cfg.vocab_size, (4, 32)).astype(np.int32)
        with mesh:
            state, met = step(state, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(toks)})
        for k in ("loss", "grad_norm", "lr"):
            saved[f"{s}/metric/{k}"] = np.asarray(met[k])
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]:
            saved[f"{s}/params/{jax.tree_util.keystr(path)}"] = \\
                np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["err"])[0]:
            for shard in leaf.addressable_shards:
                key = f"{s}/err{pod_of[shard.device]}/" \\
                    f"{jax.tree_util.keystr(path)}"
                saved[key] = np.asarray(shard.data)
    np.savez(out, **saved)
"""


def _blocks(a):
    """A leaf as the wire's rows of 256 (zero-padded)."""
    flat = a.reshape(-1)
    return np.pad(flat, (0, (-flat.size) % 256)).reshape(-1, 256)


def _keyed(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_pods") / "jax.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_COMPRESSED), str(out),
         json.dumps(SCHED)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _, _, cfg, tp = _jax_pair(COMPRESSED)
        batches = _batches(3, 4, 32, cfg.vocab_size, 10)
        run = dict(COMPRESSED, params=tp, schedule=SCHED, shape=(2, 2),
                   axes=("pod", "data"), compressed=True, emulate=True,
                   snapshots=True)
        res = launch.spawn(programs.train_rank, 4,
                           ({"batches": batches, "runs": [run]},),
                           timeout_s=300)
    finally:
        log, _ = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, log
    with np.load(out) as data:
        jax_out = {k: data[k] for k in data.files}
    return dict(ranks=[r[0] for r in res], jax=jax_out, cfg=cfg)


def test_compressed_train_step_on_two_pods_is_its_emulation(compressed):
    """Three steps on (pod, data) = (2, 2): the params, AdamW's moments and
    both pods' residuals equal, bit for bit, one process that quantizes
    each pod's data-mean gradient with its own residual and adds the two
    pods' wire in pod order (two operands: one order); the pod all-reduce
    is one fp32 all-reduce a leaf."""
    r0 = compressed["ranks"][0]
    emu = r0["emulation"]
    assert emu["state"] == [] and r0["metrics"] == emu["metrics"]
    assert emu["err"] == [(0, []), (1, [])]
    col = r0["collectives"][0]
    assert col["all_reduce"]["count"] == len(jax.tree.leaves(
        to_jax_params(r0["snapshots"][0]["params"], compressed["cfg"])))


# Two pods' int8 flips compound: an element whose int8 value flipped on
# one side moves the params by up to a few lr, and the next step's
# gradients move with them.  Measured against JAX here (the first two
# steps held as the one-pod test holds them): flips 0.054%, 0.48% and
# 2.93% of the elements after steps 0, 1 and 2; the grad norm 5.1e-6,
# 1.1e-6 and 3.2e-4 off; flipped elements at most 0, 4.54e-4 and 7.97e-4
# off (the lr summed over the steps: 0, 5e-4, 1.5e-3); after step 2, 2 of
# the 276208 elements that never flipped sit past the one-device
# tolerance.  The limits: the one-pod test's for steps 0 and 1; at step 2
# the grad norm at 1e-3 and at most ``LATE_OUTLIERS`` never-flipped
# elements past the tolerance; at every step each element within the lr
# summed so far plus the tolerance.
TIGHT_STEPS = 2
LATE_NORM_RTOL = 1e-3
LATE_OUTLIERS = 10
FLIP_SHARE = 0.05


def test_compressed_train_step_matches_jax_over_three_steps_two_pods(
        compressed):
    """tests/test_torch_distributed.py's compressed-step test from one pod
    to two: JAX's ``make_train_step`` on a (2, 2) pod x data mesh of fake
    CPU devices (its ``shard_map`` branch; each pod's residual read off
    that pod's devices) against the port's ranks, step by step: losses and
    lr at rtol 1e-4; every residual of both pods within one quantization
    step of JAX's (half a step from zero on either side); the grad norm at
    rtol 1e-4 for the first ``TIGHT_STEPS`` steps; the params as
    tests/test_torch_train.py holds them except where an int8 value
    flipped (from ``TIGHT_STEPS`` on, but ``LATE_OUTLIERS`` elements); each
    element within the lr summed over the steps so far plus that
    tolerance."""
    cfg, jx = compressed["cfg"], compressed["jax"]
    flips, lr_sum = {}, 0.0
    for s, snap in enumerate(compressed["ranks"][0]["snapshots"]):
        got_met = compressed["ranks"][0]["metrics"][s]
        for k in ("loss", "grad_norm", "lr"):
            rtol = LATE_NORM_RTOL if k == "grad_norm" and \
                s >= TIGHT_STEPS else 1e-4
            np.testing.assert_allclose(got_met[k],
                                       float(jx[f"{s}/metric/{k}"]),
                                       rtol=rtol, err_msg=(s, k))
        lr_sum += float(jx[f"{s}/metric/lr"])
        for p in range(2):
            for path, got in _keyed(to_jax_params(snap["errs"][p],
                                                  cfg)).items():
                ref = jx[f"{s}/err{p}/{path}"]
                half = np.maximum(_blocks(np.abs(ref)),
                                  _blocks(np.abs(got))).max(1, keepdims=True)
                d = _blocks(np.abs(got - ref))
                assert (d <= 2 * half * (1 + 1e-5)).all(), (s, p, path)
                moved = (d > half).reshape(-1)[:ref.size].reshape(ref.shape)
                flips[path] = flips.get(path, False) | moved
        outliers = 0
        for path, got in _keyed(to_jax_params(snap["params"], cfg)).items():
            ref = jx[f"{s}/params/{path}"]
            diff = np.abs(got - ref)
            tol = 1e-5 * np.abs(ref).max() + 0.05 * 1e-3
            outliers += int((diff[~flips[path]] > tol).sum())
            assert (diff <= lr_sum + tol).all(), (s, path, diff.max())
        assert outliers <= (0 if s < TIGHT_STEPS else LATE_OUTLIERS), \
            (s, outliers)
    n = sum(f.size for f in flips.values())
    assert sum(f.sum() for f in flips.values()) < FLIP_SHARE * n
