"""The port's mesh tooling against the JAX package: logical axes, param
counts and bytes, the sharding rules on abstract meshes of 256 and 512
devices, the shape cells, abstract caches and states, the compressed pod
sync and the compressed train step, the pipeline schedule, the elastic
re-shard, the accounting flag, the op-stream fingerprints and
``launch/train.py --mesh``.

Everything runs in this process on the CPU.  ``resolve_spec`` reads only
``mesh.shape``, so a duck mesh (``SimpleNamespace(shape=...)``) stands in
for the JAX package's 256- and 512-device meshes; JAX's ``shard_map``
runs on a one-device ``("pod", "data", "model")`` mesh.
"""
import hashlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config, shapes as jshapes
from repro.configs.registry import ASSIGNED as JASSIGNED, \
    list_archs as jlist_archs
from repro.core import accounting as jaccounting
from repro.distributed import collectives as jcoll, \
    pipeline as jpipeline, sharding as jsharding
from repro.launch import hlo_analysis as jhlo
from repro.models import build_model as jbuild
from repro.nn import params as jparams
from repro.optim import AdamWConfig as JAdamW, ScheduleConfig as JSched, \
    adamw as jadamw
from repro.train import TrainConfig as JTrainConfig, \
    abstract_state as jabstract_state, make_train_step as jmake_train_step
from repro_torch.configs import get_config, shapes
from repro_torch.configs.registry import ASSIGNED, list_archs
from repro_torch.core import accounting
from repro_torch.distributed import api, collectives, pipeline, sharding
from repro_torch.launch import hlo_analysis, mesh as mesh_mod, \
    train as train_cli
from repro_torch.models import build_model
from repro_torch.nn import params as tparams
from repro_torch.nn.params import ParamSpec, from_jax_params, \
    init_params, to_jax_params, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw
from repro_torch.runtime import reshard_state
from repro_torch.train import TrainConfig, abstract_state, init_state, \
    make_train_step

ARCHS = list_archs()
MESHES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}
MESH_SHAPES = {"single": (16, 16), "multi": (2, 16, 16)}


def _duck(axes, sizes):
    return types.SimpleNamespace(shape=dict(zip(axes, sizes)))


def _jax_leaves(specs):
    return [(jax.tree_util.keystr(p), s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=jparams.is_spec)[0]]


def _dict_leaves(tree):
    """Leaves of nested dicts in sorted-key order (a spec tuple is one
    leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _dict_leaves(tree[k])]
    return [tree]


def _specs(arch):
    return (jbuild(jget_config(arch)).param_specs(),
            build_model(get_config(arch), "meta").param_specs())


def test_registry_matches():
    assert list_archs() == jlist_archs()
    assert ASSIGNED == JASSIGNED


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_axes_counts_and_shardings(arch):
    """Every leaf at full size: path, shape and logical axes; the param
    count and bf16 bytes; every spec on abstract (16, 16) and (2, 16, 16)
    meshes with its fallback report, leaf for leaf."""
    jspecs, tspecs = _specs(arch)
    jl = _jax_leaves(jspecs)
    tl = list(sharding._with_paths(tspecs))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert t.shape == j.shape and t.axes == j.axes, path
        assert t.init == j.init and t.scale == j.scale, path
    assert tparams.count_params(tspecs) == jparams.count_params(jspecs)
    assert tparams.param_bytes(tspecs, torch.bfloat16) == \
        jparams.param_bytes(jspecs, jnp.bfloat16)
    assert tree_leaves(tparams.logical_axes(tspecs)) == [
        a for _, s in jl for a in s.axes]
    rules = dict(jsharding.DEFAULT_RULES)
    for kind, axes in MESHES.items():
        sizes = MESH_SHAPES[kind]
        tmesh = mesh_mod.make_mesh(sizes, axes)
        jmesh = _duck(axes, sizes)
        shard, report = sharding.make_shardings(tspecs, tmesh)
        jreport = jsharding.ShardingReport()
        jspec = [tuple(jsharding.resolve_spec(s, jmesh, rules, p, jreport))
                 for p, s in jl]
        assert [s.spec for s in _dict_leaves(shard)] == jspec
        assert _dict_leaves(sharding.make_pspecs(tspecs, tmesh)) == jspec
        assert report.fallbacks == jreport.fallbacks
        assert report.summary() == jreport.summary()


def test_divisibility_fallback_on_a_2x4_mesh():
    """The JAX suite's (2, 4) case (tests/test_distributed.py:26)."""
    specs = {"ok": ParamSpec((16, 8), ("embed", "mlp")),
             "bad": ParamSpec((16, 6), ("embed", "mlp")),
             "expert": ParamSpec((2, 8, 8), ("expert", "embed", "mlp"))}
    jspecs = {k: jparams.ParamSpec(s.shape, s.axes) for k, s in specs.items()}
    shard, report = sharding.make_shardings(
        specs, mesh_mod.make_mesh((2, 4), ("data", "model")))
    assert shard["ok"].spec == ("data", "model")
    assert shard["bad"].spec[1] is None
    assert shard["expert"].spec[0] is None
    assert len(report.fallbacks) == 2
    jmesh = _duck(("data", "model"), (2, 4))
    rules = dict(jsharding.DEFAULT_RULES)
    for k in specs:
        assert shard[k].spec == tuple(jsharding.resolve_spec(
            jspecs[k], jmesh, rules))


# ---------------------------------------------------------------------------
# Shape cells, inputs, caches, states
# ---------------------------------------------------------------------------

def _nbytes_torch(t):
    return t.numel() * t.element_size()


def _nbytes_jax(s):
    return math.prod(s.shape) * np.dtype(s.dtype).itemsize


def _torch_leaves(tree, pre=""):
    """(path, tensor) of a cache or state tree: dicts, lists, named
    tuples."""
    if isinstance(tree, torch.Tensor):
        return [(pre, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _torch_leaves(tree[k], f"{pre}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k in tree._fields
                for x in _torch_leaves(getattr(tree, k), f"{pre}.{k}")]
    return [x for i, v in enumerate(tree)
            for x in _torch_leaves(v, f"{pre}[{i}]")]


# The one cache whose layout is the port's own: RecurrentGemma keeps one
# stack of its recurrent layers' states and one of its attention layers'
# rings (models/recurrentgemma.py), the JAX package one stack per group
# position plus the tail.  The bytes are the same.
OWN_CACHE_LAYOUT = {"recurrentgemma-2b"}


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_cells_inputs_and_abstract_cache(arch):
    """SHAPES and ``applicable`` for every cell; the input builders'
    shapes and dtypes (token ids int64 in the port, the index type its
    embeddings and gathers take, int32 in JAX); ``abstract_cache`` in
    bytes, and leaf for leaf where the layout is JAX's."""
    assert {k: (s.kind, s.seq_len, s.global_batch) for k, s in
            shapes.SHAPES.items()} == {
        k: (s.kind, s.seq_len, s.global_batch)
        for k, s in jshapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmodel, model = jbuild(jcfg), build_model(cfg, "meta")
    for name, shape in shapes.SHAPES.items():
        jshape = jshapes.SHAPES[name]
        assert shapes.applicable(cfg, shape) == jshapes.applicable(
            jcfg, jshape)
        for fn in ("batch_inputs", "prefill_inputs", "decode_inputs"):
            got = getattr(shapes, fn)(cfg, shape)
            want = getattr(jshapes, fn)(jcfg, jshape)
            assert sorted(got) == sorted(want), fn
            for k, t in got.items():
                assert t.is_meta and tuple(t.shape) == want[k].shape
                if k in ("tokens", "labels", "token"):
                    assert t.dtype == torch.int64 and \
                        want[k].dtype == jnp.int32
                else:
                    assert str(t.dtype) == f"torch.{want[k].dtype}", k
        if name != "decode_32k" and name != "long_500k":
            continue
        got = _torch_leaves(shapes.abstract_cache(model, cfg, shape,
                                                  cfg.dtype))
        want = jax.tree_util.tree_flatten_with_path(
            jshapes.abstract_cache(jmodel, jcfg, jshape, jcfg.dtype))[0]
        assert all(t.is_meta for _, t in got)
        assert sum(_nbytes_torch(t) for _, t in got) == \
            sum(_nbytes_jax(s) for _, s in want)
        if arch in OWN_CACHE_LAYOUT:
            continue
        assert [(p, tuple(t.shape), str(t.dtype)) for p, t in got] == [
            (jax.tree_util.keystr(p), s.shape, f"torch.{s.dtype}")
            for p, s in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_bytes(arch):
    """``abstract_state`` with the dry run's optimizer policy (bf16
    moments above 64B params) and with the compressed sync's residuals:
    the bytes of params, each moment, the step and ``err`` equal JAX's."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmodel, model = jbuild(jcfg), build_model(cfg, "meta")
    big = tparams.count_params(model.param_specs()) > 64e9
    md = "bfloat16" if big else "float32"
    for compressed in (False, True):
        got = abstract_state(model, TrainConfig(
            optimizer=AdamWConfig(m_dtype=md, v_dtype=md),
            compressed_cross_pod=compressed))
        want = jabstract_state(jmodel, JTrainConfig(
            optimizer=JAdamW(m_dtype=md, v_dtype=md),
            compressed_cross_pod=compressed))
        assert sorted(got) == sorted(want)
        for part in [("params",), ("opt", "m"), ("opt", "v"),
                     ("opt", "step")] + ([("err",)] if compressed else []):
            g, w = got, want
            for k in part:
                g, w = g[k], w[k]
            assert all(t.is_meta for t in tree_leaves(g))
            assert sum(_nbytes_torch(t) for t in tree_leaves(g)) == sum(
                _nbytes_jax(s) for s in jax.tree.leaves(w)), part


# Digests of the reduced configs' params (seed 3, the config dtype) as
# the tree stood before ParamSpec gained its axes and dtype: ``init_params``
# and ``from_jax_params`` (of JAX's init from PRNGKey(3)).
# One arch of each trunk layout: stacked, grouped with a tail, unstacked.
PARAM_DIGESTS = {
    "mamba2-130m": ("516ff0722a1ad267", "a257bcdb24ecd8ba"),
    "recurrentgemma-2b": ("6908e115efa3482f", "cf8e44d1b00e2077"),
    "whisper-tiny": ("0170d0a858755cc0", "b17e1343845b7b02"),
}


def _digest(tree):
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(str((tuple(t.shape), t.dtype)).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("arch", sorted(PARAM_DIGESTS))
def test_init_and_bridge_bit_identical_to_before(arch):
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, "cpu")
    jcfg = jget_config(arch, reduced=True)
    jp = jparams.init_params(jbuild(jcfg).param_specs(),
                             jax.random.PRNGKey(3), jcfg.dtype)
    assert (_digest(init_params(model.param_specs(), 3, cfg.dtype, "cpu")),
            _digest(from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                    "cpu"))) == PARAM_DIGESTS[arch]
    meta = tparams.abstract_params(model.param_specs(), cfg.dtype)
    real = init_params(model.param_specs(), 3, cfg.dtype, "cpu")
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(meta)] == [
        (tuple(t.shape), t.dtype) for t in tree_leaves(real)]


# ---------------------------------------------------------------------------
# The compressed pod sync and the train step
# ---------------------------------------------------------------------------

def _one_device_pod_mesh():
    return jax.make_mesh((1, 1, 1), ("pod", "data", "model"))


def test_compressed_pod_psum_bit_for_bit_over_three_steps():
    rng = np.random.default_rng(7)
    shapes_ = {"a": (3, 300), "b": (257,), "c": {"d": (2, 2, 64)}}
    jmesh = _one_device_pod_mesh()
    jfn = jax.jit(jcoll.shard_map(
        lambda g, e: jcoll.compressed_pod_psum(g, e, "pod"), mesh=jmesh,
        axis_names={"pod"}, in_specs=(P(), P()), out_specs=(P(), P())))
    tmesh = mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model"))
    grads_np = [jax.tree.map(
        lambda s: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 2)
                   ).astype(np.float32), shapes_,
        is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    jerr = jcoll.init_errors(grads_np[0])
    terr = collectives.init_errors(tree_map(torch.from_numpy,
                                            grads_np[0]))
    for g in grads_np:
        jred, jerr = jfn(g, jerr)
        tred, terr = collectives.compressed_pod_psum(
            tree_map(torch.from_numpy, g), terr, "pod", tmesh)
        for got, want in ((tred, jred), (terr, jerr)):
            for t, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    # A pod axis above 1 reduces over ranks (tests/test_torch_multirank.py);
    # an abstract mesh has none.
    wide = mesh_mod.make_mesh((2, 1, 1), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="without ranks"):
        collectives.compressed_pod_psum(tred, terr, "pod", wide)


def test_quantize_rounds_half_to_even():
    x = torch.zeros(256)
    x[0], x[1], x[2] = 127.0, 0.5 * 127.0 / 127.0, 2.5
    q, scale = collectives._quantize(x)
    jq, jscale = jcoll._quantize(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def _paired(port_jax_tree, jax_tree):
    """(path, port leaf, JAX leaf) as numpy, leaf for leaf."""
    for path, ref in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jax_tree))[0]:
        node = port_jax_tree
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), node, ref


def _blocks(a):
    """A leaf as the wire's rows of 256 (zero-padded)."""
    flat = a.reshape(-1)
    return np.pad(flat, (0, (-flat.size) % 256)).reshape(-1, 256)


def test_compressed_train_step_matches_jax_over_three_steps():
    """REDUCED mamba2-130m in fp32, ``compressed_cross_pod`` on a mesh
    with a pod axis of 1: three steps against JAX's on its one-device pod
    mesh, within tests/test_torch_train.py's tolerance; ``err`` carried."""
    jcfg = jget_config("mamba2-130m", reduced=True).replace(
        param_dtype="float32")
    jm = jbuild(jcfg)
    jp = jparams.init_params(jm.param_specs(), jax.random.PRNGKey(0),
                             jnp.float32)
    cfg = get_config("mamba2-130m", reduced=True).replace(
        param_dtype="float32")
    tm = build_model(cfg, "cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    sched = dict(base_lr=1e-3, warmup_steps=2, total_steps=50)
    jtc = JTrainConfig(optimizer=JAdamW(), schedule=JSched(**sched),
                       compressed_cross_pod=True)
    tc = TrainConfig(optimizer=AdamWConfig(),
                     schedule=ScheduleConfig(**sched),
                     compressed_cross_pod=True)
    jmesh = _one_device_pod_mesh()
    tmesh = mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model"),
                               devices=["cpu"])
    jstate = {"params": jp, "opt": jadamw.init(jp, jtc.optimizer),
              "err": jcoll.init_errors(jp)}
    tstate = {"params": tp, "opt": adamw.init(tp, tc.optimizer),
              "err": collectives.init_errors(tp)}
    jstep = jax.jit(jmake_train_step(jm, jtc, jmesh))
    tstep = make_train_step(tm, tc, tmesh)
    flips = {}
    for s in range(3):
        toks = np.random.default_rng(10 + s).integers(
            1, cfg.vocab_size, (2, 32)).astype(np.int32)
        with jmesh:
            jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(toks)})
        tt = torch.from_numpy(toks).long()
        tstate, tmet = tstep(tstate, {"tokens": tt, "labels": tt})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4, err_msg=(s, k))
        # A residual lies within half a quantization step of zero on
        # either side (the larger of the two blocks' largest |residual|:
        # the sides' scales differ by the gradients' noise).  Where the two
        # sides' fp32 gradients straddle a rounding boundary of q, the
        # residuals move a whole step apart: that element's int8 value
        # flipped, and AdamW then moves it by up to a few lr.  Every other
        # element is held as tests/test_torch_train.py holds the params.
        for path, got, ref in _paired(to_jax_params(tstate["err"], cfg),
                                      jstate["err"]):
            half = np.maximum(_blocks(np.abs(ref)), _blocks(np.abs(got))
                              ).max(1, keepdims=True)
            moved = _blocks(np.abs(got - ref)) > half
            assert (_blocks(np.abs(got - ref)) <= 2 * half * (1 + 1e-5)
                    ).all(), (s, path)
            flips[path] = flips.get(path, False) | moved.reshape(-1)[
                :ref.size].reshape(ref.shape)
        for path, got, ref in _paired(to_jax_params(tstate["params"], cfg),
                                      jstate["params"]):
            diff = np.abs(got - ref)
            tol = 1e-5 * np.abs(ref).max() + 0.05 * 1e-3
            assert (diff[~flips[path]] <= tol).all(), (s, path, diff.max())
            assert (diff <= 5 * 1e-3 * (s + 1)).all(), (s, path)
    # Flips gather in blocks whose gradients are at the fp32 noise of
    # their leaf (the tied table's rows of tokens not in the batch):
    # 0.92% of the elements over these three steps.
    n = sum(f.size for f in flips.values())
    assert sum(f.sum() for f in flips.values()) < 0.02 * n
    assert all(t.dtype == torch.float32 for t in tree_leaves(tstate["err"]))
    with pytest.raises(ValueError, match="without ranks"):
        make_train_step(tm, tc, mesh_mod.make_mesh(
            (2, 1, 1), ("pod", "data", "model")))
    state = init_state(tm, 0, tc)
    assert sorted(state) == ["err", "opt", "params"]


# ---------------------------------------------------------------------------
# Pipeline, re-shard, meshes, layouts, accounting
# ---------------------------------------------------------------------------

def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("stages,micro", [(4, 6), (4, 2)])
def test_pipeline_matches_reference_jax_and_its_gradients(stages, micro):
    rng = np.random.default_rng(stages * 10 + micro)
    d = 8
    params = {"w": (rng.standard_normal((stages, d, d)) / 3).astype(
        np.float32), "b": rng.standard_normal((stages, d)).astype(
        np.float32) * 0.1}
    mbs = rng.standard_normal((micro, 3, d)).astype(np.float32)
    cot = rng.standard_normal((micro, 3, d)).astype(np.float32)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(mbs).requires_grad_()
    out = pipeline.pipeline_apply(_stage, tp, tx)
    ref = torch.stack([pipeline.reference_apply(_stage, tp, tx[i])
                       for i in range(micro)])
    jout = jpipeline.pipeline_apply(_jstage, params, jnp.asarray(mbs))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              [tp["w"], tp["b"], tx])
    jgot = jax.grad(lambda p, x: jnp.sum(jpipeline.pipeline_apply(
        _jstage, p, x) * cot), argnums=(0, 1))(params, jnp.asarray(mbs))
    for g, w in zip(got, (jgot[0]["w"], jgot[0]["b"], jgot[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_reshard_state_round_trips_and_wide_meshes_raise():
    cfg = get_config("mamba2-130m", reduced=True)
    model = build_model(cfg, "cpu")
    state = init_state(model, 1, TrainConfig())
    state["opt"]["m"] = tree_map(torch.randn_like, state["params"])
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    out = reshard_state(state, model.param_specs(), mesh)
    for part in ("params", "opt"):
        for a, b in zip(tree_leaves(state[part]), tree_leaves(out[part])):
            assert b.device.type == "cpu" and torch.equal(a, b)
    back = reshard_state(out, model.param_specs(), mesh)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state), tree_leaves(back)))
    # Wider meshes span ranks (tests/test_torch_multirank.py): a world of
    # one process refuses them, and the 512-rank production mesh names
    # what it waits for.
    with pytest.raises(RuntimeError, match="spans 4 ranks"):
        mesh_mod.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
    two = mesh_mod.make_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="without ranks"):
        sharding.place(torch.zeros(4), sharding.Sharding(two, ("model",)))
    prod = mesh_mod.make_production_mesh(device="cpu")
    assert dict(prod.shape) == {"data": 1, "model": 1}
    assert mesh_mod.describe(prod) == "data=1 x model=1 (1 devices)"


def test_activation_layout_is_the_identity_on_one_card():
    x = torch.zeros(4, 8, 3)
    assert api.shard_tokens3d(x) is x and api.current_layout() is None
    one = mesh_mod.make_mesh((1, 1), ("data", "model"))
    with api.activation_layout(("data",), "model", mesh=one):
        assert api.shard_tokens3d(x) is x
        y = x[..., 0]
        assert api.shard_tokens2d(y) is y
        assert api.constrain_dims(x, {0: "batch", 1: "seq"}) is x
        assert api.batch_pspec(3) == (("data",), "model", None)
    wide = mesh_mod.make_mesh((4, 1), ("data", "model"))
    with api.activation_layout(("data",), None, mesh=wide):
        with pytest.raises(ValueError, match="4 devices of a mesh without"):
            api.shard_tokens3d(x)
    # On a mesh of ranks a rank holds its own rows: a batch constraint
    # moves nothing; a split over a sequence axis is not ported yet.
    ranked = mesh_mod.Mesh({"data": 4, "model": 2}, (torch.device("cpu"),)
                           * 8, rank=3)
    with api.activation_layout(("data",), None, mesh=ranked):
        assert api.shard_tokens3d(x) is x
        assert api.constrain_dims(x, {0: "batch"}) is x
    with api.activation_layout(("data",), "model", mesh=ranked):
        with pytest.raises(NotImplementedError, match="sequence axes is "
                           "not ported"):
            api.shard_tokens3d(x)
    assert api.batch_pspec(1) == (None,)


def test_accounting_matches_jax():
    for mod in (accounting, jaccounting):
        assert mod.inner_unroll(7) == 1
        with mod.unroll_inner_scans():
            assert mod.inner_unroll(7) == 7
            with mod.unroll_inner_scans():
                assert mod.inner_unroll(3) == 3
            assert mod.inner_unroll(7) == 7
        assert mod.inner_unroll(7) == 1


def test_fingerprint_and_schedule_diffs_match_jax():
    a = {"mm": {"count": 4, "bytes": 100}, "add": {"count": 2, "bytes": 8},
         "copy": {"count": 1, "bytes": 5}}
    b = {"mm": {"count": 4, "bytes": 100}, "add": {"count": 5, "bytes": 20},
         "cat": {"count": 1, "bytes": 7}}
    assert hlo_analysis.fingerprint_diff(a, b) == jhlo.fingerprint_diff(a, b)
    sa = [("mm", 10), ("add", 2), ("copy", 5), ("mm", 10), ("add", 2)]
    sb = [("mm", 10), ("cat", 7), ("add", 2), ("mm", 10), ("mul", 3),
          ("add", 2)]
    assert hlo_analysis.schedule_diff(sa, sb) == jhlo.schedule_diff(sa, sb)
    terms = hlo_analysis.roofline_terms(989e12, 3.35e12 * 2, 0, 0)
    assert terms["bottleneck"] == "memory_s" and terms["collective_s"] == 0
    assert hlo_analysis.parse_collectives().total_wire_bytes == 0


def test_op_trace_is_deterministic_and_layout_free():
    """Two calls give the same op stream on REDUCED mamba2-130m, and the
    two ``scan_layers`` settings issue the same one (the finding
    ``hlo_analysis.main`` prints)."""
    kw = dict(reduced=True)
    a = hlo_analysis.program_compiled("mamba2-130m", scan_layers=True, **kw)
    b = hlo_analysis.program_compiled("mamba2-130m", scan_layers=True, **kw)
    c = hlo_analysis.program_compiled("mamba2-130m", scan_layers=False, **kw)
    assert a == b == c
    fp = hlo_analysis.op_fingerprint(a)
    assert fp["kernel:mamba2_step"]["count"] == get_config(
        "mamba2-130m", reduced=True).n_layers
    assert hlo_analysis.fingerprint_diff(fp, fp) == []
    assert hlo_analysis.main(["--arch", "mamba2-130m", "--reduced"]) == []


def test_train_cli_takes_a_one_device_mesh_and_refuses_wider(capsys):
    state, monitor = train_cli.main([
        "--device", "cpu", "--reduced", "--steps", "1", "--batch", "2",
        "--seq", "16", "--mesh", "1x1:data,model"])
    assert monitor.summary()["steps"] == 1
    # A wider mesh trains on ranks (tests/test_torch_multirank.py); these
    # are refused before any rank starts.
    for bad, why in (("3x1:data,model", "does not split"),
                     ("1x2:data,expert", "at most once")):
        with pytest.raises(SystemExit) as exc:
            train_cli.main(["--device", "cpu", "--reduced", "--steps", "1",
                            "--mesh", bad])
        assert exc.value.code == 2
        assert why in capsys.readouterr().err
