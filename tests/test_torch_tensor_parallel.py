"""The train step's compute split over ``model``, in one process.

Each split function runs on ``collectives.EmulatedGroup`` (every model
rank's piece at the ranks' shapes, added in rank order, the bits of the
ranks: ``tests/test_torch_multirank_train.py`` holds the ranks to it) at
m = 2 and 4, against the port's whole function and the JAX package's on
the same numpy inputs from a seed; the gradients of every split function
against autograd of the whole one; the ranks' own Functions
(``RankGroup``'s) against finite differences with stand-in peers; and
``sharding.model_split``'s plan for every family.

What is bit for bit: the column-parallel product in fp32 (each output
column is the whole function's sum), the vocab-parallel embedding and
its gradient (one term of each sum is not zero), the accuracy's argmax.
What is not: a row-parallel product and the log-sum-exp add the same
terms in another order (fp32: ``SUM_RTOL`` of the largest element); a
bf16 product is rounded once from fp32 sums, as JAX's, within one bf16
ulp of JAX's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import base as jbase, build_model as jbuild
from repro.nn import attention as jattention, layers as jlayers, \
    mlp as jmlp
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import EmulatedGroup, RankGroup
from repro_torch.distributed.sharding import model_split, \
    per_layer_specs, make_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import base, build_model
from repro_torch.nn import attention, layers, mlp
from repro_torch.nn.params import from_jax_params, init_params, \
    tree_leaves, tree_map

MS = (2, 4)
# fp32 sums of the same terms in another order: max |split - whole| over
# the largest |whole| (measured here at most 2.4e-7 on the products,
# 1.9e-7 on the losses).
SUM_RTOL = 2e-6
# Against the JAX function on the same inputs (fp32).
JAX_RTOL, JAX_ATOL = 1e-5, 1e-6
# Gradients: max |split - whole| over each leaf's largest |whole|.
GRAD_RTOL = 1e-5
# The whole model's gradients against jax.value_and_grad (fp32, reduced
# configs, tests/test_torch_train.py's batch): its per-family limits, the
# dense transformer's (gemma-2b's) for deepseek-7b.
MODEL_GRAD_TOL = {"mamba2-130m": 2e-4, "gemma-2b": 1e-3,
                  "deepseek-7b": 1e-3}
LOSS_RTOL = 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _grads(fn, leaves, cot):
    """Gradients of ``sum(fn() * cot)`` at ``leaves``."""
    leaves = [t.detach().requires_grad_() for t in leaves]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad((out.float() * cot).sum(),
                                             leaves)


def _bf16_ulps(got: torch.Tensor, want: np.ndarray) -> float:
    """|got - want| in units of want's bf16 spacing (the largest)."""
    w = torch.from_numpy(np.asarray(want, np.float32))
    ulp = torch.maximum(w.abs(), torch.full_like(w, 2.0 ** -126)) * 2 ** -7
    return float(((got.float() - w).abs() / ulp).max())


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_column_linear(m, bias, dtype):
    """``linear_column``'s pieces put together: fp32 bit for bit with the
    whole ``linear`` (each output column is the same sum); bf16 within
    one bf16 ulp of JAX's ``linear`` (one rounding from fp32 sums); fp32
    within ``JAX_RTOL`` of it; the gradients of x, w and b within
    ``GRAD_RTOL`` of the whole function's (x's sums the ranks' partial
    products)."""
    xa, wa, ba = _np((2, 6, 16), 1), _np((16, 24), 2, 0.3), _np((24,), 3)
    p = {"w": _t(wa, dtype)}
    jp = {"w": jnp.asarray(wa).astype(jnp.bfloat16 if dtype ==
                                       torch.bfloat16 else jnp.float32)}
    if bias:
        p["b"], jp["b"] = _t(ba, dtype), jnp.asarray(ba).astype(jp["w"].dtype)
    x = _t(xa, dtype)
    g = EmulatedGroup(m)

    def split(x, *leaves):
        q = dict(zip(sorted(p), leaves))
        return torch.cat(layers.linear_column(q, g.copy(x.float()), g, 24,
                                              x.dtype), -1)

    def whole(x, *leaves):
        return layers.linear(dict(zip(sorted(p), leaves)), x)
    cot = _t(_np((2, 6, 24), 4))
    leaves = [x] + [p[k] for k in sorted(p)]
    y, gs = _grads(split, leaves, cot)
    y0, g0 = _grads(whole, leaves, cot)
    want = np.asarray(jlayers.linear(jp, jnp.asarray(xa).astype(
        jp["w"].dtype)).astype(jnp.float32))
    if dtype == torch.float32:
        assert torch.equal(y, y0)
        np.testing.assert_allclose(y.numpy(), want, rtol=JAX_RTOL,
                                   atol=JAX_ATOL)
        for a, b in zip(gs, g0):
            assert _rel(a, b) <= GRAD_RTOL
    else:
        assert y.dtype == torch.bfloat16
        assert _bf16_ulps(y, want) <= 1.0
        for a, b in zip(gs, g0):
            assert _rel(a, b) <= 2 ** -7


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("bias", [False, True])
def test_row_linear(m, bias):
    """``linear_row`` on each rank's columns of x: the ranks' fp32 partial
    products summed in rank order, the bias added once after the sum,
    within ``SUM_RTOL`` of the whole ``linear`` and ``JAX_RTOL`` of JAX's;
    gradients within ``GRAD_RTOL``."""
    xa, wa, ba = _np((2, 6, 24), 5), _np((24, 16), 6, 0.3), _np((16,), 7)
    p = {"w": _t(wa)}
    jp = {"w": jnp.asarray(wa)}
    if bias:
        p["b"], jp["b"] = _t(ba), jnp.asarray(ba)
    g = EmulatedGroup(m)

    def split(x, *leaves):
        return layers.linear_row(dict(zip(sorted(p), leaves)), g.cut(x, -1),
                                 g, 24)

    def whole(x, *leaves):
        return layers.linear(dict(zip(sorted(p), leaves)), x)
    cot = _t(_np((2, 6, 16), 8))
    leaves = [_t(xa)] + [p[k] for k in sorted(p)]
    y, gs = _grads(split, leaves, cot)
    y0, g0 = _grads(whole, leaves, cot)
    assert _rel(y, y0) <= SUM_RTOL
    np.testing.assert_allclose(y.numpy(), np.asarray(jlayers.linear(
        jp, jnp.asarray(xa))), rtol=JAX_RTOL, atol=JAX_ATOL)
    for a, b in zip(gs, g0):
        assert _rel(a, b) <= GRAD_RTOL


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_and_unembed_split(m, dtype):
    """The vocab-parallel embedding (each rank's rows, the rest zero,
    summed) bit for bit with ``embed`` and JAX's, and its table gradient
    bit for bit; the vocab-parallel logits put together within
    ``JAX_RTOL`` of ``unembed`` and JAX's (fp32 sums), their gradients
    within ``GRAD_RTOL``."""
    V, d = 32, 16
    ta = _np((V, d), 9)
    toks = np.random.default_rng(10).integers(0, V, (3, 7))
    toks[0, :3] = [0, V // m - 1, V // m]        # shard borders
    p = {"table": _t(ta, dtype)}
    tok = torch.from_numpy(toks)
    g = EmulatedGroup(m)
    cot = _t(_np((3, 7, d), 11))
    e, (ge,) = _grads(lambda t: layers.embed_split({"table": t}, tok, g, V),
                      [p["table"]], cot)
    e0, (ge0,) = _grads(lambda t: layers.embed({"table": t}, tok),
                        [p["table"]], cot)
    assert torch.equal(e, e0) and torch.equal(ge, ge0)
    jt = jnp.asarray(ta).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                else jnp.float32)
    assert torch.equal(e.float(), torch.from_numpy(np.asarray(
        jlayers.embed({"table": jt}, jnp.asarray(toks)).astype(
            jnp.float32))))
    xa = _np((3, 7, d), 12)
    cot = _t(_np((3, 7, V), 13))
    lg, gl = _grads(lambda x, t: torch.cat(layers.unembed_split(
        {"table": t}, x, g, V), -1), [_t(xa, dtype), p["table"]], cot)
    lg0, gl0 = _grads(lambda x, t: layers.unembed({"table": t}, x),
                      [_t(xa, dtype), p["table"]], cot)
    assert lg.dtype == torch.float32
    assert _rel(lg, lg0) <= SUM_RTOL
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlayers.unembed(
        {"table": jt}, jnp.asarray(xa).astype(jt.dtype))), rtol=JAX_RTOL,
        atol=JAX_ATOL)
    for a, b in zip(gl, gl0):
        assert _rel(a, b) <= (GRAD_RTOL if dtype == torch.float32
                              else 2 ** -7)


# ---------------------------------------------------------------------------
# The vocab-parallel cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_split(m, z_loss, masked):
    """``cross_entropy_loss`` on each rank's vocab columns (z-loss, labels
    < 0, a mask): loss within ``SUM_RTOL`` of the whole function's and
    ``LOSS_RTOL`` of JAX's; accuracy and tokens equal; the logits'
    gradient (the Function's own backward) within ``GRAD_RTOL`` of
    autograd through the whole function."""
    V = 40
    la = _np((3, 9, V), 14, 3.0)
    labels = np.random.default_rng(15).integers(0, V, (3, 9))
    labels[1, 2:5] = -1
    mask = (np.random.default_rng(16).random((3, 9)) > 0.3).astype(
        np.float32) if masked else None
    lab, mk = torch.from_numpy(labels), None if mask is None else _t(mask)
    g = EmulatedGroup(m)

    def split(x):
        with collectives.model_split(g):
            loss, met = base.cross_entropy_loss(list(x.chunk(m, -1)), lab,
                                                mk, z_loss)
        split.met = met
        return loss

    def whole(x):
        loss, met = base.cross_entropy_loss(x, lab, mk, z_loss)
        whole.met = met
        return loss
    one = torch.ones(())
    loss, (gl,) = _grads(split, [_t(la)], one)
    loss0, (gl0,) = _grads(whole, [_t(la)], one)
    assert _rel(loss, loss0) <= SUM_RTOL
    for k in ("accuracy", "tokens"):
        assert torch.equal(split.met[k], whole.met[k]), k
    assert _rel(gl, gl0) <= GRAD_RTOL
    jl, jm = jbase.cross_entropy_loss(
        jnp.asarray(la), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), z_loss)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert float(split.met["accuracy"]) == float(jm["accuracy"])


@pytest.mark.parametrize("m", MS)
def test_argmax_ties_on_a_shard_border(m):
    """The accuracy's argmax across shards breaks a tie between the last
    column of one rank and the first of the next (and between two ranks'
    maxima far apart) to the lower vocab index, as ``torch.argmax`` and
    ``jnp.argmax`` do."""
    V = 16
    n = V // m
    la = _np((1, 4, V), 17) - 10.0
    la[0, 0, [n - 1, n]] = 5.0                   # a tie on the border
    la[0, 1, [1, V - 1]] = 5.0                   # first and last rank
    la[0, 2, [n, V - 1]] = 5.0
    la[0, 3, [V - 2, V - 1]] = 5.0
    want = [n - 1, 1, n, V - 2]
    assert la.argmax(-1)[0].tolist() == want
    assert np.asarray(jnp.argmax(jnp.asarray(la), -1))[0].tolist() == want
    g = EmulatedGroup(m)
    for hit, lab in ((1.0, want), (0.0, [w + 1 for w in want])):
        with collectives.model_split(g):
            _, met = base.cross_entropy_loss(
                list(_t(la).chunk(m, -1)), torch.tensor([lab]))
        assert float(met["accuracy"]) == hit


# ---------------------------------------------------------------------------
# The MLP and attention
# ---------------------------------------------------------------------------

def _jax_block(arch, spec_fn, jspec_fn, seed):
    """One block's params from JAX's init of ``arch``'s reduced config,
    carried to the port's layout (fp32)."""
    jcfg = jget_config(arch, reduced=True).replace(param_dtype="float32")
    cfg = get_config(arch, reduced=True).replace(param_dtype="float32")
    jp = jinit(jspec_fn(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, cfg, jp, tree_map(lambda a: _t(a), jax.tree.map(
        np.asarray, jp))


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-7b"])
def test_gated_mlp_split(m, arch):
    """``mlp.apply`` with ``wi`` / ``wg`` column-parallel, the activation
    on each rank's columns and ``wo`` row-parallel (GeGLU, SwiGLU): within
    ``SUM_RTOL`` of the whole MLP and ``JAX_RTOL`` of JAX's; every
    gradient within ``GRAD_RTOL``."""
    jcfg, cfg, jp, p = _jax_block(arch, mlp.mlp_specs, jmlp.mlp_specs, 18)
    xa = _np((2, 8, cfg.d_model), 19)
    names = [n for n in ("wg", "wi", "wo") if n in p]
    g = EmulatedGroup(m)

    def run(group):
        def fn(x, *ws):
            q = {n: {"w": w} for n, w in zip(names, ws)}
            with collectives.model_split(group):
                return mlp.apply(q, cfg, x)
        return fn
    cot = _t(_np((2, 8, cfg.d_model), 20))
    leaves = [_t(xa)] + [p[n]["w"] for n in names]
    y, gs = _grads(run(g), leaves, cot)
    y0, g0 = _grads(run(None), leaves, cot)
    assert _rel(y, y0) <= SUM_RTOL
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jmlp.apply(
        jp, jcfg, jnp.asarray(xa))), rtol=JAX_RTOL, atol=JAX_ATOL)
    for a, b in zip(gs, g0):
        assert _rel(a, b) <= GRAD_RTOL


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch,flash", [("gemma-2b", True),
                                        ("gemma-2b", False),
                                        ("deepseek-7b", False),
                                        ("qwen1.5-4b", False)])
def test_attention_split(m, arch, flash):
    """The cache-less self-attention on each rank's query heads: MQA
    (gemma-2b reduced: 4 query heads, one kv head, whole on every rank;
    under ``use_flash`` kernel 9's plain version on a rank's heads),
    kv heads split (deepseek-7b), QKV biases split with their columns
    (qwen1.5-4b): within ``SUM_RTOL`` of the whole ``attention.apply``
    and ``JAX_RTOL`` of JAX's; every gradient within ``GRAD_RTOL``."""
    jcfg, cfg, jp, p = _jax_block(arch, attention.attention_specs,
                                  jattention.attention_specs, 21)
    cfg = cfg.replace(use_flash=flash)
    if cfg.qkv_bias:
        # Non-zero biases, the same on both sides.
        for k, n in zip(("wq", "wk", "wv"), (22, 23, 24)):
            b = _np(p[k]["b"].shape, n, 0.1)
            p[k]["b"] = _t(b)
            jp[k]["b"] = jnp.asarray(b)
    xa = _np((2, 8, cfg.d_model), 25)
    pos = torch.arange(8)[None, :].expand(2, 8)
    flat = [(k, n) for k in sorted(p) for n in sorted(p[k])]
    g = EmulatedGroup(m)

    def run(group):
        def fn(x, *ws):
            q = {}
            for (k, n), w in zip(flat, ws):
                q.setdefault(k, {})[n] = w
            with collectives.model_split(group):
                return attention.apply(q, cfg, x, positions=pos)[0]
        return fn
    cot = _t(_np((2, 8, cfg.d_model), 26))
    leaves = [_t(xa)] + [p[k][n] for k, n in flat]
    y, gs = _grads(run(g), leaves, cot)
    y0, g0 = _grads(run(None), leaves, cot)
    assert _rel(y, y0) <= SUM_RTOL
    want, _ = jattention.apply(jp, jcfg, jnp.asarray(xa),
                               positions=jnp.asarray(pos.numpy()))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=JAX_RTOL, atol=JAX_ATOL)
    for a, b in zip(gs, g0):
        assert _rel(a, b) <= GRAD_RTOL


# ---------------------------------------------------------------------------
# The slice as a whole, and remat
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    """JAX's reduced ``arch`` (fp32): its loss, metrics and gradients on
    tests/test_torch_train.py's batch, and the port's model, params and
    tokens on the same weights."""
    jcfg = jget_config(arch, reduced=True).replace(param_dtype="float32")
    jm = jbuild(jcfg)
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(0), jnp.float32)
    cfg = get_config(arch, reduced=True).replace(param_dtype="float32")
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 32)
                                             ).astype(np.int32)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    return (float(jl), float(jmet["accuracy"]),
            from_jax_params(jax.tree.map(np.asarray, jg), cfg, "cpu"),
            build_model(cfg, "cpu"),
            from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu"),
            torch.from_numpy(toks).long())


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma-2b", "deepseek-7b"])
def test_split_loss_and_grads_match_jax(m, arch):
    """The model's loss inside ``model_split`` (vocab-parallel embedding,
    logits and loss; the Mamba-2 out-projection or the attention and MLP
    products split) against ``jax.value_and_grad`` of JAX's loss on the
    same weights: the loss within ``LOSS_RTOL``, accuracy equal, every
    gradient leaf within ``MODEL_GRAD_TOL``."""
    jl, jacc, jg, model, tp, toks = _jax_loss_and_grads(arch)
    p = tree_map(lambda t: t.clone().requires_grad_(), tp)
    with collectives.model_split(EmulatedGroup(m)):
        loss, met = model.loss(p, {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(loss, tree_leaves(p))
    np.testing.assert_allclose(float(loss), jl, rtol=LOSS_RTOL)
    assert float(met["accuracy"]) == jacc
    for got, ref in zip(grads, tree_leaves(jg)):
        assert _rel(got, ref) <= MODEL_GRAD_TOL[arch]


def test_remat_recomputes_in_the_model_group():
    """Under ``remat="full"`` the layers' recompute runs in the backward
    with the forward's model group (``models/base.py: remat`` takes it
    along): the split gradients equal ``remat="none"``'s bit for bit."""
    cfg = get_config("mamba2-130m", reduced=True).replace(
        param_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(28).integers(
        1, cfg.vocab_size, (2, 32)))
    out = []
    for mode in ("none", "full"):
        model = build_model(cfg.replace(remat=mode), "cpu")
        p = init_params(model.param_specs(), 0, torch.float32, "cpu")
        p = tree_map(lambda t: t.requires_grad_(), p)
        with collectives.model_split(EmulatedGroup(2)):
            loss, _ = model.loss(p, {"tokens": toks, "labels": toks})
        out.append(torch.autograd.grad(loss, tree_leaves(p)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# The split step's gradients against the whole step's, both fp32, each
# leaf's distance (L2, relative) over the whole step's own distance from
# the same step in fp64: the split adds the same terms in another order
# (the out-projection's partial products, the logits' input gradient, the
# log-sum-exp), and the gradients carry that as they carry fp32 rounding.
# Measured here at most 1.47 at m = 2 (layer 1's A_log) and 0.90 at m = 4;
# the split's own distance from fp64 is the whole step's within 1.46x.
SPLIT_ROUNDING_RATIO = 2.0


@pytest.mark.parametrize("m", MS)
def test_split_departs_from_the_whole_step_by_its_rounding(m):
    """mamba2-130m reduced (d_model 64, head_dim 16, fp32, the multi-rank
    tests' model): at m = 1 the split code is the whole step bit for bit;
    at m = 2 and 4 each gradient leaf departs from the whole step's by no
    more than ``SPLIT_ROUNDING_RATIO`` times the whole step's own fp32
    rounding (its distance from fp64): reordered sums, no lost term."""
    cfg = get_config("mamba2-130m", reduced=True).replace(
        param_dtype="float32", d_model=64, ssm_head_dim=16)
    model = build_model(cfg, "cpu")
    p = init_params(model.param_specs(), 0, torch.float32, "cpu")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        1, cfg.vocab_size, (4, 32)))

    def grads(params, group=None):
        params = tree_map(lambda t: t.clone().requires_grad_(), params)
        with collectives.model_split(group):
            loss, _ = model.loss(params, {"tokens": toks, "labels": toks})
        return torch.autograd.grad(loss, tree_leaves(params))
    whole = grads(p)
    wide = grads(tree_map(lambda t: t.double(), p))
    for a, b in zip(grads(p, EmulatedGroup(1)), whole):
        assert torch.equal(a, b)

    def dist(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm())
    for got, w, w64 in zip(grads(p, EmulatedGroup(m)), whole, wide):
        assert dist(got, w) <= SPLIT_ROUNDING_RATIO * dist(w, w64)


@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma-2b"])
def test_split_fp32_departure_sits_far_below_its_control(arch):
    """``programs.split_fp32_departures``, ``chip_smoke.py``'s check of the
    split's arithmetic on the card: a bf16 reduced model's gradient at its
    start params on a ``SyntheticLM`` batch (b = 8, l = 64), widened to
    fp32, split over 2 model ranks against whole, sits at fp32 rounding
    (measured 4.6e-6 for mamba2, 1.7e-5 for gemma-2b), ten times inside
    ``SPLIT_FP32_TOL``; the whole step on half the rows sits past it by
    far (measured 0.987 and 0.994)."""
    from chip_smoke import SPLIT_FP32_TOL
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import programs
    cfg = get_config(arch, reduced=True).replace(param_dtype="bfloat16")
    model = build_model(cfg, "cpu")
    params = programs.initial_state(model, {"seed": 0},
                                    programs.train_config({}))["params"]
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   global_batch=8, seed=5)).next()
    got = programs.split_fp32_departures(model, params, batch, 2)
    assert got["split"] <= SPLIT_FP32_TOL / 10
    assert got["control"] > 10 * SPLIT_FP32_TOL


# ---------------------------------------------------------------------------
# The ranks' Functions, with stand-in peers
# ---------------------------------------------------------------------------

class _Peers(RankGroup):
    """A rank ``index`` of ``size`` whose peers hold ``peers`` (fixed
    tensors, the rank's own slot ignored): the Functions' collectives
    without processes."""

    def __init__(self, size, index, peers):
        self.size, self.index, self.peers = size, index, peers

    def _all(self, x):
        return [x if r == self.index else self.peers[r].to(x.dtype)
                for r in range(self.size)]

    def _sum(self, x, dtype=None):
        return collectives.add_in_order(self._all(x), dtype or x.dtype)


@pytest.mark.parametrize("m", MS)
def test_rank_functions_against_finite_differences(m):
    """``RankGroup``'s copy, reduce, gather and cut (peers zero: the
    rank's own part of each) pass ``torch.autograd.gradcheck`` in fp64;
    with peers, reduce adds in rank order and gather puts the pieces in
    rank order, bit for bit."""
    r = m - 1
    zeros = [torch.zeros(3, 4, dtype=torch.float64) for _ in range(m)]
    g = _Peers(m, r, zeros)
    x = torch.randn(3, 4, dtype=torch.float64, requires_grad=True)
    for fn in (lambda t: g.copy(t)[0] * 2.0,
               lambda t: g.reduce([t]),
               lambda t: g.gather([t], -1),
               lambda t: torch.cat(g.cut(torch.cat([t] * m, -1), -1))):
        assert torch.autograd.gradcheck(fn, (x,))
    peers = [torch.randn(3, 4) for _ in range(m)]
    g = _Peers(m, r, peers)
    x32 = torch.randn(3, 4)
    every = [x32 if i == r else peers[i] for i in range(m)]
    assert torch.equal(g.reduce([x32]), collectives.add_in_order(every))
    assert torch.equal(g.gather([x32], 0), torch.cat(every, 0))
    # The cut's gradient is every rank's piece put together.
    z = torch.zeros(3, 4 * m, requires_grad=True)
    (gz,) = torch.autograd.grad(g.cut(z, -1)[0], z, grad_outputs=x32)
    assert torch.equal(gz, torch.cat(every, -1))


# ---------------------------------------------------------------------------
# Which leaves the step keeps split
# ---------------------------------------------------------------------------

def _plan(arch, shape, reduced=True, **over):
    cfg = get_config(arch, reduced=reduced).replace(**over)
    specs = per_layer_specs(build_model(cfg, "cpu").param_specs())
    sh, _ = make_shardings(specs, make_mesh(shape, ("data", "model")))
    return model_split(specs, sh, cfg)


def test_model_split_plans():
    """``sharding.model_split``: mamba2 gathers exactly kernel 2's
    operands (``in_proj``, ``conv``) over ``model``; gemma-2b exactly
    ``wk`` / ``wv`` (one kv head cut), reduced and at full width; the
    multi-head transformers none; mamba-130m, recurrentgemma, whisper and
    the MoE transformers compute whole, every model-split leaf gathered,
    each with its reason."""
    plan = _plan("mamba2-130m", (2, 4))
    assert plan.split
    assert len(plan.gathered) == 3 * 2 and \
        {p.rsplit("['mixer']", 1)[1] for p, _ in plan.gathered} == \
        {"['conv']['b']", "['conv']['w']", "['in_proj']['w']"}
    assert {p for p, _ in plan.kept} == {
        "['embed']['table']", "['layers'][0]['mixer']['out_proj']['w']",
        "['layers'][1]['mixer']['out_proj']['w']"}
    for reduced in (True, False):
        plan = _plan("gemma-2b", (2, 2), reduced)
        assert {p.rsplit("['attn']", 1)[1] for p, _ in plan.gathered} == \
            {"['wk']['w']", "['wv']['w']"}
        assert all("cuts heads" in w for _, w in plan.gathered)
    for arch in ("deepseek-7b", "qwen1.5-4b", "internlm2-20b"):
        plan = _plan(arch, (2, 2))
        assert plan.split and plan.gathered == () and plan.kept
    for arch in ("mamba-130m", "recurrentgemma-2b", "whisper-tiny",
                 "qwen3-moe-30b-a3b"):
        plan = _plan(arch, (2, 2))
        assert not plan.split and plan.why and plan.kept == ()
        assert all(w == plan.why for _, w in plan.gathered)
    assert not _plan("mamba2-130m", (4, 1)).split
