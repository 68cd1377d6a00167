"""The port's training path against the JAX package: the cross entropy
with a mask, AdamW, the schedules, every family's ``loss`` and its
gradients, the train step, microbatches, remat, the kernels'
``torch.autograd.Function`` wiring and the gradient guard, and the
training CLI on the CPU.

Both packages take the same weights: the JAX package's fp32 params go
through ``repro_torch.nn.params.from_jax_params``.  The port runs on the
CPU here (its kernels' plain versions).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.core.xamba import XambaConfig as JXamba
from repro.models import base as jbase, build_model as jbuild
from repro.nn.params import init_params as jinit
from repro.optim import AdamWConfig as JAdamW, ScheduleConfig as JSched, \
    adamw as jadamw, lr_at as jlr_at
from repro.train import TrainConfig as JTrainConfig, \
    make_train_step as jmake_train_step
from repro.launch import flops as jflops
from repro.configs.shapes import SHAPES as JSHAPES
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.pwl import eval_pwl, get_table
from repro_torch.kernels import actiba, flash_attention, ops, prefill_chunk
from repro_torch.launch import flops, train as train_cli
from repro_torch.models import base, build_model
from repro_torch.nn.params import from_jax_params, to_jax_params, \
    tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw, lr_at
from repro_torch.train import TrainConfig, make_train_step

# Per-family gradient tolerance: max |port - JAX| over each leaf <= TOL x
# the leaf's max |JAX|.  Both sides are fp32 on the CPU; these random
# models amplify fp32 rounding by different amounts.  JAX's own fp32
# gradients sit, leaf for leaf, this far from its fp64 ones on the same
# params (b = 2, l = 64): mamba2 8.1e-5, gemma-2b 3.7e-4,
# recurrentgemma-2b 1.05e-3.  The port's measured distance from JAX's
# fp32 gradient at this batch: mamba2 3.9e-5, mamba-130m 1.6e-5,
# recurrentgemma-2b 2.5e-3, gemma-2b 1.2e-4, qwen3-moe 3.0e-4.  Each
# limit is 2-6x the port's reading and above JAX's own distance.
GRAD_TOL = {"mamba2-130m": 2e-4, "mamba-130m": 1e-4,
            "recurrentgemma-2b": 5e-3, "gemma-2b": 1e-3,
            "qwen3-moe-30b-a3b": 1e-3}
LOSS_RTOL = 1e-5


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _pair(arch, **overrides):
    """(jax model, jax fp32 params, port model, port fp32 params) of the
    reduced ``arch`` on one weight set."""
    jcfg = jget_config(arch, reduced=True).replace(param_dtype="float32",
                                                   **overrides)
    jm = jbuild(jcfg)
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(0), jnp.float32)
    cfg = get_config(arch, reduced=True).replace(param_dtype="float32",
                                                 **overrides)
    tm = build_model(cfg, "cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, tm, tp


def _batch(vocab, b=2, l=32, seed=1):
    toks = np.random.default_rng(seed).integers(1, vocab, (b, l)).astype(
        np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(toks).long()})


def _port_grads(model, params, batch):
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = model.loss(p, batch)
    leaves = tree_leaves(p)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, got)])
    return loss, metrics, tree_map(lambda _: next(it), p)


def _worst_leaf(port_jax_tree, jax_tree):
    """(worst max |diff| / max |ref| over the leaves, its key)."""
    worst, key = 0.0, None
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    for path, ref in flat:
        got = port_jax_tree
        for k in path:
            got = got[k.key]
        ref = np.asarray(ref, np.float64)
        r = np.abs(np.asarray(got, np.float64) - ref).max() / max(
            np.abs(ref).max(), 1e-30)
        if r > worst:
            worst, key = float(r), jax.tree_util.keystr(path)
    return worst, key


# ---------------------------------------------------------------------------
# The loss's pieces
# ---------------------------------------------------------------------------

def test_cross_entropy_mask_matches_jax(rng):
    logits = rng.standard_normal((2, 9, 17)).astype(np.float32) * 3
    labels = rng.integers(-1, 17, (2, 9)).astype(np.int32)
    mask = rng.integers(0, 2, (2, 9)).astype(np.int32)
    jl, jm = jbase.cross_entropy_loss(jnp.asarray(logits),
                                      jnp.asarray(labels),
                                      jnp.asarray(mask))
    tl, tm = base.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels).long(),
                                     torch.from_numpy(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]),
                               rtol=1e-6)
    assert int(tm["tokens"]) == int(jm["tokens"])
    unmasked, _ = base.cross_entropy_loss(torch.from_numpy(logits),
                                          torch.from_numpy(labels).long())
    assert float(unmasked) != float(tl)


# ---------------------------------------------------------------------------
# AdamW and the schedules against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(rng, param_dtype):
    """Two steps from a nonzero state, weight decay and clipping on."""
    cfg = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    shapes = {"w": (6, 5), "b": (5,), "layers": {"x": (3, 4)}}
    p = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s), jdt),
                     shapes, is_leaf=lambda s: isinstance(s, tuple))
    jstate = jadamw.init(p, JAdamW(**cfg))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32))
                  .to(tdt), jax.tree.map(np.asarray, p))
    tstate = adamw.init(tp, AdamWConfig(**cfg))
    for step in range(2):
        g = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape) * 0.7, jnp.float32), p)
        lr = jnp.float32(3e-3 * (step + 1))
        p, jstate, jstats = jadamw.update(g, jstate, p, lr, JAdamW(**cfg))
        tg = _to_torch(jax.tree.map(np.asarray, g))
        tp, tstate, tstats = adamw.update(
            tg, tstate, tp, torch.tensor(float(lr)), AdamWConfig(**cfg))
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    np.testing.assert_allclose(float(tstats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)
    for name, jt, tt in (("params", p, tp), ("m", jstate["m"], tstate["m"]),
                         ("v", jstate["v"], tstate["v"])):
        for a, b in zip(jax.tree.leaves(jt), tree_leaves(tt)):
            assert b.dtype == (tdt if name == "params" else torch.float32)
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32),
                                       rtol=1e-6, atol=1e-7, err_msg=name)


def test_grad_clip_matches_jax(rng):
    cfg = dict(grad_clip=1e-3, weight_decay=0.0)
    p = {"w": jnp.zeros((8,), jnp.float32)}
    g = {"w": jnp.asarray(rng.standard_normal(8) * 100, jnp.float32)}
    jp, _, jstats = jadamw.update(g, jadamw.init(p, JAdamW(**cfg)), p,
                                  jnp.float32(1.0), JAdamW(**cfg))
    tp0 = _to_torch(jax.tree.map(np.asarray, p))
    tp, _, tstats = adamw.update(_to_torch(jax.tree.map(np.asarray, g)),
                                 adamw.init(tp0, AdamWConfig(**cfg)), tp0,
                                 1.0, AdamWConfig(**cfg))
    assert float(tstats["grad_norm"]) > 100.0     # reported pre-clip
    np.testing.assert_allclose(float(tstats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["warmup_cosine", "warmup_linear",
                                  "constant"])
def test_lr_at_matches_jax(kind):
    kw = dict(kind=kind, base_lr=3e-4, warmup_steps=10, total_steps=100,
              min_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 37, 55, 99, 100, 150):
        want = float(jlr_at(step, JSched(**kw)))
        assert float(lr_at(step, ScheduleConfig(**kw))) == pytest.approx(
            want, rel=1e-6, abs=1e-12), step
        assert float(lr_at(torch.tensor(step, dtype=torch.int32),
                           ScheduleConfig(**kw))) == pytest.approx(
            want, rel=1e-6, abs=1e-12)


# ---------------------------------------------------------------------------
# Loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(GRAD_TOL))
def test_loss_and_grads_match_jax(arch):
    """The reduced model's ``loss`` and every gradient leaf (fp32) against
    ``jax.value_and_grad(model.loss)`` on the same params and batch; the
    MoE loss carries its aux term."""
    jm, jp, tm, tp = _pair(arch)
    jb, tb = _batch(tm.cfg.vocab_size)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    tl, tmet, tg = _port_grads(tm, tp, tb)
    tl = float(tl.detach())
    assert abs(tl - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for k in jmet:
        assert k in tmet, k
        np.testing.assert_allclose(float(torch.as_tensor(tmet[k]).detach()),
                                   float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    if tm.cfg.moe:
        assert float(tmet["moe_aux"].detach()) > 0
    worst, key = _worst_leaf(to_jax_params(tg, tm.cfg),
                             jax.tree.map(np.asarray, jg))
    assert worst <= GRAD_TOL[arch], (arch, key, worst)


def test_loss_refuses_a_decode_view():
    _, _, tm, tp = _pair("mamba2-130m")
    _, tb = _batch(tm.cfg.vocab_size)
    with pytest.raises(ValueError, match="decode_view"):
        tm.loss(tm.decode_view(tp), tb)


def test_train_step_matches_jax_make_train_step():
    """Three steps of ``make_train_step`` from the same state: losses,
    grad norms and the params after each step."""
    jm, jp, tm, tp = _pair("mamba2-130m")
    jtc = JTrainConfig(optimizer=JAdamW(), schedule=JSched(
        base_lr=1e-3, warmup_steps=2, total_steps=50))
    tc = TrainConfig(optimizer=AdamWConfig(), schedule=ScheduleConfig(
        base_lr=1e-3, warmup_steps=2, total_steps=50))
    jstate = {"params": jp, "opt": jadamw.init(jp, jtc.optimizer)}
    tstate = {"params": tp, "opt": adamw.init(tp, tc.optimizer)}
    jstep = jax.jit(jmake_train_step(jm, jtc))
    tstep = make_train_step(tm, tc)
    for s in range(3):
        jb, tb = _batch(tm.cfg.vocab_size, seed=10 + s)
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        assert set(tmet) == set(jmet)
        for k in ("loss", "grad_norm", "lr", "accuracy"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4, err_msg=(s, k))
        # AdamW's first steps move each element by ~lr g / (|g| + eps): an
        # element whose gradient is near eps or at fp32 noise (the tied
        # table's rows of tokens not in the batch) moves by a share of lr
        # that rounding decides.  The params are held to 1e-5 of each
        # leaf plus 5% of the base learning rate (measured: 1.05%, the
        # table after step 2).
        got = to_jax_params(tstate["params"], tm.cfg)
        for path, ref in jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, jstate["params"]))[0]:
            node = got
            for k in path:
                node = node[k.key]
            err = np.abs(node - ref).max()
            assert err <= 1e-5 * np.abs(ref).max() + 0.05 * 1e-3, (
                s, jax.tree_util.keystr(path), err)
    assert int(tstate["opt"]["step"]) == 3


def test_microbatches_equal_the_full_batch():
    _, _, tm, tp = _pair("mamba2-130m")
    tc = {k: TrainConfig(schedule=ScheduleConfig(base_lr=1e-3,
                                                 warmup_steps=2),
                         microbatches=k) for k in (1, 2)}
    _, tb = _batch(tm.cfg.vocab_size, b=4)
    out = {}
    for k in (1, 2):
        state = {"params": tp, "opt": adamw.init(tp, tc[k].optimizer)}
        out[k] = make_train_step(tm, tc[k])(state, tb)
    np.testing.assert_allclose(float(out[2][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(out[2][1]["grad_norm"]),
                               float(out[1][1]["grad_norm"]), rtol=1e-5)
    for a, b in zip(tree_leaves(out[1][0]["params"]),
                    tree_leaves(out[2][0]["params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma-2b",
                                  "recurrentgemma-2b"])
def test_remat_modes_give_identical_grads(arch):
    """``remat`` none / full / dots recompute the same layers in the same
    order: bit-identical losses and gradients."""
    _, _, tm, tp = _pair(arch)
    _, tb = _batch(tm.cfg.vocab_size)
    got = {}
    for mode in ("none", "full", "dots"):
        m = build_model(tm.cfg.replace(remat=mode), "cpu")
        loss, _, grads = _port_grads(m, tp, tb)
        got[mode] = [loss] + tree_leaves(grads)
    for mode in ("full", "dots"):
        for a, b in zip(got["none"], got[mode]):
            assert torch.equal(a, b), mode


# ---------------------------------------------------------------------------
# The kernels' autograd Functions and the guard
# ---------------------------------------------------------------------------

def _prefill_inputs(seed=0, b=2, l=64, h=4, p=8, n=8, g=1, w=4):
    gen = torch.Generator().manual_seed(seed)

    def r(*s, scale=0.5):
        return torch.randn(s, generator=gen) * scale
    di = h * p
    dxbc = di + 2 * g * n
    return [r(b, l, di), r(b, l, dxbc), r(b, l, h), r(b, w - 1, dxbc),
            r(b, h, p, n), r(w, dxbc), r(dxbc, scale=0.1),
            r(h, scale=0.1), -torch.rand(h, generator=gen) - 0.5,
            r(h), 1 + r(di, scale=0.1)]


def _plain_prefill(*ins, silu_table=None, softplus_table=None, **kw):
    """The kernel's contract on the plain version: tables to callables."""
    def act(table, exact):
        return exact if table is None else functools.partial(eval_pwl,
                                                             table)
    return prefill_chunk.mamba2_prefill_plain(
        *ins, silu=act(silu_table, F.silu),
        softplus=act(softplus_table, F.softplus), **kw)


def _grads_of(outs, leaves, seed=3):
    gen = torch.Generator().manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen)).sum()
               for o in outs)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("actiba", [False, True])
def test_prefill_function_backward_is_the_plain_versions_autograd(
        monkeypatch, actiba):
    """Kernel 2's Function with its kernel call swapped for the plain
    version: its gradients for all 11 inputs equal autograd of
    ``mamba2_prefill_plain`` with the same activations, bit for bit."""
    monkeypatch.setattr(prefill_chunk, "mamba2_prefill", _plain_prefill)
    tables = dict(silu_table=get_table("silu"),
                  softplus_table=get_table("softplus")) if actiba else {}
    spec = dict(ngroups=1, head_dim=8, chunk=32, **tables)
    ins = [t.requires_grad_() for t in _prefill_inputs()]
    via = _grads_of(prefill_chunk.Mamba2Prefill.apply(spec, *ins), ins)
    want = _grads_of(_plain_prefill(*ins, **spec), ins)
    assert len(via) == 11
    for a, b in zip(via, want):
        assert torch.equal(a, b)
    # Only the used outputs carry a gradient: y alone is enough.
    y_only = torch.autograd.grad(
        prefill_chunk.Mamba2Prefill.apply(spec, *ins)[0].sum(), ins)
    want_y = torch.autograd.grad(_plain_prefill(*ins, **spec)[0].sum(), ins)
    for a, b in zip(y_only, want_y):
        assert torch.equal(a, b)


def test_flash_function_backward_is_the_plain_versions_autograd(
        monkeypatch):
    monkeypatch.setattr(flash_attention, "flash_attention",
                        flash_attention.flash_attention_plain)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 40, 32, generator=gen).requires_grad_()
    k = torch.randn(2, 2, 40, 32, generator=gen).requires_grad_()
    v = torch.randn(2, 2, 40, 32, generator=gen).requires_grad_()
    spec = dict(causal=True, window=16, scale=None)
    via = _grads_of([flash_attention.FlashAttention.apply(spec, q, k, v)],
                    [q, k, v])
    want = _grads_of([flash_attention.flash_attention_plain(q, k, v,
                                                            **spec)],
                     [q, k, v])
    for a, b in zip(via, want):
        assert torch.equal(a, b)


def test_pwl_function_backward_is_the_plain_versions_autograd(monkeypatch):
    monkeypatch.setattr(actiba, "pwl_activate",
                        lambda x, table: actiba.pwl_activate_plain(x, table))
    table = get_table("silu")
    x = (torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
         * 6).requires_grad_()
    via = _grads_of([actiba.PwlActivate.apply(table, x)], [x])
    want = _grads_of([actiba.pwl_activate_plain(x, table)], [x])
    assert torch.equal(via[0], want[0])


def test_guard_raises_only_under_grad_with_a_grad_input():
    """A kernel without a Function refuses a call whose output autograd
    would need (it never returns a detached output); under no_grad or
    inference_mode, or with no input that requires grad, it lets the
    call through."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="kernel 13"):
        ops._no_grad("kernel 13 (cumsum_last)", x)
    ops._no_grad("kernel 13 (cumsum_last)", x.detach())
    with torch.no_grad():
        ops._no_grad("kernel 13 (cumsum_last)", x)
    with torch.inference_mode():
        assert not ops._grad_wanted(x)
    assert ops._grad_wanted(None, x)


def test_jax_grad_fails_through_the_pallas_kernels():
    """The JAX package's rule that the port's guard follows: under
    ``XambaConfig.pallas(interpret=True)`` ``jax.grad`` of the reduced
    mamba2 loss fails at the Pallas prefill (no gradient rule), so a
    kernel without a Function has no gradient to match."""
    cfg = jget_config("mamba2-130m", reduced=True).replace(
        xamba=JXamba.pallas(interpret=True), n_layers=1)
    jm = jbuild(cfg)
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(0), jnp.float32)
    jb, _ = _batch(cfg.vocab_size, l=64)
    with pytest.raises(Exception) as err:
        jax.grad(lambda p: jm.loss(p, jb)[0])(jp)
    assert any("pallas" in str(f.path) for f in err.traceback)


# ---------------------------------------------------------------------------
# flops and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "qwen3-moe-30b-a3b"])
def test_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in JSHAPES.values():
        mine = ShapeSpec(shape.name, shape.kind, shape.seq_len,
                         shape.global_batch)
        assert flops.model_flops(cfg, mine, 123_456_789) == \
            jflops.model_flops(jcfg, shape, 123_456_789)
    assert flops.active_param_count(cfg, 10 ** 10) == \
        jflops.active_param_count(jcfg, 10 ** 10)


def _cli(monkeypatch, argv):
    """Run the training CLI on the CPU -> the per-step losses."""
    losses = []

    def recording(model, tc):
        step = make_train_step(model, tc)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return run
    monkeypatch.setattr(train_cli, "make_train_step", recording)
    train_cli.main(argv + ["--device", "cpu", "--reduced"])
    return losses


def test_cli_loss_decreases_on_synthetic_data(monkeypatch):
    """The JAX test's recipe (30 steps, b = 8, l = 64, warmup 2, data
    seed 1, the same 0.2 drop) through ``launch/train.py``'s ``main``,
    whose params are the config's bf16 and whose cosine reaches its
    floor at step 30 (the JAX test's fp32 params decay over 50): lr 3e-3
    in place of 1e-3 (1e-3 drops 0.14 here, 2e-3 0.31, 3e-3 0.53)."""
    losses = _cli(monkeypatch, ["--steps", "30", "--batch", "8", "--seq",
                                "64", "--lr", "3e-3", "--warmup", "2",
                                "--seed", "1", "--log-every", "10"])
    assert len(losses) == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_cli_resume_reproduces_the_uninterrupted_run(monkeypatch, tmp_path):
    """Checkpoints at steps 6 and 12; a run resumed from step 6 (params,
    AdamW state and the data step) gives steps 6-11's losses bit for
    bit."""
    argv = ["--steps", "12", "--batch", "4", "--seq", "32", "--lr",
            "1e-3", "--warmup", "2", "--ckpt-every", "6", "--log-every",
            "6"]
    full = _cli(monkeypatch, argv + ["--ckpt-dir", str(tmp_path / "a")])
    from repro_torch.checkpoint import all_steps
    assert all_steps(tmp_path / "a") == [6, 12]
    import shutil
    shutil.copytree(tmp_path / "a" / "step_00000006",
                    tmp_path / "b" / "step_00000006")
    resumed = _cli(monkeypatch, argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert resumed == full[6:]


def test_cli_refuses_a_mesh():
    """A mesh the batch does not split over is refused before any rank
    starts (``--mesh 2x2:data,model`` itself trains: see
    tests/test_torch_multirank.py)."""
    with pytest.raises(SystemExit) as err:
        train_cli.main(["--mesh", "3x2:data,model", "--device", "cpu"])
    assert err.value.code == 2
