"""The port's dry run against the JAX package's, and the kernels' meta
branches against their plain versions.

``run_cell`` runs REDUCED mamba2-130m (the JAX dry run's overrides: 2
layers, d_model 256, vocab 1024) at every shape cell on ``meta``: its
argument bytes equal JAX's abstract arguments' (with the two differences
named in :func:`_jax_argument_bytes`), its useful ratio is sane, and
``--mesh multi`` is skipped with its reason.  Each kernel dispatch on
meta tensors gives its plain version's output shapes and dtypes and
records the operations and bytes of ``kernels/cost.py``: the dispatch
takes the kernel's wrapper, whose checks refuse on meta what they refuse
on the card.  A run past the budget stops there, and its cost comes
from one and two layers, which for a stack of identical layers equals
the whole step's count.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, shapes as jshapes
from repro.models import build_model as jbuild
from repro.nn.params import abstract_params as jabstract_params
from repro.train import TrainConfig as JTrainConfig, \
    abstract_state as jabstract_state
from repro_torch.configs import shapes
from repro_torch.core.pwl import get_table
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun

OVERRIDES = {"n_layers": 2, "d_model": 256, "vocab_size": 1024}


def _jax_argument_bytes(shape_name):
    """The bytes of the JAX dry run's abstract arguments for the cell,
    and the port's count of the same: the port's token ids are int64 (4
    bytes more each: the index type of its embeddings and gathers), and
    its decode index is a Python int, not a 4-byte int32 scalar."""
    cfg = jget_config("mamba2-130m").replace(**OVERRIDES)
    model = jbuild(cfg)
    shape = jshapes.SHAPES[shape_name]
    if shape.kind == "train":
        args = (jabstract_state(model, JTrainConfig()),
                jshapes.batch_inputs(cfg, shape))
    else:
        params = jabstract_params(model.param_specs(), cfg.dtype)
        cache = jshapes.abstract_cache(model, cfg, shape, cfg.dtype)
        inputs = (jshapes.prefill_inputs if shape.kind == "prefill"
                  else jshapes.decode_inputs)(cfg, shape)
        args = (params, inputs, cache) + (
            (jax.ShapeDtypeStruct((), np.int32),)
            if shape.kind == "decode" else ())
    leaves = jax.tree.leaves(args)
    jax_bytes = sum(math.prod(a.shape) * np.dtype(a.dtype).itemsize
                    for a in leaves)
    tokens = sum(math.prod(a.shape) for a in leaves if a.dtype == np.int32
                 and a.shape)
    return jax_bytes, jax_bytes + 4 * tokens - 4 * (shape.kind == "decode")


@pytest.mark.parametrize("shape_name", list(shapes.SHAPES))
def test_run_cell_reduced_mamba2_matches_jax_arguments(shape_name):
    rec = dryrun.run_cell("mamba2-130m", shape_name, "single",
                          overrides=OVERRIDES)
    assert rec["ok"] and rec["device"] == "meta" and rec["chips"] == 1
    mem = rec["memory"]
    _, want = _jax_argument_bytes(shape_name)
    assert mem["argument_bytes"] == want
    assert mem["total_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["fits_hbm"] and mem["hbm_bytes"] == dryrun.hbm_bytes()
    assert mem["microbatches"] == 1
    assert 0.5 <= rec["roofline"]["useful_ratio"] <= 1.05
    assert rec["collectives"]["total_wire_bytes"] == 0
    assert rec["cost"]["acct_mode"] == "full"
    kernel = "mamba2_step" if rec["kind"] == "decode" else "mamba2_prefill"
    # A layer's kernel a step; a train step's twice (remat="full" runs the
    # forward again in the backward).
    assert rec["cost"]["kernel_launches"] == {
        kernel: 4 if rec["kind"] == "train" else 2}
    assert rec["cost"]["kernel_flops"] > 0
    multi = dryrun.run_cell("mamba2-130m", shape_name, "multi",
                            overrides=OVERRIDES)
    assert multi["skipped"] and multi["skip_reason"] == dryrun.MULTI_SKIP
    assert "split over the model axis" in multi["skip_reason"]
    assert "one card" not in multi["skip_reason"]


@pytest.mark.parametrize("arch", ["mamba2-130m", "mamba2-2.7b"])
def test_cli_writes_the_decode_record_at_full_width(arch, tmp_path):
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", arch, "--shape", "decode_32k", "--out",
                     str(tmp_path)])
    assert exc.value.code == 0
    rec = json.loads(dryrun.cell_path(tmp_path, arch, "decode_32k",
                                      "single").read_text())
    for key in ("memory", "cost", "collectives", "roofline"):
        assert key in rec
    assert rec["memory"]["fits_hbm"] and rec["memory"]["hbm_bytes"] > 0
    assert rec["cost"]["kernel_launches"] == {
        "mamba2_step": 24 if arch == "mamba2-130m" else 64}


def test_live_bytes_counts_storages_once_and_frees():
    a = torch.empty(1000, device="meta")

    def step(a):
        v = a.view(10, 100)                      # a view: no new storage
        b = torch.empty(500, device="meta")     # 2000 bytes
        c = b[:100] + 1                         # 400 bytes
        del b
        d = torch.empty(250, device="meta")     # 1000 bytes
        return v, c, d
    got = dryrun.count_step(step, (a,))
    assert got["argument_bytes"] == 4000
    assert got["output_bytes"] == 1400
    assert got["total_bytes"] == 4000 + 2000 + 400     # b freed before d
    assert got["temp_bytes"] == 2400
    assert got["argument_alloc_bytes"] == 4096


# ---------------------------------------------------------------------------
# The kernels' meta branches
# ---------------------------------------------------------------------------

def _r(*shape, dtype=torch.float32):
    return torch.randn(*shape, generator=_GEN).to(dtype)


_GEN = torch.Generator().manual_seed(0)


def _mamba2_step():
    b, h, p, n, w = 2, 4, 16, 8, 4
    di, dx = h * p, h * p + 2 * n
    args = (_r(b, di), _r(b, dx), _r(b, h), _r(b, w - 1, dx),
            _r(b, h, p, n), _r(w, dx), _r(dx), _r(h), -_r(h).abs(), _r(h),
            _r(di))
    ops_ = cost.decode_ops(b, h, p, n, dx, di)
    return ops.mamba2_decode_step, args, dict(ngroups=1, head_dim=p), ops_


def _mamba1_step():
    b, di, n, r, w = 2, 32, 4, 3, 4
    args = (_r(b, di), _r(b, di), _r(b, w - 1, di), _r(b, di, n), _r(w, di),
            _r(di), _r(di, r + 2 * n), _r(r, di), _r(di), -_r(di, n).abs(),
            _r(di))
    return ops.mamba1_decode_step, args, dict(dt_rank=r), \
        cost.mamba1_ops(b, di, n, r, w)


def _ssd_step():
    b, h, p, n, g = 2, 4, 8, 6, 2
    args = (_r(b, h, p, n), _r(b, h, p), _r(b, h).abs(), -_r(h).abs(),
            _r(b, g, n), _r(b, g, n))
    return ops.ssd_step, args, {}, cost.ssd_step_ops(b, h, p, n)


def _sscan_step():
    b, d, n = 2, 12, 4
    args = (_r(b, d, n), _r(b, d), _r(b, d).abs(), -_r(d, n).abs(),
            _r(b, n), _r(b, n), _r(d))
    return ops.sscan_step, args, {}, cost.sscan_step_ops(b, d, n)


def _prefill():
    b, l, d, h, p, n, w, chunk = 2, 16, 32, 4, 16, 8, 4, 8
    di, dx = h * p, h * p + 2 * n
    args = (_r(b, l, d), _r(d, di + dx + h) * 0.1, _r(b, w - 1, dx),
            _r(b, h, p, n), _r(w, dx), _r(dx), _r(h), -_r(h).abs(), _r(h),
            _r(di))
    return ops.mamba2_prefill, args, dict(ngroups=1, head_dim=p,
                                          chunk=chunk), \
        cost.prefill_tc_ops(b, l, chunk, h, p, n, 1)


def _rglru_step():
    b, w, wc = 2, 16, 4
    args = (_r(b, w), _r(b, w), _r(b, wc - 1, w), _r(b, w), _r(wc, w),
            _r(w), _r(w, w), _r(w), _r(w, w), _r(w), _r(w))
    return ops.rglru_decode_step, args, {}, cost.rglru_step_ops(b, w)


def _rg_scan():
    a = torch.rand(2, 9, 8, generator=_GEN)
    return ops.rg_lru_scan, (a, _r(2, 9, 8)), {}, 2 * a.numel()


def _matmul_pwl(gated):
    x, w = _r(6, 16), _r(16, 24)
    args = (x, w, get_table("gelu")) + ((_r(16, 24),) if gated else ())
    return ops.matmul_pwl, args, {}, 2 * 6 * 16 * 24 * (2 if gated else 1)


def _pwl():
    x, t = _r(4, 40), get_table("silu")
    return ops.actiba_activate, (x, t), {}, cost.pwl_ops(x.numel(), t)


def _cumsum():
    x = _r(3, 5, 16)
    return ops.cumba_cumsum, (x,), {}, x.numel()


def _reduba():
    x = _r(3, 5, 16)
    return ops.reduba_sum, (x,), {}, x.numel()


def _flash(window):
    b, hq, hkv, l, d = 2, 4, 2, 12, 32
    args = (_r(b, hq, l, d), _r(b, hkv, l, d), _r(b, hkv, l, d))
    kw = dict(causal=True, window=window)
    return ops.flash_attention, args, kw, cost.flash_ops(
        b, hq, l, l, d, True, window)


def _ssd_chunk():
    b, c, L, h, p, g, n = 2, 2, 8, 4, 8, 2, 6
    args = (_r(b, c, L, h, p), _r(b, h, c, L), _r(b, c, L, g, n),
            _r(b, c, L, g, n))
    return ops.ssd_chunk, args, {}, cost.ssd_chunk_ops(b, c, L, h, g, p, n)


def _qmatmul(gated):
    x = _r(5, 16)
    q = torch.randint(-127, 128, (16, 24), generator=_GEN).to(torch.int8)
    kw = {}
    if gated:
        kw = dict(qv=q.flip(0).contiguous(), vscale=_r(24).abs())
    return ops.qmatmul, (x, q, _r(24).abs()), kw, \
        2 * 5 * 16 * 24 * (2 if gated else 1)


KERNEL_CASES = {
    "mamba2_step": _mamba2_step, "mamba1_step": _mamba1_step,
    "ssd_step": _ssd_step, "sscan_step": _sscan_step,
    "mamba2_prefill": _prefill, "rglru_step": _rglru_step,
    "rg_lru_scan": _rg_scan, "matmul_pwl": lambda: _matmul_pwl(False),
    "matmul_pwl gated": lambda: _matmul_pwl(True), "pwl_activate": _pwl,
    "cumsum_last": _cumsum, "reduce_rows": _reduba,
    "flash_attention": lambda: _flash(None),
    "flash_attention window": lambda: _flash(5), "ssd_chunk": _ssd_chunk,
    "qmatmul": lambda: _qmatmul(False),
    "qmatmul gated": lambda: _qmatmul(True),
}


def _meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_meta_branch_shapes_and_cost(case):
    fn, args, kw, want_ops = KERNEL_CASES[case]()
    with torch.no_grad():
        plain = _flat(fn(*args, **kw))
        with cost.counting() as log:
            meta = _flat(fn(*map(_meta, args),
                            **{k: _meta(v) for k, v in kw.items()}))
    assert [(tuple(t.shape), t.dtype) for t in meta] == [
        (tuple(t.shape), t.dtype) for t in plain]
    assert all(t.is_meta for t in meta)
    name = case.split()[0]
    assert [k.name for k in log] == [name]
    assert log[0].ops == want_ops
    ins = [a for a in args if isinstance(a, torch.Tensor)] + [
        v for v in kw.values() if isinstance(v, torch.Tensor)]
    if name == "mamba2_prefill":   # the kernel's inputs: the projection's
        b, l, _ = args[0].shape    # three streams, then the rest
        ins = [torch.empty(b, l, args[1].shape[1])] + ins[2:]
    if name == "reduce_rows":      # the (last, rest) transpose it reads
        ins = [args[0].reshape(-1, args[0].shape[-1]).t()]
    assert log[0].nbytes == cost._bytes(*ins, *plain)


@pytest.mark.parametrize("case", ["mamba2_prefill", "flash_attention",
                                  "pwl_activate"])
def test_meta_branch_under_grad_differentiates(case):
    """The three differentiable kernels on meta under grad: the output
    requires grad and the backward (the plain version's autograd) gives
    each input a gradient of its shape; one launch recorded."""
    fn, args, kw, _ = KERNEL_CASES[case]()
    leaves = [_meta(a).requires_grad_() if isinstance(a, torch.Tensor)
              and a.is_floating_point() else _meta(a) for a in args]
    with cost.counting() as log:
        out = _flat(fn(*leaves, **kw))[0]
    assert out.requires_grad and [k.name for k in log] == [case]
    want = [t for t in leaves if isinstance(t, torch.Tensor)
            and t.requires_grad]
    grads = torch.autograd.grad(out.sum(), want, allow_unused=True)
    assert any(g is not None for g in grads)
    for g, t in zip(grads, want):
        assert g is None or (g.is_meta and g.shape == t.shape)


def test_meta_branch_refuses_what_the_card_refuses():
    """On meta the wrapper's checks run as on the card: kernel 9 has no
    body for head_dim 16, and kernel 1 takes only fp32 small
    parameters."""
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="head_dim 16"):
        ops.flash_attention(q, q, q)
    fn, args, kw, _ = _mamba2_step()
    args = [_meta(a) for a in args]
    args[-1] = args[-1].to(torch.bfloat16)
    with pytest.raises(ValueError, match="norm_scale"):
        fn(*args, **kw)


def test_meta_branch_without_gradient_raises_under_grad():
    x = torch.empty(3, 16, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="kernel 13"):
        ops.cumba_cumsum(x)


def test_live_bytes_stops_past_the_limit():
    a = torch.empty(1000, device="meta")

    def step(a):
        b = torch.empty(500, device="meta")     # 6000 bytes live
        c = torch.empty(500, device="meta")     # 8000: past 7000
        return b + c
    got = dryrun.count_step(step, (a,), limit=7000)
    assert not got["complete"] and got["output_bytes"] is None
    assert got["total_bytes"] == 8000
    assert dryrun.count_step(step, (a,), limit=10_000)["complete"]


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
def test_marginal_cost_equals_the_whole_count(shape_name):
    """The cost of a cell past the budget (one and two layers,
    extrapolated) equals the count of the whole step, at three reduced
    layers; and ``run_cell`` takes it when no microbatch count fits."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig
    cfg = get_config("mamba2-130m").replace(**dict(OVERRIDES, n_layers=3))
    shape = shapes.ShapeSpec(shape_name, shapes.SHAPES[shape_name].kind,
                             256, 2)
    mesh = make_mesh((1, 1), ("data", "model"))
    tc = TrainConfig(microbatches=2 if shape.kind == "train" else 1)
    fn, args, _ = dryrun._lower_cell(cfg, shape, mesh,
                                     build_model(cfg, "meta"), tc)
    whole = dryrun._totals(cfg, dryrun.count_step(fn, args))
    got, acct = dryrun._marginal(cfg, shape, mesh, tc)
    assert acct == {"acct_mode": "marginal", "acct_layers": [1, 2],
                    "n_periods": 2}
    assert got["launches"] == whole["launches"]
    for key in ("flops", "bytes", "kernel_flops", "kernel_bytes"):
        assert got[key] == pytest.approx(whole[key], rel=1e-12), key


def test_run_cell_past_the_budget_is_costed_by_layers(monkeypatch):
    monkeypatch.setattr(dryrun, "hbm_bytes", lambda: 1 << 20)
    rec = dryrun.run_cell("mamba2-130m", "train_4k", "single",
                          overrides=dict(OVERRIDES, n_layers=3),
                          shape=shapes.ShapeSpec("t", "train", 256, 8))
    mem = rec["memory"]
    assert rec["ok"] and not mem["fits_hbm"] and not mem["complete"]
    assert mem["microbatches"] == 8 and mem["total_bytes"] > 1 << 20
    assert rec["cost"]["acct_mode"] == "marginal"
    # 3 layers, twice each (remat), in each of 8 microbatches.
    assert rec["cost"]["kernel_launches"] == {"mamba2_prefill": 48}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_card_arguments_have_the_storages_the_dry_run_counts(kind):
    """``chip_smoke.py`` phase 4m's arguments (drawn from a seed, here on
    the CPU) hold exactly the storage bytes the dry run counts on meta:
    the phase asserts this on the card."""
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig
    cfg = get_config("mamba2-130m", reduced=True)
    shape = shapes.ShapeSpec("s", kind, 64, 2)
    tc = TrainConfig()
    meta = dryrun.abstract_args(build_model(cfg, "meta"), cfg, shape, tc)
    card = chip_smoke.card_args(build_model(cfg, "cpu"), cfg, shape, tc, 0,
                                torch.device("cpu"))
    assert sum(dryrun.storages(card).values()) == sum(
        dryrun.storages(meta).values())
