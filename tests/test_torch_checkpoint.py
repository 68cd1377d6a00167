"""The port's checkpoints and restart loop against the JAX package.

A checkpoint is the JAX package's on-disk layout (``step_<N>/arrays.npz``
keyed by ``jax.tree_util.keystr`` plus ``manifest.json``), so a JAX
``ckpt.save`` restores in the port and a port ``ckpt.save`` restores in
the JAX ``ckpt.restore``, leaf for leaf and bit for bit.  The rest
mirrors ``tests/test_checkpoint_and_runtime.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.nn.params import abstract_params, init_params as jinit
from repro.optim import AdamWConfig as JAdamW, adamw as jadamw
from repro_torch.checkpoint import AsyncCheckpointer, all_steps, \
    latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.nn.params import from_jax_params, to_jax_params, \
    tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.runtime import RestartPolicy, run_with_restarts

FAMILIES = {"mamba2-130m": {}, "mamba-130m": {},
            "recurrentgemma-2b": {"n_layers": 4},     # one group, a tail
            "gemma-2b": {}, "qwen3-moe-30b-a3b": {}}


def _jax_state(arch, overrides, seed=0):
    """A JAX train state (bf16 params, fp32 moments that are not zero,
    step 5) and the config pair."""
    jcfg = jget_config(arch, reduced=True).replace(**overrides)
    shapes = abstract_params(jbuild(jcfg).param_specs(), jnp.bfloat16)
    rng = np.random.default_rng(seed)

    def draw(dtype, fn):
        return jax.tree.map(lambda a: jnp.asarray(fn(a.shape), dtype),
                            shapes)
    params = draw(jnp.bfloat16, rng.standard_normal)
    opt = {"step": jnp.int32(5), "m": draw(jnp.float32, rng.standard_normal),
           "v": draw(jnp.float32, rng.random)}
    cfg = get_config(arch, reduced=True).replace(**overrides)
    return {"params": params, "opt": opt}, jcfg, cfg


def _port_target(cfg):
    """An empty port state of ``cfg``'s shapes (other values)."""
    from repro_torch.nn.params import init_params
    m = build_model(cfg, "cpu")
    params = init_params(m.param_specs(), 99, cfg.dtype, "cpu")
    return {"params": params, "opt": adamw.init(params, AdamWConfig())}


def _as_jax_layout(state, cfg):
    return {"params": to_jax_params(state["params"], cfg),
            "opt": {"step": state["opt"]["step"].numpy(),
                    "m": to_jax_params(state["opt"]["m"], cfg),
                    "v": to_jax_params(state["opt"]["v"], cfg)}}


def _assert_same(jax_state, port_jax_layout):
    flat = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    assert len(flat) == len(tree_leaves(port_jax_layout))
    for path, ref in flat:
        got = port_jax_layout
        for k in path:
            got = got[k.key]
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(got, np.float32), ref,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch):
    jstate, _, cfg = _jax_state(arch, FAMILIES[arch])
    jckpt.save(tmp_path, 5, jstate, extra={"data_step": 5})
    got, step, extra = restore(tmp_path, _port_target(cfg), cfg=cfg)
    assert step == 5 and extra == {"data_step": 5}
    assert got["params"]["embed"]["table"].dtype == torch.bfloat16
    assert got["opt"]["m"]["embed"]["table"].dtype == torch.float32
    assert got["opt"]["step"].dtype == torch.int32
    _assert_same(jstate, _as_jax_layout(got, cfg))


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    jstate, _, cfg = _jax_state(arch, FAMILIES[arch], seed=1)
    port = {"params": from_jax_params(jax.tree.map(np.asarray,
                                                   jstate["params"]), cfg,
                                      "cpu"),
            "opt": {"step": torch.tensor(5, dtype=torch.int32),
                    **{k: from_jax_params(jax.tree.map(
                        np.asarray, jstate["opt"][k]), cfg, "cpu")
                       for k in ("m", "v")}}}
    save(tmp_path, 5, port, extra={"data_step": 7}, cfg=cfg)
    target = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          jstate)
    got, step, extra = jckpt.restore(tmp_path, target)
    assert step == 5 and extra == {"data_step": 7}
    assert got["params"]["embed"]["table"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_keys_are_jax_keystr(tmp_path):
    jstate, _, cfg = _jax_state("mamba2-130m", {})
    jckpt.save(tmp_path / "j", 1, jstate)
    port = restore(tmp_path / "j", _port_target(cfg), cfg=cfg)[0]
    save(tmp_path / "t", 1, port, cfg=cfg)
    import json
    keys = {d: json.load(open(tmp_path / d / "step_00000001" /
                              "manifest.json"))["keys"] for d in "jt"}
    assert keys["t"] == keys["j"]
    assert "['opt']['m']['layers']['mixer']['A_log']" in keys["t"]


@pytest.mark.parametrize("arch", list(FAMILIES) + ["llava-next-mistral-7b"])
def test_to_jax_params_inverts_from_jax_params(arch):
    """fp32 params in the JAX layout come back leaf for leaf, dtype and
    bits; bf16 ones as their fp32 widening (numpy has no bf16)."""
    overrides = FAMILIES.get(arch, {})
    jcfg = jget_config(arch, reduced=True).replace(**overrides)
    jm = jbuild(jcfg)
    cfg = get_config(arch, reduced=True).replace(**overrides)
    for dt in (jnp.float32, jnp.bfloat16):
        jp = jax.tree.map(np.asarray, jinit(jm.param_specs(),
                                            jax.random.PRNGKey(0), dt))
        back = to_jax_params(from_jax_params(jp, cfg, "cpu"), cfg)
        _assert_same(jp, back)
        if dt == jnp.float32:
            for a, b in zip(jax.tree.leaves(jp), tree_leaves(back)):
                assert b.dtype == a.dtype


def test_unstacked_layout_round_trips():
    """``scan_layers=False`` keeps the JAX package's ``"0"``, ``"1"``, ...
    trunk."""
    jcfg = jget_config("mamba2-130m", reduced=True).replace(
        scan_layers=False)
    jp = jax.tree.map(np.asarray, jinit(jbuild(jcfg).param_specs(),
                                        jax.random.PRNGKey(0), jnp.float32))
    cfg = get_config("mamba2-130m", reduced=True).replace(scan_layers=False)
    assert sorted(jp["layers"]) == ["0", "1"]
    _assert_same(jp, to_jax_params(from_jax_params(jp, cfg, "cpu"), cfg))


# ---------------------------------------------------------------------------
# The mechanics (tests/test_checkpoint_and_runtime.py's, on the port)
# ---------------------------------------------------------------------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 8, generator=g).bfloat16(),
                       "b": torch.randn(8, generator=g)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": {"w": torch.zeros(4, 8), "b": torch.ones(8)}},
            "layers": [torch.arange(3.0), torch.ones(2)]}


def test_save_restore_roundtrip(tmp_path):
    state = _state()
    save(tmp_path, 7, state, extra={"data_step": 7})
    got, step, extra = restore(tmp_path, _state(1))
    assert step == 7 and extra["data_step"] == 7
    for a, b in zip(tree_leaves(state), tree_leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_gc_keeps_last_k(tmp_path):
    for s in range(6):
        save(tmp_path, s, _state(), keep=3)
    assert all_steps(tmp_path) == [3, 4, 5]


def test_partial_write_is_invisible(tmp_path):
    save(tmp_path, 1, _state())
    (tmp_path / "step_00000002.tmp").mkdir()     # a crash mid-write
    assert latest_step(tmp_path) == 1
    assert restore(tmp_path, _state())[1] == 1


def test_async_checkpointer(tmp_path):
    w = AsyncCheckpointer(tmp_path, keep=2)
    state = _state()
    for s in (1, 2, 3):
        w.save(s, state)
        state = tree_map(lambda t: t + 1, state)   # the loop moves on
    w.wait()
    assert all_steps(tmp_path) == [2, 3]
    got = restore(tmp_path, _state())[0]
    assert torch.equal(got["params"]["b"], _state()["params"]["b"] + 2)


def test_restore_casts_dtypes_and_devices(tmp_path):
    save(tmp_path, 1, _state())
    target = tree_map(lambda t: t.double() if t.is_floating_point() else t,
                      _state())
    got = restore(tmp_path, target)[0]
    assert got["params"]["w"].dtype == torch.float64
    assert torch.equal(got["params"]["w"],
                       _state()["params"]["w"].double())
    with pytest.raises(KeyError, match="missing"):
        restore(tmp_path, dict(_state(), extra=torch.zeros(1)))


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(tmp_path, _state())


def test_restart_loop_recovers_from_crashes(tmp_path):
    policy = RestartPolicy(max_restarts=5, ckpt_dir=str(tmp_path))
    crashes = {"left": 2}

    def train_some(state, start):
        for s in range(start, start + 5):
            state = {"x": state["x"] + 1.0,
                     "opt": {"step": torch.tensor(s + 1, dtype=torch.int32),
                             "m": state["opt"]["m"],
                             "v": state["opt"]["v"]},
                     "params": state["params"]}
            if s == 7 and crashes["left"] > 0:
                crashes["left"] -= 1
                raise RuntimeError("injected node failure")
        return state, start + 5

    init = {"x": torch.tensor(0.0), "params": {"w": torch.zeros(2)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32),
                    "m": torch.zeros(2), "v": torch.zeros(2)}}
    state, step, restarts, crash_loops = run_with_restarts(
        train_some, init, policy, target_steps=20)
    assert step == 20
    assert restarts == 2
    # Both crashes hit the same step boundary (start=5): a crash loop.
    assert crash_loops == [5]
    assert float(state["x"]) == 20.0


def test_restart_loop_gives_up_after_max_restarts(tmp_path):
    policy = RestartPolicy(max_restarts=1, ckpt_dir=str(tmp_path))

    def always(state, start):
        raise RuntimeError("poison")

    with pytest.raises(RuntimeError, match="poison"):
        run_with_restarts(always, {"x": torch.zeros(1)}, policy,
                          target_steps=5)


def test_restart_loop_trains_a_model_in_the_jax_layout(tmp_path):
    """The loop around the real train step: a crash after the first
    checkpoint resumes from it, and the checkpoint is JAX's layout."""
    from repro_torch.train import TrainConfig, init_state, make_train_step
    from repro_torch.data import DataConfig, SyntheticLM, to_device_batch
    cfg = get_config("mamba2-130m", reduced=True).replace(n_layers=1)
    model = build_model(cfg, "cpu")
    step_fn = make_train_step(model, TrainConfig())
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=2))
    crashed = []

    def train_some(state, start):
        for s in range(start, start + 2):
            state, _ = step_fn(state, to_device_batch(data._batch_at(s),
                                                      "cpu"))
            if s == 2 and not crashed:
                crashed.append(s)
                raise RuntimeError("injected")
        return state, start + 2

    out = run_with_restarts(train_some, init_state(model, 0, TrainConfig()),
                            RestartPolicy(ckpt_dir=str(tmp_path)),
                            target_steps=4, cfg=cfg)
    assert (out.step, out.restarts, out.crash_loop_steps) == (4, 1, [])
    assert int(out.state["opt"]["step"]) == 4
    jcfg = jget_config("mamba2-130m", reduced=True).replace(n_layers=1)
    jm = jbuild(jcfg)
    params = jinit(jm.param_specs(), jax.random.PRNGKey(0), jnp.bfloat16)
    target = {"params": params, "opt": jadamw.init(params, JAdamW())}
    got, step, _ = jckpt.restore(tmp_path, target)
    assert step == 4 and int(got["opt"]["step"]) == 4
