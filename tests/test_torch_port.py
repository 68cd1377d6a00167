"""The port's package rules: the weight bridge, no JAX imports, no silent
CPU fallback, a clear refusal of options that are not ported, and the
modes that are (W8 among them)."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.xamba import XambaConfig as JXamba
from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn import quant as jquant
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.core.xamba import XambaConfig
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn import quant as tquant
from repro_torch.nn.params import from_jax_params, init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIMS = dict(name="mamba2", family="mamba2", vocab_size=64, d_model=32,
            n_layers=2, d_state=8, ssm_head_dim=8, chunk_size=16)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _np_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_params_round_trip(dtype):
    """Every leaf crosses bit for bit with its dtype kept (bf16 through
    its uint16 bits), the stacked layer axis split per layer."""
    jm = jbuild(JModelConfig(**DIMS, param_dtype=dtype))
    jp = jax.tree.map(np.asarray, jinit(jm.param_specs(),
                                        jax.random.PRNGKey(0),
                                        jnp.dtype(dtype)))
    cfg = ModelConfig(**DIMS, param_dtype=dtype)
    tp = from_jax_params(jp, cfg, device="cpu")
    assert len(tp["layers"]) == cfg.n_layers

    def walk(j, t, path):
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], path + (k,))
            return
        assert str(t.dtype).split(".")[-1] == j.dtype.name, path
        np.testing.assert_array_equal(_bits(t), _np_bits(j), err_msg=path)

    for i, layer in enumerate(tp["layers"]):
        walk(jax.tree.map(lambda a: a[i], jp["layers"]), layer,
             ("layers", str(i)))
    walk({k: v for k, v in jp.items() if k != "layers"},
         {k: v for k, v in tp.items() if k != "layers"}, ())


def test_init_params_scales_and_seed():
    """The JAX package's init rule: ones/zeros where declared, the
    declared or fan-in scale elsewhere; one seed gives one weight set."""
    model = build_model(ModelConfig(**DIMS), device="cpu")
    a = init_params(model.param_specs(), 3, torch.float32, "cpu")
    b = init_params(model.param_specs(), 3, torch.float32, "cpu")
    torch.testing.assert_close(a["embed"]["table"], b["embed"]["table"],
                               rtol=0, atol=0)
    mix = a["layers"][0]["mixer"]
    assert torch.all(mix["A_log"] == 1) and torch.all(mix["dt_bias"] == 0)
    assert abs(float(a["embed"]["table"].std()) - 0.02) < 0.005
    # Stacked declaration: fan-in is the layer count, as in the JAX package.
    assert abs(float(mix["in_proj"]["w"].std()) - 2 ** -0.5) < 0.05


def test_no_jax_imports():
    """Every module of the port, and chip_smoke, imports without loading
    jax or anything of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules "
        "if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_raises_without_gpu():
    """Here, with no GPU, every default-device entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = ModelConfig(**DIMS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(model.param_specs(), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduced", "--requests", "1"])


@pytest.mark.parametrize("cfg", [
    ModelConfig(**DIMS, tie_embeddings=False)], ids=["untied"])
def test_unported_modes_raise(cfg):
    """Untied embeddings were refused before they were ported; now the
    model builds and its prefill and decode logits match the JAX model's
    (fp32, within 1e-5 of the largest magnitude, at least 1).  Whisper's
    encoder, the last family mode refused, is ported too: its config
    resolves with the JAX package's fields (``_assert_whisper_config``)."""
    dims = dict(DIMS, param_dtype="float32")
    jm = jbuild(JModelConfig(**dims, tie_embeddings=False))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(2), jnp.float32)
    model = build_model(cfg.replace(param_dtype="float32"), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), model.cfg, "cpu")
    assert "lm_head" in tp
    toks = np.random.default_rng(2).integers(1, 64, (2, 16))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, 16, jnp.float32))
    with torch.inference_mode():
        tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               model.init_cache(2, 16, torch.float32))
        tok = np.asarray(jl).argmax(-1)[:, None]
        jl2, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jc, 16)
        tl2, _ = model.decode_step(tp, torch.from_numpy(tok), tc, 16)
    for got, want in ((tl, jl), (tl2, jl2)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(want).max()))
    _assert_whisper_config()


def _assert_whisper_config():
    """``get_config("whisper-tiny")`` resolves, every field the JAX
    config has (but its sharding rules) equal, the XAMBA flags too."""
    import dataclasses
    from repro.configs import get_config as jget_config
    t, j = get_config("whisper-tiny"), jget_config("whisper-tiny")
    fields = {f.name for f in dataclasses.fields(t)} - {"xamba"}
    assert {f.name for f in dataclasses.fields(j)} - fields == {
        "logical_rules", "xamba"}
    for f in sorted(fields):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t.xamba) == dataclasses.asdict(j.xamba)
    assert (t.family, t.encoder_layers, t.n_layers, t.d_model, t.n_heads,
            t.head_dim, t.d_ff, t.vocab_size, t.encoder_seq) == (
        "whisper", 4, 4, 384, 6, 64, 1536, 51865, 1500)


@pytest.mark.parametrize("xamba", [
    dict(decode="naive"), dict(prefill="naive"), dict(actiba=True),
    dict(quant="w8")],
    ids=["decode_naive", "prefill_naive", "actiba", "w8"])
def test_formerly_unported_modes_build_and_match_jax(xamba):
    """The modes that raised before the XAMBA technique path and W8 were
    ported build, and a prefill (l = 32, chunk 16: the fused path unless
    prefill is naive) plus a decode step match the JAX package's logits.
    Under ``quant`` both sides quantize their params for the mode."""
    dims = dict(DIMS, param_dtype="float32")
    jm = jbuild(JModelConfig(**dims, xamba=JXamba(**xamba)))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(1), jnp.float32)
    tm = build_model(ModelConfig(**dims, xamba=XambaConfig(**xamba)),
                     device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    mode = xamba.get("quant", "none")
    jp = jquant.quantize_params_for_mode(jp, mode)
    tp = tquant.quantize_params_for_mode(tp, mode)
    assert tquant.is_quantized(tp["layers"][0]["mixer"]["in_proj"]["w"]) \
        == (mode != "none")
    toks = np.random.default_rng(2).integers(1, 64, size=(2, 32))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        jm.init_cache(2, dtype=jnp.float32))
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, dtype=torch.float32))
        tl2, _ = tm.decode_step(tp, torch.from_numpy(toks[:, :1]), tc, 32)
    jl2, _ = jm.decode_step(jm.decode_view(jp),
                            jnp.asarray(toks[:, :1], jnp.int32), jc,
                            jnp.int32(32))
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= 1e-4
    assert float(np.abs(tl2.numpy() - np.asarray(jl2)).max()) <= 1e-4


@pytest.mark.parametrize("preset", ["optimized", "full", "pallas",
                                    "pallas_interpret", "mode_cumba",
                                    "mode_pallas", "mode_pallas_interpret"])
def test_ported_modes_all_take_the_kernel_path(preset, monkeypatch):
    """cumba / pallas / pallas_interpret name the same path in the port,
    alone or in a preset: each layer's decode step and prefill (l = 64 at
    chunk 64, which the gate admits in every mode) go through the fused
    kernel dispatch once."""
    dims = dict(DIMS, chunk_size=64)
    if preset.startswith("mode_"):
        mode = preset[len("mode_"):]
        cfg = ModelConfig(**dims).with_decode_mode(mode).with_prefill_mode(
            mode)
    else:
        xamba = (XambaConfig.pallas(interpret=True)
                 if preset == "pallas_interpret"
                 else getattr(XambaConfig, preset)())
        cfg = ModelConfig(**dims, xamba=xamba)
    model = build_model(cfg, device="cpu")
    calls = {"mamba2_decode_step": 0, "mamba2_prefill": 0}
    for name in calls:
        fn = getattr(tops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tops, name, counted)
    params = init_params(model.param_specs(), 0, torch.float32, "cpu")
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": torch.ones(
            (1, 64), dtype=torch.long)}, model.init_cache(1))
        model.decode_step(params, torch.ones((1, 1), dtype=torch.long),
                          cache, 64)
    assert calls == {"mamba2_decode_step": cfg.n_layers,
                     "mamba2_prefill": cfg.n_layers}


def test_registry():
    cfg = get_config("mamba2-130m")
    assert (cfg.d_model, cfg.n_layers, cfg.d_state, cfg.ssm_head_dim,
            cfg.vocab_size, cfg.chunk_size) == (768, 24, 128, 64, 50288, 256)
    assert cfg.dtype == torch.bfloat16
    assert get_config("mamba2-130m", reduced=True).n_layers == 2
    cfg = get_config("mamba-130m")
    assert (cfg.family, cfg.d_model, cfg.n_layers, cfg.d_state, cfg.dt_rank,
            cfg.vocab_size) == ("mamba", 768, 24, 16, 48, 50280)
    cfg = get_config("recurrentgemma-2b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.lru_width,
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.sliding_window, cfg.attn_logit_softcap) == (
        "recurrentgemma", 26, 2560, 2560, 10, 1, 256, 7680, 256000, 2048,
        30.0)
    _assert_whisper_config()
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("whisper-base")


def test_cli_serves_on_cpu():
    engine, done = tserve.main(["--reduced", "--device", "cpu",
                                "--requests", "3", "--batch", "2",
                                "--max-new", "3"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert all(0 <= t < 512 for r in done for t in r.out_tokens)
    assert engine.metrics.summary()["wall_source"] == "measured"
