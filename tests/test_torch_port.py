"""The port's package rules: the weight bridge, no JAX imports, no silent
CPU fallback, and a clear refusal of options that are not ported."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.core.xamba import XambaConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import ModelConfig, build_model
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
    ModelConfig(**DIMS).with_decode_mode("naive"),
    ModelConfig(**DIMS).with_prefill_mode("naive"),
    ModelConfig(**DIMS, xamba=XambaConfig(actiba=True)),
    ModelConfig(**DIMS).with_quant("w8"),
    ModelConfig(**DIMS, tie_embeddings=False)],
    ids=["decode_naive", "prefill_naive", "actiba", "w8", "untied"])
def test_unported_modes_raise(cfg):
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")


def test_ported_modes_all_take_the_kernel_path():
    """cumba / pallas / pallas_interpret name the same path in the port."""
    for mode in ("cumba", "pallas", "pallas_interpret"):
        cfg = ModelConfig(**DIMS).with_decode_mode(mode).with_prefill_mode(
            mode)
        assert build_model(cfg, device="cpu").cfg.xamba.decode == mode


def test_registry():
    cfg = get_config("mamba2-130m")
    assert (cfg.d_model, cfg.n_layers, cfg.d_state, cfg.ssm_head_dim,
            cfg.vocab_size, cfg.chunk_size) == (768, 24, 128, 64, 50288, 256)
    assert cfg.dtype == torch.bfloat16
    assert get_config("mamba2-130m", reduced=True).n_layers == 2
    for arch in ("mamba-130m", "gemma-2b"):
        with pytest.raises(NotImplementedError, match="not ported"):
            get_config(arch)


def test_cli_serves_on_cpu():
    engine, done = tserve.main(["--reduced", "--device", "cpu",
                                "--requests", "3", "--batch", "2",
                                "--max-new", "3"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert all(0 <= t < 512 for r in done for t in r.out_tokens)
    assert engine.metrics.summary()["wall_source"] == "measured"
