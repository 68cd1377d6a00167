"""The rules behind kernels 10 and 11's products, on the CPU.

Which body each call takes (``qmatmul.path``) on every kernel-10 shape of
the model paths, the cluster GEMV's and the ``wgmma`` body's split rules
as pure functions of the shapes, kernel 6's plan on the same GEMV, and
the exact int8 -> bf16 widening the tensor-core body
relies on.  The bodies themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import decode_step as ds, matmul_pwl as mp, \
    qmatmul as qm
from repro_torch.models import build_model


def _projections(arch, reduced):
    """(name, k, n) of the weights W8 quantizes in ``arch``'s mixer."""
    cfg = get_config(arch, reduced=reduced)
    mixer = build_model(cfg, "cpu").param_specs()["layers"]["mixer"]
    return [(name, *mixer[name]["w"].shape[-2:])
            for name in ("in_proj", "out_proj")]


def _x(m, k, dtype=torch.bfloat16):
    return torch.empty((m, k), dtype=dtype)


def _q(k, n):
    return torch.empty((k, n), dtype=torch.int8)


@pytest.mark.parametrize("m", [4, 256, 512])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "mamba-130m"])
def test_qmatmul_body_on_the_model_shapes(arch, reduced, m):
    """m <= 8 the GEMV whatever the dtype; above it bf16 x takes the
    tensor-core body (mamba2-130m's in_proj too, n = 3352, whose int8 rows
    are only 8-byte aligned) and fp32 x the SIMT body."""
    for name, k, n in _projections(arch, reduced):
        q = _q(k, n)
        want = "gemv" if m <= qm.GEMV_M else "wgmma"
        assert qm.path(_x(m, k), q) == want, name
        assert qm.path(_x(m, k), q, _q(k, n)) == want, name
        assert qm.path(_x(m, k, torch.float32), q) == \
            ("gemv" if m <= qm.GEMV_M else "tiled"), name


def test_in_proj_rows_are_8_byte_aligned_and_still_take_wgmma():
    q = _q(768, 3352)
    assert qm.load_bytes(3352, 1, q) == 8
    assert qm.load_bytes(768, 1, _q(1536, 768)) == 16
    assert qm.load_bytes(333, 1, _q(200, 333)) == 0
    assert qm.path(_x(256, 768), q) == "wgmma"


@pytest.mark.parametrize("shape,want", [
    ((70, 200, 130), "tiled"), ((70, 200, 136), "wgmma"),
    ((70, 204, 136), "tiled"), ((9, 256, 384), "wgmma"),
    ((8, 256, 384), "gemv"), ((3, 200, 333), "gemv")])
def test_qmatmul_body_on_ragged_shapes(shape, want):
    """k and n must be multiples of 8 for the ``wgmma`` body."""
    m, k, n = shape
    assert qm.path(_x(m, k), _q(k, n)) == want


def test_qmatmul_body_on_misaligned_bases():
    x, q = _x(64, 256), _q(256, 128)
    assert qm.path(x, q) == "wgmma"
    flat = torch.empty(64 * 256 + 1, dtype=torch.bfloat16)
    assert qm.path(flat[1:].view(64, 256), q) == "tiled"      # x + 2 bytes
    flat = torch.empty(256 * 128 + 16, dtype=torch.int8)
    assert qm.path(x, flat[8:-8].view(256, 128)) == "tiled"   # q + 8 bytes
    assert qm.path(x, flat[16:].view(256, 128)) == "wgmma"    # q + 16 bytes
    assert qm.path(x, q, flat[8:-8].view(256, 128)) == "tiled"  # qv + 8


# (k, n, columns a lane, want (lanes, splits)): kernel 10's projections of
# mamba2-130m and mamba-130m (int8), mamba2-2.7b's, and kernel 11's
# recurrentgemma-2b GeGLU weights (bf16).
GEMV_CASES = [(768, 3352, 16, (8, 4)), (1536, 768, 16, (4, 4)),
              (768, 3072, 16, (8, 4)), (2560, 10576, 16, (32, 4)),
              (5120, 2560, 16, (8, 4)), (2560, 7680, 8, (32, 4))]


@pytest.mark.parametrize("k,n,lc,want", GEMV_CASES)
def test_gemv_plan_is_pure_and_one_wave(k, n, lc, want):
    """The same shape gives the same plan (also computed afresh); the
    blocks fit one wave of the 132 SMs (kernel 11's (2560, 7680) no longer
    has a second wave) and no split is empty."""
    plan = qm.gemv_plan(k, n, lc)
    qm.gemv_plan.cache_clear()
    assert qm.gemv_plan(k, n, lc) == plan == want
    lanes, splits = plan
    assert lanes in qm.GEMV_LANES and splits in qm.GEMV_SPLITS
    blocks = math.ceil(n / (lanes * lc)) * splits
    assert blocks <= qm.SMS
    ks = math.ceil(k / splits)
    assert (splits - 1) * ks < k


@pytest.mark.parametrize("m", [256, 512])
@pytest.mark.parametrize("arch", ["mamba2-130m", "mamba-130m"])
def test_wgmma_splits_are_pure_and_fill_the_card(arch, m):
    """At the model shapes the 64 x 128 tiles and their k splits give at
    least one block an SM; every split holds k steps."""
    for name, k, n in _projections(arch, False):
        splits = qm.wgmma_splits(m, k, n)
        qm.wgmma_splits.cache_clear()
        assert qm.wgmma_splits(m, k, n) == splits
        tiles = math.ceil(m / 64) * math.ceil(n / 128)
        assert 1 <= splits <= qm.MAX_SPLITS
        assert tiles * splits >= qm.SMS, (name, tiles, splits)
        steps = math.ceil(k / 64)
        assert (splits - 1) * math.ceil(steps / splits) < steps


def test_matmul_pwl_gemv_shares_the_plan():
    """Kernel 11's decode shape takes the GEMV with bf16's 8 columns a
    lane; its fp32 weights 4."""
    x, w = _x(4, 2560), torch.empty((2560, 7680), dtype=torch.bfloat16)
    assert mp.path(x, w, w) == "gemv"
    assert qm.gemv_plan(2560, 7680, 16 // w.element_size()) == (32, 4)
    assert qm.load_bytes(7680, 2, w) == 16
    assert qm.load_bytes(7680, 4, w.float()) == 16


def test_kernel_6_plan_values():
    """Kernel 6 on the cluster GEMV: recurrentgemma-2b's width 2560 takes
    one plan, a function of the width and the weights' element size alone
    (b = 1..8 is one launch of one row group): 128 columns a block and
    clusters of 5 over k, (16, 5) with bf16 weights (100 blocks of 512 k
    rows), (32, 5) with fp32."""
    assert ds.rglru_plan(2560, 2) == (16, 5)
    assert ds.rglru_plan(2560, 4) == (32, 5)
    assert math.ceil(8 / qm.GEMV_M) == 1
    lanes, splits = ds.rglru_plan(2560, 2)
    assert math.ceil(2560 / (lanes * 8)) * splits == 100
    assert math.ceil(2560 / splits) == 512


def test_every_int8_value_widens_to_bf16_exactly():
    """int8 -> bf16 is exact, and so is csrc/gemm.cuh's I8W::widen: the
    byte biased by 128 in the low bits of 2^23, less 2^23 + 128."""
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    assert torch.equal(q.to(torch.bfloat16).to(torch.int32),
                       q.to(torch.int32))
    biased = q.numpy().view(np.uint8) ^ np.uint8(0x80)
    bits = np.uint32(0x4B000000) | biased.astype(np.uint32)
    f = bits.view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, q.numpy().astype(np.float32))


@pytest.mark.parametrize("n", [8, 136, 768, 3352, 7680])
def test_no_split_is_empty(n):
    """Every k from 8 to 4096 (in steps of 8) gives the GEMV and the
    ``wgmma`` body splits that each hold rows (the C launchers refuse an
    empty split), at every m the body takes."""
    for k in range(8, 4097, 8):
        for lc in (16, 8, 4):
            lanes, splits = qm.gemv_plan(k, n, lc)
            assert (splits - 1) * math.ceil(k / splits) < k, (k, lc)
        steps = math.ceil(k / 64)
        for m in (9, 64, 256, 512):
            splits = qm.wgmma_splits(m, k, n)
            assert splits & (splits - 1) == 0 and splits <= qm.MAX_SPLITS
            assert (splits - 1) * math.ceil(steps / splits) < steps, (k, m)


def _w8_shapes(arch):
    """(name, k, n) of every weight W8 quantizes in one layer of each
    kind of ``arch`` at full width (``nn/quant.py``'s skip-list and
    smallest size), from the model's param specs."""
    from repro_torch.nn.quant import DEFAULT_MIN_DIM, DEFAULT_SKIP
    specs = build_model(get_config(arch), "cpu").param_specs()
    blocks = [specs["layers"]] if "layers" in specs else \
        list(specs["groups"].values())
    out = set()
    for blk in blocks:
        for part, sub in blk.items():
            if not isinstance(sub, dict) or part in DEFAULT_SKIP:
                continue
            for name, p in sub.items():
                if not isinstance(p, dict) or "w" not in p or \
                        name in DEFAULT_SKIP:
                    continue
                k, n = p["w"].shape[-2:]
                if min(k, n) >= DEFAULT_MIN_DIM:
                    out.add((f"{part}.{name}", k, n))
    return sorted(out)


@pytest.mark.parametrize("m", [4, 256, 512])
@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-2b"])
def test_qmatmul_body_on_the_w8_transformer_shapes(arch, m):
    """Kernel 10 under W8 at gemma-2b's and recurrentgemma-2b's widths
    (the attention projections, the gated MLP's wi / wg and wo, the
    RG-LRU's projections and gates): the GEMV at m <= ``GEMV_M`` (decode
    and the draft steps), the ``wgmma`` body above it in bf16 (chunks and
    verify windows), never the SIMT ``tiled`` body; the gated form too."""
    shapes = _w8_shapes(arch)
    names = {s[0] for s in shapes}
    assert {"mlp.wi", "mlp.wg", "mlp.wo"} <= names
    assert ({"attn.wq", "attn.wk", "attn.wv", "attn.wo"} <= names
            if arch == "gemma-2b" else
            {"rglru.in_x", "rglru.rg", "rglru.out", "attn.wq"} <= names)
    want = "gemv" if m <= qm.GEMV_M else "wgmma"
    for name, k, n in shapes:
        q = _q(k, n)
        assert qm.path(_x(m, k), q) == want, name
        assert qm.path(_x(m, k), q, _q(k, n)) == want, name
        if want == "wgmma":
            assert 1 <= qm.wgmma_splits(m, k, n) <= qm.MAX_SPLITS
        else:
            lanes, splits = qm.gemv_plan(k, n, 16)
            assert lanes in qm.GEMV_LANES and splits in qm.GEMV_SPLITS
