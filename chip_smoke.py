#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives ``src/repro_torch`` (never JAX) at the full width of mamba2-130m:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — ``nvcc`` builds every kernel from ``src/repro_torch/csrc``;
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, in fp32 and bf16: the decode step at b = 1 and 4, the
   prefill at b = 4 with l = 128 (one chunk) and l = 512 at chunk 256
   (state carried between chunks);
4. serve   — the wave engine through ``repro_torch.launch.serve``: 8
   requests, batch 4, prompts of 4-128 tokens, 16 new tokens, greedy,
   bf16 weights from ``--seed``; every token in the vocabulary, every
   logit finite, and each kernel launched 24 times per decode step and
   per wave;
5. parity  — the same model in fp32, kernel path on the card against the
   plain path on the CPU, teacher-forced over 16 greedy tokens of 4
   prompts: tokens agree wherever the plain path's top-2 margin exceeds
   the logit tolerance;
6. times   — each kernel and its plain version at the serve shapes (CUDA
   events, median), launches per decode step and per prefill, the bound.

Any failure raises (exit code 1).  Without a GPU it exits 1 before doing
anything.  The second line from the end is the ``kernels`` JSON record,
the last line the device record.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 CUDA-core
# FLOP/s.  The kernels of this slice compute in fp32 on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# Kernel vs plain version on the same inputs, element by element:
#     |kernel - plain| <= rtol * (|plain| + ATOL_RMS * rms(plain))
# rtol of each element, plus an atol of ATOL_RMS x rtol at the output's
# typical magnitude.  The atol is for elements near zero: the pre-norm y
# is a sum of up to 256 products and a carried term, its error follows the
# size of those terms, and where they cancel the element is small but its
# error is not.  rtol is keyed by the case's stream dtype and the output:
# "stream" = y and the conv tail (in the stream dtype), "state" = the
# fp32 SSM state (fp32 in both cases, so 1e-4 in both).
#   fp32: the two take the same sums in other orders: 1e-4.
#   bf16 streams: one bf16 step (2^-7 of a value at most).  A value that
#     lies within the fp32 difference of a bf16 rounding boundary rounds
#     the other way at one of the stream dtype's rounding points (y, the
#     D skip, the norm, the gate).  That happens to few elements, so the
#     share of elements that are not bit-equal is held to MAX_OFF_SHARE
#     besides: a fault smaller than a step (a missing rounding point, a
#     lost D skip) moves most elements.
# The chip readings each limit was set from are in PERF.md.
TOL = {("float32", "stream"): 1e-4, ("float32", "state"): 1e-4,
       ("bfloat16", "stream"): 2.0 ** -7, ("bfloat16", "state"): 1e-4}
ATOL_RMS = 4.0
MAX_OFF_SHARE = 0.005
# Logit tolerance of the fp32 path-parity phase (absolute).
LOGIT_TOL = 2e-3

N_HEADS, HEAD_DIM, D_STATE, N_GROUPS, WIDTH = 24, 64, 128, 1, 4
D_INNER = N_HEADS * HEAD_DIM
D_XBC = D_INNER + 2 * N_GROUPS * D_STATE


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _rand(gen, shape, scale, dev, dtype):
    import torch
    return (torch.randn(shape, generator=gen) * scale).to(dev).to(dtype)


def decode_inputs(b, dev, dtype, seed):
    """Full-width decode-step operands (the JAX tests' recipe); streams in
    ``dtype``, the state and the small parameters in fp32, as the model's
    ``decode_view`` hands them to the kernels."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    return dict(
        z=_rand(g, (b, D_INNER), 1.0, dev, dtype),
        xbc=_rand(g, (b, D_XBC), 1.0, dev, dtype),
        dt=_rand(g, (b, N_HEADS), 1.0, dev, dtype),
        conv_state=_rand(g, (b, WIDTH - 1, D_XBC), 1.0, dev, dtype),
        ssm_state=_rand(g, (b, N_HEADS, HEAD_DIM, D_STATE), 1.0, dev, f32),
        conv_w=_rand(g, (WIDTH, D_XBC), 0.3, dev, f32),
        conv_b=_rand(g, (D_XBC,), 0.1, dev, f32),
        dt_bias=_rand(g, (N_HEADS,), 0.1, dev, f32),
        A=-torch.rand(N_HEADS, generator=g).mul(1.9).add(0.1).to(dev),
        D=_rand(g, (N_HEADS,), 1.0, dev, f32),
        norm_scale=_rand(g, (D_INNER,), 1.0, dev, f32))


def prefill_inputs(b, l, dev, dtype, seed):
    """Full-width prefill operands with a nonzero carried state (dtypes
    as :func:`decode_inputs`)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    return dict(
        z=_rand(g, (b, l, D_INNER), 1.0, dev, dtype),
        xbc=_rand(g, (b, l, D_XBC), 1.0, dev, dtype),
        dt=_rand(g, (b, l, N_HEADS), 1.0, dev, dtype),
        conv_state=_rand(g, (b, WIDTH - 1, D_XBC), 1.0, dev, dtype),
        ssm_state=_rand(g, (b, N_HEADS, HEAD_DIM, D_STATE), 0.1, dev, f32),
        conv_w=_rand(g, (WIDTH, D_XBC), 0.3, dev, f32),
        conv_b=_rand(g, (D_XBC,), 0.1, dev, f32),
        dt_bias=_rand(g, (N_HEADS,), 0.1, dev, f32),
        A=-torch.exp(torch.randn(N_HEADS, generator=g) * 0.3).to(dev),
        D=_rand(g, (N_HEADS,), 0.2, dev, f32),
        norm_scale=(torch.randn(D_INNER, generator=g).abs() + 0.5).to(dev))


def _bf16_steps(diff, r):
    """``diff`` in bf16 steps at ``|r|`` (the spacing of bf16 values
    there: 2^(floor(log2|r|) - 7))."""
    import torch
    e = torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
    return diff / torch.exp2(e - 7)


def compare(name, got, want, dtype_name):
    """Each output element by element against the plain version (``TOL``,
    ``ATOL_RMS``, ``MAX_OFF_SHARE``); prints the readings and returns
    (worst abs error, names of the outputs that failed)."""
    import torch
    worst, fails = 0.0, []
    for out_name, a, r in zip(("y", "conv", "ssm"), got, want):
        rtol = TOL[dtype_name, "state" if out_name == "ssm" else "stream"]
        a32, r32 = a.float(), r.float()
        diff = (a32 - r32).abs()
        rms = float(r32.square().mean().sqrt())
        tol = rtol * (r32.abs() + ATOL_RMS * rms)
        used = float((diff / tol.clamp_min(1e-30)).max())
        # The atol each element needs at this rtol, in units of rms.
        need = float(((diff / rtol - r32.abs()) / max(rms, 1e-30)).max())
        err = float(diff.max())
        ok = used <= 1.0 and a.dtype == r.dtype and a.shape == r.shape
        msg = (f"  {name} {out_name}: max_abs_err {err:.3e}; worst element "
               f"at {used:.4f} of its tolerance (rtol {rtol:.3g}, atol "
               f"needed {max(need, 0.0):.3f} x rms of {ATOL_RMS:g})")
        if a.dtype == torch.bfloat16:
            n_off = int((diff > 0).sum())
            n_over = int((_bf16_steps(diff, r32) > 1).sum())
            msg += (f"; {n_off} of {diff.numel()} elements differ "
                    f"({n_off / diff.numel():.4%}), {n_over} by more than "
                    f"one bf16 step")
            ok = ok and n_off <= max(2, MAX_OFF_SHARE * diff.numel())
        print(msg + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            fails.append(f"{name} {out_name}")
        worst = max(worst, err)
    return worst, fails


def kernel_cases(dev, kernels):
    """Phase 3: every kernel against its plain version on the card.  Every
    case is printed; the phase fails at its end if any output failed."""
    import torch
    kw = dict(ngroups=N_GROUPS, head_dim=HEAD_DIM)
    worst = {"mamba2_step": 0.0, "mamba2_prefill": 0.0}
    fails = []

    def check(kernel, case, got, want, dn):
        err, bad = compare(f"{kernel} {case}", got, want, dn)
        worst[kernel] = max(worst[kernel], err)
        fails.extend(bad)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b in (1, 4):
            ins = decode_inputs(b, dev, dtype, seed=10 + b)
            got = kernels["mamba2_step"](**ins, **kw)
            want = kernels["mamba2_step_plain"](**ins, **kw)
            torch.cuda.synchronize(dev)
            check("mamba2_step", f"{dn} b={b}", got, want, dn)
        for b, l, chunk in ((4, 128, 128), (4, 512, 256)):
            ins = prefill_inputs(b, l, dev, dtype, seed=20 + l)
            got = kernels["mamba2_prefill"](**ins, chunk=chunk, **kw)
            want = kernels["mamba2_prefill_plain"](**ins, chunk=chunk, **kw)
            torch.cuda.synchronize(dev)
            check("mamba2_prefill", f"{dn} b={b} l={l} chunk={chunk}", got,
                  want, dn)
    if fails:
        raise AssertionError(f"kernels vs plain: {fails}")
    return worst


SERVE_ARGV = ["--arch", "mamba2-130m", "--requests", "8", "--batch", "4",
              "--prompt-len", "128", "--max-new", "16", "--temperature", "0",
              "--seed", "0"]


def serve_phase(serve_main, counters, argv):
    """Phase 4: the CLI's wave engine; returns (engine, launches, steps,
    waves)."""
    import torch
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    engine, done = serve_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    cfg = engine.model.cfg
    m = engine.metrics.summary()
    waves = math.ceil(len(done) / engine.cfg.max_batch)
    steps = m["decode_steps"]
    toks = [t for r in done for t in r.out_tokens]
    assert len(done) == 8 and all(len(r.out_tokens) == 16 for r in done), \
        "serve: every request must get 16 tokens"
    assert all(0 <= t < cfg.vocab_size for t in toks), "serve: token id"
    assert m["logit_rows"] > 0 and m["nonfinite_logit_rows"] == 0, \
        f"serve: non-finite logits {m['nonfinite_logit_rows']}"
    want = {"mamba2_step": cfg.n_layers * steps,
            "mamba2_prefill": cfg.n_layers * waves}
    print(f"  launches {launches} expected {want} "
          f"({waves} waves, {steps} decode steps, {cfg.n_layers} layers)")
    assert launches == want, "serve: kernel launch counts"
    assert all(v > 0 for v in launches.values()), "serve: a kernel idle"
    st = engine.stats(done)
    print(f"  generated {st['generated_tokens']} tokens in "
          f"{st['wall_s']:.4f} s of waves: {st['tokens_per_s']:.1f} tok/s; "
          f"ttft_mean_s {m['ttft_mean_s']:.4f} ttft_p99_s "
          f"{m['ttft_p99_s']:.4f}; decode step mean "
          f"{m['token_latency_s'] * 1e3:.3f} ms; call wall {wall:.3f} s "
          f"(weights included)", flush=True)
    return engine, launches, steps, waves


def parity_phase(dev, seed, cfg):
    """Phase 5: fp32 kernel path (card) vs plain path (CPU), teacher
    forced over the kernel path's own greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params

    cfg = cfg.replace(param_dtype="float32")
    gpu = build_model(cfg, dev)
    cpu = build_model(cfg, "cpu")
    params = init_params(gpu.param_specs(), seed, torch.float32, dev)
    cparams = _to_cpu(params)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(4, 128)).astype(np.int64))

    def run(model, p, device, forced):
        cache = model.init_cache(4, dtype=torch.float32)
        logits, cache = model.prefill(p, {"tokens": prompts.to(device)},
                                      cache)
        outs = [logits.cpu()]
        for t in range(15):
            tok = forced[:, t:t + 1] if forced is not None else \
                outs[-1].argmax(-1, keepdim=True)
            logits, cache = model.decode_step(p, tok.to(device), cache, t)
            outs.append(logits.cpu())
        return torch.stack(outs, 1)                  # (4, 16, vocab)

    with torch.inference_mode():
        lk = run(gpu, params, dev, None)
        forced = lk.argmax(-1)                       # kernel path's tokens
        lp = run(cpu, cparams, "cpu", forced)
    err = float((lk - lp).abs().max())
    top2 = lp.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    confident = margin > LOGIT_TOL
    agree = (lk.argmax(-1) == lp.argmax(-1))
    print(f"  logits max_abs_err {err:.3e} (tol {LOGIT_TOL:.0e}); "
          f"{int(confident.sum())}/{confident.numel()} positions above the "
          f"margin, {int(agree[confident].sum())} agree; "
          f"{int(agree.sum())}/{agree.numel()} agree overall", flush=True)
    assert torch.isfinite(lk).all() and torch.isfinite(lp).all()
    assert err <= LOGIT_TOL, f"parity: logit error {err}"
    assert bool(agree[confident].all()), "parity: confident token differs"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def time_call(fn, n=30, warmup=3):
    """Median milliseconds of ``fn()`` over ``n`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


OUR_KERNELS = ("mamba2_step_kernel", "gated_norm_kernel", "conv_act_kernel",
               "ssd_scan_kernel")


def device_profile(fn, n=10):
    """Device milliseconds per call of ``fn()`` by kernel name, from
    ``torch.profiler`` (CUDA activity only); empty when the profiler saw
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by[ev.key] = by.get(ev.key, 0.0) + us / 1e3 / n
    return by


def _ours(by):
    return sum(v for k, v in by.items() if any(o in k for o in OUR_KERNELS))


def step_breakdown(engine):
    """One full-width decode step and one prefill (b = 4, l = 128) of the
    served model: host wall per call, device time per call from the
    profiler, the device's busy share, and the largest kernels."""
    import torch
    model, params = engine.model, engine.params
    b = engine.cfg.max_batch
    toks = torch.ones((b, 128), dtype=torch.long, device=model.device)

    def prefill():
        return model.prefill(params, {"tokens": toks},
                             model.init_cache(b, dtype=model.cfg.dtype))

    _, cache = prefill()
    tok = toks[:, :1]

    def decode():
        return model.decode_step(params, tok, cache, 0)

    for name, fn in (("decode step", decode), ("prefill l=128", prefill)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        by = device_profile(fn)
        dev_ms = sum(by.values())
        if not by:
            print(f"  {name}: host {host_ms:.3f} ms per call; device time "
                  f"not measured (the profiler saw none)")
            continue
        top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
        print(f"  {name} (b={b}, model): wall {host_ms:.3f} ms, device "
              f"{dev_ms:.3f} ms ({100 * dev_ms / host_ms:.1f}% busy), "
              f"ported kernels {_ours(by):.3f} ms", flush=True)
        for k, v in top:
            print(f"    {v:.4f} ms  {k[:90]}")


def _bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def decode_bound(ins, outs):
    """(ms, 'bytes'|'operations'): inputs read once and outputs written
    once over HBM, vs ~5 fp32 operations per state element (decay, x*dt,
    *B, +, *C and its sum) plus the conv and the norm, over fp32 peak."""
    b, h, p, n = ins["ssm_state"].shape
    ops = 5 * b * h * p * n + 10 * b * D_XBC + 10 * b * D_INNER
    return _bound(_bytes(*ins.values(), *outs), ops)


def prefill_bound(ins, outs):
    """As :func:`decode_bound`, for the least work the function needs: the
    recurrence's ~5 fp32 operations per state element per token, plus the
    conv and the norm per token."""
    b, l, _ = ins["z"].shape
    ops = recurrence_ops(b, l) + l * (10 * b * D_XBC + 10 * b * D_INNER)
    return _bound(_bytes(*ins.values(), *outs), ops)


def recurrence_ops(b, l):
    """h = a.h + (dt.x) B and y = h.C: ~5 operations per state element and
    token."""
    return 5 * b * l * N_HEADS * HEAD_DIM * D_STATE


def chunked_ops(b, l, chunk):
    """Operations of the chunked form the prefill kernel runs, per chunk
    of L and head: C.B over L(L+1)/2 pairs x n, its product with x*dt over
    p, the carried-state term and the state update, L x n x p each (2 per
    multiply-add)."""
    tri = chunk * (chunk + 1) // 2
    per = 2 * tri * D_STATE + 2 * tri * HEAD_DIM + \
        4 * chunk * D_STATE * HEAD_DIM
    return b * N_HEADS * (l // chunk) * per


def _bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def times_phase(dev, kernels, launches, steps, waves, worst):
    """Phase 6: kernel and plain times at the serve shapes (bf16, b=4;
    prefill l=128, one chunk) and the kernels record."""
    import torch
    kw = dict(ngroups=N_GROUPS, head_dim=HEAD_DIM)
    dtype = torch.bfloat16
    rows = []
    ins = decode_inputs(4, dev, dtype, seed=31)
    outs = kernels["mamba2_step"](**ins, **kw)
    ms = time_call(lambda: kernels["mamba2_step"](**ins, **kw))
    plain_ms = time_call(lambda: kernels["mamba2_step_plain"](**ins, **kw))
    dev_ms = _ours(device_profile(lambda: kernels["mamba2_step"](**ins, **kw)))
    bound_ms, bound_by = decode_bound(ins, outs)
    rows.append(dict(
        name="mamba2_step", route="cuda",
        source="src/repro_torch/csrc/decode_step.cu",
        replaces="src/repro/kernels/decode_step.py:155",
        launches=launches["mamba2_step"],
        max_abs_err=worst["mamba2_step"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    print(f"  mamba2_step b=4 bf16: kernel {ms:.4f} ms (device time of its "
          f"two kernels {dev_ms:.4f} ms), plain {plain_ms:.4f}"
          f" ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{launches['mamba2_step'] / steps:.0f} launches per decode step",
          flush=True)

    ins = prefill_inputs(4, 128, dev, dtype, seed=32)
    outs = kernels["mamba2_prefill"](**ins, chunk=128, **kw)
    ms = time_call(lambda: kernels["mamba2_prefill"](**ins, chunk=128, **kw))
    plain_ms = time_call(
        lambda: kernels["mamba2_prefill_plain"](**ins, chunk=128, **kw))
    dev_ms = _ours(device_profile(
        lambda: kernels["mamba2_prefill"](**ins, chunk=128, **kw)))
    bound_ms, bound_by = prefill_bound(ins, outs)
    print("  the chunked form the kernel runs does " + ", ".join(
        f"{chunked_ops(4, l, c) / recurrence_ops(4, l):.3f}x (l={l}, chunk "
        f"{c})" for l, c in ((128, 128), (512, 256)))
        + " the recurrence's operations, which the bound counts", flush=True)
    rows.append(dict(
        name="mamba2_prefill", route="cuda",
        source="src/repro_torch/csrc/prefill_chunk.cu",
        replaces="src/repro/kernels/prefill_chunk.py:294",
        launches=launches["mamba2_prefill"],
        max_abs_err=worst["mamba2_prefill"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    print(f"  mamba2_prefill b=4 l=128 bf16: kernel {ms:.4f} ms (device "
          f"time of its three kernels {dev_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{launches['mamba2_prefill'] / waves:.0f} launches per prefill; "
          f"library: no single PyTorch call", flush=True)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, decode_step, prefill_chunk
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    print("== 1. device", flush=True)
    smi = _nvidia_smi()
    print(smi, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    print("== 2. build", flush=True)
    secs = build.build_all()
    print(f"  nvcc built {list(build.SOURCES)} in {secs:.1f} s", flush=True)
    for name in build.SOURCES:
        for line in str(build.BUILD_LOG.get(name, "")).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = {
        "mamba2_step": decode_step.mamba2_step,
        "mamba2_step_plain": decode_step.mamba2_step_plain,
        "mamba2_prefill": prefill_chunk.mamba2_prefill,
        "mamba2_prefill_plain": prefill_chunk.mamba2_prefill_plain,
    }
    counters = {"mamba2_step": decode_step.mamba2_step,
                "mamba2_prefill": prefill_chunk.mamba2_prefill}

    print("== 3. kernels vs plain (full width)", flush=True)
    with torch.inference_mode():
        worst = kernel_cases(dev, kernels)

    print("== 4. serve (mamba2-130m, bf16, wave engine)", flush=True)
    engine, launches, steps, waves = serve_phase(serve.main, counters,
                                                 SERVE_ARGV)

    print("== 5. path parity (fp32, kernel path vs plain path)", flush=True)
    parity_phase(dev, 1, get_config("mamba2-130m"))

    print("== 6. times (serve shapes)", flush=True)
    with torch.inference_mode():
        rows = times_phase(dev, kernels, launches, steps, waves, worst)
        step_breakdown(engine)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
