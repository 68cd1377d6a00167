#!/usr/bin/env python3
"""The decode-step kernels of one tree of the port on one GPU:
``python3 scripts/step_kernel_times.py [--src DIR]``.

Times, through the wrappers of the port found under ``--src`` (default:
this checkout's ``src``), at b = 4, full width: TPU kernel 1
(``mamba2_step``, mamba2-130m's shapes, bf16, exact and with the ActiBA
tables), kernel 5 (``mamba1_step``, mamba-130m's), kernel 6
(``rglru_step``, recurrentgemma-2b's, warm and with its gates cold),
kernel 10's GEMV (mamba2-130m's W8 in_proj and out_proj) and kernel 11's
GEMV (recurrentgemma-2b's gated MLP), kernel 12 (``pwl_activate``) at the
``pallas()`` forward's three fp32 operands and at phase 4's 32-bucket
bf16 xBC, kernel 3 (``ssd_step``, fp32), kernel 4 (``sscan_step``, fp32
state (4, 1536, 16)), kernel 9 in fp32 (gemma-2b's MQA 8 x 256, causal,
at phase 5e's b = 4, L = 64 and at b = 1, L = 4096, on whichever body
the tree's wrapper takes), then mamba-130m's and recurrentgemma-2b's
decode steps at full width and depth.  Inputs, seeds,
the cold rotation and the timers are ``chip_smoke.py``'s (phase 7), so
two trees see the same numbers: unpack the other tree (``git archive``)
into a git-ignored directory and run the script once per tree in one
call, in turns (old, new, new, old).  Prints one JSON line per reading,
each with the tree's ``src`` and the card's name and power limit:

* a kernel: ``ms``, the call (CUDA events, median of 30); ``device_ms``,
  every kernel the call launches (``torch.profiler``, 10 calls);
  ``host_us``, the wrapper's host time a call (1000 calls, no
  synchronisation); kernel 6 also ``cold_ms`` and ``cold_device_ms``;
  kernels 1, 2, 3, 4, 5, 9 and 12 also ``digest``, a hash of the call's
  output bytes (the same digest in two trees is the same bits), and
  ``sm_mhz``, the SM clock after the reading; kernel 9 the ``body`` it
  took; kernels 3, 4 and 12 also ``graph_ms``, a
  launch's time in a CUDA graph of 50 launches (CUDA events, the gap
  between launches included: a timer apart from the profiler, whose
  readings of one kernel differ by ~1.25x between processes, PERF.md);
* ``ptxas``: registers and spills of kernels 1, 3, 4, 5, 9 (fp32 and
  SIMT bodies) and 12 (their sources rebuilt for the report);
* the ``pallas()`` forward (mamba2-130m fp32, b = 4, l = 300):
  ``device_ms`` and kernel 12's share and launches;
* a decode step: ``wall_ms`` (median of five runs of 10 steps, host
  clock around synchronised runs) and ``device_ms`` (profiler), with the
  kernel's share of the device time and its launches.

Exits 1 without a GPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _kernel_rows(cs, emit, dev):
    import torch
    from repro_torch.core.pwl import table_for
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.kernels import decode_step as ds, matmul_pwl, qmatmul
    bf16 = torch.bfloat16

    def row(kernel, call, **extra):
        emit(kernel=kernel, b=4, ms=cs.time_call(call),
             device_ms=sum(cs.device_profile(call).values()),
             host_us=cs.host_us(call), **extra)

    m1 = cs.mamba1_inputs(4, dev, bf16, seed=70)
    m1_call = lambda: ds.mamba1_step(**m1, dt_rank=cs.M1_DT_RANK)  # noqa
    row("mamba1_step", m1_call, digest=_digest(m1_call()), sm_mhz=_sm_mhz())
    rg = cs.rglru_inputs(4, dev, bf16, seed=100)
    cold, mb = cs.rglru_cold(ds.rglru_step, rg)
    row("rglru_step", lambda: ds.rglru_step(**rg),
        cold_ms=cs.time_call(cold, n=30),
        cold_device_ms=sum(cs.device_profile(cold, n=30).values()),
        cold_mb=mb)
    del cold
    for proj, k, n in (("in_proj", cs.D_MODEL, cs.D_IN_PROJ),
                       ("out_proj", cs.D_INNER, cs.D_MODEL)):
        args, _ = cs.qmatmul_inputs(4, k, n, dev, bf16, seed=44 + n)
        row(f"qmatmul gemv {proj}", lambda: qmatmul.qmatmul(*args))
    x, w, v = cs.mpwl_inputs(4, dev, bf16, seed=106, gated=True)
    gelu = table_for("gelu", XambaConfig.pallas())
    row("matmul_pwl gemv gated",
        lambda: matmul_pwl.matmul_pwl(x, w, gelu, v))


def _digest(outs) -> str:
    import hashlib
    import torch
    outs = outs if isinstance(outs, tuple) else (outs,)
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _graph_ms(call, k=50) -> float:
    """Milliseconds a launch of ``call`` in a CUDA graph of ``k`` launches
    (CUDA events around a replay, median of 20): kernel time and the
    graph's gap between launches, free of the profiler."""
    import statistics
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            call()
    ts = []
    for _ in range(23):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / k)
    return statistics.median(ts[3:])


def _sm_mhz() -> int:
    """The card's SM clock now (``nvidia-smi``), MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return int(out.stdout.split()[0])


def _pwl_ssd_rows(cs, emit, dev):
    """Kernels 1 (its row and its ActiBA epilogue's bits), 2 with the
    ActiBA tables (bits), 12 and 3, and ptxas's report of 1, 3 and 12."""
    import torch
    from repro_torch.core.pwl import table_for
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.kernels import actiba, decode_step as ds, \
        prefill_chunk as pc
    pallas = XambaConfig.pallas()
    tabs = {k: table_for(k, pallas) for k in ("silu", "softplus")}
    kw = dict(ngroups=cs.N_GROUPS, head_dim=cs.HEAD_DIM)
    ktab = dict(silu_table=tabs["silu"], softplus_table=tabs["softplus"])

    def row(kernel, call, graph=False, **extra):
        ms = cs.time_call(call)
        device_ms = sum(cs.device_profile(call).values())
        if graph:
            extra["graph_ms"] = _graph_ms(call)
        emit(kernel=kernel, ms=ms, device_ms=device_ms, sm_mhz=_sm_mhz(),
             host_us=cs.host_us(call), digest=_digest(call()), **extra)

    ins = cs.decode_inputs(4, dev, torch.bfloat16, seed=31)
    row("mamba2_step", lambda: ds.mamba2_step(**ins, **kw), b=4)
    row("mamba2_step actiba", lambda: ds.mamba2_step(**ins, **kw, **ktab),
        b=4)
    pre = cs.prefill_inputs(4, 128, dev, torch.bfloat16, seed=32)
    row("mamba2_prefill actiba", lambda: pc.mamba2_prefill(
        **pre, chunk=128, **kw, **ktab), b=4, l=128)
    for dtype in (torch.float32, torch.bfloat16):
        ch = cs.chain_inputs(dev, dtype, seed=34)
        cases = ([("silu", ch["xbc"]), ("silu", ch["z"]),
                  ("softplus", ch["dt"])] if dtype == torch.float32 else
                 [("silu", ch["xbc"][:, :32].contiguous())])
        for name, x in cases:
            row("pwl_activate", lambda: actiba.pwl_activate(x, tabs[name]),
                graph=True, table=name, dtype=str(dtype).split(".")[-1],
                shape=list(x.shape))
        del ch
    args = cs.ssd_step_inputs(4, dev, torch.float32, seed=72)
    row("ssd_step", lambda: ds.ssd_step(*args), graph=True, b=4,
        shape=list(args[0].shape))
    for source, needle in (("actiba", "pwl_activate_kernel"),
                           ("decode_step", "ssd_step_kernel"),
                           ("decode_step", "mamba2_step_kernel")):
        for line in cs.ptxas_lines(source, needle):
            emit(ptxas=line)


def _sscan_flash_rows(cs, emit, dev):
    """Kernel 4 (fp32 state (4, 1536, 16), with D) and kernel 9 in fp32 at
    phase 5e's shape (gemma-2b, b = 4, MQA 8 x 256, L = 64, causal) and at
    b = 1, L = 4096, whichever body the tree's wrapper takes, and ptxas's
    report of kernels 4, 5 and 9 (fp32 and SIMT bodies)."""
    import torch
    from repro_torch.kernels import decode_step as ds, flash_attention as fa
    f32 = torch.float32
    args = cs.sscan_inputs(4, dev, f32, seed=71)
    call = lambda: ds.sscan_step(*args)                 # noqa: E731
    emit(kernel="sscan_step", b=4, shape=list(args[0].shape),
         ms=cs.time_call(call), device_ms=sum(cs.device_profile(call).values()),
         graph_ms=_graph_ms(call), sm_mhz=_sm_mhz(), host_us=cs.host_us(call),
         digest=_digest(call()))
    for b, l in ((4, 64), (1, 4096)):
        q, k, v = cs.flash_inputs(b, 8, 1, l, 256, dev, f32, seed=200 + l)
        call = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa
        before = dict(fa.flash_attention.path_launches)
        call()
        body = [n for n, c in fa.flash_attention.path_launches.items()
                if c != before.get(n, 0)]
        emit(kernel="flash_attention fp32", b=b, l=l, body=body,
             ms=cs.time_call(call, n=30 if l == 64 else 10),
             device_ms=sum(cs.device_profile(call).values()),
             sm_mhz=_sm_mhz(),
             host_us=cs.host_us(call, n=1000 if l == 64 else 20),
             digest=_digest(call()))
    for source, needle in (("mamba1_step", "sscan_step_kernel"),
                           ("mamba1_step", "mamba1_step_kernel"),
                           ("flash_attention", "flash_attention_fp32"),
                           ("flash_attention", "flash_attention_kernel")):
        for line in cs.ptxas_lines(source, needle):
            emit(ptxas=line)


def _forward_rows(cs, emit, dev):
    """The Fig. 4a ``pallas()`` forward (mamba2-130m fp32, b = 4, l = 300,
    ``chip_smoke.py`` phase 6's shape and seed): its device time, kernel
    12's share of it and kernel 12's launches a forward."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.kernels import actiba
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    cfg = get_config("mamba2-130m").replace(param_dtype="float32",
                                            xamba=XambaConfig.pallas())
    model = build_model(cfg, dev)
    params = init_params(model.param_specs(), 2, torch.float32, dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, size=(cs.CHAIN_B, cs.CHAIN_L)).astype(
            np.int64)).to(dev)
    fwd = lambda: model.forward(params, tokens)             # noqa: E731
    fwd()
    before = actiba.pwl_activate.launches
    fwd()
    launches = actiba.pwl_activate.launches - before
    by = cs.device_profile(fwd, n=5)
    emit(forward="mamba2-130m pallas()", b=cs.CHAIN_B, l=cs.CHAIN_L,
         device_ms=sum(by.values()), sm_mhz=_sm_mhz(),
         pwl_device_ms=sum(v for k, v in by.items()
                           if "pwl_activate_kernel" in k),
         pwl_launches=launches)
    del model, params
    torch.cuda.empty_cache()


def _step_rows(cs, emit, dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_step as ds
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    for arch, kernel in (("mamba-130m", "mamba1_step"),
                         ("recurrentgemma-2b", "rglru_step")):
        cfg = get_config(arch)
        model = build_model(cfg, dev)
        params = model.decode_view(init_params(model.param_specs(), 0,
                                               torch.bfloat16, dev))
        toks = torch.ones((4, 16), dtype=torch.long, device=dev)
        _, cache = model.prefill(params, {"tokens": toks},
                                 model.init_cache(4, 17, torch.bfloat16))
        tok = toks[:, :1]
        step = lambda: model.decode_step(params, tok, cache, 16)  # noqa
        step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(10):
                step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / 10 * 1e3)
        before = getattr(ds, kernel).launches
        step()
        launches = getattr(ds, kernel).launches - before
        by = cs.device_profile(step)
        emit(step=arch, b=4, wall_ms=sorted(walls)[2], walls_ms=walls,
             device_ms=sum(by.values()), kernel=kernel,
             kernel_device_ms=sum(v for k, v in by.items() if kernel in k),
             launches_a_step=launches)
        del model, params, cache
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory (repro_torch inside)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("step_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs._nvidia_smi()

    def emit(**row):
        print(json.dumps(dict(src=str(src), card=card, **row)), flush=True)
    for name in ("actiba", "decode_step", "mamba1_step",
                 "flash_attention"):           # rebuilt: ptxas's report
        build._target(name).unlink(missing_ok=True)
    build.build_all()
    with torch.inference_mode():
        _sscan_flash_rows(cs, emit, dev)
        _pwl_ssd_rows(cs, emit, dev)
        _forward_rows(cs, emit, dev)
        _kernel_rows(cs, emit, dev)
        _step_rows(cs, emit, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
