#!/usr/bin/env python3
"""What moves the train step's compute split over ``model`` away from the
whole step on the card: ``python3 scripts/split_arithmetic.py`` on a
machine with a GPU (no options; exits 1 without one).

In one process on card 0, from the params of seed 0 and the first batch
of phases 4n and 4o of ``chip_smoke.py`` (b = 8, l = 512): mamba2-130m
at full width and gemma-2b at full width and depth 2 (``use_flash``),
bf16, ``remat`` full.  The gradients at those params, four ways: the
plain step (every product whole); the same with cuBLAS's reduced-
precision bf16 reductions off; the split over two model ranks
(``collectives.EmulatedGroup(2)``, what the ranks compute); and the
model in fp32 on the same params, as the truth.  Prints each way's loss
and gradient norm, then the leaves where the plain and split gradients
part most, each way's distance from the fp32 gradient there.  Then the
split against the whole step in fp32 (``programs.split_fp32_departures``'
reading), over the tree and in its worst leaves, with kernel 9's
launches by body each way, for the two models and for gemma-2b without
``use_flash``; and, as a yardstick of two equally valid fp32
computations, gemma-2b's whole fp32 gradient with kernel 9 against
without it.

Then mamba2-130m's three steps of ``launch/train.py``'s schedule (lr 0,
3e-5, 6e-5), plain against split: each step's |loss diff| and relative
grad-norm diff, the moments' and update's departures
(``distributed/programs.py: departures``), and the bf16 params step 1
(the first with lr > 0) leaves different, with how many of them the two
ways proposed AdamW updates for within 10% of each other (``lr *
delta``, recomputed from each way's moments): bf16 rounding put the two
on either side of a rounding boundary.
"""
from __future__ import annotations

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

STEPS, B, L = 3, 8, 512
SCHEDULE = dict(base_lr=3e-4, warmup_steps=10, total_steps=20)
MODELS = (("mamba2-130m", {}, 5),
          ("gemma-2b", dict(n_layers=2, use_flash=True), 6))


def _batches(cfg, seed, dev):
    from repro_torch.data import DataConfig, SyntheticLM, to_device_batch
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=L,
                                  global_batch=B, seed=seed))
    return [to_device_batch(data.next(), dev) for _ in range(STEPS)]


def _grads(model, params, batch, group=None):
    from repro_torch.distributed import collectives
    from repro_torch.nn.params import tree_leaves
    from repro_torch.train.step import compute_grads
    with collectives.model_split(group):
        g, met = compute_grads(model, params, batch)
    return float(met["loss"]), tree_leaves(g)


def _norm(gs):
    return float(torch.sqrt(sum(g.double().square().sum() for g in gs)))


def leaves(arch, overrides, seed, dev):
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import EmulatedGroup
    from repro_torch.distributed.programs import _leaf_names, \
        initial_state, train_config
    from repro_torch.models import build_model
    from repro_torch.nn.params import tree_map
    cfg = get_config(arch).replace(**overrides)
    model = build_model(cfg, dev)
    params = initial_state(model, {"seed": 0}, train_config({}))["params"]
    batch = _batches(cfg, seed, dev)[0]
    names = _leaf_names(params)
    ways = {"plain": _grads(model, params, batch)}
    mm = torch.backends.cuda.matmul
    mm.allow_bf16_reduced_precision_reduction = False
    ways["plain, no reduced-precision reductions"] = _grads(model, params,
                                                           batch)
    mm.allow_bf16_reduced_precision_reduction = True
    ways["split"] = _grads(model, params, batch, EmulatedGroup(2))
    wide = build_model(cfg.replace(param_dtype="float32"), dev)
    ways["fp32"] = _grads(wide, tree_map(lambda t: t.float(), params),
                          batch)
    print(f"{arch} {overrides or ''}: " + "; ".join(
        f"{k} loss {v[0]:.6f} grad norm {_norm(v[1]):.5f}"
        for k, v in ways.items()), flush=True)
    truth = ways["fp32"][1]
    part = sorted(((float((a.double() - b.double()).norm()), i)
                   for i, (a, b) in enumerate(zip(ways["plain"][1],
                                                  ways["split"][1]))),
                  reverse=True)
    for d, i in part[:4]:
        t = truth[i].double()
        print(f"  {names[i]}: |plain - split| {d:.4e}, |fp32| "
              f"{float(t.norm()):.4e}, from fp32: " + ", ".join(
                  f"{k} {float((v[1][i].double() - t).norm() / t.norm()):.4e}"
                  for k, v in ways.items() if k != "fp32"), flush=True)


def fp32_leaves(arch, overrides, seed, dev):
    """The same model in fp32 on the same params and batch: the split's
    gradient against the whole step's, over the tree and in the leaves
    where they part most, with kernel 9's launches by body each way."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import EmulatedGroup
    from repro_torch.distributed.programs import _leaf_names, \
        initial_state, train_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import build_model
    from repro_torch.nn.params import tree_map
    cfg = get_config(arch).replace(**overrides)
    params = initial_state(build_model(cfg, dev), {"seed": 0},
                           train_config({}))["params"]
    wide = build_model(cfg.replace(param_dtype="float32"), dev)
    p32 = tree_map(lambda t: t.float(), params)
    batch = _batches(cfg, seed, dev)[0]
    paths = flash_attention.flash_attention.path_launches
    ways = {}
    for name, group in (("whole", None), ("split", EmulatedGroup(2))):
        before = dict(paths)
        ways[name] = _grads(wide, p32, batch, group)[1]
        print(f"  {name}: kernel 9 launches by body "
              f"{ {k: paths[k] - before[k] for k in paths} }", flush=True)
    whole, split = ways["whole"], ways["split"]
    num = sum(float((a.double() - b.double()).square().sum())
              for a, b in zip(split, whole))
    print(f"{arch} {overrides} fp32: split against whole "
          f"{(num ** 0.5) / _norm(whole):.4e} of the gradient's norm",
          flush=True)
    part = sorted(((float((a.double() - b.double()).norm()
                          / b.double().norm()), i)
                   for i, (a, b) in enumerate(zip(split, whole))),
                  reverse=True)
    names = _leaf_names(params)
    for d, i in part[:3]:
        print(f"  {names[i]}: {d:.4e} of its norm "
              f"({float(whole[i].double().norm()):.4e})", flush=True)
    return whole


def steps(dev):
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import EmulatedGroup
    from repro_torch.distributed.programs import departures, \
        initial_state, train_config
    from repro_torch.models import build_model
    from repro_torch.optim import schedule as sched
    model = build_model(get_config("mamba2-130m"), dev)
    tc = train_config({"schedule": SCHEDULE})
    start = initial_state(model, {"seed": 0}, tc)
    batches = _batches(model.cfg, 5, dev)
    plain = _run(model, tc, start, batches, None)
    got = _run(model, tc, start, batches, EmulatedGroup(2))
    loss = [abs(g[1]["loss"] - p[1]["loss"]) for g, p in zip(got, plain)]
    norm = [abs(g[1]["grad_norm"] - p[1]["grad_norm"]) / p[1]["grad_norm"]
            for g, p in zip(got, plain)]
    dep = departures(got[-1][0], plain[-1][0], start)
    n, near, total = _flips(start, plain[1][0], got[1][0],
                            float(sched.lr_at(torch.tensor(1), tc.schedule)),
                            tc.optimizer)
    print(f"mamba2-130m, {STEPS} steps, split on 2 model ranks against the "
          f"plain step: losses {[f'{x:.3e}' for x in loss]}, grad norms "
          f"{[f'{x:.3e}' for x in norm]}, moments {dep['moments']:.4e} "
          f"(worst leaf {dep['leaf'][1]} {dep['leaf'][0]:.3e}), update "
          f"{dep['update']:.4e}; step 1 left {n} of {total} params "
          f"different, {near} of them from proposals within 10% of each "
          f"other", flush=True)


def _run(model, tc, start, batches, group):
    """Each step's (state, metrics); ``group`` None: the plain step.  The
    split way clips by its gradient's whole norm, as the plain step."""
    from repro_torch.distributed import collectives
    from repro_torch.optim import adamw, schedule as sched
    from repro_torch.train import make_train_step
    from repro_torch.train.step import compute_grads
    step = make_train_step(model, tc)
    state, out = start, []
    for b in batches:
        if group is None:
            state, met = step(state, b)
        else:
            with collectives.model_split(group):
                g, met = compute_grads(model, state["params"], b)
            lr = sched.lr_at(state["opt"]["step"], tc.schedule)
            params, opt, stats = adamw.update(g, state["opt"],
                                              state["params"], lr,
                                              tc.optimizer)
            state = dict(state, params=params, opt=opt)
            met = dict(met, **stats)
        out.append((state, {k: float(v) for k, v in met.items()}))
    return out


def _flips(start, plain1, got1, lr, ocfg):
    """Params step 1 left different, and how many of those the two ways
    proposed updates for within 10% of each other."""
    from repro_torch.nn.params import tree_leaves
    n = near = total = 0
    c1, c2 = 1 - ocfg.b1 ** 2, 1 - ocfg.b2 ** 2

    def proposal(x0, m, v):
        d = (m / c1) / (torch.sqrt(v / c2) + ocfg.eps)
        return lr * (d + ocfg.weight_decay * x0 if ocfg.weight_decay else d)
    for p0, p, q, pm, pv, qm, qv in zip(*(tree_leaves(t) for t in (
            start["params"], plain1["params"], got1["params"],
            plain1["opt"]["m"], plain1["opt"]["v"], got1["opt"]["m"],
            got1["opt"]["v"]))):
        total += p.numel()
        diff = p != q
        if not diff.any():
            continue
        x0 = p0.float()[diff]
        a = proposal(x0, pm[diff], pv[diff])
        b = proposal(x0, qm[diff], qv[diff])
        n += int(diff.sum())
        near += int(((a - b).abs() <= 0.1 * a.abs()).sum())
    return n, near, total


def main() -> int:
    if not torch.cuda.is_available():
        print("split_arithmetic: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for arch, overrides, seed in MODELS:
        leaves(arch, overrides, seed, dev)
        torch.cuda.empty_cache()
    wholes = [fp32_leaves(arch, overrides, seed, dev)
              for arch, overrides, seed in MODELS + (
                  ("gemma-2b", dict(n_layers=2, use_flash=False), 6),)]
    flash, plain = wholes[1:]
    num = sum(float((a.double() - b.double()).square().sum())
              for a, b in zip(flash, plain))
    print(f"gemma-2b fp32, the whole step with kernel 9 against without "
          f"(attention in plain ops): {(num ** 0.5) / _norm(plain):.4e} "
          f"of the gradient's norm", flush=True)
    del wholes, flash, plain
    torch.cuda.empty_cache()
    steps(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
