"""The port's fault tolerance against the JAX package's, on the CPU:
the fault-injection harness (plan grammar, one-shot events, seeded
payloads), the health primitives (backoff, step monitor, watchdog), and
the continuous engine under chaos: poison quarantine at the decode step,
the staging handoff and the speculative verify, stalls, injected
failures, bounded admission, overload, in-flight shedding, watchdog
recovery with retries and backoff, and prefix-snapshot faults.

Each engine behaviour of ``tests/test_robustness.py`` (all but the
backend fallback ladder, which the port does not have: ``fail`` raises
``InjectedBackendError`` out of ``run()``, as the JAX engine does with
``backend_fallback=False``) is held to the JAX engine on the same weights
(the JAX params carried across with ``from_jax_params``), requests and
plan: the same requests ``poisoned``, ``ok``, ``shed_*`` or
``retry_exhausted``, the same tokens and the same robustness counters.
Healthy requests are also held to the port's own fault-free control run
(the blast radius).  Tolerance: tokens exact, counters exact (the port
runs its kernels' plain versions here).

The mamba2 model is the JAX suite's (d_model 32, fp32).  Quarantine and
watchdog recovery also run on the other three served families at their
reduced configs in fp32 (mamba-130m, recurrentgemma-2b with its 64-slot
attention ring wrapped, gemma-2b), one engine pair a family, reused
across their cases.
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma, mamba_130m as jmamba1, \
    recurrentgemma_2b as jrgemma
from repro.launch import trace_report as jtrace_report
from repro.models import ModelConfig as JModelConfig, build_model as jbuild
from repro.nn.params import init_params as jinit
from repro.runtime.elastic import backoff_delay_s as jbackoff
from repro.runtime.faults import FaultInjector as JInjector, \
    parse_plan as jparse_plan
from repro.runtime.health import StepMonitor as JStepMonitor
from repro.serve import ContinuousEngine as JContinuous, \
    ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.launch import trace_report
from repro_torch.models import ModelConfig, build_model
from repro_torch.nn.params import from_jax_params
from repro_torch.runtime import FAULT_KINDS, FaultEvent, FaultInjector, \
    InjectedBackendError, StepMonitor, Watchdog, backoff_delay_s, \
    parse_plan
from repro_torch.serve import ContinuousEngine, Request, Scheduler, \
    ServeConfig

V = 64
DIMS = dict(name="mamba2", family="mamba2", vocab_size=V, d_model=32,
            n_layers=2, d_state=8, ssm_head_dim=8, chunk_size=8,
            param_dtype="float32")
# The robustness counters compared with the JAX engine's.
COUNTERS = ("completed", "shed", "shed_reasons", "rejected", "quarantined",
            "retries", "watchdog_recoveries", "overload_entries",
            "overload_exits", "backend_fallbacks")


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX model, JAX params, port model, port params): one weight set
    (no test writes to it)."""
    jm = jbuild(JModelConfig(**DIMS))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(0), jnp.float32)
    tm = build_model(ModelConfig(**DIMS), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _prompts(seed, n, length):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, length).tolist() for _ in range(n)]


def _drive(eng, prompts, before_run=None):
    """Submit ``prompts`` and run; ``before_run(eng)`` runs in between.
    Returns {uid: request} (the engine is closed)."""
    for p in prompts:
        eng.submit(p)
    try:
        with torch.inference_mode():
            if before_run is not None:
                before_run(eng)
            done = eng.run()
    finally:
        eng.close()
    return {r.uid: r for r in done}


def _outcome(eng, done):
    """What is held to the JAX engine: statuses, tokens and counters."""
    m = eng.metrics.summary()
    return ({uid: r.status for uid, r in sorted(done.items())},
            {uid: list(r.out_tokens) for uid, r in sorted(done.items())},
            {k: m[k] for k in COUNTERS})


def _both(kw, prompts, before_run=None):
    """The port's and the JAX engine's run of one option set: (port
    engine, port requests), asserting that the outcomes are equal."""
    jm, jp, tm, tp = _pair()
    je = JContinuous(jm, jp, JServeConfig(**kw))
    jdone = _drive(je, prompts, before_run)
    te = ContinuousEngine(tm, tp, ServeConfig(**kw))
    tdone = _drive(te, prompts, before_run)
    assert _outcome(te, tdone) == _outcome(je, jdone)
    return te, tdone


def _control(kw, prompts):
    """The port's fault-free run: {uid: tokens}."""
    _, _, tm, tp = _pair()
    done = _drive(ContinuousEngine(tm, tp, ServeConfig(**kw)), prompts)
    return {uid: r.out_tokens for uid, r in done.items()}


# ---------------------------------------------------------------------------
# the fault-injection harness
# ---------------------------------------------------------------------------
def test_parse_plan_round_trip_matches_jax():
    spec = ("poison@5:slot=1,mode=inf; fail@8:program=decode;"
            "stall@3:stall_s=0.25;snap_drop@2;snap_corrupt@4:mode=inf")
    plan = parse_plan(spec)
    assert [ev.kind for ev in plan] == ["poison", "fail", "stall",
                                        "snap_drop", "snap_corrupt"]
    assert plan[0].poll == 5 and plan[0].slot == 1 and plan[0].mode == "inf"
    assert plan[1].program == "decode"
    assert plan[2].stall_s == 0.25
    assert [vars(ev) for ev in plan] == [vars(ev) for ev in jparse_plan(spec)]
    assert FAULT_KINDS == ("poison", "fail", "stall", "snap_drop",
                           "snap_corrupt")


@pytest.mark.parametrize("spec", ["boom@3", "poison@3:mode=zero",
                                  "poison5", "poison@3:volume=11"])
def test_parse_plan_rejects_bad_specs_as_jax(spec):
    with pytest.raises(ValueError) as got:
        parse_plan(spec)
    with pytest.raises(ValueError) as want:
        jparse_plan(spec)
    assert str(got.value) == str(want.value)


def test_injector_fires_once_and_reports():
    inj = FaultInjector("fail@2:program=decode;poison@4", seed=7)
    inj.pre_call("decode", 1)                       # not due yet
    with pytest.raises(InjectedBackendError):
        inj.pre_call("decode", 3)                   # due (poll >= 2)
    inj.pre_call("decode", 4)                       # fired: never again
    assert inj.poison_targets(3, [0, 1]) == []      # not due
    assert inj.poison_targets(4, []) == []          # waits for live slots
    assert inj.poison_targets(5, [1, 2]) == [(1, "nan")]
    assert inj.poison_targets(6, [1, 2]) == []      # fired
    assert inj.summary() == {"fired": {"poison": 1, "fail": 1},
                             "pending": {}, "events": 2}
    jinj = JInjector("fail@2:program=decode;poison@4", seed=7)
    with pytest.raises(RuntimeError):
        jinj.pre_call("decode", 3)
    jinj.poison_targets(5, [1, 2])
    assert inj.summary() == jinj.summary()
    with pytest.raises(TypeError):
        FaultInjector(["poison@1"])


def test_poison_payload_matches_jax_and_corrupt_keeps_dtypes():
    """A seed gives the JAX payloads, bit for bit, in the same order; the
    corruption lands in each floating leaf's dtype and device and leaves
    integer leaves alone."""
    for seed in (0, 3, 11):
        for mode in ("nan", "inf"):
            inj = FaultInjector([FaultEvent("poison", 0)], seed=seed)
            jinj = JInjector([], seed=seed)
            for shape in ((4, 8), (2, 1, 3), (1,)):
                got = inj.poison_payload(shape, mode)
                want = jinj.poison_payload(shape, mode)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)
    inj = FaultInjector([], seed=3)
    assert np.isnan(inj.poison_payload((4, 8), "nan")).any()
    assert np.isinf(inj.poison_payload((4, 8), "inf")).any()
    snap = {"f": torch.ones(2, 3), "h": torch.ones(2, 5,
                                                   dtype=torch.bfloat16),
            "i": torch.arange(4, dtype=torch.int32)}
    bad = FaultInjector([], seed=5).corrupt(snap, "nan")
    want = JInjector([], seed=5).corrupt(
        {"f": np.ones((2, 3), np.float32), "h": np.ones((2, 5), np.float32),
         "i": np.arange(4, dtype=np.int32)}, "nan")
    assert bad["f"].dtype == torch.float32 and not bad["f"].isfinite().all()
    assert bad["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bad["f"].numpy(), want["f"])
    np.testing.assert_array_equal(bad["h"].float().numpy(),
                                  torch.from_numpy(np.asarray(want["h"]))
                                  .bfloat16().float().numpy())
    assert bad["i"] is snap["i"]                    # ints untouched
    _, _, tm, _ = _pair()
    cache = tm.init_cache(2, 16, torch.float32)
    row = FaultInjector([], seed=1).corrupt(tm.export_state(cache, None, [1]))
    assert type(row) is type(cache)
    assert all(not leaf.isfinite().all() for leaf in row)


# ---------------------------------------------------------------------------
# health and backoff primitives
# ---------------------------------------------------------------------------
def test_backoff_delay_doubles_and_caps_as_jax():
    assert [backoff_delay_s(k, 0.5, cap_s=3.0) for k in (1, 2, 3, 4, 5)] \
        == [0.5, 1.0, 2.0, 3.0, 3.0]
    for k in (-1, 0, 1, 2, 7, 12):
        for base in (0.0, 0.25, 1.0):
            assert backoff_delay_s(k, base) == jbackoff(k, base)


@pytest.mark.parametrize("window,warmup", [(10, 3), (1, 1), (2, 1),
                                           (50, 3), (7, 7)])
def test_step_monitor_rolling_window_constant_memory(window, warmup):
    """The same straggler flags as JAX's monitor step by step (ties and
    even windows included) and the same summary, in constant memory."""
    mon = StepMonitor(window=window, warmup_steps=warmup)
    jmon = JStepMonitor(window=window, warmup_steps=warmup)
    rng = np.random.default_rng(2)
    xs = rng.lognormal(-5, 1, 300)
    xs[::3] = np.round(xs[::3], 3)          # ties
    for i, x in enumerate(xs):
        assert mon.observe(None, float(x)).straggler == \
            jmon.observe(None, float(x)).straggler, i
        if i % 37 == 0:
            assert mon.summary() == jmon.summary()
    assert len(mon.records) == window and len(mon._durations) == window
    assert mon.summary() == jmon.summary() and mon.summary()["steps"] == 300
    assert mon.records[-1].step == 299
    assert mon.straggler_steps == jmon.straggler_steps


def test_watchdog_latches_until_pet_and_engine_close_joins():
    fires = []
    wd = Watchdog(0.08, on_hang=lambda: fires.append(time.monotonic()))
    try:
        time.sleep(0.4)
        assert wd.fired and len(fires) == 1     # latched: no re-fire
        wd.pet()
        time.sleep(0.4)
        assert len(fires) == 2                  # a new hang after the pet
    finally:
        wd.stop()
    assert not wd.alive
    _, _, tm, tp = _pair()
    eng = ContinuousEngine(tm, tp, ServeConfig(
        max_batch=1, prefill_buckets=(16,), max_new_tokens=2,
        watchdog_s=5.0))
    thread = eng._watchdog
    assert thread.alive
    eng.close()
    eng.close()                                 # idempotent
    assert not thread.alive and eng._watchdog is None
    with pytest.raises(ValueError):
        ContinuousEngine(tm, tp, ServeConfig(watchdog_s=1.0,
                                             watchdog_action="panic"))
    with pytest.raises(ValueError):
        ContinuousEngine(tm, tp, ServeConfig(poison_probe="weights"))


def test_scheduler_defers_retry_backoff():
    sched = Scheduler("fcfs")
    req = Request(uid=1, prompt=[1], max_new_tokens=1, not_before_s=100.0)
    sched.submit(req)
    assert sched.pop_ready(now=50.0) is None
    assert len(sched) == 1                      # deferred, not dropped
    assert sched.pop_ready(now=150.0) is req


# ---------------------------------------------------------------------------
# poison quarantine
# ---------------------------------------------------------------------------
BASE = dict(max_batch=2, prefill_buckets=(16,), max_new_tokens=6)


@pytest.mark.parametrize("probe", ["logits", "state"])
@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunked"])
def test_poison_quarantine_healthy_rows_identical(probe, chunk):
    prompts = _prompts(3, 4, 12)
    base = dict(BASE, prefill_chunk=chunk)
    control = _control(base, prompts)
    eng, done = _both(dict(base, poison_probe=probe,
                           fault_plan="poison@3:slot=0"), prompts)
    poisoned = [r for r in done.values() if r.status == "poisoned"]
    healthy = [r for r in done.values() if r.status == "ok"]
    assert len(poisoned) == 1 and len(healthy) == 3
    for r in healthy:                    # blast radius: one slot, not four
        assert r.out_tokens == control[r.uid], f"uid={r.uid}"
    assert eng.metrics.quarantined == 1
    assert eng.metrics.shed_reasons == {"poison": 1}
    assert eng.metrics.poison_probes > 0
    assert eng._injector.summary()["fired"] == {"poison": 1}
    assert eng._slot_req == [None, None]
    assert all(s.trips == 0 for s in eng.sentinels.values())


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_probe_flags_exactly_the_bad_rows(value, dtype):
    """The ``state`` probe's per-row reduction: one non-finite element in
    any leaf flags its row and no other (NaN, +Inf and -Inf alike)."""
    _, _, tm, tp = _pair()
    eng = ContinuousEngine(tm, tp, ServeConfig(max_batch=4,
                                               poison_probe="state"))
    eng.pool.cache = type(eng.pool.cache)(*(
        torch.randn(leaf.shape).to(dtype) for leaf in eng.pool.cache))
    assert eng._state_finite().tolist() == [True] * 4
    for li, leaf in enumerate(eng.pool.cache):
        for row in (0, 2, 3):
            keep = leaf[:, row].clone()
            leaf[(leaf.shape[0] - 1, row) + tuple(
                n // 2 for n in leaf.shape[2:])] = value
            want = [i != row for i in range(4)]
            assert eng._state_finite().tolist() == want, (li, row)
            leaf[:, row] = keep
    assert eng._state_finite().tolist() == [True] * 4


def test_poison_check_every_skips_polls_as_jax():
    prompts = _prompts(3, 4, 12)
    eng, done = _both(dict(BASE, poison_probe="logits", poison_check_every=3,
                           fault_plan="poison@2:slot=1"), prompts)
    assert eng.metrics.quarantined == 1
    assert eng.metrics.poison_probes < eng.metrics.decode_steps


def test_poison_quarantine_not_counted_as_completion():
    eng, done = _both(dict(BASE, poison_probe="logits",
                           fault_plan="poison@2:slot=0"), _prompts(5, 2, 12))
    assert len(done) == 2                # the caller still sees the casualty
    assert eng.metrics.completed == 1
    assert sum(eng.metrics.shed_reasons.values()) == eng.metrics.shed


def _poison_staging(eng):
    """Corrupt staging row 0 after its first chunk call (the JAX engine's
    pools and the port's alike), so its last chunk's logits are
    non-finite."""
    eng.poll()
    assert eng._pref_req[0] is not None and eng._pref_off[0] == 8
    inj = FaultInjector([], seed=4) if isinstance(eng, ContinuousEngine) \
        else JInjector([], seed=4)
    eng._ppool.restore_row(0, inj.corrupt(eng._ppool.clone_row(0)))


@pytest.mark.parametrize("probe", ["logits", "state"])
def test_poisoned_staging_row_never_reaches_the_decode_pool(probe):
    """The staging -> decode handoff gate: a staged request whose
    first-token logits are non-finite is quarantined there; the others
    are served as in the control."""
    prompts = _prompts(7, 3, 16)
    base = dict(BASE, prefill_chunk=8)
    control = _control(base, prompts)
    eng, done = _both(dict(base, poison_probe=probe), prompts,
                      before_run=_poison_staging)
    assert done[1].status == "poisoned" and done[1].out_tokens == []
    assert [done[u].out_tokens for u in (2, 3)] == [control[2], control[3]]
    assert eng.metrics.quarantined == 1


def test_poison_in_a_speculative_burst_is_quarantined_at_verify():
    prompts = _prompts(9, 4, 12)
    base = dict(BASE, max_new_tokens=10, speculate_k=3)
    control = _control(base, prompts)
    eng, done = _both(dict(base, poison_probe="logits",
                           fault_plan="poison@3:slot=1"), prompts)
    assert [r.status for r in done.values()].count("poisoned") == 1
    for r in done.values():
        if r.status == "ok":
            assert r.out_tokens == control[r.uid]
    assert eng.metrics.spec_bursts > 0


# ---------------------------------------------------------------------------
# failures and stalls
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("program,kw", [
    ("decode", {}), ("prefill", {}), ("prefill_chunk", dict(prefill_chunk=8)),
    ("draft", dict(speculate_k=2)), ("verify", dict(speculate_k=2))])
def test_injected_failure_raises_out_of_run(program, kw):
    """No fallback: the injected failure leaves ``run()`` as
    InjectedBackendError, before the program launches anything."""
    _, _, tm, tp = _pair()
    eng = ContinuousEngine(tm, tp, ServeConfig(
        **BASE, **kw, fault_plan=f"fail@1:program={program}"))
    eng.submit(_prompts(9, 1, 12)[0])
    with pytest.raises(InjectedBackendError, match=program):
        eng.run()
    eng.close()
    assert eng._injector.summary()["fired"] == {"fail": 1}


def test_backend_failure_raises_as_jax_without_fallback():
    jm, jp, tm, tp = _pair()
    kw = dict(max_batch=1, prefill_buckets=(16,), max_new_tokens=4,
              fault_plan="fail@1:program=decode")
    prompt = _prompts(9, 1, 12)[0]
    for eng in (JContinuous(jm, jp, JServeConfig(**kw,
                                                 backend_fallback=False)),
                ContinuousEngine(tm, tp, ServeConfig(**kw))):
        eng.submit(prompt)
        with pytest.raises(RuntimeError) as err:
            eng.run()
        eng.close()
        assert type(err.value).__name__ == "InjectedBackendError"
        assert str(err.value) == "injected decode failure at poll 1"


def test_injected_stall_fires_inside_timing_window():
    prompts = _prompts(11, 2, 12)
    control = _control(BASE, prompts)
    eng, done = _both(dict(BASE, fault_plan="stall@3:program=decode,"
                                            "stall_s=0.05"), prompts)
    assert eng._injector.summary()["fired"] == {"stall": 1}
    assert eng.monitor_decode.max_s >= 0.05
    for uid, r in done.items():          # a stall delays, never corrupts
        assert r.out_tokens == control[uid]


# ---------------------------------------------------------------------------
# overload protection
# ---------------------------------------------------------------------------
def test_bounded_queue_rejects_with_backpressure():
    jm, jp, tm, tp = _pair()
    kw = dict(max_batch=1, prefill_buckets=(16,), max_new_tokens=3,
              max_queue_depth=2)
    prompts = _prompts(13, 4, 10)
    outs = []
    for eng in (JContinuous(jm, jp, JServeConfig(**kw)),
                ContinuousEngine(tm, tp, ServeConfig(**kw))):
        uids = [eng.submit(p) for p in prompts]
        done = eng.run()
        eng.close()
        outs.append((uids, eng.metrics.rejected,
                     {r.uid: r.out_tokens for r in done}))
    assert outs[1] == outs[0]
    uids, rejected, done = outs[1]
    assert uids[2] is None and uids[3] is None       # explicit refusal
    assert rejected == 2 and len(done) == 2


def test_wave_engine_rejects_past_the_queue_depth():
    from repro_torch.serve import Engine
    _, _, tm, tp = _pair()
    eng = Engine(tm, tp, ServeConfig(max_batch=1, prefill_buckets=(16,),
                                     max_new_tokens=2, max_queue_depth=1))
    assert eng.submit([1, 2]) == 1 and eng.submit([3]) is None
    assert eng.metrics.summary()["rejected"] == 1
    eng.close()


@pytest.mark.parametrize("kw", [
    dict(), dict(prefill_chunk=8, prefill_token_budget=64),
    dict(prefill_chunk=8, speculate_k=2)],
    ids=["monolithic", "chunked-budget", "speculative"])
def test_overload_mode_enters_and_clears(kw):
    prompts = _prompts(17, 5, 10)
    base = dict(max_batch=1, prefill_buckets=(16,), max_new_tokens=3, **kw)
    control = _control(base, prompts)
    eng, done = _both(dict(base, overload_queue_depth=2), prompts)
    assert eng.metrics.overload_entries >= 1
    assert eng.metrics.overload_exits == eng.metrics.overload_entries
    assert not eng._overloaded           # drained: hysteresis cleared it
    for uid, r in done.items():          # degraded mode sheds work rate,
        assert r.out_tokens == control[uid]          # never tokens


def test_overload_on_ttft_p95_as_jax():
    prompts = _prompts(19, 4, 10)
    eng, _ = _both(dict(max_batch=1, prefill_buckets=(16,),
                        max_new_tokens=3, overload_ttft_p95_s=1e-9),
                   prompts)
    assert eng.metrics.overload_entries >= 1


def _expire_tenant(eng):
    """Admit the first request, then move its deadline into the past."""
    eng.poll()
    (victim,) = [r for r in eng._slot_req if r is not None]
    victim.deadline_s = time.time() - 1.0


def _expire_staged(eng):
    """Stage the first request (its first chunk), then expire it."""
    eng.poll()
    victim = eng._pref_req[0]
    assert victim is not None
    victim.deadline_s = time.time() - 1.0


@pytest.mark.parametrize("chunk,expire", [(None, _expire_tenant),
                                          (8, _expire_staged)],
                         ids=["decoding", "staged"])
def test_shed_inflight_deadline(chunk, expire):
    far = time.time() + 3600
    prompts = _prompts(19, 2, 16)
    kw = dict(max_batch=1, prefill_buckets=(16,), max_new_tokens=20,
              prefill_chunk=chunk, shed_inflight=True)
    jm, jp, tm, tp = _pair()
    outs = []
    for eng in (JContinuous(jm, jp, JServeConfig(**kw)),
                ContinuousEngine(tm, tp, ServeConfig(**kw))):
        for p in prompts:
            eng.submit(p, deadline_s=far)
        with torch.inference_mode():
            expire(eng)
            done = eng.run()
        eng.close()
        outs.append((_outcome(eng, {r.uid: r for r in done}),
                     [r.uid for r in eng.expired]))
    assert outs[1] == outs[0]
    (status, toks, counters), expired = outs[1]
    assert status == {1: "shed_deadline", 2: "ok"} and expired == [1]
    assert counters["shed_reasons"] == {"deadline": 1}
    assert not eng.busy and len(toks[2]) == 20


def test_admission_overload_and_inflight_shed_scenario_as_jax():
    """Phase 4i (e)'s submissions at a small size: 12 requests at a queue
    bound of 10 (two rejected), degraded from a depth of 6 until it falls
    to 3 (the queue only drains: one entry, one exit), the first
    in-flight request's deadline moved into the past after the first
    poll (one in-flight shed); the JAX engine does the same."""
    prompts = _prompts(47, 12, 12)
    kw = dict(max_batch=4, prefill_buckets=(16,), max_new_tokens=6,
              prefill_chunk=8, max_queue_depth=10, overload_queue_depth=6,
              shed_inflight=True)
    control = _control(dict(max_batch=4, prefill_buckets=(16,),
                            max_new_tokens=6, prefill_chunk=8), prompts)
    jm, jp, tm, tp = _pair()
    outs = []
    for eng in (JContinuous(jm, jp, JServeConfig(**kw)),
                ContinuousEngine(tm, tp, ServeConfig(**kw))):
        uids = [eng.submit(p) for p in prompts]
        with torch.inference_mode():
            eng.poll()
            victim = next(r for r in eng._slot_req + eng._pref_req
                          if r is not None)
            victim.deadline_s = time.time() - 1.0
            done = {r.uid: r for r in eng.run()}
        eng.close()
        outs.append((uids, victim.uid, _outcome(eng, done)))
    assert outs[1] == outs[0]
    uids, victim, (status, toks, counters) = outs[1]
    assert uids == list(range(1, 11)) + [None, None]
    assert counters["rejected"] == 2
    assert counters["overload_entries"] == counters["overload_exits"] == 1
    assert counters["shed_reasons"] == {"deadline": 1}
    assert status[victim] == "shed_deadline"
    assert all(toks[u] == control[u] for u in status if status[u] == "ok")


# ---------------------------------------------------------------------------
# watchdog recovery and retries
# ---------------------------------------------------------------------------
def _hang_after_one_poll(eng):
    eng.poll()
    eng._on_hang()                       # what the watchdog thread does


@pytest.mark.parametrize("kw", [
    dict(max_batch=1, prefill_buckets=(16,), max_new_tokens=5),
    dict(max_batch=2, prefill_buckets=(16,), max_new_tokens=5,
         prefill_chunk=8)], ids=["monolithic", "chunked"])
def test_watchdog_recovery_requeues_and_replays_identically(kw):
    prompts = _prompts(23, 3, 12)
    control = _control(kw, prompts)
    eng, done = _both(dict(kw, watchdog_action="recover", max_retries=1),
                      prompts, before_run=_hang_after_one_poll)
    assert eng.metrics.watchdog_recoveries == 1
    assert eng.metrics.retries == sum(r.retries for r in done.values()) > 0
    assert eng.metrics.summary()["watchdog_fires"] == 1
    for r in done.values():              # keyed sampling: the replayed
        assert r.status == "ok"          # stream is the same
        assert r.out_tokens == control[r.uid]


def test_retry_budget_exhaustion_sheds():
    eng, done = _both(dict(max_batch=1, prefill_buckets=(16,),
                           max_new_tokens=5, watchdog_action="recover",
                           max_retries=0), _prompts(29, 1, 10),
                      before_run=_hang_after_one_poll)
    assert [r.status for r in done.values()] == ["retry_exhausted"]
    assert eng.metrics.shed_reasons == {"retry_exhausted": 1}
    assert sum(eng.metrics.shed_reasons.values()) == eng.metrics.shed
    assert not eng.busy


def test_retry_backoff_defers_readmission():
    _, _, tm, tp = _pair()
    eng = ContinuousEngine(tm, tp, ServeConfig(
        max_batch=1, prefill_buckets=(16,), max_new_tokens=4,
        watchdog_action="recover", max_retries=2, retry_backoff_s=30.0))
    eng.submit(_prompts(31, 1, 10)[0])
    with torch.inference_mode():
        eng.poll()
        eng._on_hang()
        eng.poll()                       # recovery requeues with backoff
    req = eng._scheduler.pop_ready(time.time())
    assert req is None                   # not_before_s is ~30 s out
    (queued,) = [r for _, r in eng._scheduler._heap]
    assert queued.retries == 1 and queued.out_tokens == []
    assert queued.not_before_s == pytest.approx(time.time() + 30.0, abs=5)
    eng.close()


# ---------------------------------------------------------------------------
# prefix-snapshot faults
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("probe", ["logits", "state"])
@pytest.mark.parametrize("fault", ["snap_corrupt", "snap_drop"])
def test_snapshot_fault_never_poisons_the_prefix_cache(fault, probe):
    jm, jp, tm, tp = _pair()
    prompt = _prompts(37, 1, 16)[0]
    base = dict(max_batch=1, prefill_buckets=(16,), max_new_tokens=4,
                prefill_chunk=8, prefix_cache_mb=4.0)
    control = _control(base, [prompt])
    outs = []
    for eng in (JContinuous(jm, jp, JServeConfig(
            **base, poison_probe=probe, fault_plan=f"{fault}@0")),
            ContinuousEngine(tm, tp, ServeConfig(
                **base, poison_probe=probe, fault_plan=f"{fault}@0"))):
        with torch.inference_mode():
            eng.submit(prompt)
            (first,) = eng.run()
            # The faulted insert (dropped, or corrupt and refused) left
            # no node, so no NaN node a later request could restore.
            nodes0 = eng.prefix_cache.stats()["nodes"]
            eng.submit(prompt)                   # the same prompt: a miss
            (second,) = eng.run()
        eng.close()
        s = eng.prefix_cache.stats()
        outs.append((nodes0, first.out_tokens, second.out_tokens, s["hits"],
                     s["nodes"]))
    assert outs[1] == outs[0]
    nodes0, first, second, hits, nodes = outs[1]
    assert nodes0 == 0 and hits == 0 and nodes > 0
    assert first == control[1] and second == control[1]
    cache = eng.prefix_cache
    for node in cache.root.children.values():
        assert all(leaf.isfinite().all() for leaf in node.snapshot)


# ---------------------------------------------------------------------------
# fault instants in the trace report
# ---------------------------------------------------------------------------
def test_trace_report_tallies_fault_events_as_jax(tmp_path):
    kw = dict(BASE, poison_probe="logits", trace=True, max_queue_depth=3,
              fault_plan="poison@3:slot=0")
    jm, jp, tm, tp = _pair()
    reps = []
    for eng in (JContinuous(jm, jp, JServeConfig(**kw)),
                ContinuousEngine(tm, tp, ServeConfig(**kw))):
        with torch.inference_mode():
            for p in _prompts(41, 4, 12):
                eng.submit(p)
            eng.run()
        eng.close()
        path = tmp_path / f"{type(eng).__module__}.jsonl"
        eng.tracer.save_jsonl(str(path))
        mod = trace_report if isinstance(eng, ContinuousEngine) \
            else jtrace_report
        rep = mod.analyze(mod.load_events(str(path)))
        assert mod.check(rep) == []
        reps.append(rep["fault_events"])
    assert reps[1] == reps[0] == {"quarantine": 1, "reject": 1}


# ---------------------------------------------------------------------------
# the other three served families: quarantine and watchdog recovery
# ---------------------------------------------------------------------------
FAMILIES = {"mamba-130m": jmamba1, "recurrentgemma-2b": jrgemma,
            "gemma-2b": jgemma}
# recurrentgemma's reduced window is 64: at 64 + 8 positions its attention
# layers' caches are rings, and the prompts below wrap them.
FAMILY_SERVE = dict(max_batch=2, prefill_buckets=(64,), max_new_tokens=8,
                    poison_probe="logits", watchdog_action="recover",
                    max_retries=1)
FAMILY_LENGTHS = (20, 60, 33, 64)


@functools.lru_cache(maxsize=None)
def _family_engines(arch):
    """One JAX and one port engine of ``arch``'s reduced config (fp32),
    on one weight set, and the port's fault-free tokens (by submission
    order) from its first run."""
    jm = jbuild(FAMILIES[arch].REDUCED.replace(param_dtype="float32"))
    jp = jinit(jm.param_specs(), jax.random.PRNGKey(0), jnp.float32)
    tcfg = get_config(arch, reduced=True, param_dtype="float32")
    tm = build_model(tcfg, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    je = JContinuous(jm, jp, JServeConfig(**FAMILY_SERVE))
    te = ContinuousEngine(tm, tp, ServeConfig(**FAMILY_SERVE))
    rng = np.random.default_rng(43)
    prompts = [rng.integers(1, tcfg.vocab_size, n).tolist()
               for n in FAMILY_LENGTHS]
    control = [r.out_tokens for r in _family_run(te, prompts)]
    return je, te, prompts, control


def _family_run(eng, prompts, plan=None, hang=False):
    """One run on a reused engine: stats reset, ``plan`` armed; returns
    the requests in submission order."""
    eng.reset_stats()
    eng.set_fault_plan(plan)
    first = [eng.submit(p) for p in prompts][0]
    with torch.inference_mode():
        if hang:
            _hang_after_one_poll(eng)
        done = eng.run()
    return [r for r in sorted(done, key=lambda r: r.uid)
            if r.uid >= first]


@pytest.mark.parametrize("case", ["quarantine", "recover"])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_quarantine_and_recovery_match_jax(arch, case):
    """Quarantine and requeue reset rows of every cache layout (Mamba-1
    state, RG-LRU state and a wrapped KV ring, a linear KV cache): the
    healthy requests' tokens equal the fault-free run's, and statuses,
    tokens and counters the JAX engine's."""
    je, te, prompts, control = _family_engines(arch)
    outs = []
    for eng in (je, te):
        if case == "quarantine":
            reqs = _family_run(eng, prompts,
                               plan=f"poison@{eng.poll_index + 3}:slot=1")
        else:
            reqs = _family_run(eng, prompts, hang=True)
        m = eng.metrics.summary()
        outs.append(([r.status for r in reqs], [r.out_tokens for r in reqs],
                     {k: m[k] for k in COUNTERS}))
    assert outs[1] == outs[0]
    statuses, tokens, counters = outs[1]
    if case == "quarantine":
        assert statuses.count("poisoned") == 1
        assert counters["quarantined"] == 1
    else:
        assert statuses == ["ok"] * len(prompts)
        assert counters["watchdog_recoveries"] == 1
        assert counters["retries"] == 2
    for st, got, want in zip(statuses, tokens, control):
        if st == "ok":
            assert got == want
    assert all(s.trips == 0 for s in te.sentinels.values())
