"""The port's fault injection and supervised retry
(bigdl_tpu_torch.resilience) against the JAX package's, on the CPU: the
plan grammar (spec strings and JSON files, and its errors), the fault
schedules and the visits an injector fires at for seeded probabilistic
rules, the event log, the corruption of a written artifact,
``RetryPolicy``'s backoff and a ``Supervisor``'s events under an
injected clock, ``supervise_command``; and the serving sites:
``dispatch@request:2`` answers the 2nd request 503, ``worker_kill@infer:1``
kills the batcher's worker thread (that request 500) and the watchdog's
fast-fail path answers the next 503."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from bigdl_tpu.resilience import faults as jf
from bigdl_tpu.resilience import supervisor as js
from bigdl_tpu_torch.obs import metrics as pmetrics
from bigdl_tpu_torch.resilience import faults as pf
from bigdl_tpu_torch.resilience import supervisor as ps
from bigdl_tpu_torch.serving import (InferenceEngine, MetricsRegistry,
                                     MicroBatcher, ServingApp, Watchdog)

SPECS = ["preempt@step:7", "dispatch@step:p0.1;stall@step:4:0.25;seed=3",
         "corrupt@ckpt_save:2;io@ckpt_restore:1,3;seed=5",
         "worker_kill@infer:1", "dispatch@request:2",
         "kill_device@step:2:1;preempt_soft@data:p0.5",
         "worker_kill@worker_boot:1;seed=0", " ; dispatch@request:1,2 ;"]
BAD = ["nosuchkind@step:1", "dispatch@nosuchsite:1", "dispatch@step",
       "dispatch", "dispatch@step:x", "dispatch@step:pX", "seed=x"]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    jf.clear_plan()
    pf.clear_plan()
    yield
    jf.clear_plan()
    pf.clear_plan()


def _rules(plan):
    return [(r.kind, r.site, r.at, r.rate, r.arg) for r in plan.rules]


def test_constants_match_jax():
    assert pf.FAULT_SITES == jf.FAULT_SITES
    assert pf.FAULT_KINDS == jf.FAULT_KINDS
    assert pf.PREEMPT_RC == jf.PREEMPT_RC == 75
    assert pf.WorkerKillFault.worker_fatal is True
    assert ps.RETRYABLE_EXCEPTIONS[:2] == (pf.TransientFault,
                                          pf.SimulatedPreemption)
    from bigdl_tpu_torch.utils.file import ChecksumError
    assert ChecksumError is pf.ChecksumError


@pytest.mark.parametrize("spec", SPECS)
def test_parse_plan_matches_jax(spec):
    j, p = jf.parse_plan(spec), pf.parse_plan(spec)
    assert repr(p) == repr(j) and p.seed == j.seed
    assert _rules(p) == _rules(j)
    for site in pf.FAULT_SITES:
        assert p.schedule(site, 60) == j.schedule(site, 60)


def test_parse_plan_errors_match_jax():
    for spec in BAD:
        with pytest.raises(ValueError) as je:
            jf.parse_plan(spec)
        with pytest.raises(ValueError) as pe:
            pf.parse_plan(spec)
        assert str(pe.value) == str(je.value), spec
    for kw in (dict(kind="x", site="step", at=[1]),
               dict(kind="io", site="x", at=[1]),
               dict(kind="io", site="step"),
               dict(kind="io", site="step", at=[1], rate=0.5)):
        with pytest.raises(ValueError) as je:
            jf.FaultRule(**kw)
        with pytest.raises(ValueError) as pe:
            pf.FaultRule(**kw)
        assert str(pe.value) == str(je.value)


def test_parse_plan_json_file_matches_jax(tmp_path):
    f = tmp_path / "plan.json"
    f.write_text(json.dumps({"seed": 3, "rules": [
        {"kind": "dispatch", "site": "request", "at": [2, 5]},
        {"kind": "stall", "site": "infer", "rate": 0.5, "arg": "0.01"},
        {"kind": "worker_kill", "site": "worker_boot", "at": [1]}]}))
    j, p = jf.parse_plan(str(f)), pf.parse_plan(str(f))
    assert repr(p) == repr(j) and _rules(p) == _rules(j)
    f.write_text(json.dumps({"rules": [{"kind": "nope", "site": "step",
                                        "at": [1]}]}))
    with pytest.raises(ValueError) as je:
        jf.parse_plan(str(f))
    with pytest.raises(ValueError) as pe:
        pf.parse_plan(str(f))
    assert str(pe.value) == str(je.value)


def _fired(mod, spec, site, visits):
    """(visit, kind) of every fault an injector fires over ``visits``
    visits (stalls recorded, not slept; exits recorded)."""
    exits, sleeps = [], []
    inj = mod.FaultInjector(mod.parse_plan(spec), sleep=sleeps.append,
                            exit_fn=exits.append)
    for _ in range(visits):
        try:
            inj.fire(site)
        except (mod.TransientFault, mod.SimulatedPreemption, OSError,
                mod.WorkerKillFault):
            pass
    return [(e["visit"], e["fault"], e["action"]) for e in inj.events], \
        exits, sleeps


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_probabilistic_rules_fire_at_the_jax_visits(seed):
    for spec, site in ((f"dispatch@request:p0.2;seed={seed}", "request"),
                       (f"worker_kill@infer:p0.05;stall@infer:p0.1:0.5;"
                        f"seed={seed}", "infer"),
                       (f"preempt@step:p0.03;io@step:p0.1;seed={seed}",
                        "step")):
        got = _fired(pf, spec, site, 300)
        assert got == _fired(jf, spec, site, 300)
        assert got[0]  # the rates do fire
    assert pf._u01(seed, "backoff", 3) == jf._u01(seed, "backoff", 3)


def test_event_log_and_corruption_match_jax(tmp_path):
    logs = {}
    for name, mod in (("jax", jf), ("port", pf)):
        log = tmp_path / f"{name}.jsonl"
        mod.install_plan(mod.parse_plan("io@ckpt_save:1;corrupt@ckpt_save:"
                                        "2;seed=4"), log_path=str(log))
        with pytest.raises(OSError):
            mod.hook("ckpt_save")
        (tmp_path / name).mkdir()
        blob = tmp_path / name / "model.1"  # the offset hashes the name
        blob.write_bytes(bytes(range(256)) * 8)
        mod.hook("ckpt_save")
        mod.post_write_hook("ckpt_save", str(blob))
        logs[name] = (log.read_text().replace(str(blob), "B"),
                      blob.read_bytes(), mod.injected_events())
        mod.clear_plan()
        assert mod.injected_events() == []
    assert logs["port"][:2] == logs["jax"][:2]
    assert logs["port"][1] != bytes(range(256)) * 8
    assert json.dumps(logs["port"][2]).replace("port", "x") == \
        json.dumps(logs["jax"][2]).replace("jax", "x")


def test_fault_counter_lands_in_the_process_registry():
    reg = pmetrics.MetricsRegistry(namespace="bigdl_serving")
    pmetrics.set_registry(reg)
    try:
        pf.install_plan(pf.parse_plan("dispatch@request:1,2"))
        for _ in range(2):
            with pytest.raises(pf.TransientFault):
                pf.hook("request")
        assert reg.counter("faults_injected_total").value == 2
        assert "bigdl_serving_faults_injected_total 2" in reg.render()
    finally:
        pmetrics.reset_registry()


def test_kill_device_counts_cuda_indices():
    """A stated difference: the roster is CUDA device indices. With no
    card the roster is empty and a kill marks nothing."""
    assert pf.healthy_devices() == list(range(torch.cuda.device_count()))
    pf.install_plan(pf.parse_plan("kill_device@step:1"))
    with pytest.raises(pf.DeviceLossFault):
        pf.hook("step")
    pf.clear_plan()
    assert pf.lost_device_ids() == set()


# ---------------------------------------------------------- retry policy
def test_retry_policy_backoff_matches_jax():
    for kw in (dict(), dict(budget=8, base_s=0.25, multiplier=2.0,
                            max_s=10.0, jitter=0.5, seed=0),
               dict(base_s=0.1, seed=11), dict(jitter=0.0, max_s=1.0)):
        j, p = js.RetryPolicy(**kw), ps.RetryPolicy(**kw)
        assert [p.delay(a) for a in range(1, 12)] == \
            [j.delay(a) for a in range(1, 12)]
    with pytest.raises(ValueError) as je:
        js.RetryPolicy(budget=-1)
    with pytest.raises(ValueError) as pe:
        ps.RetryPolicy(budget=-1)
    assert str(pe.value) == str(je.value)


def _supervise(mod, fmod, n_faults, budget):
    sleeps, t = [], [0.0]

    def clock():
        t[0] += 0.125
        return t[0]

    sup = mod.Supervisor(mod.RetryPolicy(budget=budget, base_s=0.1, seed=2),
                         clock=clock, sleep=sleeps.append)
    calls = [0]

    def attempt(n):
        calls[0] += 1
        if calls[0] <= n_faults:
            raise (fmod.TransientFault if calls[0] % 2 else OSError)(
                f"boom {calls[0]}")
        return n

    try:
        out = sup.run(attempt)
    except mod.SupervisorGaveUp as e:
        out = ("gave up", str(e), e.events)
    return out, sleeps, sup.annotation()


@pytest.mark.parametrize("n_faults,budget", [(0, 3), (2, 5), (4, 3)])
def test_supervisor_under_an_injected_clock_matches_jax(n_faults, budget):
    assert _supervise(ps, pf, n_faults, budget) == \
        _supervise(js, jf, n_faults, budget)


def test_supervise_command_restarts_on_preempt_rc(tmp_path):
    marker = tmp_path / "n"
    code = (f"import os,sys; p={str(marker)!r}; n=int(open(p).read()) if "
            f"os.path.exists(p) else 0; open(p,'w').write(str(n+1)); "
            f"sys.exit(75 if n < 2 else 0)")
    sleeps = []
    rc, events = ps.supervise_command(
        lambda i: [sys.executable, "-c", code],
        policy=ps.RetryPolicy(budget=3, base_s=0.01, seed=0),
        sleep=sleeps.append)
    assert rc == 0 and marker.read_text() == "3"
    assert [e["event"] for e in events] == ["process_exit", "restart",
                                            "process_exit", "restart",
                                            "recovered"]
    pol = js.RetryPolicy(budget=3, base_s=0.01, seed=0)
    assert sleeps == [pol.delay(1), pol.delay(2)]


# ---------------------------------------------------- the serving sites
def _app(plan, batcher=True):
    reg = MetricsRegistry()
    eng = InferenceEngine(torch.nn.Linear(4, 3), buckets=(1, 2),
                          metrics=reg, device="cpu")
    bat = MicroBatcher(eng.predict_scores, max_wait_ms=1.0, metrics=reg) \
        if batcher else None
    wd = Watchdog(stall_timeout_s=5.0, metrics=reg)
    if bat is not None:
        wd.watch("batcher", bat)
    app = ServingApp(name="t", metrics=reg, engine=eng, batcher=bat,
                     watchdog=wd)
    pf.install_plan(pf.parse_plan(plan))
    return app, reg


ROWS = {"inputs": np.ones((2, 4), np.float32).tolist()}


def test_dispatch_at_request_2_answers_503_then_recovers():
    app, reg = _app("dispatch@request:2")
    try:
        got = [app.dispatch_post("/predict", ROWS) for _ in range(3)]
        assert [s for s, _ in got] == [200, 503, 200]
        assert got[1][1]["error"].startswith("injected fault: injected "
                                             "transient dispatch failure "
                                             "at request visit 2")
        assert reg.counter("faults_injected_requests_total").value == 1
        assert reg.counter("request_errors_total").value == 1
        assert pf.injected_events() == [
            {"fault": "dispatch", "site": "request", "visit": 2,
             "action": "raise TransientFault"}]
    finally:
        app.close()


def test_worker_kill_at_infer_1_takes_the_fast_fail_path():
    import time
    app, reg = _app("worker_kill@infer:1")
    try:
        st, body = app.dispatch_post("/predict", ROWS)
        assert st == 500 and "WorkerKillFault" in body["error"]
        t0 = time.monotonic()
        st, body = app.dispatch_post("/predict", ROWS)
        assert st == 503 and time.monotonic() - t0 < 1.0
        assert "micro-batcher worker is dead" in body["error"]
        assert app.watchdog.check() == {"batcher": "dead"}
        assert app.handle_readyz()[0] == 503
        assert app.handle_healthz()[0] == 200
        assert reg.counter("requests_worker_dead_total").value == 1
        assert reg.counter("watchdog_failures_total").value == 1
    finally:
        app.close()


def test_serve_cli_installs_the_plan():
    from bigdl_tpu_torch.cli import common
    from bigdl_tpu_torch.cli import serve as serve_cli
    args = serve_cli.build_parser().parse_args(
        ["transformer_lm", "--faultPlan", "dispatch@request:2"])
    inj = common.install_fault_plan(args)
    assert pf.active() is inj
    assert repr(inj.plan) == "dispatch@request:2;seed=0"
    bad = serve_cli.build_parser().parse_args(
        ["transformer_lm", "--faultPlan", "dispatch@nowhere:1"])
    with pytest.raises(SystemExit, match="--faultPlan: bad --faultPlan "
                                         "entry .*unknown fault site"):
        common.install_fault_plan(bad)
    assert common.install_fault_plan(serve_cli.build_parser().parse_args(
        ["transformer_lm"])) is None
    os.environ.pop("BIGDL_FAULT_LOG", None)
