"""Elastic data parallelism in the port (bigdl_tpu_torch.resilience.elastic,
the re-formed mesh of parallel.mesh, cli.common.run_optimize) against the
JAX package's on the CPU:

* ``hold`` and ``scale`` against JAX ``ElasticDataParallel._fit_rows`` on
  the same arrays, bit for bit, and the rows each rank then takes;
* the supervisor's reshape ledger and metrics, a give-up below
  ``--minDevices``, no reshape without a loss, the bucket bound resolved
  per rank count;
* ``run_optimize --elastic hold`` at 4 gloo ranks (a spawned job,
  tests/torch_elastic_cases.py) losing a rank before step 5 against JAX
  ``run_optimize`` on 4 -> 3 CPU devices, on converted parameters: the
  losses agree within 1e-5 before the loss and 1e-4 after it; the lost
  rank leaves with exit code 0, and the same loss under ``--minDevices 4``
  gives up on every rank with the JAX ``elastic:`` message;
* ``--supervise``, ``--faultPlan``, ``--elastic`` and ``--minDevices`` are
  parsed by every training CLI and by cli.perf, with the JAX error
  messages.
"""

import argparse
import importlib
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_elastic_cases as C
from bigdl_tpu import nn as jnn
from bigdl_tpu.cli import common as jcommon
from bigdl_tpu.dataset.dataset import BatchDataSet as JBatchDataSet
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.parallel.mesh import make_mesh as jmake_mesh
from bigdl_tpu.resilience import elastic as je
from bigdl_tpu.resilience import faults as jf
from bigdl_tpu_torch.cli import common
from bigdl_tpu_torch.interop import tensors_from_jax
from bigdl_tpu_torch.obs import metrics as pmetrics
from bigdl_tpu_torch.parallel.launch import spawn
from bigdl_tpu_torch.parallel.mesh import Mesh
from bigdl_tpu_torch.resilience import RetryPolicy, SupervisorGaveUp
from bigdl_tpu_torch.resilience import elastic as pe
from bigdl_tpu_torch.resilience import faults as pf

BEFORE_ATOL = 1e-5  # the same 4-rank steps, f32
AFTER_ATOL = 1e-4   # 3 ranks, after a resume: sums in other orders
JOB_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _clean_faults():
    jf.clear_plan()
    pf.clear_plan()
    yield
    jf.clear_plan()
    pf.clear_plan()


def _pmesh(k, rank=0):
    return Mesh("data", k, rank)


def _jmesh(k):
    return jmake_mesh({"data": k}, devices=jax.devices()[:k])


# ------------------------------------------------- the batch policies
@pytest.mark.parametrize("policy,n,rows", [
    ("hold", 7, 16), ("scale", 7, 16), ("hold", 3, 128), ("scale", 3, 128),
    ("hold", 4, 16), ("scale", 4, 16)])
def test_policies_match_jax_fit_rows(policy, n, rows):
    """The port's padding or trimming equals JAX's on the same arrays, bit
    for bit, as numpy arrays and as tensors; each rank's rows are the
    fitted global batch's contiguous part (the JAX device's at its
    place); both are the identity when the batch divides."""
    x = np.random.RandomState(n).randn(rows, 3).astype(np.float32)
    y = np.arange(rows, dtype=np.int32)
    want_x = je.ElasticDataParallel(_jmesh(n), batch_policy=policy) \
        ._fit_rows(x)
    want_y = je.ElasticDataParallel(_jmesh(n), batch_policy=policy) \
        ._fit_rows(y)
    dp = pe.ElasticDataParallel(_pmesh(n), batch_policy=policy)
    np.testing.assert_array_equal(dp._fit_rows(x), want_x)
    assert torch.equal(dp._fit_rows(torch.from_numpy(x)),
                       torch.from_numpy(want_x))
    if rows % n == 0:
        assert dp._fit_rows(x) is x
    per = len(want_x) // n
    for r in range(n):
        xs, ys = pe.ElasticDataParallel(
            _pmesh(n, r), batch_policy=policy).shard_batch(x, y)
        np.testing.assert_array_equal(xs, want_x[r * per:(r + 1) * per])
        np.testing.assert_array_equal(ys, want_y[r * per:(r + 1) * per])


def test_scale_refuses_fewer_rows_than_ranks_and_bad_policies():
    with pytest.raises(ValueError, match="fewer rows than devices"):
        pe.ElasticDataParallel(_pmesh(7), batch_policy="scale")._fit_rows(
            np.zeros((3, 1)))
    for make in (lambda: pe.ElasticDataParallel(_pmesh(4),
                                                batch_policy="stretch"),
                 lambda: pe.ElasticSupervisor(batch_policy="stretch"),
                 lambda: pe.ElasticSupervisor(min_devices=0)):
        with pytest.raises(ValueError):
            make()
    assert pe.ELASTIC_POLICIES == je.ELASTIC_POLICIES


# ------------------------------------------------ the elastic supervisor
def test_supervisor_reshape_ledger_and_metrics(monkeypatch):
    """The JAX test's protocol on a roster of 8 (the devices of a process
    without a group, patched): a loss at visit 2 re-forms at 7, one
    reshape event with the JAX fields, the shared registry's counter and
    gauge; the same plan in the JAX supervisor gives the same ledger."""
    monkeypatch.setattr(pf, "_device_ids", lambda: list(range(8)))
    reg = pmetrics.get_registry()
    before = reg.counter("elastic_reshapes_total", "").value
    ledgers = []
    for mod, faults in ((pe, pf), (je, jf)):
        sup = mod.ElasticSupervisor(
            mod.RetryPolicy(budget=3, base_s=0.0, max_s=0.0),
            min_devices=4)
        faults.install_plan(faults.parse_plan("kill_device@step:2:1"))
        seen = []

        def attempt(n):
            devs = sup.probe()
            sup.observe_topology(len(devs), bucket_bytes=1024 * (8 - n),
                                 restore_ms=12.5 if n else None)
            seen.append(len(devs))
            faults.hook("step")
            faults.hook("step")  # visit 2 on attempt 0: device loss
            return "done"

        assert sup.run(attempt) == "done"
        assert seen == [8, 7]
        ann = sup.reshape_annotation()
        assert ann["count"] == 1 and "event" not in ann
        assert sup.annotation()["reshapes"] == 1
        ledgers.append(sup.reshapes)
        faults.clear_plan()
    assert ledgers[0] == ledgers[1]
    ev = ledgers[0][0]
    assert (ev["from_devices"], ev["to_devices"]) == (8, 7)
    assert (ev["restore_ms"], ev["bucket_bytes_before"],
            ev["bucket_bytes_after"]) == (12.5, 8192, 7168)
    assert reg.counter("elastic_reshapes_total", "").value == before + 1
    assert reg.gauge("elastic_devices", "").value == 7


def test_supervisor_gives_up_below_min_devices(monkeypatch):
    monkeypatch.setattr(pf, "_device_ids", lambda: list(range(8)))
    sup = pe.ElasticSupervisor(RetryPolicy(budget=5, base_s=0.0, max_s=0.0),
                               min_devices=6)
    pf.install_plan(pf.parse_plan("kill_device@step:1:4"))

    def attempt(n):
        sup.probe()
        pf.hook("step")
        return "done"

    with pytest.raises(SupervisorGaveUp) as ei:
        sup.run(attempt)
    assert "minDevices" in str(ei.value)
    assert sup.annotation()["retries"] < 5


def test_no_reshape_event_without_device_loss():
    sup = pe.ElasticSupervisor(min_devices=1)
    sup.observe_topology(8)
    sup.observe_topology(8)
    assert sup.reshapes == [] and sup.reshape_annotation() is None


def test_bucket_bound_reresolved_per_device_count(tmp_path, monkeypatch):
    """The tuner's grad_comm key holds n_devices: after a reshape the
    bound is the new count's own decision (a miss: the default), and an
    explicit --gradBuckets wins at any count."""
    from bigdl_tpu_torch import tuning
    from bigdl_tpu_torch.parallel.grad_comm import (GradCommConfig,
                                                    _resolve_bucket_bytes)
    monkeypatch.setenv("BIGDL_TPU_AUTOTUNE_CACHE", str(tmp_path))
    param_bytes = 32 * 2 ** 20
    try:
        tuning.reset()
        tuning.set_mode("cached")
        cache = tuning.get_cache()
        for n, mib in ((4, 8), (3, 2)):
            cache.put(tuning.make_key("grad_comm", param_mib=32,
                                      n_devices=n, dtype="bfloat16"),
                      {"config": {"bucket_bytes": mib * 2 ** 20},
                       "source": "measured"})
        cfg = GradCommConfig(compress="bf16")
        assert _resolve_bucket_bytes(cfg, param_bytes, 4) == \
            (8 * 2 ** 20, "autotune")
        assert _resolve_bucket_bytes(cfg, param_bytes, 3) == \
            (2 * 2 ** 20, "autotune")
        assert _resolve_bucket_bytes(cfg, param_bytes, 2)[0] == 4 * 2 ** 20
        explicit = GradCommConfig(compress="bf16", bucket_bytes=2 ** 20)
        assert _resolve_bucket_bytes(explicit, param_bytes, 3) == \
            (2 ** 20, "explicit")
    finally:
        tuning.reset()


# ----------------------------------------- run_optimize at 4 -> 3 ranks
def _jax_rows(d):
    out = {}
    with open(os.path.join(d, "train.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out[r["iteration"]] = r["loss"]
    return out


def test_run_optimize_elastic_matches_jax_four_to_three(tmp_path):
    """The port at 4 gloo ranks and JAX on 4 CPU devices, both losing the
    last before step 5 under --elastic hold (checkpoints every 3): both
    re-form at 3, resume iteration 3, pad the 16-row batch to 18, and
    their losses agree step by step. Under --minDevices 4 the same loss
    gives up on every rank with the JAX elastic: message; the lost rank
    leaves the job with exit code 0."""
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 3),
                        jnn.LogSoftMax())
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(5)))
    tensors = tensors_from_jax(C.model(), params)
    np.savez(tmp_path / "inputs.npz",
             **{f"p/{k}": v.numpy() for k, v in tensors.items()})
    res = spawn("torch_elastic_cases:run_all", 4,
                {"inputs": str(tmp_path / "inputs.npz"),
                 "dir": str(tmp_path)}, timeout_s=JOB_TIMEOUT_S,
                backend="gloo",
                env={"PYTHONPATH": C.__file__.rsplit("/", 1)[0]})

    x, y = C.data()
    ck = str(tmp_path / "jck")

    def make():
        devs = jf.healthy_devices()
        strat = je.ElasticDataParallel(
            jmake_mesh({"data": len(devs)}, devices=devs),
            batch_policy="hold")
        opt = JOptimizer(jm, JBatchDataSet(x, y, 16, shuffle=False),
                         jnn.ClassNLLCriterion(),
                         optim_method=JSGD(learning_rate=0.1),
                         end_when=JTrigger.max_iteration(C.ITERS), seed=7,
                         log_every=1, strategy=strat)
        opt.set_state(params=jax.tree_util.tree_map(jnp.asarray, params))
        opt.set_checkpoint(JTrigger.several_iteration(3), ck)
        opt.set_summary(str(tmp_path / "jsum"))
        return opt

    jf.install_plan(jf.parse_plan("kill_device@step:5:1"))
    jf._LOST_DEVICE_IDS.update(d.id for d in jax.devices()[4:])
    jcommon.run_optimize(make, SimpleNamespace(
        supervise=None, elastic="hold", minDevices=2, checkpoint=ck,
        seed=7))
    assert len(jf.healthy_devices()) == 3
    jl = _jax_rows(tmp_path / "jsum")

    assert res[3] is None  # the lost rank left with exit code 0
    for r in range(3):
        got = res[r]
        assert got["gave_up"].startswith("elastic: 3 healthy device(s) < "
                                         "--minDevices 4")
        assert got["healthy"] == [0, 1, 2]
        (ev,) = got["reshapes"]
        assert (ev["from_devices"], ev["to_devices"]) == (4, 3)
        assert ev["restore_ms"] is not None and ev["restore_ms"] >= 0
        assert ev["bucket_bytes_before"] == ev["bucket_bytes_after"] \
            == 4 * 2 ** 20
        assert [(e["site"], e["visit"], e["fault"]) for e in got["events"]] \
            == [("step", 5, "kill_device")]
        pl = {int(k): v for k, v in got["losses"].items()}
        assert sorted(pl) == sorted(jl) == list(range(1, C.ITERS + 1))
        np.testing.assert_allclose([pl[i] for i in (1, 2, 3)],
                                   [jl[i] for i in (1, 2, 3)], rtol=0,
                                   atol=BEFORE_ATOL)
        after = range(4, C.ITERS + 1)
        np.testing.assert_allclose([pl[i] for i in after],
                                   [jl[i] for i in after], rtol=0,
                                   atol=AFTER_ATOL)
        assert got["params"] == res[0]["params"]


# -------------------------------------------------------- the CLI flags
class _Parsed(Exception):
    pass


@pytest.mark.parametrize("cli", ["resnet", "vgg", "lenet", "inception",
                                 "transformerlm", "rnn",
                                 "textclassification", "autoencoder",
                                 "perf"])
def test_training_clis_take_the_resilience_flags(cli, monkeypatch, tmp_path):
    """Every training CLI and cli.perf parse --supervise [BUDGET],
    --faultPlan, --elastic {hold,scale} and --minDevices with the JAX
    defaults (the parse is stopped right after), and refuse an unknown
    --elastic policy as argparse does."""
    mod = importlib.import_module(f"bigdl_tpu_torch.cli.{cli}")
    known = argparse.ArgumentParser.parse_known_args

    def stop(self, *a, **kw):
        ns = known(self, *a, **kw)
        raise _Parsed(ns[0] if isinstance(ns, tuple) else ns)

    head = [] if cli in ("perf", "textclassification") else ["train"]
    head += ["-f", str(tmp_path)] if cli != "perf" else []
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_known_args", stop)
        m.setattr(argparse.ArgumentParser, "parse_args",
                  lambda self, *a, **kw: stop(self, *a, **kw))
        with pytest.raises(_Parsed) as e:
            mod.main(head + ["--supervise", "--faultPlan",
                             "preempt_soft@step:3", "--elastic", "scale",
                             "--minDevices", "3"])
        ns = e.value.args[0]
        assert (ns.supervise, ns.faultPlan, ns.elastic, ns.minDevices) == \
            (5, "preempt_soft@step:3", "scale", 3)
        with pytest.raises(_Parsed) as e:
            mod.main(head + ["--supervise", "2"])
        ns = e.value.args[0]
        assert (ns.supervise, ns.faultPlan, ns.elastic, ns.minDevices) == \
            (2, None, None, 1)
    with pytest.raises(SystemExit) as e:
        mod.main(head + ["--elastic", "stretch"])
    assert e.value.code == 2


def test_resilience_flag_errors_match_jax(tmp_path, capsys):
    """A bad --faultPlan exits with the JAX '--faultPlan: ...' line (a
    training CLI and perf), --elastic without dp with the JAX message,
    and --elastic with --timeToAcc with perf's."""
    from bigdl_tpu_torch.cli import lenet, perf
    bad = "nosuchkind@step:1"
    with pytest.raises(ValueError) as je_:
        jf.parse_plan(bad)
    for run in (lambda: lenet.main(["train", "-f", str(tmp_path),
                                    "--platform", "cpu", "--faultPlan",
                                    bad]),
                lambda: perf.main(["--platform", "cpu", "--faultPlan",
                                   bad])):
        with pytest.raises(SystemExit) as e:
            run()
        assert str(e.value.code) == f"--faultPlan: {je_.value}"
    with pytest.raises(SystemExit, match="composes with --strategy dp"):
        perf.main(["-m", "lenet5", "--platform", "cpu", "--elastic",
                   "hold"])
    with pytest.raises(SystemExit, match=r"--elastic \+ --timeToAcc"):
        perf.main(["-m", "resnet20_cifar", "--platform", "cpu",
                   "--elastic", "hold", "--timeToAcc", "0.5"])
    with pytest.raises(SystemExit, match="--elastic needs --strategy dp"):
        common.run_optimize(lambda: None, SimpleNamespace(
            elastic="hold", strategy=None, dataParallel=False))
