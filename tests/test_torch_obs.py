"""The port's observability surface against the JAX package's
(``bigdl_tpu/obs``, ``cli/common.py``'s ``--obs`` family, ``cli.perf``'s
observability columns, ``explain``): the phase taxonomy and
``--traceSteps`` grammar, ``torch.profiler`` capture windows on the CPU
(planned, touch-file and SIGUSR2 triggers; attributed through the host
fallback), the ``/metrics`` listener, the Optimizer's phase histograms
and spans, ``cli.perf --obs`` on the CPU, and ``explain``."""

import argparse
import json
import os
import signal
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from bigdl_tpu import obs as jobs
from bigdl_tpu.obs import capture as jcapture
from bigdl_tpu_torch import obs
from bigdl_tpu_torch.cli import common
from bigdl_tpu_torch.obs import memory


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU models run on one intra-op thread: under the suite's six
    workers, eight threads each spin far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset_registry()
    memory._reset_context()
    yield
    obs.disable()
    obs.reset_registry()
    memory._reset_context()


def _tiny_steps(n, on_step=None):
    """``n`` SGD steps of a small MLP on the CPU, ``on_step(i)`` before
    each (a capture controller's)."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 8, generator=g, requires_grad=True)
    x = torch.randn(32, 16, generator=g)
    for i in range(n):
        if on_step is not None:
            on_step(i)
        loss = torch.relu(x @ w).square().mean()
        loss.backward()
        with torch.no_grad():
            w -= 0.1 * w.grad
            w.grad = None


# ------------------------------------------------------------ taxonomy
def test_phase_taxonomy_and_histograms_equal_jax():
    assert obs.PHASE_BUCKETS_MS == jobs.PHASE_BUCKETS_MS
    assert obs.TRAIN_PHASES == jobs.TRAIN_PHASES
    reg, jreg = obs.MetricsRegistry("bigdl"), jobs.MetricsRegistry("bigdl")
    h = obs.phase_histograms(reg, "train")
    jobs.phase_histograms(jreg, "train")
    assert obs.phase_histograms(reg, "train")["dispatch"] is h["dispatch"]
    for hist in (h["dispatch"], jreg.histogram("train_phase_dispatch_ms")):
        hist.observe(0.3)

    def shape(page):  # the series and values, not the uptime line
        return [ln for ln in page.splitlines() if "uptime" not in ln]

    assert shape(reg.render()) == shape(jreg.render())


@pytest.mark.parametrize("spec", ["5@20", "1@0", " 3@7 ", "", "5", "@3",
                                  "0@2", "a@b", "3@"])
def test_parse_trace_steps_equals_jax(spec):
    try:
        want = jcapture.parse_trace_steps(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            obs.parse_trace_steps(spec)
        assert str(got.value) == str(e)
    else:
        assert obs.parse_trace_steps(spec) == want
    assert obs.TOUCH_FILE_NAME == jobs.TOUCH_FILE_NAME


# ------------------------------------------------------------- capture
def test_capture_window_parses_and_attributes_through_host_fallback(
        tmp_path):
    ctl = obs.CaptureController(str(tmp_path / "tr"), trace_steps="2@1",
                                install_signal=False, device="cpu")
    _tiny_steps(5, ctl.on_step)
    ctl.finish()
    assert len(ctl.captures) == 1
    cap = ctl.captures[0]
    assert (cap["start_step"], cap["stop_step"]) == (1, 3)
    assert cap["ok"], cap.get("error")
    assert cap["trace"] == str(tmp_path / "tr" / "capture_1" / "trace.json")
    assert "attrib_error" not in cap
    a = cap["attrib"]
    assert a["steps"] == 2 and a["total_device_s"] > 0
    assert "matmul" in a["categories"]  # aten::mm on the host rows
    assert "host_other" in cap["top"]
    page = obs.get_registry().render()
    assert "bigdl_attrib_total_device_seconds" in page


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_host_only_window_verifies_on_the_cpu_only(tmp_path, device):
    """The host fallback is for CPU windows: a window of a run on the card
    whose trace holds no device event (CUPTI recorded nothing) fails its
    verify instead of reading operator time as device time."""
    d = tmp_path / "tr" / "capture_0"
    d.mkdir(parents=True)
    (d / "trace.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 40.0, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::relu", "ts": 50.0,
         "dur": 10.0, "tid": 1}]}))
    ctl = obs.CaptureController(str(tmp_path / "tr"), install_signal=False,
                                device=torch.device(device))
    rec = {"start_step": 0, "stop_step": 1, "dir": str(d), "ok": False}
    ctl._verify(rec)
    if device == "cpu":
        assert rec["ok"] and "error" not in rec
        assert rec["attrib"]["total_device_s"] == pytest.approx(5e-5)
    else:
        assert not rec["ok"] and "attrib" not in rec
        assert rec["error"] == "no device events (CUPTI recorded no kernel)"
        assert "attrib_total_device" not in obs.get_registry().render()


def test_capture_touch_file_and_sigusr2_open_windows(tmp_path):
    assert threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGUSR2)
    ctl = obs.CaptureController(str(tmp_path / "tr"), window_steps=2,
                                device="cpu")
    assert signal.getsignal(signal.SIGUSR2) not in (signal.SIG_DFL, None)

    def on_step(i):
        if i == 1:
            open(ctl.touch_file, "w").close()
        if i == 4:
            os.kill(os.getpid(), signal.SIGUSR2)
        ctl.on_step(i)

    _tiny_steps(8, on_step)
    ctl.finish()
    assert signal.getsignal(signal.SIGUSR2) == before  # handed back
    got = [(c["trigger"], c["start_step"], c["stop_step"], c["ok"])
           for c in ctl.captures]
    assert got == [("touch", 1, 3, True), ("signal", 4, 6, True)]
    assert not os.path.exists(ctl.touch_file)  # one touch, one window


def test_a_second_profiler_session_is_recorded_not_raised(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    ctl = obs.CaptureController(str(tmp_path / "tr"), trace_steps="1@0",
                                install_signal=False, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        _tiny_steps(2, ctl.on_step)
    ctl.finish()
    (cap,) = ctl.captures
    assert not cap["ok"] and "another torch.profiler session" in \
        cap["error"]


# ------------------------------------------------------------ /metrics
def test_metrics_listener_scrapes_the_registry():
    reg = obs.MetricsRegistry("bigdl")
    reg.counter("train_steps_total", "steps").inc(3)
    srv = obs.start_metrics_server(reg, port=0)
    try:
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            page = r.read().decode()
        assert "bigdl_train_steps_total 3" in page
        base = srv.url.rsplit("/", 1)[0]
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
        with pytest.raises(SystemExit, match="--metricsPort"):
            obs.start_metrics_server(reg, port=srv.port, strict=True)
        assert obs.start_metrics_server(reg, port=srv.port) is None
    finally:
        srv.close()


# ------------------------------------------------------------ Optimizer
def _train_tiny(capture=None, epochs=1):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import Sequential
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    rs = np.random.RandomState(0)
    ds = BatchDataSet(rs.randn(32, 8).astype(np.float32),
                      rs.randint(0, 3, 32).astype(np.int32), 8)
    g = torch.Generator().manual_seed(0)
    model = Sequential(nn.Linear(8, 3, generator=g), nn.LogSoftMax())
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(),
                    optim_method=SGD(learning_rate=0.1),
                    end_when=Trigger.max_epoch(epochs), device="cpu")
    if capture is not None:
        opt.set_capture(capture)
    opt.optimize()
    return opt


def test_optimizer_publishes_phases_spans_and_captures(tmp_path):
    obs.enable()
    ctl = obs.CaptureController(str(tmp_path / "tr"), trace_steps="2@1",
                                install_signal=False, device="cpu")
    opt = _train_tiny(ctl)
    ctl.finish()
    totals = opt.phase_totals()
    assert totals["dispatch"] > 0 and totals["device"] >= 0
    reg = obs.get_registry()
    page = reg.render()
    for ph in ("dispatch", "data_wait", "h2d"):
        assert f"bigdl_train_phase_{ph}_seconds_total" in page
    assert reg.histogram("train_phase_dispatch_ms").snapshot()["count"] == 4
    names = {e["name"] for e in obs.get_tracer().events()}
    assert {"data_wait", "h2d", "dispatch", "device"} <= names
    (cap,) = ctl.captures
    assert cap["ok"] and (cap["start_step"], cap["stop_step"]) == (1, 3)


def test_optimizer_without_obs_still_meters_data_wait():
    assert not obs.enabled()
    opt = _train_tiny()
    totals = opt.phase_totals()
    assert totals["dispatch"] > 0 and totals["data_wait"] >= 0
    assert "device" not in totals  # the device wait is --obs only
    page = obs.get_registry().render()
    assert "bigdl_train_phase_dispatch_seconds_total" in page
    assert "train_phase_dispatch_ms" not in page


def test_phase_meter_publishes_each_second_once():
    """The one meter of the Optimizer's and cli.perf's loops: totals
    always, histograms once it observes into a registry, and each publish
    adds what a phase gained since the last one."""
    from bigdl_tpu_torch.obs.metrics import PhaseMeter

    reg = obs.MetricsRegistry("bigdl")
    m = PhaseMeter()
    m.add("dispatch", 0.5)
    m.publish(reg)
    m.observe_into(reg)
    with m.phase("data_wait"):
        pass
    m.add("dispatch", 0.25)
    m.publish(reg)
    m.publish(reg)
    assert m.totals["dispatch"] == 0.75 and m.totals["data_wait"] >= 0
    assert reg.counter("train_phase_dispatch_seconds_total").value == 0.75
    assert reg.histogram("train_phase_dispatch_ms").snapshot()["count"] == 1


def test_optimizer_counters_sum_its_phase_totals_over_epochs():
    opt = _train_tiny(epochs=3)
    c = obs.get_registry().counter("train_phase_dispatch_seconds_total")
    assert c.value == pytest.approx(opt.phase_totals()["dispatch"])


# ------------------------------------------------------------ CLI wiring
def test_install_observability_wiring(tmp_path, monkeypatch):
    p = argparse.ArgumentParser()
    common.add_obs_args(p)
    p.add_argument("--platform", default="cpu")
    assert common.install_observability(p.parse_args([])) is None
    assert not obs.enabled()
    with pytest.raises(SystemExit, match="--traceSteps needs --traceDir"):
        common.install_observability(p.parse_args(["--traceSteps", "1@1"]))
    with pytest.raises(SystemExit, match="expected N@M"):
        common.install_observability(p.parse_args(
            ["--traceDir", str(tmp_path / "a"), "--traceSteps", "x"]))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    args = p.parse_args(["--traceDir", str(tmp_path / "t")])
    st = common.install_observability(args)
    assert st is args._obs and st.enabled and obs.enabled()
    assert st.trace_dir == str(tmp_path / "t" / "rank1")
    assert memory.installed_trace_dir() == st.trace_dir
    st.capture.finish()
    info = st.finalize()
    assert info["trace_json"] == str(tmp_path / "t" / "rank1" /
                                     "spans.trace.json")
    assert st.finalize() is info


def _perf(tmp_path, extra):
    from bigdl_tpu_torch.cli import perf

    out = perf.main(["-m", "lenet5", "--platform", "cpu", "--f32", "-b",
                     "4", "-i", "4"] + extra)
    obs.disable()
    return out


def test_perf_obs_columns_and_spans(tmp_path):
    on = _perf(tmp_path, ["--obs", "--traceDir", str(tmp_path / "tr"),
                          "--traceSteps", "1@1", "--metricsPort", "0"])
    s = sum(on[f"{p}_s"] for p in ("data_wait", "h2d", "dispatch", "device",
                                   "ckpt"))
    assert s == pytest.approx(on["seconds"], rel=0.10)
    assert on["stall_frac"] == 0.0
    with open(on["obs"]["trace_json"]) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"dispatch", "device"} <= names
    (cap,) = on["obs"]["captures"]
    assert cap["ok"] and on["attrib"] == cap["attrib"]
    assert on["collective_s"] == 0.0
    assert on["mem"]["source"] == "plan"  # no live allocator on the CPU
    assert on["hbm_peak_bytes"] == on["mem"]["total_bytes"]
    with urllib.request.urlopen(on["obs"]["metrics_url"], timeout=10) as r:
        page = r.read().decode()
    assert "train_phase_dispatch_ms_bucket" in page
    assert "attrib_conv_seconds" in page
    off = _perf(tmp_path, [])
    assert set(off) == set(on) - {"obs"}
    for c in ("data_wait_s", "h2d_s", "dispatch_s", "device_s", "ckpt_s",
              "stall_frac", "collective_s", "collective_frac", "attrib",
              "hbm_peak_bytes", "hbm_headroom_frac", "mem"):
        assert off[c] is None, c


def test_explain_directory_and_mem_on_the_cpu(tmp_path, capsys):
    from bigdl_tpu_torch.cli import main as cli_main

    ctl = obs.CaptureController(str(tmp_path / "tr"), trace_steps="2@0",
                                install_signal=False, device="cpu")
    _tiny_steps(3, ctl.on_step)
    ctl.finish()
    d = ctl.captures[0]["dir"]
    assert cli_main.main(["explain", d, "--json", "--steps", "2",
                          "--gflops", "1e-3", "--peak", "1e12"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and out["trace"].startswith(d)
    assert out["mfu"]["step_flops"] == 1e6
    assert cli_main.main(["explain", d]) == 0
    assert "host_other" in capsys.readouterr().out
    assert cli_main.main(["explain", "--mem", "lenet5", "-b", "4",
                          "--json", "--platform", "cpu"]) == 0
    mem = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mem["model"] == "lenet5" and mem["device"] == "cpu"
    assert mem["forecast"]["fit_batches"] == [4, 8]
    assert mem["plan_2x"]["batch"] == 8
    with pytest.raises(SystemExit, match="--mem explains a MODEL"):
        cli_main.main(["explain", "--mem", d])
