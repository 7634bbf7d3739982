"""The port's memory plan, forecaster and OOM autopsy
(``bigdl_tpu_torch/obs/memory.py``) against the JAX package's
(``bigdl_tpu/obs/memory.py``): byte counts of the same trees, the
abstract plan, the forecasts, the compact and rendered spellings, and
the report a simulated "CUDA out of memory" leaves behind."""

import json
import os

import numpy as np
import pytest
import torch

from bigdl_tpu.obs import memory as jmem
from bigdl_tpu_torch import obs
from bigdl_tpu_torch.obs import memory


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset_registry()
    memory._reset_context()
    yield
    obs.disable()
    obs.reset_registry()
    memory._reset_context()


def _trees(seed=0):
    rs = np.random.RandomState(seed)
    params = {"conv": {"w": rs.randn(8, 3, 3, 3).astype(np.float32),
                       "b": rs.randn(8).astype(np.float32)},
              "fc": [rs.randn(10, 32).astype(np.float32)]}
    opt = {"momentum": {"conv": {"w": np.zeros((8, 3, 3, 3), np.float32)},
                        "fc": [np.zeros((10, 32), np.float32)]},
           "step": np.zeros((), np.int32)}
    batch = (rs.randn(4, 16, 16, 3).astype(np.float16),
             rs.randint(0, 10, 4).astype(np.int64))
    return params, opt, batch


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_torch_tree(v) for v in t)
    return torch.from_numpy(np.asarray(t))


def _renamed(plan: dict) -> dict:
    """A port plan in the JAX plan's keys (the measured total rides where
    the compiler's does)."""
    p = {k: v for k, v in plan.items() if k != "measured_total_bytes"}
    p["compiler_total_bytes"] = plan["measured_total_bytes"]
    p["compiler"] = None
    return p


def test_tree_bytes_of_torch_trees_equals_jax():
    for tree in _trees():
        assert memory.tree_bytes(_torch_tree(tree)) == \
            jmem.tree_bytes(tree) > 0
        assert memory.tree_bytes(tree) == jmem.tree_bytes(tree)
    assert memory.tree_bytes(None) == jmem.tree_bytes(None) == 0
    view = torch.zeros(4, 8)[:, :2]  # a view counts its own elements
    assert memory.tree_bytes([view]) == 4 * 2 * 4


@pytest.mark.parametrize("grad_comm", [None, {"pad_bytes": 96},
                                       {"n_buckets": 3, "bucket_bytes": 512,
                                        "total_bytes": 1400}])
def test_abstract_plan_equals_jax(grad_comm):
    params, opt, batch = _trees()
    ours = memory.build_plan(params=_torch_tree(params),
                             opt_state=_torch_tree(opt),
                             batch=_torch_tree(batch), grad_comm=grad_comm,
                             device="cpu", batch_size=4, model_name="m")
    ref = jmem.build_plan(params=params, opt_state=opt, batch=batch,
                          grad_comm=grad_comm, batch_size=4, model_name="m")
    assert ours["device"] == "cpu" and ours["measured_total_bytes"] is None
    ref.pop("device")
    got = _renamed(ours)
    got.pop("device")
    assert got == ref
    assert memory.compact(ours) == {
        ("measured_total_bytes" if k == "compiler_total_bytes" else k): v
        for k, v in jmem.compact(ref).items()}
    assert memory.render(ours) == jmem.render(ref)


def test_measured_plan_totals_by_construction():
    params, opt, batch = _trees()
    kw = dict(params=params, opt_state=opt, batch=batch, device="cpu",
              batch_size=4)
    known = sum(jmem.tree_bytes(t) for t in (params, opt, batch))
    pb = jmem.tree_bytes(params)
    for measured in (known + 10 * pb, known + pb // 2, known // 2):
        plan = memory.build_plan(measured, **kw)
        cats = plan["categories"]
        assert plan["total_bytes"] == sum(cats.values()) == measured
        assert plan["measured_total_bytes"] == measured
        if measured >= known:
            assert cats["gradients"] == min(pb, measured - known)
            assert cats["activations"] == measured - known - \
                cats["gradients"]
        else:  # the trees overshoot: scaled down, no gradient row
            assert cats["gradients"] == 0 and cats["params"] < pb
    text = memory.render(memory.build_plan(known + 10 * pb, **kw))
    assert "allocator peak" in text and "table drift 0.00%" in text


def test_forecasts_equal_jax_and_errors():
    params, opt, batch = _trees()
    plans = {}
    for b, extra in ((16, 5_000_000), (32, 9_000_000), (64, 17_000_000)):
        p = memory.build_plan(extra, params=params, opt_state=opt,
                              batch=batch, device="cpu", batch_size=b)
        plans[b] = p
        jp = _renamed(p)
        assert jmem.compact(jp)["total_bytes"] == p["total_bytes"]
    for a, b in ((16, 32), (64, 16)):
        assert memory.forecast(plans[a], plans[b]) == \
            jmem.forecast(_renamed(plans[a]), _renamed(plans[b]))
    fc = memory.forecast(plans[16], plans[32])
    assert fc["bytes_per_sample"] == 250_000 and fc["predicted_max_batch"]
    assert memory.render(plans[16], fc).endswith(
        f"predicted max batch {fc['predicted_max_batch']}")
    for bad in ((plans[16], plans[16]), (plans[16], dict(plans[32],
                                                          batch=None))):
        with pytest.raises(ValueError) as e1:
            memory.forecast(*bad)
        with pytest.raises(ValueError) as e2:
            jmem.forecast(*(_renamed(p) for p in bad))
        assert str(e1.value) == str(e2.value)
    kv = {"params_bytes": 3_000_000, "kv_bytes_per_slot": 65_536,
          "hbm_bytes": 80_000_000}
    for cap in (None, 10_000_000, 1_000):
        assert memory.forecast_slots(kv, cap) == jmem.forecast_slots(kv, cap)


def test_serving_kv_plan_counts_the_cache():
    """transformer_lm_rope at 64 tokens: 8 layers of K and V, 2 KV heads
    of 64; kv8 pages of 64 tokens, int8 rows plus an f32 scale a token."""
    dense = memory.serving_kv_plan("transformer_lm_rope", seq_len=64,
                                   device="cpu")
    assert dense["kv_bytes_per_slot"] == 8 * 2 * (2 * 64 * 64) * 4
    kv8 = memory.serving_kv_plan("transformer_lm_rope", seq_len=64,
                                 quantize="int8+kv8", device="cpu")
    assert kv8["page_tokens"] == 64
    assert kv8["kv_bytes_per_slot"] == 8 * 2 * (2 * 64 * 64 + 2 * 64 * 4)
    assert kv8["params_bytes"] < dense["params_bytes"] == \
        dense["params_bytes_f32"]
    assert memory.forecast_slots(kv8)["predicted_max_slots"] > \
        memory.forecast_slots(dense)["predicted_max_slots"]
    with pytest.raises(ValueError):
        memory.serving_kv_plan("lenet5", device="cpu")


def test_plan_for_model_on_the_cpu_is_abstract():
    plan = memory.plan_for_model("lenet5", 8, device="cpu")
    assert plan["measured_total_bytes"] is None
    assert plan["hbm_match"] == "cpu" and plan["batch"] == 8
    cats = plan["categories"]
    assert cats["params"] == cats["gradients"] > 0
    # SGD's momentum buffers and its step count
    assert cats["params"] < cats["optimizer"] <= cats["params"] + 64
    assert cats["input"] == 8 * 28 * 28 * 1 * 2 + 8 * 4  # bf16 x, int32 y


def test_sampler_degrades_on_cpu_and_reads_fake_stats(monkeypatch):
    s = memory.HbmSampler("cpu")
    assert s.sample(0) is None and s.annotation() is None
    assert s.peak_bytes is None
    monkeypatch.setattr(memory, "device_hbm_bytes",
                        lambda d=None: (80e9, "total_memory(fake)"))
    stats = {"allocated_bytes.all.current": 3000,
             "allocated_bytes.all.peak": 7000,
             "reserved_bytes.all.current": 5000}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d=None: stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (1000, 80_000))
    reg = obs.MetricsRegistry("bigdl")
    s = memory.HbmSampler(torch.device("cuda"), registry=reg, base_bytes=64)
    got = s.sample(3)
    assert got == {"bytes_in_use": 3000, "peak_bytes_in_use": 7000,
                   "reserved_bytes": 5000,
                   "largest_free_block_bytes": 1000 + 5000 - 3000}
    assert s.peak_bytes == 7000 and s.history == [(3, 3000, 7000)]
    ann = s.annotation()
    assert ann["largest_free_block_source"] == memory.FREE_BLOCK_SOURCE
    assert ann["base_bytes"] == 64
    page = reg.render()
    assert "bigdl_hbm_peak_bytes 7000" in page
    assert "bigdl_hbm_largest_free_block_bytes 3000" in page


def test_is_resource_exhausted_matches_cuda_and_jax_spellings():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    for e in (oom, RuntimeError("CUDA out of memory. Tried to allocate"),
              RuntimeError("RESOURCE_EXHAUSTED: Out of memory"),
              RuntimeError("Resource exhausted: ...")):
        assert memory.is_resource_exhausted(e)
    for e in (RuntimeError("shape mismatch"), ValueError("no")):
        assert not memory.is_resource_exhausted(e)
        assert not jmem.is_resource_exhausted(e)
    assert jmem.is_resource_exhausted(RuntimeError("RESOURCE_EXHAUSTED"))


def test_handle_oom_writes_the_report(tmp_path, monkeypatch):
    log = tmp_path / "faults.jsonl"
    monkeypatch.setenv("BIGDL_FAULT_LOG", str(log))
    obs.enable()
    plan = memory.build_plan(123_456, params=_torch_tree(_trees()[0]),
                             device="cpu", batch_size=4)
    memory.install(trace_dir=str(tmp_path / "tr"), plan=plan)
    keep = torch.zeros(1000, 100)  # a live tensor the report must name
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 64.00 GiB")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with memory.oom_guard("train_dispatch"):
            raise err
    path = tmp_path / "tr" / memory.OOM_REPORT_NAME
    rep = json.loads(path.read_text())
    assert rep["event"] == "oom" and rep["context"] == "train_dispatch"
    assert rep["plan"]["total_bytes"] == 123_456
    assert "CUDA out of memory" in rep["error"]
    top = rep["top_live_buffers"][0]
    assert top["nbytes"] >= keep.numel() * 4 and top["device"] == "cpu"
    stamp = json.loads(log.read_text().splitlines()[-1])
    assert stamp["event"] == "oom" and stamp["report"] == str(path)
    assert obs.get_registry().counter("oom_total").value == 1
    names = [e["name"] for e in obs.get_tracer().events()]
    assert "oom" in names


def test_handle_oom_ignores_other_errors_and_never_raises(tmp_path):
    memory.install(trace_dir=str(tmp_path / "tr"))
    assert memory.handle_oom(ValueError("not an oom"), "x") is None
    assert not (tmp_path / "tr").exists()
    with pytest.raises(KeyError):
        with memory.oom_guard("perf_warmup"):
            raise KeyError("k")
    # an unwritable trace dir: the report is skipped, nothing raises
    blocker = tmp_path / "file"
    blocker.write_text("")
    memory.install(trace_dir=str(blocker / "sub"))
    assert memory.handle_oom(RuntimeError("CUDA out of memory"), "x") is None
    assert os.path.isfile(blocker)
