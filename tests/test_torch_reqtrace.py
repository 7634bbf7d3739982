"""The port's request tracing (bigdl_tpu_torch.serving.reqtrace) against
the JAX package's, on the CPU: the same injected-clock event sequences
through both tracers give equal lifecycle records, equal SLO counters,
burn rates and shed verdicts, byte-equal access-log lines and the same
sampled rids; ``mint_rid``/``sanitize_rid`` agree; the joined span
timeline is the same; a tiny LM's decode lifecycle (finished, expired in
the queue, closed) ends in the JAX engine's states with equal records;
``/debug/requests`` and ``/debug/slots`` carry the JAX keys."""

import json
import re

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu.obs import metrics as jmetrics
from bigdl_tpu.obs import spans as jspans
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.serving import ServingApp as JaxServingApp
from bigdl_tpu.serving import reqtrace as jrt
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.obs import metrics as pmetrics
from bigdl_tpu_torch.obs import spans as pspans
from bigdl_tpu_torch.serving import DecodeEngine, ServingApp
from bigdl_tpu_torch.serving import reqtrace as prt

STATES = ("finished", "expired", "shed", "rejected", "worker_dead",
          "bad_request", "error", "closed")
COUNTERS = ("slo_requests_total", "slo_good_total", "slo_violations_total",
            "slo_ttft_violations_total", "slo_tpot_violations_total",
            "reqtrace_records_dropped_total") + tuple(
    f"requests_state_{s}_total" for s in STATES)
HISTOGRAMS = ("ttft_ms", "tpot_ms", "itl_ms", "request_queue_wait_ms",
              "request_prefill_ms", "request_decode_ms", "request_total_ms")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_global_tracers():
    yield
    for mod in (jrt, prt):
        mod.set_request_tracer(None)
    jspans.disable()
    pspans.disable()


def _script(seed, n=24):
    """A seeded event sequence: (op, args) with the clock advances."""
    rs = np.random.RandomState(seed)
    ops = []
    for i in range(n):
        rid = f"q{seed}-{i:03d}"
        ops.append(("tick", float(rs.uniform(0.0, 0.02))))
        ops.append(("admit", rid, "generate" if i % 4 else "predict",
                    int(rs.randint(1, 300)), int(rs.randint(1, 40))))
        if rs.rand() < 0.15:  # shed or rejected at admission
            ops.append(("finish", rid, STATES[2 + rs.randint(2)], None))
            continue
        ops.append(("queued", rid))
        ops.append(("tick", float(rs.uniform(0.0, 0.05))))
        ops.append(("dequeued", rid))
        t0 = float(rs.uniform(0.0, 0.01))
        ops.append(("prefill", rid, t0, t0 + float(rs.uniform(0.0, 0.3)),
                    int(rs.randint(4)), int(rs.randint(3)) * 16,
                    int(rs.randint(1, 9))))
        if rs.rand() < 0.5:
            ops.append(("first_byte", rid))
        for _ in range(rs.randint(0, 8)):
            ops.append(("tick", float(rs.uniform(0.001, 0.08))))
            ops.append(("round", rid, int(rs.randint(0, 4)),
                        int(rs.randint(0, 3)), int(rs.randint(1, 9)),
                        int(rs.randint(300))))
        state = "finished" if rs.rand() < 0.7 else STATES[rs.randint(8)]
        ops.append(("finish", rid, state, None))
        if rs.rand() < 0.5:  # the server's late status annotation
            ops.append(("finish", rid, "finished", 200))
    return ops


def _run(mod, ops, clock, t, metrics, **kw):
    rt = mod.RequestTracer(capacity=kw.pop("capacity", 1024), clock=clock,
                           metrics=metrics, **kw)
    for op in ops:
        kind = op[0]
        if kind == "tick":
            t[0] += op[1]
        elif kind == "admit":
            rt.admit(op[2], op[1], prompt_tokens=op[3], max_new=op[4])
        elif kind == "queued":
            rt.note_queued(op[1])
        elif kind == "dequeued":
            rt.note_dequeued(op[1])
        elif kind == "prefill":
            rt.note_prefill(op[1], t[0] + op[2], t[0] + op[3], slot=op[4],
                            prefix_hit_tokens=op[5], pages=op[6])
        elif kind == "first_byte":
            rt.note_first_byte(op[1])
        elif kind == "round":
            rt.note_round(op[1], op[2], accepted=op[3], pages=op[4],
                          pos=op[5])
        elif kind == "finish":
            rt.finish(op[1], op[2], status=op[3])
    return rt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracer_records_slo_and_metrics_match_jax(seed):
    ops = _script(seed)
    out = {}
    for name, mod, metrics in (("jax", jrt, jmetrics), ("port", prt,
                                                       pmetrics)):
        t = [100.0]
        reg = metrics.MetricsRegistry()
        rt = _run(mod, ops, lambda: t[0], t, reg, capacity=16,
                  slo=mod.SloPolicy.parse("ttft=150,tpot=30,window=8"))
        out[name] = dict(
            recent=[r.to_dict() for r in rt.recent()],
            live=[r.to_dict(t[0]) for r in rt.in_flight()],
            dropped=rt.dropped,
            counters={c: reg.counter(c).value for c in COUNTERS},
            hist={h: reg.histogram(h).snapshot() for h in HISTOGRAMS},
            slo=(rt.slo.burn_rate(), rt.slo.goodput_frac(),
                 rt.slo.should_shed(), rt.slo.describe()),
            snap=rt.snapshot(recent=8))
    assert out["port"] == out["jax"]
    assert out["jax"]["dropped"] > 0 and out["jax"]["recent"]


def test_slo_parse_burn_and_shed_match_jax():
    for spec in ("ttft=200", "ttft=200,tpot=30", "tpot=5,burn=0.5,window=4",
                 " TTFT=1.5 , burn=1 "):
        j, p = jrt.SloPolicy.parse(spec), prt.SloPolicy.parse(spec)
        assert p.describe() == j.describe()
    for bad in ("ttft", "ttft=0", "itl=5", "burn=0.5", "ttft=1,burn=2",
                "ttft=1,window=0"):
        with pytest.raises(ValueError) as je:
            jrt.SloPolicy.parse(bad)
        with pytest.raises(ValueError) as pe:
            prt.SloPolicy.parse(bad)
        assert str(pe.value) == str(je.value)
    rs = np.random.RandomState(3)
    j = jrt.SloPolicy.parse("ttft=1,burn=0.6,window=10")
    p = prt.SloPolicy.parse("ttft=1,burn=0.6,window=10")
    for good in rs.rand(40) < 0.4:
        j.account(bool(good))
        p.account(bool(good))
        assert (p.burn_rate(), p.goodput_frac(), p.should_shed()) == (
            j.burn_rate(), j.goodput_frac(), j.should_shed())


@pytest.mark.parametrize("sample", [1.0, 0.3, 0.0])
def test_access_log_lines_and_sampling_match_jax(tmp_path, sample):
    ops = _script(5, n=40)
    for name, mod, metrics in (("jax", jrt, jmetrics), ("port", prt,
                                                       pmetrics)):
        t = [7.0]
        log = mod.AccessLog(str(tmp_path / f"{name}.jsonl"), sample=sample)
        rt = _run(mod, ops, lambda: t[0], t, metrics.MetricsRegistry(),
                  access_log=log)
        rt.close()
    jb = (tmp_path / "jax.jsonl").read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == jb
    n = len(jb.splitlines())
    assert (n == 0) if sample == 0.0 else (n > 0)
    rids = [f"r{i:05d}" for i in range(500)] + ["x", "abc-12", "r1e65-000001"]
    jl = jrt.AccessLog(str(tmp_path / "j2.jsonl"), sample=sample)
    pl = prt.AccessLog(str(tmp_path / "p2.jsonl"), sample=sample)
    assert [pl.sampled(r) for r in rids] == [jl.sampled(r) for r in rids]
    if sample == 0.3:
        assert 100 < sum(pl.sampled(r) for r in rids) < 200
    with pytest.raises(ValueError):
        prt.AccessLog(str(tmp_path / "bad.jsonl"), sample=1.5)


def test_mint_and_sanitize_rid_match_jax():
    raws = ["abc", " padded ", "", "x" * 64, "x" * 65, "has space",
            "tab\there", "ünï", "~!@#$%^&*()", None, 42, "a\nb",
            "r1e65-000001", "\x7f"]
    assert [prt.sanitize_rid(r) for r in raws] == \
        [jrt.sanitize_rid(r) for r in raws]
    pat = re.compile(r"^r[0-9a-f]{4}-\d{6}$")
    a, b = prt.mint_rid(), prt.mint_rid()
    assert pat.match(a) and pat.match(b) and a != b
    assert a.split("-")[0] == jrt.mint_rid().split("-")[0]  # one pid
    assert prt.TERMINAL_STATES == jrt.TERMINAL_STATES
    assert prt.LIVE_STATES == jrt.LIVE_STATES


def test_records_join_the_span_timeline_as_jax():
    ops = _script(9, n=10)
    traces = {}
    for name, mod, spans, metrics in (("jax", jrt, jspans, jmetrics),
                                      ("port", prt, pspans, pmetrics)):
        t = [0.5]
        clock = lambda: t[0]  # noqa: E731
        tr = spans.enable(clock=clock)
        with spans.span("outer", k=1):
            t[0] += 0.25
            spans.instant("mark", x=2)
            spans.counter("bytes", {"a": 3})
        _run(mod, ops, clock, t, metrics.MetricsRegistry())
        traces[name] = tr.chrome_trace()
        spans.disable()
    assert traces["port"] == traces["jax"]
    names = {e["name"] for e in traces["port"]["traceEvents"]}
    assert {"outer", "mark", "bytes", "req:generate",
            "req:prefill"} <= names


# ------------------------------------------------------- decode lifecycle
VOCAB, D, LAYERS, HEADS, MAX_LEN = 53, 32, 2, 2, 64


@pytest.fixture(scope="module")
def lm_pair():
    jm = jax_models.transformer_lm(VOCAB, d_model=D, num_layers=LAYERS,
                                   num_heads=HEADS, max_len=MAX_LEN)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(2)))
    params["emb"]["weight"] = params["emb"]["weight"] * np.float32(0.05)
    pm = TransformerLM(VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
                       max_len=MAX_LEN).load_jax_params(params).eval()
    return jm, params, pm


def _lifecycle(make_engine, mod, metrics):
    """a finishes, b expires in the queue, c is installed when a ends and
    closed with the engine; d is cancelled while waiting."""
    t = [10.0]
    clock = lambda: t[0]  # noqa: E731
    rt = mod.RequestTracer(clock=clock, metrics=metrics.MetricsRegistry())
    mod.set_request_tracer(rt)
    eng = make_engine(clock)
    for rid, prompt, n, dl in (("a", [3, 1, 4, 1], 3, None),
                               ("b", [5, 9], 2, 10.5), ("c", [2, 6, 5], 2,
                                                        None),
                               ("d", [7], 2, None)):
        rt.admit("generate", rid, prompt_tokens=len(prompt), max_new=n)
        eng.submit(prompt, n, rid=rid, deadline=dl)
    assert eng.cancel("d")
    t[0] = 11.0
    for _ in range(3):
        eng.step()
        t[0] += 0.125
    eng.close()
    mod.set_request_tracer(None)
    return {r.rid: r.to_dict() for r in rt.recent()}


def test_decode_lifecycle_matches_jax(lm_pair):
    jm, params, pm = lm_pair
    ref = _lifecycle(lambda clock: JaxDecodeEngine(jm, params, slots=1,
                                                   clock=clock),
                     jrt, jmetrics)
    got = _lifecycle(lambda clock: DecodeEngine(pm, slots=1, clock=clock,
                                                device="cpu"),
                     prt, pmetrics)
    assert {k: v["state"] for k, v in ref.items()} == {
        "a": "finished", "b": "expired", "c": "closed", "d": "closed"}
    assert got == ref


def test_debug_endpoints_carry_the_jax_keys(lm_pair):
    jm, params, pm = lm_pair
    jdec = JaxDecodeEngine(jm, params, slots=2, kv_page_tokens=16,
                           prefix_cache=True)
    pdec = DecodeEngine(pm, slots=2, kv_page_tokens=16, prefix_cache=True,
                        device="cpu")
    japp = JaxServingApp(name="m", metrics=jmetrics.MetricsRegistry(),
                         decoder=jdec)
    papp = ServingApp(name="m", metrics=pmetrics.MetricsRegistry(),
                      decoder=pdec)
    for app in (japp, papp):
        assert app.handle_debug_requests()[0] == 404
        app.decoder.submit(list(range(1, 20)), 4, rid="s1")
    jst, js = japp.handle_debug_slots()
    pst, ps = papp.handle_debug_slots()
    assert jst == pst == 200
    assert set(js) <= set(ps) and set(js["kv"]) == set(ps["kv"])
    assert [set(s) for s in js["slots"]] == [set(s) for s in ps["slots"]]
    assert ps["kv"]["occupancy_frac"] == js["kv"]["occupancy_frac"]
    assert ps["slots"][0]["rid"] == "s1" and ps["slots"][0]["pages"] == 2
    t = [0.0]
    for mod, metrics in ((jrt, jmetrics), (prt, pmetrics)):
        rt = mod.RequestTracer(clock=lambda: t[0],
                               metrics=metrics.MetricsRegistry(),
                               slo=mod.SloPolicy.parse("ttft=10"))
        rt.admit("generate", "x1")
        rt.admit("predict", "x2")
        rt.finish("x2", "finished")
        mod.set_request_tracer(rt)
    jst, jr = japp.handle_debug_requests()
    pst, pr = papp.handle_debug_requests()
    assert jst == pst == 200 and pr == jr
    json.dumps(ps)
    jdec.close()
    pdec.close()
