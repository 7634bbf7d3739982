"""The port's serving fleet (bigdl_tpu_torch.serving.fleet, obs.aggregate,
cli.fleet) against the JAX package's, on the CPU: the control schema, the
router's argv surgery, its ``pick`` over the same worker tables and its
metrics aggregation, byte for byte; the rolling swap on a tiny LM (a
decode in flight and a /predict flush being computed finish on the old
weights, later requests run on the new, each equal to the JAX engine's
tokens for its version; a failed swap keeps the old weights; a prefix
cached under the old weights is not reused, where the JAX swap reuses
it); the worker's control surface; and a router end to end against fake
stdlib worker processes (spawn, SSE pass-through chunk by chunk, a
SIGKILL and the supervised restart, the router's own 503 with a rid). No
test starts a port worker process; the router process imports no
torch."""

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu.cli import common as jcommon
from bigdl_tpu.cli import serve as jserve_cli
from bigdl_tpu.obs.aggregate import aggregate_pages as jaggregate
from bigdl_tpu.obs.aggregate import parse_samples as jparse_samples
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.serving.fleet import control as jcontrol
from bigdl_tpu.serving.fleet import router as jrouter
from bigdl_tpu.serving.fleet import swap as jswap
from bigdl_tpu.utils.file import save_pytree
from bigdl_tpu_torch.cli import common
from bigdl_tpu_torch.cli import serve as serve_cli
from bigdl_tpu_torch.obs.aggregate import aggregate_pages, parse_samples
from bigdl_tpu_torch.obs.metrics import MetricsRegistry
from bigdl_tpu_torch.resilience.supervisor import RetryPolicy
from bigdl_tpu_torch.serving.fleet import control, router, swap
from bigdl_tpu_torch.serving.fleet.worker import WorkerControl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- control plane
def test_worker_status_round_trips_as_jax():
    kw = dict(index=3, pid=42, port=8001, state="ready", queue_depth=5,
              decode_active=2, slo_burn=0.25, goodput=0.9,
              model_version="v7", restarts=1, uptime_s=12.5)
    st = control.WorkerStatus(**kw)
    assert control.WorkerStatus.from_dict(st.to_dict()) == st
    assert st.to_dict() == jcontrol.WorkerStatus(**kw).to_dict()
    d = dict(st.to_dict(), next_proto_field="x")
    assert control.WorkerStatus.from_dict(d) == st
    for bad in ({"state": "ready"}, {"index": 0, "state": "zombie"}):
        with pytest.raises(ValueError) as je:
            jcontrol.WorkerStatus.from_dict(bad)
        with pytest.raises(ValueError) as pe:
            control.WorkerStatus.from_dict(bad)
        assert str(pe.value) == str(je.value)
    assert (control.WORKER_STATES, control.CONTROL_PATH,
            control.RELOAD_PATH) == (jcontrol.WORKER_STATES,
                                     jcontrol.CONTROL_PATH,
                                     jcontrol.RELOAD_PATH)


ARGVS = [
    ["transformer_lm", "--model", "ck", "--fleet", "2", "--port=9000", "-p",
     "9001", "--host", "h", "--randomInit", "--modelVersion", "v1",
     "--fleetHeartbeatS", "0.1", "--fleetRestartBudget", "3", "--slots",
     "4", "--quantize", "int8"],
    ["transformer_lm_1k_hd128", "--randomInit", "--bf16", "--fleet=3",
     "--kvPageTokens", "128", "--prefixCache", "--reqTrace", "on",
     "--slo", "ttft=200", "--model=x", "--host=0.0.0.0"],
    [], ["--fleet"], ["m", "--speculate", "4", "--accessLog", "a.jsonl"]]


def test_worker_base_argv_matches_jax():
    for argv in ARGVS:
        assert router.worker_base_argv(argv) == \
            jrouter.worker_base_argv(argv)


def test_worker_argv_reattaches_current_weights():
    r = router.FleetRouter("m", 2, base_argv=["m", "--slots", "2"],
                           checkpoint="ck_v1", version="v1")
    av = r.worker_argv(1)
    assert av[:3] == [sys.executable, "-m",
                      "bigdl_tpu_torch.serving.fleet.worker"]
    assert av[3:] == jrouter.FleetRouter(
        "m", 2, base_argv=["m", "--slots", "2"], checkpoint="ck_v1",
        version="v1").worker_argv(1)[3:]
    r.note_reloaded("ck_v2", "v2")
    av2 = r.worker_argv(1)
    assert av2[av2.index("--model") + 1] == "ck_v2"
    assert av2[av2.index("--modelVersion") + 1] == "v2"
    assert not r.random_init


class _FakeProc:
    def __init__(self, rc=None):
        self.rc, self.pid = rc, 12345

    def poll(self):
        return self.rc


def _tables(seed, n=5):
    rs = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        rows.append(dict(
            alive=rs.rand() < 0.85, port=None if rs.rand() < 0.1 else 9000,
            state=str(rs.choice(["ready", "ready", "starting", "draining",
                                 "unreachable"])),
            draining=rs.rand() < 0.15, gave_up=rs.rand() < 0.1,
            status=None if rs.rand() < 0.1 else dict(
                index=i, queue_depth=int(rs.randint(4)),
                decode_active=int(rs.randint(3)),
                slo_burn=float(rs.choice([0.0, 0.0, 0.25, 0.5, 1.0])))))
    return rows, set(int(x) for x in rs.choice(n, rs.randint(3),
                                               replace=False))


def _pick(mod, ctl, rows, exclude, burn_weight):
    r = mod.FleetRouter("m", len(rows), base_argv=[], random_init=True,
                        burn_weight=burn_weight)
    for h, row in zip(r._handles, rows):
        h.proc = _FakeProc(None if row["alive"] else 1)
        h.port, h.state = row["port"], row["state"]
        h.draining, h.gave_up = row["draining"], row["gave_up"]
        h.status = (ctl.WorkerStatus(**row["status"]) if row["status"]
                    else None)
    try:
        pick = r.pick(exclude=exclude).index
    except mod.NoLiveWorker:
        pick = None
    return (pick, r.handle_readyz(), [h.describe() for h in r._handles],
            [h.score(burn_weight) for h in r._handles])


def test_pick_makes_the_jax_choice_on_the_same_tables():
    picks = []
    for seed in range(60):
        rows, exclude = _tables(seed)
        for w in (0.0, 4.0):
            got = _pick(router, control, rows, exclude, w)
            assert got == _pick(jrouter, jcontrol, rows, exclude, w)
            picks.append(got[0])
    assert None in picks and len(set(picks)) >= 4


def _pages():
    regs = []
    for w in range(3):
        reg = MetricsRegistry(clock=lambda: 5.0)
        reg.counter("requests_generate_total", "done").inc(3 + w)
        reg.histogram("ttft_ms", "ttft").observe(12.5 * (w + 1))
        reg.gauge("kv_pages_in_use", "pages", fn=lambda w=w: 4 * w)
        reg.gauge("broken", "nan", fn=lambda: 1 / 0)
        reg.set_provenance({"model": "m", "worker": w,
                            "q": 'say "hi"\\n'})
        regs.append(reg)
    pages = {str(w): r.render() for w, r in enumerate(regs)}
    pages["10"] = 'x_total{worker="0"} 5\nx_total{a="b"} 2\nbad line\n'
    return pages


def test_aggregate_pages_and_parse_samples_match_jax():
    pages = _pages()
    assert aggregate_pages(pages) == jaggregate(pages)
    assert aggregate_pages(pages, label="replica") == jaggregate(
        pages, label="replica")
    for page in pages.values():  # repr: NaN samples compare equal
        assert repr(parse_samples(page)) == repr(jparse_samples(page))
    out = aggregate_pages(pages)
    assert "bigdl_serving_requests_generate_total 12" in out
    assert 'bigdl_serving_requests_generate_total{worker="2"} 5' in out


# ------------------------------------------------------------- resolving
def test_resolve_serve_config_and_refusals():
    p = serve_cli.build_parser()
    cfg = common.resolve_serve_config(p.parse_args(
        ["transformer_lm", "--fleet", "3", "--quantize", "int8+kv8",
         "--speculate", "2", "--kvPageTokens", "64"]))
    assert cfg == common.ResolvedConfig(
        model="transformer_lm", quantize="int8+kv8", speculate=2,
        serving_replicas=1, serving_tp=1, fleet_workers=3)
    assert common.resolve_serve_config(p.parse_args(
        ["transformer_lm"])).quantize is None
    for argv, msg in ((["--fleet", "-1"], "--fleet -1"),
                      (["--speculate", "-2"], "--speculate -2"),
                      (["--fleet", "2", "--strategy", "tp:2"],
                       "--strategy: .*entry 13")):
        with pytest.raises(SystemExit, match=msg):
            common.resolve_serve_config(p.parse_args(["transformer_lm"]
                                                     + argv))
    # --lint (once refused, queue 1 entry 16) is resolved with the rest,
    # and a fleet passes it to its workers
    for argv, mode in (([], None), (["--lint"], "on"),
                       (["--lint", "strict"], "strict")):
        assert common.resolve_serve_config(p.parse_args(
            ["transformer_lm"] + argv)).lint_mode == mode
    assert router.worker_base_argv(["transformer_lm", "--fleet", "2",
                                    "--lint", "strict"]) == \
        ["transformer_lm", "--lint", "strict"]
    # serve's --strategy resolves as the JAX package's (abstractly, over
    # its 8 virtual devices, in a router that imports no torch)
    from bigdl_tpu.cli.common import parse_serving_strategy as jax_parse
    for spec in ("tp", "tp:2", "dp", "dp:4", "tp:8"):
        cfg = common.resolve_serve_config(p.parse_args(
            ["transformer_lm", "--strategy", spec]))
        assert (cfg.serving_replicas, cfg.serving_tp) == jax_parse(spec, 8)
        assert cfg.strategy == spec
    # the flags of the image models and the tuner are ported: accepted,
    # and a fleet passes them to its workers
    flags = ["--classes", "10", "--fusedBN", "apply", "--convLayout",
             "NHWC,NHWC,NHWC", "--convGeom", "g.json", "--autotune",
             "cached"]
    args = p.parse_args(["resnet20_cifar", "--fleet", "2"] + flags)
    assert common.resolve_serve_config(args).fleet_workers == 2
    assert (args.classes, args.fusedBN, args.autotune) == (10, "apply",
                                                           "cached")
    assert router.worker_base_argv(["resnet20_cifar", "--fleet", "2",
                                    "--port", "0"] + flags) == \
        ["resnet20_cifar"] + flags
    from bigdl_tpu_torch.serving.quant import QUANTIZE_CHOICES
    assert common.QUANTIZE_CHOICES == QUANTIZE_CHOICES


_NO_TORCH = r"""
import sys
sys.path.insert(0, ROOT)
from bigdl_tpu_torch.cli import fleet, main
from bigdl_tpu_torch.cli import common
from bigdl_tpu_torch.serving.fleet import router
args = fleet.build_parser().parse_args(["transformer_lm", "--randomInit",
                                        "--quantize", "int8"])
cfg = common.resolve_serve_config(args)
r = router.FleetRouter("m", args.fleet, base_argv=[], random_init=True)
page = r.handle_metrics()
assert cfg.fleet_workers == 2 and "bigdl_fleet_workers 2" in page
assert "torch" not in sys.modules, sorted(m for m in sys.modules
                                          if m.startswith("torch"))
print("ok")
"""


def test_the_router_process_imports_no_torch():
    out = subprocess.run([sys.executable, "-c",
                          _NO_TORCH.replace("ROOT", repr(ROOT))],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_main_runs_fleet(capsys):
    from bigdl_tpu_torch.cli import main as cli_main
    with pytest.raises(SystemExit) as e:
        cli_main.main(["fleet", "--help"])
    assert e.value.code == 0
    assert "python -m bigdl_tpu_torch.cli.fleet" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--fleet must be >= 1"):
        cli_main.main(["fleet", "transformer_lm", "--fleet", "0"])
    with pytest.raises(SystemExit, match="fleet needs weights"):
        cli_main.main(["fleet", "transformer_lm"])


# ---------------------------------------------------------- the swap
VOCAB, D, LAYERS, HEADS, MAX_LEN = 50, 32, 2, 2, 64
LM_ARGS = ["transformer_lm", "--vocabSize", str(VOCAB), "--dModel", str(D),
           "--numLayers", str(LAYERS), "--numHeads", str(HEADS), "--seq",
           str(MAX_LEN), "--slots", "2", "--buckets", "1,2", "--maxWaitMs",
           "2", "--no-warmup", "--kvPageTokens", "8", "--prefixCache"]
PROMPT = [7, 3, 9, 1, 4]
SHARED = list(range(3, 11))  # one 8-token page
PROBE = SHARED + [5, 2]


def _random_tree(m, seed):
    """A seeded parameter tree of JAX model ``m`` (numpy draws on its
    shapes: the layer norms near 1, the embedding small, the products
    x3, so that greedy chains wander)."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[0] == "emb":
            return (0.05 * rs.standard_normal(s.shape)).astype(s.dtype)
        if keys[-1] == "weight" and keys[-2].startswith("ln"):
            return (1 + 0.1 * rs.standard_normal(s.shape)).astype(s.dtype)
        scale = 0.1 if len(s.shape) == 1 else 3 * s.shape[0] ** -0.5
        return (scale * rs.standard_normal(s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(m.init, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """JAX checkpoints v1 and v2 of one tiny LM, and each version's JAX
    engine tokens of PROMPT and PROBE (they differ between versions)."""
    root = tmp_path_factory.mktemp("torch_fleet")
    m = jax_models.transformer_lm(VOCAB, d_model=D, num_layers=LAYERS,
                                  num_heads=HEADS, max_len=MAX_LEN)
    out = {"model": m}
    eng = None
    for ver, key in (("v1", 1), ("v2", 2)):
        params = _random_tree(m, key)
        d = root / ver
        save_pytree({"params": params, "mod_state": m.init_state()},
                    str(d / "model.1"))
        if eng is None:
            eng = JaxDecodeEngine(m, params, slots=1)
        eng.params = params  # the compiled programs take the tree
        out[ver] = dict(path=str(d), params=params,
                        prompt=eng.generate(PROMPT, 8),
                        probe=eng.generate(PROBE, 8))
    eng.close()
    assert out["v1"]["prompt"] != out["v2"]["prompt"]
    assert out["v1"]["probe"] != out["v2"]["probe"]
    return out


def _app(ckpt, version, extra=()):
    args = serve_cli.build_parser().parse_args(
        LM_ARGS + ["--platform", "cpu", "--model", ckpt, "--modelVersion",
                   version] + list(extra))
    app, _, _, _ = serve_cli.build_app(args)
    return app


def _gen(app, prompt, n=8):
    st, out = app.dispatch_post("/generate", {"tokens": prompt,
                                              "max_new_tokens": n})
    assert st == 200, out
    return out["tokens"]


def _slow(app, step_s):
    step = app.decoder.step

    def slow():
        time.sleep(step_s)
        return step()

    app.decoder.step = slow


def test_swap_waits_for_in_flight_work_then_serves_the_new_weights(ckpts):
    app = _app(ckpts["v1"]["path"], "v1")
    try:
        _slow(app, 0.01)
        predict = app.batcher.predict_fn
        started, release = threading.Event(), threading.Event()

        def held_predict(x, **kw):
            started.set()
            release.wait(10)
            return predict(x, **kw)

        app.batcher.predict_fn = held_predict
        rows = {"inputs": [PROMPT]}
        res = {}
        th = [threading.Thread(target=lambda: res.__setitem__(
                  "gen", _gen(app, PROMPT, 16))),
              threading.Thread(target=lambda: res.__setitem__(
                  "pred", app.dispatch_post("/predict", dict(
                      rows, return_scores=True))))]
        for t in th:
            t.start()
        started.wait(10)
        while not app.decoder.queue_load():
            time.sleep(0.001)
        assert app.batcher.in_flight() == 1  # the flush being computed
        done = threading.Event()
        sw = threading.Thread(target=lambda: (swap.swap_app_weights(
            app, ckpts["v2"]["path"], "v2"), done.set()))
        sw.start()
        time.sleep(0.1)
        assert not done.is_set() and app.model_version == "v1"
        release.set()
        for t in th + [sw]:
            t.join(30)
        assert done.is_set() and app.model_version == "v2"
        assert res["gen"][:8] == ckpts["v1"]["prompt"]
        # the /predict flush computed wholly on v1
        app.batcher.predict_fn = predict
        st, after = app.dispatch_post("/predict", dict(rows,
                                                       return_scores=True))
        assert res["pred"][0] == st == 200
        assert res["pred"][1]["scores"] != after["scores"]
        assert _gen(app, PROMPT) == ckpts["v2"]["prompt"]
        assert '"model_version": "v2"' in app.handle_metrics()
    finally:
        app.close()


def test_a_failed_swap_keeps_the_old_weights(ckpts, tmp_path):
    app = _app(ckpts["v1"]["path"], "v1")
    try:
        other = jax_models.transformer_lm(VOCAB, d_model=64,
                                          num_layers=LAYERS,
                                          num_heads=HEADS, max_len=MAX_LEN)
        save_pytree({"params": _random_tree(other, 0),
                     "mod_state": other.init_state()},
                    str(tmp_path / "wide" / "model.1"))
        (tmp_path / "empty").mkdir()
        for bad, msg in ((str(tmp_path / "wide"), "model has"),
                         (str(tmp_path / "empty"), "no model.<n>"),
                         (str(tmp_path / "none"), "restore failed")):
            with pytest.raises(swap.WeightSwapError, match=msg):
                swap.swap_app_weights(app, bad, "v9")
            assert app.model_version == "v1"
            assert _gen(app, PROMPT) == ckpts["v1"]["prompt"]
        _slow(app, 0.02)
        fut = app.decoder.submit(PROMPT, 30)
        with pytest.raises(swap.WeightSwapError, match="drain timeout"):
            swap.swap_app_weights(app, ckpts["v2"]["path"], "v2",
                                  drain_timeout_s=0.05)
        assert fut.result(30)[:8] == ckpts["v1"]["prompt"]
        assert _gen(app, PROMPT) == ckpts["v1"]["prompt"]
        wc = WorkerControl(app, index=1, version="v1")
        assert wc.handle_reload({"checkpoint": str(tmp_path / "wide"),
                                 "version": "v3"})[0] == 503
        assert wc.status().state == "ready" and app.model_version == "v1"
    finally:
        app.close()


def test_swap_under_quantize_rewrites_the_8bit_buffers(ckpts):
    app = _app(ckpts["v1"]["path"], "v1", ["--quantize", "int8"])
    ref = _app(ckpts["v2"]["path"], "v2", ["--quantize", "int8"])
    try:
        from bigdl_tpu_torch.serving.quant import QuantizedWeight
        qs = [m for m in app.decoder.model.modules()
              if isinstance(m, QuantizedWeight)]
        before = [(id(q.q), q.q.data_ptr()) for q in qs]
        swap.swap_app_weights(app, ckpts["v2"]["path"], "v2")
        assert [(id(q.q), q.q.data_ptr()) for q in qs] == before
        for a, b in zip(qs, [m for m in ref.decoder.model.modules()
                             if isinstance(m, QuantizedWeight)]):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        assert _gen(app, PROMPT) == _gen(ref, PROMPT)
    finally:
        app.close()
        ref.close()


def test_swap_clears_the_prefix_cache_the_jax_swap_keeps(ckpts):
    """After a swap a prompt sharing a prefix cached under the old
    weights gives the new weights' tokens (a stated difference: the JAX
    swap keeps the cache, so the same prompt reuses the old K/V)."""
    app = _app(ckpts["v1"]["path"], "v1")
    try:
        _gen(app, SHARED + [0], 2)
        pfx = app.decoder._pfx
        hits = pfx.hits
        assert _gen(app, PROBE) == ckpts["v1"]["probe"] and \
            pfx.hits == hits + 1
        swap.swap_app_weights(app, ckpts["v2"]["path"], "v2")
        assert pfx.cached_pages() == 0
        assert app.decoder.kv_pages_in_use() == 0
        assert _gen(app, PROBE) == ckpts["v2"]["probe"]
        assert pfx.hits == hits + 1  # a miss: nothing old was reused
    finally:
        app.close()
    # the JAX package's swap on the same traffic: the probe hits the
    # prefix cached under v1 after the swap to v2
    jargs = jserve_cli.build_parser().parse_args(
        LM_ARGS + ["--model", ckpts["v1"]["path"], "--modelVersion", "v1"])
    jcommon.apply_platform(jargs)
    japp, _, _, _ = jserve_cli.build_app(jargs)
    try:
        japp.handle_generate({"tokens": SHARED + [0], "max_new_tokens": 2})
        jswap.swap_app_weights(japp, ckpts["v2"]["path"], "v2")
        hits = japp.decoder._pfx.hits
        st, out = japp.handle_generate({"tokens": PROBE,
                                        "max_new_tokens": 8})
        assert st == 200 and japp.decoder._pfx.hits == hits + 1
        assert out["tokens"] != ckpts["v2"]["probe"]
    finally:
        japp.close()


def test_worker_control_surface(ckpts):
    app = _app(ckpts["v1"]["path"], "v1", ["--reqTrace", "on", "--slo",
                                           "ttft=1000"])
    try:
        wc = WorkerControl(app, index=2, version="v1", port=1234)
        assert ("GET", control.CONTROL_PATH) in app.extra_routes
        st, body = wc.handle_state()
        assert st == 200 and set(body) == set(jcontrol.WorkerStatus(
            index=0).to_dict())
        assert (body["index"], body["port"], body["state"],
                body["model_version"], body["queue_depth"]) == (
            2, 1234, "ready", "v1", 0)
        for payload in ({}, {"checkpoint": "x"}, {"checkpoint": "x",
                        "version": "v", "drain_timeout_s": "soon"}):
            assert wc.handle_reload(payload)[0] == 400
        st, body = wc.handle_reload({"checkpoint": ckpts["v2"]["path"],
                                     "version": "v2"})
        assert (st, body) == (200, {"status": "reloaded", "version": "v2"})
        assert wc.status().model_version == "v2"
    finally:
        app.close()
        from bigdl_tpu_torch.serving import reqtrace
        reqtrace.set_request_tracer(None)


# ------------------------------------------- router e2e (fake workers)
_FAKE_WORKER = r"""
import json, sys, time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
idx = int(sys.argv[1])
me = {"state": "ready", "version": "vF"}
class H(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def _j(self, code, obj):
        d = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("x-request-id", self.headers.get("x-request-id",
                                                          ""))
        self.send_header("x-model-version", me["version"])
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(d)))
        self.end_headers()
        self.wfile.write(d)
    def do_GET(self):
        if self.path == "/control/state":
            self._j(200, {"index": idx, "state": me["state"],
                          "queue_depth": 0, "decode_active": 0,
                          "model_version": me["version"]})
        elif self.path == "/metrics":
            d = ("bigdl_serving_requests_generate_total %d\n" % (idx + 1)
                 ).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(d)))
            self.end_headers()
            self.wfile.write(d)
        else:
            self._j(200, {"ok": True, "worker": idx})
    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        if self.path == "/admin/reload":
            me["state"] = "reloading"
            time.sleep(0.3)
            me["version"], me["state"] = body["version"], "ready"
            self._j(200, {"status": "reloaded", "version": body["version"]})
            return
        if not body.get("stream"):
            self._j(200, {"scores": [idx]})
            return
        self.send_response(200)
        self.send_header("x-model-version", "vF")
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for i in range(3):
            f = b'data: {"tokens": [%d]}\n\n' % i
            self.wfile.write(b"%x\r\n" % len(f) + f + b"\r\n")
            self.wfile.flush()
            time.sleep(0.3)
        self.wfile.write(b"0\r\n\r\n")
        self.close_connection = True
    def log_message(self, *a):
        pass
srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
print("serving fake on http://127.0.0.1:%d" % srv.server_address[1],
      flush=True)
srv.serve_forever()
"""


@pytest.fixture
def fake_fleet(tmp_path):
    script = tmp_path / "fake_worker.py"
    script.write_text(_FAKE_WORKER)
    r = router.FleetRouter(
        "fake", 2, make_argv=lambda i: [sys.executable, str(script), str(i)],
        heartbeat_s=0.05, start_timeout_s=30.0,
        restart_policy=RetryPolicy(budget=3, base_s=0.05, multiplier=1.0,
                                   max_s=0.1, jitter=0.0, seed=0))
    srv = None
    try:
        r.start()
        srv = router.make_router_server(r, 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        yield r, srv.server_address[1]
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        r.close()


def _req(port, method, path, body=None, rid=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 **({"x-request-id": rid} if rid else {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_router_end_to_end_against_fake_workers(fake_fleet):
    r, port = fake_fleet
    st, body, _ = _req(port, "GET", "/readyz")
    assert st == 200 and body["workers_routable"] == 2
    st, body, hdr = _req(port, "POST", "/predict", {"inputs": [1]},
                         rid="rt-1")
    assert st == 200 and body["scores"][0] in (0, 1)
    assert hdr["x-request-id"] == "rt-1" and hdr["x-model-version"] == "vF"
    # SSE through the router: each chunk relayed as it arrives
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    data = json.dumps({"tokens": [1], "stream": True}).encode()
    t0 = time.monotonic()
    s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Length: %d"
              b"\r\nx-request-id: st-1\r\n\r\n" % len(data) + data)
    buf, first = b"", None
    while not buf.endswith(b"0\r\n\r\n"):
        chunk = s.recv(65536)
        if not chunk:
            break
        buf += chunk
        if first is None and b"data: " in buf:
            first = time.monotonic() - t0
    s.close()
    head, body = buf.split(b"\r\n\r\n", 1)
    assert b"x-request-id: st-1" in head and b"x-model-version: vF" in head
    assert body == b"".join(b"%x\r\n" % len(f) + f + b"\r\n" for f in (
        b'data: {"tokens": [%d]}\n\n' % i for i in range(3))) + b"0\r\n\r\n"
    assert first < 0.25  # not buffered until the worker's 0.9 s end
    # the router's /metrics: its own series, each worker's relabelled, sums
    page = r.handle_metrics()
    for needle in ("bigdl_fleet_workers 2", "# fleet aggregate",
                   "bigdl_serving_requests_generate_total 3",
                   'bigdl_serving_requests_generate_total{worker="1"} 2'):
        assert needle in page
    # SIGKILL worker 0: /readyz stays 200, the router restarts it
    h = r.worker_handles()[0]
    pid0 = h.proc.pid
    h.proc.kill()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        assert _req(port, "GET", "/readyz")[0] == 200
        if h.routable() and h.proc.pid != pid0:
            break
        time.sleep(0.02)
    assert h.routable() and h.restarts == 1 and h.proc.pid != pid0
    st, body, _ = _req(port, "GET", "/debug/fleet")
    assert [w["restarts"] for w in body["workers"]] == [1, 0]
    assert "bigdl_fleet_worker_restarts_total 1" in r.handle_metrics()
    # every worker gone, nothing restarts: the router's own 503, with a rid
    r._stop.set()
    r._monitor.join(5.0)
    for w in r.worker_handles():
        w.proc.kill()
        w.proc.wait(5.0)
    st, body, hdr = _req(port, "POST", "/predict", {"inputs": [1]},
                         rid="rt-dead")
    assert st == 503 and body["error"] == "no live fleet worker"
    assert hdr["x-request-id"] == "rt-dead"
    assert _req(port, "GET", "/readyz")[0] == 503
    st, _, hdr = _req(port, "POST", "/generate", {"tokens": [1]})
    assert st == 503 and hdr["x-request-id"]


def test_rolling_reload_through_the_router_keeps_serving(fake_fleet):
    """Traffic through the router during a rolling reload of the fake
    workers: every answer 200, from the old version or the new; each
    worker rejoins as the heartbeat the reload read says, so the next
    worker's drain never leaves none routable."""
    r, port = fake_fleet
    got, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            st, _, hdr = _req(port, "POST", "/predict", {"inputs": [1]})
            got.append((st, hdr.get("x-model-version")))

    th = [threading.Thread(target=client) for _ in range(3)]
    for t in th:
        t.start()
    time.sleep(0.2)
    st, body, _ = _req(port, "POST", "/admin/reload",
                       {"checkpoint": "ck2", "version": "v2"})
    time.sleep(0.2)
    stop.set()
    for t in th:
        t.join(10)
    assert st == 200 and [w["status"] for w in body["workers"]] == [
        "reloaded", "reloaded"]
    assert {s for s, _ in got} == {200}
    assert {v for _, v in got} == {"vF", "v2"}
    assert r.version == "v2" and r.checkpoint == "ck2"


def test_router_fails_over_on_a_connect_failure():
    r = router.FleetRouter("m", 2, base_argv=[], random_init=True)
    closed = socket.socket()
    closed.bind(("127.0.0.1", 0))
    dead_port = closed.getsockname()[1]
    closed.close()
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Worker(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            d = json.dumps({"worker": 1, "path": self.path}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(d)))
            self.end_headers()
            self.wfile.write(d)

        def log_message(self, *a):
            pass

    live = ThreadingHTTPServer(("127.0.0.1", 0), _Worker)
    for h, p in zip(r._handles, (dead_port, None)):
        h.proc, h.port, h.state = _FakeProc(), p, "ready"
        h.status = control.WorkerStatus(index=h.index)
    r._handles[1].port = live.server_address[1]
    r._handles[1].status = control.WorkerStatus(index=1, queue_depth=3)
    threading.Thread(target=live.serve_forever, daemon=True).start()
    srv = router.make_router_server(r, 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        # worker 0 scores lower but refuses the connect: worker 1 answers
        st, body, _ = _req(srv.server_address[1], "GET", "/debug/slots")
        assert (st, body) == (200, {"worker": 1, "path": "/debug/slots"})
        assert r._m_reroutes.value == 1
    finally:
        for s in (srv, live):
            s.shutdown()
            s.server_close()


def test_run_fleet_refuses_before_any_worker_boots():
    ns = serve_cli.build_parser().parse_args(["transformer_lm", "--fleet",
                                              "2", "--randomInit",
                                              "--strategy", "dp:2"])
    with pytest.raises(SystemExit, match="--strategy: .*entry 13"):
        router.run_fleet(ns, [])
    ns = argparse.Namespace(**dict(vars(ns), later_strategy=None, fleet=0))
    with pytest.raises(SystemExit, match="a fleet needs >= 1 worker"):
        router.run_fleet(ns, [])
