"""Streamed ``/generate`` in the port (``DecodeEngine.submit(emit=...)`` and
the server's SSE path) on the CPU: the emit sink sees every token once
and its tokens equal the buffered answer and the JAX engine's greedy
tokens; speculative rounds hand it only accepted tokens; the SSE frames
are the JAX handler's bytes; a client that goes away cancels its request
and frees its slot and pages; a bad streamed request gets a plain JSON
error; the first byte written is the TTFT the request tracer and the SLO
judge."""

import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.serving.server import _Handler as JaxHandler
from bigdl_tpu_torch.cli import serve as serve_cli
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import DecodeEngine, make_server
from bigdl_tpu_torch.serving import reqtrace as prt
from bigdl_tpu_torch.serving.server import _Handler

VOCAB, D, LAYERS, HEADS, MAX_LEN = 59, 32, 2, 2, 64
PROMPTS = [[3, 1, 4, 1, 5], list(range(2, 20)), [7], [9, 8, 7, 6, 5, 4, 3]]
N_NEW = 9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    jm = jax_models.transformer_lm(VOCAB, d_model=D, num_layers=LAYERS,
                                   num_heads=HEADS, max_len=MAX_LEN)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(4)))
    params["emb"]["weight"] = params["emb"]["weight"] * np.float32(0.05)
    pm = TransformerLM(VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
                       max_len=MAX_LEN).load_jax_params(params).eval()
    jeng = JaxDecodeEngine(jm, params, slots=2)
    ref = [jeng.generate(p, N_NEW) for p in PROMPTS]
    return pm, ref


def _stream(eng, prompts, n):
    """Submit every prompt with a sink, drive the loop; (per-request emit
    calls, per-request results)."""
    calls = [[] for _ in prompts]
    futs = [eng.submit(p, n, rid=f"s{i}",
                       emit=lambda new, done, i=i: calls[i].append(
                           (list(new), done)))
            for i, p in enumerate(prompts)]
    while not all(f.done() for f in futs):
        assert eng.step() > 0
    return calls, [f.result(0) for f in futs]


@pytest.mark.parametrize("paged", [False, True])
def test_emit_streams_every_token_as_buffered_and_jax(lm, paged):
    pm, ref = lm
    eng = DecodeEngine(pm, slots=2, device="cpu",
                       kv_page_tokens=16 if paged else None)
    calls, results = _stream(eng, PROMPTS, N_NEW)
    for c, res, want in zip(calls, results, ref):
        assert [t for toks, _ in c for t in toks] == res == want
        assert all(len(toks) == 1 for toks, _ in c)  # one a round
        assert [d for _, d in c] == [False] * (len(c) - 1) + [True]
    buffered = [eng.generate(p, N_NEW) for p in PROMPTS]
    assert buffered == ref
    eng.close()


@pytest.mark.parametrize("k", [2, 4])
def test_speculative_emit_gets_accepted_tokens_only(lm, k):
    pm, ref = lm
    eng = DecodeEngine(pm, slots=2, device="cpu", speculate=k)
    calls, results = _stream(eng, PROMPTS, N_NEW)
    for c, res, want in zip(calls, results, ref):
        assert [t for toks, _ in c for t in toks] == res == want
        assert all(1 <= len(toks) <= k + 1 for toks, _ in c)
        assert c[-1][1] and not any(d for _, d in c[:-1])
    # rounds that emitted more than one token: the sink got them together
    assert any(len(toks) > 1 for c in calls for toks, _ in c)
    eng.close()


def test_a_failing_sink_does_not_stop_decoding(lm):
    pm, ref = lm

    def bad(new, done):
        raise RuntimeError("sink broke")

    eng = DecodeEngine(pm, slots=2, device="cpu")
    fut = eng.submit(PROMPTS[0], N_NEW, emit=bad)
    other = eng.submit(PROMPTS[1], N_NEW)
    while not (fut.done() and other.done()):
        eng.step()
    assert fut.result(0) == ref[0] and other.result(0) == ref[1]
    eng.close()


def test_sse_frames_are_the_jax_bytes():
    for obj in ({"tokens": [1, 2, 3]}, {"tokens": []},
                {"done": True, "prompt_len": 5, "tokens_out": 9},
                {"error": "stream timeout"}, {"error": "ünï \"q\""}):
        assert _Handler._sse(obj) == JaxHandler._sse(obj)


# ------------------------------------------------------------------ HTTP
@pytest.fixture
def server(request, tmp_path):
    """An in-process server of a tiny LM (paged, two slots) with request
    tracing and an SLO; each decode round takes at least ``step_s``."""
    step_s = getattr(request, "param", 0.0)
    args = serve_cli.build_parser().parse_args(
        ["transformer_lm", "--randomInit", "--platform", "cpu",
         "--vocabSize", str(VOCAB), "--dModel", "32", "--numLayers", "2",
         "--numHeads", "2", "--seq", "64", "--slots", "2", "--buckets", "1",
         "--kvPageTokens", "16", "--port", "0", "--no-warmup",
         "--slo", "ttft=60000,tpot=60000",
         "--accessLog", str(tmp_path / "access.jsonl")])
    app, _, _, _ = serve_cli.build_app(args)
    step = app.decoder.step

    def slow_step():
        time.sleep(step_s)
        return step()

    app.decoder.step = slow_step
    srv = make_server(app, "127.0.0.1", 0)
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    yield app, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    app.close()
    thr.join(10)
    prt.set_request_tracer(None)


def _raw_stream(port, body, rid=None, read_frames=None):
    """(status line, headers, raw body bytes) of a POST /generate over a
    socket; with ``read_frames`` the socket closes after that many SSE
    frames arrived."""
    data = json.dumps(body).encode()
    head = (f"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Type: "
            f"application/json\r\nContent-Length: {len(data)}\r\n"
            + (f"x-request-id: {rid}\r\n" if rid else "") + "\r\n")
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.sendall(head.encode() + data)
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += s.recv(65536)
    hdr, body = buf.split(b"\r\n\r\n", 1)
    lines = hdr.decode().split("\r\n")
    headers = {k.lower(): v.strip() for k, _, v in
               (ln.partition(":") for ln in lines[1:])}
    while True:
        if read_frames is not None and body.count(b"data: ") >= read_frames:
            break
        if b"0\r\n\r\n" in body and body.endswith(b"0\r\n\r\n"):
            break
        if "content-length" in headers and len(body) >= int(
                headers["content-length"]):
            break
        chunk = s.recv(65536)
        if not chunk:
            break
        body += chunk
    s.close()
    return lines[0], headers, body


def _chunk(data: bytes) -> bytes:
    return b"%x\r\n" % len(data) + data + b"\r\n"


def _tokens(port, prompt):
    data = json.dumps({"tokens": prompt, "max_new_tokens": N_NEW}).encode()
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=data)
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())["tokens"]


def test_http_stream_wire_bytes_equal_buffered(server):
    app, port = server
    for i, p in enumerate(PROMPTS[:3]):
        status, hdr, body = _raw_stream(
            port, {"tokens": p, "max_new_tokens": N_NEW, "stream": True},
            rid=f"w{i}")
        toks = _tokens(port, p)
        assert status == "HTTP/1.1 200 OK"
        assert hdr["content-type"] == "text/event-stream"
        assert hdr["transfer-encoding"] == "chunked"
        assert hdr["x-request-id"] == f"w{i}" and hdr["x-model-version"] == \
            "v0"
        want = b"".join(_chunk(JaxHandler._sse({"tokens": [t]}))
                        for t in toks) + _chunk(JaxHandler._sse(
                            {"done": True, "prompt_len": len(p),
                             "tokens_out": len(toks)})) + b"0\r\n\r\n"
        assert body == want


def test_bad_streamed_request_gets_plain_json(server):
    app, port = server
    for bad, code in (({"tokens": [], "stream": True}, 400),
                      ({"tokens": [1] * 70, "stream": True}, 400),
                      ({"tokens": ["x"], "stream": True}, 400)):
        status, hdr, body = _raw_stream(port, bad, rid="bad-1")
        assert status.startswith(f"HTTP/1.1 {code}")
        assert hdr["content-type"] == "application/json"
        assert hdr["x-request-id"] == "bad-1"
        assert "error" in json.loads(body)
    rec = prt.get().recent()[-1]
    assert (rec.rid, rec.state, rec.status) == ("bad-1", "bad_request", 400)


@pytest.mark.parametrize("server", [0.02], indirect=True)
def test_disconnect_cancels_and_frees_slot_and_pages(server):
    app, port = server
    dec = app.decoder
    base = dec.kv_pages_in_use()
    cancelled = app.metrics._metrics["decode_cancelled_total"]
    _raw_stream(port, {"tokens": PROMPTS[1], "max_new_tokens": 40,
                       "stream": True}, rid="gone", read_frames=1)
    t0 = time.monotonic()
    while (cancelled.value < 1 or dec.kv_pages_in_use() != base) \
            and time.monotonic() - t0 < 20:
        time.sleep(0.01)
    assert cancelled.value == 1
    assert dec.kv_pages_in_use() == base and dec.queue_load() == 0
    assert all(s["state"] == "free" for s in dec.debug_snapshot()["slots"])
    rec = [r for r in prt.get().recent() if r.rid == "gone"][0]
    assert rec.state == "closed" and rec.tokens_out < 40
    # the freed slot serves the next request
    assert _tokens(port, PROMPTS[0]) == dec.model.generate(
        [PROMPTS[0]], N_NEW)[0].tolist()


@pytest.mark.parametrize("server", [0.01], indirect=True)
def test_first_byte_feeds_the_slo_ttft(server):
    app, port = server
    rt = prt.get()
    status, _, body = _raw_stream(port, {"tokens": PROMPTS[3],
                                         "max_new_tokens": 20,
                                         "stream": True}, rid="fb")
    assert status.endswith("200 OK") and b'"done": true' in body
    rec = [r for r in rt.recent() if r.rid == "fb"][0]
    assert rec.t_first_byte is not None
    assert rec.t_first_byte >= rec.t_first_token
    assert rec.ttft_ms() == pytest.approx(
        (rec.t_first_byte - rec.t_admit) * 1000.0)
    assert rec.status == 200 and rec.state == "finished"
    assert rt.slo.evaluate(rec) == []
    assert app.metrics._metrics["slo_requests_total"].value >= 1
    assert app.metrics._metrics["requests_generate_total"].value == 1
