"""The port's serving stack (bigdl_tpu_torch.serving) on the CPU: prompt
buckets and LM configs against the JAX package's, greedy tokens of the
port's DecodeEngine against the JAX DecodeEngine from the same parameters,
row-exact bucket padding, device sampling against the JAX package's warp
and distribution, the host-side batcher and watchdog, an in-process HTTP
round trip, and serving a JAX checkpoint paged with the prefix cache.
The CUDA graphs of the serving path are checked on the card
(``cuda``-marked here, and ``chip_smoke.py``)."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu.cli.perf import build_model as jax_build_model
from bigdl_tpu.ops.attention_kernel import \
    serving_prefill_buckets as jax_buckets
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.serving.spec_decode import warp_logits as jax_warp
from bigdl_tpu.utils import file as jfile
from bigdl_tpu_torch.cli import serve as serve_cli
from bigdl_tpu_torch.cli.perf import LM_CONFIGS, LM_VOCAB
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.ops import serving_prefill_buckets
from bigdl_tpu_torch.serving import (AdmissionError, DecodeEngine,
                                     InferenceEngine, MetricsRegistry,
                                     MicroBatcher, ServingApp, Watchdog,
                                     WorkerDied, make_server)
from bigdl_tpu_torch.serving.sampling import (sample_token, sample_tokens,
                                              warp_logits)

VOCAB, D, LAYERS, HEADS, MAX_LEN = 97, 64, 2, 4, 64
CONFIGS = {"sinusoidal_mha": dict(pos_encoding="sinusoidal"),
           "rope_gqa": dict(pos_encoding="rope", num_kv_heads=2)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def lm_pair(request):
    """JAX LM + params, and the port's LM loaded from the same tree (the
    embedding scaled down so the layers, not an echo, pick the tokens)."""
    kw = CONFIGS[request.param]
    jm = jax_models.transformer_lm(VOCAB, d_model=D, num_layers=LAYERS,
                                   num_heads=HEADS, max_len=MAX_LEN,
                                   attn_impl="flash", **kw)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(1)))
    params["emb"]["weight"] = params["emb"]["weight"] * np.float32(0.05)
    pm = TransformerLM(VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
                       max_len=MAX_LEN, attn_impl="flash", **kw)
    return jm, params, pm.load_jax_params(params).eval()


# ----------------------------------------------------- configs and buckets
@pytest.mark.parametrize("name", sorted(LM_CONFIGS))
def test_lm_configs_and_prefill_buckets_match_jax(name):
    jm, in_shape = jax_build_model(name)
    cfg = LM_CONFIGS[name]
    mha = jm.encoder._modules[0].mha
    assert (jm.vocab, jm.d_model, jm.max_len, jm.rope) == (
        LM_VOCAB, cfg["d_model"], cfg["max_len"],
        cfg["pos_encoding"] == "rope")
    assert len(jm.encoder._modules) == cfg["num_layers"]
    assert mha.num_heads == cfg["num_heads"]
    assert mha.num_kv_heads == (cfg["num_kv_heads"] or cfg["num_heads"])
    assert in_shape == (cfg["max_len"],)
    for dtype in (jnp.float32, jnp.bfloat16):
        assert serving_prefill_buckets(jm.max_len) == jax_buckets(
            jm.max_len, mha.head_dim, True, dtype)


# ------------------------------------------------------------ decode engine
def _drive(engine, prompts, max_new):
    futs = [engine.submit(p, max_new) for p in prompts]
    for _ in range(200):
        if all(f.done() for f in futs):
            break
        engine.step()
    return [f.result(0) for f in futs]


def test_decode_engine_matches_jax_engine(lm_pair):
    """Mixed prompt lengths (two buckets), more requests than slots: the
    port's greedy tokens equal the JAX engine's and the offline
    generate's, request by request."""
    jm, params, pm = lm_pair
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, VOCAB, n).tolist() for n in (3, 9, 21, 5, 17)]
    ref = _drive(JaxDecodeEngine(jm, params, slots=2), prompts, 6)
    got = _drive(DecodeEngine(pm, slots=2, device="cpu"), prompts, 6)
    assert got == ref
    for p, toks in zip(prompts, got):
        assert pm.generate([p], 6)[0].tolist() == toks
    assert any(toks[0] != p[-1] for p, toks in zip(prompts, got))


def test_decode_engine_admission_and_budget(lm_pair):
    _, _, pm = lm_pair
    reg = MetricsRegistry()
    de = DecodeEngine(pm, slots=1, max_waiting=0, metrics=reg, device="cpu")
    de.submit([1, 2], 2)
    with pytest.raises(AdmissionError):
        de.submit([3, 4], 2)
    assert reg._metrics["decode_rejected_total"].value == 1
    with pytest.raises(ValueError, match="exceeds"):
        de.submit(list(range(60)), 10)
    with pytest.raises(ValueError):
        de.submit([VOCAB], 2)  # out of the vocabulary
    kv_heads = pm.encoder[0].mha.num_kv_heads  # layers x (k, v) x f32
    assert reg._metrics["kv_cache_bytes"].value == (
        LAYERS * 2 * kv_heads * MAX_LEN * (D // HEADS) * 4)


def test_decode_engine_deadline_and_cancel(lm_pair):
    _, _, pm = lm_pair
    t = [0.0]
    de = DecodeEngine(pm, slots=1, clock=lambda: t[0], device="cpu")
    first = de.submit([1, 2, 3], 4, deadline=5.0)
    waiting = de.submit([4, 5], 3, rid="w")
    assert de.cancel("w") and not de.cancel("nope")
    with pytest.raises(RuntimeError, match="cancelled"):
        waiting.result(0)
    de.step()
    t[0] = 6.0
    de.step()  # expired before compute: the slot frees
    with pytest.raises(Exception, match="deadline"):
        first.result(0)
    assert not de.busy()


def test_decode_engine_later_features_refused(lm_pair):
    """Speculation and quantization are ported and build; what the engine
    refuses are the JAX package's errors: the prefix cache or kv8 without
    paging, a page size that does not divide max_len, a negative
    ``speculate`` and an unknown ``--quantize`` mode."""
    _, _, pm = lm_pair
    for kw, err, msg in (
            (dict(prefix_cache=True), ValueError, "requires kv_page_tokens"),
            (dict(quantize="kv8"), ValueError, "requires kv_page_tokens"),
            (dict(kv_page_tokens=13), ValueError, "divide"),
            (dict(speculate=-1), ValueError, "speculate"),
            (dict(quantize="int4"), ValueError, "--quantize")):
        with pytest.raises(err, match=msg):
            DecodeEngine(pm, device="cpu", **kw)
    spec = DecodeEngine(pm, device="cpu", speculate=2, quantize="int8")
    assert spec.speculate == 2 and spec.draft_model is spec.model
    assert spec.model is not pm and spec.quantize == "int8"


# ---------------------------------------------------------- inference engine
def test_inference_engine_padding_is_row_exact(lm_pair):
    _, _, pm = lm_pair
    reg = MetricsRegistry()
    eng = InferenceEngine(pm, buckets=(2, 4), metrics=reg, device="cpu")
    x = np.random.RandomState(8).randint(0, VOCAB, (7, 24)).astype(np.int32)
    got = eng.predict_scores(x)  # 4 + 3 padded to 4
    with torch.no_grad():
        ref = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (7, 24, VOCAB)
    assert np.array_equal(got, ref)
    assert reg._metrics["rows_total"].value == 7
    assert reg._metrics["padded_rows_total"].value == 1
    with pytest.raises(ValueError, match="token ids"):
        eng.validate(np.full((1, 4), VOCAB, np.int32))


def test_inference_engine_geometries_fixed_at_warmup(lm_pair):
    """With length buckets, rows of 40 distinct lengths run through the
    buckets x lengths geometries that warmup staged, and no other: each
    equals the unpadded forward (the LM is causal); a longer row or
    another dtype is refused; a graph set serves only what was captured."""
    _, _, pm = lm_pair
    lengths = serving_prefill_buckets(MAX_LEN)            # 16, 32, 64
    eng = InferenceEngine(pm, buckets=(1, 2), lengths=lengths,
                          device="cpu")
    eng.warmup((MAX_LEN,), np.int32)
    staged = set(eng._inputs)
    assert len(staged) == 2 * len(lengths)
    rs = np.random.RandomState(9)
    for n in range(1, 41):
        x = rs.randint(0, VOCAB, (1 + n % 2, n)).astype(np.int32)
        eng.validate(x)
        got = eng.predict_scores(x)
        with torch.no_grad():
            ref = pm(torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert set(eng._inputs) == staged
    for bad, msg in ((np.zeros((1, MAX_LEN + 1), np.int32), "serves 1 to"),
                     (np.zeros((1, 8), np.int64), "captured at start-up")):
        with pytest.raises(ValueError, match=msg):
            eng.validate(bad)
    eng.graphs.pool.enabled = True   # as on the card: replay, never capture
    with pytest.raises(KeyError, match="captured at start-up only"):
        eng.graphs.run(("unseen",), lambda: None)


# ------------------------------------------------------------------ sampling
@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.6), (0.9, 12, 0.8),
    (0.0, 3, 0.5)])
def test_warp_logits_matches_jax(temp, top_k, top_p):
    lg = np.random.RandomState(9).randn(97).astype(np.float32) * 3
    ref = jax_warp(jnp.asarray(lg), jnp.float32(temp), jnp.int32(top_k),
                   jnp.float32(top_p))
    got = warp_logits(torch.from_numpy(lg), temp, top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sample_token_seeded_and_greedy():
    lg = torch.from_numpy(np.random.RandomState(10).randn(50).astype(
        np.float32))
    assert sample_token(lg, 0.0, 0, 1.0, 1, 2) == int(torch.argmax(lg))
    draws = [sample_token(lg, 1.0, 5, 1.0, 3, p) for p in range(20)]
    again = [sample_token(lg, 1.0, 5, 1.0, 3, p) for p in range(20)]
    assert draws == again and len(set(draws)) > 1
    assert set(draws) <= set(torch.topk(lg, 5).indices.tolist())


GRID = [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.6), (0.9, 12, 0.8),
        (0.0, 3, 0.5), (0.8, 40, 0.9), (2.0, 1, 1.0), (0.5, 0, 0.3)]


def test_vectorised_warp_matches_jax_per_slot():
    """One pass over a slot per (temp, top_k, top_p) of GRID, the knobs as
    per-slot tensors: each row is the JAX warp of that row, bit for bit."""
    lg = np.random.RandomState(11).randn(len(GRID), 97).astype(
        np.float32) * 3
    temp, top_k, top_p = (torch.tensor(c) for c in zip(*GRID))
    got = warp_logits(torch.from_numpy(lg), temp.float(), top_k,
                      top_p.float()).numpy()
    for i, (t, k, p) in enumerate(GRID):
        ref = jax_warp(jnp.asarray(lg[i]), jnp.float32(t), jnp.int32(k),
                       jnp.float32(p))
        np.testing.assert_array_equal(got[i], np.asarray(ref))


def test_device_sampling_replays_its_seed(lm_pair):
    """The same seed draws the same tokens (an engine of a different slot
    count, slots in other orders), another seed others; with the filters
    off the warping program draws what the sort-free one draws; top_k = 1
    is greedy at any temperature."""
    _, _, pm = lm_pair
    kw = dict(temperature=0.8, top_k=12, top_p=0.9)
    a = DecodeEngine(pm, slots=2, device="cpu")
    b = DecodeEngine(pm, slots=3, device="cpu")
    b.submit([5, 6, 7], 4, temperature=1.0, seed=1)  # occupies slot 0
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    first = a.generate(prompt, 12, seed=9, **kw)
    assert b.generate(prompt, 12, seed=9, **kw) == first
    assert a.generate(prompt, 12, seed=10, **kw) != first
    assert a.generate(prompt, 12, temperature=1.3, top_k=1, seed=4) == \
        a.generate(prompt, 12)
    rs = np.random.RandomState(12)
    lg = torch.from_numpy(rs.randn(6, 97).astype(np.float32))
    knobs = (torch.arange(6) * 7, torch.full((6,), 0.9),
             torch.zeros(6, dtype=torch.long), torch.ones(6),
             torch.arange(6) + 100)
    assert torch.equal(sample_tokens(lg, *knobs, warp=True),
                       sample_tokens(lg, *knobs, warp=False))


def test_sampled_distribution_matches_jax():
    """4000 draws of one warped row (temperature 0.8, top_k 6, top_p 0.9)
    keyed by 4000 seeds, against jax.random.categorical's over 4000 keys
    and against the warped softmax: total variation below 0.04 (the
    expected TV of two samples of 4000 over the ~5 kept tokens is
    ~0.02)."""
    n = 4000
    lg = np.random.RandomState(13).randn(16).astype(np.float32)
    rows = torch.from_numpy(np.repeat(lg[None], n, 0))
    got = sample_tokens(rows, torch.zeros(n, dtype=torch.long),
                        torch.full((n,), 0.8), torch.full((n,), 6),
                        torch.full((n,), 0.9), torch.arange(n)).numpy()
    warped = jax_warp(jnp.asarray(lg), jnp.float32(0.8), jnp.int32(6),
                      jnp.float32(0.9))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    ref = np.asarray(jax.vmap(lambda k: jax.random.categorical(
        k, warped))(keys))
    p = np.asarray(jax.nn.softmax(warped))
    freq = lambda t: np.bincount(t, minlength=16) / n  # noqa: E731
    assert set(np.unique(got)) <= set(np.flatnonzero(p > 0))
    assert 0.5 * np.abs(freq(got) - freq(ref)).sum() < 0.04
    assert 0.5 * np.abs(freq(got) - p).sum() < 0.04


# --------------------------------------------------------- batcher, watchdog
def test_batcher_triggers_and_admission():
    t = [0.0]
    b = MicroBatcher(lambda x: x.sum(axis=1)[:, None], max_batch=3,
                     max_wait_ms=10, max_queue=3, clock=lambda: t[0],
                     start=False)
    futs = [b.submit(np.full(2, i, np.float32)) for i in range(2)]
    assert b.pump(0.005) == 0
    assert b.pump(0.011) == 2
    assert [f.result(0)[0] for f in futs] == [0.0, 2.0]
    for _ in range(3):
        b.submit(np.ones(2))
    with pytest.raises(AdmissionError):
        b.submit(np.ones(2))


def test_watchdog_declares_wedged_worker():
    t = [0.0]
    b = MicroBatcher(lambda x: x, clock=lambda: t[0], start=False)
    wd = Watchdog(stall_timeout_s=5.0, clock=lambda: t[0]).watch("b", b)
    fut = b.submit(np.ones(2))
    assert wd.check(1.0) == {"b": "ok"}
    t[0] = 10.0
    assert wd.check(10.0) == {"b": "wedged"} and not wd.ready()
    with pytest.raises(WorkerDied):
        fut.result(0)
    with pytest.raises(WorkerDied):
        b.submit(np.ones(2))


def test_watchdog_spares_a_decoder_woken_after_a_long_idle():
    """An idle decoder's heartbeat is as old as its idleness. The first
    request after more than the stall timeout starts the stall clock (its
    prefill runs under the lock, where the loop cannot beat), so the
    watchdog does not call the decoder wedged then; a decoder busy and
    silent past the timeout still is."""
    t = [0.0]
    pm = TransformerLM(VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
                       max_len=MAX_LEN, attn_impl="flash").eval()
    dec = DecodeEngine(pm, slots=2, device="cpu", clock=lambda: t[0])
    wd = Watchdog(stall_timeout_s=5.0, clock=lambda: t[0]).watch("d", dec)
    t[0] = 100.0  # idle, its loop never started
    assert not dec.busy() and wd.check(100.0) == {"d": "ok"}
    fut = dec.submit([1, 2, 3], 4)
    assert dec.busy() and wd.check(100.0) == {"d": "ok"}
    t[0] = 110.0
    assert wd.check(110.0) == {"d": "wedged"} and not wd.ready()
    with pytest.raises(WorkerDied):
        fut.result(0)


# --------------------------------------------------------------------- HTTP
def _post(port, path, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


def _serve(app):
    srv = make_server(app, "127.0.0.1", 0)
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    return srv, thr


def _stop(srv, thr, app):
    srv.shutdown()
    srv.server_close()
    app.close()
    thr.join(10.0)
    assert not thr.is_alive()


def test_serve_http_round_trip():
    args = serve_cli.build_parser().parse_args(
        ["transformer_lm", "--randomInit", "--platform", "cpu",
         "--vocabSize", "50", "--dModel", "32", "--numLayers", "2",
         "--numHeads", "2", "--seq", "64", "--slots", "2", "--buckets",
         "1,2,4", "--maxWaitMs", "2", "--port", "0"])
    app, eng, in_shape, in_dtype = serve_cli.build_app(args)
    assert in_shape == (64,) and in_dtype == np.int32
    srv, thr = _serve(app)
    port = srv.server_address[1]
    assert srv.request_queue_size >= 64  # a burst of clients is not dropped
    try:
        assert _get(port, "/healthz") == (
            200, '{"status": "ok", "model": "transformer_lm"}')
        st, body = _get(port, "/readyz")
        assert st == 200 and json.loads(body)["status"] == "ready"
        prompts = [[3, 1, 4, 1, 5], list(range(20))]
        outs = {}
        ths = [threading.Thread(
            target=lambda i, p: outs.__setitem__(i, _post(
                port, "/generate", {"tokens": p, "max_new_tokens": 6})),
            args=(i, p)) for i, p in enumerate(prompts)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
        for i, p in enumerate(prompts):
            st, out, _ = outs[i]
            assert st == 200 and out["prompt_len"] == len(p)
            assert out["tokens"] == app.decoder.model.generate(
                [p], 6)[0].tolist()
        toks = np.random.RandomState(0).randint(0, 50, (3, 64)).tolist()
        st, out, _ = _post(port, "/predict", {"inputs": toks})
        assert st == 200 and np.asarray(out["predictions"]).shape == (3, 64)
        assert _post(port, "/generate", {"tokens": [1] * 70,
                                         "max_new_tokens": 4})[0] == 400
        # a bad streamed request answers a plain JSON error
        assert _post(port, "/generate", {"tokens": [], "stream": True})[0] \
            == 400
        assert _post(port, "/predict", {"inputs": [[99, 1]]})[0] == 400
        st, page = _get(port, "/metrics")
        prov = json.loads([ln for ln in page.splitlines()
                           if ln.startswith("# provenance ")][0][13:])
        assert prov["decode_slots"] == 2 and prov["device"] == "cpu"
        assert "bigdl_serving_requests_generate_total 2" in page
        assert "bigdl_serving_generated_tokens_total 12" in page
        assert "bigdl_serving_rows_total 3" in page
        # rows of another length pad to a length bucket; past max_len: 400
        st, out, _ = _post(port, "/predict", {"inputs": [[5] * 40]})
        assert st == 200 and np.asarray(out["predictions"]).shape == (1, 40)
        assert _post(port, "/predict", {"inputs": [[5] * 65]})[0] == 400
    finally:
        _stop(srv, thr, app)


def test_serve_http_429_on_full_queue(lm_pair):
    _, _, pm = lm_pair
    reg = MetricsRegistry()
    eng = InferenceEngine(pm, buckets=(4,), device="cpu")
    batcher = MicroBatcher(eng.predict_scores, max_queue=1, start=False)
    app = ServingApp(name="t", metrics=reg, engine=eng, batcher=batcher)
    srv, thr = _serve(app)
    try:
        st, out, headers = _post(srv.server_address[1], "/predict",
                                 {"inputs": [[1, 2], [3, 4]]})
        assert st == 429 and "capacity" in out["error"]
        assert headers["Retry-After"] == "1"
        assert reg._metrics["request_errors_total"].value == 1
    finally:
        _stop(srv, thr, app)


class _DequantUpcast(torch.nn.Module):
    """A forward that multiplies an upcast bf16 activation by an f32 copy
    of an int8 weight (the lint's quant-dequant-upcast error)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("q", torch.ones(64, 16, dtype=torch.int8))
        self.register_buffer("s", torch.ones(16))

    def forward(self, x):
        return x.to(torch.bfloat16).float() @ (self.q.float() * self.s)


def test_serve_cli_refuses_what_is_not_ported():
    p = serve_cli.build_parser()
    for argv, msg in (
            (["transformer_lm", "--randomInit", "--platform", "cpu",
              "--strategy", "tp:2"], "runs 2 ranks.*torchrun"),
            (["transformer_lm", "--randomInit", "--platform", "cpu",
              "--strategy", "dp:2", "--devices", "cpu"],
             "needs 2 devices"),
            (["transformer_lm", "--randomInit", "--slo", "ttft_p99=1"],
             "--slo 'ttft_p99=1': unknown SLO dim"),
            (["transformer_lm", "--randomInit", "--platform", "cpu",
              "--speculate", "2", "--draftDims", "65,2,4"], "divisible"),
            (["transformer_lm", "--randomInit", "--platform", "cpu",
              "--seq", "100", "--quantize", "kv8"], "no page size"),
            (["alexnet_v9", "--randomInit", "--platform", "cpu"],
             "serve takes the transformer_lm"),
            (["lenet5", "--randomInit", "--platform", "cpu", "--quantize",
              "kv8"], "transformer_lm models only"),
            (["lenet5", "--randomInit", "--platform", "cpu",
              "--speculate", "2"], "transformer_lm models only"),
            (["transformer_lm", "--platform", "cpu"], "needs weights"),
            (["transformer_lm", "--randomInit", "--platform", "cpu",
              "--prefixCache"], "needs --kvPageTokens"),
            (["transformer_lm", "--randomInit", "--platform", "cpu",
              "--kvPageTokens", "100"], "must divide")):
        with pytest.raises(SystemExit, match=msg):
            serve_cli.build_app(p.parse_args(argv))
    assert serve_cli._page_tokens("auto", 1024) == 128
    assert serve_cli._page_tokens("auto", 96) == 32
    assert serve_cli._page_tokens("auto", 100) is None
    # --lint is ported (it was refused, queue 1 entry 16): strict refuses
    # to serve a model whose forward the lint finds an error in (an f32
    # product of a dequantized weight and an upcast bf16 activation)
    args = p.parse_args(["lenet5", "--randomInit", "--platform", "cpu",
                         "--lint", "strict"])
    assert args.lint == "strict"
    engine = InferenceEngine(
        _DequantUpcast(), buckets=(1, 2), device="cpu", graphs=False,
        lint="strict")
    assert engine.preflight_lint((64,), np.float32) == 2
    assert engine.lint_annotation["errors"] == 1


def test_serve_jax_checkpoint_paged_with_prefix_cache(tmp_path):
    """``serve --model CKPT --kvPageTokens auto --prefixCache`` on a
    checkpoint the JAX package wrote: over HTTP, the greedy tokens equal
    the JAX paged engine's on the same parameters, a request sharing a
    prefix is served from the prefix cache, and once traffic ends only
    the cache's pages stay in use."""
    jm = jax_models.transformer_lm(50, d_model=32, num_layers=2,
                                   num_heads=2, max_len=96)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(3)))
    params["emb"]["weight"] = params["emb"]["weight"] * np.float32(0.05)
    jfile.save_pytree({"params": params, "mod_state": jm.init_state()},
                      str(tmp_path / "ck" / "model.3"))
    args = serve_cli.build_parser().parse_args(
        ["transformer_lm", "--model", str(tmp_path / "ck"), "--platform",
         "cpu", "--vocabSize", "50", "--dModel", "32", "--numLayers", "2",
         "--numHeads", "2", "--seq", "96", "--slots", "2", "--kvPageTokens",
         "auto", "--prefixCache", "--port", "0", "--no-warmup"])
    app, _, _, _ = serve_cli.build_app(args)
    assert app.decoder.page_tokens == 32 and app.decoder._pfx is not None
    srv, thr = _serve(app)
    port = srv.server_address[1]
    shared = np.random.RandomState(4).randint(0, 50, 40).tolist()
    prompts = [shared, shared + [7, 8], [1, 2, 3]]
    try:
        got = [_post(port, "/generate", {"tokens": p, "max_new_tokens": 6})
               for p in prompts]
        st, page = _get(port, "/metrics")
    finally:
        _stop(srv, thr, app)
    ref = JaxDecodeEngine(jm, params, slots=2, kv_page_tokens=32)
    for p, (st_g, out, _) in zip(prompts, got):
        assert st_g == 200 and out["tokens"] == ref.generate(p, 6)
    assert "bigdl_serving_prefix_cache_hits_total 1" in page
    assert app.decoder.kv_pages_in_use() == app.decoder._pfx.cached_pages() \
        == 1
    prov = json.loads([ln for ln in page.splitlines()
                       if ln.startswith("# provenance ")][0][13:])
    assert prov["kv_page_tokens"] == 32 and prov["prefix_cache"] is True
    assert prov["cuda_graphs"] is False


@pytest.mark.cuda
def test_cuda_serving_graphs_match_eager():
    """On the card the decode engine replays CUDA graphs: greedy and
    sampled tokens, dense and paged with the prefix cache, equal the same
    engine's eager run, and flash_fwd launches count the replays; the
    inference engine's graphs, fixed at warmup, equal its eager run."""
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda unavailable")
    from bigdl_tpu_torch import ops
    pm = TransformerLM(VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
                       max_len=MAX_LEN, attn_impl="flash",
                       generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(14)
    prompts = [rs.randint(0, VOCAB, n).tolist() for n in (5, 20, 33, 40)]
    kws = [dict(), dict(temperature=0.8, top_k=10, top_p=0.9, seed=2)]
    for extra in (dict(), dict(kv_page_tokens=16, prefix_cache=True)):
        outs = []
        for graphs in (False, True):
            de = DecodeEngine(pm, slots=2, device="cuda", graphs=graphs,
                              **extra)
            ops.reset_kernel_launches()
            outs.append([de.generate(p, 8, **kw) for p in prompts
                         for kw in kws])
            assert ops.kernel_launches()["flash_fwd"] >= LAYERS
            de.close()
        assert outs[0] == outs[1]
    # /predict: one graph per (batch bucket, length bucket), captured at
    # warmup; rows of other lengths replay them and equal the eager run
    lengths = serving_prefill_buckets(MAX_LEN)
    engines = [InferenceEngine(pm, buckets=(1, 2), lengths=lengths,
                               device="cuda", graphs=g) for g in (False, True)]
    for e in engines:
        e.warmup((MAX_LEN,), np.int32)
    for n in (5, 16, 40, MAX_LEN):
        x = rs.randint(0, VOCAB, (2, n)).astype(np.int32)
        eager, graphed = (e.predict_scores(x) for e in engines)
        assert np.array_equal(eager, graphed)
    assert len(engines[1].graphs) == 2 * len(lengths)
