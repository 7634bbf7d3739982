"""The port's quantized serving (bigdl_tpu_torch.serving.quant and the kv8
pools of serving.kv_pages) against the JAX package's, on the CPU:
``parse_quantize``; ``quantize_weight`` and ``quantize_params`` (int8 and
fp8 ``q`` and ``scale`` bit for bit); the dequant folded into the product
(epilogue, the tied head's prologue, the embedding gather); a quantized
LM's log-probs against the JAX quantized LM's; ``kv_quant_rows`` and
``kv_fake_quant`` bit for bit; a kv8 pool gathered back equal to
``kv_fake_quant`` of what was written (scatter, per-token writes, page
copies); ``quant_report``; the engines with int8/fp8 weights and kv8
pools against the JAX engine's greedy tokens, with speculation and the
prefix cache; ``--quantize off`` serving the model as it is; the
``/predict`` engine and its provenance.

Tolerances: every quantized tensor bit for bit; log-probs of the quantized
LM against JAX's at 1e-4 (f32, a few layers, sums in other orders); the
folded products against the dequantized weight's at 1e-5; greedy tokens
exactly; quant_report agreement >= 0.99 (the JAX test's bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.serving import kv_pages as jkvp
from bigdl_tpu.serving import quant as jq
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import DecodeEngine, InferenceEngine
from bigdl_tpu_torch.serving import kv_pages as kvp
from bigdl_tpu_torch.serving import quant as q

VOCAB, D, LAYERS, HEADS, KV_HEADS, MAX_LEN = 50, 32, 2, 2, 1, 64
LOGP_ATOL = 1e-4
PROD_ATOL = 1e-5
PROMPTS = [[3, 9, 44, 1], [7, 7, 12, 30, 2], [49, 1, 2], [8, 41]]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: torch's intra-op threads only add spinning,
    and beside other test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    """A RoPE GQA LM in both packages from one JAX tree (weights x3, the
    embedding x0.05, so the greedy chains wander)."""
    kw = dict(d_model=D, num_layers=LAYERS, num_heads=HEADS,
              pos_encoding="rope", num_kv_heads=KV_HEADS)
    jm = jax_models.transformer_lm(VOCAB, max_len=MAX_LEN, **kw)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(3),
                                    jm.init(jax.random.PRNGKey(1)))
    params["emb"]["weight"] = params["emb"]["weight"] * np.float32(0.05)
    pm = TransformerLM(VOCAB, max_len=MAX_LEN, **kw).load_jax_params(params)
    return jm, params, pm.eval()


def _jax_tokens(jm, params, prompts, n=8, **kw):
    eng = JaxDecodeEngine(jm, params, slots=2, **kw)
    try:
        return [eng.generate(p, n) for p in prompts]
    finally:
        eng.close()


def _port_tokens(pm, prompts, n=8, **kw):
    eng = DecodeEngine(pm, slots=2, device="cpu", **kw)
    try:
        return [eng.generate(p, n) for p in prompts]
    finally:
        eng.close()


# ---------------------------------------------------------- mode parsing
def test_parse_quantize_matches_jax():
    for mode in (None,) + q.QUANTIZE_CHOICES:
        assert q.parse_quantize(mode) == jq.parse_quantize(mode)
    assert q.QUANTIZE_CHOICES == jq.QUANTIZE_CHOICES
    assert q.fp8_supported() and jq.fp8_supported()
    with pytest.raises(ValueError, match="--quantize"):
        q.parse_quantize("int4")


# ------------------------------------------------------------ the weights
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_weight_matches_jax_bit_for_bit(fmt):
    """Random weights with a column of zeros (the eps floor) and large
    values: ``q`` and ``scale`` equal the JAX package's exactly."""
    rs = np.random.RandomState(2)
    w = (rs.randn(96, 40) * rs.uniform(0.01, 30, 40)).astype(np.float32)
    w[:, 7] = 0.0
    ref = jq.quantize_weight(jnp.asarray(w), fmt)
    got = q.quantize_weight(torch.from_numpy(w), fmt)
    assert got.fmt == ref.fmt == fmt
    assert np.array_equal(got.scale.numpy(), np.asarray(ref.scale))
    want_q = np.asarray(ref.q)
    got_q = got.q.numpy() if fmt == "int8" else \
        got.q.view(torch.uint8).numpy()
    if fmt == "fp8":
        want_q = want_q.view(np.uint8)
        assert got.q.dtype == torch.float8_e4m3fn
    assert np.array_equal(got_q, want_q)
    assert got.nbytes == ref.nbytes == 96 * 40 + 40 * 4
    with pytest.raises(ValueError, match="2-D"):
        q.quantize_weight(torch.zeros(3))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_params_matches_jax(lm, fmt):
    """Every eligible projection (the embedding, wq/wk/wv/wo, w1/w2) is
    quantized as the JAX tree's leaf at the same path, and nothing else;
    the caller's model is untouched, and quantizing again is a no-op."""
    jm, params, pm = lm
    ref = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, params),
                             fmt)
    qm = q.quantize_params(pm, fmt)
    flat = jax.tree_util.tree_flatten_with_path(ref, is_leaf=jq.is_quantized)
    want = {".".join(k.key for k in path): leaf for path, leaf in flat[0]
            if jq.is_quantized(leaf)}
    got = {n: m for n, m in qm.named_modules() if q.is_quantized(m)}
    assert sorted(got) == sorted(want) and len(got) == 1 + 6 * LAYERS
    for name, w in got.items():
        assert np.array_equal(w.scale.numpy(), np.asarray(want[name].scale))
        assert np.array_equal(w.q.view(torch.uint8).numpy(),
                              np.asarray(want[name].q).view(np.uint8))
    assert not any(q.is_quantized(m) for m in pm.modules())
    assert q.quantize_params(qm, fmt) is qm
    assert q.quantize_params(pm, None) is pm
    assert q.weight_bytes(qm) < q.weight_bytes(pm) / 3


def test_folded_products_match_the_dequantized_weight():
    """``x @ w.to(dt)`` (epilogue), the tied head's ``h @ w.to(dt).T``
    (prologue) and the embedding gather, against the dequantized weight."""
    rs = np.random.RandomState(4)
    w = torch.from_numpy(rs.randn(50, 32).astype(np.float32))
    x = torch.from_numpy(rs.randn(4, 50).astype(np.float32))
    h = torch.from_numpy(rs.randn(4, 32).astype(np.float32))
    qw = q.quantize_weight(w, "int8")
    dq = qw.dequantize()
    torch.testing.assert_close(x @ qw.to(x.dtype), x @ dq, rtol=0,
                               atol=PROD_ATOL)
    torch.testing.assert_close(h @ qw.to(h.dtype).T, h @ dq.T, rtol=0,
                               atol=PROD_ATOL)
    idx = torch.tensor([[0, 7, 49]])
    torch.testing.assert_close(qw.take_rows(idx), dq[idx], rtol=0,
                               atol=1e-6)
    assert qw.shape == (50, 32)
    # a model's cast moves devices only: the 8-bit tensor keeps its dtype
    qw.to(torch.float64)  # a dtype alone is the multiply's view
    qw.half()
    assert qw.q.dtype == torch.int8 and qw.scale.dtype == torch.float32


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_logprobs_match_jax(lm, fmt):
    """The quantized LM's log-probs against the JAX quantized LM's, on the
    JAX init's own scale (the fixture's x3 weights put the log-probs near
    10, where f32 sums in another order move them past 1e-4)."""
    jm, _, _ = lm
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    pm = TransformerLM(VOCAB, max_len=MAX_LEN, d_model=D, num_layers=LAYERS,
                       num_heads=HEADS, pos_encoding="rope",
                       num_kv_heads=KV_HEADS).load_jax_params(params).eval()
    toks = np.random.RandomState(5).randint(0, VOCAB, (2, 24)).astype(
        np.int32)
    qp = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, params), fmt)
    ref, _ = jm.apply(qp, jm.init_state(), jnp.asarray(toks))
    with torch.no_grad():
        got = q.quantize_params(pm, fmt)(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=LOGP_ATOL)


# ------------------------------------------------------------- kv8 pools
def test_kv_quant_rows_and_fake_quant_match_jax():
    rs = np.random.RandomState(6)
    v = (rs.randn(3, 2, 5, 16) * rs.uniform(0, 4, (3, 2, 5, 1))).astype(
        np.float32)
    v[0, 0, 0] = 0.0  # an all-zero row: the eps floor
    rq, rs_ = jkvp.kv_quant_rows(jnp.asarray(v))
    gq, gs = kvp.kv_quant_rows(torch.from_numpy(v))
    assert np.array_equal(gq.numpy(), np.asarray(rq))
    assert np.array_equal(gs.numpy(), np.asarray(rs_))
    assert np.array_equal(q.kv_fake_quant(torch.from_numpy(v)).numpy(),
                          np.asarray(jq.kv_fake_quant(jnp.asarray(v))))


def _kv8(pm, slots=2, page_tokens=16):
    return kvp.PagedKvCache(pm.encoder, slots=slots, max_len=MAX_LEN,
                            page_tokens=page_tokens, dtype=torch.float32,
                            device="cpu", quantized=True)


def test_kv8_pool_gathers_back_to_fake_quant(lm):
    """A cache scattered into kv8 pages and gathered back equals
    ``kv_fake_quant`` of it, bit for bit, and the JAX pools' gather; a
    per-token write quantizes its row alone; copied pages read the same
    bits (no second quantization)."""
    jm, _, pm = lm
    kv, ref = _kv8(pm, slots=3), jkvp.PagedKvCache(
        jm.encoder, slots=3, max_len=MAX_LEN, page_tokens=16,
        dtype=jnp.float32, quantized=True)
    for c in (kv, ref):
        assert c.reserve(0, 64) and c.reserve(1, 64)
    rs = np.random.RandomState(7)
    dense = [{n: rs.randn(1, KV_HEADS, 64, D // HEADS).astype(np.float32)
              for n in ("k", "v")} for _ in range(LAYERS)]
    pages = kv.page_table[0]
    kvp.scatter_pages(kv.pools, [{n: torch.from_numpy(a) for n, a in
                                  layer.items()} for layer in dense], pages)
    got = kvp.gather_cache(kv.pools, pages)
    jpools = jkvp.scatter_pages(ref.pools, dense, jnp.asarray(
        ref.page_table[0]))
    jgot = iter(jax.tree_util.tree_leaves(jkvp.gather_cache(
        jpools, jnp.asarray(ref.page_table[0]))))  # layer by layer, k, v
    for layer, want in zip(got, dense):
        for n in ("k", "v"):
            fq = q.kv_fake_quant(torch.from_numpy(want[n][0]))
            assert torch.equal(layer[n], fq)
            assert np.array_equal(layer[n].numpy(), np.asarray(next(jgot)))
    # one token's row, written at offset 5 of the slot's first page
    tok = [{n: torch.from_numpy(rs.randn(1, KV_HEADS, D // HEADS).astype(
        np.float32)) for n in ("k", "v")} for _ in range(LAYERS)]
    kvp.scatter_tokens(kv.pools, tok, pages[:1], torch.tensor([5]))
    after = kvp.gather_cache(kv.pools, pages)
    for layer, t in zip(after, tok):
        assert torch.equal(layer["k"][:, 5], q.kv_fake_quant(t["k"])[0])
    # copied pages read back the same bits
    kvp.copy_pages(kv.pools, pages, kv.page_table[1])
    for a, b in zip(after, kvp.gather_cache(kv.pools, kv.page_table[1])):
        assert all(torch.equal(a[n], b[n]) for n in a)
    dense_bpp = kvp.PagedKvCache(pm.encoder, slots=2, max_len=MAX_LEN,
                                 page_tokens=16, dtype=torch.float32,
                                 device="cpu").bytes_per_page
    assert kv.bytes_per_page == ref.bytes_per_page
    assert kv.bytes_per_page / dense_bpp == (16 + 4) / (4 * 16)


# --------------------------------------------------------------- reports
def test_quant_report_agreement(lm):
    """int8 and fp8, with and without kv8: greedy agreement >= 0.99 and a
    small, nonzero logit error; identical models measure exactly 0."""
    _, _, pm = lm
    for fmt in ("int8", "fp8"):
        qm = q.quantize_params(pm, fmt)
        for kv8 in (False, True):
            rep = q.quant_report(pm, qm, prompt=PROMPTS[0],
                                 max_new_tokens=8, kv8=kv8)
            assert rep["steps"] == 8
            assert rep["agreement"] >= 0.99, (fmt, kv8, rep)
            assert 0.0 < rep["logit_max_err"] < 1.0, (fmt, kv8, rep)
    ident = q.quant_report(pm, pm, prompt=PROMPTS[0], max_new_tokens=4)
    assert ident == {"agreement": 1.0, "logit_max_err": 0.0, "steps": 4}


# ----------------------------------------------------------------- engines
@pytest.mark.parametrize("mode", ["int8", "fp8", "int8+kv8", "fp8+kv8"])
def test_quantized_engine_matches_jax_engine(lm, mode):
    """Paged engines with quantized weights (and kv8 pools) under slot
    churn: the port's greedy tokens equal the JAX engine's in the same
    mode, and equal the port's speculative ones with the prefix cache."""
    jm, params, pm = lm
    ref = _jax_tokens(jm, params, PROMPTS, kv_page_tokens=16, quantize=mode)
    assert _port_tokens(pm, PROMPTS, kv_page_tokens=16, quantize=mode) == ref
    shared = list(range(1, 17))
    prompts = [shared + [5, 9], shared + [30], shared + [2, 2, 7]]
    ref = _jax_tokens(jm, params, prompts, kv_page_tokens=16, quantize=mode)
    eng = DecodeEngine(pm, slots=2, device="cpu", kv_page_tokens=16,
                       prefix_cache=True, speculate=3, quantize=mode)
    assert [eng.generate(p, 8) for p in prompts] == ref
    assert eng._pfx.hits >= 1


def test_kv8_prefix_hit_equals_kv8_prefill(lm):
    """A prefix hit copies int8 pages and scales: its slot's pages read
    back exactly what prefilling the same prompt into kv8 pools wrote."""
    _, _, pm = lm
    shared = list(range(1, 33))
    hit = DecodeEngine(pm, slots=1, device="cpu", kv_page_tokens=16,
                       prefix_cache=True, quantize="kv8")
    hit.generate(shared + [4], 1)
    fut = hit.submit(shared + [9], 2)
    cold = DecodeEngine(pm, slots=1, device="cpu", kv_page_tokens=16,
                        quantize="kv8")
    cold.submit(shared + [9], 2)
    assert hit._pfx.hits == 1
    a = kvp.gather_cache(hit._kv.pools, hit._kv.page_table[0])
    b = kvp.gather_cache(cold._kv.pools, cold._kv.page_table[0])
    for la, lb in zip(a, b):  # the two copied pages of the shared prefix
        assert all(torch.equal(la[n][:, :32], lb[n][:, :32]) for n in la)
    while not fut.done():
        hit.step()


def test_quantize_off_serves_the_model_and_kv8_needs_pages(lm):
    jm, params, pm = lm
    base = _port_tokens(pm, PROMPTS[:2])
    for mode in (None, "off"):
        eng = DecodeEngine(pm, slots=2, device="cpu", quantize=mode)
        assert eng.model is pm and eng.quantize == "off"
        assert [eng.generate(p, 8) for p in PROMPTS[:2]] == base
    with pytest.raises(ValueError, match="kv_page_tokens"):
        DecodeEngine(pm, device="cpu", quantize="kv8")
    with pytest.raises(ValueError, match="kv_page_tokens"):
        JaxDecodeEngine(jm, params, slots=2, quantize="kv8")


def test_inference_engine_quantized(lm):
    """``/predict`` through int8 weights: the quantized model's output,
    row for row, and ``quantize`` in the provenance."""
    _, _, pm = lm
    x = np.random.RandomState(8).randint(0, VOCAB, (3, 16)).astype(np.int32)
    eng = InferenceEngine(pm, buckets=(4,), device="cpu", quantize="int8")
    with torch.no_grad():
        ref = q.quantize_params(pm, "int8")(torch.from_numpy(x)).numpy()
    assert np.array_equal(eng.predict_scores(x), ref)
    assert eng.provenance()["quantize"] == "int8"
    assert InferenceEngine(pm, device="cpu").provenance()["quantize"] == "off"
    with pytest.raises(ValueError, match="--quantize"):
        InferenceEngine(pm, device="cpu", quantize="int4")
