"""The port's speculative decoding (bigdl_tpu_torch.serving.spec_decode and
``DecodeEngine(speculate=K)``) against the JAX package's, on the CPU:
``accept_chunk`` against the JAX function, greedy exactly, sampled with
the JAX function's own uniforms and Gumbel noise handed to the port's
rule, and against a numpy restatement of the JAX rule with the port's
draws; the emitted distribution against the target's; speculative greedy
decoding against plain greedy decoding and against the JAX engine's greedy
tokens from the same parameters (dense and paged, self-draft and a distinct
draft, K = 1..4, the prefix cache, the stop token, the max_len boundary,
concurrent slots); the acceptance counters; per-seed determinism.

Tolerances: greedy tokens and accepted counts exactly; the sampled rule
against JAX exactly (the same decisions from the same draws: the two f32
softmaxes differ by rounding only, far below these seeded rows' margins);
the emitted frequencies within 0.04 of the target's probabilities over
4000 seeds (the JAX test's bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.serving import spec_decode as jsd
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import DecodeEngine, MetricsRegistry
from bigdl_tpu_torch.serving import spec_decode as sd
from bigdl_tpu_torch.serving.sampling import (STREAM_ACCEPT, request_key,
                                              uniforms)

VOCAB, D, LAYERS, HEADS, KV_HEADS, MAX_LEN = 61, 64, 2, 4, 2, 96
PROMPTS = [[3, 9, 44, 1, 55, 2], [7, 7, 12], [60, 1, 2, 3, 4, 5, 6, 8]]
N_NEW = 20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: torch's intra-op threads only add spinning,
    and beside other test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_lm(params, max_len=MAX_LEN, **kw):
    return TransformerLM(VOCAB, max_len=max_len, **kw).load_jax_params(
        params).eval()


@pytest.fixture(scope="module")
def lms():
    """A RoPE GQA target and a one-layer sinusoidal draft in both packages
    from JAX trees. The target's weights are scaled x3 and its embedding
    down (x0.05), so its greedy chains wander instead of repeating a
    token; the JAX engine's greedy tokens of every prompt are kept."""
    tkw = dict(d_model=D, num_layers=LAYERS, num_heads=HEADS,
               pos_encoding="rope", num_kv_heads=KV_HEADS)
    jm = jax_models.transformer_lm(VOCAB, max_len=MAX_LEN, **tkw)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(3),
                                    jm.init(jax.random.PRNGKey(7)))
    params["emb"]["weight"] = params["emb"]["weight"] * np.float32(0.05)
    dkw = dict(d_model=32, num_layers=1, num_heads=2)
    jd = jax_models.transformer_lm(VOCAB, max_len=MAX_LEN, **dkw)
    dparams = jax.tree_util.tree_map(np.asarray,
                                     jd.init(jax.random.PRNGKey(123)))
    jeng = JaxDecodeEngine(jm, params, slots=2)
    shared = list(range(2, 25))
    prompts = PROMPTS + [shared, shared + [7, 8]]
    ref = {tuple(p): jeng.generate(p, N_NEW) for p in prompts}
    return dict(target=_port_lm(params, **tkw), draft=_port_lm(dparams, **dkw),
                params=params, tkw=tkw, jax=(jm, params, jd, dparams),
                ref=ref, shared=shared)


# --------------------------------------------------------------- accept rule
def _chunk(seed, s, m, v, match=()):
    """Random target logits (s, m, v), draft q rows (s, m-1, v) and
    proposals (s, m-1); proposal j of the slots in ``match`` is the
    target's argmax at j (a greedy acceptance)."""
    rs = np.random.RandomState(seed)
    t = (2.0 * rs.randn(s, m, v)).astype(np.float32)
    d = rs.randn(s, max(m - 1, 0), v).astype(np.float32)
    q = np.exp(d) / np.exp(d).sum(-1, keepdims=True)
    props = rs.randint(0, v, (s, m - 1)).astype(np.int32)
    for i, n in match:
        n = min(n, m - 1)
        props[i, :n] = t[i, :n].argmax(-1)
    return t, q.astype(np.float32), props


def _jax_accept(t, q, props, temp, seed, pos, draws=False):
    """The JAX ``accept_chunk`` over the slots, as its engine runs it
    (``jit(vmap(...))``), per slot; with ``draws``, also its acceptance
    uniforms and the residual's Gumbel noise."""
    s, m, v = t.shape
    em, ne, na = (np.asarray(x) for x in jax.jit(jax.vmap(jsd.accept_chunk))(
        jnp.asarray(t), jnp.asarray(q), jnp.asarray(props),
        jnp.asarray(temp, jnp.float32), jnp.zeros(s, jnp.int32),
        jnp.ones(s, jnp.float32), jnp.asarray(seed, jnp.uint32),
        jnp.asarray(pos, jnp.int32)))
    outs = [(em[i], int(ne[i]), int(na[i])) for i in range(s)]
    us, gs = [], []
    for i in range(s if draws else 0):
        key = jsd.request_key(jnp.uint32(seed[i]), jnp.int32(pos[i]),
                              jsd.STREAM_ACCEPT)
        us.append(np.asarray(jax.random.uniform(key, (m - 1,))))
        r_key = jax.random.fold_in(jsd.request_key(
            jnp.uint32(seed[i]), jnp.int32(pos[i]), jsd.STREAM_RESIDUAL),
            jnp.int32(na[i]))
        gs.append(np.asarray(jax.random.gumbel(r_key, (v,))))
    return outs, np.array(us, np.float32), np.array(gs, np.float32)


def _port_accept(t, q, props, temp, seed, pos, **kw):
    return [x.numpy() for x in sd.accept_chunk(
        torch.from_numpy(t), torch.from_numpy(q), torch.from_numpy(props),
        torch.tensor(temp, dtype=torch.float32), 0, 1.0,
        torch.tensor(seed, dtype=torch.int64),
        torch.tensor(pos, dtype=torch.int64), **kw)]


@pytest.mark.parametrize("m", [2, 3, 5])
def test_accept_chunk_greedy_matches_jax(m):
    """Greedy slots: emitted, n_emit and n_accept equal the JAX rule's, for
    full, partial and no acceptance. (The JAX rule cannot trace m = 1,
    which its engine never reaches; the port's m = 1 is held against the
    numpy restatement below.)"""
    s = 4
    t, q, props = _chunk(m, s, m, 37, match=[(0, m - 1), (1, 1), (3, 2)])
    temp, seed, pos = [0.0] * s, [5, 6, 7, 8], [3, 9, 11, 40]
    ref, _, _ = _jax_accept(t, q, props, temp, seed, pos)
    em, ne, na = _port_accept(t, q, props, temp, seed, pos)
    for i, (r_em, r_ne, r_na) in enumerate(ref):
        assert (int(ne[i]), int(na[i])) == (r_ne, r_na)
        assert em[i].tolist() == r_em.tolist()
    assert int(na[0]) == m - 1  # the matched slot accepts every proposal


def test_accept_chunk_sampled_with_jax_draws_matches_jax():
    """Sampled slots given the JAX rule's own uniforms and residual noise:
    the same accepted counts, corrections and bonuses as the JAX rule.
    Proposals drawn from the draft rows so that acceptance is likely."""
    s, m, v = 6, 4, 23
    rs = np.random.RandomState(11)
    t, q, _ = _chunk(12, s, m, v)
    props = np.array([[rs.choice(v, p=q[i, j] / q[i, j].sum())
                       for j in range(m - 1)] for i in range(s)], np.int32)
    temp, seed, pos = [1.0, 0.7, 1.3, 1.0, 0.9, 1.0], list(range(20, 26)), \
        [4, 5, 6, 7, 8, 9]
    ref, u, g = _jax_accept(t, q, props, temp, seed, pos, draws=True)
    em, ne, na = _port_accept(t, q, props, temp, seed, pos,
                              accept_u=torch.from_numpy(u),
                              residual_noise=torch.from_numpy(g))
    assert [r[2] for r in ref] == na.tolist()
    assert [r[1] for r in ref] == ne.tolist()
    assert [r[0].tolist() for r in ref] == em.tolist()
    assert 0 < int(na.sum()) < s * (m - 1)  # accepts and rejects both


def _numpy_accept(t, q, props, temp, u, g):
    """The JAX ``accept_chunk`` (bigdl_tpu/serving/spec_decode.py:116-168)
    restated in numpy for one slot, top-k and top-p off, with the draws
    given: uniforms ``u`` and the residual's Gumbel noise ``g``."""
    m = t.shape[0]
    greedy = t.argmax(-1)
    lg = t / (temp if temp > 0 else 1.0)
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    j = np.arange(m - 1)
    ok = (u * np.maximum(q[j, props], 1e-30) < p[j, props]) if temp > 0 \
        else props == greedy[:m - 1]
    n = int(np.cumprod(ok.astype(np.int64)).sum())
    # a zero row past the proposals (the JAX code's zeros_like(q[:1]) is
    # empty when there are none; its engine never verifies m = 1)
    q_pad = np.concatenate([q, np.zeros((1, q.shape[1]), q.dtype)])
    resid = np.maximum(p[n] - q_pad[n], 0.0)
    resid = resid / resid.sum() if resid.sum() > 0 else p[n]
    extra = int(np.argmax(np.log(np.maximum(resid, 1e-38)) + g)) \
        if temp > 0 else int(greedy[n])
    return list(props[:n]) + [extra] + [0] * (m - 1 - n), n + 1, n


@pytest.mark.parametrize("m", [1, 5])
def test_accept_chunk_matches_numpy_restatement_with_port_draws(m):
    """The port's rule with its own hashed draws (uniforms from (seed,
    pos, STREAM_ACCEPT), noise from the residual key) against the numpy
    restatement given those same draws; greedy and sampled slots, and
    m = 1 (the pending feed alone, zero-sized proposals)."""
    s, v = 8, 29
    t, q, props = _chunk(21, s, m, v, match=[(1, m - 1), (5, 2)])
    temp = [0.0, 0.0, 1.0, 0.8, 1.2, 0.0, 1.0, 0.6]
    seed, pos = list(range(40, 48)), list(range(10, 18))
    em, ne, na = _port_accept(t, q, props, temp, seed, pos)
    keys = request_key(torch.tensor(seed), torch.tensor(pos), STREAM_ACCEPT)
    u = uniforms(keys, m - 1).numpy()
    from bigdl_tpu_torch.serving.sampling import (STREAM_RESIDUAL, _fold,
                                                  gumbel_noise)
    g = gumbel_noise(_fold(request_key(torch.tensor(seed), torch.tensor(pos),
                                       STREAM_RESIDUAL),
                           torch.from_numpy(na)), v).numpy()
    for i in range(s):
        r_em, r_ne, r_na = _numpy_accept(t[i], q[i], props[i], temp[i], u[i],
                                         g[i])
        assert (em[i].tolist(), int(ne[i]), int(na[i])) == (r_em, r_ne, r_na)


def test_rejection_sampling_matches_target_distribution():
    """4000 seeds as 4000 slots: the draft proposes from q, the rule
    accepts or redraws, and the first emitted token's frequencies match
    the target's p (not q), as the JAX package's test holds its own."""
    v, n = 8, 4000
    rs = np.random.RandomState(0)
    t_logits = torch.from_numpy(rs.randn(2, v).astype(np.float32))
    d_logits = torch.from_numpy(rs.randn(v).astype(np.float32))
    seeds, pos = torch.arange(n), torch.full((n,), 5)
    prop, q = sd.draft_propose(d_logits.expand(n, v), 1.0, 0, 1.0, seeds,
                               pos)
    em, _, _ = sd.accept_chunk(t_logits.expand(n, 2, v), q[:, None],
                               prop[:, None], 1.0, 0, 1.0, seeds, pos)
    freq = np.bincount(em[:, 0].numpy(), minlength=v) / n
    p = torch.softmax(t_logits[0], -1).numpy()
    qd = torch.softmax(d_logits, -1).numpy()
    assert np.abs(freq - p).max() < 0.04
    assert np.abs(p - qd).max() > 0.12
    assert np.abs(freq - qd).max() > 0.08
    # the draft's own draws follow q, and its greedy slots take the argmax
    pf = np.bincount(prop.numpy(), minlength=v) / n
    assert np.abs(pf - qd).max() < 0.04
    g, _ = sd.draft_propose(d_logits.expand(3, v), 0.0, 0, 1.0,
                            torch.arange(3), torch.zeros(3, dtype=torch.long))
    assert g.tolist() == [int(d_logits.argmax())] * 3


def test_parse_draft_dims_matches_jax():
    assert sd.parse_draft_dims("64,2,4") == jsd.parse_draft_dims("64,2,4") \
        == {"d_model": 64, "num_layers": 2, "num_heads": 4}
    for bad in ("64,2", "65,2,4"):
        with pytest.raises(ValueError):
            sd.parse_draft_dims(bad)


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("kv", ["dense", "paged", "prefix"])
@pytest.mark.parametrize("draft", ["self", "distinct"])
def test_spec_greedy_equals_plain_and_jax(lms, k, kv, draft):
    """Speculative greedy tokens equal the JAX engine's plain greedy tokens
    (and so the port's plain ones, held by test_torch_serving), request by
    request, with a prefix hit in the prefix-cache runs."""
    kw = {"dense": {}, "paged": dict(kv_page_tokens=8),
          "prefix": dict(kv_page_tokens=8, prefix_cache=True)}[kv]
    eng = DecodeEngine(lms["target"], slots=2, device="cpu", speculate=k,
                       draft_model=lms["draft"] if draft == "distinct"
                       else None, **kw)
    shared = lms["shared"]
    for p in (PROMPTS[0], shared, shared + [7, 8]):
        assert eng.generate(p, N_NEW) == lms["ref"][tuple(p)], p
    if kv == "prefix":
        assert eng._pfx.hits >= 1
    assert not eng.busy() and eng.kv_pages_in_use() == (
        eng._pfx.cached_pages() if eng._pfx else 0)


def test_spec_plain_engines_agree_and_concurrent_slots(lms):
    """Requests decoding together in one speculative batch each give their
    solo plain tokens (slot interference would break this)."""
    plain = DecodeEngine(lms["target"], slots=2, device="cpu")
    base = [plain.generate(p, 15) for p in PROMPTS]
    assert base == [lms["ref"][tuple(p)][:15] for p in PROMPTS]
    de = DecodeEngine(lms["target"], slots=3, device="cpu", speculate=4)
    futs = [de.submit(p, 15) for p in PROMPTS]
    while not all(f.done() for f in futs):
        assert de.step() > 0 or all(f.done() for f in futs)
    assert [f.result(0) for f in futs] == base


def test_spec_stop_token_truncates_round(lms):
    """A stop token accepted mid-chunk ends the request there: tokens
    speculated past it are dropped."""
    ref = lms["ref"][tuple(PROMPTS[0])]
    stop = ref[2]
    want = ref[:ref.index(stop) + 1]
    for k in (0, 4):
        eng = DecodeEngine(lms["target"], slots=2, device="cpu", speculate=k)
        assert eng.generate(PROMPTS[0], N_NEW, stop_token=stop) == want


def test_spec_max_len_boundary(lms):
    """prompt + max_new == max_len: the chunk is cut to the cache's tail
    (m < K+1 in the last rounds), and the tokens are the plain ones."""
    small = _port_lm(lms["params"], max_len=32, **lms["tkw"])
    n = 32 - len(PROMPTS[0])
    ref = DecodeEngine(small, slots=1, device="cpu").generate(PROMPTS[0], n)
    jm, params, _, _ = lms["jax"]
    assert ref == JaxDecodeEngine(jm, params, slots=1,
                                  max_len=32).generate(PROMPTS[0], n)
    for pt in (None, 8):
        spec = DecodeEngine(small, slots=1, device="cpu", speculate=4,
                            kv_page_tokens=pt)
        assert spec.generate(PROMPTS[0], n) == ref


def test_spec_accept_counters_and_dispatch_win(lms):
    reg = MetricsRegistry()
    de = DecodeEngine(lms["target"], slots=2, device="cpu", speculate=4,
                      metrics=reg)
    de.generate(PROMPTS[0], N_NEW)
    g = lambda n: reg._metrics[n].value  # noqa: E731
    assert g("spec_proposed_total") > 0
    # self-draft: every proposal stands, K+1 tokens a round after the first
    assert g("spec_accepted_total") == g("spec_proposed_total")
    assert g("spec_accept_rate") == 1.0
    assert g("generated_tokens_total") == N_NEW
    assert g("decode_steps_total") == 4  # 1 at install, then 5 + 5 + 5 + 4
    assert g("spec_draft_steps_total") == 5 * 4
    assert g("spec_accepted_tokens_per_step") == N_NEW / 4
    assert de.debug_snapshot()["speculate"] == 4


def test_spec_low_accept_rate_with_distinct_draft(lms):
    reg = MetricsRegistry()
    de = DecodeEngine(lms["target"], slots=2, device="cpu", speculate=4,
                      draft_model=lms["draft"], metrics=reg)
    de.generate(PROMPTS[0], N_NEW)
    g = lambda n: reg._metrics[n].value  # noqa: E731
    assert 0.0 <= g("spec_accept_rate") < 1.0
    assert g("spec_accepted_tokens_per_step") >= 1.0


def test_spec_sampling_deterministic_per_seed(lms):
    kw = dict(temperature=0.8, top_k=12, top_p=0.9)

    def run(seed, pt=None):
        return DecodeEngine(lms["target"], slots=2, device="cpu",
                            speculate=3, kv_page_tokens=pt).generate(
            PROMPTS[0], 12, seed=seed, **kw)

    a = run(9)
    assert a == run(9) == run(9, pt=8)
    assert a != run(10)
    # top_k = 1 makes any temperature greedy
    de = DecodeEngine(lms["target"], slots=2, device="cpu", speculate=3)
    assert de.generate(PROMPTS[0], 12, temperature=1.3, top_k=1, seed=4) \
        == lms["ref"][tuple(PROMPTS[0])][:12]


def test_spec_engine_arguments(lms):
    with pytest.raises(ValueError, match="speculate"):
        DecodeEngine(lms["target"], device="cpu", speculate=-1)
    short = TransformerLM(VOCAB, d_model=32, num_layers=1, num_heads=2,
                          max_len=32)
    with pytest.raises(ValueError, match="max_len"):
        DecodeEngine(lms["target"], device="cpu", speculate=2,
                     draft_model=short)


def test_serve_cli_speculative_and_quantized():
    """``serve --speculate 3 --draftDims 32,1,2 --quantize int8+kv8`` on
    the CPU: the page size is picked for kv8, the draft is the seeded
    distinct model, the quality report is in the provenance, and the
    served greedy tokens equal plain decoding of the same quantized model
    with the same pools."""
    from bigdl_tpu_torch.cli import serve as serve_cli
    args = serve_cli.build_parser().parse_args(
        ["transformer_lm", "--randomInit", "--platform", "cpu",
         "--vocabSize", "61", "--dModel", "32", "--numLayers", "2",
         "--numHeads", "2", "--seq", "64", "--slots", "2", "--speculate",
         "3", "--draftDims", "32,1,2", "--quantize", "int8+kv8",
         "--no-warmup", "--port", "0"])
    app, _, _, _ = serve_cli.build_app(args)
    try:
        dec = app.decoder
        assert dec.page_tokens == 64 and dec.speculate == 3
        assert dec.draft_model is not dec.model
        assert dec.draft_model.encoder[0].mha.wq.fmt == "int8"
        prov = app.metrics._provenance
        assert prov["quantize"] == "int8+kv8" and prov["speculate"] == 3
        assert prov["draft"] == "32,1,2" and prov["quant_agreement"] >= 0.99
        from bigdl_tpu_torch.serving.quant import weight_bytes
        assert prov["weight_bytes"] == weight_bytes(dec.model)
        plain = DecodeEngine(dec.model, slots=2, device="cpu",
                             kv_page_tokens=64, quantize="kv8")
        for p in PROMPTS:
            assert dec.submit(p, 10).result(60) == plain.generate(p, 10)
    finally:
        app.close()
