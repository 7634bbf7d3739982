"""The port's paged KV cache and shared-prefix cache
(bigdl_tpu_torch.serving.kv_pages / prefix_cache) against the JAX
package's, on the CPU: the page functions bit for bit, the allocator's page
ids, reservation, the paged engine's tokens and logits against the JAX
paged engine's, paged against dense under slot churn, admission by
reservation, the page-counting gauges, ``verify_logits``, prefix hits
against misses, and LRU eviction order.

Tolerances: the port against the JAX package at 1e-4 on f32 logits (a
few layers, sums in other orders); the port against itself bit for bit
(paged decode runs the dense arithmetic on each layer's gathered view),
but for a prefix hit's first logits against its miss's, 1e-5: the suffix
goes through ``verify_logits``, the miss through the prefill's attention,
so the sums are taken in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu.serving import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.serving import kv_pages as jkvp
from bigdl_tpu.serving.prefix_cache import PrefixCache as JaxPrefixCache
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import DecodeEngine, MetricsRegistry
from bigdl_tpu_torch.serving import kv_pages as kvp
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache

VOCAB, D, LAYERS, HEADS, KV_HEADS, MAX_LEN = 53, 32, 2, 2, 1, 64
LOGIT_ATOL = 1e-4
HIT_ATOL = 1e-5  # one f32 forward over the suffix, two attention routes
PROMPTS = [[3, 9, 44, 1], [7, 7, 12, 30, 2], [50, 1, 2], [8, 41],
           list(range(5, 26))]


@pytest.fixture(scope="module")
def lm():
    """A RoPE GQA LM in both packages from one JAX tree (the embedding
    scaled down so the layers, not an echo of the tied head, pick the
    tokens)."""
    jm = jax_models.transformer_lm(VOCAB, d_model=D, num_layers=LAYERS,
                                   num_heads=HEADS, max_len=MAX_LEN,
                                   pos_encoding="rope",
                                   num_kv_heads=KV_HEADS)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(5)))
    params["emb"]["weight"] = params["emb"]["weight"] * np.float32(0.05)
    pm = TransformerLM(VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
                       max_len=MAX_LEN, pos_encoding="rope",
                       num_kv_heads=KV_HEADS)
    return jm, params, pm.load_jax_params(params).eval()


# ---------------------------------------------------------- page functions
def _pools(rs, pool_pages=7, kh=2, pt=4, hd=3):
    return rs.randn(pool_pages, kh, pt, hd).astype(np.float32)


def _torch_pools(a):
    return [{"k": torch.from_numpy(a.copy())}]


@pytest.mark.parametrize("op", ["gather", "scatter_tokens", "scatter_pages",
                                "copy_pages"])
def test_page_functions_match_jax_bit_for_bit(op):
    rs = np.random.RandomState(1)
    pools = _pools(rs)
    pages = np.array([2, 4, 1, 0], np.int32)  # the tail entry is null
    if op == "gather":
        ref = jkvp.gather_cache(jnp.asarray(pools), jnp.asarray(pages))
        got = kvp.gather_cache(_torch_pools(pools),
                               torch.from_numpy(pages))[0]["k"]
    elif op == "scatter_tokens":
        vals = rs.randn(3, 2, 3).astype(np.float32)
        ids, offs = np.array([3, 0, 5], np.int32), np.array([2, 1, 0],
                                                            np.int32)
        ref = jkvp.scatter_tokens(jnp.asarray(pools), jnp.asarray(vals),
                                  jnp.asarray(ids), jnp.asarray(offs))
        got = kvp.scatter_tokens(_torch_pools(pools),
                                 [{"k": torch.from_numpy(vals)}],
                                 torch.from_numpy(ids),
                                 torch.from_numpy(offs))[0]["k"]
    elif op == "scatter_pages":
        cache = rs.randn(1, 2, 16, 3).astype(np.float32)
        pg = np.array([2, 4, 1, 5], np.int32)
        ref = jkvp.scatter_pages(jnp.asarray(pools), jnp.asarray(cache),
                                 jnp.asarray(pg))
        got = kvp.scatter_pages(_torch_pools(pools),
                                [{"k": torch.from_numpy(cache)}],
                                torch.from_numpy(pg))[0]["k"]
        back = kvp.gather_cache([{"k": got}], torch.from_numpy(pg))
        assert np.array_equal(back[0]["k"].numpy(), cache[0])
    else:
        src, dst = np.array([1, 2], np.int32), np.array([4, 6], np.int32)
        ref = jkvp.copy_pages(jnp.asarray(pools), jnp.asarray(src),
                              jnp.asarray(dst))
        got = kvp.copy_pages(_torch_pools(pools), torch.from_numpy(src),
                             torch.from_numpy(dst))[0]["k"]
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_batched_gather_is_per_row_gather():
    """The decode step gathers every slot's row at once: row i equals the
    one-row gather of page-table row i."""
    rs = np.random.RandomState(2)
    pools = _torch_pools(_pools(rs))
    table = torch.tensor([[2, 4, 0], [5, 1, 3]])
    both = kvp.gather_layer(pools[0]["k"], table)
    for i in range(2):
        assert torch.equal(both[i], kvp.gather_layer(pools[0]["k"],
                                                     table[i]))


def test_allocator_gives_jax_page_ids():
    """A scripted alloc/free sequence: the same ids, refusals and counts
    as the JAX allocator."""
    ours, ref = kvp.PageAllocator(9), jkvp.PageAllocator(9)
    script = [("alloc", 3), ("alloc", 2), ("free", 0), ("alloc", 4),
              ("alloc", 2), ("free", 1), ("alloc", 1), ("free", 3),
              ("alloc", 5)]
    held_o, held_r = [], []
    for op, n in script:
        if op == "alloc":
            a, b = ours.alloc(n), ref.alloc(n)
            assert a == b
            held_o.append(a or [])
            held_r.append(b or [])
        else:
            ours.free(held_o[n])
            ref.free(held_r[n])
        assert (ours.free_pages, ours.pages_in_use) == (
            ref.free_pages, ref.pages_in_use)
    with pytest.raises(ValueError, match="invalid page"):
        ours.free([0])
    with pytest.raises(ValueError):
        kvp.PageAllocator(1)
    assert kvp.pages_needed(17, 8) == jkvp.pages_needed(17, 8) == 3


def test_reservation_fails_cleanly(lm):
    jm, _, pm = lm
    kw = dict(slots=2, max_len=MAX_LEN, page_tokens=16, pool_pages=4)
    kv = kvp.PagedKvCache(pm.encoder, dtype=torch.float32, device="cpu",
                          **kw)
    ref = jkvp.PagedKvCache(jm.encoder, dtype=jnp.float32, **kw)
    for cache in (kv, ref):
        assert cache.reserve(0, 48)          # all 3 real pages
        assert not cache.reserve(1, 17)      # needs 2, none free
        assert cache.slot_pages[1] == []
    assert kv.slot_pages == ref.slot_pages
    assert np.array_equal(kv.table, ref.page_table)
    assert torch.equal(kv.page_table, torch.from_numpy(kv.table))
    assert kv.bytes_per_page == ref.bytes_per_page
    assert kv.allocated_bytes() == ref.allocated_bytes() == 3 * \
        kv.bytes_per_page
    kv.release(0)
    assert kv.reserve(1, 17) and kv.slot_pages[1] == [1, 2]
    assert not kv.page_table[0].any()
    with pytest.raises(ValueError, match="divide"):
        kvp.PagedKvCache(pm.encoder, slots=1, max_len=MAX_LEN,
                         page_tokens=13, dtype=torch.float32, device="cpu")


# ------------------------------------------------------------ paged engine
def test_paged_engine_matches_jax_paged_engine(lm):
    """Both engines with 8-token pages and one slot per prompt: the
    prefill logits written into the pages, the logits after decode steps
    over the pages (atol LOGIT_ATOL), and the greedy tokens."""
    jm, params, pm = lm
    prompts = PROMPTS[:2] + PROMPTS[4:]
    jde = JaxDecodeEngine(jm, params, slots=3, kv_page_tokens=8)
    pde = DecodeEngine(pm, slots=3, kv_page_tokens=8, device="cpu")
    jf = [jde.submit(p, 6) for p in prompts]
    pf = [pde.submit(p, 6) for p in prompts]
    for step in range(3):
        np.testing.assert_allclose(pde._logits.numpy(),
                                   np.asarray(jde._logits),
                                   rtol=0, atol=LOGIT_ATOL)
        jde.step()
        pde.step()
    while not all(f.done() for f in jf + pf):
        jde.step()
        pde.step()
    assert [f.result(0) for f in pf] == [f.result(0) for f in jf]
    assert pde.kv_pages_in_use() == 0


def test_paged_equals_dense_under_slot_churn(lm):
    """Five requests through two slots (hand-offs free and reuse pages
    mid-run), greedy and sampled: tokens equal the dense engine's, and
    each step's logits equal bit for bit."""
    _, _, pm = lm
    dense = DecodeEngine(pm, slots=2, device="cpu")
    paged = DecodeEngine(pm, slots=2, kv_page_tokens=16, device="cpu")
    futs = []
    for p in PROMPTS:
        futs.append((dense.submit(p, 12), paged.submit(p, 12)))
    sampled = dict(temperature=0.9, top_k=8, top_p=0.9, seed=11)
    futs.append((dense.submit(PROMPTS[0], 10, **sampled),
                 paged.submit(PROMPTS[0], 10, **sampled)))
    for _ in range(300):
        if all(a.done() and b.done() for a, b in futs):
            break
        assert torch.equal(dense._logits, paged._logits)
        dense.step()
        paged.step()
    assert [a.result(0) for a, _ in futs] == [b.result(0) for _, b in futs]
    assert paged.kv_pages_in_use() == 0


def test_admission_waits_until_pages_free(lm):
    """A request the pool cannot back stays queued (nothing installed)
    and runs once a finishing request frees its pages."""
    _, _, pm = lm
    de = DecodeEngine(pm, slots=2, kv_page_tokens=16, pool_pages=4,
                      device="cpu")  # 3 real pages
    f1 = de.submit(PROMPTS[0], 28)     # 32 tokens: 2 pages
    f2 = de.submit(PROMPTS[1], 20)     # 25 tokens: 2 pages, must wait
    assert de._reqs.count(None) == 1 and len(de._waiting) == 1
    assert de.kv_pages_in_use() == 2
    with pytest.raises(ValueError, match="pages"):
        de.submit(list(range(50)), 14)  # 4 pages: never fits the pool
    for _ in range(200):
        if f1.done() and f2.done():
            break
        de.step()
    dense = DecodeEngine(pm, slots=1, device="cpu")
    assert f1.result(0) == dense.generate(PROMPTS[0], 28)
    assert f2.result(0) == dense.generate(PROMPTS[1], 20)


def test_kv_cache_bytes_counts_allocated_pages(lm):
    _, _, pm = lm
    reg = MetricsRegistry()
    de = DecodeEngine(pm, slots=2, kv_page_tokens=16, metrics=reg,
                      device="cpu")
    g = lambda n: reg._metrics[n].value  # noqa: E731
    assert g("kv_cache_bytes") == 0.0 and g("kv_pages_in_use") == 0.0
    fut = de.submit(PROMPTS[0], 20)    # 24 tokens: 2 pages
    bpp = de._kv.bytes_per_page
    assert bpp == LAYERS * 2 * KV_HEADS * 16 * (D // HEADS) * 4
    assert g("kv_pages_in_use") == 2.0 and de.kv_pages_in_use() == 2
    assert g("kv_cache_bytes") == 2.0 * bpp == de.kv_bytes()
    assert g("kv_cache_bytes_per_slot") == bpp
    while not fut.done():
        de.step()
    assert g("kv_cache_bytes") == 0.0  # released with the slot


# ----------------------------------------------------------- verify_logits
def test_verify_logits_matches_jax(lm):
    """A prompt prefilled, then a 5-token chunk verified at its end: the
    chunk's logits against the JAX model's, dense and over pages."""
    jm, params, pm = lm
    rs = np.random.RandomState(3)
    prompt = rs.randint(0, VOCAB, (1, 11)).astype(np.int32)
    chunk = rs.randint(0, VOCAB, (1, 5)).astype(np.int32)
    jc = jm.encoder.init_cache(1, MAX_LEN, jnp.float32)
    _, jc = jm.prefill_logits(params, jnp.asarray(prompt), jc)
    ref, _ = jm.verify_logits(params, jnp.asarray(chunk), jc, 11)
    with torch.no_grad():
        cache = pm.init_cache(1)
        pm.prefill_logits(torch.from_numpy(prompt), cache)
        got = pm.verify_logits(torch.from_numpy(chunk), cache, 11)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=LOGIT_ATOL)
        kv = kvp.PagedKvCache(pm.encoder, slots=1, max_len=MAX_LEN,
                              page_tokens=8, dtype=torch.float32,
                              device="cpu")
        assert kv.reserve(0, 16)
        fresh = pm.init_cache(1)
        pm.prefill_logits(torch.from_numpy(prompt), fresh)
        kvp.scatter_pages(kv.pools, fresh, kv.page_table[0])
        paged = kvp.paged_verify_logits(pm, torch.from_numpy(chunk),
                                        kv.pools, kv.page_table,
                                        torch.tensor([11]))
    assert torch.equal(paged, got)


# ------------------------------------------------------------ prefix cache
def test_prefix_hit_equals_miss(lm):
    """A second request sharing a page-aligned prefix copies the cached
    pages and prefills only its suffix: its tokens equal a cold engine's
    and the offline generate's, bit for bit; its first logits, which the
    suffix computes through ``verify_logits`` where the miss runs the
    prefill's flash attention, agree within HIT_ATOL. The pages the cache
    holds stay in use once traffic ends."""
    _, _, pm = lm
    reg = MetricsRegistry()
    de = DecodeEngine(pm, slots=2, kv_page_tokens=8, prefix_cache=True,
                      metrics=reg, device="cpu")
    shared = list(range(1, 20))        # usable prefix 16 tokens: 2 pages
    cold = DecodeEngine(pm, slots=2, kv_page_tokens=8, device="cpu")
    for prompt in (shared, shared + [33], shared + list(range(30, 45))):
        got = de.generate(prompt, 8)
        assert got == cold.generate(prompt, 8)
        assert got == pm.generate([prompt], 8)[0].tolist()
    assert de._pfx.hits == 2 and de._pfx.misses == 1
    assert reg._metrics["prefix_cache_hits_total"].value == 2
    assert de.kv_pages_in_use() == de._pfx.cached_pages() == \
        reg._metrics["prefix_cache_pages"].value > 0
    for eng in (de, cold):             # first logits of a hit and a miss
        eng.submit(shared + [7], 2)
    diff = float((de._logits[0] - cold._logits[0]).abs().max())
    assert diff <= HIT_ATOL
    with pytest.raises(ValueError, match="prefix_cache requires"):
        DecodeEngine(pm, prefix_cache=True, device="cpu")


def test_prefix_cache_lru_matches_jax(lm):
    """Inserts past the page budget evict least-recently used entries:
    the same entries, pages and hit/miss counts as the JAX cache over a
    scripted sequence of matches and inserts."""
    jm, _, pm = lm
    kw = dict(slots=1, max_len=MAX_LEN, page_tokens=8, pool_pages=12)
    ours = PrefixCache(kvp.PagedKvCache(pm.encoder, dtype=torch.float32,
                                        device="cpu", **kw), max_pages=5)
    ref = JaxPrefixCache(jkvp.PagedKvCache(jm.encoder, dtype=jnp.float32,
                                           **kw), max_pages=5)
    rs = np.random.RandomState(4)
    heads = [rs.randint(0, VOCAB, n).tolist() for n in (17, 9, 25, 12)]
    script = [heads[0], heads[1], heads[0] + [1, 2], heads[2], heads[1],
              heads[3], heads[0], heads[2] + [5]]
    for toks in script:
        assert ours.match(toks) == ref.match(toks)
        for cache in (ours, ref):
            ins = cache.prepare_insert(toks)
            if ins is not None:
                key, pages = ins
                cache.commit_insert(key, pages,
                                    len(pages) * cache.page_tokens)
        assert list(ours._entries) == list(ref._entries)
        assert [e.pages for e in ours._entries.values()] == \
            [e.pages for e in ref._entries.values()]
    assert (ours.hits, ours.misses, ours.evictions) == (
        ref.hits, ref.misses, ref.evictions)
    assert ours.evictions > 0
    ours.clear()
    assert ours.kv.alloc.pages_in_use == 0
