"""The untied LM head (``TransformerLM(tie_embeddings=False)``) and
``LookupTable(max_norm=...)`` against the JAX modules, on the CPU, from
the same parameters (JAX init trees through ``params_from_jax``): log-
probs within 1e-4, gradients within 1e-4 of each tensor's largest
magnitude, and greedy tokens equal to JAX ``generate`` and to the port's
serving paths (dense, paged, speculative, int8). The JAX side runs
attn_impl="flash" (its Pallas kernel in interpret mode); the port runs
the kernel's plain twin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu_torch.interop import params_from_jax
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn import LookupTable
from bigdl_tpu_torch.serving import DecodeEngine

VOCAB, D, LAYERS, HEADS, MAX_LEN = 61, 32, 2, 2, 48


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def untied():
    jm = jax_models.transformer_lm(VOCAB, d_model=D, num_layers=LAYERS,
                                   num_heads=HEADS, max_len=MAX_LEN,
                                   attn_impl="flash", tie_embeddings=False,
                                   pos_encoding="rope", num_kv_heads=1)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    params["emb"]["weight"] = params["emb"]["weight"] * np.float32(0.05)
    pm = TransformerLM(VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
                       max_len=MAX_LEN, attn_impl="flash",
                       tie_embeddings=False, pos_encoding="rope",
                       num_kv_heads=1)
    pm.load_jax_params(params).eval()
    return jm, params, pm


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, shape).astype(
        np.int32)


def test_head_parameters_carry_across(untied):
    _, params, pm = untied
    flat = params_from_jax(params)
    assert set(flat) == set(pm.state_dict())
    assert tuple(pm.head.weight.shape) == params["head"]["weight"].shape \
        == (D, VOCAB)
    np.testing.assert_array_equal(pm.head.bias.detach().numpy(),
                                  params["head"]["bias"])
    tied = TransformerLM(VOCAB, d_model=D, num_layers=1, num_heads=HEADS,
                         max_len=MAX_LEN)
    assert tied.head is None and "head.weight" not in tied.state_dict()


def test_untied_forward_and_gradients_match(untied):
    jm, params, pm = untied
    toks = _tokens((2, 24), seed=1)
    tgt = _tokens((2, 24), seed=2)

    def jloss(p):
        lp, _ = jm.apply(p, jm.init_state(), jnp.asarray(toks))
        return -jnp.take_along_axis(lp, jnp.asarray(tgt)[..., None],
                                    axis=-1).mean(), lp

    (jl, jlp), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    pm.zero_grad()
    lp = pm(torch.from_numpy(toks))
    loss = -torch.gather(lp, -1, torch.from_numpy(tgt).long()[..., None]
                         ).mean()
    loss.backward()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp),
                               atol=1e-4)
    assert abs(float(loss.detach()) - float(jl)) < 1e-5
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in pm.named_parameters():
        want = flat[name].numpy()
        tol = 1e-4 * max(1e-6, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, atol=tol,
                                   err_msg=name)


def test_untied_greedy_decoding_matches_jax_and_serving(untied):
    jm, params, pm = untied
    prompt = _tokens((2, 7), seed=3)
    want = np.asarray(jm.generate(params, jnp.asarray(prompt), 12))
    got = pm.generate(torch.from_numpy(prompt), 12).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(want[0].tolist())) > 1  # the head, not a repeat
    row = prompt[0].tolist()
    for kw in ({}, {"kv_page_tokens": 8}, {"kv_page_tokens": 8,
                                           "speculate": 3}):
        eng = DecodeEngine(pm, device="cpu", slots=2, **kw)
        assert eng.generate(row, 12) == want[0].tolist(), kw
        eng.close()
    # int8 weights (the head's among them): the engine decodes its own
    # model greedily, the same tokens as that model's generate
    from bigdl_tpu_torch.serving.quant import is_quantized, quantize_params
    qm = quantize_params(pm, "int8")
    assert is_quantized(qm.head.weight)
    eng = DecodeEngine(pm, device="cpu", slots=2, quantize="int8")
    assert eng.generate(row, 12) == qm.generate(
        torch.tensor([row]), 12)[0].tolist()
    eng.close()


@pytest.mark.parametrize("max_norm,norm_type", [(1.5, 2.0), (2.0, 1.0),
                                                (0.5, 3.0)])
def test_lookup_table_max_norm_matches_jax(max_norm, norm_type):
    """Gathered rows renormalised at lookup time, the weight untouched:
    forward within 1e-6, the weight's gradient within 1e-5."""
    jlt = jnn.LookupTable(20, 6, max_norm=max_norm, norm_type=norm_type)
    jp = jlt.init(jax.random.PRNGKey(3))
    ids = np.random.RandomState(4).randint(0, 20, (3, 9)).astype(np.int32)
    r = np.random.RandomState(5).randn(3, 9, 6).astype(np.float32)

    def jfn(p):
        out = jlt.forward(p, jnp.asarray(ids))
        return jnp.sum(out * r), out

    (_, jout), jg = jax.value_and_grad(jfn, has_aux=True)(jp)
    lt = LookupTable(20, 6, max_norm=max_norm, norm_type=norm_type)
    with torch.no_grad():
        lt.weight.copy_(torch.from_numpy(np.array(jp["weight"])))
    before = lt.weight.detach().clone()
    out = lt(torch.from_numpy(ids))
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    np.testing.assert_allclose(lt.weight.grad.numpy(),
                               np.asarray(jg["weight"]), atol=1e-5)
    assert torch.equal(lt.weight.detach(), before)
    norms = torch.linalg.vector_norm(out.detach(), ord=norm_type, dim=-1)
    assert float(norms.max()) <= max_norm * (1 + 1e-6)
    assert float(norms.max()) > max_norm * 0.999  # some row was clipped
