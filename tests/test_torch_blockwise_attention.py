"""The port's blockwise attention (bigdl_tpu_torch/ops/attention_kernel.py
``blockwise_attention``) against the JAX package's, on the CPU, with the
same seeded inputs: causal and not, each mask form ((b, s_k) and (b, 1, 1,
s_k) key padding, packed-row segments, decode alignment with s_q < s_k,
and the ragged fallback to dense, a (b, s_k) key-padding mask there
too). Forward within 1e-5 in f32, gradients
within 1e-4 of max|g|. Also: ``flash_attention`` routes a key-padding mask
to the blockwise path with the stated block rule, and
``MultiHeadAttention(attn_impl="blockwise")`` matches the JAX layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.ops import blockwise_attention as jax_blockwise
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import params_from_jax
from bigdl_tpu_torch.ops import attention_kernel as ak
from bigdl_tpu_torch.ops import blockwise_attention

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
B, H, S, D, BK = 2, 3, 64, 16, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: torch's intra-op threads only add spinning,
    and beside other test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(s_q, s_k, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, s_q, D).astype(np.float32),
            rs.randn(B, H, s_k, D).astype(np.float32),
            rs.randn(B, H, s_k, D).astype(np.float32))


def _key_padding(s_k, seed):
    rs = np.random.RandomState(seed)
    keep = rs.rand(B, s_k) > 0.3
    keep[:, 0] = True  # every row keeps a key
    return keep


def _segments(s, seed):
    rs = np.random.RandomState(seed)
    seg = np.sort(rs.randint(1, 4, (B, s)), axis=1).astype(np.int32)
    seg[:, -5:] = 0  # padding
    return seg


def _both(q, k, v, kw_np, causal, block_k=BK, jax_kw_np=None):
    """(port out, port grads, JAX out, JAX grads) of sum(out * w); the JAX
    function takes ``jax_kw_np`` where given, else ``kw_np``."""
    w = np.random.RandomState(99).randn(*q.shape).astype(np.float32)

    def jf(q_, k_, v_):
        kw = {n: jnp.asarray(a) for n, a in (
            kw_np if jax_kw_np is None else jax_kw_np).items()}
        return jax_blockwise(q_, k_, v_, causal=causal, block_k=block_k,
                             **kw)

    jo, vjp = jax.vjp(jax.jit(jf), jnp.asarray(q), jnp.asarray(k),
                      jnp.asarray(v))
    jg = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    kw = {n: torch.from_numpy(a) for n, a in kw_np.items()}
    to = blockwise_attention(tq, tk, tv, causal=causal, block_k=block_k,
                             **kw)
    tg = torch.autograd.grad((to * torch.from_numpy(w)).sum(), (tq, tk, tv))
    return to.detach().numpy(), [g.numpy() for g in tg], np.asarray(jo), \
        [np.asarray(g) for g in jg]


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


# name: (s_q, s_k, inputs, causal)
CASES = {
    "plain_full": (S, S, lambda: {}, False),
    "plain_causal": (S, S, lambda: {}, True),
    "key_padding_2d_causal": (S, S, lambda: {"mask": _key_padding(S, 1)},
                              True),
    "key_padding_4d_full": (S, S, lambda: {
        "mask": _key_padding(S, 2)[:, None, None, :]}, False),
    "key_padding_4d_broadcast_causal": (S, S, lambda: {
        "mask": _key_padding(S, 3)[:1, None, None, :]}, True),
    "segments_full": (S, S, lambda: {"segments": _segments(S, 4)}, False),
    "segments_causal": (S, S, lambda: {"segments": _segments(S, 4)}, True),
    "decode_aligned_causal": (16, S, lambda: {}, True),
    "decode_aligned_key_padding_causal": (16, S, lambda: {
        "mask": _key_padding(S, 5)}, True),
    "ragged_dense_fallback_causal": (S - 6, S - 6, lambda: {}, True),
    "rich_mask_dense_fallback_full": (S, S, lambda: {
        "mask": np.random.RandomState(6).rand(B, 1, S, S) > 0.2}, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case):
    s_q, s_k, kw, causal = CASES[case]
    q, k, v = _qkv(s_q, s_k, seed=len(case))
    to, tg, jo, jg = _both(q, k, v, kw(), causal)
    _close(to, jo, FWD_TOL)
    for got, want in zip(tg, jg):
        _close(got, want, GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_key_padding_2d_takes_the_dense_path(causal):
    """s_k 130 with block 128 is ragged: the port takes the dense path
    with its (b, s_k) key-padding mask broadcast as (b, 1, 1, s_k), held
    against the JAX function given that mask as (b, 1, 1, s_k) (the form
    its dense path takes): the output within FWD_TOL (1e-5) and the
    gradients of q, k and v within GRAD_TOL (1e-4) of max|g|, f32."""
    s, bk = 130, 128
    q, k, v = _qkv(s, s, seed=12 + causal)
    keep = _key_padding(s, 12 + causal)
    to, tg, jo, jg = _both(q, k, v, {"mask": keep}, causal, block_k=bk,
                           jax_kw_np={"mask": keep[:, None, None, :]})
    _close(to, jo, FWD_TOL)
    for got, want in zip(tg, jg):
        _close(got, want, GRAD_TOL)
    # the masked keys take no gradient
    dropped = np.broadcast_to(~keep[:, None, :, None], tg[1].shape)
    assert not tg[1][dropped].any() and not tg[2][dropped].any()


def test_matches_dense_and_keeps_bf16_rules():
    """bf16 operands: the statistics stay f32 and the output is bf16; the
    result agrees with the dense path on the same bf16 values within bf16
    rounding, and a fully masked key row gives 0."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(S, S, 7))
    keep = torch.from_numpy(_key_padding(S, 8))
    keep[1] = False  # row 1 attends nothing
    out = blockwise_attention(q, k, v, mask=keep, block_k=BK)
    ref = tnn.dot_product_attention(q, k, v, mask=keep[:, None, None, :])
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref.float()).abs().max()) < 2e-2
    assert float(out[1].float().abs().max()) == 0.0


def test_argument_errors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(S, S, 9))
    seg = torch.from_numpy(_segments(S, 9))
    with pytest.raises(ValueError, match="mutually exclusive"):
        blockwise_attention(q, k, v, mask=torch.ones(B, S, dtype=torch.bool),
                            segments=seg)
    with pytest.raises(ValueError, match="self-attention"):
        blockwise_attention(q[:, :, :16], k, v, segments=seg)


def test_flash_attention_routes_key_padding_to_blockwise(monkeypatch):
    """A key-padding mask given to flash_attention takes the blockwise path
    with the block of ``flash_block_k`` (512 clamped to s_k), never the
    dense one; a richer mask takes the dense path."""
    calls = []
    real = ak.blockwise_attention

    def spy(*a, **kw):
        calls.append(kw["block_k"])
        return real(*a, **kw)

    def no_dense(*a, **kw):
        raise AssertionError("the dense path ran")

    s = 1024
    rs = np.random.RandomState(10)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, s, D).astype(np.float32))
               for _ in range(3))
    keep = torch.from_numpy(rs.rand(1, s) > 0.2)
    want = tnn.dot_product_attention(q, k, v, causal=True,
                                     mask=keep[:, None, None, :])
    monkeypatch.setattr(ak, "blockwise_attention", spy)
    monkeypatch.setattr(ak._dense, "dot_product_attention", no_dense)
    for m in (keep, keep[:, None, None, :]):
        got = ak.flash_attention(q, k, v, causal=True, mask=m)
        _close(got.numpy(), want.numpy(), FWD_TOL)
    assert calls == [512, 512]
    assert [ak.flash_block_k(n) for n in (100, 512, 768, 1000, 4096)] == \
        [100, 512, 256, 512, 512]
    monkeypatch.undo()
    rich = torch.from_numpy(rs.rand(1, 1, s, s) > 0.2)
    monkeypatch.setattr(ak, "blockwise_attention", spy)
    ak.flash_attention(q, k, v, causal=True, mask=rich)
    assert calls == [512, 512]


def test_mha_blockwise_matches_jax():
    """MultiHeadAttention(attn_impl="blockwise") with grouped KV heads and
    a (b, s_k) key-padding mask against the JAX layer with the same
    parameters: output and the gradients of every parameter and input."""
    d, heads, kv, s = 32, 4, 2, 256  # s_k 256: two 128-key blocks
    causal = True
    jm = jnn.MultiHeadAttention(d, heads, causal=causal,
                                attn_impl="blockwise", num_kv_heads=kv)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    tm = tnn.MultiHeadAttention(d, heads, causal=causal,
                                attn_impl="blockwise", num_kv_heads=kv)
    tm.load_state_dict(params_from_jax(params), strict=True)
    rs = np.random.RandomState(11)
    x = rs.randn(2, s, d).astype(np.float32)
    keep = rs.rand(2, s) > 0.25
    keep[:, 0] = True
    w = rs.randn(2, s, d).astype(np.float32)

    def jloss(p, x_):
        out, _ = jm.apply(p, jm.init_state(), (x_, x_, jnp.asarray(keep)))
        return jnp.sum(out * w), out

    (_, jo), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    to = tm((tx, tx, torch.from_numpy(keep)))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad((to * torch.from_numpy(w)).sum(),
                                [tx] + list(tm.parameters()))
    _close(to.detach().numpy(), np.asarray(jo), FWD_TOL)
    _close(grads[0].numpy(), np.asarray(jgx), GRAD_TOL)
    # one scale, max|g| over every parameter's gradient: bk's is zero up
    # to rounding (a shift of every key's score by q . bk cancels)
    jflat = {n: np.asarray(t) for n, t in params_from_jax(jgp).items()}
    scale = max(float(np.abs(g).max()) for g in jflat.values())
    for n, g in zip(names, grads[1:]):
        err = float(np.abs(g.numpy() - jflat[n]).max()) / scale
        assert err <= GRAD_TOL, (n, err)
