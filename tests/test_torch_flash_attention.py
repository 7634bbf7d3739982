"""The port's flash-attention forward (bigdl_tpu_torch.ops.attention_kernel)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port runs the kernel's plain twin; the CUDA kernel itself is
held against that twin by the cuda-marked test below, which runs only on a
machine with a card (and by chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.attention import dot_product_attention as jax_dense
from bigdl_tpu.ops.attention_kernel import _flash_fwd, _live_block_pairs
from bigdl_tpu_torch.nn import dot_product_attention
from bigdl_tpu_torch.ops import attention_kernel as ak
from bigdl_tpu_torch.ops import flash_attention, flash_attention_reference


def _qkv(b, h, sq, sk, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, sq, d).astype(np.float32),
            rs.randn(b, h, sk, d).astype(np.float32),
            rs.randn(b, h, sk, d).astype(np.float32))


# (b, h, s_q, s_k, d), causal, Pallas blocks (bq, bk). f32, atol 1e-5: the
# two sum the softmax in different orders, nothing else differs.
@pytest.mark.parametrize("shape,causal,blocks", [
    ((1, 2, 64, 64, 32), True, (16, 16)),
    ((1, 2, 64, 64, 32), False, (32, 16)),
    ((1, 2, 16, 64, 32), True, (16, 16)),   # s_q < s_k: bottom-right causal
    ((1, 2, 40, 40, 32), True, (16, 8)),    # ragged s = 40
    # the head dims of the Hopper kernel: s ragged against its 128-row
    # tiles, and s_q < s_k
    ((1, 2, 200, 200, 64), True, (64, 8)),
    ((1, 2, 200, 200, 128), True, (64, 8)),
    ((1, 2, 40, 200, 128), True, (16, 8)),
    ((1, 1, 16, 136, 64), True, (16, 8)),
    ((1, 2, 72, 200, 64), False, (8, 8)),
])
def test_reference_matches_pallas_fwd(shape, causal, blocks):
    b, h, sq, sk, d = shape
    q, k, v = _qkv(b, h, sq, sk, d, seed=sq + sk)
    o_j, lse_j = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, *blocks)
    o_t, lse_t = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, :sq],
                               atol=1e-5)


def test_rows_without_keys_give_zero():
    """s_q > s_k under causal: the first rows see no key (O = 0, the
    lse of the TPU kernel's empty row)."""
    q, k, v = _qkv(1, 1, 8, 4, 16, seed=1)
    o, lse = flash_attention_reference(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), True)
    assert torch.all(o[0, 0, :4] == 0)
    assert torch.all(lse[0, :4] == np.float32(-1e30))
    ref = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_matches_jax_with_key_padding(causal):
    q, k, v = _qkv(2, 2, 24, 24, 16, seed=3)
    mask = np.ones((2, 1, 1, 24), bool)
    mask[:, :, :, 20:] = False
    ref = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, mask=jnp.asarray(mask))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # a key-padding mask takes the blockwise path, as in the JAX package's
    # routing, with the key block of flash_block_k; it agrees with dense
    routed = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             mask=torch.from_numpy(mask))
    assert torch.equal(routed, ak.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, mask=torch.from_numpy(mask),
        block_k=ak.flash_block_k(24)))
    np.testing.assert_allclose(routed.numpy(), got.numpy(), atol=1e-5)
    np.testing.assert_allclose(routed.numpy(), np.asarray(ref), atol=1e-5)


def test_routing_and_wrapper_contract():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 16, 16, seed=5))
    before = ak.flash_fwd.launches
    o = flash_attention(q, k, v, causal=True)
    assert torch.equal(o, flash_attention_reference(q, k, v, True)[0])
    assert ak.flash_fwd.launches == before  # the CPU path launches nothing
    # segments go to the kernel's path; id-0 rows come out as 0
    seg = torch.tensor([[1] * 6 + [2] * 7 + [0] * 3])
    o = flash_attention(q, k, v, causal=True, segments=seg)
    ref = flash_attention_reference(q, k, v, True, seg)[0]
    assert torch.equal(o[:, :, :13], ref[:, :, :13])
    assert torch.all(o[:, :, 13:] == 0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        flash_attention(q, k, v, segments=seg, mask=torch.ones(1, 16) > 0)
    with pytest.raises(ValueError, match="CUDA"):
        ak._flash_fwd_cuda(q, k, v, True)  # the kernel wrapper never takes CPU


@pytest.mark.parametrize("sq,sk,bq,bk,causal", [
    (1024, 1024, 512, 512, True), (1024, 1024, 64, 64, True),
    (256, 1024, 64, 64, True), (512, 512, 128, 64, False),
    (128, 384, 64, 128, True),
    # the Hopper forward's 128-row query tiles, 128- or 64-key tiles
    (1024, 1024, 128, 128, True), (1152, 1152, 128, 128, True),
    (256, 1024, 128, 128, True), (128, 1024, 128, 64, True),
    (1024, 1024, 128, 128, False)])
def test_live_tile_pairs_matches_jax(sq, sk, bq, bk, causal):
    assert ak.live_tile_pairs(sq, sk, bq, bk, causal, sk - sq) == \
        _live_block_pairs(sq, sk, bq, bk, causal, sk - sq)


def test_live_tile_pairs_ragged_and_empty():
    # 1000 rows in 64-tiles: the ragged last tile counts once per live pair
    assert ak.live_tile_pairs(1000, 1000, 64, 64, True, 0) == 16 * 17 // 2
    # s_q > s_k: query tiles wholly before the first key are skipped
    assert ak.live_tile_pairs(128, 32, 64, 64, True, -96) == 1


def _cuda_qkv(dtype, d, sq, sk):
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda unavailable")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    return tuple(torch.randn(2, 4, s, d, device="cuda", generator=g).to(dtype)
                 for s in (sq, sk, sk))


def _cuda_segments(sq):
    """(2, sq) packed document ids with id-0 padding at the end of each
    row."""
    rs = np.random.RandomState(sq)
    seg = np.zeros((2, sq), np.int32)
    for row in seg:
        cuts = np.sort(rs.choice(np.arange(1, sq - 8), 3, replace=False))
        for i, (a, b) in enumerate(zip([0, *cuts], [*cuts, sq - 8])):
            row[a:b] = i + 1
    return torch.from_numpy(seg).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal,sq,sk,use_seg", [
    (torch.bfloat16, 128, True, 1024, 1024, False),
    (torch.float32, 128, True, 1000, 1000, False),
    (torch.bfloat16, 64, False, 512, 512, False),
    (torch.bfloat16, 128, True, 16, 1024, False),
    (torch.float32, 32, True, 40, 72, False),
    (torch.bfloat16, 128, True, 1024, 1024, True),
    (torch.bfloat16, 64, True, 1000, 1000, False),
    (torch.bfloat16, 128, True, 1000, 1000, False),
    (torch.bfloat16, 64, True, 16, 1024, False),
    (torch.bfloat16, 64, True, 300, 300, True),
])
def test_cuda_kernel_matches_plain(dtype, d, causal, sq, sk, use_seg):
    q, k, v = _cuda_qkv(dtype, d, sq, sk)
    seg = _cuda_segments(sq) if use_seg else None
    o, lse = ak.flash_fwd(q, k, v, causal, seg)
    o_ref, lse_ref = flash_attention_reference(q, k, v, causal, seg)
    torch.cuda.synchronize()
    atol_o, atol_l = (2e-5, 2e-5) if dtype == torch.float32 else (2e-2, 1e-2)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol_o,
                               rtol=1e-5)
    torch.testing.assert_close(lse, lse_ref, atol=atol_l, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d,use_seg", [(128, False), (64, True)])
def test_cuda_forward_is_deterministic(d, use_seg):
    """Every output row is written once by one CTA, without atomics: two
    runs on the same inputs give the same bits."""
    q, k, v = _cuda_qkv(torch.bfloat16, d, 1024, 1024)
    seg = _cuda_segments(1024) if use_seg else None
    first = ak.flash_fwd(q, k, v, True, seg)
    second = ak.flash_fwd(q, k, v, True, seg)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
