"""The port's flash-attention backward (bigdl_tpu_torch.ops.attention_kernel)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU the port runs the kernels' plain twins; the CUDA kernels are
held against those twins by the cuda-marked test below, which runs only on
a machine with a card (and by chip_smoke.py).

Tolerances: f32 atol 1e-5 (the two sum in different orders, nothing else
differs). bf16: both sides round P and dS to bf16 at the same points, but
an f32 sum in another order can land on the other side of a bf16 rounding
boundary, so a gradient may differ by a few bf16 ulps of its largest
entry: max|d| <= 2e-2 * max|ref|."""

import ctypes
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.attention_kernel import _flash_bwd, _flash_fwd
from bigdl_tpu.ops.attention_kernel import flash_attention as jax_flash
from bigdl_tpu_torch.dataset import pack_sequences
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import attention_kernel as ak

F32_ATOL = 1e-5
BF16_REL = 2e-2


def _arrays(b, h, sq, sk, d, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, s, d).astype(np.float32)
                 for s in (sq, sk, sk, sq))  # q, k, v, dO


def _segments(b, s, seed):
    """Packed-row ids from pack_sequences of seeded lengths into rows of
    s - s//8, then id-0 padding to s: every row ends in padding."""
    rs = np.random.RandomState(seed)
    docs = [[1] * n for n in rs.randint(3, s // 2, 4 * b)]
    _, seg = pack_sequences(docs, s - s // 8)
    seg = np.pad(seg[:b], ((0, 0), (0, s // 8)))
    assert seg.shape == (b, s) and (seg > 1).any()
    return seg


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _close(got, ref, dtype):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)
    else:
        assert np.abs(got - ref).max() <= BF16_REL * np.abs(ref).max()


# (b, h, s_q, s_k, d), causal, Pallas blocks (bq, bk), segments
CASES = {
    "causal": ((1, 2, 64, 64, 32), True, (16, 16), False),
    "noncausal": ((1, 2, 64, 64, 32), False, (32, 16), False),
    "ragged": ((1, 2, 40, 40, 32), True, (16, 8), False),
    "sq_lt_sk": ((1, 2, 16, 64, 32), True, (16, 16), False),
    "segments": ((2, 2, 64, 64, 32), True, (16, 16), True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_reference_matches_pallas_bwd(case, dtype):
    (b, h, sq, sk, d), causal, blocks, use_seg = CASES[case]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, k, v, g = _arrays(b, h, sq, sk, d, seed=sq + sk)
    seg = _segments(b, sq, seed=3) if use_seg else None
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jseg = None if seg is None else jnp.asarray(seg)
    o, lse = _flash_fwd(jq, jk, jv, causal, *blocks, segments=jseg)
    dq, dk, dv = _flash_bwd(jq, jk, jv, o, lse, jg, causal, *blocks,
                            segments=jseg)
    # the same q, k, v, o, lse and dO on both sides (lse without the
    # Pallas row padding)
    tq, tk, tv, tg, to = (_t(a, dtype) for a in (jq, jk, jv, jg, o))
    tlse = _t(lse)[:, :sq].contiguous()
    tseg = None if seg is None else torch.from_numpy(seg)
    got = ak.flash_bwd_reference(tq, tk, tv, to, tlse, tg, causal, tseg)
    for t, r in zip(got, (dq, dk, dv)):
        assert t.dtype == dtype
        _close(t, r, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_reference_with_segments_matches_pallas(causal):
    q, k, v, _ = _arrays(2, 2, 64, 64, 32, seed=11)
    seg = _segments(2, 64, seed=5)
    o_j, lse_j = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, 16, 16, segments=jnp.asarray(seg))
    o_t, lse_t = ak.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, torch.from_numpy(seg))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=F32_ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, :64],
                               atol=F32_ATOL)


# (b, h, s_q, s_k, d), causal, segments: the routes of flash_attention
GRAD_CASES = {
    "causal": ((1, 2, 64, 64, 32), True, False),
    "noncausal": ((2, 2, 32, 32, 16), False, False),
    "sq_lt_sk": ((1, 2, 32, 64, 32), True, False),
    "rows_without_keys": ((1, 2, 64, 32, 32), True, False),
    "segments": ((2, 2, 64, 64, 32), True, True),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_function_grads_match_jax_grad(case):
    """The autograd Function (twins on the CPU) against jax.grad of the
    JAX package's flash_attention (its custom_vjp over the interpret-mode
    kernels), including the segments route and its zeroed id-0 rows."""
    (b, h, sq, sk, d), causal, use_seg = GRAD_CASES[case]
    q, k, v, g = _arrays(b, h, sq, sk, d, seed=7 + sq)
    seg = _segments(b, sq, seed=9) if use_seg else None
    jseg = None if seg is None else jnp.asarray(seg)

    def loss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, causal=causal, segments=jseg)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ak.flash_attention(tq, tk, tv, causal=causal,
                             segments=None if seg is None
                             else torch.from_numpy(seg))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=F32_ATOL)
    if use_seg:  # id-0 padding rows come out as 0, and pass no gradient
        pad = seg == 0
        assert np.all(out.detach().numpy()[np.broadcast_to(
            pad[:, None, :, None], out.shape)] == 0)
        assert np.all(tq.grad.numpy()[np.broadcast_to(
            pad[:, None, :, None], tq.shape)] == 0)
    for t, r in zip((tq, tk, tv), grads_j):
        assert bool(torch.isfinite(t.grad).all())
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=F32_ATOL)


def test_wrappers_count_only_kernel_launches_and_refuse_cpu_tensors():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(1, 2, 32, 32, 16, 1))
    before = {n: getattr(ak, n).launches
              for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    o, lse = ak.flash_fwd(q, k, v, True)
    dq, dk, dv = ak.flash_bwd(q, k, v, o, lse, g, True)
    assert torch.equal(dq, ak.flash_bwd_reference(q, k, v, o, lse, g,
                                                  True)[0])
    assert before == {n: getattr(ak, n).launches for n in before}
    delta = ak._delta(o, g)
    with pytest.raises(ValueError, match="CUDA"):  # never the twin
        ak._launch_bwd("flash_dq", q, k, v, g, lse, delta, True, None,
                       (torch.empty_like(q),))


# C parameter types of the kernels' entry points and the ctypes type each
# must be bound with (a pointer bound as an int would be cut to 32 bits)
_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "const int*": ctypes.c_void_p, "const long long*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


@pytest.mark.parametrize("name", ["flash_dq", "flash_dkv", "flash_fwd"])
def test_bwd_entry_points_match_their_bindings(name, monkeypatch):
    """The extern "C" signature in flash_bwd.cu (flash_fwd.cu for the
    forward) against the argtypes attention_kernel._bind sets, without a
    card: a library stand-in takes the place of the built one."""
    source = "flash_fwd.cu" if name == "flash_fwd" else "flash_bwd.cu"
    src = (Path(ak.__file__).parent / "csrc" / source).read_text()
    entry = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    assert entry is not None
    c_types = []
    for param in entry.group(1).split(","):
        decl = " ".join(param.replace("*", "* ").split())
        c_type = re.sub(r"\s*\w+$", "", decl).replace(" *", "*")
        c_types.append(_C_TYPES[c_type])
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace()})
    monkeypatch.setattr(_build, "load", lambda _: lib)
    monkeypatch.setattr(ak, "_fns", {})
    fn = ak._bind(name)
    assert fn.argtypes == c_types
    assert fn.restype is ctypes.c_int


def _cuda_case(dtype, d, causal, sq, sk, use_seg):
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda unavailable")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 4, s, d, device="cuda", generator=g).to(dtype)
               for s in (sq, sk, sk))
    do = torch.randn(2, sq, 4, d, device="cuda", generator=g).to(
        dtype).transpose(1, 2)
    seg = (torch.from_numpy(_segments(2, sq, seed=1)).cuda() if use_seg
           else None)
    o, lse = ak.flash_fwd(q, k, v, causal, seg)
    return q, k, v, o, lse, do, seg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal,sq,sk,use_seg", [
    (torch.bfloat16, 128, True, 1024, 1024, False),
    (torch.float32, 128, True, 1000, 1000, False),
    (torch.bfloat16, 64, False, 512, 512, False),
    (torch.bfloat16, 128, True, 16, 1024, False),
    (torch.float32, 32, True, 72, 40, False),
    (torch.bfloat16, 128, True, 1024, 1024, True),
    (torch.bfloat16, 64, True, 16, 1024, False),
    (torch.bfloat16, 128, True, 1000, 1000, False),
    (torch.bfloat16, 64, False, 1000, 1000, False),
    (torch.bfloat16, 64, True, 512, 512, True),
    (torch.bfloat16, 32, True, 72, 40, False),
])
def test_cuda_backward_kernels_match_plain(dtype, d, causal, sq, sk,
                                           use_seg):
    q, k, v, o, lse, do, seg = _cuda_case(dtype, d, causal, sq, sk, use_seg)
    got = ak.flash_bwd(q, k, v, o, lse, do, causal, seg)
    ref = ak.flash_bwd_reference(q, k, v, o, lse, do, causal, seg)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else BF16_REL
    for t, r in zip(got, ref):
        assert float((t.float() - r.float()).abs().max()) <= \
            tol * float(r.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d,use_seg", [(128, False), (64, True)])
def test_cuda_backward_kernels_are_deterministic(d, use_seg):
    """Every output tile is written once by one CTA, without atomics: two
    runs on the same inputs give the same bits."""
    q, k, v, o, lse, do, seg = _cuda_case(torch.bfloat16, d, True, 1024,
                                          1024, use_seg)
    first = ak.flash_bwd(q, k, v, o, lse, do, True, seg)
    second = ak.flash_bwd(q, k, v, o, lse, do, True, seg)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
