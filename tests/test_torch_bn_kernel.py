"""The port's batch-norm kernels (bigdl_tpu_torch.ops.bn_kernel) against the
JAX package's Pallas kernels, run in interpret mode on the CPU, and its
two autograd Functions against ``jax.vjp`` of the JAX custom VJPs.

On the CPU the port runs the kernels' plain twins; the CUDA kernels are
held against those twins by the cuda-marked test below (and by
chip_smoke.py), which runs only on a machine with a card.

Tolerances. The per-channel sums are f32 on both sides, summed in other
orders: rtol 1e-5. f32 y, dx, mean and var: atol 1e-5. bf16 y and dx are
computed in f32 and rounded once on both sides; a sum in another order can
move a value across a bf16 rounding boundary, so they may differ by one
bf16 ulp of the reference value. Where x·scale + shift cancels to near 0,
the f32 rounding of the O(1) terms (atol 1e-6) is more than a bf16 ulp of
the tiny result, so that atol is the floor."""

import ctypes
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import bn_kernel as jbk
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import bn_kernel as bk

EPS = 1e-5
ATOL = 1e-5
SUM_RTOL = 1e-5
BF16_ATOL = 1e-6
# (rows, C) where the JAX kernels engage: rows % 512 == 0, C % 128 == 0
SHAPES = [(1024, 256), (512, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(rows, c, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, c) * 1.5 + 0.3).astype(np.float32)
    dy = rs.randn(rows, c).astype(np.float32)
    gamma = (1.0 + 0.2 * rs.randn(c)).astype(np.float32)
    beta = (0.2 * rs.randn(c)).astype(np.float32)
    return x, dy, gamma, beta


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.array(t, np.float32))


def _sums_close(got, ref):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, rtol=SUM_RTOL,
                               atol=SUM_RTOL * np.abs(ref).max())


def _elems_close(got, ref, dtype):
    """y or dx: atol 1e-5 in f32; in bf16 one bf16 ulp of the reference,
    at least BF16_ATOL."""
    got, ref = _np(got), _np(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        return
    _, exp = np.frexp(np.maximum(np.abs(ref), 1e-30))
    ulp = np.maximum(np.ldexp(np.float32(1.0), exp - 8),  # 8 significant bits
                     BF16_ATOL)
    assert np.all(np.abs(got - ref) <= ulp), float(
        np.max(np.abs(got - ref) / ulp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c", SHAPES)
def test_stats_twins_match_jax(rows, c, dtype):
    x, dy, _, _ = _arrays(rows, c, seed=rows + c)
    jx, tx = _both(x, dtype)
    for got, ref in zip(bk.bn_stats(tx), jbk.bn_stats(jx)):
        _sums_close(got, ref)
    # the port's bn_bwd_stats(dy, x, mean, inv) against the JAX
    # bn_bwd_stats(dy, x̂) on x̂ = (x.astype(f32) − mean)·inv, as the JAX
    # backward builds it
    mean = x.mean(0).astype(np.float32)
    inv = (1.0 / x.std(0)).astype(np.float32)
    jdy, tdy = _both(dy, dtype)
    jxhat = (jx.astype(jnp.float32) - jnp.asarray(mean)) * jnp.asarray(inv)
    ref = jbk.bn_bwd_stats(jdy, jxhat)
    got = bk.bn_bwd_stats(tdy, tx, torch.from_numpy(mean),
                          torch.from_numpy(inv))
    for g, r in zip(got, ref):
        _sums_close(g, r)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c", SHAPES)
def test_fused_block_twins_match_jax(rows, c, dtype, relu):
    x, dy, gamma, beta = _arrays(rows, c, seed=3 * rows + c)
    jx, tx = _both(x, dtype)
    jdy, tdy = _both(dy, dtype)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    y, mean, var = bk.bn_fwd_apply(tx, tg, tb, EPS, relu)
    ry, rmean, rvar = jbk.bn_fwd_apply(jx, jnp.asarray(gamma),
                                       jnp.asarray(beta), EPS, relu)
    assert y.dtype == tx.dtype and mean.dtype == var.dtype == torch.float32
    _elems_close(y, ry, dtype)
    np.testing.assert_allclose(_np(mean), _np(rmean), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(var), _np(rvar), rtol=0, atol=ATOL)

    # the backward from the same f32 mean and inv on both sides
    inv = (1.0 / np.sqrt(_np(rvar) + EPS)).astype(np.float32)
    vecs = [_np(rmean), inv, gamma, beta]
    dx, sdy, sdyx = bk.bn_bwd_fused(tdy, tx,
                                    *(torch.from_numpy(v) for v in vecs),
                                    relu)
    rdx, rsdy, rsdyx = jbk.bn_bwd_fused(jdy, jx,
                                        *(jnp.asarray(v) for v in vecs),
                                        relu)
    assert dx.dtype == tx.dtype
    _elems_close(dx, rdx, dtype)
    _sums_close(sdy, rsdy)
    _sums_close(sdyx, rsdyx)


# (8, 8, 8, 128) takes JAX's kernels (rows 512, C 128); (8, 3, 3, 20) its
# jnp fallback, which computes the same function
@pytest.mark.parametrize("shape", [(8, 8, 8, 128), (8, 3, 3, 20)])
@pytest.mark.parametrize("mode", ["stats", "apply", "apply_relu"])
def test_functions_match_jax_vjp(shape, mode):
    rs = np.random.RandomState(sum(shape))
    x = (rs.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    c = shape[-1]
    gamma = (1.0 + 0.2 * rs.randn(c)).astype(np.float32)
    beta = (0.2 * rs.randn(c)).astype(np.float32)
    relu = mode == "apply_relu"
    if mode == "stats":
        jfn = lambda a, g, b: jbk.fused_bn_train(a, g, b, EPS)
        tfn = lambda a, g, b: bk.fused_bn_train(a, g, b, EPS)
    else:
        jfn = lambda a, g, b: jbk.fused_bn_apply_train(a, g, b, EPS, relu)
        tfn = lambda a, g, b: bk.fused_bn_apply_train(a, g, b, EPS, relu)
    (ry, rmean, rvar), vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(gamma),
                                     jnp.asarray(beta))
    rdx, rdg, rdb = vjp((jnp.asarray(dy), jnp.zeros(c), jnp.zeros(c)))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, gamma, beta))
    y, mean, var = tfn(tx, tg, tb)
    assert not mean.requires_grad and not var.requires_grad
    dx, dg, db = torch.autograd.grad(y, (tx, tg, tb), torch.from_numpy(dy))
    for got, ref in ((y, ry), (mean, rmean), (var, rvar), (dx, rdx)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=ATOL)
    for got, ref in ((dg, rdg), (db, rdb)):  # dγ = Σ(dy·x̂), dβ = Σdy
        _sums_close(got, ref)


# ResNet-50's 12 BN shapes at batch 128, (rows, C) of NHWC activations,
# with the number of BNs of each (bigdl_tpu/models/resnet.py, the stride on
# the 3x3 conv)
RESNET50_BNS = {(1605632, 64): 1, (401408, 64): 6, (401408, 128): 1,
                (401408, 256): 4, (100352, 128): 7, (100352, 256): 1,
                (100352, 512): 5, (25088, 256): 11, (25088, 512): 1,
                (25088, 1024): 7, (6272, 512): 5, (6272, 2048): 4}
# the plan's cases: those in bf16, resnet_cifar(20)'s three in f32 (the
# CIFAR CLI), and ragged ones; (16, 40000) in f32 has more channel blocks
# (313) than the grid holds
PLAN_CASES = ([(r, c, "bfloat16") for r, c in RESNET50_BNS]
              + [(131072, 16, "float32"), (32768, 32, "float32"),
                 (8192, 64, "float32"), (1000, 100, "bfloat16"),
                 (7, 3, "bfloat16"), (16, 40000, "bfloat16"),
                 (16, 40000, "float32")])
SMS, CTAS_PER_SM = 132, 2  # an H100 at two 256-thread CTAs an SM
# where bn_fwd_apply's 24 rows a thread hold every row of the slab, so x
# is read from device memory once: ResNet-50's bf16 x of at most ~26 MB
# (28 of its 53 BNs) and every case below 3 MB; not where C has more
# blocks than the grid (no row is kept then)
FWD_ONCE = {(100352, 128, "bfloat16"), (25088, 256, "bfloat16"),
            (25088, 512, "bfloat16"), (6272, 512, "bfloat16"),
            (6272, 2048, "bfloat16"), (131072, 16, "float32"),
            (32768, 32, "float32"), (8192, 64, "float32"),
            (1000, 100, "bfloat16"), (7, 3, "bfloat16"),
            (16, 40000, "bfloat16")}
# bn_bwd_fused's 11 (dy, x) rows a thread fit fewer
FUSED_ONCE = {(6272, 512, "bfloat16"), (131072, 16, "float32"),
              (32768, 32, "float32"), (8192, 64, "float32"),
              (1000, 100, "bfloat16"), (7, 3, "bfloat16"),
              (16, 40000, "bfloat16")}


def test_fwd_once_is_28_of_resnet50s_53_bns():
    assert sum(RESNET50_BNS.values()) == 53
    assert sum(n for (r, c), n in RESNET50_BNS.items()
               if (r, c, "bfloat16") in FWD_ONCE) == 28


@pytest.mark.parametrize("mode", ["stats", "fwd", "bwd_stats", "bwd_fused"])
@pytest.mark.parametrize("rows,c,dtype", PLAN_CASES)
def test_launch_plan(rows, c, dtype, mode):
    """bn_coop's plan, without a card: slabs cover the rows, the grid fits
    the CTAs given, a slab holds at least _SLAB_ROWS rows a thread unless
    it is the only one, and the operands are read once exactly where the
    design keeps every row in shared memory."""
    m = {"stats": bk._STATS, "fwd": bk._FWD, "bwd_stats": bk._BWD_STATS,
         "bwd_fused": bk._BWD_FUSED}[mode]
    vec = 16 // (2 if dtype == "bfloat16" else 4)
    while c % vec:
        vec //= 2
    ctas = SMS * CTAS_PER_SM
    p = bk._plan(m, rows, c, vec, ctas)
    ty = bk._NTHREADS // p.tx
    assert p.tx & (p.tx - 1) == 0 and 1 <= p.tx <= 32
    assert p.blocks * p.tx * vec >= c > (p.blocks - 1) * p.tx * vec
    assert p.slabs * p.slab >= rows > (p.slabs - 1) * p.slab
    assert p.grid == min(ctas, p.blocks * p.slabs) >= 1
    assert p.slabs == 1 or p.slab >= bk._SLAB_ROWS * ty
    assert p.slabs == 1 or p.blocks * p.slabs <= ctas
    want = {"fwd": (rows, c, dtype) in FWD_ONCE,
            "bwd_fused": (rows, c, dtype) in FUSED_ONCE}.get(mode, True)
    assert p.once == want


# C parameter types of bn.cu's entry points and the ctypes type each must
# be bound with (a pointer bound as an int would be cut to 32 bits)
_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "unsigned*": ctypes.c_void_p,
            "int*": ctypes.POINTER(ctypes.c_int), "int": ctypes.c_int,
            "float": ctypes.c_float, "long long": ctypes.c_longlong}


@pytest.mark.parametrize("name", ["bn_coop", "bn_coop_ctas"])
def test_entry_points_match_their_bindings(name, monkeypatch):
    """The extern "C" signature in bn.cu against the argtypes
    bn_kernel._bind sets, without a card: a library stand-in takes the
    place of the built one."""
    src = (Path(bk.__file__).parent / "csrc" / "bn.cu").read_text()
    entry = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    assert entry is not None
    c_types = []
    for param in entry.group(1).split(","):
        decl = " ".join(param.replace("*", "* ").split())
        c_types.append(_C_TYPES[re.sub(r"\s*\w+$", "", decl)
                                .replace(" *", "*")])
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace()})
    monkeypatch.setattr(_build, "load", lambda _: lib)
    monkeypatch.setattr(bk, "_fns", {})
    fn = bk._bind(name)
    assert fn.argtypes == c_types
    assert fn.restype is ctypes.c_int


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# (16, 40000): more channel blocks than the one-launch backward's grid
# holds at once, so its CTAs loop over several
@pytest.mark.parametrize("rows,c", [(4096, 256), (1000, 100), (7, 3),
                                    (16, 40000)])
def test_cuda_bn_kernels_match_plain(rows, c, dtype):
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda unavailable")
    g = torch.Generator(device="cuda").manual_seed(rows + c)
    x = (torch.randn(rows, c, device="cuda", generator=g) * 1.5).to(dtype)
    dy = torch.randn(rows, c, device="cuda", generator=g).to(dtype)
    gamma = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
    beta = 0.2 * torch.randn(c, device="cuda", generator=g)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4

    def rel(a, r):
        return float((a.float() - r.float()).abs().max()
                     / r.float().abs().max().clamp_min(1e-30))

    for relu in (False, True):
        got = bk.bn_fwd_apply(x, gamma, beta, EPS, relu)
        ref = bk.bn_fwd_apply_reference(x, gamma, beta, EPS, relu)
        assert max(rel(a, r) for a, r in zip(got, ref)) <= tol
        inv = torch.rsqrt(ref[2] + EPS)
        got = bk.bn_bwd_fused(dy, x, ref[1], inv, gamma, beta, relu)
        want = bk.bn_bwd_fused_reference(dy, x, ref[1], inv, gamma, beta, relu)
        assert max(rel(a, r) for a, r in zip(got, want)) <= tol
    for got, want in ((bk.bn_stats(x), bk.bn_stats_reference(x)),
                      (bk.bn_bwd_stats(dy, x, ref[1], inv),
                       bk.bn_bwd_stats_reference(dy, x, ref[1], inv))):
        assert max(rel(a, r) for a, r in zip(got, want)) <= 1e-4
