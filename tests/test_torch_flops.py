"""The port's analytic FLOP count (bigdl_tpu_torch/utils/flops.py) against
the JAX package's (bigdl_tpu/utils/flops.py ``fn_flops_by_kind``), kind by
kind (rtol 1e-6): products, grouped and strided convolutions with their
gradients, the GEMM spelling of a 1x1, the flash kernels' declared counts,
whole training steps (resnet_cifar(20), ResNet-50 and its s2d row at
batch 2, a 2-layer LM with flash on in both packages), counted on fake
tensors; the perf harness's peak table and JSON line."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu.ops import conv2d as jc2d
from bigdl_tpu.ops import flash_attention as jflash
from bigdl_tpu.utils.flops import fn_flops_by_kind as jax_flops
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.cli import perf
from bigdl_tpu_torch.ops import conv2d as tc2d
from bigdl_tpu_torch.ops import flash_attention as tflash
from bigdl_tpu_torch.utils import flops

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _pristine():
    jc2d.reset_conv_pass_layouts()
    tc2d.reset_conv_pass_layouts()
    yield
    jc2d.reset_conv_pass_layouts()
    tc2d.reset_conv_pass_layouts()


def _same(port: dict, jax_: dict):
    assert set(port) == set(jax_) == {"matmul", "conv"}
    for k in port:
        np.testing.assert_allclose(port[k], jax_[k], rtol=RTOL, err_msg=k)


def test_matmul():
    M, N, K, B = 64, 32, 128, 3
    _same(flops.fn_flops_by_kind(lambda a, b: a @ b, torch.zeros(M, K),
                                 torch.zeros(K, N)),
          jax_flops(lambda a, b: a @ b, jnp.zeros((M, K)),
                    jnp.zeros((K, N))))
    _same(flops.fn_flops_by_kind(torch.matmul, torch.zeros(B, M, K),
                                 torch.zeros(B, K, N)),
          jax_flops(jnp.matmul, jnp.zeros((B, M, K)), jnp.zeros((B, K, N))))


def _jconv(stride, pad, groups):
    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, stride, pad, feature_group_count=groups,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return conv


def _tconv(stride, pad, groups):
    def conv(x, w):
        return F.conv2d(x.permute(0, 3, 1, 2), w, None, stride, pad, 1,
                        groups).permute(0, 2, 3, 1)
    return conv


@pytest.mark.parametrize("name,x_shape,cout,k,stride,pad,groups", [
    ("grouped", (2, 8, 8, 16), 32, 3, 1, 1, 4),
    ("depthwise", (2, 8, 8, 16), 16, 3, 1, 1, 16),
    ("strided_patchify", (2, 32, 32, 3), 24, 8, 8, 0, 1),
    ("strided_padded", (2, 15, 15, 6), 10, 3, 2, 1, 1)])
def test_conv_and_its_gradients(name, x_shape, cout, k, stride, pad,
                                groups):
    """The forward, and the forward with both gradients: dgrad counts the
    conv JAX's transpose builds (a strided conv's zeros excluded), wgrad
    the forward's."""
    cin = x_shape[-1]
    jx, jw = jnp.zeros(x_shape), jnp.zeros((k, k, cin // groups, cout))
    tx, tw = torch.zeros(x_shape), torch.zeros(cout, cin // groups, k, k)
    jc = _jconv((stride, stride), ((pad, pad), (pad, pad)), groups)
    tc = _tconv((stride, stride), (pad, pad), groups)
    _same(flops.fn_flops_by_kind(tc, tx, tw), jax_flops(jc, jx, jw))

    def tgrad(x, w):
        x.requires_grad_(True)
        w.requires_grad_(True)
        torch.autograd.grad((tc(x, w) ** 2).sum(), [x, w])

    _same(flops.fn_flops_by_kind(tgrad, tx, tw),
          jax_flops(jax.grad(lambda x, w: jnp.sum(jc(x, w) ** 2),
                             argnums=(0, 1)), jx, jw))


@pytest.mark.parametrize("layout", ["NHWC", "GEMM"])
def test_1x1_under_gemm_and_nhwc(layout):
    """The policy conv at a 1x1 site with both gradients: GEMM moves the
    count from conv to matmul, the total is the same, both as in JAX."""
    x_shape, cin, cout = (2, 6, 6, 8), 8, 16
    for mod in (jc2d, tc2d):
        mod.set_conv_pass_layouts(layout, layout, layout)

    def jstep(x, w):
        return jax.grad(lambda a, b: jnp.sum(jc2d.conv2d(
            a, b, (1, 1), ((0, 0), (0, 0)), (1, 1), 1) ** 2),
            argnums=(0, 1))(x, w)

    def tstep(x, w):
        x.requires_grad_(True)
        w.requires_grad_(True)
        y = tc2d.conv2d(x, w, (1, 1), ((0, 0), (0, 0)))
        torch.autograd.grad((y ** 2).sum(), [x, w])

    got = flops.fn_flops_by_kind(tstep, torch.zeros(x_shape),
                                 torch.zeros(cout, cin, 1, 1))
    _same(got, jax_flops(jstep, jnp.zeros(x_shape),
                         jnp.zeros((1, 1, cin, cout))))
    unit = flops.conv_unit_flops(2, 6, 6, cin, cout, 1, 1)
    assert got["matmul"] + got["conv"] == 3 * unit
    assert got["matmul" if layout == "GEMM" else "conv"] == 3 * unit


@pytest.mark.parametrize("causal", [False, True])
def test_flash_declared_counts(causal):
    """Flash at explicit 128 blocks: the port's declared forward and
    backward counts against the JAX kernels' CostEstimate (qk+pv; dP+dQ
    and dV+dK, recomputation excluded; causal skipping block-granular);
    and the port's Function at the default blocks against JAX's."""
    b, h, s, d = 2, 4, 512, 64
    q = jnp.ones((b, h, s, d), jnp.float32)

    def attn(q, blocks):
        return jflash(q, q, q, causal=causal, block_q=blocks,
                      block_k=blocks)

    fwd, bwd = flops.flash_flops(b, h, s, s, d, causal, 128, 128)
    np.testing.assert_allclose(
        fwd, jax_flops(lambda q: attn(q, 128), q)["matmul"], rtol=RTOL)
    np.testing.assert_allclose(
        fwd + bwd, jax_flops(lambda q: jax.value_and_grad(
            lambda q: jnp.sum(attn(q, 128)))(q), q)["matmul"], rtol=RTOL)
    unit = 2.0 * b * h * s * s * d
    assert (fwd < 2 * unit) == causal and bwd == 2 * fwd

    def tstep(q):
        q.requires_grad_(True)
        torch.autograd.grad(tflash(q, q, q, causal=causal).sum(), [q])

    _same(flops.fn_flops_by_kind(tstep, torch.ones(b, h, s, d)),
          jax_flops(lambda q: jax.value_and_grad(
              lambda q: jnp.sum(attn(q, None)))(q), q))


def _jax_step_flops(model, x_shape, x_dtype, y_shape, crit):
    """The JAX perf harness's single step (forward, loss on the f32
    output, gradients, SGD update) counted on abstract parameters."""
    from bigdl_tpu.optim import SGD

    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    state = model.init_state()
    opt = SGD(learning_rate=0.01, momentum=0.9)
    opt_state = jax.eval_shape(opt.init, params)

    def step(p, s, o, x, y):
        def loss_fn(p):
            out, ms = model.apply(p, s, x, training=True,
                                  rng=jax.random.PRNGKey(0))
            return crit(out.astype(jnp.float32), y), ms
        (loss, ms), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return opt.update(g, o, p)

    return jax_flops(step, params, state, opt_state,
                     jax.ShapeDtypeStruct(x_shape, x_dtype),
                     jax.ShapeDtypeStruct(y_shape, jnp.int32))


@pytest.mark.parametrize("row,jax_build", [
    ("resnet20_cifar", lambda: jmodels.resnet_cifar(20, 10)),
    ("resnet50", lambda: jmodels.resnet50(1000)),
    ("resnet50_s2d", lambda: jmodels.resnet50(1000, s2d_stem=True)),
    ("alexnet", lambda: jmodels.alexnet(1000))])
def test_perf_rows_count_equal_jax(row, jax_build):
    """cli.perf's count of a row's step at batch 2 (fake tensors: no
    full-size step runs here) equals the JAX count, by kind; ResNet-50's
    per image lies in the JAX test's 20-32 GF. AlexNet's dropout takes
    the step's seed, as in cli.perf's step."""
    model, in_shape = perf.build_model(row)
    got = perf.step_flops(model, row, 2, torch.float32)
    _same(got, _jax_step_flops(jax_build(), (2, *in_shape), jnp.float32,
                               (2,), jnn.ClassNLLCriterion()))
    if row.startswith("resnet50"):
        per_image = (got["matmul"] + got["conv"]) / 2
        assert 20e9 < per_image < 32e9, per_image


def test_lm_with_flash_on_in_both_packages():
    """A 2-layer LM (RoPE, grouped KV heads, s = 1024 so the JAX causal
    blocks of 512 skip one pair of four) with flash forced on in both
    packages: the declared attention counts plus every projection."""
    V, B, S = 97, 1, 1024
    cfg = dict(d_model=64, num_layers=2, num_heads=4, max_len=S,
               num_kv_heads=2, pos_encoding="rope")
    got = flops.step_flops_by_kind(
        tmodels.transformer_lm(V, attn_impl="flash", **cfg), (B, S),
        torch.int32, (B, S),
        tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion()))
    want = _jax_step_flops(
        jmodels.transformer_lm(V, attn_impl="flash", **cfg), (B, S),
        jnp.int32, (B, S),
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()))
    _same(got, want)
    attn = flops.flash_flops(B, 4, S, S, 16, True)
    assert attn[0] < 2 * 2.0 * B * 4 * S * S * 16  # causal skipping
    assert got["conv"] == 0


@pytest.mark.parametrize("name,label,peak", [
    ("NVIDIA H100 80GB HBM3", "h10080gbhbm3", 989.4e12),
    ("NVIDIA H100 PCIe", "h100pcie", 756e12),
    ("NVIDIA H100 NVL", "h100nvl", 835e12),
    ("cpu", "cpu", 1e12),
    ("NVIDIA A100-SXM4-80GB", "UNMATCHED(NVIDIA A100-SXM4-80GB)->"
                              "1e12-nominal", 1e12)])
def test_peak_table(name, label, peak):
    assert perf.peak_flops(name) == (peak, label)


def test_perf_line_carries_mfu(capsys):
    import json

    out = perf.main(["-m", "resnet20_cifar", "-b", "2", "-i", "1",
                     "--platform", "cpu", "--fusedBN", "apply"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["mfu_basis"] == "analytic"
    assert line["peak_flops_device_match"] == "cpu"
    assert line["peak_flops_assumed"] == 1e12
    assert line["step_gflops_hlo"] is None
    assert line["step_gflops_by_kind"]["conv"] > 0
    want = line["step_gflops_analytic"] * 1e9 * out["iterations"] / \
        out["seconds"] / 1e12
    assert 0 < line["mfu"] == pytest.approx(want, rel=1e-2, abs=1e-4)
    assert line["mfu_pct"] == pytest.approx(line["mfu"] * 100, abs=0.01)
    assert "conv_layouts" not in line and "conv_geom" not in line


def test_perf_profile_writes_a_trace(tmp_path):
    """--profile DIR: a torch.profiler trace of the timed loop."""
    import json

    perf.main(["-m", "resnet20_cifar", "-b", "2", "-i", "1", "--platform",
               "cpu", "--profile", str(tmp_path)])
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("conv" in e.get("name", "") for e in trace["traceEvents"])


def test_transposed_conv_count_is_refused():
    """The count does not guess JAX's rule for a transposed convolution."""
    m = tnn.SpatialFullConvolution(4, 4, 3, 3, 2, 2)
    with pytest.raises(NotImplementedError, match="transposed"):
        flops.fn_flops_by_kind(m, torch.zeros(1, 5, 5, 4))
