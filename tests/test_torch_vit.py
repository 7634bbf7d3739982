"""The port's ViT (bigdl_tpu_torch/models/vit.py) against the JAX
package's on the CPU: a small ViT (image 32, patch 8, 2 layers) from the
JAX init tree, loaded strictly with ``interop.load_jax``, matches in
log-probs (1e-5) and parameter gradients (1e-4 of max|g|), with the port
on the flash kernels' plain twins; ``vit_b16``/``vit_s16`` head counts;
the patch-size check; the step's analytic FLOPs equal the JAX count (the
stride-16 patchify's data gradient counts its forward's MACs); a tiny ViT
learns two synthetic classes through the Optimizer; the ``cli.perf``
rows at a CPU width, graphed steps and ``--strategy dp`` over 2 gloo
ranks included."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_vit_dp_case as C
from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu.cli import perf as jperf
from bigdl_tpu.utils.flops import fn_flops_by_kind as jax_flops
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.cli import perf
from bigdl_tpu_torch.dataset import BatchDataSet
from bigdl_tpu_torch.interop import (load_jax, params_from_jax,
                                     tensors_from_jax)
from bigdl_tpu_torch.optim import (SGD, Optimizer, Top1Accuracy, Trigger,
                                   Validator)
from bigdl_tpu_torch.parallel.launch import spawn
from bigdl_tpu_torch.utils import flops

SMALL = dict(image_size=32, patch_size=8, d_model=64, num_layers=2,
             num_heads=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: torch's intra-op threads only add spinning,
    and beside other test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vit_pair():
    jm = jmodels.ViT(7, **SMALL)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    tm = load_jax(tmodels.ViT(7, attn_impl="flash", **SMALL), params,
                  jm.init_state())
    return jm, params, tm


def test_param_names_follow_the_jax_tree(vit_pair):
    _, params, tm = vit_pair
    assert set(params) == {"patch", "encoder", "ln", "head"}
    assert set(params_from_jax(params)) == set(tm.state_dict())


def test_logprobs_and_grads_match_jax(vit_pair):
    jm, params, tm = vit_pair
    rs = np.random.RandomState(0)
    x = rs.randn(3, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 7, 3).astype(np.int32)
    crit = jnn.ClassNLLCriterion()

    def loss(p):
        out, _ = jm.apply(p, jm.init_state(), jnp.asarray(x))
        return crit(out, jnp.asarray(y)), out

    (_, jo), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tm.train()
    to = tm(torch.from_numpy(x))
    tl = tnn.ClassNLLCriterion()(to, torch.from_numpy(y))
    names = [n for n, _ in tm.named_parameters()]
    tg = torch.autograd.grad(tl, list(tm.parameters()))
    assert to.dtype == torch.float32 and to.shape == (3, 7)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=1e-5, rtol=0)
    # the JAX gradients in the port's layouts (the patch kernel's OIHW),
    # against one scale, max|g| over every parameter: a key bias's is zero
    # up to rounding (it shifts a query's every score alike)
    want = {n: t.numpy() for n, t in tensors_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jg)).items()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    for n, g in zip(names, tg):
        err = float(np.abs(g.numpy() - want[n]).max()) / scale
        assert err <= 1e-4, (n, err)


def test_head_counts_and_patch_check():
    b16 = tmodels.vit_b16(10)
    assert b16.encoder[0].mha.num_heads == 6 and b16.n_patches == 196
    assert tmodels.vit_s16(10).encoder[0].mha.num_heads == 3
    with pytest.raises(ValueError, match="divisible"):
        tmodels.ViT(10, image_size=224, patch_size=15)


def test_step_flops_equal_jax():
    """The step count of a small ViT with flash on in both packages, and
    of the stride-16 patchify with both of its gradients: the data
    gradient counts the forward's MACs (not 256 times them)."""
    from bigdl_tpu.optim import SGD as JSGD

    model = jmodels.ViT(10, attn_impl="flash", **SMALL)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    opt = JSGD(learning_rate=0.01, momentum=0.9)
    o = jax.eval_shape(opt.init, params)
    crit = jnn.ClassNLLCriterion()

    def step(p, s, o, x, y):
        def lf(p):
            out, ms = model.apply(p, s, x, training=True,
                                  rng=jax.random.PRNGKey(0))
            return crit(out.astype(jnp.float32), y), ms
        (_, _), g = jax.value_and_grad(lf, has_aux=True)(p)
        return opt.update(g, o, p)

    want = jax_flops(step, params, model.init_state(), o,
                     jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32),
                     jax.ShapeDtypeStruct((2,), jnp.int32))
    got = flops.step_flops_by_kind(
        tmodels.ViT(10, attn_impl="flash", **SMALL), (2, 32, 32, 3),
        torch.float32, (2,), tnn.ClassNLLCriterion(),
        forward_kwargs={"seed": 0})
    for k in ("matmul", "conv"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)

    def jconv(x, w):
        return jnp.sum(jax.lax.conv_general_dilated(
            x, w, (16, 16), "VALID", dimension_numbers=("NHWC", "HWIO",
                                                        "NHWC")))

    x_shape, w_shape = (2, 224, 224, 3), (16, 16, 3, 768)
    jboth = jax_flops(jax.grad(jconv, argnums=(0, 1)),
                      jnp.zeros(x_shape), jnp.zeros(w_shape))

    def tboth(x, w):
        x.requires_grad_(True)
        w.requires_grad_(True)
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, None, 16)
        torch.autograd.grad(y.sum(), (x, w))

    tcount = flops.fn_flops_by_kind(tboth, torch.zeros(x_shape),
                                    torch.zeros(768, 3, 16, 16))
    unit = flops.conv_unit_flops(2, 14, 14, 3, 768, 16, 16)
    assert tcount["conv"] == jboth["conv"] == 3 * unit


def test_tiny_vit_learns_two_classes():
    rng = np.random.RandomState(1)
    n = 192
    y = rng.randint(0, 2, n).astype(np.int32)
    x = rng.randn(n, 32, 32, 3).astype(np.float32) * 0.1
    x[y == 0, 4:14, 4:14] += 1.0
    x[y == 1, 18:28, 18:28] += 1.0
    m = tmodels.ViT(2, image_size=32, patch_size=8, d_model=64,
                    num_layers=2, num_heads=2, attn_impl="flash",
                    generator=torch.Generator().manual_seed(0))
    Optimizer(m, BatchDataSet(x, y, 32, shuffle=True),
              tnn.ClassNLLCriterion(),
              optim_method=SGD(learning_rate=0.05, momentum=0.9),
              end_when=Trigger.max_epoch(8), seed=0, log_every=100,
              device="cpu").optimize()
    (res,) = Validator(m, BatchDataSet(x, y, 64), "cpu").test(
        [Top1Accuracy()])
    assert res.result()[0] > 0.9, res


@pytest.mark.parametrize("row", ["vit_b16", "vit_s16"])
def test_perf_rows_at_a_cpu_width(row, monkeypatch, capsys):
    """The row's model (flash, 1000 classes, 224 x 224 x 3, as the JAX
    harness's) and its JSON line, eager and graphed, on 32 x 32 images
    with one layer."""
    cfg, shape, classes = perf.IMAGE_CONFIGS[row]
    assert (cfg, shape, classes) == (dict(arch=row, attn_impl="flash"),
                                     (224, 224, 3), 1000)
    jm, jshape = jperf.build_model(row)
    assert jshape == shape and jm.head.out_features == classes
    width = {"vit_b16": 768, "vit_s16": 384}[row]
    monkeypatch.setitem(perf.IMAGE_CONFIGS, row, (
        dict(cfg, arch="vit", d_model=width, image_size=32, patch_size=8,
             num_layers=1), (32, 32, 3), 10))
    for extra in ([], ["--innerSteps", "2"]):
        out = perf.main(["-m", row, "--platform", "cpu", "-b", "2", "-i",
                         "1", "--f32"] + extra)
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["model"] == row and line["step_gflops_by_kind"][
            "conv"] > 0
        assert all(np.isfinite(out["losses"]))


def test_perf_row_under_data_parallel():
    """``--strategy dp`` with a ViT row: 2 gloo ranks on the global batch
    give the single process's losses."""
    env = {"PYTHONPATH": C.__file__.rsplit("/", 1)[0]}
    res = spawn("torch_vit_dp_case:run_row", 2,
                {"batch": 4, "iterations": 2, "strategy": "dp"},
                timeout_s=240, backend="gloo", env=env)
    single = C.run_row({"batch": 4, "iterations": 2})
    assert [r["n_devices"] for r in res] == [2, 2]
    for r in res:
        np.testing.assert_allclose(r["losses"], single["losses"],
                                   rtol=1e-5)
