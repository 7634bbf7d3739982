"""The port's tensor parallelism (``bigdl_tpu_torch.parallel.
TensorParallel``, ``megatron_specs``, the model-axis meshes) against the
JAX package's on the CPU. The port runs 2 and 4 gloo ranks, each a fresh
process started by ``parallel.launch.spawn`` with a time limit (the cases
are in tests/torch_tp_cases.py); the JAX package runs in this process on
conftest's virtual devices.

Held: ``megatron_specs`` equal to JAX's spec tree on the models of
tests/test_tensor_parallel.py, ``TransformerLM`` and a small conv net
(one case a model; GQA at a K that does not divide the KV heads is the
stated difference, tested on its own); tp:2 and dp:2 x tp:2 against JAX
``TensorParallel`` on 2 and 4 virtual devices over 3 SGD steps (1e-5 the
MLP, 1e-4 the 2-layer LM, JAX's own tolerances); the dropout MLP, the
conv net, the GQA LM (KV heads split at K = 2, whole at K = 4) against the
port's single process; LARS and LAMB at tp:2 (whole norms of split
leaves) against JAX ``TensorParallel``; ``make_mesh`` and ``make_hybrid_mesh`` rank
layouts against the JAX device layouts; ``cli.perf --strategy tp``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_tp_cases as C
from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.core import Sequential as JSequential
from bigdl_tpu.dataset import BatchDataSet as JaxBatchDataSet
from bigdl_tpu.parallel import TensorParallel as JaxTensorParallel
from bigdl_tpu.parallel import make_hybrid_mesh as jax_hybrid_mesh
from bigdl_tpu.parallel import make_mesh as jax_make_mesh
from bigdl_tpu.parallel import megatron_specs as jax_specs
from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.core.module import Sequential
from bigdl_tpu_torch.interop import tensors_from_jax
from bigdl_tpu_torch.parallel import megatron_specs
from bigdl_tpu_torch.parallel.launch import spawn
from bigdl_tpu_torch.parallel.mesh import hybrid_layout

MLP_ATOL = 1e-5
LM_ATOL = 1e-4
JOB_TIMEOUT_S = 200
# the ranks import the cases module from this directory
ENV = {"PYTHONPATH": C.__file__.rsplit("/", 1)[0]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ specs
def _pair(name):
    """(JAX model, port model) of one spec case."""
    if name == "mlp":
        return (JSequential(jnn.Linear(8, 32), jnn.Tanh(), jnn.Linear(32, 4),
                            jnn.LogSoftMax()), C.mlp())
    if name == "block":
        return (jnn.TransformerEncoderLayer(d_model=16, num_heads=4,
                                            d_ff=32),
                nn.TransformerEncoderLayer(16, 4, 32))
    if name == "branchy":
        return (JSequential(
            jnn.Concat(JSequential(jnn.Linear(8, 16), jnn.ReLU(),
                                   jnn.Linear(16, 8)),
                       JSequential(jnn.Linear(8, 32), jnn.Tanh(),
                                   jnn.Linear(32, 8))),
            jnn.Linear(16, 10)),
            Sequential(nn.Concat(Sequential(nn.Linear(8, 16), nn.ReLU(),
                                            nn.Linear(16, 8)),
                                 Sequential(nn.Linear(8, 32), nn.Tanh(),
                                            nn.Linear(32, 8))),
                       nn.Linear(16, 10)))
    if name == "odd_chain":
        return (JSequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 8),
                            jnn.ReLU(), jnn.Linear(8, 4)),
                Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 8),
                           nn.ReLU(), nn.Linear(8, 4)))
    if name == "indivisible":
        return (JSequential(jnn.Linear(8, 7), jnn.Tanh(), jnn.Linear(7, 3)),
                Sequential(nn.Linear(8, 7), nn.Tanh(), nn.Linear(7, 3)))
    if name == "dropout":
        return (JSequential(jnn.Linear(8, 32), jnn.Dropout(0.5),
                            jnn.Linear(32, 4), jnn.LogSoftMax()),
                C.dropout_mlp())
    if name == "lm":
        return (jax_models.transformer_lm(32, d_model=16, num_layers=2,
                                          num_heads=4, max_len=8), C.lm())
    if name == "lm_gqa":
        return (jax_models.transformer_lm(32, d_model=16, num_layers=2,
                                          num_heads=4, max_len=8,
                                          num_kv_heads=2), C.lm(2))
    if name == "lm_untied":
        return (jax_models.transformer_lm(32, d_model=16, num_layers=1,
                                          num_heads=4, max_len=8,
                                          tie_embeddings=False),
                models.TransformerLM(32, d_model=16, num_layers=1,
                                     num_heads=4, max_len=8,
                                     tie_embeddings=False))
    if name == "conv":
        return (JSequential(jnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
                            jnn.SpatialBatchNormalization(8), jnn.ReLU(),
                            jnn.SpatialConvolution(8, 4, 3, 3),
                            jnn.Reshape([4 * 4 * 4]), jnn.Linear(64, 5),
                            jnn.LogSoftMax()), C.conv_net())
    raise KeyError(name)


def _leaves(tree, path=""):
    """{path: spec} of a spec tree's leaves (a parameterless layer's empty
    subtree has none)."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{path}/{k}"))
    return out


def _assert_same_specs(port, jax_tree):
    got = {k: P(*v) for k, v in _leaves(port).items()}
    assert got == _leaves(jax_tree)


# GQA at K = 4 over 2 KV heads is left out: the port keeps wk/wv whole
# there (the stated difference, test_gqa_kv_whole_when_k_does_not_divide)
SPEC_CASES = [(name, k) for name in (
    "mlp", "block", "branchy", "odd_chain", "indivisible", "dropout", "lm",
    "lm_gqa", "lm_untied", "conv") for k in (2, 4)
    if (name, k) != ("lm_gqa", 4)]


@pytest.mark.parametrize("name,k", SPEC_CASES)
def test_megatron_specs_match_jax(name, k):
    """The port's spec tree is JAX's, leaf for leaf, for every model."""
    jm, tm = _pair(name)
    params = jm.init(jax.random.PRNGKey(0))
    want = jax_specs(jm, params, "model", k)
    _assert_same_specs(megatron_specs(tm, None, "model", k), want)


def test_gqa_kv_whole_when_k_does_not_divide():
    """At K = 4 over 2 KV heads JAX splits wk/wv through a KV head (GSPMD
    repairs it); the port keeps wk/wv and their biases whole, and every
    other leaf as JAX."""
    jm, tm = _pair("lm_gqa")
    want = jax_specs(jm, jm.init(jax.random.PRNGKey(0)), "model", 4)
    got = megatron_specs(tm, None, "model", 4)
    for i in ("0", "1"):
        mha_w, mha_g = want["encoder"][i]["mha"], got["encoder"][i]["mha"]
        for leaf in ("wk", "wv", "bk", "bv"):
            assert mha_g[leaf] == () and mha_w[leaf] != P()
            mha_w[leaf] = P()
    _assert_same_specs(got, want)


# ---------------------------------------------------------------- training
@pytest.fixture(scope="module")
def jax_models_and_inputs(tmp_path_factory):
    """Seeded inputs and JAX init trees, converted for the port."""
    root = tmp_path_factory.mktemp("tp")
    rs = np.random.RandomState(0)
    inp = {"mlp_x": (rs.rand(64, 8) * 2 - 1).astype(np.float32),
           "mlp_y": rs.randint(0, 4, 64).astype(np.int32),
           "lm_x": rs.randint(0, 32, (8, 8)).astype(np.int32),
           "lm_y": rs.randint(0, 32, (8, 8)).astype(np.int32),
           "conv_x": rs.randn(16, 6, 6, 3).astype(np.float32),
           "conv_y": rs.randint(0, 5, 16).astype(np.int32)}
    jax_trees = {}
    for name, pair in (("mlp", "mlp"), ("lm", "lm"), ("gqa", "lm_gqa"),
                       ("drop", "dropout"), ("conv", "conv")):
        jm, tm = _pair(pair)
        p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(
            7)))
        s = jm.init_state() if name == "conv" else None
        jax_trees[name] = (jm, p)
        inp.update({f"{name}/{k}": v.numpy() for k, v in
                    tensors_from_jax(tm, p, s).items()})
    np.savez(root / "inputs.npz", **inp)
    return root, inp, jax_trees


@pytest.fixture(scope="module")
def tp_jobs(jax_models_and_inputs):
    """The 2-rank job (tp:2, every model) and one 4-rank job running
    dp:2 x tp:2 for the MLP and the LM, then tp:4 for the GQA LM and the
    LM; {ranks: results}."""
    root = jax_models_and_inputs[0]
    out = {}
    spawn("torch_tp_cases:run_all", 2,
          {"dir": str(root), "cases": ["tp", "perf"], "k": 2,
           "models": list(C.TP_MODELS)},
          timeout_s=JOB_TIMEOUT_S, backend="gloo", env=ENV)
    out[2] = [dict(np.load(root / f"tp_r{r}.npz")) for r in range(2)]
    out["perf"] = [dict(np.load(root / f"perf_r{r}.npz")) for r in range(2)]
    spawn("torch_tp_cases:run_all", 4,
          {"dir": str(root), "cases": ["tp"], "runs": [
              {"k": 2, "models": ["mlp", "lm"]},
              {"k": 4, "models": ["gqa", "lm"], "prefix": "tp4_"}]},
          timeout_s=JOB_TIMEOUT_S, backend="gloo", env=ENV)
    out[4] = [dict(np.load(root / f"tp_r{r}.npz")) for r in range(4)]
    out["tp4"] = [dict(np.load(root / f"tp4_tp_r{r}.npz")) for r in range(4)]
    return out


def _jax_method(name, lr):
    """The JAX twin of ``torch_tp_cases.make_method``."""
    if name == "lars":
        return joptim.LARS(lr, momentum=0.9, weight_decay=1e-4)
    if name == "lamb":
        return joptim.LAMB(lr, weight_decay=1e-2)
    return joptim.SGD(lr, momentum=0.9)


def _jax_tp_train(jm, params, x, y, batch, n_dev, crit, lr, method="sgd"):
    mesh = jax_make_mesh({"data": n_dev // 2, "model": 2},
                         devices=jax.devices()[:n_dev])
    opt = joptim.Optimizer(jm, JaxBatchDataSet(x, y, batch, shuffle=False),
                           crit, optim_method=_jax_method(method, lr),
                           end_when=joptim.Trigger.max_iteration(C.STEPS),
                           strategy=JaxTensorParallel(mesh, jm))
    opt.set_state(params=jax.tree_util.tree_map(jax.numpy.asarray, params))
    return jax.tree_util.tree_map(np.asarray, opt.optimize().params)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("name", ["mlp", "lm"])
def test_tp_training_matches_jax(name, ranks, jax_models_and_inputs,
                                 tp_jobs):
    """tp:2 (2 ranks) and dp:2 x tp:2 (4 ranks) against JAX
    TensorParallel on 2 and 4 virtual devices: 3 SGD-momentum steps; every
    rank ends with the same whole parameters."""
    _, inp, trees = jax_models_and_inputs
    jm, p = trees[name]
    if name == "mlp":
        crit, x, y, batch, lr, tol = (jnn.ClassNLLCriterion(), "mlp_x",
                                      "mlp_y", 64, 0.5, MLP_ATOL)
    else:
        crit, x, y, batch, lr, tol = (
            jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()), "lm_x",
            "lm_y", 4, 0.1, LM_ATOL)
    want = _jax_tp_train(jm, p, inp[x], inp[y], batch, ranks, crit, lr)
    tm = C.mlp() if name == "mlp" else C.lm()
    want = {k: v.numpy() for k, v in tensors_from_jax(tm, want).items()}
    got = tp_jobs[ranks]
    for k, v in want.items():
        np.testing.assert_allclose(got[0][f"{name}/{k}"], v, atol=tol,
                                   err_msg=k)
        for r in range(1, ranks):
            np.testing.assert_array_equal(got[r][f"{name}/{k}"],
                                          got[0][f"{name}/{k}"])


@pytest.mark.parametrize("job,name", [(2, "drop"), (2, "conv"), (2, "gqa"),
                                      (2, "clip"), ("tp4", "gqa"),
                                      ("tp4", "lm")])
def test_tp_matches_one_process(job, name, jax_models_and_inputs, tp_jobs):
    """Models whose tp forward JAX runs with other noise or kernels,
    against the port's single process: the dropout MLP (the masks hash the
    whole activation's index), the conv net (split output channels
    gathered before its BN), the GQA LM at tp:2 (KV heads split) and tp:4
    (KV heads whole on every rank), the LM at tp:4, and the LM with its
    gradients clipped to a global norm (the split leaves' squares summed
    over the model axis)."""
    root, _, _ = jax_models_and_inputs
    inp = np.load(root / "inputs.npz")
    want = C.train_named(name, inp)
    got = tp_jobs[job][0]
    tol = LM_ATOL if name in ("gqa", "lm", "clip") else MLP_ATOL
    for k, v in want.items():
        np.testing.assert_allclose(got[f"{name}/{k}"], v, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("method", ["lars", "lamb"])
def test_tp_refuses_per_tensor_norm_methods(method, jax_models_and_inputs,
                                            tp_jobs):
    """LARS and LAMB under tp:2 take a split leaf's whole norm (its
    slice's square sum all-reduced over the model axis): the MLP's
    Optimizer run (3 steps) against JAX ``TensorParallel`` with the same
    method on 2 virtual devices, params within 1e-5 of max|p|. (Until the
    norms were whole, tp refused these methods; the name stays.)"""
    _, inp, trees = jax_models_and_inputs
    jm, p = trees["mlp"]
    _, _, _, _, kw = C.TP_MODELS[method]
    want = _jax_tp_train(jm, p, inp["mlp_x"], inp["mlp_y"], 64, 2,
                         jnn.ClassNLLCriterion(), kw["lr"], method)
    want = {k: v.numpy() for k, v in tensors_from_jax(C.mlp(), want).items()}
    pmax = max(float(np.abs(v).max()) for v in want.values())
    got = tp_jobs[2]
    for k, v in want.items():
        np.testing.assert_allclose(got[0][f"{method}/{k}"], v,
                                   atol=1e-5 * pmax, err_msg=k)
        np.testing.assert_array_equal(got[1][f"{method}/{k}"],
                                      got[0][f"{method}/{k}"])


def test_perf_tp_row_matches_one_process(tp_jobs):
    """``cli.perf`` at --strategy tp over 2 ranks: the line names tp, its
    mesh and devices, and its losses are the single process's; the
    time-to-accuracy run at --strategy dp carries --gradCompress and
    --gradBuckets in its line, as the JAX harness's does."""
    from bigdl_tpu_torch.cli import perf
    perf.LM_CONFIGS["tp_test_lm"] = dict(d_model=32, num_layers=2,
                                         num_heads=4, max_len=16,
                                         pos_encoding="rope", num_kv_heads=2)
    try:
        one = perf.run("tp_test_lm", batch=4, iterations=2, warmup=1,
                       dtype=torch.float32, device="cpu", seq_len=16)
    finally:
        del perf.LM_CONFIGS["tp_test_lm"]
    got = tp_jobs["perf"][0]
    assert got["tp_line"].tolist() == [2, 2, 1]
    np.testing.assert_allclose(got["losses"], one["losses"], atol=1e-5)
    assert got["tta"].tolist()[0] == 1 and got["tta"].tolist()[1] >= 1
    assert got["tta"].tolist()[2] == 1


# ------------------------------------------------------------------ meshes
@pytest.mark.parametrize("dcn,ici,slices", [
    ({"data": 2}, {"model": 4}, 2), ({"data": -1}, {"model": 2}, 4),
    ({"data": 4}, {"seq_like": 2}, 4), ({"data": 1}, {"model": 8}, None),
    ({"replica": 2}, {"data": 2, "model": 2}, 2)])
def test_hybrid_mesh_layout_matches_jax(dcn, ici, slices):
    """``make_hybrid_mesh``'s rank layout is the JAX function's device
    layout over 8 devices (one node split into ``slices`` virtual
    slices), and ``make_mesh``'s is the JAX one with ``model``
    innermost."""
    sizes, layout = hybrid_layout(dcn, ici, 8, 8, slices)
    jm = jax_hybrid_mesh(dcn, ici, devices=jax.devices()[:8],
                         num_slices=slices)
    assert tuple(sizes) == jm.axis_names
    assert layout.tolist() == np.vectorize(lambda d: d.id)(
        jm.devices).tolist()
    from bigdl_tpu_torch.parallel import mesh as tmesh
    flat = jax_make_mesh({"data": 4, "model": 2},
                         devices=jax.devices()[:8])
    assert np.arange(8).reshape(4, 2).tolist() == np.vectorize(
        lambda d: d.id)(flat.devices).tolist()
    assert tmesh.make_mesh({"data": 1, "model": 1}).shape == {"data": 1,
                                                              "model": 1}
