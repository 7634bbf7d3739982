"""The port's fully sharded data parallelism (``bigdl_tpu_torch.parallel.
FullyShardedDataParallel``) against the JAX package's on the CPU: the port
runs 2 gloo ranks started by ``parallel.launch.spawn`` with a time limit
(the cases are in tests/torch_tp_cases.py), the JAX package runs
``FullyShardedDataParallel`` on 2 of conftest's virtual devices.

Held: 3 SGD-momentum steps of the MLP and a 2-layer LM against JAX FSDP
(1e-5 and 1e-4) and, with the conv net's synced BN, against the port's
``DataParallel`` (1e-5); the hooks gather one module at a time, in the
forward and again in the backward (not once a step); a rank holds only
its own parameters' storage and optimizer state.
"""

import jax
import numpy as np
import pytest
import torch

import torch_tp_cases as C
from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.core import Sequential as JSequential
from bigdl_tpu.dataset import BatchDataSet as JaxBatchDataSet
from bigdl_tpu.parallel import FullyShardedDataParallel as JaxFSDP
from bigdl_tpu.parallel import make_mesh as jax_make_mesh
from bigdl_tpu_torch.interop import tensors_from_jax
from bigdl_tpu_torch.parallel.launch import spawn

ATOL = 1e-5
LM_ATOL = 1e-4
JOB_TIMEOUT_S = 200
ENV = {"PYTHONPATH": C.__file__.rsplit("/", 1)[0]}


def _jax_models():
    return {"mlp": JSequential(jnn.Linear(8, 32), jnn.Tanh(),
                               jnn.Linear(32, 4), jnn.LogSoftMax()),
            "lm": jax_models.transformer_lm(32, d_model=16, num_layers=2,
                                            num_heads=4, max_len=8),
            "conv": JSequential(jnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1,
                                                       1),
                                jnn.SpatialBatchNormalization(8), jnn.ReLU(),
                                jnn.SpatialConvolution(8, 4, 3, 3),
                                jnn.Reshape([4 * 4 * 4]), jnn.Linear(64, 5),
                                jnn.LogSoftMax())}


@pytest.fixture(scope="module")
def fsdp_job(tmp_path_factory):
    """JAX init trees and seeded inputs; the 2-rank job's results."""
    root = tmp_path_factory.mktemp("fsdp")
    rs = np.random.RandomState(0)
    inp = {"mlp_x": (rs.rand(64, 8) * 2 - 1).astype(np.float32),
           "mlp_y": rs.randint(0, 4, 64).astype(np.int32),
           "lm_x": rs.randint(0, 32, (8, 8)).astype(np.int32),
           "lm_y": rs.randint(0, 32, (8, 8)).astype(np.int32),
           "conv_x": rs.randn(16, 6, 6, 3).astype(np.float32),
           "conv_y": rs.randint(0, 5, 16).astype(np.int32)}
    trees = {}
    ports = {"mlp": C.mlp(), "lm": C.lm(), "conv": C.conv_net()}
    for name, jm in _jax_models().items():
        p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(
            3)))
        s = jm.init_state() if name == "conv" else None
        trees[name] = (jm, p)
        inp.update({f"{name}/{k}": v.numpy() for k, v in
                    tensors_from_jax(ports[name], p, s).items()})
    np.savez(root / "inputs.npz", **inp)
    spawn("torch_tp_cases:run_all", 2, {"dir": str(root),
                                        "cases": ["fsdp"]},
          timeout_s=JOB_TIMEOUT_S, backend="gloo", env=ENV)
    return inp, trees, [dict(np.load(root / f"fsdp_r{r}.npz"))
                        for r in range(2)]


@pytest.mark.parametrize("name", ["mlp", "lm"])
def test_fsdp_matches_jax_fsdp(name, fsdp_job):
    inp, trees, got = fsdp_job
    jm, p = trees[name]
    if name == "mlp":
        crit, x, y, batch, lr, tol = (jnn.ClassNLLCriterion(), "mlp_x",
                                      "mlp_y", 64, 0.5, ATOL)
    else:
        crit, x, y, batch, lr, tol = (
            jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()), "lm_x",
            "lm_y", 4, 0.1, LM_ATOL)
    opt = joptim.Optimizer(jm, JaxBatchDataSet(inp[x], inp[y], batch,
                                               shuffle=False), crit,
                           optim_method=joptim.SGD(lr, momentum=0.9),
                           end_when=joptim.Trigger.max_iteration(C.STEPS),
                           strategy=JaxFSDP(jax_make_mesh(
                               {"data": 2}, devices=jax.devices()[:2])))
    opt.set_state(params=jax.tree_util.tree_map(jax.numpy.asarray, p))
    want = jax.tree_util.tree_map(np.asarray, opt.optimize().params)
    tm = C.mlp() if name == "mlp" else C.lm()
    for k, v in tensors_from_jax(tm, want).items():
        np.testing.assert_allclose(got[0][f"fsdp/{name}/{k}"], v.numpy(),
                                   atol=tol, err_msg=k)
        np.testing.assert_array_equal(got[1][f"fsdp/{name}/{k}"],
                                      got[0][f"fsdp/{name}/{k}"])


@pytest.mark.parametrize("name", ["mlp", "conv", "lm"])
def test_fsdp_matches_data_parallel(name, fsdp_job):
    """The same steps under the port's DataParallel: parameters and the
    synced BN's running statistics within 1e-5."""
    got = fsdp_job[2][0]
    keys = [k[len(f"dp/{name}/"):] for k in got
            if k.startswith(f"dp/{name}/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[f"fsdp/{name}/{k}"],
                                   got[f"dp/{name}/{k}"], atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("name,modules", [("mlp", 2), ("conv", 4)])
def test_fsdp_gathers_one_module_at_a_time(name, modules, fsdp_job):
    """Each module that holds parameters is gathered in the forward and
    again in the backward, one parameter a broadcast (2 a module here),
    and at most one module is whole at a time: 2 x 2 x modules gathers a
    step, not one gather of the model a step."""
    gathers, max_whole, n_modules = fsdp_job[2][0][f"acct/{name}"].tolist()
    assert n_modules == modules
    assert max_whole == 1
    assert gathers == C.STEPS * 2 * 2 * modules


def test_fsdp_rank_holds_its_own_leaves(fsdp_job):
    """Placed, each rank's parameter storage is its own leaves (whole
    leaves, balanced by bytes) and its optimizer state theirs only: the
    two ranks' bytes sum to the model's."""
    r0, r1 = (g["resident"].tolist() for g in fsdp_job[2])
    total = r0[1]
    assert r0[0] + r1[0] == total and 0 < r0[0] < total
    assert r0[2] + r1[2] == total and r0[2] == r0[0]
