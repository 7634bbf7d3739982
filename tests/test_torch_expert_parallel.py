"""The port's expert parallelism (``nn.MoE.place_expert_parallel``) and
``cli.perf``'s pp and ep harness against the JAX package's on the CPU. The
port runs one job of 2 gloo ranks (the cases are in
tests/torch_spe_cases.py); the JAX package runs in this process on 2 of
conftest's virtual devices, from the same JAX init trees.

Held: one SGD-momentum step of MSE plus 0.01 x the auxiliary loss of an
MoE (top-2, top-1, dense) placed over {"expert": 2} against JAX's
``place_expert_parallel`` step: the loss, and each rank's experts and the
replicated gate within 1e-5 of max|p|; the harness of ``cli.perf
--strategy pp`` ({"pipe": 2, "data": 1}) and ``ep`` ({"expert": 2}) at
``transformer_lm`` geometry with a short sequence against
``bigdl_tpu.cli.perf._setup_strategy_harness``: every step's loss within
1e-5 relative; ``cli.perf.run``'s line (strategy, mesh, devices) and the
``--gradCompress`` exits under pp and ep with the JAX text.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spe_cases as C
from bigdl_tpu import nn as jnn
from bigdl_tpu.cli import perf as jax_perf
from bigdl_tpu.core import Sequential as JSequential
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.parallel import make_mesh as jax_make_mesh
from bigdl_tpu_torch.interop import params_from_jax, tensors_from_jax
from bigdl_tpu_torch.parallel.launch import spawn

JOB_TIMEOUT_S = 200
ENV = {"PYTHONPATH": C.__file__.rsplit("/", 1)[0]}
RANKS = 2
HARNESS_MESH = {"pp": {"pipe": 2, "data": 1}, "ep": {"expert": 2}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmoe(case):
    return jnn.MoE(JSequential(jnn.Linear(C.MOE_D, C.MOE_H), jnn.ReLU(),
                               jnn.Linear(C.MOE_H, C.MOE_D)),
                   C.MOE_E, C.MOE_D, **C.MOE_CASES[case])


def _jax_harness(name):
    """The JAX harness's setup on 2 devices at C.HARNESS geometry."""
    h = C.HARNESS
    mesh = jax_make_mesh(HARNESS_MESH[name], devices=jax.devices()[:2])
    return jax_perf._setup_strategy_harness(
        name, h["model"], h["batch"], mesh, HARNESS_MESH[name], jnp.float32,
        h["seq"])


@pytest.fixture(scope="module")
def ep_job(tmp_path_factory):
    """The JAX MoE init trees and harness setups, seeded inputs, and the
    2-rank job's results {case: [rank's npz]} and notes."""
    root = tmp_path_factory.mktemp("ep")
    rs = np.random.RandomState(0)
    shape = (2, 6, C.MOE_D)
    inp = {"moe_x": rs.randn(*shape).astype(np.float32),
           "moe_y": rs.randn(*shape).astype(np.float32)}
    trees = {}
    for case in C.MOE_CASES:
        trees[case] = jax.tree_util.tree_map(
            np.asarray, _jmoe(case).init(jax.random.PRNGKey(1)))
        inp.update({f"moe_{case}/{k}": t.numpy() for k, t in
                    tensors_from_jax(C.moe(case), trees[case]).items()})
    setups = {name: _jax_harness(name) for name in HARNESS_MESH}
    for name, setup in setups.items():
        inp.update({f"{name}/{k}": t.numpy() for k, t in params_from_jax(
            jax.device_get(setup["params"])).items()})
    np.savez(root / "inputs.npz", **inp)
    cases = ["ep", "harness"]
    notes = spawn("torch_spe_cases:run_all", RANKS,
                  {"dir": str(root), "cases": cases},
                  timeout_s=JOB_TIMEOUT_S, backend="gloo", env=ENV)
    out = {c: [dict(np.load(root / f"{c}_r{r}.npz")) for r in range(RANKS)]
           for c in cases}
    return inp, trees, setups, out, notes


@pytest.mark.parametrize("case", list(C.MOE_CASES))
def test_ep_moe_step_matches_jax(case, ep_job):
    inp, trees, _, out, _ = ep_job
    moe = _jmoe(case)
    mesh = jax_make_mesh({"expert": 2}, devices=jax.devices()[:2])
    params = moe.place_expert_parallel(
        mesh, jax.tree_util.tree_map(jnp.asarray, trees[case]))
    opt = JSGD(learning_rate=C.MOE_LR, momentum=0.9)
    x, y = jnp.asarray(inp["moe_x"]), jnp.asarray(inp["moe_y"])

    @jax.jit
    def step(p, o):
        def loss_fn(p):
            out, st = moe.apply(p, moe.init_state(), x, training=True)
            return (jnn.MSECriterion()(out, y)
                    + C.MOE_AUX * st["aux_loss"])

        loss, g = jax.value_and_grad(loss_fn)(p)
        new_p, _ = opt.update(g, o, p)
        return new_p, loss

    new_p, loss = step(params, opt.init(params))
    want = {k: t.numpy() for k, t in tensors_from_jax(
        C.moe(case), jax.device_get(new_p)).items()}
    pmax = max(float(np.abs(v).max()) for v in want.values())
    for r in range(RANKS):
        got = out["ep"][r]
        lo, hi = got[f"{case}/stage"]
        assert (lo, hi) == (2 * r, 2 * r + 2)
        assert abs(float(got[f"{case}/loss"]) - float(loss)) <= \
            1e-5 * abs(float(loss))
        for k, v in want.items():
            np.testing.assert_allclose(
                got[f"{case}/{k}"], v if k == "gate" else v[lo:hi],
                atol=1e-5 * pmax, err_msg=k)


@pytest.mark.parametrize("name", list(HARNESS_MESH))
def test_perf_harness_matches_jax(name, ep_job):
    """The port's harness from the JAX harness's weights: each step's loss
    (the last is the line's ``final_loss``); the line and the exits."""
    _, _, setups, out, notes = ep_job
    s = setups[name]
    p, o, ms = s["params"], s["opt_state"], {}
    want = []
    for i in range(C.HARNESS["steps"]):
        p, ms, o, loss = s["step"](p, ms, o, s["x"], s["y"],
                                   jax.random.PRNGKey(i))
        want.append(float(loss))
    for r in range(RANKS):
        np.testing.assert_allclose(out["harness"][r][f"{name}/losses"],
                                   want, rtol=1e-5)
    line = notes[0]["harness"][name]
    assert line == {"strategy": name, "mesh": HARNESS_MESH[name],
                    "n_devices": 2, "finite": True}
    assert notes[0]["harness"][f"{name}_compress"] == (
        f"--gradCompress rides DataParallel.reduce_grads; --strategy {name}"
        f" builds its own step structure and has no replicated-grad "
        f"all-reduce to compress")
