"""The port's pipeline parallelism (``bigdl_tpu_torch.parallel.pipeline``:
``PipelineStack``, ``place_pipeline_params``, ``pipeline_forward``,
``make_pipeline_train_step``) against the JAX package's on the CPU. The
port runs one job of 4 gloo ranks on {"pipe": 2, "data": 2} (the cases
are in tests/torch_spe_cases.py); the JAX package runs in this process on
conftest's virtual devices, from the same JAX init tree.

Held: a converted stack's single-process forward against JAX
``PipelineStack.apply`` (1e-6), and whole JAX leaves cut to a placed
stack's and a placed MoE's slices; ``pipeline_forward`` at pipe:2 (micro 2
and 4) and at pipe:2 x data:2 against JAX's (1e-5); one
``make_pipeline_train_step`` step at pipe:2 x data:2 against JAX's (loss,
and each stage's parameters within 1e-5 of max|p|); the JAX refusals and
their texts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spe_cases as C
from bigdl_tpu import nn as jnn
from bigdl_tpu.core import Sequential as JSequential
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.parallel import PipelineStack as JStack
from bigdl_tpu.parallel import make_mesh as jax_make_mesh
from bigdl_tpu.parallel import (make_pipeline_train_step as jax_train_step,
                                pipeline_forward as jax_forward,
                                place_pipeline_params as jax_place)
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core.module import Sequential
from bigdl_tpu_torch.interop import load_jax, tensors_from_jax
from bigdl_tpu_torch.parallel import (Mesh, PipelineStack,
                                      place_pipeline_params)
from bigdl_tpu_torch.parallel.launch import spawn

JOB_TIMEOUT_S = 200
ENV = {"PYTHONPATH": C.__file__.rsplit("/", 1)[0]}
RANKS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jstack():
    return JStack(jnn.TransformerEncoderLayer(d_model=C.PIPE_D, num_heads=2,
                                              d_ff=2 * C.PIPE_D), C.PIPE_L)


@pytest.fixture(scope="module")
def pipe_job(tmp_path_factory):
    """The JAX stack's init tree, seeded inputs, and the 4-rank job's
    results (a list of each rank's npz) and notes."""
    root = tmp_path_factory.mktemp("pipe")
    rs = np.random.RandomState(0)
    shape = (C.PIPE_B, C.PIPE_S, C.PIPE_D)
    inp = {"pipe_x": rs.randn(*shape).astype(np.float32),
           "pipe_y": rs.randn(*shape).astype(np.float32)}
    params = jax.tree_util.tree_map(np.asarray,
                                    _jstack().init(jax.random.PRNGKey(5)))
    inp.update({f"stack/{k}": t.numpy() for k, t in
                tensors_from_jax(C.pipe_stack(), params).items()})
    np.savez(root / "inputs.npz", **inp)
    notes = spawn("torch_spe_cases:run_all", RANKS,
                  {"dir": str(root), "cases": ["pipe"]},
                  timeout_s=JOB_TIMEOUT_S, backend="gloo", env=ENV)
    out = [dict(np.load(root / f"pipe_r{r}.npz")) for r in range(RANKS)]
    return params, inp, out, notes[0]["pipe"]


def test_converted_stack_matches_jax_apply(pipe_job):
    """The JAX stack's tree loads into ``PipelineStack`` by name (its
    leaves stacked [L, ...]); the single-process forward is
    ``PipelineStack.apply``."""
    params, inp, _, _ = pipe_job
    want, _ = _jstack().apply(params, (), jnp.asarray(inp["pipe_x"]))
    stack = load_jax(C.pipe_stack(), params)
    assert tuple(stack.mha.wq.shape) == (C.PIPE_L, C.PIPE_D, C.PIPE_D)
    with torch.no_grad():
        got = stack(torch.from_numpy(inp["pipe_x"])).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_jax_trees_load_into_placed_stacks(pipe_job):
    """A whole JAX leaf converts into a placed stack's slice: the
    pipeline stack at stage 1 of 2 takes blocks 2-3, an MoE at expert rank
    1 of 2 its experts 2-3 (the gate whole)."""
    params, *_ = pipe_job
    stack = place_pipeline_params(C.pipe_stack(), Mesh("pipe", 2, 1))
    assert stack.stage == (2, 4)
    got = tensors_from_jax(stack, params)
    stack.load_state_dict(got, strict=True)
    assert tuple(stack.mha.wq.shape) == (2, C.PIPE_D, C.PIPE_D)
    np.testing.assert_array_equal(got["w1"].numpy(), params["w1"][2:4])
    jm = jnn.MoE(JSequential(jnn.Linear(4, 6), jnn.ReLU(), jnn.Linear(6, 4)),
                 4, 4)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    moe = nn.MoE(lambda: Sequential(nn.Linear(4, 6), nn.ReLU(),
                                    nn.Linear(6, 4)), 4, 4)
    moe.place_expert_parallel(Mesh("expert", 2, 1))
    got = tensors_from_jax(moe, tree)
    moe.load_state_dict(got, strict=True)
    np.testing.assert_array_equal(got["experts.0.weight"].numpy(),
                                  tree["experts"]["0"]["weight"][2:4])
    np.testing.assert_array_equal(got["gate"].numpy(), tree["gate"])


def test_stateful_block_refused_with_the_jax_text():
    with pytest.raises(ValueError) as want:
        JStack(jnn.BatchNormalization(4), 2)
    with pytest.raises(ValueError) as got:
        PipelineStack(nn.BatchNormalization(4), 2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tag,micro,data", C.PIPE_FWD)
def test_pipeline_forward_matches_jax(tag, micro, data, pipe_job):
    """Every rank's output (its rows of each microbatch under the data
    axis, else the whole batch) against JAX ``pipeline_forward``."""
    params, inp, out, _ = pipe_job
    axes = {"pipe": 2, "data": 2} if data else {"pipe": 2}
    n = 4 if data else 2
    mesh = jax_make_mesh(axes, devices=jax.devices()[:n])
    stack = _jstack()
    want = np.asarray(jax.jit(lambda p, x: jax_forward(
        stack, mesh, p, x, micro, axis="pipe", data_axis=data))(
        jax_place(mesh, params, "pipe"), jnp.asarray(inp["pipe_x"])))
    for r in range(RANKS):
        rows = out[r][f"rows_{tag}"]
        np.testing.assert_allclose(out[r][f"fwd_{tag}"], want[rows],
                                   atol=1e-5, err_msg=f"rank {r}")


def test_pipeline_train_step_matches_jax(pipe_job):
    """One step at pipe:2 x data:2 (micro 2): the loss and each stage's
    blocks after the SGD-momentum update."""
    params, inp, out, _ = pipe_job
    mesh = jax_make_mesh({"pipe": 2, "data": 2}, devices=jax.devices()[:4])
    stack = _jstack()
    opt = JSGD(learning_rate=C.PIPE_LR, momentum=0.9)
    sharded = jax_place(mesh, jax.tree_util.tree_map(jnp.asarray, params),
                        "pipe")
    opt_state = opt.init(params)
    step = jax_train_step(stack, mesh, jnn.MSECriterion(), opt, 2,
                          axis="pipe", data_axis="data")(opt_state, sharded)
    p, _, loss = step(sharded, opt_state, jnp.asarray(inp["pipe_x"]),
                      jnp.asarray(inp["pipe_y"]), jax.random.PRNGKey(9))
    want = {k: t.numpy() for k, t in tensors_from_jax(
        C.pipe_stack(), jax.device_get(p)).items()}
    pmax = max(float(np.abs(v).max()) for v in want.values())
    for r in range(RANKS):
        got = out[r]
        lo, hi = got["train/stage"]
        assert (lo, hi) == ((r // 2) * 2, (r // 2) * 2 + 2)
        assert abs(float(got["train/loss"]) - float(loss)) <= \
            1e-5 * abs(float(loss))
        for k, v in want.items():
            np.testing.assert_allclose(got[f"train/{k}"], v[lo:hi],
                                       atol=1e-5 * pmax, err_msg=k)


def test_pipeline_refusals_are_the_jax_texts(pipe_job):
    *_, notes = pipe_job
    assert notes["blocks"] == "3 blocks not divisible by 2 pipeline stages"
    assert notes["batch"] == "batch 5 not divisible by 2 microbatches"
