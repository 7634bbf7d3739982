"""The port's MoE (bigdl_tpu_torch/nn/moe.py) against the JAX package's on
the CPU, from the JAX init tree (stacked experts) loaded strictly with
``interop.load_jax``: dense mode, sparse top-1 and top-2 with capacity
drops, 3-D input, the auxiliary loss and every gradient (forward 1e-5,
gradients 1e-4 of max|g|); a few ``Optimizer`` steps with the auxiliary
loss against the JAX ``Optimizer``'s losses and parameters; a stateful
expert refused and ``place_expert_parallel`` over an expert axis of one
(in gloo ranks: tests/test_torch_expert_parallel.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.core import Sequential as JSequential
from bigdl_tpu.dataset import BatchDataSet as JBatchDataSet
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import BatchDataSet
from bigdl_tpu_torch.interop import load_jax, tensors_from_jax
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

D, H, E = 8, 16, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: torch's intra-op threads only add spinning,
    and beside other test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jexpert():
    return JSequential(jnn.Linear(D, H), jnn.ReLU(), jnn.Linear(H, D))


def _texpert():
    return tnn.Sequential(tnn.Linear(D, H), tnn.ReLU(), tnn.Linear(H, D))


def _pair(**kw):
    jm = jnn.MoE(_jexpert(), E, D, **kw)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    tm = load_jax(tnn.MoE(_texpert, E, D, **kw), params)
    return jm, params, tm


CASES = {
    "dense": (dict(dense=True), (6, D)),
    "top1": (dict(top_k=1, capacity_factor=4.0), (10, D)),
    "top1_drops": (dict(top_k=1, capacity_factor=0.5), (16, D)),
    "top2_3d": (dict(top_k=2, capacity_factor=2.0), (2, 5, D)),
    "top2_drops_3d": (dict(top_k=2, capacity_factor=0.5), (3, 6, D)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case):
    kw, shape = CASES[case]
    jm, params, tm = _pair(**kw)
    rs = np.random.RandomState(len(case))
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(*shape).astype(np.float32)

    def loss(p, x_):
        y, st = jm.apply(p, jm.init_state(), x_)
        return jnp.sum(y * w) + st["aux_loss"], (y, st["aux_loss"])

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    with tnn.collect_aux_losses() as aux:
        ty = tm(tx)
    assert len(aux) == 1 and aux[0].dtype == torch.float32
    tl = (ty * torch.from_numpy(w)).sum() + aux[0]
    names = [n for n, _ in tm.named_parameters()]
    tg = torch.autograd.grad(tl, [tx] + list(tm.parameters()))
    assert ty.shape == shape
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux[0].detach()), float(jaux),
                               atol=1e-6)
    if "drops" in case:  # the capacity dropped choices: zero rows
        zero = np.all(np.abs(np.asarray(jy).reshape(-1, D)) < 1e-12, -1)
        assert zero.sum() >= 1 and kw["capacity_factor"] < 1
    want = {n: t.numpy() for n, t in tensors_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jgp)).items()}
    scale = max(float(np.abs(v).max()) for v in want.values())
    for n, g in zip(names, tg[1:]):
        err = float(np.abs(g.numpy() - want[n]).max()) / scale
        assert err <= 1e-4, (n, err)
    gx = np.asarray(jgx)
    assert float(np.abs(tg[0].numpy() - gx).max()) <= \
        1e-4 * float(np.abs(gx).max())
    if not kw.get("dense"):
        assert float(np.abs(tg[1 + names.index("gate")].numpy()).max()) > 0


def test_stacked_experts_load_by_name():
    _, params, tm = _pair(top_k=2)
    names = dict(tm.named_parameters())
    assert set(names) == {"gate", "experts.0.weight", "experts.0.bias",
                          "experts.2.weight", "experts.2.bias"}
    assert tuple(names["experts.0.weight"].shape) == (E, D, H)
    np.testing.assert_array_equal(names["experts.2.bias"].detach().numpy(),
                                  params["experts"]["2"]["bias"])


def test_stateful_expert_and_expert_parallel_refused():
    """A stateful expert is refused; ``place_expert_parallel`` over an
    expert axis of one process keeps every expert (its forward and
    gradients are the unplaced module's), and an axis that does not
    divide the experts is refused."""
    from bigdl_tpu_torch.parallel import Mesh, make_mesh
    with pytest.raises(ValueError, match="stateless"):
        tnn.MoE(tnn.Sequential(tnn.Linear(D, D),
                               tnn.BatchNormalization(D)), E, D)
    jm, params, tm = _pair(top_k=2, capacity_factor=2.0)
    placed = load_jax(tnn.MoE(_texpert, E, D, top_k=2, capacity_factor=2.0),
                      params).place_expert_parallel(make_mesh({"expert": 1}))
    assert placed.experts.stage == (0, E) and placed._ep is None
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 5, D).astype(
        np.float32))
    np.testing.assert_array_equal(placed(x).detach().numpy(),
                                  tm(x).detach().numpy())
    with pytest.raises(ValueError, match="4 experts not divisible by the 3"):
        tnn.MoE(_texpert, E, D).place_expert_parallel(Mesh("expert", 3))


def test_optimizer_adds_aux_loss_as_jax(tmp_path):
    """Three SGD steps of Sequential(MoE, Linear, LogSoftMax) through each
    package's Optimizer with aux_loss_weight 1.0 (and the default 0.01):
    every step's logged loss (criterion + weight x aux) and the final
    parameters agree; weight 0 trains other parameters."""
    rs = np.random.RandomState(0)
    x = rs.randn(32, D).astype(np.float32)
    y = rs.randint(0, 4, 32).astype(np.int32)
    jmodel = JSequential(jnn.MoE(_jexpert(), E, D, top_k=1,
                                 capacity_factor=4.0),
                         jnn.Linear(D, 4), jnn.LogSoftMax())
    jp = jax.tree_util.tree_map(np.asarray,
                                jmodel.init(jax.random.PRNGKey(1)))

    def losses(d):
        with open(d / "train.jsonl") as f:
            return [json.loads(line)["loss"] for line in f]

    final = {}
    for w in (1.0, 0.01, 0.0):
        jd, td = tmp_path / f"j{w}", tmp_path / f"t{w}"
        jopt = joptim.Optimizer(
            jmodel, JBatchDataSet(x, y, 8, shuffle=False),
            jnn.ClassNLLCriterion(),
            optim_method=joptim.SGD(learning_rate=0.1),
            end_when=joptim.Trigger.max_iteration(3), seed=3,
            aux_loss_weight=w)
        jopt.set_state(params=jp).set_summary(str(jd))
        jtrained = jopt.optimize()
        tmodel = load_jax(tnn.Sequential(
            tnn.MoE(_texpert, E, D, top_k=1, capacity_factor=4.0),
            tnn.Linear(D, 4), tnn.LogSoftMax()), jp)
        topt = Optimizer(tmodel, BatchDataSet(x, y, 8),
                         tnn.ClassNLLCriterion(),
                         optim_method=SGD(learning_rate=0.1),
                         end_when=Trigger.max_iteration(3), seed=3,
                         aux_loss_weight=w, device="cpu")
        topt.set_summary(str(td))
        topt.optimize()
        np.testing.assert_allclose(losses(td), losses(jd), atol=1e-5)
        want = tensors_from_jax(tmodel, jax.tree_util.tree_map(
            np.asarray, jtrained.params))
        for n, t in tmodel.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[n].numpy(),
                                       atol=1e-5, err_msg=n)
        final[w] = tmodel.state_dict()["0.gate"].clone()
    assert float((final[1.0] - final[0.0]).abs().max()) > 1e-7


def test_noisy_experts_draw_per_expert_seeds():
    """An expert with dropout draws, in training, from fold_seed(seed, e)
    under the vmap: the same seed repeats its masks, another seed moves
    them, and eval draws none."""
    def expert():
        return tnn.Sequential(tnn.Linear(D, H), tnn.Dropout(0.5),
                              tnn.Linear(H, D))

    m = tnn.Sequential(tnn.MoE(expert, E, D, top_k=2), tnn.Linear(D, 3))
    x = torch.from_numpy(np.random.RandomState(7).randn(10, D)
                         .astype(np.float32))
    m.train()
    a, b, c = (m(x, seed=torch.tensor(s)) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    m.eval()
    assert torch.equal(m(x), m(x))
