"""The port's data parallelism (``bigdl_tpu_torch.parallel``) against the
JAX package's on the CPU: the port runs 2 and 4 gloo ranks, each a fresh
process started by ``parallel.launch.spawn`` with a time limit (the cases
are in tests/torch_dp_cases.py), and the JAX package runs in this process
on conftest's 8 virtual devices.

Held: the DP step at 2 and 4 ranks against JAX ``DataParallel(
local_mesh())`` and the port's single process (the bar of
tests/test_parallel.py, 1e-5 after 10 SGD-momentum steps); ZeRO-1 on and
off for SGD, Adam, LARS and LAMB (bit for bit) and the state a rank keeps;
synced batch norm (plain, and through the kernels' twins in "stats" and
"apply" mode, ReLU off and on) against JAX BN over the global batch in y,
running statistics, dx, dγ and dβ (1e-5, f32); a narrow ResNet with the
fused BN block against JAX dp and the port's single process; the LM and
a Dropout model at 2 ranks against one process; the Validator; a JAX dp
checkpoint resumed at 2 ranks, and a 2-rank checkpoint resumed in one
process and read in the JAX leaf order; the mesh and the strategy in one
process; no fallback for a failed, hung or unplaceable rank.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_cases as C
from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.core import Sequential as JSequential
from bigdl_tpu.dataset import BatchDataSet as JaxBatchDataSet
from bigdl_tpu.parallel import DataParallel as JaxDataParallel
from bigdl_tpu.parallel import local_mesh as jax_local_mesh
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import BatchDataSet
from bigdl_tpu_torch.interop import tensors_from_jax
from bigdl_tpu_torch.optim import (SGD, Optimizer, Top1Accuracy,
                                   Top5Accuracy, Trigger, Validator)
from bigdl_tpu_torch.parallel import (DataParallel, feeds_rank_part,
                                      local_mesh, make_mesh)
from bigdl_tpu_torch.parallel.launch import spawn

ATOL = 1e-5
# a ResNet's 3 steps and an LM's 2: sums over the batch in other orders,
# through a dozen layers
MODEL_ATOL = 1e-4
JOB_TIMEOUT_S = 240
CASES_2 = ["mlp", "zero1", "bn", "cifar", "lm", "dropout", "validator",
           "ckpt"]
CASES_4 = ["mlp", "zero1"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_named(model, params, state=None):
    return {k: v.numpy() for k, v in
            tensors_from_jax(model, params, state).items()}


def _jax_dp_run(jm, params, x, y, batch, iters, state=None, ckpt=None):
    opt = joptim.Optimizer(jm, JaxBatchDataSet(x, y, batch, shuffle=False),
                           jnn.ClassNLLCriterion(),
                           optim_method=joptim.SGD(0.5, momentum=0.9),
                           end_when=joptim.Trigger.max_iteration(iters),
                           strategy=JaxDataParallel(jax_local_mesh()))
    opt.set_state(params=jax.tree_util.tree_map(jnp.asarray, params),
                  mod_state=(None if state is None else
                             jax.tree_util.tree_map(jnp.asarray, state)))
    if ckpt is not None:
        opt.set_checkpoint(joptim.Trigger.several_iteration(2), str(ckpt))
    return opt.optimize()


@pytest.fixture(scope="module")
def jax_mlp():
    """The JAX DP test's model and an init of it."""
    jm = JSequential(jnn.Linear(2, 8), jnn.Tanh(), jnn.Linear(8, 2),
                     jnn.LogSoftMax())
    return jm, _np_tree(jm.init(jax.random.PRNGKey(7)))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, jax_mlp):
    """Inputs from seeds and JAX init trees, a JAX dp checkpoint, then the
    2-rank and the 4-rank jobs; (inputs, {ranks: (dir, results)})."""
    root = tmp_path_factory.mktemp("dp")
    jm, mp = jax_mlp
    rs = np.random.RandomState(1)
    inp = {f"mlp/{k}": v for k, v in _port_named(C.mlp(), mp).items()}
    jc = jax_models.resnet_cifar(8, fused_bn="apply")
    cp, cs = _np_tree(jc.init(jax.random.PRNGKey(3))), _np_tree(
        jc.init_state())
    from bigdl_tpu_torch import models
    inp.update({f"cifar/{k}": v for k, v in _port_named(
        models.resnet_cifar(8), cp, cs).items()})
    inp.update({"cifar_x": rs.randn(24, 32, 32, 3).astype(np.float32),
                "cifar_y": rs.randint(0, 10, 24).astype(np.int32)})
    torch.manual_seed(0)
    lm = C.lm()
    inp.update({f"lm/{k}": v for k, v in C.params_np(lm).items()})
    inp.update({"lm_x": rs.randint(0, C.LM["vocab"], (8, 32)).astype(
        np.int32), "lm_y": rs.randint(0, C.LM["vocab"], (8, 32)).astype(
        np.int32)})
    inp.update({"bn/x": (rs.randn(8, 3, 3, 6) * 3 + 1).astype(np.float32),
                "bn/dy": rs.randn(8, 3, 3, 6).astype(np.float32),
                "bn/gamma": (rs.rand(6) + 0.5).astype(np.float32),
                "bn/beta": rs.randn(6).astype(np.float32)})
    inp.update({"drop/x": rs.randn(8, 8).astype(np.float32),
                "drop/y": rs.randint(0, 4, 8).astype(np.int32)})
    x, y = C.blob_data()
    _jax_dp_run(jm, mp, x, y, 16, 2, ckpt=root / "jax_ck")
    inp["ckpt/jax"] = np.array(str(root / "jax_ck"))
    np.savez(root / "inputs.npz", **inp)
    out = {}
    for ranks, cases in ((2, CASES_2), (4, CASES_4)):
        d = root / f"r{ranks}"
        d.mkdir()
        inp["ckpt/port"] = np.array(str(d / "ck"))
        np.savez(d / "inputs.npz", **inp)
        res = spawn("torch_dp_cases:run_all", ranks,
                    {"inputs": str(d / "inputs.npz"), "out": str(d),
                     "cases": cases}, timeout_s=JOB_TIMEOUT_S,
                    backend="gloo", env={"PYTHONPATH": C.__file__.rsplit(
                        "/", 1)[0]})
        out[ranks] = (d, res)
    return np.load(root / "inputs.npz"), out


def _rank_arrays(jobs, ranks, case):
    d, _ = jobs[1][ranks]
    return [np.load(d / f"{case}_r{r}.npz") for r in range(ranks)]


def _close_trees(got, ref, atol=ATOL):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("ranks", [2, 4])
def test_dp_step_matches_jax_dp_and_one_process(jobs, jax_mlp, ranks):
    """10 SGD-momentum steps of the JAX DP test's model on its blob data:
    every rank ends with the parameters of JAX DataParallel over 8 devices
    and of the port's single process (1e-5), and all ranks agree bit for
    bit."""
    inp, _ = jobs
    jm, mp = jax_mlp
    x, y = C.blob_data()
    trained = _jax_dp_run(jm, mp, x, y, 64, C.MLP_ITERS)
    ref = _port_named(C.mlp(), _np_tree(trained.params))
    single, _ = C.train(C.load(C.mlp(), inp, "mlp"), x, y, 64,
                        SGD(0.5, momentum=0.9), C.MLP_ITERS)
    got = _rank_arrays(jobs, ranks, "mlp")
    for r in got:
        _close_trees(r, ref)
        _close_trees(r, C.params_np(single))
        for k in r.files:
            assert np.array_equal(r[k], got[0][k])


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("method", ["sgd", "adam", "lars", "lamb"])
def test_zero1_equals_replicated_state(jobs, ranks, method):
    """ZeRO-1 on equals ZeRO-1 off bit for bit (whole leaves: LARS's and
    LAMB's per-tensor norms need no collective), and one process within
    1e-6; each rank keeps state for exactly the leaves it owns, the ranks'
    leaves partition the model, balanced by bytes."""
    rs = np.random.RandomState(7)
    x, y = rs.randn(16, 4).astype(np.float32), rs.randint(0, 3, 16).astype(
        np.int32)
    single, _, _ = C.manual_steps(C.deep_mlp(), x, y, C.methods()[method](),
                                  5)
    arrays = _rank_arrays(jobs, ranks, "zero1")
    infos = [jobs[1][ranks][1][r]["zero1"] for r in range(ranks)]
    owned = []
    for r in range(ranks):
        on = {k.split("/", 1)[1]: arrays[r][k] for k in arrays[r].files
              if k.startswith(f"{method}_1/")}
        off = {k.split("/", 1)[1]: arrays[r][k] for k in arrays[r].files
               if k.startswith(f"{method}_0/")}
        for k in on:
            assert np.array_equal(on[k], off[k]), k
        _close_trees(on, {k: v.detach().numpy() for k, v in single.items()},
                     1e-6)
        mine = infos[r][f"{method}_1"]
        for keys in mine["state"].values():
            assert keys == mine["owned"]
        every = infos[r][f"{method}_0"]
        for keys in every["state"].values():
            assert keys == sorted(single)
        owned.append(mine["owned"])
    assert sorted(n for o in owned for n in o) == sorted(single)
    sizes = {n: p.numel() for n, p in single.items()}
    loads = [sum(sizes[n] for n in o) for o in owned]
    assert max(loads) - min(loads) <= max(sizes.values())


def _jax_bn_global(inp, relu):
    x, dy = jnp.asarray(inp["bn/x"]), jnp.asarray(inp["bn/dy"])
    bn = jnn.BatchNormalization(6)
    bn.fuse_relu = relu
    p = {"weight": jnp.asarray(inp["bn/gamma"]),
         "bias": jnp.asarray(inp["bn/beta"])}
    st = bn.init_state()

    def f(x, p):
        y, new = bn.apply(p, st, x, training=True)
        return y, new

    (y, new), vjp = jax.vjp(f, x, p)
    dx, dp = vjp((dy, jax.tree_util.tree_map(jnp.zeros_like, new)))
    return {"y": y, "dx": dx, "dgamma": dp["weight"], "dbeta": dp["bias"],
            "running_mean": new["running_mean"],
            "running_var": new["running_var"]}


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("mode", ["off", "stats", "apply"])
def test_synced_bn_matches_jax_global_batch(jobs, mode, relu):
    """Each of 2 ranks normalises its half of an NHWC batch by the global
    batch's statistics: the ranks' y and dx side by side, their dγ and dβ
    summed (each rank's are its own sums, which the gradient average
    completes) and every rank's running statistics equal JAX BN over the
    whole batch, within 1e-5."""
    inp, _ = jobs
    ref = _jax_bn_global(inp, relu)
    got = _rank_arrays(jobs, 2, "bn")
    tag = f"{mode}_{int(relu)}"
    cat = {k: np.concatenate([g[f"{tag}/{k}"] for g in got])
           for k in ("y", "dx")}
    summed = {k: sum(g[f"{tag}/{k}"] for g in got)
              for k in ("dgamma", "dbeta")}
    for k, v in {**cat, **summed}.items():
        np.testing.assert_allclose(v, np.asarray(ref[k]), rtol=0, atol=ATOL,
                                   err_msg=k)
    for g in got:
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(g[f"{tag}/{k}"], np.asarray(ref[k]),
                                       rtol=0, atol=ATOL, err_msg=k)


def test_resnet_fused_apply_matches_jax_dp_and_one_process(jobs):
    """resnet_cifar(8) with --fusedBN apply, 3 SGD-momentum steps of
    global batch 8: 2 ranks (the stats kernels' twins with all-reduced
    sums) against JAX dp on 8 devices (which turns its fused BN off) and
    the port's single process (the fused block's twins), parameters and
    running statistics within 1e-4."""
    inp, _ = jobs
    x, y = inp["cifar_x"], inp["cifar_y"]
    jc = jax_models.resnet_cifar(8, fused_bn="apply")
    cp, cs = _np_tree(jc.init(jax.random.PRNGKey(3))), _np_tree(
        jc.init_state())
    opt = joptim.Optimizer(jc, JaxBatchDataSet(x, y, 8, shuffle=False),
                           jnn.ClassNLLCriterion(),
                           optim_method=joptim.SGD(0.1, momentum=0.9),
                           end_when=joptim.Trigger.max_iteration(3),
                           strategy=JaxDataParallel(jax_local_mesh()))
    opt.set_state(params=jax.tree_util.tree_map(jnp.asarray, cp),
                  mod_state=jax.tree_util.tree_map(jnp.asarray, cs))
    trained = opt.optimize()
    from bigdl_tpu_torch import models
    ref = _port_named(models.resnet_cifar(8), _np_tree(trained.params),
                      _np_tree(trained.mod_state))
    single, losses = C.train(
        C.load(models.resnet_cifar(8, fused_bn="apply"), inp, "cifar"), x, y,
        8, SGD(0.1, momentum=0.9), 3)
    for r, g in enumerate(_rank_arrays(jobs, 2, "cifar")):
        _close_trees(g, ref, MODEL_ATOL)
        _close_trees(g, C.params_np(single), MODEL_ATOL)
    # the loss each rank saw is its half's; their mean is the global one
    halves = [jobs[1][2][1][r]["cifar"]["losses"] for r in range(2)]
    np.testing.assert_allclose(np.mean(halves, axis=0), losses, rtol=0,
                               atol=MODEL_ATOL)


def test_lm_and_dropout_match_one_process(jobs):
    """The LM (2 layers of 32, flash attention's twins, SGD) and a Dropout
    model at 2 ranks end with the single process's parameters: each rank's
    noise is offset by its place in the batch, so the ranks draw the
    single process's masks."""
    inp, _ = jobs
    from bigdl_tpu_torch.nn import TimeDistributedCriterion
    single, _ = C.train(C.load(C.lm(), inp, "lm"), inp["lm_x"], inp["lm_y"],
                        4, SGD(0.1, momentum=0.9), 2,
                        crit=TimeDistributedCriterion(nn.ClassNLLCriterion()))
    for g in _rank_arrays(jobs, 2, "lm"):
        _close_trees(g, C.params_np(single), MODEL_ATOL)
    x, y = inp["drop/x"], inp["drop/y"]
    single, _ = C.train(C.dropout_mlp(), x, y, 8, SGD(0.1), 3, seed=11)
    for g in _rank_arrays(jobs, 2, "dropout"):
        _close_trees(g, C.params_np(single), 1e-6)
    # and the steps moved the parameters far more than that tolerance
    start = C.dropout_mlp()
    far = max(float(np.abs(g[k] - C.params_np(start)[k]).max())
              for g in _rank_arrays(jobs, 2, "dropout") for k in g.files)
    assert far > 1e-3


def test_validator_sums_counts_over_ranks(jobs):
    """Top-1 and Top-5 at 2 ranks over 23 rows in batches of 10 (the last
    of 3 rows, split 1 and 2) are the single process's."""
    rs = np.random.RandomState(9)
    x = rs.randn(23, 4).astype(np.float32)
    y = rs.randint(0, 3, 23).astype(np.int32)
    single = Validator(C.deep_mlp(), BatchDataSet(x, y, 10,
                                                  drop_remainder=False),
                       "cpu").test([Top1Accuracy(), Top5Accuracy()])
    for r in range(2):
        got = jobs[1][2][1][r]["validator"]["results"]
        assert got == [list(s.result()) for s in single]


def _leaves(path):
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(
            sum(1 for k in z.files if k.startswith("leaf_")))]


def test_checkpoints_cross_between_jax_dp_ranks_and_one_process(
        jobs, jax_mlp, tmp_path):
    """A JAX checkpoint written under DataParallel on 8 devices (its
    manifest carries the layout) resumes at 2 ranks and ends where JAX's
    uninterrupted run ends; the port's 2-rank checkpoint (rank 0 wrote it,
    the ZeRO-1 state gathered, the manifest naming the layout) resumes in
    one process to the 2-rank run's end, and its state blob's leaves are
    the JAX SGD state's tree."""
    inp, res = jobs
    jm, mp = jax_mlp
    x, y = C.blob_data()
    jman = json.loads((res[2][0].parent / "jax_ck" / "model.2.manifest.json"
                       ).read_text())
    assert jman["layout"]["n_devices"] == 8
    full = _jax_dp_run(jm, mp, x, y, 16, 4)
    ref = _port_named(C.mlp(), _np_tree(full.params))
    got = _rank_arrays(jobs, 2, "ckpt")
    for g in got:
        _close_trees({k[8:]: g[k] for k in g.files
                      if k.startswith("resumed/")}, ref)
    d = res[2][0] / "ck"
    assert res[2][1][0]["ckpt"]["files"] == sorted(
        f.name for f in d.iterdir())
    man = json.loads((d / "state.2.manifest.json").read_text())
    assert man["layout"] == {"strategy": "DataParallel", "axis": "data",
                             "zero1": True, "n_devices": 2,
                             "mesh": {"data": 2}}
    one = tmp_path / "one"
    one.mkdir()
    for f in d.iterdir():
        if f.name.startswith(("model.2", "state.2")):
            shutil.copy(f, one / f.name)
    model = C.load(C.mlp(), inp, "mlp")
    Optimizer(model, BatchDataSet(x, y, 16), nn.ClassNLLCriterion(),
              optim_method=SGD(0.5, momentum=0.9),
              end_when=Trigger.max_iteration(4), device="cpu").resume(
        str(one)).optimize()
    _close_trees(C.params_np(model), {k[5:]: got[0][k] for k in got[0].files
                                      if k.startswith("port/")}, 1e-6)
    sgd = joptim.SGD(0.5, momentum=0.9).init(mp)
    st = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(sgd),
                                      _leaves(d / "state.2"))
    assert float(st["step"]) == 2.0
    for a, b in zip(jax.tree_util.tree_leaves(st["velocity"]),
                    jax.tree_util.tree_leaves(sgd["velocity"])):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a).max() > 0  # every leaf gathered, none left zero


def test_mesh_and_strategy_in_one_process():
    """One process: the mesh is {'data': 1}, a model or sequence axis
    needs its ranks, a seq, pipe or expert axis of one is a mesh of one
    (and a BN may name it), a strategy runs
    (its collectives are the identity) and shard_batch keeps the batch; a
    dataset that yields a rank's part is told apart by its kind."""
    from bigdl_tpu_torch.dataset import ShardedDataSet
    from bigdl_tpu_torch.dataset.pipeline import EpochPlan, ExecutorDataSet
    from bigdl_tpu_torch.dataset.pipeline.executor import ArraySampleSource
    m = local_mesh()
    assert m.shape == {"data": 1} and m.size == 1 and m.axis_names == (
        "data",)
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh({"data": 1, "model": 2})
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh({"data": 1, "seq": 2})
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh({"data": 2})
    for axes in ({"data": 1, "seq": 1}, {"pipe": 1, "data": 1},
                 {"expert": 1}):
        m = make_mesh(axes)
        assert m.shape == axes and m.size == 1 and m.rank == 0
        for a in axes:
            assert m.axis_view(a).size == 1
    assert nn.BatchNormalization(4, axis_name="seq").axis_name == "seq"
    s = DataParallel()
    assert s.layout_signature()["n_devices"] == 1
    x = np.zeros((6, 2))
    assert s.shard_batch(x, x)[0] is x
    x2, y2 = C.blob_data(16)
    assert not feeds_rank_part(BatchDataSet(x2, y2, 4))
    assert feeds_rank_part(ShardedDataSet(x2, y2, 4, process_index=1,
                                          process_count=2))
    plan = EpochPlan(16, 2, process_index=0, process_count=2)
    assert feeds_rank_part(ExecutorDataSet(ArraySampleSource(x2, y2),
                                           plan=plan))


def test_no_fallback_for_a_failed_hung_or_unplaceable_rank():
    """spawn fails the job when a rank fails (killing the rank that waits
    for it) and when the ranks outlive the time limit (killing them);
    NCCL with more ranks than cards raises before joining anything."""
    import time

    from bigdl_tpu_torch.parallel import init_distributed
    env = {"PYTHONPATH": C.__file__.rsplit("/", 1)[0]}
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with 1"):
        spawn("torch_dp_cases:rank1_fails", 2, timeout_s=JOB_TIMEOUT_S,
              backend="gloo", env=env)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 6s"):
        spawn("torch_dp_cases:hang", 2, timeout_s=6, backend="gloo", env=env)
    assert time.monotonic() - t0 < 30
    with pytest.raises(RuntimeError, match="NCCL needs one card a rank"):
        init_distributed("127.0.0.1:1", 2, 1, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_unfuse_bn_for_spmd_as_the_jax_one():
    """unfuse_bn_for_spmd switches every fused BN back at more than one
    device and nothing at one, returning the JAX function's counts."""
    from bigdl_tpu.nn.norm import unfuse_bn_for_spmd as jax_unfuse
    from bigdl_tpu_torch import models
    from bigdl_tpu_torch.nn import bn_fused_mode, unfuse_bn_for_spmd
    for n in (1, 8):
        tm = models.resnet_cifar(8, fused_bn="apply")
        jm = jax_models.resnet_cifar(8, fused_bn="apply")
        assert unfuse_bn_for_spmd(tm, n) == jax_unfuse(jm, n)
        assert bn_fused_mode(tm) == ("apply" if n == 1 else "off")
