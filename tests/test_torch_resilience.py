"""Recovery on the port's training path (bigdl_tpu_torch.resilience,
cli.common.run_optimize, utils.file, utils.orbax_ckpt) on the CPU, against
the port's own uninterrupted runs and the JAX package's:

* supervised runs of a small Dropout model (the JAX test's trainee) killed
  mid-epoch, at an epoch boundary, inside a checkpoint write, by a
  transient dispatch fault, and with no fault, each bit-equal to the
  uninterrupted run; a corrupted newest pair falls back to the one before;
* one fault plan gives the same event log (site, visit, kind) in both
  packages across a retry, and the losses of a Dropout-free model agree
  with JAX's on converted parameters (1e-5);
* ``memory://`` checkpoints: a round trip, the overwrite guard, a JAX
  checkpoint resumed by the port and a port one read into the JAX model;
* DCP snapshots: a round trip in one process, an Optimizer's sharded
  checkpoints resumed bit for bit, and a 2-rank ZeRO-1 save (a spawned
  gloo job, tests/torch_resilience_cases.py) restored in one process equal
  to the single-blob restore bit for bit;
* ``restore_resharded`` from 4 ranks to 2 and back, and its
  ``ChecksumError`` on a blob that disagrees with its manifest;
* ``tools/chaos_run --kills 1 --platform cpu`` reports ``"equal": true``.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.cli import common as jcommon
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.dataset.dataset import BatchDataSet as JBatchDataSet
from bigdl_tpu.resilience import faults as jf
from bigdl_tpu.utils import file as jfile
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.cli import common
from bigdl_tpu_torch.core.module import Sequential
from bigdl_tpu_torch.dataset import BatchDataSet
from bigdl_tpu_torch.interop import tensors_from_jax
from bigdl_tpu_torch.interop.checkpoint import load_state, save_state
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.parallel.launch import spawn
from bigdl_tpu_torch.parallel.mesh import Mesh
from bigdl_tpu_torch.resilience import faults as pf
from bigdl_tpu_torch.utils import file as tfile
from bigdl_tpu_torch.utils import orbax_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 1e-5  # f32, the same steps in both packages
JOB_TIMEOUT_S = 240

_rs = np.random.RandomState(0)
_X = _rs.randn(64, 8).astype(np.float32)
_Y = _rs.randint(0, 3, 64).astype(np.int32)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    jf.clear_plan()
    pf.clear_plan()
    torch.set_num_threads(1)  # tiny models: threads only add overhead
    yield
    jf.clear_plan()
    pf.clear_plan()


def _model(dropout=True):
    g = torch.Generator().manual_seed(0)
    mid = [nn.Dropout(0.5)] if dropout else []
    return Sequential(nn.Linear(8, 16, generator=g), nn.ReLU(), *mid,
                      nn.Linear(16, 3, generator=g), nn.LogSoftMax())


def _make_opt(max_it, ckpt=None, every=3, dropout=True, **kw):
    """The JAX test's trainee (tests/test_resilience.py), from its seed."""
    opt = Optimizer(_model(dropout), BatchDataSet(_X, _Y, 16),
                    nn.ClassNLLCriterion(),
                    optim_method=SGD(learning_rate=0.1),
                    end_when=Trigger.max_iteration(max_it), seed=7,
                    log_every=100, device="cpu")
    if ckpt:
        opt.set_checkpoint(Trigger.several_iteration(every), ckpt, **kw)
    return opt


def _run_supervised(make, ckpt, plan=None, budget=3):
    """cli.common.run_optimize under --supervise, with ``plan`` installed
    for the run; returns (trained, the injected events)."""
    if plan:
        pf.install_plan(pf.parse_plan(plan))
    try:
        args = SimpleNamespace(supervise=budget, checkpoint=ckpt, seed=7)
        return common.run_optimize(make, args), pf.injected_events()
    finally:
        pf.clear_plan()


def _assert_bit_equal(a, b):
    pa, pb = a.params, b.params
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


# --------------------------------------- supervised resume, bit for bit
@pytest.mark.parametrize("plan,max_it,every", [
    ("preempt_soft@step:6", 10, 3),      # mid-epoch 2 (ckpt at 3)
    ("preempt_soft@step:5", 8, 4),       # the first step of epoch 2
    ("preempt_soft@ckpt_save:2", 10, 3),  # inside state.3's write
    ("dispatch@step:7", 10, 3),          # a transient dispatch fault
    (None, 10, 3),                       # no fault: --supervise is a no-op
])
def test_supervised_run_is_bit_equal_to_the_uninterrupted_one(
        tmp_path, plan, max_it, every):
    """Each plan's supervised run ends with the uninterrupted run's
    parameters bit for bit (tolerance 0): the retry builds a fresh model
    and Optimizer and resumes the newest valid pair (a torn one falls back
    to the model-only blob), replaying the seed stream and the batches."""
    full = _make_opt(max_it).optimize()
    ck = str(tmp_path / "ck")
    got, events = _run_supervised(lambda: _make_opt(max_it, ck, every), ck,
                                  plan)
    _assert_bit_equal(full, got)
    assert len(events) == (0 if plan is None else 1)


def test_corrupt_checkpoint_falls_back_to_previous_pair(tmp_path):
    """corrupt@ckpt_save visit 4 bit-rots state.6 after its sidecar is
    written: the pair scan picks pair 3, whose resume replays to the
    uninterrupted run's parameters bit for bit."""
    full = _make_opt(10).optimize()
    ck = str(tmp_path / "ck")
    pf.install_plan(pf.parse_plan("corrupt@ckpt_save:4"))
    try:
        _make_opt(6, ck).optimize()  # writes 3 (sound) and 6 (corrupted)
    finally:
        pf.clear_plan()
    assert not tfile.verify_checkpoint(f"{ck}/state.6")
    m, _ = tfile.latest_valid_checkpoint_pair(ck)
    assert m.endswith("model.3")
    opt = _make_opt(10, ck)
    opt.resume(ck)
    _assert_bit_equal(full, opt.optimize())


def test_async_preempt_in_the_writer_reaches_the_supervisor(tmp_path):
    """preempt_soft@ckpt_save inside the async writer thread is raised at
    the next join as itself (a retryable fault), so the supervisor
    retries it; the run ends bit-equal to the uninterrupted one."""
    full = _make_opt(10).optimize()
    ck = str(tmp_path / "ck")
    got, events = _run_supervised(
        lambda: _make_opt(10, ck, async_save=True), ck,
        "preempt_soft@ckpt_save:3")
    _assert_bit_equal(full, got)
    assert [(e["site"], e["visit"]) for e in events] == [("ckpt_save", 3)]


# ------------------------------------- the same plan in both packages
def _jax_model():
    return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 3),
                          jnn.LogSoftMax())


def _train_rows(d):
    """{iteration: loss} of a summary directory's train.jsonl, the last
    row of each iteration winning (a retry rewrites the ones it redoes)."""
    out = {}
    with open(os.path.join(d, "train.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out[r["iteration"]] = r["loss"]
    return out


def test_one_plan_fires_alike_in_both_packages(tmp_path):
    """The same plan through both packages' run_optimize gives the same
    event log (site, visit, kind), across a retry, and the losses of a
    Dropout-free model agree step by step on converted parameters."""
    plan = "stall@data:2:0;dispatch@step:5;io@ckpt_save:3"
    jm = _jax_model()
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(3)))
    tensors = tensors_from_jax(_model(False), params)

    def jmake(d=str(tmp_path / "jck")):
        opt = JOptimizer(jm, JBatchDataSet(_X, _Y, 16, shuffle=False),
                         jnn.ClassNLLCriterion(),
                         optim_method=JSGD(learning_rate=0.1),
                         end_when=JTrigger.max_iteration(8), seed=7,
                         log_every=1)
        opt.set_state(params=jax.tree_util.tree_map(jnp.asarray, params))
        opt.set_checkpoint(JTrigger.several_iteration(2), d)
        opt.set_summary(str(tmp_path / "jsum"))
        return opt

    def pmake(d=str(tmp_path / "pck")):
        opt = Optimizer(_model(False), BatchDataSet(_X, _Y, 16),
                        nn.ClassNLLCriterion(),
                        optim_method=SGD(learning_rate=0.1),
                        end_when=Trigger.max_iteration(8), seed=7,
                        log_every=1, device="cpu")
        opt.set_state(params=tensors)
        opt.set_checkpoint(Trigger.several_iteration(2), d)
        opt.set_summary(str(tmp_path / "psum"))
        return opt

    jf.install_plan(jf.parse_plan(plan))
    try:
        jcommon.run_optimize(jmake, SimpleNamespace(
            supervise=3, checkpoint=str(tmp_path / "jck"), seed=7))
        jev = jf.injected_events()
    finally:
        jf.clear_plan()
    _, pev = _run_supervised(pmake, str(tmp_path / "pck"), plan)
    key = [(e["site"], e["visit"], e["fault"]) for e in jev]
    assert key == [(e["site"], e["visit"], e["fault"]) for e in pev]
    assert {k[2] for k in key} == {"stall", "dispatch", "io"}
    jl, pl = _train_rows(tmp_path / "jsum"), _train_rows(tmp_path / "psum")
    assert sorted(jl) == sorted(pl) == list(range(1, 9))
    np.testing.assert_allclose([pl[i] for i in pl], [jl[i] for i in pl],
                               rtol=0, atol=LOSS_ATOL)


# ----------------------------------------------- remote (fsspec) paths
def test_memory_roundtrip_and_overwrite_guard():
    """save_leaves/load_leaves/latest_checkpoint on memory://, and an
    Optimizer's overwrite guard there: a second run without overwrite
    refuses the existing snapshot (FileExistsError)."""
    base = "memory://ckpts/port_run1"
    leaves = [np.arange(6.0).reshape(2, 3), np.asarray([1, 2, 3], np.int32)]
    paths = [("a",), ("b", "c")]
    tfile.save_leaves(f"{base}/model.3", leaves, paths)
    tfile.save_leaves(f"{base}/model.10", leaves, paths)
    assert tfile.is_remote(base) and not tfile.is_remote("/tmp/x")
    assert tfile.latest_checkpoint(base, "model.").endswith("model.10")
    got, gp = tfile.load_leaves(f"{base}/model.3")
    assert gp == paths
    for a, b in zip(leaves, got):
        np.testing.assert_array_equal(a, b)
    ck = "memory://ckpts/port_guard"
    opt = _make_opt(3, ck)
    assert opt.set_checkpoint(Trigger.several_iteration(3), ck) is opt
    opt.optimize()
    assert tfile.exists(f"{ck}/model.3") and tfile.verify_checkpoint(
        f"{ck}/model.3")
    with pytest.raises(FileExistsError):
        _make_opt(3, ck).optimize()
    _make_opt(3, ck, overwrite=True).optimize()


def test_jax_memory_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX Optimizer's checkpoint on memory:// is resumed by the port:
    the port's remaining steps give the JAX run's losses (1e-5)."""
    jm = _jax_model()
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(4)))
    ck = "memory://ckpts/jax_to_port"

    def jrun(max_it, d):
        opt = JOptimizer(jm, JBatchDataSet(_X, _Y, 16, shuffle=False),
                         jnn.ClassNLLCriterion(),
                         optim_method=JSGD(learning_rate=0.1,
                                           momentum=0.9),
                         end_when=JTrigger.max_iteration(max_it), seed=7,
                         log_every=1)
        opt.set_state(params=jax.tree_util.tree_map(jnp.asarray, params))
        if d:
            opt.set_checkpoint(JTrigger.several_iteration(3), d)
        opt.set_summary(str(tmp_path / f"j{max_it}"))
        return opt.optimize()

    jrun(3, ck)
    jrun(6, None)
    ref = _train_rows(tmp_path / "j6")
    assert jfile.latest_checkpoint(ck, "model.").endswith("model.3")
    opt = Optimizer(_model(False), BatchDataSet(_X, _Y, 16),
                    nn.ClassNLLCriterion(),
                    optim_method=SGD(learning_rate=0.1, momentum=0.9),
                    end_when=Trigger.max_iteration(6), seed=7, log_every=1,
                    device="cpu")
    opt.set_summary(str(tmp_path / "p"))
    opt.resume(ck).optimize()
    got = _train_rows(tmp_path / "p")
    assert sorted(got) == [4, 5, 6]
    np.testing.assert_allclose([got[i] for i in (4, 5, 6)],
                               [ref[i] for i in (4, 5, 6)], rtol=0,
                               atol=LOSS_ATOL)


def test_port_memory_checkpoint_loads_into_the_jax_model():
    """A port checkpoint on memory://: its leaves, unflattened with the
    JAX model's treedef, are the JAX model's params, and give the port
    model's log-probabilities (1e-5)."""
    ck = "memory://ckpts/port_to_jax"
    trained = _make_opt(4, ck, every=4, dropout=False).optimize()
    jm = _jax_model()
    like = jm.init(jax.random.PRNGKey(0))
    import fsspec
    fs, p = fsspec.core.url_to_fs(f"{ck}/model.4")
    import io
    with fs.open(p, "rb") as f:
        z = np.load(io.BytesIO(f.read()))
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    drv = {k: 0 for k in ("epoch", "epoch_records", "iteration",
                          "rng_splits")}
    blob = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(
        {"driver": drv, "mod_state": jm.init_state(), "params": like}),
        leaves)
    assert int(blob["driver"]["iteration"]) == 4
    out = jm.forward(blob["params"], jnp.asarray(_X), blob["mod_state"],
                     training=False)
    with torch.no_grad():
        ref = trained.module(torch.from_numpy(_X)).numpy()
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=LOSS_ATOL)


# ------------------------------------------------------- DCP snapshots
def test_dcp_roundtrip_in_one_process(tmp_path):
    """save_sharded/restore_sharded in one process, local and memory://:
    the same tensors and string leaves back; an existing path refused
    unless overwrite; restore_for_inference reads a model snapshot and
    refuses a state one and a JAX orbax directory with one line."""
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": np.ones(3, np.float32)},
            "driver": {"plan": {"mode": np.asarray("shuffle")}}}
    for path in (str(tmp_path / "snap"), "memory://ckpts/dcp_one"):
        orbax_ckpt.save_sharded(tree, path)
        back = orbax_ckpt.restore_sharded(path)
        assert torch.equal(back["params"]["w"], tree["params"]["w"])
        assert back["params"]["b"].numpy().tolist() == [1.0, 1.0, 1.0]
        assert back["driver"]["plan"]["mode"] == "shuffle"
        with pytest.raises(FileExistsError):
            orbax_ckpt.save_sharded(tree, path)
        orbax_ckpt.save_sharded(tree, path, overwrite=True)
        params, _ = orbax_ckpt.restore_for_inference(path)
        assert sorted(params) == ["b", "w"]
    orbax_ckpt.save_sharded({"velocity": {"w": torch.zeros(2)}},
                            str(tmp_path / "st"))
    with pytest.raises(SystemExit, match="state.<n>"):
        orbax_ckpt.restore_for_inference(str(tmp_path / "st"))
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(SystemExit, match="orbax"):
        orbax_ckpt.restore_for_inference(str(tmp_path / "orbax"))
    with pytest.raises(SystemExit, match="does not exist"):
        orbax_ckpt.restore_for_inference(str(tmp_path / "none"))


def test_optimizer_sharded_checkpoints_resume_bit_for_bit(tmp_path):
    """set_checkpoint(sharded=True) writes DCP snapshot directories; a
    supervised run killed mid-epoch resumes from them to the uninterrupted
    run's parameters bit for bit, and load_trained serves from one."""
    full = _make_opt(9).optimize()
    ck = str(tmp_path / "ck")
    got, _ = _run_supervised(lambda: _make_opt(9, ck, sharded=True), ck,
                             "preempt_soft@step:6")
    _assert_bit_equal(full, got)
    assert orbax_ckpt.is_sharded(f"{ck}/model.9")
    with pytest.raises(ValueError, match="async_save"):
        _make_opt(3, ck, sharded=True, async_save=True)
    served = common.load_trained(_model(), ck)
    for k, v in served.state_dict().items():
        assert torch.equal(v, full.params[k]), k


def test_dcp_zero1_save_at_two_ranks_restores_in_one_process(tmp_path):
    """A 2-rank gloo job (ZeRO-1 SGD-momentum) writes its checkpoints once
    as DCP snapshots and once as blobs; restored in one process, the DCP
    optimizer state and parameters equal the single-blob restore bit for
    bit, and both resume to the same parameters."""
    res = spawn("torch_resilience_cases:zero1_dcp", 2,
                {"dir": str(tmp_path)}, timeout_s=JOB_TIMEOUT_S,
                backend="gloo",
                env={"PYTHONPATH": os.path.join(REPO, "tests")})
    assert [r["world"] for r in res] == [2, 2]
    import torch_resilience_cases as C
    model = C.model()
    like = C.method().init(dict(model.named_parameters()))
    a = load_state(str(tmp_path / "dcp" / "state.4"), like, model)
    b = load_state(str(tmp_path / "blob" / "state.4"), like, model)

    def leaves(t, pre=()):
        for k, v in sorted(t.items()):
            if isinstance(v, dict):
                yield from leaves(v, pre + (k,))
            else:
                yield pre + (k,), v

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert sorted(la) == sorted(lb) and len(la) > 2
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    outs = []
    for d in ("dcp", "blob"):
        opt = C.optimizer(None, 6)
        opt.resume(str(tmp_path / d))
        outs.append(opt.optimize())
    _assert_bit_equal(*outs)


# ------------------------------------------------- restore_resharded
def test_restore_resharded_4_to_2_and_back(tmp_path):
    """A state blob written under 4 ranks restored at 2 and one written
    under 2 restored at 4: each rank keeps the entries it owns at the new
    count (balanced_owners), the ranks' entries partition the state, and
    every entry is the blob's, bit for bit."""
    from bigdl_tpu_torch.parallel.data_parallel import balanced_owners
    model = _model()
    params = dict(model.named_parameters())
    method = SGD(0.1, momentum=0.9)
    state = method.init(params)
    g = torch.Generator().manual_seed(1)
    for v in state["velocity"].values():
        v.copy_(torch.randn(v.shape, generator=g))
    for written, read in ((4, 2), (2, 4)):
        path = str(tmp_path / f"state.{written}")
        save_state(path, state, model, layout={"n_devices": written})
        assert tfile.read_manifest(path)["layout"]["n_devices"] == written
        owners = balanced_owners({n: p.numel() * p.element_size()
                                  for n, p in params.items()}, read)
        seen = {}
        for r in range(read):
            got = tfile.restore_resharded(path, Mesh("data", read, r),
                                          params=params)
            for kp, t in got.items():
                if kp[0] != "velocity":
                    continue
                name = ".".join(kp[1:])
                assert owners[name] == r
                assert name not in seen
                seen[name] = t
        assert sorted(seen) == sorted(state["velocity"])
        for n, t in seen.items():
            assert torch.equal(t, state["velocity"][n])
        whole = tfile.restore_resharded(path, Mesh("data", read, 0),
                                        zero1=False)
        assert len(whole) == len(state["velocity"]) + 2  # step, epoch


def test_restore_resharded_rejects_blob_manifest_mismatch(tmp_path):
    model = _model()
    path = str(tmp_path / "state.1")
    save_state(path, SGD(0.1, momentum=0.9).init(
        dict(model.named_parameters())), model)
    man = tfile.read_manifest(path)
    man["leaves"][0]["shape"] = [99]
    with open(tfile.manifest_path(path), "w") as f:
        json.dump(man, f)
    with pytest.raises(tfile.ChecksumError):
        tfile.restore_resharded(path, Mesh("data", 2, 0), verify=False)


# ------------------------------------------------------------ chaos_run
def test_chaos_run_one_kill_is_equal(tmp_path):
    """tools/chaos_run kills the trainee once (os._exit(75)), restarts it
    under supervise_command, and its line says the final parameters equal
    the uninterrupted run's."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.tools.chaos_run",
         "--kills", "1", "--platform", "cpu", "--workdir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    line = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")][-1]
    assert line["equal"] is True
    assert line["restarts"] == 1 and line["kills"] == [6]
    assert [e["fault"] for e in line["fault_events"]] == ["preempt"]
