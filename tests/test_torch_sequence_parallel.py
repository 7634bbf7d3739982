"""The port's sequence parallelism (``bigdl_tpu_torch.parallel.sequence``:
ring attention, ``SequenceParallel``, ``cli.perf --strategy sp``) against
the JAX package's on the CPU. The port runs one job of 4 gloo ranks (the
cases are in tests/torch_spe_cases.py); the JAX package runs in this
process on conftest's virtual devices.

Held: the ring at seq:2 and seq:4 against ``bigdl_tpu.parallel.
make_ring_attention`` (causal and not, with and without ``segments``,
``block_k`` dividing the chunk and not): output within 1e-5, dq/dk/dv of
the output's sum within 1e-4 of max|g| (``jax.grad``); one SGD step of a
2-layer LM at dp:2 x sp:2 (sinusoidal positions) and sp:4 (RoPE) against
the port's single process, params within 1e-5 of max|p| (a rank whose
chunk started at position 0 fails it); batch norm over the seq axis
against the whole rows' statistics; ``cli.perf --strategy sp`` against
the single process's losses, and its exits.
"""

import jax
import numpy as np
import pytest
import torch

import torch_spe_cases as C
from bigdl_tpu import models as jax_models
from bigdl_tpu.parallel import make_mesh as jax_make_mesh
from bigdl_tpu.parallel import make_ring_attention as jax_ring
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import tensors_from_jax
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


@pytest.fixture(scope="module")
def sp_job(tmp_path_factory):
    """Seeded inputs and JAX LM init trees; the 4-rank job's results
    {case: [rank's npz]} and its notes."""
    root = tmp_path_factory.mktemp("sp")
    rs = np.random.RandomState(0)
    inp = {f"ring_{t}": rs.randn(*C.RING_SHAPE).astype(np.float32)
           for t in "qkv"}
    b, _, s, _ = C.RING_SHAPE
    inp["ring_seg"] = np.sort(rs.randint(0, 3, (b, s)), axis=1).astype(
        np.int32)
    v = C.SP_LM["vocab"]
    inp["lm_x"] = rs.randint(0, v, (C.SP_BATCH, 16)).astype(np.int32)
    inp["lm_y"] = rs.randint(0, v, (C.SP_BATCH, 16)).astype(np.int32)
    inp["bn_x"] = rs.randn(4, 6, 3).astype(np.float32)
    for pos in C.SP_MESH:
        jm = jax_models.transformer_lm(v, d_model=C.SP_LM["d_model"],
                                       num_layers=C.SP_LM["num_layers"],
                                       num_heads=C.SP_LM["num_heads"],
                                       max_len=C.SP_LM["max_len"],
                                       pos_encoding=pos)
        p = jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.PRNGKey(3)))
        inp.update({f"lm_{pos}/{k}": t.numpy() for k, t in
                    tensors_from_jax(C.sp_lm(pos), p).items()})
    np.savez(root / "inputs.npz", **inp)
    cases = ["ring", "sp_lm", "sp_perf"]
    notes = spawn("torch_spe_cases:run_all", RANKS,
                  {"dir": str(root), "cases": cases},
                  timeout_s=JOB_TIMEOUT_S, backend="gloo", env=ENV)
    out = {c: [dict(np.load(root / f"{c}_r{r}.npz")) for r in range(RANKS)]
           for c in cases}
    return inp, out, notes


@pytest.mark.parametrize("n,causal,seg,bk", C.RING_CASES)
def test_ring_matches_jax(n, causal, seg, bk, sp_job):
    """The ring's output chunks and gradient chunks, gathered over the
    ranks of the first seq line, against the JAX ring on n devices."""
    inp, out, _ = sp_job
    q, k, v = (inp[f"ring_{t}"] for t in "qkv")
    segs = inp["ring_seg"] if seg else None
    attn = jax_ring(jax_make_mesh({"data": 1, "seq": n},
                                  devices=jax.devices()[:n]),
                    "seq", batch_axis="data", block_k=bk)

    @jax.jit
    def run(q, k, v):
        def total(q, k, v):
            o = attn(q, k, v, causal=causal, segments=segs)
            return o.sum(), o

        (_, o), g = jax.value_and_grad(total, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
        return o, g

    want, grads = run(q, k, v)
    want = np.asarray(want)
    tag = C.ring_tag(n, causal, seg, bk)

    def gathered(key):
        return np.concatenate([out["ring"][r][f"{tag}/{key}"]
                               for r in range(n)], axis=2)

    np.testing.assert_allclose(gathered("o"), want, atol=1e-5)
    for name, g in zip(("dq", "dk", "dv"), grads):
        g = np.asarray(g)
        np.testing.assert_allclose(gathered(name), g,
                                   atol=1e-4 * np.abs(g).max(),
                                   err_msg=name)


@pytest.mark.parametrize("pos", list(C.SP_MESH))
def test_sp_lm_step_matches_one_process(pos, sp_job):
    """One step of the LM with the ring under ``SequenceParallel``: every
    rank's whole parameters and the loss equal the single process's step
    with dense attention (the positions are global)."""
    inp, out, _ = sp_job
    model = C._load(C.sp_lm(pos), inp, f"lm_{pos}")
    loss, want = C.sp_step(model, torch.from_numpy(inp["lm_x"]),
                           torch.from_numpy(inp["lm_y"]))
    pmax = max(float(np.abs(p).max()) for p in want.values())
    for r in range(RANKS):
        got = out["sp_lm"][r]
        assert abs(float(got[f"{pos}/loss"]) - loss) <= 1e-5 * abs(loss)
        for k, p in want.items():
            np.testing.assert_allclose(got[f"{pos}/{k}"], p,
                                       atol=1e-5 * pmax, err_msg=k)


def test_batch_norm_over_the_seq_axis(sp_job):
    """BN(axis_name="seq") on each rank's (b, s_local, c) chunk normalises
    by its data line's whole rows, as one BN over them."""
    inp, out, _ = sp_job
    x = torch.from_numpy(inp["bn_x"])
    for d in range(2):
        bn = nn.BatchNormalization(3).train()
        want = bn(x[2 * d:2 * d + 2]).detach().numpy()
        got = np.concatenate([out["sp_lm"][2 * d + s]["bn/y"]
                              for s in range(2)], axis=1)
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(out["sp_lm"][2 * d]["bn/running_var"],
                                   bn.running_var.numpy(), atol=1e-6)


def test_perf_sp_line_and_exits(sp_job):
    """``cli.perf --strategy sp`` at 4 ranks: mesh {"data": 2, "seq": 2},
    the single process's losses; a length the seq axis does not divide, a
    model that is no LM and --remat exit with their texts."""
    from bigdl_tpu_torch.cli import perf
    _, out, notes = sp_job
    perf.LM_CONFIGS["spe_test_lm"] = dict(C.PERF_LM)
    try:
        want = perf.run("spe_test_lm", batch=4, iterations=2, warmup=1,
                        dtype=torch.float32, device="cpu",
                        seq_len=16)["losses"]
    finally:
        del perf.LM_CONFIGS["spe_test_lm"]
    n = notes[0]["sp_perf"]
    assert n["strategy"] == "sp" and n["n_devices"] == 4
    assert n["mesh"] == {"data": 2, "seq": 2}
    np.testing.assert_allclose(out["sp_perf"][0]["losses"], want,
                               rtol=1e-5)
    assert "sequence length 15 must be divisible by the seq axis (2)" \
        in n["odd_seq"]
    assert "needs a transformer_lm* model" in n["not_lm"]
    assert "without layer remat" in n["remat"]

