"""The port's L-BFGS, parameter trees, gradient checker and autoencoder
against the JAX package's, on the CPU.

``LBFGS`` and ``line_search_wolfe`` run the functions of
``tests/test_lbfgs.py`` from the same start in both packages, with the
port's closure evaluating the JAX function (so both see the same bits)
or the same function in torch: the loss histories and final iterates
agree within 1e-5 (absolute, and relative above 1). Rosenbrock under the
Wolfe search is the exception: XLA fuses ``x + t*d`` and the dot
products otherwise than torch, and its torch gradients differ from
JAX's in the last bit, so the two trajectories are 5e-7 apart after the
first iteration and the narrow valley magnifies that through the cubic
steps of the search (2.79440 against 2.79446 at the second line search,
1.5e-4 apart by the fifth iteration). There the first two losses agree
within 1e-5, both runs reach the minimum (loss < 1e-5, as
``tests/test_lbfgs.py`` asks), and their final iterates agree within
1e-3 (measured: 3e-4 at most).
``flatten_params`` of a carried JAX tree is ``ravel_pytree``'s vector
exactly. The autoencoder's reconstruction from one JAX init tree agrees
within atol 1e-5."""

import logging
import math
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu.core import pytree as jpytree
from bigdl_tpu.optim import LBFGS as JLBFGS
from bigdl_tpu.optim import line_search_wolfe as jline_search
from bigdl_tpu.utils import gradcheck as jgradcheck
from bigdl_tpu_torch import core, models, nn
from bigdl_tpu_torch.cli import autoencoder as ae_cli
from bigdl_tpu_torch.cli import main as cli_main
from bigdl_tpu_torch.core import pytree
from bigdl_tpu_torch.interop import load_jax, params_from_jax
from bigdl_tpu_torch.optim import LBFGS, line_search_wolfe
from bigdl_tpu_torch.utils import check_gradients, numerical_grad

TOL = 1e-5
# Rosenbrock from 0 under the Wolfe search: the first two losses agree
# within TOL, then both reach the minimum (loss < 1e-5) and their last
# iterates agree within 1e-3
VALLEY_SAME, VALLEY_X_TOL = 2, 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _agree(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


# ------------------------------------------------------------------ L-BFGS
def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen_t(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                     + (1.0 - x[:-1]) ** 2)


def _torch_feval(fn):
    def feval(p):
        p = pytree.tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss = fn(p)
        grads = iter(torch.autograd.grad(loss, pytree.tree_leaves(p)))
        return loss.detach(), pytree.tree_map(lambda _: next(grads), p)
    return feval


def _quad_j(p):
    return jnp.sum((p["w"] - jnp.asarray([1.0, -2.0, 3.0])) ** 2) + (
        p["b"] - 0.5) ** 2


def _quad_t(p):
    return torch.sum((p["w"] - torch.tensor([1.0, -2.0, 3.0])) ** 2) + (
        p["b"] - 0.5) ** 2


_LIN = np.random.RandomState(0)
_W_TRUE = _LIN.randn(5, 3).astype(np.float32)
_X = _LIN.randn(64, 5).astype(np.float32)
_Y = _X @ _W_TRUE


def _lin_j(p):
    return jnp.mean((jnp.asarray(_X) @ p["weight"] + p["bias"]
                     - jnp.asarray(_Y)) ** 2)


def _lin_t(p):
    return torch.mean((torch.from_numpy(_X) @ p["weight"] + p["bias"]
                       - torch.from_numpy(_Y)) ** 2)


CASES = {
    "rosenbrock_wolfe": (_rosen_j, _rosen_t, lambda: np.zeros(4, np.float32),
                         dict(max_iter=100, max_eval=500, line_search=True)),
    "rosenbrock_fixed": (_rosen_j, _rosen_t, lambda: np.zeros(2, np.float32),
                         dict(max_iter=200, max_eval=1000, learning_rate=0.5,
                              line_search=False)),
    "quadratic_tree": (_quad_j, _quad_t,
                       lambda: {"w": np.zeros(3, np.float32),
                                "b": np.zeros((), np.float32)},
                       dict(max_iter=50)),
    "linear_regression": (
        _lin_j, _lin_t,
        lambda: _np_tree(jnn.Linear(5, 3).init(jax.random.PRNGKey(0))),
        dict(max_iter=100, max_eval=400)),
}


def _bridged(jfeval):
    """A feval of the port's optimiser that evaluates the JAX function:
    both optimisers then see the same bits at the same point, so what
    differs is their own arithmetic."""
    def feval(p):
        loss, grads = jfeval(jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()), p))
        return (torch.from_numpy(np.array(loss)),
                jax.tree_util.tree_map(lambda a: torch.from_numpy(
                    np.array(a)), grads))
    return feval


@pytest.mark.parametrize("name,feval", [
    (name, "bridged") for name in CASES] + [
    (name, "torch") for name in CASES])
def test_lbfgs_matches_jax(name, feval):
    """From the same start, with the JAX function bridged in or the same
    function written in torch. Rosenbrock under the Wolfe search is held
    to the valley's rule (module docstring)."""
    jfn, tfn, start, kw = CASES[name]
    p0 = start()
    jfeval = jax.jit(jax.value_and_grad(jfn))
    jx, jl = JLBFGS(**kw).optimize(
        lambda p: jfeval(p), jax.tree_util.tree_map(jnp.asarray, p0))
    tx, tl = LBFGS(**kw).optimize(
        _bridged(jfeval) if feval == "bridged" else _torch_feval(tfn),
        jax.tree_util.tree_map(torch.from_numpy, p0))
    assert jl[-1] < jl[0]
    pairs = list(zip(pytree.tree_leaves(tx), jax.tree_util.tree_leaves(jx)))
    if name == "rosenbrock_wolfe":
        np.testing.assert_allclose(tl[:VALLEY_SAME], jl[:VALLEY_SAME],
                                   rtol=TOL, atol=TOL)
        assert tl[-1] < 1e-5 and jl[-1] < 1e-5
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=VALLEY_X_TOL)
        return
    assert len(tl) == len(jl)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    for a, b in pairs:
        _agree(a.numpy(), b)


def test_line_search_wolfe_matches_jax():
    """Along the steepest descent of Rosenbrock from (-1.2, 1), from a
    step too long (the zoom) and one too short (the expansion)."""
    x0 = np.asarray([-1.2, 1.0], np.float32)
    jf = jax.jit(jax.value_and_grad(_rosen_j))
    f0, g0 = jf(jnp.asarray(x0))
    d = -np.asarray(g0)
    gtd = float(np.dot(np.asarray(g0), d))

    def jdir(t):
        f, g = jf(jnp.asarray(x0 + t * d))
        return float(f), float(jnp.dot(g, jnp.asarray(d)))

    tfeval = _torch_feval(_rosen_t)

    def tdir(t):
        f, g = tfeval(torch.from_numpy(x0) + t * torch.from_numpy(d))
        return float(f), float(torch.dot(g, torch.from_numpy(d)))

    for t0 in (1.0, 1e-5):
        got = line_search_wolfe(tdir, t0, float(f0), gtd)
        ref = jline_search(jdir, t0, float(f0), gtd)
        assert got[2] == ref[2]
        np.testing.assert_allclose(got[:2], ref[:2], rtol=TOL, atol=TOL)


# ------------------------------------------------------------------ pytree
def test_flatten_params_is_ravel_pytree():
    jm = jax_models.birnn_classifier(11, 4, 3, 2)
    params = _np_tree(jm.init(jax.random.PRNGKey(1)))
    ref, _ = ravel_pytree(params)
    flat_names = params_from_jax(params)  # {"1.fwd.cell.w_ih": ...}
    nested = jax.tree_util.tree_map(torch.from_numpy, params)
    for tree in (flat_names, nested):
        flat, unflatten = core.flatten_params(tree)
        assert flat.numpy().tobytes() == np.asarray(ref).tobytes()
        back = unflatten(flat * 2)
        for a, b in zip(pytree.tree_leaves(back), pytree.tree_leaves(tree)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b * 2)
    # mixed dtypes promote, and each leaf keeps its own on the way back
    tree = {"b": torch.ones(2, dtype=torch.bfloat16), "a": torch.arange(3.)}
    flat, unflatten = core.flatten_params(tree)
    jflat, _ = ravel_pytree({"b": jnp.ones(2, jnp.bfloat16),
                             "a": jnp.arange(3.0)})
    assert flat.dtype == torch.float32 and np.array_equal(flat.numpy(),
                                                          np.asarray(jflat))
    assert unflatten(flat)["b"].dtype == torch.bfloat16
    assert core.flatten_params({})[0].numel() == 0


def test_tree_helpers_match_jax():
    rs = np.random.RandomState(2)
    a = {"x": rs.randn(3, 2).astype(np.float32),
         "y": {"z": rs.randn(4).astype(np.float32)}}
    b = jax.tree_util.tree_map(lambda v: v * 0.5 + 1, a)
    ta, tb = (jax.tree_util.tree_map(torch.from_numpy, t) for t in (a, b))
    for got, ref in ((pytree.tree_add(ta, tb), jpytree.tree_add(a, b)),
                     (pytree.tree_scale(ta, 3.0), jpytree.tree_scale(a, 3.0)),
                     (pytree.tree_zeros_like(ta),
                      jpytree.tree_zeros_like(a))):
        for g, r in zip(pytree.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert pytree.tree_size(ta) == jpytree.tree_size(a) == 10
    np.testing.assert_allclose(float(pytree.tree_global_norm(ta)),
                               float(jpytree.tree_global_norm(a)), rtol=1e-6)
    assert float(pytree.tree_global_norm({})) == 0.0
    assert pytree.tree_cast(ta, torch.bfloat16)["y"]["z"].dtype == \
        torch.bfloat16
    with pytest.raises(TypeError):
        pytree.tree_leaves({"x": "not a tensor"})


# --------------------------------------------------------------- gradcheck
def test_check_gradients_passes_on_a_small_lstm():
    """Full BPTT through an LSTM and the BiLSTM classifier pass at the
    JAX defaults."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 5, 3).astype(np.float32))
    rec = nn.Recurrent(nn.LSTMCell(3, 4))
    ids = torch.from_numpy(rs.randint(0, 20, (3, 6)).astype(np.int32))
    y = torch.from_numpy(rs.randint(0, 2, 3))
    bi = models.birnn_classifier(20, 4, 5, 2,
                                 generator=torch.Generator().manual_seed(0))
    crit = nn.ClassNLLCriterion()
    for model, loss in (
            (rec, lambda p: torch.func.functional_call(
                rec, p, (x,)).square().sum()),
            (bi, lambda p: crit(torch.func.functional_call(bi, p, (ids,)),
                                y))):
        check_gradients(loss, {k: v.detach()
                               for k, v in model.named_parameters()})


def test_truncated_bptt_is_the_gradient_of_the_truncated_objective():
    """``simple_rnn``'s BPTT cut every 2 steps (T = 7: cuts before steps
    0, 2, 4, 6) is not the loss's gradient, so the full finite-difference
    check fails on it, in JAX as here; it is the gradient of the loss
    with the hidden state entering step 6 held at its value, which central
    differences of that objective confirm at the JAX defaults."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(3, 7, 6).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 5, 3))
    m = models.simple_rnn(6, 8, 5, generator=torch.Generator().manual_seed(1))
    crit = nn.ClassNLLCriterion()
    params = {k: v.detach() for k, v in m.named_parameters()}

    def loss(p):
        return crit(torch.func.functional_call(m, p, (x,)), y)

    with pytest.raises(AssertionError):
        check_gradients(loss, params)
    cell = m[0].cell
    with torch.no_grad():
        h = cell.initial_hidden(3)
        for t in range(6):
            _, h = cell((x[:, t], h))

    def held(p):
        cp = {k[len("0.cell."):]: v for k, v in p.items()
              if k.startswith("0.cell.")}
        y6, _ = torch.func.functional_call(cell, cp, ((x[:, 6], h),))
        out = torch.func.functional_call(
            m[1], {"weight": p["1.weight"], "bias": p["1.bias"]}, (y6,))
        return crit(m[2](out), y)

    flat, unflatten = core.flatten_params(params)
    v = flat.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(loss(unflatten(v)), v)
    idx, num = numerical_grad(lambda f: held(unflatten(f)), flat, 1e-3)
    np.testing.assert_allclose(auto.numpy()[idx], num, rtol=2e-2, atol=5e-3)


class _WrongTanh(torch.autograd.Function):
    """tanh whose backward drops the derivative's square term."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.tanh(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (1 - torch.tanh(x))


def test_check_gradients_catches_a_wrong_backward():
    cell = nn.RnnCell(3, 4, activation=_WrongTanh.apply)
    rec = nn.Recurrent(cell)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 4, 3)
                         .astype(np.float32))

    def loss(p):
        return torch.func.functional_call(rec, p, (x,)).square().sum()

    params = {k: v.detach() for k, v in rec.named_parameters()}
    with pytest.raises(AssertionError):
        check_gradients(loss, params)
    rec.cell.activation = torch.tanh
    check_gradients(loss, params)


def test_numerical_grad_matches_jax():
    """The same subsample and the same differences (eps 1e-2: a sum of
    300 terms near 100 rounds to 8e-6 in f32, 4e-4 over 2 eps)."""
    v = np.linspace(-1, 1, 300).astype(np.float32)
    idx, got = numerical_grad(lambda f: torch.sum(torch.sin(f) * f),
                              torch.from_numpy(v), eps=1e-2)
    jidx, ref = jgradcheck.numerical_grad(
        lambda f: jnp.sum(jnp.sin(f) * f), jnp.asarray(v), eps=1e-2)
    np.testing.assert_array_equal(idx, jidx)
    assert len(idx) == 200
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    exact = np.sin(v[idx]) + v[idx] * np.cos(v[idx])
    np.testing.assert_allclose(got, exact, rtol=0, atol=2e-3)


# ------------------------------------------------------------- autoencoder
def test_autoencoder_matches_jax():
    jm, tm = jax_models.autoencoder(32), models.autoencoder(32)
    params = _np_tree(jm.init(jax.random.PRNGKey(6)))
    load_jax(tm, params)
    assert tm.name == jm.name
    x = np.random.RandomState(7).rand(5, 28, 28, 1).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm.forward(params, jnp.asarray(x))),
                               rtol=0, atol=1e-5)


def _write_mnist(folder, n, seed):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 10, n).astype(np.uint8)
    x = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    for stem in ("train", "t10k"):
        with open(folder / f"{stem}-images-idx3-ubyte", "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + x.tobytes())
        with open(folder / f"{stem}-labels-idx1-ubyte", "wb") as f:
            f.write(struct.pack(">II", 2049, n) + y.tobytes())


@pytest.mark.parametrize("adagrad", [False, True])
def test_autoencoder_cli_trains_one_epoch(tmp_path, caplog, monkeypatch,
                                          adagrad):
    _write_mnist(tmp_path, 64, 8)
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch")
    built = []
    real = ae_cli.common.build_optimizer
    monkeypatch.setattr(ae_cli.common, "build_optimizer",
                        lambda *a, **kw: built.append(real(*a, **kw))
                        or built[-1])
    argv = ["autoencoder", "train", "-f", str(tmp_path), "-b", "16",
            "--maxEpoch", "1", "--logEvery", "1", "--learningRate", "0.01",
            "--platform", "cpu"] + (["--adagrad"] if adagrad else [])
    assert cli_main.main(argv) == 0
    losses = [float(r.getMessage().rsplit(" ", 1)[1])
              for r in caplog.records if "Loss is" in r.getMessage()]
    assert len(losses) == 4 and all(math.isfinite(v) for v in losses)
    assert all(0 < v < 1 for v in losses)  # MSE of sigmoids on [0, 1]
    method = built[0].optim_method
    assert type(method).__name__ == ("Adagrad" if adagrad else "SGD")
    assert built[0].model.name == "Autoencoder"
