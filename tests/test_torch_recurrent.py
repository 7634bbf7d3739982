"""The port's recurrent layers (``bigdl_tpu_torch.nn.recurrent``) against the
JAX package's on the CPU: the same numpy-seeded inputs, the JAX init tree
carried across strictly by ``interop.load_jax``.

Tolerances: f32 outputs and states atol 1e-5 (the port sums the hoisted
input projection in another order than the scan's per-step product);
gradients max|d| <= 1e-4 * max|g| per tensor, against ``jax.grad``. The
bf16 case runs both packages in bf16 from the same f32 weights: each
step rounds its gates and state to bf16 (8 significant bits), and the
two packages may round differently where their sums differ in the last
bits, so the outputs (|y| < 0.5 here, where a bf16 ulp is 2^-9 = 2e-3)
are held to atol 1e-2, five ulps after 6 steps, and their mean
difference to 2e-3 (measured: 4.9e-3 and 4.3e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import load_jax, tensors_from_jax

B, T, I, H = 3, 6, 4, 5
ATOL = 1e-5
GRAD_REL = 1e-4
BF16_ATOL, BF16_MEAN = 1e-2, 2e-3

CELLS = {"rnn": (jnn.RnnCell, nn.RnnCell), "lstm": (jnn.LSTMCell,
                                                    nn.LSTMCell),
         "gru": (jnn.GRUCell, nn.GRUCell)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(jm, seed=0):
    return _np_tree(jm.init(jax.random.PRNGKey(seed)))


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=atol)


def _pair(kind, **kw):
    """A JAX cell and the port's, loaded from the JAX init tree."""
    jcls, tcls = CELLS[kind]
    jc, tc = jcls(I, H, **kw), tcls(I, H, **kw)
    p = _init(jc)
    load_jax(tc, p)
    return jc, tc, p


@pytest.mark.parametrize("kind", ["rnn", "lstm", "lstm_fb0", "gru"])
def test_cell_matches_jax(kind):
    kw = {"forget_bias": 0.0} if kind == "lstm_fb0" else {}
    jc, tc, p = _pair(kind.split("_")[0], **kw)
    rs = np.random.RandomState(1)
    x = rs.randn(B, I).astype(np.float32)
    h = rs.randn(B, H).astype(np.float32)
    if kind.startswith("lstm"):
        c = rs.randn(B, H).astype(np.float32)
        jy, (jh, jcs) = jc.forward(p, (jnp.asarray(x), (jnp.asarray(h),
                                                         jnp.asarray(c))))
        ty, (th, tcs) = tc((torch.from_numpy(x), (torch.from_numpy(h),
                                                  torch.from_numpy(c))))
        _close(tcs.detach(), jcs)
    else:
        jy, jh = jc.forward(p, (jnp.asarray(x), jnp.asarray(h)))
        ty, th = tc((torch.from_numpy(x), torch.from_numpy(h)))
    _close(ty.detach(), jy)
    _close(th.detach(), jh)


def test_parameter_names_are_the_jax_trees():
    bi = nn.BiRecurrent(nn.LSTMCell(I, H), nn.GRUCell(I, H))
    assert sorted(n for n, _ in bi.named_parameters()) == sorted(
        f"{d}.cell.{k}" for d in ("fwd", "bwd")
        for k in ("w_ih", "w_hh", "bias"))
    assert bi.fwd.cell.w_ih.shape == (I, 4 * H)  # JAX's (in, out)
    assert bi.bwd.cell.w_hh.shape == (H, 3 * H)


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seqs", [True, False])
def test_recurrent_matches_jax(kind, reverse, seqs):
    jcls, tcls = CELLS[kind]
    jr = jnn.Recurrent(jcls(I, H), return_sequences=seqs, reverse=reverse)
    tr = nn.Recurrent(tcls(I, H), return_sequences=seqs, reverse=reverse)
    p = _init(jr, 3)
    load_jax(tr, p)
    x = np.random.RandomState(2).randn(B, T, I).astype(np.float32)
    jy = jr.forward(p, jnp.asarray(x))
    ty = tr(torch.from_numpy(x)).detach()
    assert tuple(ty.shape) == jy.shape == ((B, T, H) if seqs else (B, H))
    _close(ty, jy)
    if not seqs:  # the last step run: t = 0 when reversed
        full = nn.Recurrent(tr.cell, reverse=reverse)(torch.from_numpy(x))
        _close(ty, full[:, 0 if reverse else -1].detach(), 0)


@pytest.mark.parametrize("merge", ["concat", "sum"])
@pytest.mark.parametrize("seqs", [True, False])
def test_birecurrent_matches_jax(merge, seqs):
    jb = jnn.BiRecurrent(jnn.LSTMCell(I, H), jnn.LSTMCell(I, H), merge=merge,
                         return_sequences=seqs)
    tb = nn.BiRecurrent(nn.LSTMCell(I, H), nn.LSTMCell(I, H), merge=merge,
                        return_sequences=seqs)
    p = _init(jb, 4)
    load_jax(tb, p)
    x = np.random.RandomState(5).randn(B, T, I).astype(np.float32)
    jy = jb.forward(p, jnp.asarray(x))
    ty = tb(torch.from_numpy(x)).detach()
    _close(ty, jy)
    if not seqs and merge == "concat":
        # the forward half at T-1, the backward half at 0
        yf, yb = tb.fwd(torch.from_numpy(x)), tb.bwd(torch.from_numpy(x))
        _close(ty[:, :H], yf[:, -1].detach(), 0)
        _close(ty[:, H:], yb[:, 0].detach(), 0)


def test_birecurrent_refuses_an_unknown_merge():
    with pytest.raises(ValueError, match="merge"):
        nn.BiRecurrent(nn.RnnCell(I, H), nn.RnnCell(I, H), merge="mean")


def _grad_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    return 0.0 if scale == 0 else np.abs(got - ref).max() / scale


@pytest.mark.parametrize("kind,trunc,reverse", [
    ("lstm", 0, False), ("lstm", 1, False), ("lstm", 2, False),
    ("lstm", 2, True), ("rnn", 2, False), ("gru", 3, True)])
def test_recurrent_gradients_match_jax(kind, trunc, reverse):
    """d loss / d (params, x) of a weighted sum of every output, with the
    hidden state detached every ``trunc`` steps (counted in the loop's
    order: reversed time for a reversed Recurrent)."""
    jcls, tcls = CELLS[kind]
    jr = jnn.Recurrent(jcls(I, H), bptt_truncate=trunc, reverse=reverse)
    tr = nn.Recurrent(tcls(I, H), bptt_truncate=trunc, reverse=reverse)
    p = _init(jr, 6)
    load_jax(tr, p)
    rs = np.random.RandomState(7)
    x = rs.randn(B, T, I).astype(np.float32)
    w = rs.randn(B, T, H).astype(np.float32)

    def jloss(params, xin):
        return jnp.sum(jr.forward(params, xin) * jnp.asarray(w))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tr(xt) * torch.from_numpy(w)).sum().backward()
    ref = tensors_from_jax(tr, _np_tree(jgp))
    errs = {n: _grad_err(q.grad, ref[n]) for n, q in tr.named_parameters()}
    errs["x"] = _grad_err(xt.grad, jgx)
    assert max(errs.values()) <= GRAD_REL, errs
    if trunc == 1:  # every step cut: x_t reaches only y_t
        single = nn.Recurrent(tr.cell, bptt_truncate=1)
        xs = torch.from_numpy(x).requires_grad_(True)
        single(xs)[:, -1].sum().backward()
        assert np.abs(xs.grad[:, :-1].numpy()).max() == 0
        assert np.abs(xs.grad[:, -1].numpy()).max() > 0


def test_recurrent_bf16_matches_jax():
    jr = jnn.Recurrent(jnn.LSTMCell(I, H))
    tr = nn.Recurrent(nn.LSTMCell(I, H))
    p = _init(jr, 8)
    load_jax(tr, p)
    x = np.random.RandomState(9).randn(B, T, I).astype(np.float32)
    jy = np.asarray(jr.forward(p, jnp.asarray(x, jnp.bfloat16))
                    .astype(jnp.float32))
    ty = tr(torch.from_numpy(x).bfloat16())
    assert ty.dtype == torch.bfloat16
    d = np.abs(ty.float().detach().numpy() - jy)
    assert d.max() <= BF16_ATOL and d.mean() <= BF16_MEAN, (d.max(),
                                                            d.mean())
    # the cell state follows the input's dtype, as in JAX
    _, (h, c) = tr.cell((torch.zeros(B, I, dtype=torch.bfloat16),
                         tr.cell.initial_hidden(B, torch.bfloat16)))
    assert h.dtype == c.dtype == torch.bfloat16


def test_recurrent_names_are_exported():
    assert {"RnnCell", "LSTMCell", "GRUCell", "Recurrent",
            "BiRecurrent"} <= set(nn.__all__)
    assert set(jnn.recurrent.__all__) <= set(nn.__all__)
