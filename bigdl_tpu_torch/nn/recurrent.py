"""Recurrent layers (counterpart of ``bigdl_tpu/nn/recurrent.py``; reference
nn/Recurrent.scala:27-113, nn/RNN.scala:27-90).

The JAX package unrolls a cell with one ``lax.scan``; here ``Recurrent`` is
a Python loop over the time axis whose step index is a Python int, so
nothing in it reads a tensor back to the host and a training step that
runs it can be captured in a CUDA graph as it is. Truncated BPTT detaches
the hidden state every ``bptt_truncate`` steps, counted in the order the
loop runs (in reversed time for a reversed ``Recurrent``), as the scan's
step counter does.

Each cell splits its work in two: ``project`` is the input side of every
step, computed for the whole sequence as one matrix product before the
loop (``x.reshape(B * T, F) @ w_ih``), and ``step`` is the recurrence. The
sums keep the JAX cells' order: ``(x_t @ w_ih + h @ w_hh) + bias`` for
``RnnCell`` and ``LSTMCell``, and ``x_t @ w_ih + bias`` on the input side
for ``GRUCell``. Weights are kept in JAX's (in, out) orientation under the
JAX tree's names (``cell.w_ih``, ``cell.w_hh``, ``cell.bias``), so a JAX
tree loads with ``interop.load_jax`` as it is. The dtype follows the
input: the weights are cast to ``x.dtype``, the initial state is zeros of
it, and the LSTM's cell state stays in it.

Sequence layout: (B, T, F), time axis 1.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from bigdl_tpu_torch.core.module import Module, SimpleModule, uniform_fan_in

__all__ = ["RnnCell", "LSTMCell", "GRUCell", "Recurrent", "BiRecurrent"]


def _detach(hidden):
    if isinstance(hidden, tuple):
        return tuple(h.detach() for h in hidden)
    return hidden.detach()


class Cell(SimpleModule):
    """A recurrent cell. Called on its own, ``cell((x_t, hidden))`` returns
    ``(y_t, new_hidden)``; ``hidden`` is a tensor or a tuple of them.
    ``Recurrent`` calls ``project`` once over the sequence and ``step`` at
    each time step with the weights ``recurrent_weights`` gives."""

    hidden_size: int

    def initial_hidden(self, batch: int, dtype=torch.float32, device=None):
        raise NotImplementedError

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The input side of every step: ``x @ w_ih`` over (..., in)."""
        return x @ self.w_ih.to(x.dtype)

    def recurrent_weights(self, dtype) -> tuple:
        """The step's weights cast to ``dtype``, cast once a sequence."""
        return self.w_hh.to(dtype), self.bias.to(dtype)

    def step(self, xp: torch.Tensor, hidden, weights):
        raise NotImplementedError

    def forward(self, x):
        x_t, hidden = x
        return self.step(self.project(x_t), hidden,
                         self.recurrent_weights(x_t.dtype))


class RnnCell(Cell):
    """Vanilla RNN cell: act(x @ w_ih + h @ w_hh + bias) (reference
    nn/RNN.scala's i2h, h2h, CAddTable and activation, fused)."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation: Callable = torch.tanh,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self.w_ih = nn.Parameter(uniform_fan_in(
            (input_size, hidden_size), input_size, generator))
        self.w_hh = nn.Parameter(uniform_fan_in(
            (hidden_size, hidden_size), hidden_size, generator))
        self.bias = nn.Parameter(uniform_fan_in((hidden_size,), hidden_size,
                                                generator))

    def initial_hidden(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros(batch, self.hidden_size, dtype=dtype,
                           device=device)

    def step(self, xp, h, weights):
        w_hh, bias = weights
        h_new = self.activation(xp + h @ w_hh + bias)
        return h_new, h_new


class LSTMCell(Cell):
    """LSTM with the four gates [i, f, g, o] in one product and
    ``forget_bias`` added inside the forget gate's sigmoid (not stored in
    ``bias``, which starts at zero)."""

    def __init__(self, input_size: int, hidden_size: int,
                 forget_bias: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.forget_bias = forget_bias
        h4 = 4 * hidden_size
        self.w_ih = nn.Parameter(uniform_fan_in((input_size, h4), input_size,
                                                generator))
        self.w_hh = nn.Parameter(uniform_fan_in((hidden_size, h4),
                                                hidden_size, generator))
        self.bias = nn.Parameter(torch.zeros(h4))

    def initial_hidden(self, batch: int, dtype=torch.float32, device=None):
        z = torch.zeros(batch, self.hidden_size, dtype=dtype, device=device)
        return (z, z)  # (h, c)

    def step(self, xp, hidden, weights):
        h, c = hidden
        w_hh, bias = weights
        gates = xp + h @ w_hh + bias
        i, f, g, o = gates.chunk(4, -1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f + self.forget_bias)
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRUCell(Cell):
    """GRU with the three gates [r, z, n] in one product each side and the
    one bias on the input side: n = tanh(x_n + r * (h @ w_hh)_n)."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        h3 = 3 * hidden_size
        self.w_ih = nn.Parameter(uniform_fan_in((input_size, h3), input_size,
                                                generator))
        self.w_hh = nn.Parameter(uniform_fan_in((hidden_size, h3),
                                                hidden_size, generator))
        self.bias = nn.Parameter(torch.zeros(h3))

    def initial_hidden(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros(batch, self.hidden_size, dtype=dtype,
                           device=device)

    def project(self, x):
        return x @ self.w_ih.to(x.dtype) + self.bias.to(x.dtype)

    def recurrent_weights(self, dtype) -> tuple:
        return (self.w_hh.to(dtype),)

    def step(self, xp, h, weights):
        hh = h @ weights[0]
        xr, xz, xn = xp.chunk(3, -1)
        hr, hz, hn = hh.chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1 - z) * n + z * h
        return h_new, h_new


class Recurrent(Module):
    """A cell unrolled over the time axis (reference nn/Recurrent.scala).

    * ``bptt_truncate``: the hidden state is detached before every
      ``bptt_truncate``-th step (0: full BPTT), the reference's
      bpttTruncate (Recurrent.scala:66-107).
    * ``return_sequences``: True -> (B, T, H) outputs; False -> the last
      step's output, which for ``reverse`` is the output at t = 0.
    * ``reverse``: run the sequence from its end; the outputs keep the
      input's time order."""

    def __init__(self, cell: Cell, bptt_truncate: int = 0,
                 return_sequences: bool = True, reverse: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.cell = cell
        self.bptt_truncate = bptt_truncate
        self.return_sequences = return_sequences
        self.reverse = reverse

    def forward(self, x):
        batch, steps = x.shape[0], x.shape[1]
        cell, trunc = self.cell, self.bptt_truncate
        # unbind: one backward node stacks the T steps' gradients, where
        # indexing step t would zero-fill a whole (B, T, k*H) gradient for
        # each step and add it into the next
        xp = cell.project(x.reshape(batch * steps, -1)).view(
            batch, steps, -1).unbind(1)
        weights = cell.recurrent_weights(x.dtype)
        h = cell.initial_hidden(batch, x.dtype, x.device)
        order = range(steps - 1, -1, -1) if self.reverse else range(steps)
        ys = []
        for n, t in enumerate(order):
            if trunc > 0 and n % trunc == 0:
                h = _detach(h)
            y, h = cell.step(xp[t], h, weights)
            ys.append(y)
        if not self.return_sequences:
            return ys[-1]
        if self.reverse:
            ys.reverse()
        return torch.stack(ys, 1)

    def extra_repr(self) -> str:
        return (f"bptt_truncate={self.bptt_truncate}, return_sequences="
                f"{self.return_sequences}, reverse={self.reverse}")


class BiRecurrent(Module):
    """Two cells over opposite time directions, merged by ``concat`` (the
    default) or ``sum``: the BiRNN of BASELINE config 5. The halves are
    ``fwd`` and ``bwd`` (a reversed ``Recurrent``), each returning its
    whole sequence. ``return_sequences=False`` returns the final state of
    each direction: the forward half at t = T-1 joined to the backward
    half at t = 0, each having read the whole sequence."""

    def __init__(self, fwd_cell: Cell, bwd_cell: Cell, merge: str = "concat",
                 return_sequences: bool = True, name: Optional[str] = None):
        super().__init__(name)
        if merge not in ("concat", "sum"):
            raise ValueError(f"merge must be 'concat' or 'sum', got "
                             f"{merge!r}")
        self.fwd = Recurrent(fwd_cell)
        self.bwd = Recurrent(bwd_cell, reverse=True)
        self.merge = merge
        self.return_sequences = return_sequences

    def forward(self, x):
        yf, yb = self.fwd(x), self.bwd(x)
        if not self.return_sequences:
            yf, yb = yf[:, -1], yb[:, 0]
        return torch.cat([yf, yb], -1) if self.merge == "concat" else yf + yb
