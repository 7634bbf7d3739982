"""Sequence (context) parallelism: ring attention over a ``seq`` mesh axis
(counterpart of ``bigdl_tpu/parallel/sequence.py``).

The sequence dimension is split over the ranks of the ``seq`` axis: each
rank holds one (b, h, s_local, d) chunk of Q, K and V. K and V (and the
packed-row segment ids) travel round the ring, rank to rank + 1, while
each rank folds every arriving chunk into its queries' streaming softmax
(``ops.online_softmax_update``) in sub-blocks of ``block_k`` keys, each
under a non-reentrant ``torch.utils.checkpoint`` (the JAX ``jax.
checkpoint`` on the scan body): memory a rank is O(s_local x block_k),
and the result is full attention up to the order of the sums.

The hop is :class:`~bigdl_tpu_torch.parallel.p2p.Shift`, an autograd op
whose backward sends the gradient back round the ring, the VJP of the
``ppermute`` that ``jax.grad`` gives the JAX ring: dK and dV reach the
rank that owns them. The causal mask reads global positions (this rank's
queries start at ``rank * s_local``), so the model's positions must be
global too: :class:`RingAttention` tells an LM the offset of its chunk
(``position_offset``), which ``PositionalEncoding`` and RoPE take.

:class:`SequenceParallel` is the training strategy of ``cli.perf
--strategy sp``: the batch split over the data axis and the sequence over
the seq axis, the parameters replicated on both, the gradients and the
loss averaged over data x seq (the JAX ``DataParallel`` over that mesh,
whose jit holds the whole batch)."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.ops.attention_kernel import online_softmax_update
from bigdl_tpu_torch.parallel.data_parallel import DataParallel
from bigdl_tpu_torch.parallel.mesh import Mesh
from bigdl_tpu_torch.parallel.p2p import Shift, shift

__all__ = ["ring_attention", "make_ring_attention", "RingAttention",
           "SequenceParallel", "install_ring_attention"]

_NEG_INF = -1e30  # finite mask value: a fully masked block keeps exp()
                  # well-defined (a true -inf would give NaN)


def _fold(q, kj, vj, m, l, o, q_pos, k0: int, bk: int, causal: bool,
          seg_q, sj, scale):
    """One sub-block's online-softmax step, its validity tile built here
    so a recompute rebuilds it: the causal triangle over global positions
    (keys from ``k0``) and the segment equality."""
    valid = None
    if causal:
        k_pos = k0 + torch.arange(bk, device=q.device)
        valid = q_pos[:, None] >= k_pos[None, :]
    if sj is not None:
        sv = seg_q[:, None, :, None] == sj[:, None, None, :]
        valid = sv if valid is None else valid & sv
    return online_softmax_update(q, kj, vj, m, l, o, scale, valid)


def ring_attention(q, k, v, segments=None, *, group: Mesh,
                   causal: bool = False, block_k: int = 512):
    """Blockwise ring attention of this rank's (b, h, s_local, d) chunks
    over ``group``, the seq axis's line (``mesh.axis_view("seq")``); every
    rank of the line calls it together. ``segments``: this rank's (b,
    s_local) packed-document ids; they ride the ring beside K and V (an
    id attends its own id, 0 too). Returns this rank's output chunk in
    q's dtype; a query row with nothing to attend comes out 0."""
    from torch.utils.checkpoint import checkpoint

    n, my = group.size, group.rank
    s_q, s_k = q.shape[-2], k.shape[-2]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    q_pos = my * s_q + torch.arange(s_q, device=q.device)
    seg_q = None if segments is None else segments.to(torch.int32)
    bk = min(block_k, s_k)
    n_sub = s_k // bk if s_k % bk == 0 else 1
    if n_sub == 1:
        bk = s_k
    m = torch.full(q.shape[:-1] + (1,), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:-1] + (1,), dtype=torch.float32,
                    device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    kv, sb = torch.stack([k, v]), seg_q
    for t in range(n):
        # after t hops of "send to next" this rank holds the chunk born on
        # rank (my - t)
        src = (my - t) % n
        for j in range(n_sub):
            blk = slice(j * bk, (j + 1) * bk)
            args = (q, kv[0, ..., blk, :], kv[1, ..., blk, :], m, l, o,
                    q_pos, src * s_k + j * bk, bk, causal, seg_q,
                    None if sb is None else sb[:, blk], scale)
            if remat:
                m, l, o = checkpoint(_fold, *args, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                m, l, o = _fold(*args)
        if t < n - 1:
            kv = Shift.apply(kv, group, 1)
            if sb is not None:
                sb = shift(sb, group, 1)
    return (o / l.clamp_min(1e-30)).to(q.dtype)


class RingAttention:
    """The ``attn_impl`` of :class:`~bigdl_tpu_torch.nn.MultiHeadAttention`
    that :func:`make_ring_attention` returns: ``(q, k, v, *, causal,
    mask, segments)`` -> this rank's output chunk. ``position_offset(s)``
    is the global position of this rank's first token when each rank holds
    ``s`` tokens, which the LM's positions take."""

    def __init__(self, line: Mesh, block_k: int = 512):
        self.line, self.block_k = line, block_k

    def position_offset(self, s_local: int) -> int:
        return self.line.rank * s_local

    def __call__(self, q, k, v, *, causal: bool = False, mask=None,
                 segments=None):
        if mask is not None:
            raise NotImplementedError(
                "ring attention supports causal masking only")
        return ring_attention(q, k, v, segments, group=self.line,
                              causal=causal, block_k=self.block_k)


def make_ring_attention(mesh: Mesh, seq_axis: str = "seq",
                        batch_axis: Optional[str] = None,
                        block_k: int = 512) -> RingAttention:
    """:func:`ring_attention` over ``mesh``'s ``seq_axis``, as an
    ``attn_impl`` (the JAX function's ``shard_map`` wrapper). Each rank
    passes its own chunk: s on ``seq_axis`` (b on ``batch_axis``, which
    only names the layout here; the ring runs on the seq line alone)."""
    if batch_axis is not None and batch_axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {batch_axis!r}")
    return RingAttention(mesh.axis_view(seq_axis), block_k)


def install_ring_attention(model: torch.nn.Module, mesh: Mesh,
                           seq_axis: str = "seq",
                           batch_axis: Optional[str] = "data"
                           ) -> RingAttention:
    """Make every ``MultiHeadAttention`` of ``model`` the ring over
    ``mesh``'s ``seq_axis`` and run every ``TransformerEncoder`` without
    layer remat (a recomputed layer would repeat the ring's hops; the ring
    keeps its own sub-block checkpoints): the step of ``cli.perf
    --strategy sp``, which shardlint traces too. Returns the ring."""
    from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                              TransformerEncoder)

    ring = make_ring_attention(mesh, seq_axis, batch_axis=batch_axis)
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.set_attn_fn(ring)
        elif isinstance(m, TransformerEncoder):
            m.remat = False
    return ring


class SequenceParallel(DataParallel):
    """dp x sp over a mesh with ``data_axis`` and ``seq_axis``: each rank
    steps on its (batch / data, seq / seq-axis) block of the global batch
    (:meth:`shard_batch`); the parameters are replicated on every rank,
    and the gradients and the loss are averaged over all of them, data x
    seq (ZeRO-1 over the same ranks). The model's attention must be the
    ring over the same mesh (:func:`make_ring_attention`)."""

    def __init__(self, mesh: Mesh, data_axis: str = "data",
                 seq_axis: str = "seq", zero1: bool = True,
                 donate: bool = True, grad_comm=None):
        super().__init__(mesh, axis=data_axis, zero1=zero1, donate=donate,
                         grad_comm=grad_comm)
        if seq_axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.shape} has no axis {seq_axis!r}")
        self.seq_axis = seq_axis

    @property
    def data_mesh(self) -> Mesh:
        """The whole mesh as one axis: the ranks the gradients, the loss
        and ZeRO-1 are reduced over."""
        m = self.mesh
        return Mesh(self.axis, m.size, m.rank, group=m.group, ranks=m.ranks)

    @property
    def world(self) -> int:
        return self.mesh.size

    def shard_batch(self, x, y, rank_local: bool = False):
        """This rank's block of the global ``(batch, seq)`` ids and
        targets: rows by its index on the data axis, columns by its index
        on the seq axis. A batch or a length the axes do not divide
        raises."""
        if rank_local or self.world <= 1:
            return x, y
        rows, cols = (self.mesh.axis_view(self.axis),
                      self.mesh.axis_view(self.seq_axis))
        n, s = x.shape[0], x.shape[1]
        if n % rows.size:
            raise ValueError(f"global batch {n} is not divisible by the "
                             f"{rows.size} ranks of the {self.axis!r} axis")
        if s % cols.size:
            raise ValueError(f"sequence length {s} is not divisible by the "
                             f"{cols.size} ranks of the {self.seq_axis!r} "
                             f"axis")
        r, c = n // rows.size, s // cols.size
        lo, clo = rows.rank * r, cols.rank * c
        return x[lo:lo + r, clo:clo + c], y[lo:lo + r, clo:clo + c]
