"""Point-to-point hops between the ranks of a mesh line (the port's
``lax.ppermute``): what ring attention (``parallel.sequence``) and the
GPipe schedule (``parallel.pipeline``) move their activations with.

The backend decides the path. NCCL sends and receives on the card
(``batch_isend_irecv``, so a rank that both sends and receives posts both
at once). Gloo has no point-to-point path for CUDA tensors: a card tensor
is copied to the host, sent from there and received into a host buffer,
then copied to the card. On the CPU gloo sends the tensor itself. Neither
path is a fallback for the other. Every call names its peers by their
index on ``line`` (a one-axis :class:`~bigdl_tpu_torch.parallel.mesh.Mesh`,
``mesh.axis_view(axis)``); ``torch.distributed`` gets the job's ranks.
"""

from __future__ import annotations

import torch

__all__ = ["shift", "send", "recv", "Shift"]


def _dist():
    import torch.distributed as dist
    return dist


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses through the host: a card tensor under gloo."""
    return t.is_cuda and _dist().get_backend(group) == "gloo"


def shift(t: torch.Tensor, line, step: int = 1) -> torch.Tensor:
    """Send ``t`` to the rank ``step`` places on along ``line`` (cyclic)
    and return what the rank ``step`` places back sent (a tensor shaped
    and typed as ``t``): every rank of the line calls it together."""
    n = line.size
    if n <= 1 or step % n == 0:
        return t
    dist = _dist()
    dst = line.global_rank((line.rank + step) % n)
    src = line.global_rank((line.rank - step) % n)
    t = t.detach().contiguous()
    if _staged(t, line.group):
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        work = dist.isend(t.cpu(), dst, group=line.group)
        dist.recv(out, src, group=line.group)
        work.wait()
        return out.to(t.device, non_blocking=True)
    out = torch.empty_like(t)
    if t.is_cuda:
        ops = [dist.P2POp(dist.isend, t, dst, line.group),
               dist.P2POp(dist.irecv, out, src, line.group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return out
    work = dist.isend(t, dst, group=line.group)
    dist.recv(out, src, group=line.group)
    work.wait()
    return out


def send(t: torch.Tensor, line, to: int, tag: int = 0) -> None:
    """Send ``t`` to index ``to`` of ``line`` (returns once it is sent)."""
    dist = _dist()
    t = t.detach().contiguous()
    if _staged(t, line.group):
        t = t.cpu()
    dist.send(t, line.global_rank(to), group=line.group, tag=tag)


def recv(shape, dtype, device, line, frm: int,
         tag: int = 0) -> torch.Tensor:
    """The tensor index ``frm`` of ``line`` sends (``shape``, ``dtype``),
    on ``device``."""
    dist = _dist()
    probe = torch.empty(0, device=device)
    if _staged(probe, line.group):
        out = torch.empty(shape, dtype=dtype, pin_memory=True)
        dist.recv(out, line.global_rank(frm), group=line.group, tag=tag)
        return out.to(device, non_blocking=True)
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(out, line.global_rank(frm), group=line.group, tag=tag)
    return out


class Shift(torch.autograd.Function):
    """:func:`shift` by ``step`` as an autograd op: the backward shifts the
    gradient back by ``-step`` (the VJP of ``ppermute`` is the reverse
    ``ppermute``), so a gradient reaches the rank that owned the tensor."""

    @staticmethod
    def forward(ctx, t, line, step: int = 1):
        ctx.line, ctx.step = line, step
        return shift(t, line, step)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.line, -ctx.step), None, None
