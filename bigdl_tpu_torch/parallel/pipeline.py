"""Pipeline parallelism: the GPipe microbatch schedule over a ``pipe``
mesh axis (counterpart of ``bigdl_tpu/parallel/pipeline.py``).

:class:`PipelineStack` holds L homogeneous, stateless blocks with their
parameters stacked on a leading ``[L, ...]`` axis, named by the block's
JAX paths (the JAX ``PipelineStack.init`` tree), so a JAX tree loads by
name (``interop.load_jax``). :func:`place_pipeline_params` keeps stage
p's blocks [p·L/P, (p+1)·L/P) on the rank at index p of the pipe axis.

:func:`pipeline_forward` runs the stack as a pipeline: M microbatches
through P stages. The JAX package runs one SPMD program whose ticks hop
activations with ``ppermute``; the port runs one process a stage, and
each stage takes microbatch m from the stage before it, runs its blocks
and sends the result on, so stage p works on microbatch m while stage p
+ 1 works on m - 1: M + P - 1 steps of the slowest stage, the bubble
(P - 1)/(M + P - 1) of GPipe. The sends and receives are autograd ops
whose backward sends the gradient the other way, so the backward runs
the pipeline in reverse. The last stage's outputs are broadcast to every
stage (the JAX ``psum`` of zeros elsewhere), whose backward hands the
gradient to the last stage only: a loss that every stage computes alike
counts once.

With ``data_axis`` each microbatch is split over the data ranks too: a
rank runs and returns its rows of each microbatch
(:func:`pipeline_rows`), and :func:`make_pipeline_train_step` averages
the gradients and the loss over the data axis. Stated difference: the
JAX function returns the whole batch, sharded; the port returns this
rank's rows.

Collectives: the stage hops are ``parallel.p2p`` sends and receives (on
the card under NCCL, through the host under gloo); the output broadcast
is a ``broadcast`` (on the card under both backends)."""

from __future__ import annotations

import copy
from typing import Callable, Optional, Union

import torch
from torch import nn

from bigdl_tpu_torch.core.module import Module, fold_seed, takes_seed
from bigdl_tpu_torch.nn.moe import stack_modules
from bigdl_tpu_torch.parallel.mesh import Mesh
from bigdl_tpu_torch.parallel.p2p import recv, send

__all__ = ["PipelineStack", "pipeline_forward", "place_pipeline_params",
           "make_pipeline_train_step", "pipeline_rows"]


def _dist():
    import torch.distributed as dist
    return dist


class PipelineStack(Module):
    """``PipelineStack(block, num_blocks)``: ``num_blocks`` blocks shaped
    like ``block`` (a stateless module, copied into every block, or a
    callable returning a fresh one: then each block is its own draw, as
    each JAX block gets its own key). The parameters are the blocks'
    stacked on a leading [L, ...] axis under the block's own names
    (``mha.wq`` is [L, d, d]). The single-process ``forward`` runs the
    blocks in turn (the JAX ``lax.scan`` over layers); block i draws its
    noise from ``fold_seed(seed, i)``. After :func:`place_pipeline_params`
    the stack holds its stage's blocks only (``stage``: their global
    range)."""

    def __init__(self, block: Union[nn.Module, Callable[[], nn.Module]],
                 num_blocks: int, name: Optional[str] = None):
        super().__init__(name)
        make = block if not isinstance(block, nn.Module) else (
            lambda: copy.deepcopy(block))
        blocks = [make() for _ in range(num_blocks)]
        params = {n for n, _ in blocks[0].named_parameters()}
        if set(blocks[0].state_dict()) - params:
            raise ValueError("PipelineStack blocks must be stateless "
                             f"({type(blocks[0]).__name__} has state)")
        body = stack_modules(blocks)
        self.num_blocks = num_blocks
        self.stage = (0, num_blocks)
        # the block the forward calls functionally; its children are this
        # module's, so the parameters carry the block's names
        self.__dict__["_body"] = body
        for name, child in body.named_children():
            self.add_module(name, child)
        for name, p in body.named_parameters(recurse=False):
            self.register_parameter(name, p)
        self.jax_stacked = True
        self._noisy = takes_seed(blocks[0])

    def run_blocks(self, h, seed=None):
        """``h`` through the blocks this stack holds (all of them, or its
        stage's), block i (its global index) seeded ``fold_seed(seed,
        i)``."""
        stacked = dict(self.named_parameters())
        lo, hi = self.stage
        for i in range(hi - lo):
            kw = ({"seed": fold_seed(seed, lo + i)}
                  if self._noisy and seed is not None and self.training
                  else {})
            h = torch.func.functional_call(
                self._body, {k: v[i] for k, v in stacked.items()}, (h,), kw)
        return h

    def forward(self, x, seed=None):
        if self.stage != (0, self.num_blocks):
            raise ValueError(f"this stack holds blocks {self.stage} of "
                             f"{self.num_blocks}: run it with "
                             f"pipeline_forward")
        return self.run_blocks(x, seed)

    def extra_repr(self) -> str:
        return f"num_blocks={self.num_blocks}, stage={self.stage}"


def place_pipeline_params(stack: PipelineStack, mesh: Mesh,
                          axis: str = "pipe") -> PipelineStack:
    """Keep stage p's blocks [p·L/P, (p+1)·L/P) of ``stack`` (new
    Parameters, the rest freed) on the rank at index p of ``mesh``'s
    ``axis``. Returns the stack."""
    view = mesh.axis_view(axis)
    n_stage, L = view.size, stack.num_blocks
    if L % n_stage:
        raise ValueError(f"{L} blocks not divisible by {n_stage} pipeline "
                         f"stages")
    if stack.stage != (0, L):
        raise ValueError(f"the stack is placed already (blocks "
                         f"{stack.stage})")
    per = L // n_stage
    lo = view.rank * per
    with torch.no_grad():
        for name, p in list(stack.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = stack.get_submodule(owner) if owner else stack
            setattr(mod, leaf, nn.Parameter(p.data[lo:lo + per].clone(),
                                            requires_grad=p.requires_grad))
    stack.stage = (lo, lo + per)
    return stack


def pipeline_rows(batch: int, microbatches: int, mesh: Mesh,
                  data_axis: Optional[str] = None) -> torch.Tensor:
    """The rows of a global batch of ``batch`` that this rank runs, in the
    order :func:`pipeline_forward` returns them: each microbatch's part
    on this rank's index of ``data_axis`` (all of it without one)."""
    mb = batch // microbatches
    lo, n = 0, mb
    if data_axis is not None:
        view = mesh.axis_view(data_axis)
        if mb % view.size:
            raise ValueError(f"microbatch {mb} not divisible by the "
                             f"{view.size} ranks of the {data_axis!r} axis")
        n = mb // view.size
        lo = view.rank * n
    return torch.cat([torch.arange(m * mb + lo, m * mb + lo + n)
                      for m in range(microbatches)])


class _Send(torch.autograd.Function):
    """Send h to stage ``to``; a 0-d token stands for it in the graph. The
    backward receives h's gradient from that stage."""

    @staticmethod
    def forward(ctx, h, line, to: int, tag: int):
        ctx.line, ctx.to, ctx.tag = line, to, tag
        ctx.meta = (h.shape, h.dtype, h.device)
        send(h, line, to, tag)
        return h.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.meta
        return recv(shape, dtype, device, ctx.line, ctx.to, ctx.tag), None, \
            None, None


class _Recv(torch.autograd.Function):
    """The activation stage ``frm`` sends (``anchor``, an empty view of a
    parameter, ties the op to the graph). The backward sends the
    activation's gradient back to that stage."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, line, frm: int, tag: int):
        ctx.line, ctx.frm, ctx.tag = line, frm, tag
        return recv(shape, dtype, anchor.device, line, frm, tag)

    @staticmethod
    def backward(ctx, g):
        send(g, ctx.line, ctx.frm, ctx.tag)
        return None, None, None, None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's ``out`` on every stage of ``line``; ``tokens``
    (the stage's sends) tie the stage's pipeline to the result. The
    backward gives the gradient to the last stage's ``out`` alone, and
    zeros to the tokens, which start the backward's sends."""

    @staticmethod
    def forward(ctx, out, line, *tokens):
        ctx.last = line.rank == line.size - 1
        ctx.n_tokens = len(tokens)
        dist = _dist()
        wide = out.is_cuda and out.dtype in (torch.bfloat16, torch.float16) \
            and dist.get_backend(line.group) == "gloo"
        buf = out.detach().float() if wide else \
            out.detach().contiguous().clone()
        # gloo's card path broadcasts 16-bit tensors widened to f32
        dist.broadcast(buf, src=line.global_rank(line.size - 1),
                       group=line.group)
        return buf.to(out.dtype) if wide else buf

    @staticmethod
    def backward(ctx, g):
        zero = g.new_zeros(())
        return ((g if ctx.last else None), None) + (zero,) * ctx.n_tokens


def pipeline_forward(stack: PipelineStack, mesh: Mesh, x,
                     microbatches: int, axis: str = "pipe",
                     data_axis: Optional[str] = None, seed=None):
    """The pipelined forward of ``stack`` (placed over ``mesh``'s
    ``axis``) on the global batch ``x`` (batch, ...), split into
    ``microbatches`` equal microbatches along dim 0: ``stack``'s forward
    up to the order of the sums, on every stage. With ``data_axis`` each
    rank runs and returns its rows (:func:`pipeline_rows`). Every rank of
    the mesh calls it together."""
    view = mesh.axis_view(axis)
    n_stage, L = view.size, stack.num_blocks
    if L % n_stage:
        raise ValueError(f"{L} blocks not divisible by {n_stage} pipeline "
                         f"stages")
    if x.shape[0] % microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{microbatches} microbatches")
    rows = pipeline_rows(x.shape[0], microbatches, mesh, data_axis)
    if n_stage == 1:
        return stack.run_blocks(x[rows.to(x.device)], seed)
    per = L // n_stage
    if stack.stage != (view.rank * per, (view.rank + 1) * per):
        raise ValueError(f"stage {view.rank} of {n_stage} holds blocks "
                         f"{stack.stage}: place the stack with "
                         f"place_pipeline_params first")
    xs = x[rows.to(x.device)].chunk(microbatches)
    p, last = view.rank, n_stage - 1
    # the receives hang off an empty view of a parameter, so a backward
    # that asks for the parameters' gradients alone (autograd.grad) still
    # runs them, and their sends of the gradient
    anchor = next(stack.parameters()).view(-1)[:0]
    tokens, outs = [], []
    for m, xm in enumerate(xs):
        h = xm if p == 0 else _Recv.apply(anchor, xm.shape, xm.dtype, view,
                                          p - 1, m)
        h = stack.run_blocks(h, None if seed is None
                             else fold_seed(seed, m))
        if p < last:
            tokens.append(_Send.apply(h, view, p + 1, m))
        else:
            outs.append(h)
    out = torch.cat(outs) if outs else torch.empty_like(x[rows.to(
        x.device)])
    return _Broadcast.apply(out, view, *tokens)


def make_pipeline_train_step(stack: PipelineStack, mesh: Mesh, criterion,
                             optim_method, microbatches: int,
                             axis: str = "pipe",
                             data_axis: Optional[str] = None):
    """The training step of ``stack`` (placed over ``axis``):
    ``step(opt_state, x, y, seed=None) -> loss`` runs
    :func:`pipeline_forward` on the global batch ``x``, ``criterion``
    against this rank's rows of ``y``, the pipelined backward, the mean
    of the gradients and of the loss over ``data_axis`` and
    ``optim_method.update`` of this stage's blocks alone (a stage-local
    optimizer: ``opt_state`` is ``optim_method.init`` of the placed
    stack's parameters). Returns the global loss (not synced)."""
    from bigdl_tpu_torch.parallel.data_parallel import DataParallel

    params = dict(stack.named_parameters())
    names, plist = list(params), list(params.values())
    dp = None
    if data_axis is not None and mesh.shape.get(data_axis, 1) > 1:
        dp = DataParallel(mesh.axis_view(data_axis), axis=data_axis,
                          zero1=False)

    def step(opt_state, x, y, seed=None):
        out = pipeline_forward(stack, mesh, x, microbatches, axis,
                               data_axis, seed)
        rows = pipeline_rows(x.shape[0], microbatches, mesh, data_axis)
        loss = criterion(out, y[rows.to(y.device)])
        grads = dict(zip(names, torch.autograd.grad(loss, plist)))
        if dp is not None:
            grads, loss = dp.reduce_grads(grads, loss)
        optim_method.update(grads, opt_state, params)
        return loss.detach()

    return step
