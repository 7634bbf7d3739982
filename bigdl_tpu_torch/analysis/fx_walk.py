"""FX-graph traversal of the lint (counterpart of
``bigdl_tpu/analysis/jaxpr_walk.py``): the trace of a step and
provenance-preserving reads over it.

The JAX package traces a step with ``jax.make_jaxpr`` over
``ShapeDtypeStruct``s and walks the nested jaxpr levels. The port traces
with ``make_fx`` under a ``FakeTensorMode`` (:func:`trace_graph`): shapes,
dtypes and devices only, nothing allocated, computed or launched. The
graph is flat (``make_fx`` inlines every call, the autograd backward of a
training step included), and each node's ``meta["val"]`` carries the
shape and dtype a jaxpr var's aval carries. The hand kernels are opaque
to a trace: their wrappers record :class:`~bigdl_tpu_torch.ops.
lint_sites.KernelSite`s instead of launching, and :func:`kernel_sites`
reads them off the graph.

Stated differences from the JAX walk:

* A step's tensors are fake tensors on the ``meta`` device, the card's
  stand-in, and the kernel wrappers treat any fake tensor off the CPU as
  the card's: autograd over fake CUDA tensors needs CUDA's device guard,
  which a CPU-only build of torch lacks (the process aborts), and on a
  CUDA build it would start the card.
* ``.item()``/``.tolist()`` become ``aten._local_scalar_dense`` nodes
  (the fake mode hands back an unbacked scalar); Python control flow on
  such a scalar cannot be traced, and :func:`trace_graph` raises
  :class:`DataDependentTrace` naming the line where it happened.
* Sharding: the JAX walk reads ``NamedSharding`` annotations and
  ``sharding_constraint`` equations; the port has neither. Its layout is
  explicit: the strategies' spec trees (``megatron_specs``) and the
  ``c10d`` collectives a rank's step issues. A step over a mesh is traced
  on rank 0 of a fake process group of the mesh's size
  (:func:`fake_world`: ``torch.distributed``'s ``"fake"`` backend, which
  communicates nothing), or, in a job that already has its process
  group, on this rank over the job's groups (collectives on fake tensors
  communicate nothing either). :func:`collect_collectives` names the mesh
  axes each collective runs over from its process group: the port's
  counterpart of the JAX walk's ``collect_constraints`` (the replication
  points of a step).
"""

from __future__ import annotations

import contextlib
import copy
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["trace_graph", "fake_mode", "DataDependentTrace", "meta_clone",
           "fakeify_",
           "fake_world", "aval_bytes", "node_val", "consumers_map",
           "eqn_label", "call_nodes", "kernel_sites", "Collective",
           "collect_collectives", "ShardedLevel",
           "sharded_levels", "observed_mesh_axes", "spec_axes",
           "mesh_groups", "flatten_tree", "COLLECTIVE_NAMESPACES"]

# the namespaces of torch.distributed's traced collectives (the c10d ops
# the eager API dispatches, and the functional ones)
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
_NOT_COLLECTIVES = ("wait", "barrier", "monitored_barrier", "wait_tensor")
_TORCH_DIR = os.path.dirname(torch.__file__)


class DataDependentTrace(RuntimeError):
    """The step reads a value off the device (a host sync) and branches on
    it, so it cannot be traced; ``where`` names the line."""

    def __init__(self, message: str, where: str):
        super().__init__(message)
        self.where = where


def fake_mode():
    """The fake mode of a lint trace: real tensors it meets become fake
    ones (no data read), and ``.item()`` gives an unbacked scalar."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    return FakeTensorMode(allow_non_fake_inputs=True,
                          shape_env=ShapeEnv(allow_scalar_outputs=True))


def _user_frame(tb) -> str:
    """``file:line (function)`` of the innermost frame outside torch."""
    import traceback

    where = ""
    for fr in traceback.extract_tb(tb):
        if not fr.filename.startswith(_TORCH_DIR):
            where = (f"{os.path.basename(fr.filename)}:{fr.lineno} "
                     f"({fr.name})")
    return where


def _data_dependent_errors() -> tuple:
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    from torch.fx.experimental.symbolic_shapes import \
        GuardOnDataDependentSymNode
    return (DataDependentOutputException, DynamicOutputShapeException,
            GuardOnDataDependentSymNode)


@contextlib.contextmanager
def _quiet_tuning():
    """The tuner read-only for a trace: ``measure`` answers from its cache
    (a miss is the default), and the consulted-key ledger a perf line
    reports is left as it was."""
    from bigdl_tpu_torch.tuning import autotune as _at

    mode = _at.get_mode()
    ledger = dict(_at._DECISIONS)
    if mode == "measure":
        _at.set_mode("cached")
    try:
        yield
    finally:
        _at.set_mode(mode)
        _at._DECISIONS.clear()
        _at._DECISIONS.update(ledger)


def _to_fake(mode, t):
    from torch._subclasses.fake_tensor import FakeTensor

    if not isinstance(t, torch.Tensor) or isinstance(t, FakeTensor):
        return t
    return mode.from_tensor(t, static_shapes=True)


def trace_graph(fn, *args, mode=None, **kwargs):
    """The FX graph (``torch.fx.GraphModule``) of ``fn(*args, **kwargs)``
    traced on fake tensors: tensor arguments become placeholders (fake
    twins of their shape, dtype, device and ``requires_grad``), tensors
    ``fn`` closes over become constants. ``mode``: a :func:`fake_mode`
    the arguments were built in (default a new one). Nothing is computed
    or launched: the kernel sites the step meets are on
    ``graph.meta["kernel_sites"]``. The conv layout policy and the tuner
    are left as they were. Raises :class:`DataDependentTrace` where the
    step branches on a value read off the device."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._pytree import tree_map

    from bigdl_tpu_torch.ops import lint_sites
    from bigdl_tpu_torch.ops.conv2d import policy_snapshot, restore_policy

    mode = mode or fake_mode()
    with mode:
        fargs = tree_map(lambda t: _to_fake(mode, t), args)
    snap = policy_snapshot()
    try:
        with _quiet_tuning(), mode, lint_sites.recording() as sites:
            gm = make_fx(lambda *a: fn(*a, **kwargs),
                         tracing_mode="real")(*fargs)
    except _data_dependent_errors() as e:
        where = _user_frame(e.__traceback__)
        raise DataDependentTrace(
            f"{type(e).__name__}: the step branches on a value read off "
            f"the device", where) from e
    finally:
        restore_policy(snap)
    gm.meta["kernel_sites"] = list(sites)
    return gm


def meta_clone(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose parameters and buffers are ``meta``
    tensors of the same shapes and dtypes: a model a trace may place,
    slice and step without touching the original or allocating."""
    memo = {}
    for p in module.parameters():
        memo[id(p)] = torch.nn.Parameter(
            torch.empty_like(p, device="meta"), requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(module, memo)


def fakeify_(module: torch.nn.Module, mode, device=None) -> torch.nn.Module:
    """Replace ``module``'s parameters and buffers in place by fake tensors
    of ``mode`` (same shapes and dtypes; on ``device`` where given, else
    on their own): the module a trace steps, whose parameters the trace's
    placeholders then are. Returns it."""
    def fake(t):
        if device is None:
            return _to_fake(mode, t)
        with mode:
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device=device)

    for mod in module.modules():
        for n, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[n] = torch.nn.Parameter(
                    fake(p), requires_grad=p.requires_grad)
        for n, b in list(mod._buffers.items()):
            if b is not None:
                mod._buffers[n] = fake(b)
    return module


@contextlib.contextmanager
def fake_world(world: int):
    """A process group of ``world`` ranks in which this process is rank 0
    (``torch.distributed``'s ``"fake"`` backend: every collective returns
    at once, nothing is sent), torn down on exit with the mesh registry
    as it was. In a process that already has a group of that size, the
    job's own group (yields False)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != int(world):
            raise ValueError(f"this job has {dist.get_world_size()} ranks; "
                             f"the declared mesh needs {world}")
        yield False
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from bigdl_tpu_torch.parallel import mesh as _mesh
    saved = (_mesh._LIVE, _mesh._CURRENT)
    dist.init_process_group("fake", store=FakeStore(), world_size=int(world),
                            rank=0)
    try:
        yield True
    finally:
        dist.destroy_process_group()
        _mesh._LIVE, _mesh._CURRENT = saved


# ------------------------------------------------------------ node reads
def node_val(x):
    """The fake tensor a node stands for (or ``x`` itself if it is one)."""
    if isinstance(x, torch.fx.Node):
        return x.meta.get("val")
    return x


def aval_bytes(x) -> int:
    """Byte size of one value: a node's ``meta["val"]`` or a tensor (0
    for anything without a static shape and dtype)."""
    v = node_val(x)
    if not isinstance(v, torch.Tensor):
        return 0
    try:
        return int(v.numel()) * v.element_size()
    except (TypeError, RuntimeError):  # an unbacked symbolic size
        return 0


def consumers_map(gm) -> Dict[object, List[object]]:
    """node -> the nodes that take it as an input."""
    return {n: list(n.users) for n in gm.graph.nodes}


def _op_name(target) -> str:
    name = getattr(target, "name", None)
    if callable(name):
        full = name()  # OpOverload: "aten::_to_copy"
        return full.replace("::", ".")
    return getattr(target, "__name__", str(target))


def eqn_label(node) -> str:
    """Short label of one node: its op, after the innermost module it ran
    in when the trace recorded one."""
    label = _op_name(node.target)
    stack = node.meta.get("nn_module_stack")
    if stack:
        path = list(stack.values())[-1][0]
        if path:
            label = f"{path}/{label}"
    return label


def call_nodes(gm) -> List[Tuple[int, object]]:
    """(position, node) of every op call in the graph, in order."""
    return [(i, n) for i, n in enumerate(gm.graph.nodes)
            if n.op == "call_function"]


def where(i: int, node) -> str:
    return f"{eqn_label(node)}#{i}"


def kernel_sites(gm) -> list:
    """The hand-kernel launches the traced step would make
    (:class:`~bigdl_tpu_torch.ops.lint_sites.KernelSite`), in order."""
    return list(gm.meta.get("kernel_sites", ()))


# ------------------------------------------------------------- sharding
def spec_axes(spec) -> List[str]:
    """Mesh axis names one spec (a tuple over the leaf's dims, entries an
    axis, a tuple of axes or None) references, in dim order."""
    out: List[str] = []
    for entry in tuple(spec or ()):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if ax is not None:
                out.append(str(ax))
    return out


def flatten_tree(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(``['a']['b']`` path, leaf) of a tree of dicts, lists and tuples in
    order; an object with ``q`` and ``s`` planes (a quantized pool) is
    two leaves."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += flatten_tree(v, f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_tree(v, f"{prefix}[{i}]")
        return out
    if not isinstance(tree, torch.Tensor) and hasattr(tree, "q") \
            and hasattr(tree, "s"):
        return (flatten_tree(tree.q, f"{prefix}.q")
                + flatten_tree(tree.s, f"{prefix}.s"))
    return [(prefix, tree)]


def mesh_groups(mesh) -> Dict[str, Tuple[str, ...]]:
    """process-group name -> the mesh axes its collectives reduce over,
    for this rank's lines of every axis of ``mesh`` (a
    ``parallel.mesh.Mesh``) of more than one rank; the job's default
    group covers the axes whose lines span the whole job."""
    import torch.distributed as dist

    out: Dict[str, Tuple[str, ...]] = {}
    if not dist.is_initialized():
        return out
    default = dist.distributed_c10d._get_default_group().group_name
    whole = mesh.group.group_name if mesh.group is not None else default
    for axis, size in mesh.shape.items():
        if size <= 1:
            continue
        group = mesh.axis_view(axis).group
        name = group.group_name if group is not None else whole
        out[name] = out.get(name, ()) + (axis,)
    wide = tuple(a for a, s in mesh.shape.items() if s > 1)
    if wide:  # one wide axis: the whole mesh is that axis's line
        out.setdefault(whole, wide)
    return out


@dataclass
class Collective:
    """One collective of a traced step: its node and position, its op
    (``allreduce_``, ``broadcast_``, ...), the mesh axes of its process
    group (empty where the group is not one of the mesh's), the group's
    size, and the dtype and bytes of what it moves."""
    node: object
    index: int
    op: str
    axes: Tuple[str, ...]
    group_size: int
    dtype: Optional[torch.dtype]
    nbytes: int

    def where(self) -> str:
        return where(self.index, self.node)

    @property
    def reduces(self) -> bool:
        return "reduce" in self.op


def _group_of(gm, node):
    """(group name, size) of a collective node, or (None, 0)."""
    import torch.distributed as dist

    for a in list(node.args) + list(node.kwargs.values()):
        if isinstance(a, torch.fx.Node) and a.op == "get_attr":
            obj = getattr(gm, a.target, None)
            try:
                pg = dist.ProcessGroup.unbox(obj)
            except Exception:
                continue
            return pg.group_name, pg.size()
        if isinstance(a, str) and node.target.namespace == \
                "_c10d_functional":
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            try:
                pg = _resolve_process_group(a)
            except Exception:
                return a, 0
            return pg.group_name, pg.size()
    return None, 0


def _moved(node) -> Tuple[Optional[torch.dtype], int]:
    """dtype and bytes of the tensors a collective node takes."""
    for a in node.args:
        vals = a if isinstance(a, (list, tuple)) else [a]
        ts = [node_val(v) for v in vals if isinstance(v, torch.fx.Node)]
        ts = [t for t in ts if isinstance(t, torch.Tensor)]
        if ts:
            return ts[0].dtype, sum(aval_bytes(t) for t in ts)
    return None, 0


def collect_collectives(gm, groups: Optional[Dict[str, tuple]] = None
                        ) -> List[Collective]:
    """Every collective of the traced step, its process group named by
    mesh axes through ``groups`` (:func:`mesh_groups`)."""
    groups = groups or {}
    out = []
    for i, n in call_nodes(gm):
        ns = getattr(n.target, "namespace", None)
        if ns not in COLLECTIVE_NAMESPACES:
            continue
        op = _op_name(n.target).split(".")[1]
        if op.rstrip("_") in _NOT_COLLECTIVES:
            continue
        name, size = _group_of(gm, n)
        dtype, nbytes = _moved(n)
        out.append(Collective(n, i, op, tuple(groups.get(name, ())), size,
                              dtype, nbytes))
    return out


@dataclass
class ShardedLevel:
    """The traced step (one flat level) with its collectives."""
    gm: object
    path: str = ""
    depth: int = 0
    collectives: List[Collective] = field(default_factory=list)


def sharded_levels(gm, groups: Optional[Dict[str, tuple]] = None
                   ) -> List[ShardedLevel]:
    """The shardlint view of a traced step: its one level and the
    collectives on it (the counterpart of the JAX walk's levels with
    their sharding environments)."""
    return [ShardedLevel(gm, collectives=collect_collectives(gm, groups))]


def observed_mesh_axes(levels: List[ShardedLevel]) -> Dict[str, int]:
    """axis -> size of every mesh axis a collective of the walk runs over
    alone (a group of several axes is not split into sizes)."""
    axes: Dict[str, int] = {}
    for lv in levels:
        for c in lv.collectives:
            if len(c.axes) == 1 and c.group_size:
                axes[c.axes[0]] = int(c.group_size)
    return axes
