"""Synchronous data-parallel training over ``torch.distributed`` (counterpart
of ``bigdl_tpu/parallel/data_parallel.py``; reference
optim/DistriOptimizer.scala and parameters/AllReduceParameter.scala).

One process a GPU. Every rank holds the whole model; a step:

* :meth:`DataParallel.shard_batch` takes this rank's contiguous part of
  the global batch (``P("data")``); a dataset that already yields this
  rank's part (:class:`~bigdl_tpu_torch.dataset.ShardedDataSet`, an
  executor feed whose epoch plan spans the ranks) is not sliced again;
* the forward and backward run on that part; batch norm normalises by
  the global batch's statistics (:meth:`DataParallel.sync_batch_norm`);
  dropout draws the single process's masks (:meth:`compile_step` offsets
  the noise by the rank's place in the batch);
* :meth:`DataParallel.reduce_grads` averages the gradients over the
  ranks in dense buckets (:mod:`~bigdl_tpu_torch.parallel.grad_comm`,
  optionally on a 16-bit wire), and the loss with them;
* :meth:`DataParallel.update` runs the ``OptimMethod``. With ``zero1``
  (the default, as in the JAX package) each rank keeps optimizer state
  only for the parameters it owns, updates only those, and broadcasts
  them to the other ranks.

Stated differences from the JAX package:

* ZeRO-1 partitions whole parameters, balanced by bytes, where
  ``_zero1_spec`` slices each state leaf along its largest divisible
  axis: a per-tensor norm (LARS, LAMB) then needs no collective, and each
  update is the single process's, bit for bit.
* ``donate`` is kept and means nothing: PyTorch updates in place.
* One process a GPU, where the JAX package runs one process a host and
  a mesh over its chips.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.parallel.grad_comm import apply_grad_comm, jax_order
from bigdl_tpu_torch.parallel.mesh import Mesh, local_mesh

__all__ = ["DataParallel", "feeds_rank_part"]


def _dist():
    import torch.distributed as dist
    return dist


def feeds_rank_part(dataset) -> bool:
    """Whether ``dataset`` yields this rank's part of each global batch
    (decided by its kind, never by a batch's size): a ShardedDataSet or
    an epoch plan over more than one process, itself or under the
    wrappers (staging, prefetch, Mixup) that hold it as ``inner``."""
    from bigdl_tpu_torch.dataset.distributed import ShardedDataSet

    seen = set()
    while dataset is not None and id(dataset) not in seen:
        seen.add(id(dataset))
        if isinstance(dataset, ShardedDataSet):
            return dataset.pc > 1
        plan = getattr(dataset, "plan", None)
        if plan is not None and getattr(plan, "pc", 1) > 1:
            return True
        dataset = getattr(dataset, "inner", None)
    return False


def balanced_owners(sizes: dict, world: int) -> dict:
    """{name: rank}: whole leaves to ranks, largest first (ties in the JAX
    flatten order), each to the rank holding the fewest bytes so far
    (ties to the lowest rank). ``sizes`` is {name: bytes}."""
    load = [0] * world
    owner = {}
    index = {n: i for i, n in enumerate(jax_order(sizes))}  # tie order
    for name in sorted(index, key=lambda n: (-sizes[n], index[n])):
        r = min(range(world), key=lambda i: (load[i], i))
        owner[name] = r
        load[r] += sizes[name]
    return owner


def _keyed(tree: dict, names: set) -> bool:
    """Whether a state dict is keyed by parameter names (a per-parameter
    subtree such as ``velocity``)."""
    return bool(tree) and all(k in names for k in tree)


def _slice0(t, lo: int, hi: int):
    if isinstance(t, (tuple, list)):
        return type(t)(_slice0(u, lo, hi) for u in t)
    return t[lo:hi]


class DataParallel:
    """The strategy object :class:`~bigdl_tpu_torch.optim.Optimizer`,
    :class:`~bigdl_tpu_torch.optim.Validator` and ``cli.perf`` consume.
    ``mesh`` (default :func:`~bigdl_tpu_torch.parallel.mesh.local_mesh`)
    names the ranks; ``grad_comm`` is a
    :class:`~bigdl_tpu_torch.parallel.grad_comm.GradCommConfig` (the
    parsed ``--gradCompress``/``--gradBuckets``) or None."""

    def __init__(self, mesh: Optional[Mesh] = None, axis: str = "data",
                 zero1: bool = True, donate: bool = True, grad_comm=None):
        if mesh is None:
            mesh = local_mesh(axis)
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
        self.mesh = mesh
        self.axis = axis
        self.zero1 = zero1
        self.donate = donate
        self.grad_comm = grad_comm
        self._grad_comm_info = None
        self._residuals: dict = {}
        self._owner: Optional[dict] = None
        self._names: set = set()
        # leaves every rank updates on its own, never broadcast (a tensor
        # parallel rank's slices)
        self._local: set = set()
        self._template = None
        self._model = None

    # ------------------------------------------------------------ identity
    @property
    def data_mesh(self) -> Mesh:
        """The one-axis mesh of this rank's line along the data axis (the
        mesh itself when it has one axis): the group the gradients, the
        loss, ZeRO-1 and the evaluation counts are reduced over."""
        return self.mesh.axis_view(self.axis)

    @property
    def world(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def rank(self) -> int:
        return self.data_mesh.rank

    @property
    def group(self):
        return self.data_mesh.group

    @property
    def writer(self) -> bool:
        """Whether this rank writes a checkpoint that one rank writes: the
        first rank of the mesh."""
        return self.mesh.rank == 0

    def _collective(self) -> bool:
        return _dist().is_initialized()

    def layout_signature(self) -> dict:
        """The dp layout this strategy writes checkpoints under (the
        manifest's ``layout``; the blobs hold whole tensors either way)."""
        return {"strategy": type(self).__name__, "axis": self.axis,
                "zero1": bool(self.zero1), "n_devices": int(self.mesh.size),
                "mesh": {str(k): int(v) for k, v in self.mesh.shape.items()}}

    def lint_spec_metadata(self, params=None) -> dict:
        """What the lint needs to rebuild this strategy over fake tensors:
        the declared mesh axes, the strategy's short name, the spec tree
        it places ``params`` by (dp: replicated), the batch axes and the
        grad-comm config of the reduce."""
        from bigdl_tpu_torch.parallel.tensor_parallel import replicated_specs
        return {"strategy": "dp",
                "mesh_axes": {str(name): int(self.mesh.shape[name])
                              for name in self.mesh.axis_names},
                "batch_axes": (self.axis,),
                "param_specs": (replicated_specs(params)
                                if params is not None else None),
                "grad_comm": self.grad_comm}

    def owner(self, name: str) -> int:
        """The rank that updates parameter ``name`` (every rank without
        ZeRO-1 updates every parameter; this is then the rank itself)."""
        if not self.zero1 or self._owner is None:
            return self.rank
        return self._owner[name]

    # ----------------------------------------------------------- placement
    @torch.no_grad()
    def _broadcast_tensors(self, tensors: list, src: int) -> None:
        """Broadcast ``tensors`` from rank ``src``, one flat buffer a
        dtype, copied back in place on the other ranks."""
        dist = _dist()
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            # src is a rank of the mesh; torch.distributed names the job's
            dist.broadcast(flat, src=self.data_mesh.global_rank(src),
                           group=self.group)
            if self.rank != src:
                for t, piece in zip(ts, torch.split(
                        flat, [t.numel() for t in ts])):
                    t.copy_(piece.view(t.shape))

    def place(self, params: dict, mod_state: Optional[dict] = None,
              opt_state: Optional[dict] = None):
        """Make the training state this rank's: ``params`` and
        ``mod_state`` ({name: tensor}) take rank 0's values (in place), and
        ``opt_state``, a whole ``OptimMethod.init(params)`` state, comes
        back with only the parameters this rank owns under ZeRO-1. Returns
        ``(params, mod_state, opt_state)``."""
        if self._collective():
            self._broadcast_tensors(
                [p.data for _, p in sorted(params.items())]
                + [b for _, b in sorted((mod_state or {}).items())], 0)
        self._names = set(params)
        self._owner = balanced_owners(
            {n: p.numel() * p.element_size() for n, p in params.items()},
            self.world)
        if opt_state is None:
            return params, mod_state, None
        self._template = _meta_tree(opt_state)
        return params, mod_state, self.shard_opt_state(opt_state)

    def shard_opt_state(self, opt_state: dict) -> dict:
        """This rank's part of a whole optimizer state (a view: the same
        tensors)."""
        names = self._names

        def keep(tree):
            if _keyed(tree, names):
                return {k: v for k, v in tree.items()
                        if self.owner(k) == self.rank}
            return {k: keep(v) if isinstance(v, dict) else v
                    for k, v in tree.items()}

        return keep(opt_state)

    def sync_batch_norm(self, model: torch.nn.Module) -> int:
        """Give every BatchNormalization of ``model`` without an axis this
        strategy's, so training normalises by the global batch's
        statistics, as the JAX BN does under a mesh; nothing changes at
        world size 1. Returns how many modules it set."""
        if self.world <= 1:
            return 0
        from bigdl_tpu_torch.nn.norm import set_bn_axis
        return set_bn_axis(model, self.axis)

    # --------------------------------------------------------------- batch
    def shard_batch(self, x, y, rank_local: bool = False):
        """This rank's contiguous part of the global batch ``(x, y)``
        (``y`` may be a tuple of arrays, as Mixup's); ``rank_local``
        batches (see :func:`feeds_rank_part`) come back as they are. A
        global batch that the ranks do not divide raises."""
        if rank_local or self.world <= 1:
            return x, y
        n = len(x)
        if n % self.world:
            raise ValueError(f"global batch {n} is not divisible by the "
                             f"{self.world} ranks of the {self.axis!r} axis")
        per = n // self.world
        lo = self.rank * per
        return _slice0(x, lo, lo + per), _slice0(y, lo, lo + per)

    # ---------------------------------------------------------------- step
    def compile_step(self, train_step):
        """``train_step`` run with dropout noise offset by this rank's
        place in the global batch."""
        from bigdl_tpu_torch.core.module import noise_shard

        def step(*args, **kw):
            with noise_shard(self.rank):
                return train_step(*args, **kw)

        return step

    def reduce_grads(self, grads: dict, loss):
        """The mean over the ranks of ``grads`` ({name: tensor}), bucketed
        and compressed per ``grad_comm``, and of ``loss``; returns
        ``(grads, loss)``."""
        if not self._collective() or self.world <= 1:
            return grads, loss
        dist = _dist()
        out, info = apply_grad_comm(grads, self.grad_comm, self.data_mesh,
                                    self._residuals)
        if info is not None:
            self._grad_comm_info = info
        loss = loss.detach().float().clone()
        dist.all_reduce(loss, group=self.group)
        return out, loss / self.world

    def grad_sq_norm(self, grads: dict):
        """The squared global L2 norm of the reduced ``grads`` (f32): every
        rank holds every gradient whole."""
        return sum(torch.sum(torch.square(g.float())) for g in grads.values())

    def grad_comm_info(self):
        """The bucket and wire accounting of the last compressed
        ``reduce_grads`` (None when compression never ran)."""
        return self._grad_comm_info

    @torch.no_grad()
    def update(self, method, grads: dict, opt_state: dict, params: dict):
        """``method.update`` over the parameters this rank owns (all of
        them without ZeRO-1), then each owner's parameters broadcast to
        the other ranks."""
        kw = self._update_kw(method)
        if not self.zero1 or self.world <= 1:
            method.update(grads, opt_state, params, **kw)
            return opt_state
        mine = [n for n in params if self.owner(n) == self.rank]
        method.update({n: grads[n] for n in mine}, opt_state,
                      {n: params[n] for n in mine}, **kw)
        order = [n for n in jax_order(params) if n not in self._local]
        for r in range(self.world):
            self._broadcast_tensors([params[n].data for n in order
                                     if self.owner(n) == r], r)
        return opt_state

    def _update_kw(self, method) -> dict:
        """The keywords ``method.update`` takes from this strategy (none:
        every rank holds every parameter whole)."""
        return {}

    # --------------------------------------------------------------- gather
    @torch.no_grad()
    def gather(self, params: dict, mod_state: dict, opt_state: dict):
        """Whole trees for a checkpoint: ``(params, mod_state, the whole
        optimizer state)``, the last from every rank's ZeRO-1 part (a
        collective: every rank calls it and gets the whole state)."""
        if not self.zero1 or self.world <= 1 or self._template is None:
            return params, mod_state, opt_state
        names = self._names
        full_bufs: dict = {}
        device = _first_device(opt_state)

        def build(tmpl, mine, path=()):
            out = {}
            keyed = _keyed(tmpl, names)
            for k, v in tmpl.items():
                if isinstance(v, dict):
                    out[k] = build(v, mine.get(k, {}), path + (k,))
                elif keyed and self.owner(k) != self.rank:
                    t = torch.empty(v.shape, dtype=v.dtype, device=device)
                    full_bufs.setdefault(self.owner(k), []).append(
                        (path + (k,), t))
                    out[k] = t
                else:
                    out[k] = mine[k]
                    if keyed and k not in self._local:
                        full_bufs.setdefault(self.rank, []).append(
                            (path + (k,), mine[k]))
            return out

        full = build(self._template, opt_state)
        for r in range(self.world):
            leaves = [t for _, t in sorted(full_bufs.get(r, []),
                                           key=lambda e: e[0])]
            if leaves:
                self._broadcast_tensors(leaves, r)
        return params, mod_state, full

    # ----------------------------------------------------------- evaluation
    def sum_over_ranks(self, values, device) -> list:
        """Each of ``values`` (floats) summed over the ranks, as floats."""
        if not self._collective() or self.world <= 1:
            return [float(v) for v in values]
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=device)
        _dist().all_reduce(t, group=self.group)
        return t.tolist()

    def barrier(self) -> None:
        """Every rank of the mesh (its data and model axes)."""
        if self._collective():
            _dist().barrier(group=self.mesh.group)

    def bind(self, model: torch.nn.Module) -> "DataParallel":
        """The model whose parameters ``place`` receives (the Optimizer
        binds its own; the fully sharded strategy hooks it)."""
        self._model = model
        return self

    def unplace(self, model: torch.nn.Module) -> None:
        """Make ``model`` whole again after training (nothing to do: every
        rank holds every parameter)."""


def _meta_tree(tree: dict) -> dict:
    """The structure of a state tree, its tensors on the meta device."""
    return {k: _meta_tree(v) if isinstance(v, dict) else
            torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def _first_device(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            d = _first_device(v)
            if d is not None:
                return d
        else:
            return v.device
    return None


class FullyShardedDataParallel(DataParallel):
    """ZeRO-3 over the data axis (the JAX ``FullyShardedDataParallel``):
    parameters, their gradients' use and the optimizer state live on
    their owner rank only, and two module hooks unshard a leaf module's
    parameters around each use.

    * ``place`` gives every parameter an owner (:func:`balanced_owners`,
      whole leaves) and frees the storage of the parameters this rank does
      not own (``untyped_storage().resize_(0)``: the tensor keeps its
      shape, autograd its saved references).
    * A forward pre-hook on each module that holds parameters gathers them
      (a broadcast from each owner into the re-grown storage), a forward
      hook frees them again; a hook on the module's output gathers them
      once more when its gradient arrives, before the module's backward
      runs, and a hook on each parameter's gradient frees them once the
      module's last gradient is made. So at most the modules in flight are
      whole: one at a time in a chain. A parameter the model's forward
      reads outside its module (``model.fsdp_outer_params()``: the tied LM
      head) is gathered for the model's whole call.
    * After the backward the gradients are averaged over the ranks
      (``reduce_grads``, the buckets of ``parallel.grad_comm``) and each
      owner updates its own parameters; nothing is broadcast after the
      update (the next forward gathers).

    Stated differences from the JAX package: whole leaves are owned (JAX
    slices each leaf along its largest divisible dim, ``_zero1_spec``), so
    a gather is a broadcast from the owner, which gloo has on CUDA
    tensors, and a per-tensor norm (LARS, LAMB) needs no collective; the
    gradients are whole on every rank until the step's reduce (the
    backward returns them together), reduced by all-reduce (gloo's CUDA
    path has no reduce-scatter) and kept by their owner.
    """

    def __init__(self, mesh: Optional[Mesh] = None, axis: str = "data",
                 donate: bool = True, grad_comm=None):
        super().__init__(mesh, axis, zero1=True, donate=donate,
                         grad_comm=grad_comm)
        self._handles: list = []
        self._params: dict = {}  # name -> Parameter
        self._whole = {}  # id(param) -> modules holding it whole now
        # accounting the tests and chip_smoke read
        self.gathers = 0
        self.max_whole_modules = 0
        self._whole_modules: set = set()

    # ------------------------------------------------------------ storage
    def _resident(self, p: torch.Tensor) -> bool:
        return p.untyped_storage().size() > 0

    @torch.no_grad()
    def _gather_module(self, mod) -> None:
        """Gather ``mod``'s own parameters (a broadcast from each owner;
        every rank runs the same modules in the same order)."""
        key = id(mod)
        if key in self._whole_modules:
            return
        self._whole_modules.add(key)
        self.max_whole_modules = max(self.max_whole_modules,
                                     len(self._whole_modules))
        for name, p in self._module_params[key]:
            users = self._whole.setdefault(id(p), set())
            users.add(key)
            if len(users) > 1:
                continue
            src = self._owner[name]
            if src != self.rank:
                p.untyped_storage().resize_(p.numel() * p.element_size())
            _dist().broadcast(p.data, src=self.data_mesh.global_rank(src),
                              group=self.group)
            self.gathers += 1

    @torch.no_grad()
    def _free_module(self, mod) -> None:
        key = id(mod)
        if key not in self._whole_modules:
            return
        self._whole_modules.discard(key)
        for name, p in self._module_params[key]:
            users = self._whole.get(id(p), set())
            users.discard(key)
            if not users and self._owner[name] != self.rank:
                p.untyped_storage().resize_(0)

    def _install_hooks(self, model: torch.nn.Module, params: dict) -> None:
        by_id = {id(p): n for n, p in params.items()}
        # parameters the model's own forward reads outside their module
        # (a tied LM head) are whole for the model's whole call
        outer = [model.get_parameter(n) for n in
                 getattr(model, "fsdp_outer_params", lambda: [])()]
        self._module_params = {}
        for mod in model.modules():
            own = [(by_id[id(p)], p) for p in list(
                mod.parameters(recurse=False)) + (outer if mod is model
                                                  else [])
                   if id(p) in by_id]
            if not own:
                continue
            self._module_params[id(mod)] = own
            pending = {"left": 0}

            def pre(m, args, _self=self):
                _self._gather_module(m)

            def post(m, args, out, _self=self, pending=pending,
                     n_own=len(own)):
                _self._free_module(m)
                if torch.is_grad_enabled():
                    pending["left"] = n_own
                    for t in _tensors(out):
                        if t.requires_grad:
                            t.register_hook(
                                lambda g, m=m: (_self._gather_module(m), g)[1])

            def grad_made(g, m=mod, pending=pending, _self=self):
                pending["left"] -= 1
                if pending["left"] <= 0:
                    _self._free_module(m)
                return g

            self._handles.append(mod.register_forward_pre_hook(pre))
            self._handles.append(mod.register_forward_hook(post))
            for _, p in own:
                if p.requires_grad:
                    self._handles.append(p.register_hook(grad_made))

    # ----------------------------------------------------------- placement
    def place(self, params: dict, mod_state: Optional[dict] = None,
              opt_state: Optional[dict] = None):
        """As :meth:`DataParallel.place`, then each parameter this rank
        does not own is freed and the unshard hooks are installed on the
        model that holds ``params`` (``shard_model`` names it)."""
        params, mod_state, opt_state = super().place(params, mod_state,
                                                     opt_state)
        self._params = dict(params)
        if self._model is not None and self._collective() \
                and self.world > 1:  # one rank owns everything
            self.shard_model(self._model)
        return params, mod_state, opt_state

    @torch.no_grad()
    def shard_model(self, model: torch.nn.Module) -> None:
        self.unplace(model, gather=False)
        self._model = model
        self._install_hooks(model, self._params)
        for name, p in self._params.items():
            if self._owner[name] != self.rank and self._resident(p):
                p.untyped_storage().resize_(0)

    def resident_bytes(self) -> int:
        """Bytes of parameter storage this rank holds now."""
        return sum(p.untyped_storage().size() for p in self._params.values())

    # ---------------------------------------------------------------- step
    def reduce_grads(self, grads: dict, loss):
        """Every module whole at the end of the backward (a parameter that
        got no gradient) is freed, then :meth:`DataParallel.reduce_grads`."""
        for mod in list(self._model.modules()) if self._model else []:
            self._free_module(mod)
        self._whole_modules.clear()
        return super().reduce_grads(grads, loss)

    @torch.no_grad()
    def update(self, method, grads: dict, opt_state: dict, params: dict):
        """``method.update`` over the parameters this rank owns; the next
        forward's gathers hand them to the other ranks."""
        mine = [n for n in params if self.owner(n) == self.rank]
        method.update({n: grads[n] for n in mine}, opt_state,
                      {n: params[n] for n in mine})
        return opt_state

    # --------------------------------------------------------------- gather
    @torch.no_grad()
    def _whole_params(self, params: dict) -> dict:
        out = {}
        for n in jax_order(params):
            p = params[n]
            t = (p.data.clone(memory_format=torch.contiguous_format)
                 if self._owner[n] == self.rank
                 else torch.empty(p.shape, dtype=p.dtype, device=p.device))
            _dist().broadcast(t, src=self.data_mesh.global_rank(
                self._owner[n]), group=self.group)
            out[n] = t
        return out

    def gather(self, params: dict, mod_state: dict, opt_state: dict):
        """Whole trees on every rank (a collective): the parameters from
        their owners, the optimizer state as under ZeRO-1."""
        if params is not None and self._collective() and self.world > 1:
            params = self._whole_params(params)
        return super().gather(params, mod_state, opt_state)

    @torch.no_grad()
    def unplace(self, model: torch.nn.Module, gather: bool = True) -> None:
        """Remove the hooks and, with ``gather``, make every parameter
        whole on every rank again (a collective)."""
        for h in self._handles:
            h.remove()
        self._handles = []
        self._whole_modules.clear()
        self._whole.clear()
        if gather and self._params and self._collective() and \
                self.world > 1:
            for n, t in self._whole_params(self._params).items():
                p = self._params[n]
                if not self._resident(p):
                    p.untyped_storage().resize_(t.numel() * t.element_size())
                p.data.copy_(t)


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []
