"""Tensor (model) parallelism over a ``model`` mesh axis (counterpart of
``bigdl_tpu/parallel/tensor_parallel.py``).

:func:`megatron_specs` builds the same spec tree as the JAX function for
the same model, keyed by the JAX param paths: a spec is a tuple of axis
names (or None) over the leaf's dims in the JAX layout, ``()`` when the
leaf is replicated, so ``P(*spec)`` is the JAX ``PartitionSpec``. The
pairing is structural, over the same cases: within an ordered container a
Linear is column-split only when a second Linear follows it (through
pointwise layers) to take the row split; branches of parallel containers
pair on their own; attention splits its heads (wq/wk/wv and their biases
by column, wo by row); a transformer block splits its MLP pair; a conv
splits its output channels, a ``LookupTable`` its features; a dim that
the axis does not divide stays whole.

The JAX package lets GSPMD propagate those specs through the einsums. No
partitioner runs here, so :class:`TensorParallel` keeps each rank's slice
of every split leaf and writes Megatron's forward out, module by module
(each split module's ``_tp`` state, read by its forward):

* ``copy_to_model`` (identity forward, all-reduce backward) before a
  column-split product, ``reduce_from_model`` (all-reduce forward,
  identity backward) after a row-split one; a row-split bias is added
  once, after the reduce;
* a feature-split activation that a whole-feature layer needs (the
  embedding's output before the first LayerNorm, a split conv's output
  before its BN) is gathered as an all-reduce of the zero-padded slice,
  the slice taken in the backward;
* the tied LM head contracts over the split d: its input's slice
  (``scatter_to_model``: the slice forward, an all-reduce of the
  zero-padded gradient backward), then ``reduce_from_model`` of the
  partial logits;
* dropout inside a column-split region hashes the element's index in the
  whole activation (its column offset by the rank's slice), so the masks
  are the single process's.

Gradients are reduced over the data axis only (``DataParallel.
reduce_grads``): a replicated leaf's gradient is already whole on every
model rank. Replicated leaves take ZeRO-1 over the data axis (the JAX
``opt_sharding_like_params``); split leaves keep their state local.
LARS and LAMB take a split leaf's whole norm (its slice's square sum
all-reduced over the model axis), as the JAX package's global arrays give
it.

Stated differences from the JAX package:

* GQA when the axis does not divide the KV heads: the JAX ``mha_spec``
  checks only ``num_heads``, and GSPMD repairs a wk/wv split through the
  middle of a KV head. Hand-written attention cannot, so at such a K the
  port keeps wk, wv (and their biases, and the KV cache) whole on every
  rank and gives each rank the KV heads its query heads need (their
  gradient summed over the model axis in the backward).
* Collectives: NCCL has all-reduce on the card; gloo reduces CUDA tensors
  through the host, 16-bit ones in f32. Megatron needs nothing else.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from bigdl_tpu_torch.parallel.data_parallel import (DataParallel,
                                                    balanced_owners)
from bigdl_tpu_torch.parallel.mesh import Mesh

__all__ = ["TensorParallel", "megatron_specs", "replicated_specs",
           "param_tree", "TPState", "apply_specs", "unshard_module"]


def _dist():
    import torch.distributed as dist
    return dist


# ---------------------------------------------------------------- specs
def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def replicated_specs(params):
    """The all-replicated spec tree of ``params`` (the degenerate rule)."""
    if isinstance(params, dict):
        return {k: replicated_specs(v) for k, v in params.items()}
    return ()


def param_tree(module: torch.nn.Module) -> dict:
    """``module``'s parameters as the JAX param tree: nested dicts keyed by
    the JAX paths, leaves the tensors (a quantized weight, a module of its
    own, is one leaf under the parameter's name)."""
    from bigdl_tpu_torch.serving.quant import is_quantized

    out = {k: p for k, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if is_quantized(child):
            out[name] = child
            continue
        sub = param_tree(child)
        if sub:
            out[name] = sub
    return out


def _div(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0 and dim >= n


def _pointwise(mod) -> bool:
    """Layers transparent to a feature-dim split: the elementwise
    activations and Dropout (SoftMax, SoftMin and LogSoftMax reduce over
    the features, so they are not)."""
    from bigdl_tpu_torch import nn
    if isinstance(mod, (nn.SoftMax, nn.SoftMin, nn.LogSoftMax)):
        return False
    return (type(mod).__module__ == "bigdl_tpu_torch.nn.activation"
            or isinstance(mod, nn.Dropout))


def _kv_split(mod, n_shard: int) -> bool:
    """Whether the KV projections of attention ``mod`` split with its
    heads: the axis divides the KV heads (else they stay whole, the stated
    GQA difference)."""
    return _div(mod.num_kv_heads, n_shard)


def megatron_specs(module, params=None, axis: str = "model",
                   n_shard: int = 2):
    """The spec tree of ``module``'s ``params`` (default
    :func:`param_tree` of the module) over ``axis`` of size ``n_shard``,
    keyed by the JAX paths; see the module docstring."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import Sequential

    if params is None:
        params = param_tree(module)

    def linear_col_spec(p):
        spec = {"weight": (None, axis)}
        if "bias" in p:
            spec["bias"] = (axis,)
        return spec

    def linear_row_spec(p):
        spec = {"weight": (axis, None)}
        if "bias" in p:
            spec["bias"] = ()
        return spec

    def mha_spec(mod, p):
        if not _div(mod.num_heads, n_shard):
            return replicated_specs(p)
        kv = (None, axis) if _kv_split(mod, n_shard) else ()
        kvb = (axis,) if kv else ()
        return {"wq": (None, axis), "wk": kv, "wv": kv,
                "bq": (axis,), "bk": kvb, "bv": kvb,
                "wo": (axis, None), "bo": ()}

    def block_spec(mod, p):
        f = mod.d_ff
        split = _div(f, n_shard)
        return {"ln1": replicated_specs(p["ln1"]),
                "ln2": replicated_specs(p["ln2"]),
                "mha": mha_spec(mod.mha, p["mha"]),
                "w1": (None, axis) if split else (),
                "b1": (axis,) if split else (),
                "w2": (axis, None) if split else (),
                "b2": ()}

    def conv_spec(mod, p):
        # the JAX HWIO kernel's output channels (its last dim; the port's
        # OIHW dim 0)
        if _div(mod.n_output_plane, n_shard):
            spec = {"weight": (None, None, None, axis)}
            if "bias" in p:
                spec["bias"] = (axis,)
            return spec
        return replicated_specs(p)

    def lookup_spec(mod, p):
        if _div(_shape(p["weight"])[-1], n_shard):
            return {"weight": (None, axis)}
        return replicated_specs(p)

    def seq_spec(children, p):
        out = {}
        n_c = len(children)
        i = 0
        while i < n_c:
            k, c = children[i]
            if isinstance(c, nn.Linear) and k in p:
                j = i + 1
                while j < n_c and _pointwise(children[j][1]):
                    j += 1
                kj = children[j][0] if j < n_c else None
                if (j < n_c and isinstance(children[j][1], nn.Linear)
                        and kj in p
                        and _div(_shape(p[k]["weight"])[1], n_shard)
                        and _div(_shape(p[kj]["weight"])[0], n_shard)):
                    out[k] = linear_col_spec(p[k])
                    out[kj] = linear_row_spec(p[kj])
                    for m in range(i + 1, j):
                        km = children[m][0]
                        if km in p:
                            out[km] = replicated_specs(p[km])
                    i = j + 1
                    continue
                out[k] = replicated_specs(p[k])
                i += 1
                continue
            if k in p:
                out[k] = rec(c, p[k])
            i += 1
        for k in p:
            if k not in out:
                out[k] = replicated_specs(p[k])
        return out

    def rec(mod, p):
        if isinstance(mod, nn.TransformerEncoderLayer):
            return block_spec(mod, p)
        if isinstance(mod, nn.MultiHeadAttention):
            return mha_spec(mod, p)
        if isinstance(mod, nn.Linear):
            return replicated_specs(p)
        if isinstance(mod, nn.LookupTable):
            return lookup_spec(mod, p)
        if isinstance(mod, nn.SpatialConvolution):
            return conv_spec(mod, p)
        named = getattr(mod, "tp_param_children", None)
        if named is not None and isinstance(p, dict):
            mapping = named()
            out = {k: rec(c, p[k]) for k, c in mapping.items() if k in p}
            for k in p:
                if k not in out:
                    out[k] = replicated_specs(p[k])
            return out
        children = list(mod.named_children())
        if children and isinstance(p, dict):
            if isinstance(mod, Sequential):
                return seq_spec(children, p)
            out = {k: rec(c, p[k]) for k, c in children if k in p}
            for k in p:
                if k not in out:
                    out[k] = replicated_specs(p[k])
            return out
        return replicated_specs(p)

    return rec(module, params)


# ------------------------------------------------------------- collectives
def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``. Gloo sums 16-bit tensors in
    f32 (a backend capability: its CUDA path has no bf16 reduction)."""
    dist = _dist()
    if t.dtype in (torch.bfloat16, torch.float16) and \
            dist.get_backend(group) == "gloo":
        f = t.float()
        dist.all_reduce(f, group=group)
        t.copy_(f)
    else:
        dist.all_reduce(t, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, state):
        ctx.state = state
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.state.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, state):
        return _all_reduce(x.contiguous().clone(), state.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The whole feature dim of a split activation: an all-reduce of the
    zero-padded slice; the backward takes the slice."""

    @staticmethod
    def forward(ctx, x, state, dim, lo, full):
        ctx.dim, ctx.lo, ctx.n = dim, lo, x.shape[dim]
        shape = list(x.shape)
        shape[dim] = full
        out = x.new_zeros(shape)
        out.narrow(dim, lo, x.shape[dim]).copy_(x)
        return _all_reduce(out, state.group)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None,
                None, None)


class _SelectToModel(torch.autograd.Function):
    """The entries ``index`` of ``dim`` (this rank's slice of a replicated
    activation); the backward sums the ranks' zero-padded gradients, so
    the replicated input's gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, x, state, dim, index):
        ctx.state, ctx.dim, ctx.index = state, dim, index
        ctx.shape = x.shape
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.index_add_(ctx.dim, ctx.index, g.contiguous())
        return _all_reduce(full, ctx.state.group), None, None, None


class TPState:
    """A split module's tensor-parallel state: the model axis's process
    ``group``, its ``size`` and this rank's index ``rank`` on it, the
    split's ``mode`` (``col``, ``row``, ``heads``, ``mlp``, ``out``,
    ``feat``, ``cols``) and what the mode needs (``lo``/``full`` of a
    feature slice; for attention the first query head ``heads_lo``,
    ``kv_split`` and the global head counts)."""

    def __init__(self, group, size: int, rank: int, mode: str, **kw):
        self.group, self.size, self.rank = group, int(size), int(rank)
        self.mode = mode
        self.__dict__.update(kw)

    def copy(self, x):
        return _CopyToModel.apply(x, self)

    def reduce(self, x):
        return _ReduceFromModel.apply(x, self)

    def gather(self, x, dim: int = -1):
        """The whole feature dim ``dim`` of this rank's slice ``x``."""
        dim = dim % x.dim()
        n = x.shape[dim]
        return _GatherFromModel.apply(x, self, dim, self.rank * n,
                                      n * self.size)

    def scatter(self, x, dim: int = -1):
        """This rank's slice of dim ``dim`` of a replicated ``x``."""
        dim = dim % x.dim()
        n = x.shape[dim] // self.size
        index = torch.arange(self.rank * n, (self.rank + 1) * n,
                             device=x.device)
        return _SelectToModel.apply(x, self, dim, index)

    def select(self, x, dim: int, index):
        return _SelectToModel.apply(x, self, dim, index)

    def __repr__(self) -> str:
        return f"TPState({self.mode}, rank {self.rank} of {self.size})"


# --------------------------------------------------------------- placement
# the JAX layout's dim -> the port's dim, for leaves whose layouts differ
# (a conv kernel: JAX HWIO, the port OIHW)
_CONV_DIMS = {0: 2, 1: 3, 2: 1, 3: 0}


def _port_dim(module, leaf: str, jax_dim: int) -> int:
    from bigdl_tpu_torch import nn
    if isinstance(module, nn.SpatialConvolution) and leaf == "weight":
        return _CONV_DIMS[jax_dim]
    return jax_dim


def _split_dim(spec, axis: str) -> Optional[int]:
    spec = tuple(spec or ())
    return spec.index(axis) if axis in spec else None


def _slice_leaf(module, name: str, dim: int, view: Mesh):
    """Replace ``module.<name>`` (a Parameter, or a quantized weight) by
    this rank's slice along ``dim``; returns the leaf's whole size on it."""
    from bigdl_tpu_torch.serving.quant import QuantizedWeight, is_quantized

    leaf = getattr(module, name)
    full = leaf.shape[dim]
    if full % view.size:
        raise ValueError(f"{type(module).__name__}.{name}: dim {dim} of "
                         f"{tuple(leaf.shape)} does not split {view.size} "
                         f"ways")
    n = full // view.size
    lo = view.rank * n
    with torch.no_grad():
        if is_quantized(leaf):
            scale = (leaf.scale.narrow(0, lo, n).clone() if dim == 1
                     else leaf.scale)
            setattr(module, name, QuantizedWeight(
                leaf.q.narrow(dim, lo, n).clone(), scale, leaf.fmt))
        else:
            setattr(module, name, torch.nn.Parameter(
                leaf.data.narrow(dim, lo, n).clone(),
                requires_grad=leaf.requires_grad))
    return full


def apply_specs(module: torch.nn.Module, specs: dict, view: Mesh,
                axis: str = "model") -> dict:
    """Place ``module`` under ``specs`` (JAX paths) on the model-axis line
    ``view``: every split leaf is replaced by this rank's slice and every
    split module gets the ``_tp`` state its forward reads. Returns
    ``{port parameter name: (port dim, whole size)}`` of the split
    leaves."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import Sequential

    split: dict = {}
    g, k, r = view.group, view.size, view.rank

    def state(mode, **kw):
        return TPState(g, k, r, mode, **kw)

    def cut(mod, prefix, sp, names):
        for nm in names:
            d = _split_dim(sp.get(nm), axis)
            if d is not None and hasattr(mod, nm):
                pd = _port_dim(mod, nm, d)
                split[prefix + nm] = (pd, _slice_leaf(mod, nm, pd, view))

    def walk(mod, prefix, sp):
        if not isinstance(sp, dict):
            return
        if isinstance(mod, nn.TransformerEncoderLayer):
            walk(mod.mha, prefix + "mha.", sp.get("mha", {}))
            if _split_dim(sp.get("w1"), axis) is not None:
                cut(mod, prefix, sp, ("w1", "b1", "w2"))
                mod._tp = state("mlp")
            return
        if isinstance(mod, nn.MultiHeadAttention):
            if _split_dim(sp.get("wq"), axis) is None:
                return
            kv_split = _split_dim(sp.get("wk"), axis) is not None
            heads, kv_heads = mod.num_heads, mod.num_kv_heads
            cut(mod, prefix, sp, ("wq", "bq", "wk", "bk", "wv", "bv", "wo"))
            local = heads // k
            mod._tp = state("heads", heads_lo=r * local, kv_split=kv_split,
                            heads=heads, kv_heads=kv_heads)
            mod.num_heads = local
            if kv_split:
                mod.num_kv_heads = kv_heads // k
            return
        if isinstance(mod, nn.Linear):
            d = _split_dim(sp.get("weight"), axis)
            if d is not None:
                cut(mod, prefix, sp, ("weight", "bias"))
                mod._tp = state("col" if d == 1 else "row")
            return
        if isinstance(mod, nn.SpatialConvolution):
            if _split_dim(sp.get("weight"), axis) is not None:
                if type(mod).forward is not nn.SpatialConvolution.forward:
                    raise NotImplementedError(
                        f"{type(mod).__name__} under tensor parallelism")
                cut(mod, prefix, sp, ("weight", "bias"))
                mod._tp = state("out")
            return
        if isinstance(mod, nn.LookupTable):
            if _split_dim(sp.get("weight"), axis) is not None:
                cut(mod, prefix, sp, ("weight",))
                mod._tp = state("feat")
            return
        children = list(mod.named_children())
        for name, child in children:
            walk(child, f"{prefix}{name}.", sp.get(name, {}))
        if isinstance(mod, Sequential):
            # dropout between a column-split Linear and its row partner
            # sees a column slice: hash the whole activation's indices
            cols = None
            for _, child in children:
                tp = getattr(child, "_tp", None)
                if isinstance(child, nn.Linear) and tp is not None:
                    cols = (child.weight.shape[1] * r,
                            child.weight.shape[1] * k) \
                        if tp.mode == "col" else None
                elif cols is not None and isinstance(child, nn.Dropout):
                    child._tp = state("cols", lo=cols[0], full=cols[1])

    walk(module, "", specs)
    return split


@torch.no_grad()
def _gather_leaf(t: torch.Tensor, dim: int, view: Mesh) -> torch.Tensor:
    """The whole tensor of this rank's slice ``t`` along ``dim``: an
    all-reduce of the zero-padded slice over the model-axis line."""
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * view.size
    out = t.new_zeros(shape)
    out.narrow(dim, view.rank * n, n).copy_(t)
    if view.size > 1:
        _all_reduce(out, view.group)
    return out


def unshard_module(module: torch.nn.Module, split: dict,
                   view: Mesh) -> None:
    """Undo :func:`apply_specs`: every split parameter gathered whole and
    put back, every ``_tp`` state cleared and the head counts restored (a
    collective over the model-axis line)."""
    params = dict(module.named_parameters())
    for name, (dim, _) in split.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        whole = _gather_leaf(params[name].data, dim, view)
        setattr(mod, leaf, torch.nn.Parameter(
            whole, requires_grad=params[name].requires_grad))
    for mod in module.modules():
        tp = mod.__dict__.get("_tp")
        if tp is None:
            continue
        if tp.mode == "heads":
            mod.num_heads, mod.num_kv_heads = tp.heads, tp.kv_heads
        mod._tp = None


class TensorParallel(DataParallel):
    """dp x tp over a mesh with ``data_axis`` and ``model_axis`` (the JAX
    ``TensorParallel``): parameters split per ``rules`` (default
    :func:`megatron_specs`) over the model axis, the batch over the data
    axis, the optimizer state of split leaves kept with their slices and
    that of replicated leaves ZeRO-1 over the data axis. ``place`` keeps
    only this rank's slice of each split leaf; ``gather`` gives whole
    trees (a checkpoint is the single process's blob); ``unplace`` puts
    the whole parameters back into the module."""

    def __init__(self, mesh: Mesh, module, data_axis: str = "data",
                 model_axis: str = "model", rules: Callable = megatron_specs,
                 zero1: bool = True, donate: bool = True, grad_comm=None):
        super().__init__(mesh, axis=data_axis, zero1=zero1, donate=donate,
                         grad_comm=grad_comm)
        if model_axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.shape} has no axis "
                             f"{model_axis!r}")
        self.module = module
        self.model_axis = model_axis
        self.rules = rules
        self.specs: Optional[dict] = None
        self._split: dict = {}

    def bind(self, model: torch.nn.Module) -> "TensorParallel":
        """The model this strategy splits (``cli.perf`` builds the
        strategy before the model)."""
        if self.module is not None and self.module is not model:
            raise ValueError("TensorParallel was built over another model")
        self.module = self._model = model
        return self

    def lint_spec_metadata(self, params=None) -> dict:
        """The lint's view of this strategy: :meth:`DataParallel.
        lint_spec_metadata` with the spec tree ``rules`` gives ``params``
        (the JAX param tree; shapes are all it reads) over the model
        axis."""
        meta = super().lint_spec_metadata(None)
        meta["strategy"] = "tp"
        meta["model_axis"] = self.model_axis
        if params is not None:
            meta["param_specs"] = self.rules(self.module, params,
                                             self.model_axis, self.n_shard)
        return meta

    @property
    def model_mesh(self) -> Mesh:
        return self.mesh.axis_view(self.model_axis)

    @property
    def n_shard(self) -> int:
        return self.mesh.shape[self.model_axis]

    @torch.no_grad()
    def _broadcast_whole(self, tensors: list) -> None:
        """``tensors`` from the mesh's first rank to all of its ranks."""
        dist = _dist()
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=self.mesh.global_rank(0),
                           group=self.mesh.group)
            if self.mesh.rank != 0:
                for t, piece in zip(ts, torch.split(
                        flat, [t.numel() for t in ts])):
                    t.copy_(piece.view(t.shape))

    def place(self, params: dict, mod_state: Optional[dict] = None,
              opt_state: Optional[dict] = None):
        """Every rank takes the mesh's first rank's parameters and module
        state, then keeps its slice of each split leaf (new Parameters:
        the returned ``params`` are the module's own) and of their
        optimizer state. Returns ``(params, mod_state, opt_state)``."""
        if self.module is None:
            raise ValueError("TensorParallel needs its model: pass it to "
                             "the constructor or to bind()")
        if self._collective() and self.mesh.size > 1:
            self._broadcast_whole(
                [p.data for _, p in sorted(params.items())]
                + [b for _, b in sorted((mod_state or {}).items())])
        if opt_state is not None:
            from bigdl_tpu_torch.parallel.data_parallel import _meta_tree
            self._template = _meta_tree(opt_state)
        self.specs = self.rules(self.module, param_tree(self.module),
                                self.model_axis, self.n_shard)
        view = self.model_mesh
        self._split = apply_specs(self.module, self.specs, view,
                                  self.model_axis)
        params = dict(self.module.named_parameters())
        self._names = set(params)
        self._local = set(self._split)
        self._owner = balanced_owners(
            {n: p.numel() * p.element_size() for n, p in params.items()
             if n not in self._local}, self.world)
        if opt_state is None:
            return params, mod_state, None
        names = self._names

        def cut(tree):
            out = {}
            for key, v in tree.items():
                if isinstance(v, dict):
                    out[key] = cut(v)
                elif key in self._split and key in names:
                    dim, full = self._split[key]
                    n = full // view.size
                    out[key] = v.narrow(dim, view.rank * n, n).clone()
                else:
                    out[key] = v
            return out

        return params, mod_state, self.shard_opt_state(cut(opt_state))

    def owner(self, name: str) -> int:
        if name in self._local:
            return self.rank
        return super().owner(name)

    def grad_sq_norm(self, grads: dict):
        """The whole model's squared gradient norm: the split leaves'
        squares summed over the model axis, the replicated ones once."""
        split = [g for n, g in grads.items() if n in self._local]
        whole = [g for n, g in grads.items() if n not in self._local]
        part = sum(torch.sum(torch.square(g.float())) for g in split) \
            if split else None
        if part is not None and self.n_shard > 1:
            part = _all_reduce(part.clone(), self.model_mesh.group)
        rest = sum(torch.sum(torch.square(g.float())) for g in whole)
        return rest if part is None else part + rest

    def _update_kw(self, method) -> dict:
        """A per-tensor-norm method (LARS, LAMB) takes the whole leaf's
        norm of a split leaf: its slice's square sum all-reduced over the
        model axis (a replicated leaf keeps its local norm)."""
        if not (self._local and getattr(method, "takes_sq_norm", False)
                and self.n_shard > 1):
            return {}
        group = self.model_mesh.group

        def sq_norm(name, t):
            s = torch.sum(torch.square(t))
            return _all_reduce(s, group) if name in self._local else s

        return {"sq_norm": sq_norm}

    @torch.no_grad()
    def gather(self, params: dict, mod_state: dict, opt_state: dict):
        """Whole trees (a collective over the mesh): the split parameters
        and their optimizer state gathered over the model axis, the
        replicated leaves' ZeRO-1 state over the data axis."""
        params, mod_state, opt_state = super().gather(params, mod_state,
                                                      opt_state)
        view = self.model_mesh
        if params is not None:
            params = {n: (_gather_leaf(p.data, self._split[n][0], view)
                          if n in self._split else p)
                      for n, p in params.items()}
        if opt_state is not None:
            opt_state = self._gather_state(opt_state, view)
        return params, mod_state, opt_state

    def _gather_state(self, tree: dict, view: Mesh) -> dict:
        out = {}
        for key, v in tree.items():
            if isinstance(v, dict):
                out[key] = self._gather_state(v, view)
            elif key in self._split and key in self._names:
                out[key] = _gather_leaf(v, self._split[key][0], view)
            else:
                out[key] = v
        return out

    def unplace(self, model: torch.nn.Module) -> None:
        """Put the whole parameters back into ``model`` (a collective)."""
        if self._split or any(m.__dict__.get("_tp") is not None
                              for m in self.module.modules()):
            unshard_module(self.module, self._split, self.model_mesh)
        self._split, self._local = {}, set()
