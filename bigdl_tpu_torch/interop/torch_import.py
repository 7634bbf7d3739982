"""Whole-model Torch ``.t7`` import and export (counterpart of
``bigdl_tpu/interop/torch_import.py``; reference ``Module.loadTorch``,
nn/Module.scala:32, backed by the class mapping in
utils/TorchFile.scala:136-181 ``readModuleWithType`` and the per-class
readers :911-1000).

``load_torch_module(path)`` builds the module graph of a ``.t7`` file with
its weights and running statistics: the reference's ``example/loadmodel``
Torch flow. Stated difference: it returns the built module (in eval mode,
on ``device``), where the JAX function returns ``(module, params,
state)``.

Torch runs NCHW; both packages run NHWC. Each builder reads the torch
fields into the JAX package's parameter layout (OIHW -> HWIO, (out, in) ->
(in, out)), and the tree loads through ``load_jax``, which hands each leaf
to its module's ``from_jax_leaf``: one rule decides the layout in both
packages. The conv -> linear flatten, where the element ORDER of the
collapse differs between layouts, is imported as :class:`TorchFlatten`,
which restores torch's CHW order before flattening, so the following
Linear's rows line up verbatim with the torch weights. Concat dimensions
are remapped NCHW -> NHWC the same way. ``save_torch_module`` writes the
inverse, byte for byte the JAX package's file for every module the JAX
exporter takes.

Stated differences, both for models the JAX package cannot carry through
``.t7`` (AlexNet, Inception): the port exports ``SpatialCrossMapLRN`` as
``nn.SpatialCrossMapLRN`` (size, alpha, beta, k) and imports those fields,
where the JAX exporter refuses the class and the JAX importer builds it
with its constructor's defaults; and it writes a grouped convolution's
``groups`` and reads it back (default 1), where the JAX exporter writes
no group count and its importer cannot reshape such a weight.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.core.module import Module, SimpleModule
from bigdl_tpu_torch.interop.torchfile import TorchObject, load_t7, save_t7

__all__ = ["load_torch_module", "save_torch_module", "TorchFlatten"]


class TorchFlatten(SimpleModule):
    """Flatten imported from a torch ``nn.View``/``nn.Reshape`` that sat on
    a 4-D NCHW feature map: NHWC goes back to CHW element order before the
    collapse, so downstream imported Linear weights match torch's. On
    input that is not 4-D it is a plain batch-preserving reshape."""

    def __init__(self, size, name: Optional[str] = None):
        super().__init__(name)
        self.size = tuple(int(s) for s in size)

    def forward(self, x):
        if x.dim() == 4:
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW order
        return x.reshape((x.shape[0],) + self.size)


def _cls(obj: TorchObject) -> str:
    """``nn.SpatialConvolutionMM`` -> ``SpatialConvolutionMM``; cudnn
    aliases fold into nn (reference TorchFile.scala:139-143)."""
    name = obj.torch_typename
    if name.startswith("cudnn."):
        name = "nn." + name[len("cudnn."):]
    return name.rsplit(".", 1)[-1]


def _int(fields: dict, key: str, default: Optional[int] = None) -> int:
    v = fields.get(key, default)
    if v is None:
        raise ValueError(f"torch module missing field {key!r}")
    return int(v)


def _seq_size(arr) -> Tuple[int, ...]:
    """A torch ``size`` field is a LongStorage (numpy array) or a number."""
    if isinstance(arr, np.ndarray):
        return tuple(int(s) for s in arr.tolist())
    if isinstance(arr, (list, tuple)):
        return tuple(int(s) for s in arr)
    return (int(arr),)


def _map_concat_dim(dim: int) -> int:
    """Torch ``Concat``/``JoinTable`` dimension (1-based, NCHW incl. batch)
    -> the NHWC axis. dim 2 (channels) -> -1; dim 1 (batch) -> 0;
    spatial dims shift left by the channel move."""
    return {1: 0, 2: -1, 3: 1, 4: 2}.get(dim, dim - 1)


# ---------------------------------------------------------------- builders
# each returns (module, params, state), the trees in the JAX layout

def _import_children(mods) -> Tuple[list, dict, dict]:
    built, params, state = [], {}, {}
    for i, child in enumerate(mods or []):
        m, p, s = _import(child)
        built.append(m)
        params[str(i)] = p
        state[str(i)] = s
    return built, params, state


def _linear(obj):
    from bigdl_tpu_torch import nn

    fields = obj.fields
    w = np.asarray(fields["weight"], np.float32)      # torch (out, in)
    bias = fields.get("bias")
    mod = nn.Linear(w.shape[1], w.shape[0], with_bias=bias is not None)
    p = {"weight": np.ascontiguousarray(w.T)}
    if bias is not None:
        p["bias"] = np.asarray(bias, np.float32)
    return mod, p, {}


def _conv(obj):
    from bigdl_tpu_torch import nn

    fields = obj.fields
    n_in = _int(fields, "nInputPlane")
    n_out = _int(fields, "nOutputPlane")
    groups = _int(fields, "groups", 1)
    kw, kh = _int(fields, "kW"), _int(fields, "kH")
    mod = nn.SpatialConvolution(
        n_in, n_out, kw, kh,
        stride_w=_int(fields, "dW", 1), stride_h=_int(fields, "dH", 1),
        pad_w=_int(fields, "padW", 0), pad_h=_int(fields, "padH", 0),
        n_group=groups, with_bias=fields.get("bias") is not None)
    w = np.asarray(fields["weight"], np.float32)
    # SpatialConvolutionMM stores (out, in/groups*kH*kW); plain stores OIHW
    w = w.reshape(n_out, n_in // groups, kh, kw)
    p = {"weight": np.transpose(w, (2, 3, 1, 0)).copy()}  # OIHW -> HWIO
    if fields.get("bias") is not None:
        p["bias"] = np.asarray(fields["bias"], np.float32)
    return mod, p, {}


def _conv_map(obj):
    """Torch SpatialConvolutionMap (reference reader
    TorchFile.scala:922-939): ``weight`` is per-connection (nPairs, kH,
    kW), ``connTable`` (nPairs, 2) 1-based (in, out). The module is a
    masked dense convolution, so each pair's kernel is scattered into the
    dense HWIO weight; the fixed mask zeroes everything else."""
    from bigdl_tpu_torch import nn

    f = obj.fields
    ct = np.asarray(f["connTable"], np.float32).astype(np.int64) - 1
    kw, kh = _int(f, "kW"), _int(f, "kH")
    # honor explicit plane counts when present: a legal table may leave
    # the highest-numbered plane unconnected, so inference undercounts
    n_in = _int(f, "nInputPlane", 0) or None
    n_out = _int(f, "nOutputPlane", 0) or None
    mod = nn.SpatialConvolutionMap(
        ct, kw, kh,
        stride_w=_int(f, "dW", 1), stride_h=_int(f, "dH", 1),
        pad_w=_int(f, "padW", 0), pad_h=_int(f, "padH", 0),
        n_input_plane=n_in, n_output_plane=n_out)
    w = np.asarray(f["weight"], np.float32).reshape(len(ct), kh, kw)
    dense = np.zeros((kh, kw, mod.n_input_plane, mod.n_output_plane),
                     np.float32)
    dense[:, :, ct[:, 0], ct[:, 1]] = np.transpose(w, (1, 2, 0))
    p = {"weight": dense,
         "bias": np.asarray(f["bias"], np.float32)}
    return mod, p, {}


def _maxpool(obj):
    from bigdl_tpu_torch import nn

    f = obj.fields
    mod = nn.SpatialMaxPooling(
        _int(f, "kW"), _int(f, "kH"),
        _int(f, "dW", _int(f, "kW")), _int(f, "dH", _int(f, "kH")),
        pad_w=_int(f, "padW", 0), pad_h=_int(f, "padH", 0),
        ceil_mode=bool(f.get("ceil_mode", False)))
    return mod, {}, {}


def _avgpool(obj):
    from bigdl_tpu_torch import nn

    f = obj.fields
    mod = nn.SpatialAveragePooling(
        _int(f, "kW"), _int(f, "kH"),
        _int(f, "dW", _int(f, "kW")), _int(f, "dH", _int(f, "kH")),
        pad_w=_int(f, "padW", 0), pad_h=_int(f, "padH", 0),
        ceil_mode=bool(f.get("ceil_mode", False)),
        count_include_pad=bool(f.get("count_include_pad", True)))
    return mod, {}, {}


def _lrn(obj):
    """Torch ``nn.SpatialCrossMapLRN`` with its fields (Torch7's
    defaults: size 5, alpha 1e-4, beta 0.75, k 1)."""
    from bigdl_tpu_torch import nn

    f = obj.fields
    return nn.SpatialCrossMapLRN(
        _int(f, "size", 5), float(f.get("alpha", 1e-4)),
        float(f.get("beta", 0.75)), float(f.get("k", 1.0))), {}, {}


def _batchnorm(obj, spatial: bool):
    from bigdl_tpu_torch import nn

    f = obj.fields
    running_mean = np.asarray(f["running_mean"], np.float32)
    affine = f.get("weight") is not None
    cls = nn.SpatialBatchNormalization if spatial else nn.BatchNormalization
    mod = cls(running_mean.shape[0],
              eps=float(f.get("eps", 1e-5)),
              momentum=float(f.get("momentum", 0.1)),
              affine=affine)
    p = {}
    if affine:
        p = {"weight": np.asarray(f["weight"], np.float32),
             "bias": np.asarray(f["bias"], np.float32)}
    s = {"running_mean": running_mean,
         "running_var": np.asarray(f["running_var"], np.float32)}
    return mod, p, s


def _sequential(obj):
    from bigdl_tpu_torch.core.module import Sequential

    built, params, state = _import_children(obj.fields.get("modules"))
    return Sequential(*built), params, state


def _concat(obj):
    from bigdl_tpu_torch import nn

    built, params, state = _import_children(obj.fields.get("modules"))
    axis = _map_concat_dim(_int(obj.fields, "dimension", 2))
    return nn.Concat(*built, axis=axis), params, state


def _concat_table(obj):
    from bigdl_tpu_torch import nn

    built, params, state = _import_children(obj.fields.get("modules"))
    return nn.ConcatTable(*built), params, state


def _view(obj):
    f = obj.fields
    size = _seq_size(f.get("size", f.get("numElements")))
    return TorchFlatten(size), {}, {}


def _dropout(obj):
    from bigdl_tpu_torch import nn

    return nn.Dropout(float(obj.fields.get("p", 0.5))), {}, {}


def _threshold(obj):
    from bigdl_tpu_torch import nn

    f = obj.fields
    return nn.Threshold(float(f.get("threshold", 1e-6)),
                        float(f.get("val", 0.0))), {}, {}


def _zero_padding(obj):
    from bigdl_tpu_torch import nn

    f = obj.fields
    return nn.SpatialZeroPadding(
        _int(f, "pad_l", 0), _int(f, "pad_r", 0),
        _int(f, "pad_t", 0), _int(f, "pad_b", 0)), {}, {}


def _cadd_table(obj):
    from bigdl_tpu_torch import nn

    return nn.CAddTable(), {}, {}


_BUILDERS = {
    "Linear": _linear,
    "SpatialConvolution": _conv,
    "SpatialConvolutionMM": _conv,
    "SpatialConvolutionMap": _conv_map,
    "SpatialMaxPooling": _maxpool,
    "SpatialAveragePooling": _avgpool,
    "SpatialCrossMapLRN": _lrn,
    "BatchNormalization": lambda o: _batchnorm(o, spatial=False),
    "SpatialBatchNormalization": lambda o: _batchnorm(o, spatial=True),
    "Sequential": _sequential,
    "Concat": _concat,
    "ConcatTable": _concat_table,
    "CAddTable": _cadd_table,
    "View": _view,
    "Reshape": _view,
    "Dropout": _dropout,
    "Threshold": _threshold,
    "SpatialZeroPadding": _zero_padding,
}

# parameter-free classes resolved by name on bigdl_tpu_torch.nn (the
# analog of the reference's createInstanceFor reflection fallback,
# TorchFile.scala:163-178)
_PARAM_FREE = {
    "ReLU", "Tanh", "Sigmoid", "LogSoftMax", "SoftMax", "Identity",
    "SoftPlus", "SoftSign", "ELU", "Abs", "Square", "Sqrt", "HardTanh",
    "LeakyReLU", "ReLU6", "SoftMin", "Exp", "Log",
}


def _import(obj: Any) -> Tuple[Module, Any, Any]:
    from bigdl_tpu_torch import nn

    if not isinstance(obj, TorchObject):
        raise ValueError(f"expected a torch nn module, got {type(obj)}")
    cls = _cls(obj)
    builder = _BUILDERS.get(cls)
    if builder is not None:
        return builder(obj)
    if cls in _PARAM_FREE:
        return getattr(nn, cls)(), {}, {}
    # last resort, mirrors the reference's reflection: a same-named
    # parameter-free class on bigdl_tpu_torch.nn (only safe when the torch
    # object carries no weights that would be silently dropped)
    target = getattr(nn, cls, None)
    has_params = (isinstance(obj.fields, dict)
                  and any(isinstance(obj.fields.get(k), np.ndarray)
                          for k in ("weight", "bias")))
    if target is not None and not has_params:
        try:
            return target(), {}, {}
        except TypeError:
            pass
    raise ValueError(f"unsupported torch module nn.{cls} "
                     f"(reference parity set: TorchFile.scala:136-181)")


def load_torch_module(path_or_obj, device=None) -> Module:
    """The module of a ``.t7`` file or an already-parsed
    :class:`TorchObject` tree, with its weights and running statistics
    (reference Module.loadTorch, nn/Module.scala:32), in eval mode on
    ``device`` (CUDA unless the CPU is asked for)."""
    from bigdl_tpu_torch.core.module import resolve_device
    from bigdl_tpu_torch.interop.from_jax import load_jax

    dev = resolve_device(device)
    obj = (load_t7(path_or_obj) if isinstance(path_or_obj, str)
           else path_or_obj)
    mod, params, state = _import(obj)
    load_jax(mod, params, state)
    return mod.eval().to(dev)


# ---------------------------------------------------------------- export
# Inverse mapping: a module tree -> the TorchObject tree the reference
# reader (TorchFile.scala:136-181) and this file's importer both accept.
# Field spellings follow the reference readers exactly: ReLU requires
# "inplace", pooling requires "ceil_mode", Linear requires "bias", View
# requires "numElements".

def _perm_chw(h: int, w: int, c: int) -> np.ndarray:
    """perm[t] = HWC-flat index of the element at CHW-flat position t, so
    ``torch_rows = rows[perm]`` reorders a flattened feature dim from the
    NHWC collapse to torch's NCHW collapse."""
    return np.arange(h * w * c).reshape(h, w, c).transpose(2, 0, 1).ravel()


def _jax_leaf(mod, key: str) -> np.ndarray:
    """``mod``'s parameter or buffer ``key`` in the JAX package's layout,
    as f32 numpy."""
    t = getattr(mod, key).detach().cpu()
    convert = getattr(mod, "to_jax_leaf", None)
    if convert is not None:
        t = convert(key, t)
    return np.asarray(t, np.float32)


class _ExportCtx:
    """Threads (a) the activation through Sequential chains, from
    ``example_input``, so the conv->linear flatten can compute its row
    permutation, and (b) that pending permutation until the next Linear
    consumes it."""

    def __init__(self, example_input=None):
        self.x = example_input
        self.perm: Optional[np.ndarray] = None
        # set when a Reshape/View is exported without a live activation:
        # the CHW permutation question could not be answered, so a
        # following Linear must refuse rather than silently write
        # NHWC-ordered rows
        self.blind_flatten = False

    def advance(self, mod):
        if self.x is None:
            return
        try:
            self.x = mod(self.x)
        except (RuntimeError, TypeError, ValueError, IndexError):
            self.x = None  # shape tracking ends at exotic modules

    def shape(self):
        return None if not torch.is_tensor(self.x) else tuple(self.x.shape)


_PASS_THROUGH = {  # elementwise: a pending flatten-perm flows through
    "ReLU", "Tanh", "Sigmoid", "Threshold", "Dropout", "LogSoftMax",
    "SoftMax", "Identity", "ELU", "LeakyReLU", "ReLU6", "Abs",
}


def _obj(cls: str, fields: dict) -> TorchObject:
    fields.setdefault("_type", "torch.FloatTensor")
    fields.setdefault("train", False)
    return TorchObject(f"nn.{cls}", fields)


def _branches(mod, ctx: _ExportCtx) -> list:
    """The children of a Concat or ConcatTable, each exported from the
    container's input."""
    children = []
    for ch in mod.children():
        branch = _ExportCtx()
        branch.x = ctx.x
        children.append(_export(ch, branch))
    return children


def _export(mod, ctx: _ExportCtx) -> TorchObject:
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.core.module import Sequential

    name = type(mod).__name__
    in_shape = ctx.shape()

    if isinstance(mod, Sequential):
        return _obj("Sequential",
                    {"modules": [_export(ch, ctx) for ch in mod.children()]})

    if isinstance(mod, nn.Concat):
        children = _branches(mod, ctx)
        ctx.advance(mod)
        axis = mod.axis
        dim = {0: 1, -1: 2, 3: 2, 1: 3, 2: 4}.get(axis)
        if dim is None:
            raise ValueError(f"cannot map Concat axis {axis} to torch")
        return _obj("Concat", {"modules": children,
                               "dimension": float(dim)})

    if isinstance(mod, nn.ConcatTable):
        children = _branches(mod, ctx)
        ctx.x = None
        return _obj("ConcatTable", {"modules": children})

    if isinstance(mod, nn.CAddTable):
        ctx.advance(mod)
        return _obj("CAddTable", {"inplace": False})

    if isinstance(mod, nn.Linear):
        if ctx.blind_flatten:
            raise ValueError(
                "Reshape->Linear export without shape tracking: pass "
                "example_input to save_torch_module so the CHW flatten "
                "permutation can be computed; exporting blind would write "
                "NHWC-ordered Linear rows that torch consumers misread")
        w = _jax_leaf(mod, "weight")               # (in, out)
        if ctx.perm is not None:
            if ctx.perm.shape[0] != w.shape[0]:
                raise ValueError(
                    "flatten permutation does not match Linear fan-in "
                    f"({ctx.perm.shape[0]} vs {w.shape[0]})")
            w = w[ctx.perm]
            ctx.perm = None
        bias = (_jax_leaf(mod, "bias") if mod.with_bias
                else np.zeros((w.shape[1],), np.float32))
        ctx.advance(mod)
        return _obj("Linear", {"weight": np.ascontiguousarray(w.T),
                               "bias": bias})

    if isinstance(mod, nn.SpatialConvolutionMap):
        w = _jax_leaf(mod, "weight")               # dense HWIO, masked
        ct = mod.conn_table                        # (nPairs, 2) 0-based
        per_pair = np.transpose(w[:, :, ct[:, 0], ct[:, 1]], (2, 0, 1))
        ctx.advance(mod)
        return _obj("SpatialConvolutionMap", {
            "connTable": (ct + 1).astype(np.float64),   # torch is 1-based
            "kW": float(mod.kernel_w), "kH": float(mod.kernel_h),
            "dW": float(mod.stride_w), "dH": float(mod.stride_h),
            "padW": float(mod.pad_w), "padH": float(mod.pad_h),
            "nInputPlane": float(mod.n_input_plane),
            "nOutputPlane": float(mod.n_output_plane),
            "weight": np.ascontiguousarray(per_pair),
            "bias": _jax_leaf(mod, "bias"),
        })

    if isinstance(mod, nn.SpatialConvolution):
        w = _jax_leaf(mod, "weight")               # HWIO
        kh, kw, cin_g, cout = w.shape
        oihw = np.transpose(w, (3, 2, 0, 1))
        bias = (_jax_leaf(mod, "bias") if mod.with_bias
                else np.zeros((cout,), np.float32))
        ctx.advance(mod)
        fields = {
            "nInputPlane": float(mod.n_input_plane),
            "nOutputPlane": float(mod.n_output_plane),
            "kW": float(mod.kernel_w), "kH": float(mod.kernel_h),
            "dW": float(mod.stride_w), "dH": float(mod.stride_h),
            "padW": float(mod.pad_w), "padH": float(mod.pad_h),
            "weight": np.ascontiguousarray(
                oihw.reshape(cout, cin_g * kh * kw)),
            "bias": bias,
        }
        if mod.n_group > 1:
            fields["groups"] = float(mod.n_group)
        return _obj("SpatialConvolutionMM", fields)

    if isinstance(mod, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
        ctx.advance(mod)
        fields = {
            "kW": float(mod.kernel_w), "kH": float(mod.kernel_h),
            "dW": float(mod.stride_w), "dH": float(mod.stride_h),
            "padW": float(mod.pad_w), "padH": float(mod.pad_h),
            "ceil_mode": bool(mod.ceil_mode),
        }
        if isinstance(mod, nn.SpatialAveragePooling):
            fields["count_include_pad"] = bool(mod.count_include_pad)
            return _obj("SpatialAveragePooling", fields)
        return _obj("SpatialMaxPooling", fields)

    if isinstance(mod, nn.SpatialCrossMapLRN):
        ctx.advance(mod)
        return _obj("SpatialCrossMapLRN", {
            "size": float(mod.size), "alpha": float(mod.alpha),
            "beta": float(mod.beta), "k": float(mod.k)})

    if isinstance(mod, nn.BatchNormalization):
        cls = ("SpatialBatchNormalization"
               if isinstance(mod, nn.SpatialBatchNormalization)
               else "BatchNormalization")
        fields = {
            "eps": float(mod.eps), "momentum": float(mod.momentum),
            "affine": bool(mod.affine),
            "running_mean": _jax_leaf(mod, "running_mean"),
            "running_var": _jax_leaf(mod, "running_var"),
        }
        if mod.affine:
            fields["weight"] = _jax_leaf(mod, "weight")
            fields["bias"] = _jax_leaf(mod, "bias")
        ctx.advance(mod)
        return _obj(cls, fields)

    if isinstance(mod, TorchFlatten):
        size = np.asarray(mod.size, np.int64)
        ctx.advance(mod)
        return _obj("View", {"size": size,
                             "numElements": float(int(np.prod(size)))})

    if isinstance(mod, nn.Reshape):             # includes nn.View
        size = np.asarray(mod.size, np.int64)
        if in_shape is not None and len(in_shape) == 4:
            # the NHWC flatten collapses HWC; torch consumers expect CHW
            # order -> permute the next Linear's rows (consumed above)
            _, h, w_, c = in_shape
            ctx.perm = _perm_chw(h, w_, c)
        elif in_shape is None:
            ctx.blind_flatten = True
        ctx.advance(mod)
        return _obj("View", {"size": size,
                             "numElements": float(int(np.prod(size)))})

    if isinstance(mod, nn.Threshold) and not isinstance(mod, nn.ReLU):
        ctx.advance(mod)
        return _obj("Threshold", {"threshold": float(mod.th),
                                  "val": float(mod.v), "inplace": False})

    if isinstance(mod, nn.Dropout):
        ctx.advance(mod)
        return _obj("Dropout", {"p": float(mod.p), "inplace": False})

    if name in _PASS_THROUGH:
        ctx.advance(mod)
        fields = {"inplace": False} if name == "ReLU" else {}
        return _obj(name, fields)

    raise ValueError(
        f"cannot export {name} to .t7 (reference writeModule parity set: "
        "TorchFile.scala:258-295)")


def save_torch_module(module: torch.nn.Module, path: str,
                      example_input=None) -> None:
    """Write a module tree, with its weights and running statistics, as a
    Torch7 ``.t7`` model file (reference ``Module.saveTorch`` /
    TorchFile.writeModule, TorchFile.scala:258-295). Stated difference:
    the module carries its own weights, where the JAX function takes
    ``(module, params, state, path)``.

    ``example_input`` (a tensor, or a shape for zeros) is run through the
    module in eval mode to track the activation's shape through Sequential
    chains; it is required for exact export of models with a
    conv->linear flatten, where torch's NCHW collapse order differs from
    the NHWC one and the following Linear's rows must be permuted (see
    :func:`_perm_chw`)."""
    if example_input is not None and not torch.is_tensor(example_input):
        example_input = torch.zeros(tuple(example_input))
    if example_input is not None:
        first = next(module.parameters(), None)
        if first is not None:
            example_input = example_input.to(first.device)
    modes = {m: m.training for m in module.modules()}
    module.eval()
    try:
        with torch.no_grad():
            obj = _export(module, _ExportCtx(example_input))
    finally:
        for m, training in modes.items():
            m.training = training
    save_t7(path, obj)
