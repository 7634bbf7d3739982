"""Torch7 ``.t7`` binary serialization, reader and writer (counterpart of
``bigdl_tpu/interop/torchfile.py``, kept as the port's own copy: the port
imports nothing of the JAX package; reference utils/TorchFile.scala: type
tags :39-59,200-208, ``load`` :74, ``save`` :90, module mapping
:214-335). It reads and writes the same bytes as the JAX package's.

The public Torch7 ``File:writeObject`` wire format (little-endian):

* every value is ``<i32 type-tag><payload>``; tags: 0 nil, 1 number (f64),
  2 string, 3 table, 4 torch object, 5 boolean, 6/7/8 functions.
* tables and torch objects carry an ``i32`` heap index for reference
  sharing; re-reading an index returns the memoized object.
* a torch object payload is ``<string>`` which is either the class name
  (format version 0) or ``"V <n>"`` followed by a second ``<string>`` class
  name; tensors then store ``ndim, sizes[i64], strides[i64],
  storageOffset(i64, 1-based), <storage object>``; storages store
  ``size[i64]`` + raw element bytes.

Tensors are numpy arrays here, as in the JAX package.
:func:`load_torch_params` returns the JAX package's parameter tree (its
(in, out) Linear and HWIO convolution layouts): load it into a port model
with :func:`bigdl_tpu_torch.interop.load_jax`, which converts each leaf
through its module's ``from_jax_leaf``. Whole models come through
:mod:`bigdl_tpu_torch.interop.torch_import`.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np

__all__ = ["load_t7", "save_t7", "TorchObject", "load_torch_params"]

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_LEGACY_RECUR_FUNCTION = 7
TYPE_RECUR_FUNCTION = 8

_TENSOR_DTYPES = {
    "torch.ByteTensor": np.uint8,
    "torch.CharTensor": np.int8,
    "torch.ShortTensor": np.int16,
    "torch.IntTensor": np.int32,
    "torch.LongTensor": np.int64,
    "torch.FloatTensor": np.float32,
    "torch.DoubleTensor": np.float64,
}
_STORAGE_DTYPES = {
    k.replace("Tensor", "Storage"): v for k, v in _TENSOR_DTYPES.items()
}
_DTYPE_TO_TENSOR = {
    np.dtype(np.float32): "torch.FloatTensor",
    np.dtype(np.float64): "torch.DoubleTensor",
    np.dtype(np.int64): "torch.LongTensor",
    np.dtype(np.int32): "torch.IntTensor",
    np.dtype(np.int16): "torch.ShortTensor",
    np.dtype(np.int8): "torch.CharTensor",
    np.dtype(np.uint8): "torch.ByteTensor",
}


class TorchObject:
    """A non-tensor torch class instance: class name + its payload table."""

    def __init__(self, torch_typename: str, fields: Any):
        self.torch_typename = torch_typename
        self.fields = fields

    def __getitem__(self, k):
        return self.fields[k]

    def get(self, k, default=None):
        if isinstance(self.fields, dict):
            return self.fields.get(k, default)
        return default

    def __repr__(self):
        return f"TorchObject({self.torch_typename})"


# ---------------------------------------------------------------- reading

class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: dict[int, Any] = {}

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        data = self.f.read(size)
        if len(data) != size:
            raise EOFError("truncated .t7 file")
        return struct.unpack("<" + fmt, data)[0]

    def read_int(self) -> int:
        return self._read("i")

    def read_long(self) -> int:
        return self._read("q")

    def read_string(self) -> str:
        n = self.read_int()
        return self.f.read(n).decode("latin-1")

    def read_object(self) -> Any:
        tag = self.read_int()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            v = self._read("d")
            return int(v) if float(v).is_integer() else v
        if tag == TYPE_STRING:
            return self.read_string()
        if tag == TYPE_BOOLEAN:
            return bool(self.read_int())
        if tag == TYPE_TABLE:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            table: dict[Any, Any] = {}
            self.memo[idx] = table
            n = self.read_int()
            for _ in range(n):
                k = self.read_object()
                table[k] = self.read_object()
            out = _maybe_list(table)
            # re-memo the converted list so later references share identity
            # (self-referencing array-tables keep the dict — acceptable)
            self.memo[idx] = out
            return out
        if tag == TYPE_TORCH:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            name = self.read_string()
            if name.startswith("V "):  # versioned header
                name = self.read_string()
            obj = self._read_torch_class(name, idx)
            return obj
        if tag in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                   TYPE_LEGACY_RECUR_FUNCTION):
            # dumped lua bytecode: size + blob, then upvalue table. Parsed
            # and discarded (we cannot execute lua).
            size = self.read_int()
            self.f.read(size)
            upvalues = self.read_object()
            fn = TorchObject("function", upvalues)
            return fn
        raise ValueError(f"unknown .t7 type tag {tag}")

    def _read_torch_class(self, name: str, idx: int) -> Any:
        if name in _TENSOR_DTYPES:
            ndim = self.read_int()
            sizes = [self.read_long() for _ in range(ndim)]
            strides = [self.read_long() for _ in range(ndim)]
            offset = self.read_long() - 1  # 1-based
            storage = self.read_object()  # may be None for empty tensors
            if storage is None:
                arr = np.zeros(sizes, dtype=_TENSOR_DTYPES[name])
            elif ndim == 0:
                # 0-d tensor: one element at the storage offset
                arr = np.asarray(storage[offset],
                                 dtype=_TENSOR_DTYPES[name]).copy()
            else:
                itemsize = storage.dtype.itemsize
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:],
                    shape=sizes,
                    strides=[s * itemsize for s in strides],
                ).copy()
            self.memo[idx] = arr
            return arr
        if name in _STORAGE_DTYPES:
            dtype = np.dtype(_STORAGE_DTYPES[name])
            size = self.read_long()
            data = self.f.read(size * dtype.itemsize)
            if len(data) != size * dtype.itemsize:
                # must raise here: a short buffer + the as_strided view in
                # the tensor reader would read out-of-bounds memory
                raise EOFError("truncated .t7 storage")
            arr = np.frombuffer(data, dtype=dtype).copy()
            self.memo[idx] = arr
            return arr
        # generic torch class: payload is one serialized object (its table)
        placeholder = TorchObject(name, {})
        self.memo[idx] = placeholder
        fields = self.read_object()
        placeholder.fields = fields
        return placeholder


def _maybe_list(table: dict) -> Any:
    """Torch tables with consecutive 1..n int keys are arrays — surface
    them as python lists (keeps ``modules`` traversal natural)."""
    n = len(table)
    if n and all(isinstance(k, int) for k in table):
        keys = sorted(table)
        if keys == list(range(1, n + 1)):
            return [table[k] for k in keys]
    return table


# ---------------------------------------------------------------- writing

class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.next_index = 1
        self.memo: dict[int, int] = {}  # id(obj) -> heap index
        # memo keys are id()s: every memoized object must be kept alive for
        # the writer's lifetime or CPython may reuse the address for an
        # unrelated object and dedup it to a stale heap index
        self._keepalive: list[Any] = []

    def _w(self, fmt: str, v):
        self.f.write(struct.pack("<" + fmt, v))

    def write_int(self, v: int):
        self._w("i", v)

    def write_string(self, s: str):
        b = s.encode("latin-1")
        self.write_int(len(b))
        self.f.write(b)

    def write_object(self, obj: Any):
        if obj is None:
            self.write_int(TYPE_NIL)
        elif isinstance(obj, bool):
            self.write_int(TYPE_BOOLEAN)
            self.write_int(int(obj))
        elif isinstance(obj, (int, float)):
            self.write_int(TYPE_NUMBER)
            self._w("d", float(obj))
        elif isinstance(obj, str):
            self.write_int(TYPE_STRING)
            self.write_string(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, (dict, list, tuple)):
            self._write_table(obj)
        elif isinstance(obj, TorchObject):
            self.write_int(TYPE_TORCH)
            if self._ref(obj):
                return
            self.write_string("V 1")
            self.write_string(obj.torch_typename)
            self.write_object(obj.fields)
        else:
            try:
                arr = np.asarray(obj)
            except Exception:
                raise TypeError(f"cannot serialize {type(obj)} to .t7")
            self._write_tensor(arr)

    def _ref(self, obj) -> bool:
        """Write the heap index; True if obj was already written."""
        key = id(obj)
        if key in self.memo:
            self.write_int(self.memo[key])
            return True
        self.memo[key] = self.next_index
        self._keepalive.append(obj)
        self.write_int(self.next_index)
        self.next_index += 1
        return False

    def _write_table(self, obj):
        if isinstance(obj, (list, tuple)):
            obj_dict = {i + 1: v for i, v in enumerate(obj)}
        else:
            obj_dict = obj
        self.write_int(TYPE_TABLE)
        if self._ref(obj):
            return
        self.write_int(len(obj_dict))
        for k, v in obj_dict.items():
            self.write_object(k)
            self.write_object(v)

    def _write_tensor(self, arr: np.ndarray):
        dtype = arr.dtype
        if dtype == np.bool_:
            arr, dtype = arr.astype(np.uint8), np.dtype(np.uint8)
        if dtype not in _DTYPE_TO_TENSOR:
            arr = arr.astype(np.float32)
            dtype = arr.dtype
        tname = _DTYPE_TO_TENSOR[dtype]
        self.write_int(TYPE_TORCH)
        if self._ref(arr):
            return
        self.write_string("V 1")
        self.write_string(tname)
        arr_c = np.ascontiguousarray(arr)
        self.write_int(arr.ndim)
        for s in arr.shape:
            self._w("q", s)
        stride = 1
        strides = []
        for s in reversed(arr.shape):
            strides.append(stride)
            stride *= s
        for s in reversed(strides):
            self._w("q", s)
        self._w("q", 1)  # storage offset, 1-based
        # storage object
        self.write_int(TYPE_TORCH)
        self.write_int(self.next_index)
        self.next_index += 1
        self.write_string("V 1")
        self.write_string(tname.replace("Tensor", "Storage"))
        self._w("q", arr_c.size)
        self.f.write(arr_c.tobytes())


def load_t7(path: str) -> Any:
    """Load a Torch7 ``.t7`` file (reference TorchFile.load :74). Tensors
    come back as numpy arrays, tables as dicts/lists, other torch classes
    as :class:`TorchObject`."""
    with open(path, "rb") as f:
        return _Reader(f).read_object()


def save_t7(path: str, obj: Any) -> None:
    """Write ``obj`` as a Torch7 ``.t7`` file (reference TorchFile.save :90).
    numpy arrays become torch tensors; dicts/lists become tables."""
    with open(path, "wb") as f:
        _Writer(f).write_object(obj)


# --------------------------------------------------- module param import

def _torch_class_basename(obj: TorchObject) -> str:
    return obj.torch_typename.rsplit(".", 1)[-1]


def _convert_torch_weight(cls: str, w: np.ndarray) -> np.ndarray:
    """Torch layout -> the JAX package's layout. Torch Linear stores
    ``(out,in)`` (JAX: ``(in,out)``); torch spatial convs store
    ``(out,in,kH,kW)`` (JAX: HWIO). LookupTable/CMul/etc. keep their
    shape. Applied unconditionally by ndim for unknown classes, since every
    torch 2-D weight is (out,in) and every 4-D is OIHW."""
    if cls in ("LookupTable", "CMul", "CAdd", "Mul", "Add",
               "BatchNormalization", "SpatialBatchNormalization", "PReLU"):
        return w
    if w.ndim == 2:
        return np.ascontiguousarray(w.T)          # (out,in) -> (in,out)
    if w.ndim == 4:
        return np.transpose(w, (2, 3, 1, 0)).copy()  # OIHW -> HWIO
    return w


def load_torch_params(obj: Any) -> Any:
    """Convert a parsed Torch nn module tree into the JAX package's params
    tree (child params under "0", "1", ...; load it into a port model with
    ``load_jax``, which converts each leaf to the module's layout).

    Covers the module families the reference's TorchFile maps
    (utils/TorchFile.scala:214-335): containers expose ``modules``; leaf
    layers expose ``weight``/``bias``. Weight layouts are converted
    (torch (out,in)/OIHW -> JAX (in,out)/HWIO) via
    :func:`_convert_torch_weight`. Layers without parameters map to ``{}``.
    """
    if isinstance(obj, TorchObject):
        fields = obj.fields if isinstance(obj.fields, dict) else {}
        mods = fields.get("modules")
        if mods is not None:
            return {str(i): load_torch_params(m) for i, m in enumerate(mods)}
        cls = _torch_class_basename(obj)
        out: dict[str, Any] = {}
        if isinstance(fields.get("weight"), np.ndarray):
            out["weight"] = _convert_torch_weight(cls, fields["weight"])
        if isinstance(fields.get("bias"), np.ndarray):
            out["bias"] = fields["bias"]
        return out
    if isinstance(obj, list):
        return {str(i): load_torch_params(m) for i, m in enumerate(obj)}
    return {}
