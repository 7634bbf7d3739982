"""Caffe model import (counterpart of ``bigdl_tpu/interop/caffe.py``;
reference utils/CaffeLoader.scala:33-149 and the generated protobuf
classes dl/src/main/java/caffe/Caffe.java).

A ``.caffemodel`` is a protobuf ``NetParameter`` message; the fields that
weight import needs (layer name / type / blobs, blob shape / data) are
decoded straight from the wire format, with no protoc and no generated
code. Field numbers (from the public caffe.proto schema):

* ``NetParameter``: name=1, layers(V1LayerParameter)=2, layer(LayerParameter)=100
* ``V1LayerParameter``: bottom=2, top=3, name=4, type=5(enum), blobs=6
* ``LayerParameter``: name=1, type=2, bottom=3, top=4, blobs=7
* ``BlobProto``: num=1, channels=2, height=3, width=4, data=5(float),
  diff=6, shape=7(BlobShape), double_data=8
* ``BlobShape``: dim=1 (packed int64)

``load_caffe(model, caffemodel)`` mirrors ``Module.loadCaffe``
(nn/Module.scala:36): caffe layers are matched to modules by ``name`` over
the whole module tree, blob 0 goes to ``weight`` and blob 1 to ``bias``.
Each blob is converted to the JAX package's layout by its rules (caffe
OIHW -> HWIO, caffe (out, in) -> (in, out)), then to the module's own
through its ``from_jax_leaf``, so one rule decides the layout in both
packages. ``match_all`` keeps the reference's strictness flag
(CaffeLoader.scala:141). Stated difference: the port copies into the
module's parameters in place and returns the module, where the JAX
function returns a new param tree.
"""

from __future__ import annotations

import struct
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["parse_caffemodel", "parse_prototxt", "load_caffe", "CaffeLayer"]


# ------------------------------------------------------------ wire reader

class _Wire:
    def __init__(self, buf: bytes, pos: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def eof(self) -> bool:
        return self.pos >= self.end

    def varint(self) -> int:
        shift = 0
        out = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def field(self) -> tuple[int, int]:
        key = self.varint()
        return key >> 3, key & 0x7

    def skip(self, wire_type: int) -> None:
        if wire_type == 0:
            self.varint()
        elif wire_type == 1:
            self.pos += 8
        elif wire_type == 2:
            n = self.varint()  # NB: must read the varint before adding — the
            self.pos += n      # augmented form would load pos pre-varint

        elif wire_type == 5:
            self.pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")

    def bytes_field(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def sub(self) -> "_Wire":
        n = self.varint()
        w = _Wire(self.buf, self.pos, self.pos + n)
        self.pos += n
        return w


class CaffeLayer:
    def __init__(self, name: str, type_: str, blobs: list[np.ndarray]):
        self.name = name
        self.type = type_
        self.blobs = blobs

    def __repr__(self):
        return (f"CaffeLayer({self.name!r}, {self.type!r}, "
                f"blobs={[b.shape for b in self.blobs]})")


# V1LayerParameter.LayerType enum values needed for weight-bearing layers.
_V1_TYPES = {4: "Convolution", 14: "InnerProduct", 39: "Deconvolution",
             6: "Data", 18: "ReLU", 17: "Pooling", 20: "Softmax",
             21: "SoftmaxWithLoss", 8: "Dropout", 15: "LRN", 33: "Scale"}


def _parse_blob(w: _Wire) -> np.ndarray:
    dims_legacy = {}
    shape: Optional[list[int]] = None
    data: list[np.ndarray] = []
    while not w.eof():
        fno, wt = w.field()
        if fno in (1, 2, 3, 4) and wt == 0:
            dims_legacy[fno] = w.varint()
        elif fno == 5:  # float data
            if wt == 2:  # packed
                raw = w.bytes_field()
                data.append(np.frombuffer(raw, dtype="<f4"))
            else:  # unpacked 32-bit
                data.append(np.array(
                    struct.unpack_from("<f", w.buf, w.pos), dtype=np.float32))
                w.pos += 4
        elif fno == 8:  # double data
            if wt == 2:
                raw = w.bytes_field()
                data.append(np.frombuffer(raw, dtype="<f8").astype(np.float32))
            else:
                data.append(np.array(
                    struct.unpack_from("<d", w.buf, w.pos), dtype=np.float32))
                w.pos += 8
        elif fno == 7 and wt == 2:  # BlobShape
            sw = w.sub()
            shape = []
            while not sw.eof():
                sfno, swt = sw.field()
                if sfno == 1 and swt == 2:  # packed dims
                    pw = _Wire(sw.bytes_field())
                    while not pw.eof():
                        shape.append(pw.varint())
                elif sfno == 1 and swt == 0:
                    shape.append(sw.varint())
                else:
                    sw.skip(swt)
        else:
            w.skip(wt)
    arr = (np.concatenate(data) if data
           else np.zeros(0, dtype=np.float32))
    if shape is None and dims_legacy:
        shape = [dims_legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape:
        arr = arr.reshape(shape)
    return arr


def _parse_layer(w: _Wire, v1: bool) -> CaffeLayer:
    name = ""
    type_: Any = ""
    blobs: list[np.ndarray] = []
    name_field = 4 if v1 else 1
    type_field = 5 if v1 else 2
    blob_field = 6 if v1 else 7
    while not w.eof():
        fno, wt = w.field()
        if fno == name_field and wt == 2:
            name = w.bytes_field().decode("utf-8", "replace")
        elif fno == type_field:
            if v1 and wt == 0:
                type_ = _V1_TYPES.get(w.varint(), "Unknown")
            elif wt == 2:
                type_ = w.bytes_field().decode("utf-8", "replace")
            else:
                w.skip(wt)
        elif fno == blob_field and wt == 2:
            blobs.append(_parse_blob(w.sub()))
        else:
            w.skip(wt)
    return CaffeLayer(name, type_, blobs)


def parse_caffemodel(path: str) -> list[CaffeLayer]:
    """Parse a binary ``.caffemodel`` into layers with their weight blobs
    (reference CaffeLoader.loadBinary, CaffeLoader.scala:72-84 — which uses
    CodedInputStream with the 2GB limit lifted; here we just mmap-read)."""
    with open(path, "rb") as f:
        buf = f.read()
    w = _Wire(buf)
    layers: list[CaffeLayer] = []
    while not w.eof():
        fno, wt = w.field()
        if fno == 2 and wt == 2:  # V1LayerParameter
            layers.append(_parse_layer(w.sub(), v1=True))
        elif fno == 100 and wt == 2:  # LayerParameter
            layers.append(_parse_layer(w.sub(), v1=False))
        else:
            w.skip(wt)
    return layers


# -------------------------------------------------------- prototxt parser

def parse_prototxt(text: str) -> dict:
    """Minimal protobuf text-format parser (reference parses the .prototxt
    with TextFormat.merge, CaffeLoader.scala:72-78). Returns nested dicts;
    repeated keys become lists."""
    tokens: list[str] = []
    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0]
        line = line.replace("{", " { ").replace("}", " } ").replace(":", ": ")
        tokens.extend(line.split())

    def parse_block(i: int) -> tuple[dict, int]:
        out: dict[str, Any] = {}

        def put(k: str, v: Any):
            if k in out:
                if not isinstance(out[k], list):
                    out[k] = [out[k]]
                out[k].append(v)
            else:
                out[k] = v

        while i < len(tokens):
            tok = tokens[i]
            if tok == "}":
                return out, i + 1
            if tok.endswith(":"):
                key = tok[:-1]
                val = tokens[i + 1]
                if val.startswith('"') or val.startswith("'"):
                    v: Any = val.strip("\"'")
                else:
                    try:
                        v = int(val)
                    except ValueError:
                        try:
                            v = float(val)
                        except ValueError:
                            v = {"true": True, "false": False}.get(val, val)
                put(key, v)
                i += 2
            elif i + 1 < len(tokens) and tokens[i + 1] == "{":
                sub, i = parse_block(i + 2)
                put(tok, sub)
            else:
                i += 1
        return out, i

    out, _ = parse_block(0)
    return out


# ---------------------------------------------------------- weight copy

def _convert_blob(blob: np.ndarray, target_shape) -> Optional[np.ndarray]:
    """Convert a caffe blob onto a param of the JAX package's layout
    ``target_shape``.

    Layout rules come first (shape equality alone cannot decide: a square
    FC weight or a symmetric conv kernel still needs its transpose):

    * 4-D blob -> 4-D param: caffe OIHW -> HWIO, always.
    * 2-D blob -> 2-D param: caffe (out,in) -> (in,out), always.
    * legacy 4-D ``(1,1,out,in)`` InnerProduct blob -> 2-D param:
      squeeze then transpose.
    * otherwise shapes must match element count (bias vectors etc.).
    """
    ts = tuple(int(s) for s in target_shape)
    if blob.size != int(np.prod(ts)):
        return None
    if blob.ndim == 4 and len(ts) == 4:
        cand = np.transpose(blob, (2, 3, 1, 0))  # OIHW -> HWIO
        return cand if cand.shape == ts else None
    if len(ts) == 2:
        mat = blob
        if mat.ndim == 4 and mat.shape[:2] == (1, 1):  # legacy IP blob
            mat = mat.reshape(mat.shape[2], mat.shape[3])
        if mat.ndim == 2:
            cand = np.ascontiguousarray(mat.T)  # (out,in) -> (in,out)
            return cand if cand.shape == ts else None
    if blob.shape == ts:
        return blob
    return blob.reshape(ts)


def _jax_layout(module, slot: str, t: torch.Tensor) -> torch.Tensor:
    convert = getattr(module, "to_jax_leaf", None)
    return t if convert is None else convert(slot, t)


def _port_layout(module, slot: str, t: torch.Tensor) -> torch.Tensor:
    convert = getattr(module, "from_jax_leaf", None)
    return t if convert is None else convert(slot, t)


def load_caffe(model: torch.nn.Module, caffemodel_path: str,
               prototxt_path: Optional[str] = None,
               match_all: bool = True) -> torch.nn.Module:
    """Copy caffe weights into ``model``'s parameters by module name, in
    place (reference CaffeLoader.copyParameters, CaffeLoader.scala:131-140).

    Modules are matched to caffe layers by their ``name`` attribute (set
    ``nn.SpatialConvolution(..., name="conv1")``), every module of the
    tree in order. Raises if ``match_all`` and some caffe weight layer
    found no module (CaffeLoader.scala:141 strictness). Returns the
    model."""
    del prototxt_path  # structure is given by `model`; kept for API parity
    layers = {l.name: l for l in parse_caffemodel(caffemodel_path)
              if l.blobs}
    matched: set[str] = set()
    with torch.no_grad():
        for module in model.modules():
            layer = layers.get(getattr(module, "name", None))
            if layer is None:
                continue
            own = dict(module.named_parameters(recurse=False))
            slots = [k for k in ("weight", "bias") if k in own]
            for slot, blob in zip(slots, layer.blobs):
                param = own[slot]
                shape = tuple(_jax_layout(module, slot, param).shape)
                conv = _convert_blob(blob, shape)
                if conv is None:
                    raise ValueError(
                        f"caffe layer {layer.name!r} blob {blob.shape} does "
                        f"not fit param {slot!r} {shape}")
                param.copy_(_port_layout(module, slot,
                                         torch.from_numpy(np.array(conv))))
            matched.add(module.name)
    unmatched = set(layers) - matched
    if match_all and unmatched:
        raise ValueError(
            f"caffe layers with weights not matched to modules: "
            f"{sorted(unmatched)} (set match_all=False to ignore)")
    return model
