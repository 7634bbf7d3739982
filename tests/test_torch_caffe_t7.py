"""The port's model importers against the JAX package's, on the CPU: the
Caffe wire reader, prototxt parser and ``load_caffe``; the Torch7 ``.t7``
reader and writer, ``load_torch_params``, and whole-model
``load_torch_module``/``save_torch_module``.

Every file is written here from a numpy seed: ``.caffemodel`` bytes by a
protobuf wire writer (V1 and new layer formats, packed and unpacked
floats, ``double_data``, legacy 4-D InnerProduct blobs), ``.t7`` files by
either package's writer or from hand-built Torch7-style object trees.
Parameters and bytes must be equal exactly; forwards of imported models
atol 1e-5 (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import models as jax_models
from bigdl_tpu import nn as jnn
from bigdl_tpu.interop import caffe as jax_caffe
from bigdl_tpu.interop import torch_import as jax_ti
from bigdl_tpu.interop import torchfile as jax_tf
from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.interop import (TorchFlatten, TorchObject, load_caffe,
                                     load_jax, load_t7, load_torch_module,
                                     load_torch_params, parse_caffemodel,
                                     parse_prototxt, save_t7,
                                     save_torch_module, tensors_from_jax)

ATOL = 1e-5


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=atol)


def _zeros_tree(jm):
    """A JAX param tree of ``jm``'s shapes (``load_caffe`` reads only the
    shapes and dtypes of the tree it fills)."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  jax.eval_shape(jm.init,
                                                 jax.random.PRNGKey(0)))


# ------------------------------------------------------- caffe wire writer
def _varint(n):
    out = b""
    while True:
        b7, n = n & 0x7F, n >> 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _key(fno, wt):
    return _varint((fno << 3) | wt)


def _len_delim(fno, data):
    return _key(fno, 2) + _varint(len(data)) + data


def _blob(arr, fmt):
    """A BlobProto of ``arr``: ``fmt`` is packed, unpacked (one 32-bit
    field per float), double (packed double_data), double_unpacked or
    legacy (num/channels/height/width fields, packed floats)."""
    if fmt == "legacy":
        dims = (1,) * (4 - arr.ndim) + arr.shape
        msg = b"".join(_key(f, 0) + _varint(d)
                       for f, d in zip((1, 2, 3, 4), dims))
    else:
        msg = _len_delim(7, _len_delim(1, b"".join(_varint(d)
                                                   for d in arr.shape)))
    flat = arr.ravel()
    if fmt in ("packed", "legacy"):
        msg += _len_delim(5, flat.astype("<f4").tobytes())
    elif fmt == "unpacked":
        msg += b"".join(_key(5, 5) + v.tobytes()
                        for v in flat.astype("<f4"))
    elif fmt == "double":
        msg += _len_delim(8, flat.astype("<f8").tobytes())
    else:  # double_unpacked
        msg += b"".join(_key(8, 1) + v.tobytes()
                        for v in flat.astype("<f8"))
    return msg


_V1_ENUM = {"Convolution": 4, "InnerProduct": 14, "ReLU": 18,
            "Pooling": 17, "LRN": 15}


def _layer(name, type_, blobs, v1, fmt):
    if v1:
        msg = _len_delim(4, name.encode()) + _key(5, 0) + _varint(
            _V1_ENUM[type_])
        return msg + b"".join(_len_delim(6, _blob(b, fmt)) for b in blobs)
    msg = _len_delim(1, name.encode()) + _len_delim(2, type_.encode())
    return msg + b"".join(_len_delim(7, _blob(b, fmt)) for b in blobs)


def write_caffemodel(path, layers, v1=False, fmt="packed"):
    """A NetParameter of ``layers`` [(name, type, [blob arrays])]."""
    net = _len_delim(1, b"seeded") + _len_delim(3, b"data")  # skipped
    for name, type_, blobs in layers:
        net += _len_delim(2 if v1 else 100,
                          _layer(name, type_, blobs, v1, fmt))
    with open(path, "wb") as f:
        f.write(net)
    return str(path)


FORMATS = [(v1, fmt) for v1 in (False, True)
           for fmt in ("packed", "unpacked", "double", "double_unpacked",
                       "legacy")]


@pytest.mark.parametrize("v1,fmt", FORMATS,
                         ids=[f"{'v1' if v1 else 'new'}-{f}"
                              for v1, f in FORMATS])
def test_parse_caffemodel_matches_jax(tmp_path, v1, fmt):
    rs = np.random.RandomState(0)
    layers = [("conv1", "Convolution", [rs.randn(4, 3, 3, 3), rs.randn(4)]),
              ("relu1", "ReLU", []),
              ("fc", "InnerProduct", [rs.randn(5, 36), rs.randn(5)])]
    path = write_caffemodel(tmp_path / "m.caffemodel", layers, v1, fmt)
    got, ref = parse_caffemodel(path), jax_caffe.parse_caffemodel(path)
    assert [(l.name, l.type) for l in got] == [(l.name, l.type) for l in ref]
    assert [(l.name, l.type) for l in got] == [(n, t) for n, t, _ in layers]
    for g, r, (_, _, blobs) in zip(got, ref, layers):
        assert len(g.blobs) == len(r.blobs) == len(blobs)
        for a, b, want in zip(g.blobs, r.blobs, blobs):
            shape = ((1,) * (4 - want.ndim) + want.shape if fmt == "legacy"
                     else want.shape)
            assert a.dtype == b.dtype == np.float32
            assert a.shape == b.shape == shape
            assert a.tobytes() == b.tobytes()
            assert np.array_equal(a.ravel(), want.astype(np.float32).ravel())


GOOGLENET_PROTOTXT = '''
name: "GoogleNet"   # deploy net
input: "data"
input_dim: 10
input_dim: 3
input_dim: 224
input_dim: 224
layer {
  name: "conv1/7x7_s2"
  type: "Convolution"
  bottom: "data"
  top: "conv1/7x7_s2"
  param { lr_mult: 1 decay_mult: 1 }
  param { lr_mult: 2 decay_mult: 0 }
  convolution_param {
    num_output: 64 pad: 3 kernel_size: 7 stride: 2
    weight_filler { type: "xavier" std: 0.1 }
    bias_filler { type: "constant" value: 0.2 }
  }
}
layer { name: "pool1/3x3_s2" type: "Pooling" bottom: "conv1/7x7_s2"
  top: "pool1/3x3_s2"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer {
  name: "pool1/norm1"  type: "LRN"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 }
}
layer { name: "inception_3a/output" type: "Concat"
  bottom: "inception_3a/1x1" bottom: "inception_3a/3x3"
  bottom: "inception_3a/5x5" bottom: "inception_3a/pool_proj" }
layer { name: "loss3/classifier" type: "InnerProduct"
  inner_product_param { num_output: 1000 } include { phase: TEST } }
'''


def test_parse_prototxt_matches_jax():
    got = parse_prototxt(GOOGLENET_PROTOTXT)
    assert got == jax_caffe.parse_prototxt(GOOGLENET_PROTOTXT)
    assert got["input_dim"] == [10, 3, 224, 224]
    assert len(got["layer"]) == 5
    conv = got["layer"][0]
    assert conv["name"] == "conv1/7x7_s2" and len(conv["param"]) == 2
    assert conv["convolution_param"]["weight_filler"] == {"type": "xavier",
                                                          "std": 0.1}
    assert got["layer"][2]["lrn_param"]["alpha"] == 0.0001
    assert got["layer"][3]["bottom"][3] == "inception_3a/pool_proj"


# (caffe name, blob shapes) of AlexNet at 17 classes, caffe layouts
ALEXNET_BLOBS = [("conv1", (96, 3, 11, 11)), ("conv2", (256, 48, 5, 5)),
                 ("conv3", (384, 256, 3, 3)), ("conv4", (384, 192, 3, 3)),
                 ("conv5", (256, 192, 3, 3)), ("fc6", (4096, 9216)),
                 ("fc7", (4096, 4096)), ("fc8", (17, 4096))]


def alexnet_caffemodel(path, classes=17, seed=0):
    """A seeded AlexNet ``.caffemodel`` of the real blob shapes (fc8 at
    ``classes``); fc7 as a legacy (1, 1, out, in) blob."""
    rng = np.random.default_rng(seed)
    layers = []
    for name, shape in ALEXNET_BLOBS:
        if name == "fc8":
            shape = (classes, 4096)
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
        b = 0.1 * rng.standard_normal(shape[0], dtype=np.float32)
        if name == "fc7":
            w = w.reshape(1, 1, *shape)
        layers.append((name, "InnerProduct" if name.startswith("fc")
                       else "Convolution", [w, b]))
        layers.append((f"relu{len(layers)}", "ReLU", []))
    return write_caffemodel(path, layers), layers


def test_load_caffe_alexnet_matches_jax(tmp_path):
    """Every AlexNet parameter from ``load_caffe`` equals
    ``load_jax(<the JAX load_caffe tree>)`` exactly: grouped convolutions,
    a legacy fc blob, in place, the model returned."""
    path, layers = alexnet_caffemodel(tmp_path / "alexnet.caffemodel")
    jm = jax_models.alexnet(17)
    jtree = jax_caffe.load_caffe(jm, _zeros_tree(jm), path)
    tm = models.alexnet(17, generator=torch.Generator().manual_seed(0))
    assert load_caffe(tm, path, prototxt_path="unused") is tm
    want = tensors_from_jax(tm, jax.tree_util.tree_map(np.asarray, jtree))
    got = tm.state_dict()
    assert set(got) == set(want) and len(got) == 16
    for name, t in got.items():
        assert torch.equal(t, want[name]), name
    conv2 = next(blobs for name, _, blobs in layers if name == "conv2")[0]
    assert torch.equal(tm[4].weight, torch.from_numpy(conv2))  # (out, in/g)


def test_load_caffe_match_all_square_fc_and_errors(tmp_path):
    rs = np.random.RandomState(1)
    sq = rs.randn(4, 4).astype(np.float32)
    sym = np.ones((2, 2, 3, 3), np.float32)
    sym[:, :, 0, 0] = 5.0
    path = write_caffemodel(tmp_path / "a.caffemodel",
                            [("fc1", "InnerProduct", [sq]),
                             ("c1", "Convolution", [sym]),
                             ("fcX", "InnerProduct", [sq])])

    def jmodel():
        return jnn.Sequential(jnn.SpatialConvolution(2, 2, 3, 3, name="c1"),
                              jnn.Linear(4, 4, name="fc1"))

    def tmodel():
        return nn.Sequential(nn.SpatialConvolution(2, 2, 3, 3, name="c1"),
                             nn.Linear(4, 4, name="fc1"))

    jm, tm = jmodel(), tmodel()
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0)))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with pytest.raises(ValueError) as jerr:
        jax_caffe.load_caffe(jm, jparams, path)
    with pytest.raises(ValueError) as terr:
        load_caffe(tm, path)
    assert str(terr.value) == str(jerr.value) and "fcX" in str(terr.value)
    jtree = jax_caffe.load_caffe(jm, jparams, path, match_all=False)
    load_caffe(tm, path, match_all=False)
    # the square FC weight is transposed, the symmetric kernel laid out
    assert torch.equal(tm[1].weight, torch.from_numpy(sq.T.copy()))
    assert torch.equal(tm[0].weight, torch.from_numpy(sym))
    assert torch.equal(tm[0].bias, before["0.bias"])  # no blob 1
    want = tensors_from_jax(tm, jax.tree_util.tree_map(np.asarray, jtree))
    for name in ("0.weight", "1.weight"):
        assert torch.equal(tm.state_dict()[name], want[name]), name
    bad = write_caffemodel(tmp_path / "b.caffemodel",
                           [("fc1", "InnerProduct", [rs.randn(3, 4)])])
    with pytest.raises(ValueError) as jerr:
        jax_caffe.load_caffe(jmodel(), jparams, bad)
    with pytest.raises(ValueError) as terr:
        load_caffe(tmodel(), bad)
    assert str(terr.value) == str(jerr.value)
    assert "does not fit param 'weight' (4, 4)" in str(terr.value)


def test_load_caffe_inception_names_refused_in_both(tmp_path):
    """Reference-side behaviour, kept: the inception builders name none of
    their modules, so a caffemodel with GoogLeNet's layer names matches
    nothing, and ``match_all`` raises the same error in both packages."""
    rs = np.random.RandomState(2)
    path = write_caffemodel(tmp_path / "g.caffemodel", [
        ("conv1/7x7_s2", "Convolution", [rs.randn(64, 3, 7, 7),
                                         rs.randn(64)]),
        ("inception_3a/1x1", "Convolution", [rs.randn(64, 192, 1, 1),
                                             rs.randn(64)])])
    jm = jax_models.inception_v1_no_aux(10)
    tm = models.inception_v1_no_aux(10)
    with pytest.raises(ValueError) as jerr:
        jax_caffe.load_caffe(jm, _zeros_tree(jm), path)
    with pytest.raises(ValueError) as terr:
        load_caffe(tm, path)
    assert str(terr.value) == str(jerr.value)
    assert "'conv1/7x7_s2', 'inception_3a/1x1'" in str(terr.value)
    names = {m.name for m in tm.modules()
             if isinstance(m, nn.SpatialConvolution)}
    assert names == {"SpatialConvolution"}


# ------------------------------------------------------------------ torch7
def _t7_values():
    """One of every value the format carries: each tensor dtype, a bool
    array, a 0-d tensor, nested tables, a shared array (one heap index),
    a torch object, strings, numbers, booleans and nil."""
    rs = np.random.RandomState(3)
    shared = rs.randn(3, 2).astype(np.float32)
    arrays = [rs.randint(0, 200, (2, 3)).astype(dt) for dt in
              (np.uint8, np.int8, np.int16, np.int32, np.int64)]
    arrays += [rs.randn(4).astype(np.float32), rs.randn(2, 2, 2),
               np.array([True, False, True]), np.asarray(np.float32(2.5))]
    return {"arrays": arrays, "shared": [shared, shared],
            "obj": TorchObject("nn.Linear", {"weight": shared, "p": 0.5,
                                             "name": "fc", "flag": True}),
            "nested": {"a": [1, 2.5, "x", None], "b": {"c": False}},
            "count": 7}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if hasattr(a, "torch_typename"):
        return (a.torch_typename == b.torch_typename
                and _same(a.fields, b.fields))
    return a == b and type(a) is type(b)


def test_t7_round_trip_bytes_and_cross_reading(tmp_path):
    vals = _t7_values()
    mine, theirs = str(tmp_path / "port.t7"), str(tmp_path / "jax.t7")
    save_t7(mine, vals)
    jax_tf.save_t7(theirs, {**vals, "obj": jax_tf.TorchObject(
        "nn.Linear", vals["obj"].fields)})
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for got in (load_t7(mine), load_t7(theirs), jax_tf.load_t7(mine)):
        assert _same(got["nested"], vals["nested"])
        assert got["count"] == 7
        assert got["arrays"][7].dtype == np.uint8  # bools become bytes
        assert got["arrays"][8].shape == () and got["arrays"][8] == 2.5
        for a, b in zip(got["arrays"][:7], vals["arrays"][:7]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        # one heap index: the shared array is one object after reading
        assert got["shared"][0] is got["shared"][1]
        assert got["obj"].fields["weight"] is got["shared"][0]
        assert got["obj"].torch_typename == "nn.Linear"
    with open(mine, "rb") as f:
        head = f.read()[:-5]
    cut = str(tmp_path / "cut.t7")
    with open(cut, "wb") as f:
        f.write(head)
    for reader in (load_t7, jax_tf.load_t7):
        with pytest.raises(EOFError):
            reader(cut)


def _t7(cls, **fields):
    fields.setdefault("_type", "torch.FloatTensor")
    return TorchObject(cls, fields)


def torch7_graph(rs):
    """A Torch7-style module tree (NCHW semantics, OIHW and (out, in)
    weights, 1-based tables) with every class ``_BUILDERS`` maps, cudnn
    names among them, and an NCHW View before a Linear."""
    f32 = np.float32
    ct = np.array([[i % 6 + 1, i % 4 + 1] for i in range(12)], np.float64)

    def bn(c, spatial):
        return _t7("nn.SpatialBatchNormalization" if spatial
                   else "cudnn.BatchNormalization", eps=1e-5, momentum=0.1,
                   running_mean=rs.randn(c).astype(f32),
                   running_var=(rs.rand(c) + 0.5).astype(f32),
                   weight=(1 + 0.1 * rs.randn(c)).astype(f32),
                   bias=rs.randn(c).astype(f32))

    return _t7("nn.Sequential", modules=[
        _t7("cudnn.SpatialConvolution", nInputPlane=3.0, nOutputPlane=6.0,
            kW=3.0, kH=3.0, dW=1.0, dH=1.0, padW=1.0, padH=1.0,
            weight=rs.randn(6, 3, 3, 3).astype(f32) * 0.3,
            bias=rs.randn(6).astype(f32)),
        bn(6, True),
        _t7("cudnn.ReLU", inplace=True),
        _t7("nn.SpatialZeroPadding", pad_l=1.0, pad_r=1.0, pad_t=1.0,
            pad_b=1.0),
        _t7("nn.ConcatTable", modules=[
            _t7("nn.SpatialConvolutionMM", nInputPlane=6.0,
                nOutputPlane=4.0, kW=3.0, kH=3.0,
                weight=rs.randn(4, 54).astype(f32) * 0.2,
                bias=rs.randn(4).astype(f32)),
            _t7("nn.SpatialConvolutionMap", connTable=ct, kW=3.0, kH=3.0,
                nInputPlane=6.0, nOutputPlane=4.0,
                weight=rs.randn(12, 3, 3).astype(f32) * 0.3,
                bias=rs.randn(4).astype(f32))]),
        _t7("nn.CAddTable", inplace=False),
        _t7("nn.Concat", dimension=2.0, modules=[
            _t7("nn.Sequential", modules=[_t7(
                "cudnn.SpatialMaxPooling", kW=3.0, kH=3.0, dW=2.0, dH=2.0,
                padW=1.0, padH=1.0, ceil_mode=False)]),
            _t7("nn.SpatialAveragePooling", kW=2.0, kH=2.0, dW=2.0, dH=2.0,
                padW=0.0, padH=0.0, ceil_mode=True,
                count_include_pad=False)]),
        _t7("nn.Threshold", threshold=0.1, val=-0.5, inplace=False),
        _t7("nn.Dropout", p=0.3, inplace=False),
        _t7("nn.View", size=np.array([8 * 4 * 4], np.int64),
            numElements=128.0),
        _t7("nn.Linear", weight=rs.randn(10, 128).astype(f32) * 0.1,
            bias=rs.randn(10).astype(f32)),
        bn(10, False),
        _t7("nn.Tanh"),
        _t7("nn.Reshape", size=np.array([10], np.int64)),
        _t7("nn.Linear", weight=rs.randn(5, 10).astype(f32),
            bias=rs.randn(5).astype(f32)),
        _t7("cudnn.LogSoftMax")])


def test_hand_built_torch7_graph_loads_in_both(tmp_path):
    rs = np.random.RandomState(4)
    graph = torch7_graph(rs)
    path = str(tmp_path / "graph.t7")
    save_t7(path, graph)
    jm, jp, js = jax_ti.load_torch_module(path)
    tm = load_torch_module(path, device="cpu")
    assert not tm.training
    assert [type(m).__name__ for m in tm] == [
        type(m).__name__ for m in jm._modules]
    assert isinstance(tm[9], TorchFlatten) and tm[9].size == (128,)
    x = rs.randn(2, 8, 8, 3).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    ref = jm.apply(jp, js, jnp.asarray(x))[0]
    assert got.shape == (2, 5)
    _close(got, ref)
    # the parsed tree too, and load_torch_params' JAX-layout tree
    assert _same(load_torch_params(load_t7(path)),
                 jax_tf.load_torch_params(jax_tf.load_t7(path)))


def _small_nets():
    """The same small net in both packages: conv, BN, a Concat of a
    conv branch and a ceil-mode pool branch, an average pool, a CHW
    flatten into a Linear."""
    def build(m, seq):
        return seq(
            m.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1),
            m.SpatialBatchNormalization(8), m.ReLU(),
            m.Concat(seq(m.SpatialConvolution(8, 4, 1, 1), m.ReLU()),
                     seq(m.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(),
                         m.SpatialConvolution(8, 4, 1, 1)), axis=-1),
            m.SpatialAveragePooling(2, 2, 2, 2), m.Reshape([8 * 4 * 4]),
            m.Linear(128, 10), m.Dropout(0.2), m.LogSoftMax())
    return build(jnn, jnn.Sequential), build(nn, nn.Sequential)


def test_save_torch_module_writes_the_jax_file_and_reads_it(tmp_path):
    """On a net the JAX exporter takes, the port writes its bytes exactly;
    the JAX file loads into the port and the port's into the JAX package,
    each with the other's forward."""
    jm, tm = _small_nets()
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(5)))
    state = jax.tree_util.tree_map(np.asarray, jm.init_state())
    state["1"] = {"running_mean": rs.randn(8).astype(np.float32),
                  "running_var": (rs.rand(8) + 0.5).astype(np.float32)}
    load_jax(tm, params, state)
    jpath, tpath = str(tmp_path / "jax.t7"), str(tmp_path / "port.t7")
    jax_ti.save_torch_module(jm, params, state, jpath, example_input=(
        jax.ShapeDtypeStruct((1, 8, 8, 3), np.float32)))
    tm.train()
    save_torch_module(tm, tpath, example_input=torch.zeros(1, 8, 8, 3))
    assert tm.training  # restored
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    x = rs.randn(2, 8, 8, 3).astype(np.float32)
    ref = jm.apply(params, state, jnp.asarray(x))[0]
    with torch.no_grad():
        _close(load_torch_module(jpath, device="cpu")(torch.from_numpy(x)),
               ref)
    m2, p2, s2 = jax_ti.load_torch_module(tpath)
    _close(m2.apply(p2, s2, jnp.asarray(x))[0], ref)
    with pytest.raises(ValueError, match="example_input"):
        save_torch_module(tm, str(tmp_path / "blind.t7"))


def test_alexnet_through_t7_in_the_port(tmp_path):
    """AlexNet through ``.t7``: the port writes its LRN and grouped
    convolutions and reads them back to the same forward. The JAX
    exporter refuses it (no SpatialCrossMapLRN in its set), and the JAX
    importer builds an LRN from the constructor's defaults: both are
    reference-side behaviours."""
    tm = models.alexnet(17, generator=torch.Generator().manual_seed(6))
    path = str(tmp_path / "alexnet.t7")
    save_torch_module(tm, path, example_input=(1, 227, 227, 3))
    back = load_torch_module(path, device="cpu")
    x = torch.from_numpy(np.random.RandomState(6).randn(
        2, 227, 227, 3).astype(np.float32))
    with torch.no_grad():
        _close(back(x), tm.eval()(x))
    lrn = load_t7(path)["modules"][2]
    assert lrn.torch_typename == "nn.SpatialCrossMapLRN"
    assert (lrn["size"], lrn["alpha"], lrn["beta"]) == (5, 1e-4, 0.75)
    assert load_t7(path)["modules"][4]["groups"] == 2
    jm = jax_models.alexnet(17)
    with pytest.raises(ValueError, match="cannot export SpatialCrossMapLRN"):
        jax_ti.save_torch_module(jm, _zeros_tree(jm), jm.init_state(),
                                 str(tmp_path / "j.t7"))
    jlrn = jax_ti.load_torch_module(jax_tf.TorchObject(
        "nn.SpatialCrossMapLRN", {"size": 5.0, "alpha": 1e-4, "beta": 0.75,
                                  "k": 1.0}))[0]
    assert jlrn.alpha == 1.0 and back[2].alpha == 1e-4
