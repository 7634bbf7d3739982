"""The port's conv layout policy (bigdl_tpu_torch/ops/conv2d.py) against
the JAX package's (bigdl_tpu/ops/conv2d.py): the same numpy inputs from a
seed through both packages' ``conv2d`` under the same installed policy,
output and both gradients (f32, atol 1e-5); the same precedence, spec
parsing, probe decisions and decision files; ``nn.SpatialConvolution``
through the policy against the JAX module; the CLI flags' exits."""

import argparse
import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.ops import conv2d as jc2d
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import load_jax
from bigdl_tpu_torch.ops import conv2d as tc2d

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _pristine():
    """Both packages' process-global policies reset around each test."""
    jc2d.reset_conv_pass_layouts()
    tc2d.reset_conv_pass_layouts()
    yield
    jc2d.reset_conv_pass_layouts()
    tc2d.reset_conv_pass_layouts()


def _both(fn_name, *args):
    """Call ``fn_name`` in both packages with the same arguments."""
    return getattr(jc2d, fn_name)(*args), getattr(tc2d, fn_name)(*args)


def _geom_json(kh, kw, stride, cin, cout, dtype="float32"):
    return {"kh": kh, "kw": kw, "stride": [stride, stride], "cin": cin,
            "cout": cout, "groups": 1, "dilation": [1, 1], "dtype": dtype}


def _jax_run(x, w_hwio, stride, padding):
    """(y, dx, dw) of sum(conv**2) through the JAX policy conv."""
    args = (stride, padding, (1, 1), 1)

    def loss(a, b):
        return jnp.sum(jc2d.conv2d(a, b, *args) ** 2)

    x, w = jnp.asarray(x), jnp.asarray(w_hwio)
    y = jc2d.conv2d(x, w, *args)
    dx, dw = jax.grad(loss, argnums=(0, 1))(x, w)
    return [np.asarray(v) for v in (y, dx, dw)]


def _port_run(x, w_hwio, stride, padding):
    """(y, dx, dw in HWIO) of sum(conv**2) through the port's policy
    conv."""
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)),
                      requires_grad=True)
    y = tc2d.conv2d(xt, wt, stride, padding, (1, 1), 1)
    (y ** 2).sum().backward()
    return [y.detach().numpy(), xt.grad.numpy(),
            wt.grad.permute(2, 3, 1, 0).numpy()]


def _inputs(seed, x_shape, w_shape):
    rs = np.random.RandomState(seed)
    return (rs.randn(*x_shape).astype(np.float32),
            rs.randn(*w_shape).astype(np.float32))


def _install(decisions):
    assert jc2d.install_geom_decisions(decisions) == \
        tc2d.install_geom_decisions(decisions)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("pass_name,layout", list(itertools.product(
    ("fwd", "dgrad", "wgrad"), ("NHWC", "NCHW", "GEMM"))))
def test_one_pass_one_layout_f32(pass_name, layout):
    x, w = _inputs(0, (2, 6, 6, 8), (1, 1, 8, 16))
    _install([{"geom": _geom_json(1, 1, 1, 8, 16),
               "layouts": {pass_name: layout}}])
    assert tc2d.policy_active()
    pad = ((0, 0), (0, 0))
    _close(_port_run(x, w, (1, 1), pad), _jax_run(x, w, (1, 1), pad))


@pytest.mark.parametrize("layouts,k,stride,pad", [
    ({"fwd": "GEMM", "dgrad": "NCHW", "wgrad": "GEMM"}, 1, 1, 0),
    ({"fwd": "NCHW", "dgrad": "NHWC", "wgrad": "NCHW"}, 3, 2, 1),
    ({"fwd": "NHWC", "dgrad": "NCHW", "wgrad": "NCHW"}, 3, 1, 1)])
def test_mixed_layouts_f32(layouts, k, stride, pad):
    x, w = _inputs(1, (2, 8, 8, 4), (k, k, 4, 6))
    _install([{"geom": _geom_json(k, k, stride, 4, 6),
               "layouts": layouts}])
    p = ((pad, pad), (pad, pad))
    _close(_port_run(x, w, (stride, stride), p),
           _jax_run(x, w, (stride, stride), p))


def test_gemm_ineligible_site_falls_back_exactly():
    """A GEMM decision at a 3x3/stride-2 padded site is NHWC: the port's
    numbers equal its default path's bit for bit (and JAX's)."""
    x, w = _inputs(4, (2, 8, 8, 4), (3, 3, 4, 4))
    p = ((1, 1), (1, 1))
    tc2d.set_conv_pass_layouts("NHWC", "NHWC", "NHWC")
    ref = _port_run(x, w, (2, 2), p)
    tc2d.reset_conv_pass_layouts()
    _install([{"geom": _geom_json(3, 3, 2, 4, 4),
               "layouts": {"fwd": "GEMM", "dgrad": "GEMM",
                           "wgrad": "GEMM"}}])
    assert tc2d.resolve_site_layouts(3, 3, (2, 2), p, (1, 1), 1, 4, 4,
                                     "float32") == dict.fromkeys(
        ("fwd", "dgrad", "wgrad"), "NHWC")
    got = _port_run(x, w, (2, 2), p)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    _close(got, _jax_run(x, w, (2, 2), p))


@pytest.mark.parametrize("case", ["explicit_beats_geometry",
                                  "geometry_beats_global",
                                  "global_where_no_geometry",
                                  "gemm_spec_at_ineligible_site"])
def test_precedence(case):
    """Explicit spec > per-geometry decision > global triple, resolved the
    same way by both packages."""
    geom = [{"geom": _geom_json(1, 1, 1, 4, 4, "bfloat16"),
             "layouts": {"fwd": "GEMM"}}]
    site = (1, 1, (1, 1), ((0, 0), (0, 0)), (1, 1), 1, 4, 4, "bfloat16")
    if case == "explicit_beats_geometry":
        _install(geom)
        _both("set_conv_pass_layouts", "NCHW", "NHWC", "NCHW")
    elif case == "geometry_beats_global":
        # a global triple installed without the explicit flag (a measured
        # device default): a geometry entry wins over it
        snap = ({"fwd": "NCHW", "dgrad": "NCHW", "wgrad": "NCHW"}, False, {})
        _both("restore_policy", snap)
        _install(geom)
    elif case == "global_where_no_geometry":
        _install(geom)
        site = (1, 1, (1, 1), ((0, 0), (0, 0)), (1, 1), 1, 4, 8,
                "bfloat16")
    else:
        _both("install_layout_spec", "GEMM,GEMM,GEMM")
        site = (3, 3, (1, 1), ((1, 1), (1, 1)), (1, 1), 1, 4, 4, "bfloat16")
    j, t = _both("resolve_site_layouts", *site)
    assert j == t
    want = {"explicit_beats_geometry": {"fwd": "NCHW", "dgrad": "NHWC",
                                        "wgrad": "NCHW"},
            "geometry_beats_global": {"fwd": "GEMM", "dgrad": "NCHW",
                                      "wgrad": "NCHW"},
            "global_where_no_geometry": dict.fromkeys(
                ("fwd", "dgrad", "wgrad"), "NHWC"),
            "gemm_spec_at_ineligible_site": dict.fromkeys(
                ("fwd", "dgrad", "wgrad"), "NHWC")}[case]
    assert t == want


@pytest.mark.parametrize("spec", ["auto", "default", "NHWC,NCHW,GEMM",
                                  " nchw,nhwc,gemm ", "", None])
def test_spec_parser_accepts(spec):
    j, t = _both("resolve_layout_spec", spec)
    assert j == t


@pytest.mark.parametrize("spec", ["NHWC,GEM,NHWC", "NHWC,NHWC",
                                  "NHWC,NHWC,NHWC,NHWC", "fast"])
def test_spec_parser_rejects_with_the_jax_message(spec):
    with pytest.raises(ValueError) as je:
        jc2d.resolve_layout_spec(spec)
    with pytest.raises(ValueError) as te:
        tc2d.resolve_layout_spec(spec)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as je:
        jc2d.set_conv_pass_layouts("NHWC", "nchw", "NHWC")
    with pytest.raises(ValueError) as te:
        tc2d.set_conv_pass_layouts("NHWC", "nchw", "NHWC")
    assert str(te.value) == str(je.value)


def _synthetic_probe_lines():
    rows = []
    for k, cin, cout in ((1, 64, 256), (3, 64, 64), (7, 3, 64)):
        for i, lay in enumerate(("NHWC", "NCHW", "GEMM")):
            if lay == "GEMM" and k != 1:
                continue
            row = {"shape": f"k{k}", "layout": lay, "kh": k, "kw": k,
                   "stride": [1, 1], "cin": cin, "cout": cout, "groups": 1,
                   "dilation": [1, 1], "dtype": "bfloat16"}
            for j, p in enumerate(("fwd", "dgrad", "wgrad")):
                row[f"{p}_ms"] = 1.0 + ((i + j + k) % 3) * 0.25
            rows.append(json.dumps(row))
    return rows + ["not json", "{broken"]


@pytest.mark.parametrize("source", ["archive", "synthetic"])
def test_probe_decisions_match(source):
    lines = ((ROOT / "CONV_PROBE_r05.jsonl").read_text().splitlines()
             if source == "archive" else _synthetic_probe_lines())
    jd, td = _both("decide_geom_from_probe", lines)
    assert jd == td and td
    if source == "archive":
        j, t = _both("decide_from_probe", lines)
        assert j == t
        j, t = _both("probe_totals", lines)
        assert j == t
    # the decisions install and round-trip the same way
    _install(td)
    assert jc2d.geom_policy_if_any() == tc2d.geom_policy_if_any()


def test_probe_rejections_match():
    for lines in (["no rows"], [json.dumps({"layout": "NHWC",
                                            "shape": "unknown"})]):
        with pytest.raises(ValueError) as je:
            jc2d.decide_geom_from_probe(lines)
        with pytest.raises(ValueError) as te:
            tc2d.decide_geom_from_probe(lines)
        assert str(te.value) == str(je.value)
    trunc = [json.dumps({"layout": "NHWC", "fwd_ms": 1.0})]
    with pytest.raises(ValueError) as je:
        jc2d.decide_from_probe(trunc)
    with pytest.raises(ValueError) as te:
        tc2d.decide_from_probe(trunc)
    assert str(te.value) == str(je.value)


def test_jax_decision_file_read_by_the_port(tmp_path):
    """A file in the JAX ``--convGeom`` format (what its apply_conv_probe
    --geom writes) installs the same table in the port."""
    decisions = [{"geom": _geom_json(7, 7, 2, 3, 64, "bfloat16"),
                  "layouts": {"wgrad": "NCHW"}},
                 {"geom": _geom_json(1, 1, 1, 256, 64, "bfloat16"),
                  "layouts": {"fwd": "GEMM", "dgrad": "GEMM"}}]
    jc2d.install_geom_decisions(decisions)
    path = tmp_path / "geom.json"
    path.write_text(json.dumps({"decisions": jc2d.geom_policy_if_any()},
                               indent=1, sort_keys=True))
    assert tc2d.install_geom_file(str(path)) == 2
    assert tc2d.geom_policy_if_any() == jc2d.geom_policy_if_any()
    tc2d.clear_geom_policy()
    path.write_text(json.dumps(decisions))  # the bare-list spelling
    assert tc2d.install_geom_file(str(path)) == 2
    assert tc2d.geom_policy_if_any() == jc2d.geom_policy_if_any()


def test_install_rejects_bad_decision_with_the_jax_message():
    for bad in ([{"geom": _geom_json(1, 1, 1, 4, 4),
                  "layouts": {"fwd": "FAST"}}],
                [{"geom": {"kh": 1}, "layouts": {"fwd": "NHWC"}}]):
        with pytest.raises(ValueError) as je:
            jc2d.install_geom_decisions(bad)
        with pytest.raises(ValueError) as te:
            tc2d.install_geom_decisions(bad)
        assert str(te.value) == str(je.value)


def test_snapshot_restore_mixed_state():
    """Global triple and per-geometry table round-trip together; a legacy
    two-tuple restores with an empty table (both packages alike)."""
    _install([{"geom": _geom_json(1, 1, 1, 8, 8),
               "layouts": {"fwd": "GEMM"}}])
    _both("set_conv_pass_layouts", "NHWC", "NHWC", "NCHW")
    snaps = _both("policy_snapshot")
    assert snaps[0] == snaps[1]
    _both("reset_conv_pass_layouts")
    assert not tc2d.policy_active()
    j, t = jc2d.restore_policy(snaps[0]), tc2d.restore_policy(snaps[1])
    assert j == t and tc2d.geom_policy_if_any() == jc2d.geom_policy_if_any()
    assert tc2d.policy_active() and tc2d.conv_layouts_if_nondefault() == \
        {"fwd": "NHWC", "dgrad": "NHWC", "wgrad": "NCHW"}
    legacy = ({"fwd": "NCHW", "dgrad": "NHWC", "wgrad": "NHWC"}, True)
    assert jc2d.restore_policy(legacy) == tc2d.restore_policy(legacy)
    assert tc2d.geom_policy_if_any() is None is jc2d.geom_policy_if_any()
    assert tc2d.MEASURED_DECISIONS == {}


def test_legacy_probe_names_and_geometry_keys():
    assert tc2d.LEGACY_PROBE_SHAPES == jc2d.LEGACY_PROBE_SHAPES
    g = (3, 3, 2, 2, 64, 128, 1, 1, 1, "bfloat16")
    assert tc2d.geom_to_json(g) == jc2d.geom_to_json(g)
    assert tc2d.geom_from_json(tc2d.geom_to_json(g)) == g
    for args in ((1, 1, (1, 1), ((0, 0), (0, 0)), (1, 1), 1),
                 (1, 1, (2, 2), ((0, 0), (0, 0)), (1, 1), 1),
                 (1, 1, (1, 1), ((1, 0), (0, 0)), (1, 1), 1),
                 (1, 1, (1, 1), "VALID", (1, 1), 1),
                 (1, 1, (1, 1), ((0, 0), (0, 0)), (1, 1), 2),
                 (3, 3, (1, 1), ((0, 0), (0, 0)), (1, 1), 1)):
        j, t = _both("gemm_eligible", *args)
        assert j == t


@pytest.mark.parametrize("layouts", [
    {"fwd": "GEMM", "dgrad": "GEMM", "wgrad": "NCHW"},
    {"fwd": "NCHW", "dgrad": "NCHW", "wgrad": "GEMM"}])
def test_spatial_convolution_through_the_policy(layouts):
    """nn.SpatialConvolution (1x1, bias) routes through the policy conv
    and matches the JAX module under the same decisions, weights carried
    over with from_jax."""
    jm = jnn.SpatialConvolution(8, 16, 1, 1)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tnn.SpatialConvolution(8, 16, 1, 1)
    load_jax(tm, params)
    x = np.random.RandomState(6).randn(2, 5, 5, 8).astype(np.float32)
    _install([{"geom": _geom_json(1, 1, 1, 8, 16), "layouts": layouts}])
    assert tc2d.policy_active() and jc2d.policy_active()

    def jloss(p):
        y, _ = jm.apply(p, {}, jnp.asarray(x), training=True, rng=None)
        return jnp.sum(y ** 2), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    y = tm(torch.from_numpy(x))
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(tm.weight.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(jg["weight"]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(jg["bias"]),
                               rtol=1e-5, atol=1e-4)


def test_default_policy_keeps_the_single_op_path():
    """No flag: SpatialConvolution never enters the policy Function."""
    calls = []
    orig = tc2d._Conv2d.apply
    tc2d._Conv2d.apply = lambda *a: calls.append(1) or orig(*a)
    try:
        m = tnn.SpatialConvolution(4, 4, 3, 3, 1, 1, 1, 1)
        m(torch.zeros(1, 5, 5, 4))
        assert not calls
        tc2d.install_layout_spec("NCHW,NCHW,NCHW")
        m(torch.zeros(1, 5, 5, 4))
        assert calls
    finally:
        tc2d._Conv2d.apply = orig


def test_cli_flags_exit_with_the_jax_messages(tmp_path):
    from bigdl_tpu_torch.cli import common
    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.cli import resnet as resnet_cli

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"geom": _geom_json(1, 1, 1, 4, 4),
                                "layouts": {"fwd": "FAST"}}]))
    with pytest.raises(ValueError) as je:
        jc2d.install_geom_file(str(bad))
    want = f"--convGeom {bad}: {je.value}"
    with pytest.raises(SystemExit, match=None) as te:
        perf.main(["-m", "resnet20_cifar", "-b", "2", "-i", "1",
                   "--platform", "cpu", "--convGeom", str(bad)])
    assert str(te.value) == want
    with pytest.raises(SystemExit) as te:
        resnet_cli.main(["train", "-f", str(tmp_path), "--platform", "cpu",
                         "--convGeom", str(tmp_path / "missing.json")])
    assert str(te.value).startswith(f"--convGeom {tmp_path}/missing.json: ")
    with pytest.raises(ValueError) as je:
        jc2d.resolve_layout_spec("NHWC,BAD,NHWC")
    with pytest.raises(SystemExit) as te:
        resnet_cli.main(["train", "-f", str(tmp_path), "--platform", "cpu",
                         "--convLayout", "NHWC,BAD,NHWC"])
    assert str(te.value) == str(je.value)
    # every training CLI parses the flags; a good pair installs geometry
    # first and lets the spec win
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"decisions": [
        {"geom": _geom_json(1, 1, 1, 4, 4), "layouts": {"fwd": "GEMM"}}]}))
    p = argparse.ArgumentParser()
    common.add_train_args(p)
    args = p.parse_args(["--convGeom", str(good), "--convLayout",
                         "NCHW,NCHW,NCHW"])
    common.apply_conv_args(args)
    assert tc2d.geom_policy_if_any() and tc2d.resolve_site_layouts(
        1, 1, (1, 1), ((0, 0), (0, 0)), (1, 1), 1, 4, 4, "float32") == \
        dict.fromkeys(("fwd", "dgrad", "wgrad"), "NCHW")
