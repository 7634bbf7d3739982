"""The port's autotuner (``bigdl_tpu_torch.tuning``) against the JAX
package's (``bigdl_tpu.tuning``): the cache file's rules, the resolution
ladder in every mode, the key and annotation spellings, byte-identical
dry ``measure`` files for the namespaces whose candidate rules agree, the
surfaces the port's knobs read (the BN plan's slab height, the
key-padding block, the bucket bound, the conv layouts, the int8 product),
and ``--autotune`` through the CLIs. Everything runs on the CPU, where
``measure`` is dry; a timed measurement is faked by replacing the
measure function. Integer decisions and file bytes are compared exactly;
the native-int8 product is held to JAX's bit for bit in f32."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import tuning as jtuning
from bigdl_tpu.ops import conv2d as jconv2d
from bigdl_tpu.serving import quant as jquant
from bigdl_tpu_torch import tuning
from bigdl_tpu_torch.ops import bn_kernel as bk
from bigdl_tpu_torch.ops import conv2d as c2d
from bigdl_tpu_torch.tuning import CACHE_VERSION, AutotuneCache
from bigdl_tpu_torch.tuning import autotune as at


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A private cache directory and pristine tuners and conv policies in
    both packages (all process-global)."""
    monkeypatch.setenv("BIGDL_TPU_AUTOTUNE_CACHE", str(tmp_path))
    for t in (tuning, jtuning):
        t.reset()
    yield tmp_path
    for t in (tuning, jtuning):
        t.reset()
    c2d.reset_conv_pass_layouts()
    jconv2d.reset_conv_pass_layouts()


def _put(key, config, source="measured", **extra):
    cache = tuning.get_cache()
    cache.put(key, dict({"config": config, "source": source}, **extra))
    cache.save()


# ------------------------------------------------------------------ cache
def test_cache_round_trip_and_device_slug(tmp_path):
    c = AutotuneCache("NVIDIA H100 80GB HBM3")
    assert c.path == os.path.join(str(tmp_path), "nvidia-h100-80gb-hbm3.json")
    key = tuning.make_key("flash", seq_q=1024, head_dim=128)
    c.put(key, {"config": {"block_q": 512, "block_k": 256},
                "source": "measured", "best_ms": 1.25})
    c.save()
    assert AutotuneCache("NVIDIA H100 80GB HBM3").get(key) == {
        "config": {"block_q": 512, "block_k": 256}, "source": "measured",
        "best_ms": 1.25}
    assert tuning.device_kind() == "cpu"  # no card here
    assert tuning.cache_path().endswith("cpu.json")
    # no temporary file is left behind by the atomic save
    assert os.listdir(tmp_path) == ["nvidia-h100-80gb-hbm3.json"]


@pytest.mark.parametrize("payload", [
    "{not json", json.dumps({"version": CACHE_VERSION + 1, "entries": {
        "k": {"config": {"row_block": 64}}}}), json.dumps([1, 2])])
def test_corrupt_or_mismatched_file_loads_empty(tmp_path, payload):
    c = AutotuneCache("cpu")
    with open(c.path, "w") as f:
        f.write(payload)
    assert AutotuneCache("cpu").entries == {}
    # and the tuner then falls back to the default and can write anew
    tuning.set_mode("measure")
    assert tuning.kv_page_tokens(1024, 2, 128, torch.bfloat16) == 128
    with open(c.path) as f:
        assert json.load(f)["version"] == CACHE_VERSION


def test_make_key_and_dtype_spelling_match_jax():
    facets = [("flash", dict(seq_q=1024, seq_k=1024, head_dim=128, causal=1,
                             dtype="bfloat16")),
              ("quant", dict(m=16, k=1024, n=32000, dtype="float32")),
              ("conv_geom", {"kh": 7, "pass": "wgrad", "stride": "2x2"})]
    for op, f in facets:
        assert tuning.make_key(op, **f) == jtuning.make_key(op, **f)
    assert at._dtype_name(torch.bfloat16) == "bfloat16"
    assert at._dtype_name(torch.float32) == "float32"
    assert at._dtype_name(np.float32) == "float32"
    geom = (3, 3, 1, 1, 64, 64, 1, 1, 1, "bfloat16")
    assert tuning.conv_geom_key("dgrad", geom) == jtuning.conv_geom_key(
        "dgrad", geom)
    assert tuple(tuning.MODES) == tuple(jtuning.MODES)
    assert tuple(tuning.QUANT_MATMUL_KINDS) == tuple(jtuning.QUANT_MATMUL_KINDS)
    assert set(tuning.__all__) == set(jtuning.__all__)


# ----------------------------------------------------- the shared ladder
def _consult(t, dt):
    """One sequence of consultations over the namespaces whose candidate
    rules agree in both packages; ``dt`` maps a dtype name to the
    package's dtype object."""
    t.grad_bucket_bytes(25 * 2 ** 20 + 3, 2, dt("bfloat16"))
    t.grad_bucket_bytes(3 * 2 ** 20, 4, dt("float16"))
    t.grad_bucket_bytes(1000, 1, dt("bfloat16"))
    t.kv_page_tokens(1024, 2, 128, dt("bfloat16"))
    t.kv_page_tokens(96, 4, 32, dt("float32"))
    t.quant_matmul_kind(16, 1024, 3072, dt("bfloat16"))
    t.quant_matmul_kind(1, 1024, 32000, dt("float32"))
    t.conv_geom_layout("fwd", (7, 7, 2, 2, 3, 64, 1, 1, 1, "bfloat16"),
                       (32, 224, 224, 3), False)
    t.conv_geom_layout("wgrad", (1, 1, 1, 1, 256, 64, 1, 1, 1, "bfloat16"),
                       (32, 56, 56, 256), True)
    for variant in ("plain", "inner", "s2d"):
        t.install_conv_layouts(variant)
    return t.annotation()


_TORCH_DT = {"bfloat16": torch.bfloat16, "float16": torch.float16,
             "float32": torch.float32}
_JAX_DT = {"bfloat16": jnp.bfloat16, "float16": jnp.float16,
           "float32": jnp.float32}


def test_dry_measure_files_are_byte_identical_to_jax(tmp_path, monkeypatch):
    """The same consultations in dry ``measure`` mode write the same bytes
    in both packages; ``cached`` replays them with the file unchanged."""
    files = {}
    for name, t, dt in (("port", tuning, _TORCH_DT),
                        ("jax", jtuning, _JAX_DT)):
        d = tmp_path / name
        monkeypatch.setenv("BIGDL_TPU_AUTOTUNE_CACHE", str(d))
        t.reset()
        t.set_mode("measure")
        ann = _consult(t, dt.get)
        assert all(v["source"] == "dry" for v in ann["decisions"].values())
        path = d / "cpu.json"
        files[name] = (path.read_bytes(), ann)
        t.reset()
        t.set_mode("cached")
        replay = _consult(t, dt.get)
        assert path.read_bytes() == files[name][0]
        assert all(v["source"] == "cached"
                   for v in replay["decisions"].values())
        assert {k: {kk: vv for kk, vv in v.items() if kk != "source"}
                for k, v in replay["decisions"].items()} == \
            {k: {kk: vv for kk, vv in v.items() if kk != "source"}
             for k, v in ann["decisions"].items()}
    assert files["port"][0] == files["jax"][0]
    assert files["port"][1] == files["jax"][1]
    blob = json.loads(files["port"][0])
    assert blob["device_kind"] == "cpu" and len(blob["entries"]) == 12


def test_ladder_in_every_mode(monkeypatch):
    key = tuning.make_key("kv_pages", max_len=1024, kv_heads=2,
                          head_dim=128, dtype="bfloat16")
    # off: the caller's ladder, nothing consulted or written
    assert tuning.kv_page_tokens(1024, 2, 128, torch.bfloat16) is None
    assert tuning.annotation() is None
    assert not os.path.exists(tuning.cache_path())
    # cached miss: the default, recorded as "default", nothing written
    tuning.set_mode("cached")
    assert tuning.kv_page_tokens(1024, 2, 128, torch.bfloat16) == 128
    assert tuning.annotation() == {"mode": "cached",
                                   "decisions": {key: "default"}}
    assert not os.path.exists(tuning.cache_path())
    # measure with a card (faked): the candidates are timed, the winner
    # persisted with its best_ms; a dry placeholder is measured again
    calls = []

    def fake_measure(max_len, kv_heads, head_dim, dtype, cands):
        calls.append(tuple(cands))
        return {"page_tokens": 64}, 0.123456

    from bigdl_tpu_torch.tuning import measure
    monkeypatch.setattr(measure, "measure_kv_page_tokens", fake_measure)
    monkeypatch.setattr(at, "dry_run", lambda: False)
    _put(key, {"page_tokens": 128}, source="dry")
    tuning.set_mode("measure")
    assert tuning.kv_page_tokens(1024, 2, 128, torch.bfloat16) == 64
    assert calls == [(32, 64, 128, 256)]
    ent = AutotuneCache().get(key)
    assert ent == {"config": {"page_tokens": 64}, "source": "measured",
                   "best_ms": 0.1235}
    # a measured entry is a hit: nothing is timed again
    assert tuning.kv_page_tokens(1024, 2, 128, torch.bfloat16) == 64
    assert len(calls) == 1
    assert tuning.annotation()["decisions"][key] == {"page_tokens": 64,
                                                     "source": "cached"}
    tuning.reset_decisions()
    assert tuning.annotation() == {"mode": "measure", "decisions": {}}
    with pytest.raises(ValueError, match="autotune mode must be one of"):
        tuning.set_mode("fast")


# ------------------------------------------------------ the BN slab plan
def _seed_plan(mode, rows, c, vec, ctas):
    """The launch plan as the port computed it before the tuner came."""
    groups = -(-c // vec)
    tx = 1
    while tx < min(32, groups):
        tx *= 2
    ty = bk._NTHREADS // tx
    blocks = -(-c // (tx * vec))
    slabs = max(1, min(ctas // blocks, rows // (bk._SLAB_ROWS * ty)))
    slab = -(-rows // slabs)
    slabs = -(-rows // slab)
    once = mode in (bk._STATS, bk._BWD_STATS) or (
        blocks * slabs <= ctas and -(-slab // ty) <= bk._SLOTS[mode])
    return bk.Plan(tx, blocks, slabs, slab, min(ctas, blocks * slabs), once)


def _vec(c, elem):
    vec = 16 // elem
    while vec > 1 and c % vec:
        vec //= 2
    return vec


@pytest.fixture(scope="module")
def bn_shapes():
    """(rows, C) of every BN shape chip_smoke.py's phases 7 and 17-18 run:
    ResNet-50 at batch 128, VGG-for-CIFAR at 128 and Inception-v2's 57 BNs
    at batch 32 (rows scale with the batch: found at batch 1)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import inception_v2

    shapes = {(b * h * w, c) for b, h, w, c in (
        (128, 112, 112, 64), (128, 56, 56, 256), (128, 28, 28, 512),
        (128, 7, 7, 2048), (10, 10, 10, 100), (128, 32, 32, 64),
        (128, 16, 16, 128), (128, 8, 8, 256), (128, 4, 4, 512),
        (128, 2, 2, 512), (128, 1, 1, 512), (401408 // 3136, 56, 56, 256))}
    model = inception_v2(1000, generator=torch.Generator().manual_seed(0))
    seen = []
    hooks = [m.register_forward_hook(lambda mod, a, out: seen.append(
        tuple(a[0].shape))) for m in model.modules()
        if isinstance(m, nn.BatchNormalization)]
    with torch.no_grad():
        model.eval()(torch.zeros(1, 224, 224, 3))
    for h in hooks:
        h.remove()
    assert len(seen) == 57
    shapes |= {(32 * int(np.prod(s[:-1])), s[-1]) for s in seen}
    return sorted(shapes)


def test_plan_under_off_is_the_untuned_plan(bn_shapes):
    tuning.set_mode("off")
    n = 0
    for rows, c in bn_shapes:
        for elem in (2, 4):
            vec = _vec(c, elem)
            for ctas in (132, 264, 396, 528):
                for mode in range(4):
                    assert bk._plan(mode, rows, c, vec, ctas) == \
                        _seed_plan(mode, rows, c, vec, ctas)
                    assert bk._plan(mode, rows, c, vec, ctas, None) == \
                        _seed_plan(mode, rows, c, vec, ctas)
                    n += 1
    assert n > 1000
    x = torch.zeros(128, 512, dtype=torch.bfloat16)
    assert bk._tuned_slab(bk._FWD, x, 8, True) is None  # off: untuned


def test_every_tuned_plan_keeps_its_ctas_resident(bn_shapes):
    seen = 0
    for rows, c in bn_shapes:
        for elem in (2, 4):
            vec = _vec(c, elem)
            for ctas in (132, 264, 528):
                for mode in range(4):
                    hs = bk.slab_heights(mode, rows, c, vec, ctas)
                    base = bk._plan(mode, rows, c, vec, ctas)
                    if base.blocks > ctas:
                        assert hs == ()
                        continue
                    assert hs[0] == base.slab and len(set(hs)) == len(hs)
                    for h in hs:
                        p = bk._plan(mode, rows, c, vec, ctas, h)
                        assert p.blocks * p.slabs <= ctas
                        assert p.grid == p.blocks * p.slabs
                        assert p.slab == h and p.slabs * h >= rows
                        seen += 1
    assert seen > 5000
    # VGG's few-row shape gains candidates of more CTAs a channel block
    hs = bk.slab_heights(bk._FWD, 128, 512, 8, 264)
    assert hs[0] == 64 and min(hs) == 1


def test_bn_surfaces_replay_a_height_only_where_it_is_legal():
    heights = bk.slab_heights(bk._STATS, 128, 512, 8, 264)
    tuning.set_mode("cached")
    assert tuning.bn_row_block(128, 512, torch.bfloat16, heights) is None
    key = tuning.make_key("bn_stats", rows=128, channels=512,
                          dtype="bfloat16")
    assert tuning.annotation()["decisions"] == {key: "default"}
    _put(key, {"row_block": heights[-1]})
    tuning.reset()
    tuning.set_mode("cached")
    assert tuning.bn_row_block(128, 512, torch.bfloat16,
                               heights) == heights[-1]
    _put(key, {"row_block": 7})  # not a height of this card: untuned
    tuning.reset()
    tuning.set_mode("cached")
    assert tuning.bn_row_block(128, 512, torch.bfloat16, heights) is None
    fkey = tuning.make_key("bn_fba", rows=128, channels=512,
                           dtype="bfloat16", relu=1)
    _put(fkey, {"row_block": 16})
    tuning.reset()
    tuning.set_mode("cached")
    assert tuning.fba_row_block(128, 512, torch.bfloat16, True,
                                (64, 128, 16)) == 16
    with bk.pinned_slab(32):  # the tuner's own timing pins the height
        assert bk._tuned_slab(bk._FWD, torch.zeros(128, 512), 4, True) == 32


# ------------------------------------------------------- the other knobs
def test_flash_block_k_reads_the_decision():
    from bigdl_tpu_torch.ops.attention_kernel import flash_block_k

    assert flash_block_k(1024, 1024, 32, True, torch.float32) == 512
    tuning.set_mode("cached")
    key = tuning.make_key("flash", seq_q=1024, seq_k=1024, head_dim=32,
                          causal=1, dtype="float32")
    _put(key, {"block_q": 512, "block_k": 256})
    tuning.reset()
    tuning.set_mode("cached")
    assert flash_block_k(1024, 1024, 32, True, torch.float32) == 256
    assert flash_block_k(1024) == 512  # no facets: the untuned rule
    # a ragged length admits no tiling: the untuned rule (the dense path)
    assert flash_block_k(1000, 1000, 32, True, torch.float32) == 512
    # measure (dry): the default is recorded, block_q too
    tuning.set_mode("measure")
    assert tuning.flash_blocks(768, 768, 64, False, torch.bfloat16) == \
        (256, 256)
    assert jtuning.flash_blocks(768, 768, 64, False, jnp.bfloat16) is None


def test_grad_buckets_auto_asks_the_tuner():
    from bigdl_tpu_torch.parallel.grad_comm import (DEFAULT_BUCKET_BYTES,
                                                    _resolve_bucket_bytes,
                                                    make_config)

    assert _resolve_bucket_bytes(None, 40 * 2 ** 20, 2) == (
        DEFAULT_BUCKET_BYTES, "default")
    key = tuning.make_key("grad_comm", param_mib=40, n_devices=2,
                          dtype="bfloat16")
    _put(key, {"bucket_bytes": 8 * 2 ** 20})
    tuning.set_mode("cached")
    assert _resolve_bucket_bytes(None, 40 * 2 ** 20, 2) == (8 * 2 ** 20,
                                                            "autotune")
    explicit = make_config("bf16", "2")
    assert _resolve_bucket_bytes(explicit, 40 * 2 ** 20, 2) == (
        2 * 2 ** 20, "explicit")


def test_conv_decisions_follow_the_precedence(tmp_path):
    from bigdl_tpu_torch import nn

    conv = nn.SpatialConvolution(4, 6, 3, 3, 1, 1, 1, 1,
                                 generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 5, 4, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    ref = conv(x)
    assert not c2d.policy_active()
    geom = (3, 3, 1, 1, 4, 6, 1, 1, 1, "float32")
    for p, lay in (("fwd", "NCHW"), ("dgrad", "NHWC"), ("wgrad", "NCHW")):
        _put(tuning.conv_geom_key(p, geom), {"layout": lay})
    tuning.set_mode("cached")
    assert c2d.policy_active()
    out = conv(x)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    ann = tuning.annotation()["decisions"]
    assert ann[tuning.conv_geom_key("fwd", geom)] == {"layout": "NCHW",
                                                      "source": "cached"}
    assert c2d.resolve_site_layouts(3, 3, (1, 1), ((1, 1), (1, 1)), (1, 1),
                                    1, 4, 6, "float32") == {
        "fwd": "NCHW", "dgrad": "NHWC", "wgrad": "NCHW"}
    # an installed --convGeom decision wins over the tuner, --convLayout
    # over both
    c2d.install_geom_decisions([{"geom": c2d.geom_to_json(geom),
                                 "layouts": {"fwd": "GEMM"}}])
    assert c2d.resolve_site_layouts(3, 3, (1, 1), ((1, 1), (1, 1)), (1, 1),
                                    1, 4, 6, "float32")["fwd"] == "NHWC"
    c2d.install_layout_spec("NHWC,NCHW,NHWC")
    assert c2d.resolve_site_layouts(3, 3, (1, 1), ((1, 1), (1, 1)), (1, 1),
                                    1, 4, 6, "float32") == {
        "fwd": "NHWC", "dgrad": "NCHW", "wgrad": "NHWC"}


def test_install_conv_layouts_off_mode_matches_jax():
    for variant in ("plain", "inner", "s2d"):
        assert tuning.install_conv_layouts(variant) == \
            jtuning.install_conv_layouts(variant)
    c2d.install_layout_spec("GEMM,NCHW,NHWC")
    tuning.set_mode("cached")
    assert tuning.install_conv_layouts("inner") == {
        "fwd": "GEMM", "dgrad": "NCHW", "wgrad": "NHWC"}  # explicit wins
    with pytest.raises(ValueError, match="conv variant"):
        tuning.install_conv_layouts("fused")


# --------------------------------------------------------- native int8
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_native_int8_product_matches_jax(tmp_path, dtype):
    """Under a cache entry that says native-int8 (one file both packages
    read), the port's quantized product equals the JAX one: bit for bit
    in f32; in bf16 within one bf16 ulp of the output's scale, since the
    JAX cast of the int32 sum to bf16 may round through f32 differently."""
    rs = np.random.RandomState(0)
    w = rs.randn(32, 24).astype(np.float32)
    x = rs.randn(2, 12, 32).astype(np.float32)
    key = tuning.make_key("quant", m=12, k=32, n=24, dtype=dtype)
    _put(key, {"kind": "native-int8"})
    tuning.set_mode("cached")
    jtuning.set_mode("cached")
    from bigdl_tpu_torch.serving import quant as q
    tw = q.quantize_weight(torch.from_numpy(w), "int8")
    jw = jquant.quantize_weight(jnp.asarray(w), "int8")
    tdt, jdt = _TORCH_DT[dtype], _JAX_DT[dtype]
    got = (torch.from_numpy(x).to(tdt) @ tw.to(tdt)).float().numpy()
    want = np.asarray((jnp.asarray(x).astype(jdt) @ jw.astype(jdt))
                      .astype(jnp.float32))
    assert tuning.annotation()["decisions"][key] == {
        "kind": "native-int8", "source": "cached"}
    assert jtuning.annotation()["decisions"][key] == {
        "kind": "native-int8", "source": "cached"}
    dq = ((torch.from_numpy(x) @ tw.q.float()) * tw.scale).numpy()
    assert np.abs(got - dq).max() > 0  # the activation really went int8
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    # a decode step's 2 rows: torch._int_mm takes no product of <= 16
    # rows on the card, so the cached kind yields to dequant
    assert tuning.quant_matmul_kind(1, 32, 24, tdt, rows=2) == "dequant"
    small = (torch.from_numpy(x[:, :1]).to(tdt) @ tw.to(tdt)).float()
    ref = (torch.from_numpy(x[:, :1]).to(tdt) @ tw.q.to(tdt)) * \
        tw.scale.to(tdt)
    np.testing.assert_array_equal(small.numpy(), ref.float().numpy())


# ------------------------------------------------------------ the CLIs
def test_training_clis_and_perf_parse_autotune():
    import argparse

    from bigdl_tpu_torch.cli import common, perf, serve

    p = argparse.ArgumentParser()
    common.add_train_args(p)
    assert p.parse_args([]).autotune == "off"
    args = p.parse_args(["--autotune", "cached"])
    common.apply_autotune(args)
    assert tuning.get_mode() == "cached"
    with pytest.raises(SystemExit):
        p.parse_args(["--autotune", "fast"])
    with pytest.raises(SystemExit, match="autotune mode must be one of"):
        common.apply_autotune(argparse.Namespace(autotune="fast"))
    assert common.AUTOTUNE_CHOICES == tuning.MODES
    assert serve.build_parser().parse_args(
        ["resnet50", "--autotune", "measure"]).autotune == "measure"
    from bigdl_tpu_torch.cli import lenet, resnet, transformerlm
    for mod, argv in ((lenet, ["train"]), (resnet, ["train"]),
                      (transformerlm, ["train"])):
        src = open(mod.__file__).read()
        assert "add_train_args" in src, mod.__name__
    assert "add_autotune_arg(p)" in open(perf.__file__).read()


def test_perf_line_carries_the_decisions_it_ran_under():
    from bigdl_tpu_torch.cli import perf

    off = perf.run("resnet20_cifar", batch=2, iterations=1, warmup=1,
                   device="cpu", dtype=torch.float32, fused_bn="apply")
    assert "autotune" not in off
    out = perf.run("resnet20_cifar", batch=2, iterations=1, warmup=1,
                   device="cpu", dtype=torch.float32, fused_bn="apply",
                   autotune="cached")
    ann = out["autotune"]
    assert ann["mode"] == "cached"
    keys = sorted(ann["decisions"])
    assert "conv_layouts|variant=plain" in keys
    geoms = [k for k in keys if k.startswith("conv_geom|")]
    # resnet20_cifar's 21 convs in 7 geometries, three passes each (the
    # stem's dgrad too: its input is no leaf, but the FLOP count's fake
    # pass reads only); the default everywhere on an empty cache
    assert len(geoms) >= 7 and all(ann["decisions"][k] == "default"
                                   for k in keys)
    assert off["losses"] == out["losses"]  # the same program
    assert tuning.get_mode() == "cached"
    assert not c2d.policy_snapshot()[2]  # the run restored the policy
