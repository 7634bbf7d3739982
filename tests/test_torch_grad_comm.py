"""The port's gradient communication and data-parallel CLI surface
(``bigdl_tpu_torch.parallel.grad_comm``, ``cli.common``'s strategy flags,
``cli.perf --strategy dp``) against the JAX package's, on the CPU.

In this process: the constants and the flag parsing with the JAX errors;
bucket plans equal to the JAX plans by membership, element counts, byte
totals and wire bytes for the ResNet-20, ResNet-50 and LM trees (shapes
differ where torch lays a conv weight out otherwise, so signatures are not
compared); bf16 and fp16 compression bit for bit the JAX cast and clamp;
the one-process exits. In 2 gloo ranks (tests/torch_dp_cases.py, started
with a time limit): 50 steps of the JAX convergence problem uncompressed
(equal to one process and to JAX's 8-device run, rel 1e-5), bf16 and fp16
(JAX's bar: rel 0.05 of f32 and a loss under 0.5) and bf16+ec (error
feedback: within rel 1e-4 of f32); ``cli.perf.run(strategy="dp")``'s
columns and parity; ``build_strategy``'s config and exits; and
``cli.transformerlm train --strategy dp``."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_cases as C
from bigdl_tpu import models as jax_models
from bigdl_tpu.parallel import grad_comm as jgc
from bigdl_tpu.parallel import local_mesh as jax_local_mesh
from bigdl_tpu_torch import models
from bigdl_tpu_torch.cli import common
from bigdl_tpu_torch.parallel import grad_comm as tgc
from bigdl_tpu_torch.parallel.launch import spawn

JOB_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("gc")
    corpus = root / "corpus"
    corpus.mkdir()
    words = np.random.RandomState(0).choice(
        ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "far"], 900)
    (corpus / "input.txt").write_text(
        " ".join(w + ("." if i % 9 == 8 else "") for i, w in
                 enumerate(words)))
    np.savez(root / "inputs.npz", **{"cli/folder": np.array(str(corpus))})
    res = spawn("torch_dp_cases:run_all", 2,
                {"inputs": str(root / "inputs.npz"), "out": str(root),
                 "cases": ["conv", "perf", "cli"]}, timeout_s=JOB_TIMEOUT_S,
                backend="gloo",
                env={"PYTHONPATH": C.__file__.rsplit("/", 1)[0]})
    return root, res


def test_constants_match_jax():
    assert tgc.COMPRESS_MODES == jgc.COMPRESS_MODES
    assert common.GRAD_COMPRESS_CHOICES == tgc.COMPRESS_MODES
    assert tgc.DEFAULT_BUCKET_BYTES == jgc.DEFAULT_BUCKET_BYTES
    assert tgc._F16_MAX == jgc._F16_MAX


@pytest.mark.parametrize("compress,buckets", [
    ("off", None), ("off", "auto"), ("bf16", None), ("FP16+ec", "auto"),
    ("bf16+ec", "2"), ("off", "3"), ("junk", None), ("bf16", "zero"),
    ("bf16", "0"), (None, " 7 ")])
def test_make_config_matches_jax(compress, buckets):
    def call(mod):
        try:
            return mod.make_config(compress, buckets)
        except ValueError as e:
            return ("error", str(e))

    got, want = call(tgc), call(jgc)
    if isinstance(want, tuple) or want is None:
        assert got == want
    else:
        assert (got.compress, got.bucket_bytes, got.active, got.wire_dtype,
                got.error_comp) == (want.compress, want.bucket_bytes,
                                    want.active, want.wire_dtype,
                                    want.error_comp)


def _jax_plan_rows(tree, bound):
    plan = jgc.build_bucket_plan(tree, bound)
    names = [".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    return plan, [[names[i] for i in b.leaf_ids] for b in plan.buckets], \
        [list(b.sizes) for b in plan.buckets]


@pytest.mark.parametrize("which,bound", [
    ("resnet20", 64 * 1024), ("resnet20", tgc.DEFAULT_BUCKET_BYTES),
    ("resnet50", 2 ** 20), ("resnet50", tgc.DEFAULT_BUCKET_BYTES),
    ("lm", 16 * 1024)])
def test_bucket_plan_matches_jax_by_membership(which, bound):
    key = jax.random.PRNGKey(0)
    if which == "resnet20":
        jtree = jax.eval_shape(jax_models.resnet_cifar(20).init, key)
        tm = models.resnet_cifar(20)
    elif which == "resnet50":
        jtree = jax.eval_shape(jax_models.resnet(50, 1000).init, key)
        tm = models.resnet(50, 1000)
    else:
        jtree = jax.eval_shape(jax_models.transformer_lm(
            C.LM["vocab"], d_model=C.LM["d_model"],
            num_layers=C.LM["num_layers"], num_heads=C.LM["num_heads"],
            max_len=C.LM["max_len"], attn_impl="flash", pos_encoding="rope",
            num_kv_heads=2).init, key)
        tm = C.lm()
    jplan, members, sizes = _jax_plan_rows(jtree, bound)
    tplan = tgc.build_bucket_plan(dict(tm.named_parameters()), bound)
    assert len(tplan.buckets) == len(jplan.buckets) > 0
    assert [[tplan.names[i] for i in b.leaf_ids]
            for b in tplan.buckets] == members
    assert [list(b.sizes) for b in tplan.buckets] == sizes
    assert [b.nbytes for b in tplan.buckets] == [b.nbytes
                                                  for b in jplan.buckets]
    assert tplan.total_bytes == jplan.total_bytes
    assert tplan.passthrough == jplan.passthrough == ()
    for mode in ("off", "bf16"):
        cfg = jgc.GradCommConfig(mode)
        assert tgc.plan_wire_bytes(tplan, tgc.GradCommConfig(mode)) == \
            jgc.plan_wire_bytes(jplan, cfg)
    assert tgc.build_bucket_plan(dict(tm.named_parameters()), bound) is tplan


@pytest.mark.parametrize("mode", ["bf16", "fp16", "bf16+ec", "fp16+ec"])
def test_compression_is_the_jax_cast_and_clamp(mode):
    rs = np.random.RandomState(3)
    buf = np.concatenate([rs.randn(4096) * 10.0 ** rs.randint(-8, 8, 4096),
                          [7e4, -1e6, 65504.0, 65520.0, 1e-30, -0.0,
                           3.0e38]]).astype(np.float32)
    got = tgc.compress_bucket(torch.from_numpy(buf), mode)
    want = np.asarray(jgc.compress_bucket(jnp.asarray(buf), mode))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert np.array_equal(got.view(torch.int16).numpy(),
                          want.view(np.int16))
    back = tgc.decompress_bucket(got)
    assert back.dtype == torch.float32
    assert np.array_equal(back.numpy(),
                          np.asarray(jgc.decompress_bucket(jnp.asarray(
                              want))))


def _jax_conv(compress):
    mesh = jax_local_mesh()
    from jax.sharding import NamedSharding, PartitionSpec as P
    init, x, y = C.conv_problem()
    params = {k: jnp.asarray(v) for k, v in init.items()}
    cfg = jgc.make_config(compress, "auto")
    x = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    y = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("data")))

    def step(params, x, y):
        def loss_fn(p):
            h = jnp.tanh(x @ p["w1"] + p["b1"])
            return jnp.mean((h @ p["w2"] - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads, info = jgc.apply_grad_comm(grads, cfg, mesh)
        return jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params,
                                      grads), loss

    step = jax.jit(step)
    for _ in range(C.CONV_STEPS):
        params, loss = step(params, x, y)
        loss.block_until_ready()
    return float(loss)


def test_convergence_over_50_steps(job):
    """Uncompressed 2 ranks = one process = JAX on 8 devices (rel 1e-5);
    bf16 and fp16 within JAX's bar of f32 (rel 0.05, and learning: loss
    under 0.5); bf16+ec, error feedback, within rel 1e-4 of f32."""
    res = [r["conv"] for r in job[1]]
    assert res[0] == res[1]
    # compressed_psum: each rank's bucket cast (fp16 clamped), summed in
    # the 16-bit dtype (two clamped fp16 maxima overflow, as JAX's psum)
    bucket = torch.tensor([1.0, -2.5, 70000.0, 1e-3])
    for mode in ("bf16", "fp16"):
        want = (tgc.compress_bucket(bucket, mode)
                + tgc.compress_bucket(bucket * 2, mode)).float()
        assert res[0]["psum"][mode] == want.tolist(), mode
    assert res[0]["psum"]["fp16"][2] == float("inf")
    f32 = res[0]["off"]
    assert f32 == pytest.approx(C.conv_train("off"), rel=1e-5)
    assert f32 == pytest.approx(_jax_conv("off"), rel=1e-5)
    for mode in ("bf16", "fp16"):
        assert res[0][mode] == pytest.approx(f32, rel=0.05, abs=1e-3)
        assert res[0][mode] < 0.5
    assert res[0]["bf16+ec"] == pytest.approx(f32, rel=1e-4)
    assert res[0]["off_info"] is None
    mesh = jax_local_mesh()
    g = {k: jnp.asarray(v) for k, v in C.conv_problem()[0].items()}
    _, jinfo = jgc.apply_grad_comm(g, jgc.make_config("bf16"), mesh)
    info = res[0]["bf16_info"]
    assert sorted(info) == sorted(jinfo)
    assert info["wire_bytes"] * 2 == info["wire_bytes_f32"] == \
        jinfo["wire_bytes_f32"]
    assert (info["n_buckets"], info["bucket_bytes"], info["n_devices"],
            info["bucket_source"]) == (jinfo["n_buckets"],
                                       jinfo["bucket_bytes"], 2, "default")


def test_perf_dp_parity_and_json_columns(job):
    """cli.perf.run(strategy="dp") at 2 ranks: --gradCompress off is bit
    for bit the uncompressed run, bf16 within rel 1e-2; every line carries
    strategy, n_devices, mesh, grad_compress and grad_buckets, and the
    compressed one grad_comm with half the f32 wire bytes."""
    plain, off, bf16 = (job[1][0]["perf"][k] for k in ("None", "off",
                                                        "bf16"))
    assert plain["losses"] == off["losses"]
    assert bf16["losses"][-1] == pytest.approx(off["losses"][-1], rel=1e-2)
    for line in (plain, off, bf16):
        assert (line["strategy"], line["n_devices"], line["mesh"]) == (
            "dp", 2, {"data": 2})
    assert (plain["grad_compress"], plain["grad_buckets"]) == ("off", None)
    assert "grad_comm" not in plain
    assert bf16["grad_compress"] == "bf16" and bf16["grad_buckets"] >= 1
    info = bf16["grad_comm"]
    assert info["wire_bytes"] * 2 == info["wire_bytes_f32"]
    assert info["n_devices"] == 2
    assert job[1][0]["perf"] == job[1][1]["perf"]


def test_build_strategy_and_cli_at_two_ranks(job):
    """build_strategy threads --gradCompress/--gradBuckets, gives None
    grad_comm when untouched, takes --dataParallel as dp and exits on
    multi-step dispatch and on a batch the ranks do not divide; the LM CLI
    trains under --strategy dp with both ranks ending equal."""
    root, res = job
    cli = res[0]["cli"]
    assert cli["threaded"] == ["bf16+ec", 2 * 2 ** 20, 2]
    assert cli["off"] is True and cli["alias"] == "DataParallel"
    assert "--stepsPerDispatch > 1" in cli["dispatch"]
    assert "--innerSteps > 1" in cli["inner"]
    assert "batch 3 must be divisible by the data axis (2)" in cli["batch"]
    a, b = (np.load(root / f"cli_r{r}.npz") for r in range(2))
    for k in a.files:
        assert np.array_equal(a[k], b[k])


def _args(**kw):
    ns = argparse.Namespace(strategy=None, dataParallel=False,
                            stepsPerDispatch=1, gradCompress="off",
                            gradBuckets="auto", platform="cpu")
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_one_process_exits_as_the_jax_cli():
    """In one process --strategy dp and tp exit naming torchrun (the JAX
    CLI names XLA_FLAGS; both need more than one device there too), the
    deprecated alias is a no-op, an unknown strategy exits by name, the
    training CLIs refuse sp, pp and ep with the JAX CLI's own text (cli.perf
    runs them), --elastic without dp or with another strategy exits with
    the JAX text, and junk buckets exit with the JAX text. The mesh axes of
    tp, sp, pp and ep are the JAX function's."""
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node N"):
        common.build_strategy(_args(strategy="dp"))
    assert common.build_strategy(_args(dataParallel=True)) is None
    assert common.build_strategy(_args()) is None
    with pytest.raises(SystemExit, match="unknown strategy 'zz'"):
        common.build_strategy(_args(strategy="zz"))
    with pytest.raises(SystemExit, match="needs more than one device.*"
                                         "torchrun --nproc_per_node N"):
        common.build_strategy(_args(strategy="tp"))
    from bigdl_tpu.cli.common import build_strategy as jax_build
    from bigdl_tpu.cli.common import strategy_mesh_axes as jax_axes
    for name in ("tp", "sp", "pp", "ep"):
        for n, k in ((2, None), (4, None), (8, None), (8, 2), (4, 4),
                     (8, 4), (12, None)):
            assert common.strategy_mesh_axes(name, n, k) == \
                jax_axes(name, n, k), (name, n, k)
    for bad in (("tp", 6, 4), ("sp", 6, 4), ("pp", 6, 4)):
        with pytest.raises(SystemExit) as want:
            jax_axes(*bad)
        with pytest.raises(SystemExit) as got:
            common.strategy_mesh_axes(*bad)
        assert str(got.value) == str(want.value)
    for name in ("sp:2", "pp", "ep"):
        # the JAX CLI reaches its text on conftest's 8 virtual devices
        with pytest.raises(SystemExit) as want:
            jax_build(_args(strategy=name))
        assert "wired through the perf harness" in str(want.value)
        with pytest.raises(SystemExit) as got:
            common.build_strategy(_args(strategy=name))
        assert str(got.value) == str(want.value)
    with pytest.raises(SystemExit, match="--elastic needs --strategy dp"):
        common.build_strategy(_args(elastic="hold"))
    with pytest.raises(SystemExit, match="composes with --strategy dp only "
                                         r"\(got tp\)"):
        common.build_strategy(_args(strategy="tp", elastic="hold"))
    for name in ("sp", "pp", "ep"):
        with pytest.raises(SystemExit) as want:
            jax_build(_args(strategy=name, elastic="hold"))
        with pytest.raises(SystemExit) as got:
            common.build_strategy(_args(strategy=name, elastic="hold"))
        assert str(got.value) == str(want.value)
        assert f"(got {name})" in str(got.value)
    with pytest.raises(SystemExit, match="gradBuckets must be 'auto'"):
        common.make_grad_comm(_args(gradCompress="bf16", gradBuckets="x"))
    from bigdl_tpu_torch.cli import perf
    with pytest.raises(SystemExit, match="multi-device"):
        perf.run("lenet5", 4, 1, torch.float32, device="cpu",
                 grad_compress="bf16")
    # the JAX harness's order: a strategy needs its devices first (the
    # --gradCompress exit under pp/ep is held at 2 ranks)
    with pytest.raises(SystemExit, match="needs more than one device"):
        perf.run("lenet5", 4, 1, torch.float32, device="cpu",
                 strategy="ep", grad_compress="bf16")
    assert not torch.distributed.is_initialized()  # no group of one left


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("cli", ["resnet", "vgg", "lenet", "inception",
                                 "transformerlm", "perf"])
def test_training_clis_take_the_strategy_flags(cli, monkeypatch, tmp_path):
    """Every training CLI and cli.perf parse --strategy, --dataParallel,
    --gradCompress and --gradBuckets (the parse is stopped right after)."""
    import importlib
    mod = importlib.import_module(f"bigdl_tpu_torch.cli.{cli}")
    known = argparse.ArgumentParser.parse_known_args

    def stop(self, *a, **kw):
        ns = known(self, *a, **kw)
        raise _Parsed(ns[0] if isinstance(ns, tuple) else ns)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", stop)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        lambda self, *a, **kw: stop(self, *a, **kw))
    argv = ([] if cli == "perf" else ["train", "-f", str(tmp_path)]) + [
        "--strategy", "dp", "--dataParallel", "--gradCompress", "fp16+ec",
        "--gradBuckets", "4"]
    with pytest.raises(_Parsed) as e:
        mod.main(argv)
    ns = e.value.args[0]
    assert (ns.strategy, ns.dataParallel, ns.gradCompress,
            ns.gradBuckets) == ("dp", True, "fp16+ec", "4")
