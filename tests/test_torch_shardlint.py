"""The port's shardlint (bigdl_tpu_torch.analysis.sharding_rules) on the
CPU: the catalog against the JAX package's, the replicated-operand and
KV rules against the JAX rule functions on the same trees, each rule
group on small steps traced as rank 0 of a fake process group (nothing
is sent), the sharded LM train step at the JAX tests' tp:2 (clean) and
tp:3 (mis-sharded) configurations, the decode surface, the
ResolvedConfig spine, the strategies' lint metadata, and the lint CLI's
and serve's --lint exits."""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from bigdl_tpu import analysis as janalysis
from bigdl_tpu_torch import analysis
from bigdl_tpu_torch.analysis import fx_walk
from bigdl_tpu_torch.cli import lint as lint_cli
from bigdl_tpu_torch.parallel import make_mesh
from bigdl_tpu_torch.parallel.grad_comm import make_config

SEQ = 128  # the JAX tests' transformer_lm at a shorter context


def errors(rep, rule=None):
    return [f for f in rep.findings if f.severity == "error"
            and (rule is None or f.rule == rule)]


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------- catalog
def test_shard_catalog_matches_jax_and_is_merged():
    for rule, (fam, sev, desc) in analysis.SHARD_CATALOG.items():
        assert rule in analysis.CATALOG, rule
        assert (fam, sev) == janalysis.SHARD_CATALOG[rule][:2], rule
        assert fam == "sharding" and desc, rule


# ============================ group 2 and 5 against the JAX functions
def _params():
    return ({"emb": {"w": _meta((4096, 512))}, "bias": _meta((512,))},
            {"emb": {"w": jax.ShapeDtypeStruct((4096, 512), jnp.float32)},
             "bias": jax.ShapeDtypeStruct((512,), jnp.float32)})


@pytest.mark.parametrize("mesh,split", [({"data": 2, "model": 4}, False),
                                        ({"data": 2, "model": 4}, True),
                                        ({"data": 8}, False),
                                        ({"data": 2, "model": 3}, False)])
def test_replicated_operand_rules_equal_jax(mesh, split):
    pt, jt = _params()
    pspec = {"emb": {"w": (None, "model") if split else ()}, "bias": ()}
    jspec = {"emb": {"w": P(None, "model") if split else P()},
             "bias": P()}
    pr = analysis.run_replicated_operand_rules(pt, mesh, specs=pspec)
    jr = janalysis.run_replicated_operand_rules(jt, mesh, specs=jspec)
    assert pr.to_json() == jr.to_json()
    assert bool(pr.findings) == (not split and "model" in mesh)
    # abstract leaves with no specs: placement unknown, never fires
    assert not analysis.run_replicated_operand_rules(pt, mesh).findings


def test_legacy_serving_alias_reads_placed_trees_only():
    pt, jt = _params()
    for rep in (analysis.run_replicated_operand_rules(
            pt, {"model": 4}, split_axes=("model",),
            rule_id="serving-unsharded-matmul"),
            analysis.run_serving_tp_rules(pt, 4)):
        assert not rep.findings
    placed = {"w": torch.zeros(1024, 512)}  # a whole 2 MiB weight here
    jplaced = {"w": jnp.zeros((1024, 512), jnp.float32)}
    pr = analysis.run_serving_tp_rules(placed, 4)
    jr = janalysis.run_serving_tp_rules(jplaced, 4)
    assert pr.to_json() == jr.to_json()
    hits = pr.by_rule("serving-unsharded-matmul")
    assert hits and hits[0].family == "serving" and hits[0].detail["tp"] == 4
    assert not analysis.run_serving_tp_rules(
        placed, 4, specs={"w": (None, "model")}).findings


@pytest.mark.parametrize("kv_heads,tp", [(6, 4), (8, 4), (6, 1)])
def test_kv_sharding_rules_equal_jax(kv_heads, tp):
    shape = (33, kv_heads, 128, 64)
    pr = analysis.run_kv_sharding_rules(
        {"k": _meta(shape, torch.bfloat16), "v": _meta(shape,
                                                        torch.bfloat16)},
        tp, page_tokens=128)
    jleaf = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
    jr = janalysis.run_kv_sharding_rules({"k": jleaf, "v": jleaf}, tp,
                                         page_tokens=128)
    assert pr.to_json() == jr.to_json()
    assert len(errors(pr, "kv-shard-misfit")) == (2 if kv_heads % tp else 0)


# =========================== groups 1, 3, 4 on traced fake-group steps
@pytest.fixture
def world():
    """Rank 0 of a fake group of 4: a {data: 2, model: 2} mesh."""
    with fx_walk.fake_world(4):
        mesh = make_mesh({"data": 2, "model": 2})
        yield mesh
    assert not dist.is_initialized()


def _trace(mesh, fn, *args):
    graph = fx_walk.trace_graph(fn, *args)
    graph.meta["mesh_groups"] = fx_walk.mesh_groups(mesh)
    return graph


def _reduce(axis, mesh):
    group = mesh.axis_view(axis).group

    def fn(x):
        dist.all_reduce(x, group=group)
        return x * 2.0
    return fn


BIG = (1024, 1024)  # f32: 4 MiB


def test_collective_axis_membership_and_extra(world):
    g = _trace(world, _reduce("model", world), _meta(BIG))
    rep = analysis.run_sharding_rules(g, mesh_axes={"data": 2},
                                      strategy="dp")
    hits = errors(rep, "shard-collective-axis")
    assert hits and "model" in str(hits[0].detail["axes"])
    assert not analysis.run_sharding_rules(
        g, mesh_axes={"model": 2}, strategy="tp").findings
    hits = errors(analysis.run_sharding_rules(
        g, mesh_axes={"data": 2, "model": 2}, strategy="dp"),
        "shard-collective-extra")
    assert hits and hits[0].detail["axes"] == ["model"]


def test_unreferenced_axis_and_grad_compress_signature(world):
    g = _trace(world, _reduce("data", world), _meta(BIG))
    hits = errors(analysis.run_sharding_rules(
        g, mesh_axes={"data": 2, "model": 2}, strategy="tp"),
        "shard-collective-missing")
    assert hits and hits[0].detail["axis"] == "model"
    cfg = make_config("bf16", "auto")
    rep = analysis.run_sharding_rules(g, mesh_axes={"data": 2},
                                      strategy="dp", grad_comm=cfg)
    assert errors(rep, "shard-collective-missing")
    assert errors(rep, "shard-wire-dtype")  # 4 MiB reduced in f32
    assert not analysis.run_sharding_rules(
        g, mesh_axes={"data": 2}, strategy="dp").findings
    g16 = _trace(world, _reduce("data", world), _meta(BIG, torch.bfloat16))
    assert not analysis.run_sharding_rules(
        g16, mesh_axes={"data": 2}, strategy="dp", grad_comm=cfg).findings


def test_quant_remat_before_a_collective(world):
    group = world.axis_view("model").group

    def dense(w, s):
        x = w.float() * s
        dist.all_reduce(x, group=group)
        return x

    def kept(w, s):
        dist.all_reduce(s, group=group)
        return w, s

    args = (_meta(BIG, torch.int8), _meta((1024, 1)))
    hits = analysis.run_sharding_rules(
        _trace(world, dense, *args), mesh_axes={"data": 2, "model": 2},
        strategy="tp").by_rule("shard-quant-remat-wire")
    assert hits and hits[0].severity == "warning"
    assert not analysis.run_sharding_rules(
        _trace(world, kept, *args), mesh_axes={"data": 2, "model": 2},
        strategy="tp").by_rule("shard-quant-remat-wire")


def test_gather_then_reslice_is_churn(world):
    group = world.axis_view("model").group

    def churn(x):
        out = torch.zeros((2048, 1024), device=x.device)
        out.narrow(0, 0, 1024).copy_(x)
        dist.all_reduce(out, group=group)  # the gather of a split value
        return out.narrow(0, 1024, 1024) * 2.0

    def stable(x):
        out = torch.zeros((2048, 1024), device=x.device)
        out.narrow(0, 0, 1024).copy_(x)
        dist.all_reduce(out, group=group)
        return out * 2.0

    hits = analysis.run_sharding_rules(
        _trace(world, churn, _meta(BIG)), mesh_axes={"data": 2, "model": 2},
        strategy="tp").by_rule("shard-reshard-churn")
    assert hits and hits[0].detail["wasted_bytes"] > 0
    assert not analysis.run_sharding_rules(
        _trace(world, stable, _meta(BIG)),
        mesh_axes={"data": 2, "model": 2},
        strategy="tp").by_rule("shard-reshard-churn")


def test_strategy_lint_spec_metadata(world):
    from bigdl_tpu_torch.parallel import DataParallel, TensorParallel
    from bigdl_tpu_torch.parallel.tensor_parallel import param_tree

    meta = DataParallel(make_mesh({"data": 4}),
                        grad_comm=make_config("bf16")).lint_spec_metadata()
    assert meta["strategy"] == "dp" and meta["mesh_axes"] == {"data": 4}
    assert meta["grad_comm"].active
    model, _ = analysis._build("transformer_lm", seq_len=SEQ)
    tp = TensorParallel(world, model)
    meta = tp.lint_spec_metadata(param_tree(model))
    assert meta["strategy"] == "tp" and meta["model_axis"] == "model"
    assert meta["mesh_axes"] == {"data": 2, "model": 2}
    specs = [s for _, s in analysis.sharding_rules.flatten_specs(
        meta["param_specs"])]
    assert any(any(a is not None for a in s) for s in specs)


# =============================== the LM over a fake group of 4 and 6
@pytest.mark.parametrize("k,clean", [(2, True), (3, False)])
def test_sharded_lm_step(k, clean):
    model, in_shape = analysis._build("transformer_lm", seq_len=SEQ)
    cfg = make_config("bf16", "auto") if clean else None
    graph, meta = analysis.trace_sharded_train_step(
        model, in_shape, 8, mesh_axes={"data": 2, "model": k}, is_lm=True,
        grad_comm=cfg)
    assert not dist.is_initialized()
    colls = fx_walk.collect_collectives(graph, graph.meta["mesh_groups"])
    rep = analysis.run_sharding_rules(
        graph, mesh_axes=meta["mesh_axes"], strategy="tp", grad_comm=cfg,
        param_specs=meta["param_specs"], params=meta["params"])
    if clean:  # the blessed multi-device config stays shardlint-clean
        assert not errors(rep), [f.message for f in errors(rep)[:3]]
        assert {c.axes for c in colls} >= {("data",), ("model",)}
        assert not rep.by_rule("shard-reshard-churn")
    else:  # 512 % 3: Megatron keeps every weight whole
        rules = {f.rule for f in errors(rep)}
        assert {"shard-collective-missing",
                "shard-replicated-operand"} <= rules
        assert all(c.axes != ("model",) for c in colls)


def test_decode_surface_under_tp():
    model, _ = analysis._build("transformer_lm", seq_len=SEQ)
    model.compute_dtype = torch.bfloat16
    rep = analysis.lint_serving(model, slots=2, kv_page_tokens=64,
                                speculate=2, quantize="int8+kv8", tp=2)
    assert not dist.is_initialized()
    assert rep.by_rule("decode-sampling-sort")  # a 32000-lane warp sort
    assert not errors(rep) and not rep.by_rule("lint-trace-error")
    rep = analysis.lint_serving(model, slots=16, tp=3)  # 2 MiB of KV
    assert {"kv-shard-misfit", "shard-replicated-operand"} <= {
        f.rule for f in errors(rep)}
    assert analysis.lint_serving(model, slots=2,
                                 kv_page_tokens=48).by_rule(
        "kv-page-misfit")


# ------------------------------------------------- ResolvedConfig spine
def test_resolve_lint_config_virtual_mesh_and_grad_comm():
    import argparse

    from bigdl_tpu_torch.cli.common import resolve_lint_config
    args = argparse.Namespace(model="transformer_lm", batchSize=8,
                              strategy="tp:4", gradCompress="bf16+ec",
                              gradBuckets="auto", quantize="int8+kv8",
                              speculate=4, kvPageTokens="auto")
    cfg = resolve_lint_config(args)
    assert cfg.mesh == {"data": 2, "model": 4}
    assert cfg.strategy == "tp" and cfg.strategy_k == 4
    assert cfg.make_grad_comm().active
    assert cfg.kv_page_tokens is None  # 'auto' is serve-side only
    assert cfg.describe()["mesh"] == "data:2,model:4"
    args.strategy = "tp"  # over a job's 2 ranks: K takes them all
    assert resolve_lint_config(args, n_devices=2).mesh == {"data": 1,
                                                          "model": 2}


# ------------------------------------------------------------ the CLIs
def test_cli_sharded_configs_exit_codes(capsys):
    assert lint_cli.main(["transformer_lm", "--seq", str(SEQ), "-b", "8",
                          "--strategy", "tp:2", "--gradCompress", "bf16",
                          "--quantize", "int8+kv8", "--speculate", "2",
                          "--strict"]) == 0
    capsys.readouterr()
    assert lint_cli.main(["transformer_lm", "--seq", str(SEQ), "-b", "8",
                          "--strategy", "tp:3", "--strict"]) == 2
    assert "shard-" in capsys.readouterr().out


def test_serve_lint_strict_stamps_lint_mesh():
    import json as _json

    from bigdl_tpu_torch.cli import serve as serve_cli
    args = serve_cli.build_parser().parse_args(
        ["transformer_lm", "--randomInit", "--platform", "cpu",
         "--vocabSize", "50", "--dModel", "32", "--numLayers", "2",
         "--numHeads", "2", "--seq", "64", "--slots", "2", "--buckets",
         "1,2", "--maxWaitMs", "2", "--strategy", "dp:2", "--devices",
         "cpu,cpu", "--lint=strict"])
    app, engine, _, _ = serve_cli.build_app(args)
    try:
        page = app.metrics.render()
        prov = _json.loads(
            [ln for ln in page.splitlines()
             if ln.startswith("# provenance ")][0][len("# provenance "):])
        assert prov["lint_mesh"] == "replicated x 2 replica(s)"
        assert prov["strategy"] == "dp:2"
        assert engine.lint_annotation["errors"] == 0
    finally:
        app.close()
