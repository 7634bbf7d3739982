"""The port's lint (bigdl_tpu_torch.analysis, cli/lint.py) against the JAX
package's tpulint on the CPU: the catalog, the report's JSON, render and
exit codes, the module rules on the zoo's models, the comm and memory
rules on the same trees, the graph rules on small functions traced on
fake tensors, the kernel sites a traced step records (and launches no
kernel for), the CLIs' exit codes and the training pre-flight. Each
stated difference from the JAX rules is asserted by name."""

import json

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import analysis as janalysis
from bigdl_tpu.analysis import report as jreport
from bigdl_tpu.cli.common import apply_fused_bn as jax_apply_fused_bn
from bigdl_tpu.cli.perf import build_model as jax_build_model
from bigdl_tpu.ops import conv2d as jconv
from bigdl_tpu_torch import analysis
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.analysis import fx_walk, report as preport
from bigdl_tpu_torch.cli import lint as lint_cli
from bigdl_tpu_torch.cli.common import apply_fused_bn
from bigdl_tpu_torch.ops import conv2d as pconv

# the JAX CLI's findings on `lint resnet50 -b 32` (jax 0.9.0 on the CPU):
# what the port's trace is held against
JAX_RESNET50_RULES = {"fusion-bn-unfused", "dtype-upcast",
                      "dtype-weak-scalar", "fusion-conv-gemm",
                      "tile-bn-ineligible", "layout-c128"}
BIG = (2048, 1024)  # bf16: 4 MiB, past the 2 MiB upcast floor


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _rules(rep):
    return {f.rule for f in rep.findings}


# ------------------------------------------------------------- catalog
def test_catalog_matches_the_jax_catalog():
    assert set(analysis.CATALOG) == set(janalysis.CATALOG)
    assert len(analysis.CATALOG) == 26 + 8
    for rule, (fam, sev, desc) in analysis.CATALOG.items():
        assert (fam, sev) == janalysis.CATALOG[rule][:2], rule
        assert desc, rule
    assert set(analysis.SHARD_CATALOG) == set(janalysis.SHARD_CATALOG)


def test_report_json_render_and_exit_codes_match_jax(tmp_path):
    rows = [("fusion-bn-unfused", "fusion", "error", "53 sites", "a; b",
             "--fusedBN apply", {"count": 53, "channels": [64, 128]}),
            ("layout-c128", "layout", "info", "1 layer", "", "",
             {"worst_waste": 0.5}),
            ("dtype-upcast", "dtype", "warning", "17 upcasts", "x#3", "",
             {})]
    reps = []
    for mod in (jreport, preport):
        r = mod.Report()
        for rule, fam, sev, msg, where, hint, detail in rows:
            r.add(mod.Finding(rule, fam, sev, msg, where, hint, detail))
        reps.append(r)
    jr, pr = reps
    assert pr.to_json() == jr.to_json()
    assert pr.render() == jr.render()
    assert pr.annotation() == jr.annotation()
    assert (pr.exit_code(), pr.exit_code(strict=True)) == \
        (jr.exit_code(), jr.exit_code(strict=True)) == (0, 2)
    jr.dump_json(str(tmp_path / "j.json"))
    pr.dump_json(str(tmp_path / "p.json"))
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert preport.Report().render() == "lint: no findings"
    with pytest.raises(ValueError):
        preport.Finding("x", "meta", "fatal", "")


# ------------------------------------------------------- module rules
# (name, --fusedBN, all-GEMM conv policy): the port's rule set is the
# JAX one less the stated differences (tile-bn-ineligible never fires:
# every BN shape takes the kernels; layout-headdim: a 64-wide bf16 head
# stays on the wgmma kernels)
_MODULE_CASES = [("lenet5", None, False), ("resnet50", None, False),
                 ("resnet50", "apply", True), ("inception_v2", None, False),
                 ("transformer_lm", None, False),
                 ("transformer_lm_1k_hd128", None, False)]


@pytest.mark.parametrize("name,fused,gemm", _MODULE_CASES)
def test_module_rules_match_jax(name, fused, gemm):
    jm, jin = jax_build_model(name, class_num=1000, lm_attn_impl="flash")
    jax_apply_fused_bn(jm, fused)
    pm, pin = analysis._build(name, 1000)
    apply_fused_bn(pm, fused)
    assert tuple(pin) == tuple(jin)
    seq = jin[0] if name.startswith("transformer_lm") else None
    jsnap, psnap = jconv.policy_snapshot(), pconv.policy_snapshot()
    try:
        if gemm:
            jconv.set_conv_pass_layouts("GEMM", "GEMM", "GEMM")
            pconv.set_conv_pass_layouts("GEMM", "GEMM", "GEMM")
        jr = janalysis.run_module_rules(jm, seq=seq)
        pr = analysis.run_module_rules(pm, seq=seq)
    finally:
        jconv.restore_policy(jsnap)
        pconv.restore_policy(psnap)
    differences = {"tile-bn-ineligible", "layout-headdim"}
    assert _rules(pr) == _rules(jr) - differences
    count = {f.rule: f.detail.get("count") for f in pr.findings}
    jcount = {f.rule: f.detail.get("count") for f in jr.findings}
    if "fusion-conv-gemm" in count:
        assert count["fusion-conv-gemm"] == jcount["fusion-conv-gemm"]
    if "fusion-bn-unfused" in count:  # the JAX unfused + its ineligible
        assert count["fusion-bn-unfused"] == \
            jcount["fusion-bn-unfused"] + jcount.get("tile-bn-ineligible", 0)
    assert not pr.by_rule("tile-bn-ineligible")
    if name == "transformer_lm":
        assert jr.by_rule("layout-headdim") and not pr.by_rule(
            "layout-headdim")


# ------------------------------------------------ comm + memory rules
@pytest.mark.parametrize("strategy,compress", [("dp", None), ("tp", "off"),
                                               ("dp", "bf16"),
                                               ("pp", None)])
def test_comm_rules_match_jax_on_the_same_tree(strategy, compress):
    from bigdl_tpu_torch.parallel.tensor_parallel import param_tree

    jm, _ = jax_build_model("resnet50", class_num=1000)
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    pm, _ = analysis._build("resnet50", 1000)
    jr = janalysis.run_comm_rules(jparams, strategy, compress)
    pr = analysis.run_comm_rules(param_tree(pm), strategy, compress)
    assert pr.to_json() == jr.to_json()
    assert bool(pr.findings) == (strategy in ("dp", "tp")
                                 and compress in (None, "off"))


def test_memory_rules_match_jax():
    cats = {"params": 3 * 2 ** 30, "optimizer": 3 * 2 ** 30,
            "gradients": 3 * 2 ** 30, "input": 2 ** 20}
    for hbm in (8e9, 11e9, 80e9):
        plan = {"total_bytes": sum(cats.values()), "hbm_bytes": int(hbm),
                "categories": cats, "model": "m", "batch": 8,
                "device": "cpu"}
        # the same findings; the hints name the port's commands
        got, want = (r(plan).to_json() for r in (
            analysis.run_memory_rules, janalysis.run_memory_rules))
        for blob in (got, want):
            for f in blob["findings"]:
                f.pop("hint")
        assert got == want
    assert not analysis.run_memory_rules(None).findings


# ---------------------------------------------------------- graph rules
def test_dtype_upcast_fires_on_leading_reduce_not_on_softmax():
    rep = analysis.lint_fn(lambda x: x.float().sum(0), _meta(BIG))
    hits = rep.by_rule("dtype-upcast")
    assert hits and hits[0].severity == "warning"
    assert "aten._to_copy" in hits[0].where
    assert not analysis.lint_fn(lambda x: x.float().sum(-1),
                                _meta(BIG)).by_rule("dtype-upcast")
    assert analysis.lint_fn(lambda x, w: x.float() @ w, _meta(BIG),
                            _meta((1024, 8), torch.float32)).by_rule(
                                "dtype-upcast")


def test_weak_scalar_is_a_one_element_tensor_in_torch():
    # stated difference: a 0-d f32 tensor and a python scalar are weak in
    # torch (the product stays bf16); a (1,) f32 tensor promotes
    one = _meta((1,), torch.float32)
    assert analysis.lint_fn(lambda x, one: x * one, _meta(BIG),
                            one).by_rule("dtype-weak-scalar")
    for fn in (lambda x: x * torch.tensor(2.0), lambda x: x * 2.0):
        assert not analysis.lint_fn(fn, _meta(BIG)).findings


def test_donation_rules_read_the_train_state():
    p, x = _meta((512, 512), torch.float32), _meta((512, 512), torch.float32)
    rep = analysis.lint_fn(lambda p, x: (p + x.sum(), x * 2.0), p, x,
                           state_argnums=(0, 1))
    hits = rep.by_rule("donate-missing")
    assert hits and hits[0].detail["bytes"] >= 2 * 512 * 512 * 4
    rep = analysis.lint_fn(lambda p, x: (p.add_(x.sum()), x.mul_(2.0)), p,
                           x, state_argnums=(0, 1))
    assert rep.by_rule("donate-ok") and not rep.by_rule("donate-missing")
    # without a declared state there is no step to round-trip
    assert not analysis.lint_fn(lambda p, x: p + x, p, x).findings


def test_host_sync_item_cpu_and_data_dependent_branch():
    x = _meta((128,), torch.float32)
    rep = analysis.lint_fn(lambda x: x * x.sum().item(), x)
    hits = rep.by_rule("host-sync")
    assert hits and hits[0].severity == "error"
    assert "_local_scalar_dense" in hits[0].where
    assert analysis.lint_fn(lambda x: x.cpu() + 1, x).by_rule("host-sync")
    assert not analysis.lint_fn(lambda x: x.sum(), x).findings

    def branchy(x):
        if x.sum().item() > 0:  # the host decides: no trace
            return x
        return -x

    hits = analysis.lint_fn(branchy, x).by_rule("host-sync")
    assert hits and "test_torch_lint.py" in hits[0].where
    assert "branchy" in hits[0].where


def test_dequant_chain_into_an_f32_product_fires():
    x, w = _meta((64, 256)), _meta((256, 128), torch.int8)
    s = _meta((128,), torch.float32)
    rep = analysis.lint_fn(lambda x, w, s: x.float() @ (w.float() * s),
                           x, w, s)
    hits = rep.by_rule("quant-dequant-upcast")
    assert hits and hits[0].severity == "error"
    rep = analysis.lint_fn(lambda x, w, s: x @ (w.to(x.dtype) * s.to(
        x.dtype)), x, w, s)
    assert not rep.by_rule("quant-dequant-upcast")


# --------------------------------------------------------- kernel sites
def _flash(b, h, s, d, dtype=torch.bfloat16, mask=None):
    q = _meta((b, h, s, d), dtype)
    extra = () if mask is None else (_meta(mask, torch.bool),)
    return analysis.lint_fn(
        lambda q, k, v, *m: ops.flash_attention(
            q, k, v, causal=mask is None, mask=m[0] if m else None),
        q, q.clone(), q.clone(), *extra)


def test_flash_sites_check_their_launch_plans():
    before = ops.kernel_launches()
    assert not _flash(1, 2, 512, 64).findings
    hits = _flash(1, 2, 512, 96).by_rule("tile-min")  # no kernel takes it
    assert hits and hits[0].severity == "error"
    # a ragged causal LM stays on the kernels (they mask the edge): the
    # stated tile-ragged-attn difference; its last tile runs padded
    rep = _flash(1, 2, 600, 64)
    assert not rep.by_rule("tile-ragged-attn")
    assert rep.by_rule("tile-pad")[0].detail["plan"]["tile_q"] == 128
    assert _flash(1, 2, 512, 128).by_rule("vmem-budget")
    assert not _flash(1, 2, 512, 64, torch.float32).findings
    # a key-padding mask at a length no block divides leaves the kernels
    rep = _flash(2, 2, 600, 64, mask=(2, 600))
    assert rep.by_rule("tile-ragged-attn")
    assert _flash(1, 1, 768, 64, mask=(1, 768)).by_rule("tile-seq-clamp")
    assert ops.kernel_launches() == before


@pytest.fixture(scope="module")
def fba_graph():
    model, in_shape = analysis._build("resnet50_fba", 1000)
    before = ops.kernel_launches()
    graph = analysis.trace_train_step(model, in_shape, 8)
    assert ops.kernel_launches() == before  # the trace launched nothing
    return model, graph


def test_resnet50_fba_records_the_launches_of_a_step(fba_graph):
    from collections import Counter

    model, graph = fba_graph
    sites = Counter(s.kernel for s in fx_walk.kernel_sites(graph))
    assert sites == {"bn_fwd_apply": 53, "bn_bwd_fused": 53}
    site = fx_walk.kernel_sites(graph)[0]
    assert site.shapes == ((8 * 112 * 112, 64),)
    assert site.plan["kernel"] == "bn_coop_kernel"
    assert site.plan["blocks"] * site.plan["slabs"] <= site.plan["ctas"]
    rep = analysis.run_jaxpr_rules(graph)
    analysis._bn_fallback_rule(model, graph, rep)
    assert rep.by_rule("donate-ok") and not rep.by_rule("tile-bn-fallback")
    assert not rep.by_rule("dtype-upcast")  # the fused pair keeps it in


# ------------------------------------------------------- whole models
def test_resnet50_default_config_reports_the_jax_families():
    rep = analysis.lint_perf_model("resnet50", 32)
    # the JAX CLI's set, less the stated differences (every BN shape
    # takes the kernels; a 0-d f32 constant does not promote), plus the
    # in-place update the JAX trace no longer sees under jax 0.9.0
    assert _rules(rep) == (JAX_RESNET50_RULES - {"tile-bn-ineligible",
                                                 "dtype-weak-scalar"}
                           ) | {"donate-ok"}
    assert len(rep.families()) >= 4
    assert any("#" in f.where for f in rep.findings)  # node provenance


def test_resnet50_tuned_config_zero_fusion_findings():
    snap = pconv.policy_snapshot()
    try:
        pconv.set_conv_pass_layouts("GEMM", "GEMM", "GEMM")
        rep = analysis.lint_perf_model("resnet50", 32, fused_bn="apply")
    finally:
        pconv.restore_policy(snap)
    assert not rep.by_family("fusion"), [f.rule for f in
                                         rep.by_family("fusion")]
    assert rep.errors == 0
    assert pconv.policy_snapshot() == snap


# ------------------------------------------------------------ the CLIs
def test_cli_lint_exit_codes(tmp_path, capsys):
    from bigdl_tpu_torch.cli import main as cli_main

    out = tmp_path / "report.json"
    assert lint_cli.main(["lenet5", "--strict", "--json", str(out)]) == 0
    blob = json.loads(out.read_text())
    assert blob["summary"]["errors"] == 0
    assert isinstance(blob["findings"], list)
    # unfused BN (the measured-regression config), module rules only
    assert lint_cli.main(["resnet50", "-b", "8", "--strict",
                          "--no-trace"]) == 2
    # a ragged length pads the kernels' tiles (tile-pad, where the JAX
    # lint reports tile-ragged-attn); a tileable one is green
    assert lint_cli.main(["transformer_lm", "--seq", "600", "-b", "2",
                          "--strict"]) == 2
    assert "tile-pad" in capsys.readouterr().out
    assert cli_main.main(["lint", "transformer_lm", "-b", "2", "--seq",
                          "256", "--strict"]) == 0


def test_perf_cli_lint_strict_refuses_and_stamps(capsys):
    from bigdl_tpu_torch.cli import perf

    before = ops.kernel_launches()
    # unfused BN: refused before anything runs
    assert perf.main(["-m", "resnet20_cifar", "-b", "8", "--platform",
                      "cpu", "--lint=strict"]) == 2
    assert ops.kernel_launches() == before
    capsys.readouterr()
    out = perf.main(["-m", "lenet5", "-b", "8", "-i", "1", "--platform",
                     "cpu", "--lint"])
    assert out["lint"]["errors"] == 0 and "rules" in out["lint"]
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    assert json.loads(line)["lint"] == out["lint"]


def test_preflight_optimizer_traces_without_touching_shuffle_rng():
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.models import lenet5
    from bigdl_tpu_torch.optim import Optimizer, SGD, Trigger

    x = np.random.RandomState(0).randn(32, 28, 28, 1).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 10, 32).astype(np.int32)
    ds = BatchDataSet(x, y, 16, shuffle=True)
    state0 = ds._rng.get_state()[1].copy()
    opt = Optimizer(lenet5(10), ds, nn.ClassNLLCriterion(),
                    optim_method=SGD(0.1), end_when=Trigger.max_epoch(1),
                    device="cpu")
    w0 = next(opt.model.parameters()).detach().clone()
    rep = analysis.preflight_optimizer(opt)
    # the Optimizer's own step was traced: its update is in place
    assert rep.by_rule("donate-ok")
    assert not rep.by_rule("lint-trace-error")
    assert (ds._rng.get_state()[1] == state0).all()
    assert torch.equal(next(opt.model.parameters()), w0)
