"""``explain``: turn a profile into an explanation (counterpart of
``bigdl_tpu/cli/explain.py``)::

    python -m bigdl_tpu_torch.cli.main explain DIR/capture_4     # a window
    python -m bigdl_tpu_torch.cli.main explain PROF --steps 5 --gflops 94
    python -m bigdl_tpu_torch.cli.main explain resnet50 -b 32 -i 5
    python -m bigdl_tpu_torch.cli.main explain --mem resnet50 -b 32

The target is either a directory holding a ``torch.profiler`` trace (a
``cli.perf --profile`` directory or a ``capture_<step>`` window of
``--traceDir``) or a perf-zoo model name: the latter runs a short
profiled ``cli.perf`` loop first, then attributes its own trace with the
run's FLOP numerators and peak, so the table carries FLOP share and
roofline utilization, not only times. Output: the per-category table
(``utils/table``) with the collective breakout and MFU decomposition, or
``--json`` (one line, printed last).

``--mem`` is the memory twin for a model target: the training step runs
on the card at ``-b`` and at twice it, the per-category plan of the step
is rendered (totalling to the allocator's peak), and the linear
per-sample fit predicts the largest batch that fits the card; on the CPU
(``--platform cpu``) the plans are abstract-only (nothing runs).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(
        "python -m bigdl_tpu_torch.cli.explain",
        description="classify every device event of a torch.profiler "
                    "trace into the taxonomy (matmul/conv/bn_norm/"
                    "attention/elementwise/collective/infeed/host_other) "
                    "with per-collective subtotals and an MFU "
                    "decomposition")
    p.add_argument("target",
                   help="torch.profiler trace dir (e.g. an obs "
                        "capture_<step> window) OR a perf model name "
                        "(runs a short profiled loop first)")
    p.add_argument("--json", action="store_true",
                   help="machine output (one JSON line, printed last)")
    p.add_argument("--mem", action="store_true",
                   help="memory mode (model target only): per-category "
                        "plan of the training step, headroom against the "
                        "card's memory, and the predicted max batch from "
                        "a two-point per-sample fit; no timed run")
    p.add_argument("-b", "--batchSize", type=int, default=16,
                   help="batch for model-mode runs")
    p.add_argument("-i", "--iteration", type=int, default=5,
                   help="timed steps for model-mode runs (= the step "
                        "count the attribution divides by)")
    p.add_argument("--steps", type=int, default=None,
                   help="step count of a profile-dir target (enables "
                        "ms/step and the per-step collective column)")
    p.add_argument("--gflops", type=float, default=None,
                   help="analytic step GFLOPs of the profiled run (the "
                        "perf line's step_gflops_analytic): enables FLOP "
                        "share and utilization for a profile-dir target")
    p.add_argument("--gflopsConv", type=float, default=None,
                   help="conv share of --gflops (the perf line's "
                        "step_gflops_by_kind.conv); the rest is matmul")
    p.add_argument("--peak", type=float, default=None,
                   help="peak FLOP/s of the run's devices for the "
                        "roofline join (the perf line's "
                        "peak_flops_assumed x n_devices)")
    p.add_argument("--top", type=int, default=3,
                   help="top kernels listed per category")
    p.add_argument("--seq", type=int, default=None,
                   help="transformer_lm* sequence override (model mode)")
    p.add_argument("--quantize", default=None,
                   choices=("off", "int8", "fp8", "kv8", "int8+kv8",
                            "fp8+kv8"),
                   help="with --mem on a transformer_lm target: account "
                        "the serving KV cache and weights under this "
                        "quantize mode and re-fit the max-slot forecast")
    from bigdl_tpu_torch.cli.common import (_add_platform_arg,
                                            add_strategy_arg)
    _add_platform_arg(p)
    add_strategy_arg(p)
    args = p.parse_args(argv)

    from bigdl_tpu_torch.obs import attrib

    if args.mem:
        if os.path.isdir(args.target):
            raise SystemExit(
                "--mem explains a MODEL's memory plan (it runs the "
                "step); pass a perf model name, not a profile dir")
        from bigdl_tpu_torch.obs import memory
        b = args.batchSize
        plan = memory.plan_for_model(args.target, b, seq_len=args.seq,
                                     device=args.platform)
        plan2 = memory.plan_for_model(args.target, 2 * b,
                                      seq_len=args.seq,
                                      device=args.platform)
        fc = memory.forecast(plan, plan2)
        kvp = fcs = None
        if args.target.startswith("transformer_lm"):
            kvp = memory.serving_kv_plan(args.target, seq_len=args.seq,
                                         quantize=args.quantize,
                                         device=args.platform)
            fcs = memory.forecast_slots(kvp)
        if args.json:
            out = memory.compact(plan)
            out["model"] = args.target
            out["device"] = plan.get("device")
            out["forecast"] = fc
            out["plan_2x"] = memory.compact(plan2)
            if kvp is not None:
                out["serving_kv"] = kvp
                out["forecast_slots"] = fcs
            print(json.dumps(out))
        else:
            print(f"memory plan: {args.target} b={b} "
                  f"({plan.get('device')})")
            print(memory.render(plan, fc))
            if kvp is not None:
                print(f"\nserving (quantize={kvp['quantize']}): "
                      f"kv/slot {kvp['kv_bytes_per_slot']} B "
                      f"(L={kvp['max_len']}, "
                      f"dtype={kvp['cache_dtype']}"
                      + (f", page={kvp['page_tokens']}"
                         if kvp['page_tokens'] else "")
                      + f"), weights {kvp['params_bytes']} B"
                      f" -> predicted max slots "
                      f"{fcs['predicted_max_slots']}")
        return 0

    if os.path.isdir(args.target):
        step_flops = args.gflops * 1e9 if args.gflops else None
        by_kind = None
        if step_flops and args.gflopsConv is not None:
            conv = args.gflopsConv * 1e9
            by_kind = {"matmul": max(0.0, step_flops - conv),
                       "conv": conv}
        summary = attrib.attribute_profile(
            args.target, steps=args.steps, step_flops=step_flops,
            flops_by_kind=by_kind, peak_flops=args.peak,
            top_ops=args.top)
    else:
        # model mode: a short profiled perf run, then its trace
        # attributed with the run's own numerators
        import tempfile

        from bigdl_tpu_torch.cli import perf

        tmp = tempfile.mkdtemp(prefix="bigdl_explain_")
        out = perf.run(args.target, args.batchSize, args.iteration,
                       data_type="random", profile_dir=tmp,
                       strategy=args.strategy, seq_len=args.seq,
                       device=args.platform)
        gf = out.get("step_gflops_analytic") or 0.0
        kinds = out.get("step_gflops_by_kind") or {}
        summary = attrib.attribute_profile(
            tmp, steps=args.iteration * out.get("inner_steps", 1),
            step_flops=gf * 1e9 or None,
            flops_by_kind={k: v * 1e9 for k, v in kinds.items()} or None,
            peak_flops=(out.get("peak_flops_assumed") or 0)
            * out.get("n_devices", 1) or None,
            top_ops=args.top)
        summary["perf"] = {k: out.get(k) for k in (
            "model", "batch", "strategy", "n_devices", "mesh",
            "records_per_second", "mfu_pct", "device")}

    if args.json:
        c = attrib.compact(summary)
        c["trace"] = summary.get("trace")
        if "perf" in summary:
            c["perf"] = summary["perf"]
        print(json.dumps(c))
    else:
        print(attrib.render(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
