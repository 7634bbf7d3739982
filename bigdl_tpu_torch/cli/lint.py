"""``lint``: the lint CLI of the port (counterpart of
``bigdl_tpu/cli/lint.py``).

Trace a perf-zoo model's whole train step on fake tensors (no
allocation, no kernel launch, no card: seconds on the CPU) and report the
H100 path's performance and correctness anti-patterns with rule-level
provenance and fix hints::

    python -m bigdl_tpu_torch.cli.main lint resnet50 -b 128
    python -m bigdl_tpu_torch.cli.main lint resnet50 --fusedBN apply \\
        --convLayout GEMM,GEMM,GEMM
    python -m bigdl_tpu_torch.cli.main lint transformer_lm --seq 600 --strict
    python -m bigdl_tpu_torch.cli.main lint lenet5 --json report.json

shardlint extends the command to the multi-device surfaces: the
strategy's sharded train step is traced as rank 0 of a fake process group
of the mesh's size (nothing is sent), and the serving decode step is
traced when ``--quantize``/``--speculate``/``--kvPageTokens`` ask for
one::

    python -m bigdl_tpu_torch.cli.main lint transformer_lm_1k_hd128 \\
        --strategy tp:2 --gradCompress bf16 --quantize int8+kv8 \\
        --kvPageTokens 128 --speculate 4 --strict

The configuration flags are the perf/training/serve harnesses'
(--fusedBN, --convLayout, --convGeom, --autotune, --strategy,
--gradCompress, --gradBuckets, --quantize, --speculate, --kvPageTokens),
so the configuration about to run is what is analyzed; ``--strict`` exits
2 on any error-severity finding (the CI gate). The rule catalog and its
stated differences from the JAX rules: ``bigdl_tpu_torch/analysis``.
"""

from __future__ import annotations

import argparse
import json

__all__ = ["main"]


def main(argv=None):
    from bigdl_tpu_torch.cli.common import (QUANTIZE_CHOICES,
                                            add_autotune_arg,
                                            add_fused_bn_arg,
                                            add_grad_comm_args,
                                            add_strategy_arg)

    p = argparse.ArgumentParser(
        "python -m bigdl_tpu_torch.cli.main lint",
        description="trace-time lint of the H100 path "
                    "(bigdl_tpu_torch.analysis: tpulint and shardlint)")
    p.add_argument("model",
                   help="perf model-zoo name (see cli.perf), e.g. "
                        "resnet50, lenet5, transformer_lm")
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--seq", type=int, default=None,
                   help="override the LM sequence length (transformer_lm* "
                        "models)")
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--f32", action="store_true",
                   help="analyze the f32 path instead of the bf16 default")
    p.add_argument("--strict", action="store_true",
                   help="exit 2 on error-severity findings (what "
                        "--lint=strict does on the perf/training CLIs)")
    p.add_argument("--json", default=None, metavar="FILE",
                   help="also write the full finding list as JSON "
                        "('-' = stdout)")
    p.add_argument("--no-trace", action="store_true",
                   help="module-level rules only (skip the traced step)")
    add_autotune_arg(p)
    add_fused_bn_arg(p)
    p.add_argument("--convLayout", default=None, metavar="FWD,DGRAD,WGRAD",
                   help="analyze under this explicit per-pass conv layout "
                        "policy (NHWC|NCHW|GEMM each, or "
                        "'auto'/'default')")
    p.add_argument("--convGeom", default=None, metavar="FILE",
                   help="analyze under this per-geometry conv decision "
                        "JSON (tools/conv_probe.py --geom)")
    # the multi-device flag families, spelled as the perf/serve CLIs
    # spell them; the mesh is a fake process group, so tp:4 lints in one
    # CPU process
    add_strategy_arg(p)
    add_grad_comm_args(p)
    p.add_argument("--quantize", default=None, choices=QUANTIZE_CHOICES,
                   help="lint the quantized serving decode step for this "
                        "weight/KV format (serve --quantize)")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="lint the speculative decode surface (serve "
                        "--speculate)")
    p.add_argument("--kvPageTokens", default=None, metavar="N",
                   help="lint the paged-KV decode step with N-token pages "
                        "(serve --kvPageTokens)")
    p.add_argument("--slots", type=int, default=4,
                   help="decode slots for the serving-surface lint")
    args = p.parse_args(argv)

    from bigdl_tpu_torch import tuning
    from bigdl_tpu_torch.analysis import lint_config
    from bigdl_tpu_torch.cli.common import (apply_autotune, apply_conv_args,
                                            resolve_lint_config)
    from bigdl_tpu_torch.ops.conv2d import policy_snapshot, restore_policy

    snap, mode = policy_snapshot(), tuning.get_mode()
    try:
        apply_autotune(args)
        apply_conv_args(args)
        report = lint_config(resolve_lint_config(args))
    finally:
        restore_policy(snap)
        tuning.set_mode(mode)

    print(report.render(), flush=True)
    if args.json == "-":
        print(json.dumps(report.to_json(), indent=2), flush=True)
    elif args.json:
        report.dump_json(args.json)
        print(f"lint: wrote {args.json}", flush=True)
    return report.exit_code(strict=args.strict)


if __name__ == "__main__":
    raise SystemExit(main())
