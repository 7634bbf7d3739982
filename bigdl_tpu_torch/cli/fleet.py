"""The serving fleet's front door (counterpart of
``bigdl_tpu/cli/fleet.py``): ``serve --fleet K`` with the fleet as the
default. The same flags as ``serve``; this process is always the router,
and ``--fleet`` defaults to 2 workers::

    python -m bigdl_tpu_torch.cli.fleet transformer_lm_1k_hd128 \\
        --model CKPT --fleet 2 -p 8000
    curl -d '{"checkpoint": "CKPT2", "version": "v1"}' \\
        localhost:8000/admin/reload

The router imports no torch; each worker
(``python -m bigdl_tpu_torch.serving.fleet.worker``) runs on the card
unless ``--platform cpu`` is given, and takes ``--strategy``: ``dp:N``
is one worker process of N replicas, ``tp:K`` and ``dp:N+tp:K`` a group
of K rank processes that start, die and restart together::

    python -m bigdl_tpu_torch.cli.fleet transformer_lm_1k_hd128 \
        --model CKPT --fleet 2 --strategy tp:2 --no-warmup -p 8000
"""

from __future__ import annotations

import sys

from bigdl_tpu_torch.cli import common

__all__ = ["build_parser", "main"]


def build_parser():
    from bigdl_tpu_torch.cli import serve as serve_cli
    p = serve_cli.build_parser()
    p.prog = "python -m bigdl_tpu_torch.cli.fleet"
    p.set_defaults(fleet=2)
    return p


def main(argv=None) -> int:
    common.setup_logging()
    raw_argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(raw_argv)
    if int(args.fleet) < 1:
        raise SystemExit("fleet: --fleet must be >= 1 (use cli.serve for "
                         "the single-process stack)")
    from bigdl_tpu_torch.serving.fleet.router import run_fleet
    return run_fleet(args, raw_argv)


if __name__ == "__main__":
    raise SystemExit(main())
