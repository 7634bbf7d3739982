"""One launcher for every CLI of the port (counterpart of
``bigdl_tpu/cli/main.py``, the ``bigdl-tpu`` console entry point)::

    python -m bigdl_tpu_torch.cli.main lenet train -f /data/mnist -b 128
    python -m bigdl_tpu_torch.cli.main perf -m inception_v1 -b 32
    python -m bigdl_tpu_torch.cli.main loadmodel --modelType caffe ...

Each command of the JAX package's table forwards to the matching
``bigdl_tpu_torch.cli.<module>.main(argv)``, so ``... cli.main lenet
...`` and ``python -m bigdl_tpu_torch.cli.lenet ...`` are the same
surface. The port installs no console script.
"""

from __future__ import annotations

import importlib
import sys
from typing import List, Optional

__all__ = ["main"]

# command -> cli module name (all expose main(argv)), the JAX table
_COMMANDS = {
    "lenet": "lenet",
    "vgg": "vgg",
    "resnet": "resnet",
    "inception": "inception",
    "rnn": "rnn",
    "autoencoder": "autoencoder",
    "transformerlm": "transformerlm",
    "textclassification": "textclassification",
    "perf": "perf",
    "explain": "explain",
    "lint": "lint",
    "serve": "serve",
    "fleet": "fleet",
    "predict": "predict",
    "batch-predict": "batch_predict",
    "loadmodel": "loadmodel",
    "record-gen": "record_gen",
}
def _usage() -> str:
    cmds = "\n".join(f"  {name}" for name in _COMMANDS)
    return ("bigdl_tpu_torch, the PyTorch port of bigdl-tpu\n\n"
            "usage: python -m bigdl_tpu_torch.cli.main <command> "
            f"[args...]\n\ncommands:\n{cmds}\n\n"
            "run `python -m bigdl_tpu_torch.cli.main <command> --help` "
            "for per-command flags\n")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    if argv[0] == "--version":
        from bigdl_tpu_torch import __version__

        print(__version__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in _COMMANDS:
        print(f"bigdl_tpu_torch: unknown command {cmd!r}\n\n{_usage()}",
              file=sys.stderr)
        return 2
    mod = importlib.import_module(f"bigdl_tpu_torch.cli.{_COMMANDS[cmd]}")
    rc = mod.main(rest)
    # subcommand mains return rich values (optimize() results, metrics) —
    # only a genuine int is an exit code (bool True must not become 1)
    return rc if isinstance(rc, int) and not isinstance(rc, bool) else 0


if __name__ == "__main__":
    raise SystemExit(main())
