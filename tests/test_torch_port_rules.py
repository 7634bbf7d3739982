"""Rules the PyTorch port keeps: it imports neither jax nor the JAX
package (not even modules of it that do not import jax), and its entry
points run on CUDA unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "bigdl_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "bigdl_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import bigdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                               "bigdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu"))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_bigdl_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every submodule was imported


def test_no_source_file_imports_jax_or_bigdl_tpu():
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|bigdl_tpu)"
                     r"(?:\.|\s|$|,)", re.MULTILINE)
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pat.search(f.read_text())]
    assert not offenders, offenders
    # the pattern does catch the forms it must, and spares the port's name
    assert pat.search("    from bigdl_tpu.serving import x\n")
    assert pat.search("import jax\n") and pat.search("import bigdl_tpu\n")
    assert not pat.search("from bigdl_tpu_torch.ops import x\n")


def _tiny_lm():
    from bigdl_tpu_torch.models import TransformerLM
    return TransformerLM(50, d_model=32, num_layers=1, num_heads=2,
                         max_len=32)


def test_entry_points_refuse_a_silent_cpu_run(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("torch.cuda is available: the no-CUDA rule cannot be "
                    "shown on this machine")
    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.cli import transformerlm
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.optim import Optimizer
    from bigdl_tpu_torch.serving import DecodeEngine, InferenceEngine
    (tmp_path / "input.txt").write_text("the cat sat on the mat . " * 200)
    data = BatchDataSet(np.zeros((4, 8), np.int32), np.zeros((4, 8),
                                                             np.int32), 2)
    for make in (lambda: DecodeEngine(_tiny_lm()),
                 lambda: InferenceEngine(_tiny_lm()),
                 lambda: serve_cli.build_app(serve_cli.build_parser()
                                             .parse_args(["transformer_lm",
                                                          "--randomInit"])),
                 lambda: Optimizer(_tiny_lm(), data, None),
                 lambda: transformerlm.main(
                     ["train", "-f", str(tmp_path), "--dModel", "16",
                      "--numLayers", "1", "--numHeads", "2",
                      "--seqLength", "16", "-b", "2"]),
                 lambda: perf.main(["-m", "transformer_lm", "--seq", "16",
                                    "-b", "1", "-i", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # asked for the CPU, they run
    assert DecodeEngine(_tiny_lm(), device="cpu").device.type == "cpu"
    assert InferenceEngine(_tiny_lm(), device="cpu").device.type == "cpu"
    assert Optimizer(_tiny_lm(), data, None, device="cpu").device.type == \
        "cpu"
