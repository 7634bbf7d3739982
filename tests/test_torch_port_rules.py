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


def test_the_resnet_slice_modules_are_walked():
    """The modules the import check above walks include the conv layout
    policy, the FLOP count and the conv probe."""
    import pkgutil

    import bigdl_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                                   "bigdl_tpu_torch.")}
    assert {"bigdl_tpu_torch.ops.conv2d", "bigdl_tpu_torch.utils.flops",
            "bigdl_tpu_torch.tools.conv_probe"} <= names


def test_the_parallel_modules_are_walked_and_import_no_jax():
    """The parallel package (data, fully sharded data, tensor, sequence
    and pipeline parallelism, and their point-to-point hops) is among the
    modules the import check walks, and none of its files imports jax or
    the JAX package; nor do the serving strategies' modules."""
    import pkgutil

    import bigdl_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                                   "bigdl_tpu_torch.")}
    want = {f"bigdl_tpu_torch.parallel.{m}" for m in (
        "mesh", "grad_comm", "data_parallel", "hints", "launch",
        "tensor_parallel", "p2p", "sequence", "pipeline")} | {
            "bigdl_tpu_torch.serving.sharding",
            "bigdl_tpu_torch.serving.replicas"}
    assert want <= names
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|bigdl_tpu)"
                     r"(?:\.|\s|$|,)", re.MULTILINE)
    files = sorted((PORT / "parallel").rglob("*.py"))
    assert len(files) == 10
    files += [PORT / "serving" / "sharding.py",
              PORT / "serving" / "replicas.py"]
    assert not [f.name for f in files if pat.search(f.read_text())]


def test_the_serving_front_modules_are_walked_and_import_no_jax():
    """The serving front's modules (spans, aggregation, faults and the
    supervisor, request tracing, the fleet) are among the modules the
    import check walks, and none of their files imports jax or the JAX
    package."""
    import pkgutil

    import bigdl_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                                   "bigdl_tpu_torch.")}
    want = {"bigdl_tpu_torch.obs.spans", "bigdl_tpu_torch.obs.aggregate",
            "bigdl_tpu_torch.resilience.faults",
            "bigdl_tpu_torch.resilience.supervisor",
            "bigdl_tpu_torch.serving.reqtrace", "bigdl_tpu_torch.cli.fleet"}
    want |= {f"bigdl_tpu_torch.serving.fleet.{m}" for m in (
        "control", "router", "swap", "worker")}
    assert want <= names
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|bigdl_tpu)"
                     r"(?:\.|\s|$|,)", re.MULTILINE)
    files = [PORT / (n[len("bigdl_tpu_torch."):].replace(".", "/") + ".py")
             for n in sorted(want)]
    assert all(f.is_file() for f in files)
    assert not [f.name for f in files if pat.search(f.read_text())]


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
    from bigdl_tpu_torch.cli import inception as inception_cli
    from bigdl_tpu_torch.cli import lenet as lenet_cli
    from bigdl_tpu_torch.cli import loadmodel as loadmodel_cli
    from bigdl_tpu_torch.cli import main as cli_main
    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.cli import resnet as resnet_cli
    from bigdl_tpu_torch.cli import vgg as vgg_cli
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.cli import transformerlm
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.interop import TorchObject, load_torch_module
    from bigdl_tpu_torch.optim import Optimizer
    from bigdl_tpu_torch.serving import DecodeEngine, InferenceEngine
    from bigdl_tpu_torch.tools import conv_probe
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
                                    "-b", "1", "-i", "1"]),
                 lambda: perf.main(["-m", "resnet50_fba", "-b", "1", "-i",
                                    "1"]),
                 lambda: perf.main(["-m", "resnet20_cifar", "--timeToAcc",
                                    "0.5", "-b", "2"]),
                 lambda: conv_probe.probe(),
                 lambda: resnet_cli.main(["train", "-f", str(tmp_path),
                                          "--depth", "8", "-b", "2"]),
                 lambda: lenet_cli.main(["train", "-f", str(tmp_path),
                                         "-b", "2"]),
                 lambda: lenet_cli.main(["test", "-f", str(tmp_path),
                                         "--model", str(tmp_path)]),
                 lambda: vgg_cli.main(["train", "-f", str(tmp_path), "-b",
                                       "2", "--fusedBN", "apply"]),
                 lambda: vgg_cli.main(["test", "-f", str(tmp_path),
                                       "--model", str(tmp_path)]),
                 lambda: inception_cli.main(["train", "-f", str(tmp_path),
                                             "-b", "2", "--modelName",
                                             "inception_v2", "--fusedBN",
                                             "apply"]),
                 lambda: inception_cli.main(["test", "-f", str(tmp_path),
                                             "--model", str(tmp_path)]),
                 lambda: loadmodel_cli.main(["--modelType", "bigdl",
                                             "--modelName", "alexnet",
                                             "--model", str(tmp_path), "-f",
                                             str(tmp_path)]),
                 lambda: loadmodel_cli.main(["--modelType", "torch",
                                             "--model", str(tmp_path), "-f",
                                             str(tmp_path)]),
                 lambda: cli_main.main(["inception", "train", "-f",
                                        str(tmp_path), "-b", "2"]),
                 lambda: cli_main.main(["perf", "-b", "1", "-i", "1"]),
                 lambda: load_torch_module(TorchObject("nn.ReLU", {}))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # asked for the CPU, they run
    assert DecodeEngine(_tiny_lm(), device="cpu").device.type == "cpu"
    assert InferenceEngine(_tiny_lm(), device="cpu").device.type == "cpu"
    assert Optimizer(_tiny_lm(), data, None, device="cpu").device.type == \
        "cpu"


def _bn_calls(make):
    """Each BN kernel wrapper called on (rows, C) operands from ``make``."""
    from bigdl_tpu_torch.ops import bn_kernel as bk
    x, dy = make(), make()
    vec = torch.ones(x.shape[1], device=x.device)
    return {
        "bn_stats": lambda: bk.bn_stats(x),
        "bn_bwd_stats": lambda: bk.bn_bwd_stats(dy, x, vec, vec),
        "bn_fwd_apply": lambda: bk.bn_fwd_apply(x, vec, vec, 1e-5, True),
        "bn_bwd_fused": lambda: bk.bn_bwd_fused(dy, x, vec, vec, vec, vec,
                                                True)}


def test_bn_wrappers_refuse_and_never_fall_back():
    """A dtype the kernels do not take raises on every device, and a tensor
    that is not on the CPU never reaches the plain version: a meta tensor
    (neither CPU nor CUDA) raises where a CUDA tensor would launch."""
    from bigdl_tpu_torch.ops import bn_kernel as bk
    for dtype in (torch.float16, torch.float64):
        for name, call in _bn_calls(lambda: torch.zeros(8, 4,
                                                        dtype=dtype)).items():
            with pytest.raises(ValueError, match="float32 or bfloat16"):
                call()
    for name, dtype in (("mean", torch.bfloat16), ("inv", torch.float64)):
        vecs = {"mean": torch.zeros(4), "inv": torch.ones(4)}
        vecs[name] = vecs[name].to(dtype)
        with pytest.raises(ValueError, match=f"got {name} {dtype}"):
            bk.bn_bwd_stats(torch.zeros(8, 4), torch.zeros(8, 4), **vecs)
    for name, call in _bn_calls(lambda: torch.zeros(8, 4,
                                                    device="meta")).items():
        with pytest.raises(ValueError, match="one CUDA device"):
            call()
    for name, call in _bn_calls(lambda: torch.ones(8, 4)).items():
        call()  # the plain versions, on the CPU


def test_checkpoints_graphs_and_methods_are_no_longer_refused(tmp_path):
    """What raised "not in the port yet" before checkpoints, the graphed
    step and the rest of optim came: every --optimMethod, the checkpoint
    and dispatch flags, ``resnet test`` and ``transformerlm generate``
    parse and build; no source still names them as coming later."""
    import argparse

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.cli import common
    from bigdl_tpu_torch.dataset import BatchDataSet
    p = argparse.ArgumentParser()
    common.add_train_args(p)
    data = BatchDataSet(np.zeros((4, 8), np.int32), np.zeros((4, 8),
                                                             np.int32), 2)
    kinds = {"sgd": optim.SGD, "adam": optim.Adam, "adamw": optim.AdamW,
             "adagrad": optim.Adagrad, "rmsprop": optim.RMSprop,
             "lars": optim.LARS, "lamb": optim.LAMB}
    assert set(kinds) == set(common.OPTIM_METHODS)
    for name, kind in kinds.items():
        args = p.parse_args(["--platform", "cpu", "--optimMethod", name,
                             "--stepsPerDispatch", "3", "--checkpoint",
                             str(tmp_path / "ck"), "--model",
                             str(tmp_path / "none"), "--overWriteCheckpoint",
                             "--keepCheckpoints", "2"])
        opt = common.build_optimizer(_tiny_lm(), data, None, args)
        assert type(opt.optim_method) is kind
        assert opt.steps_per_dispatch == 3
    stale = ("checkpoint reader", "rest of optim", "steps_per_dispatch > 1",
             "checkpoints (item 6)", "CUDA graphs of the train step")
    for f in sorted(PORT.rglob("*.py")):
        text = f.read_text()
        assert not [s for s in stale if s in text], f


def test_graphed_path_never_falls_back_to_eager():
    """The CUDA-graph path has no ``except`` that could run the step
    eagerly when a capture or replay fails: ``step_graph.py`` and
    ``cli/perf.py`` catch nothing, and the Optimizer catches only in its
    asynchronous checkpoint writer (the error is raised at the next
    join)."""
    import ast
    for rel, allowed in (("optim/step_graph.py", set()),
                         ("cli/perf.py", set()),
                         ("optim/optimizer.py", {"worker"})):
        owners = set()

        def visit(node, fn=None):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = node.name
            if isinstance(node, ast.Try) and node.handlers:
                owners.add(fn)
            for child in ast.iter_child_nodes(node):
                visit(child, fn)

        visit(ast.parse((PORT / rel).read_text()))
        assert owners == allowed, (rel, owners)
