"""Start a data-parallel job of N local processes and wait for it, with a
time limit (what ``torchrun --nproc_per_node N`` does, for code that must
also get each rank's result and must never hang)::

    results = spawn("package.module:function", 2, {"key": value},
                    timeout_s=300, backend="gloo")

runs ``function(args)`` once in each of N fresh Python processes joined by
:func:`~bigdl_tpu_torch.parallel.mesh.init_distributed` (torchrun's
environment variables, a free ``localhost`` port) and returns their
JSON-able return values in rank order. A rank that exits non-zero fails
the job: the other ranks are killed and :class:`RuntimeError` carries the
tail of the failed rank's output. At ``timeout_s`` every rank is killed
and :class:`TimeoutError` is raised, so a hung collective fails the
caller instead of stalling it. Each rank runs in a session of its own;
killing kills its children too.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

__all__ = ["spawn", "free_port"]

_ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    for p in procs:
        p.wait()


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def spawn(target: str, nprocs: int, args: Optional[dict] = None,
          timeout_s: float = 300.0, backend: Optional[str] = None,
          env: Optional[dict] = None) -> list:
    """Run ``target`` ("module:function") in ``nprocs`` ranks; see the
    module docstring. ``backend`` is passed to ``init_distributed`` (None:
    NCCL with cards, gloo without); ``env`` adds variables."""
    with tempfile.TemporaryDirectory(prefix="bigdl_spawn_") as td:
        work = Path(td)
        (work / "args.json").write_text(json.dumps(args or {}))
        port = free_port()
        procs, logs = [], []
        try:
            for rank in range(nprocs):
                e = dict(os.environ, **(env or {}))
                e.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                         RANK=str(rank), WORLD_SIZE=str(nprocs),
                         LOCAL_RANK=str(rank))
                e["PYTHONPATH"] = os.pathsep.join(
                    [str(_ROOT)] + [p for p in e.get("PYTHONPATH", "")
                                    .split(os.pathsep) if p])
                log = work / f"rank{rank}.log"
                logs.append(log)
                with open(log, "wb") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "bigdl_tpu_torch.parallel.launch",
                         target, str(work)] + (["--backend", backend]
                                               if backend else []),
                        stdout=f, stderr=subprocess.STDOUT, env=e,
                        cwd=str(_ROOT), start_new_session=True))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes)
                       if c is not None and c != 0]
                if bad:
                    _kill(procs)
                    raise RuntimeError(
                        f"{target}: rank {bad[0]} of {nprocs} exited with "
                        f"{codes[bad[0]]}:\n{_tail(logs[bad[0]])}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    _kill(procs)
                    raise TimeoutError(
                        f"{target}: {nprocs} ranks did not finish in "
                        f"{timeout_s:.0f}s (killed); rank 0's output:\n"
                        f"{_tail(logs[0])}")
                time.sleep(0.05)
        finally:
            _kill(procs)
        out = []
        for rank in range(nprocs):
            out.append(json.loads((work / f"result{rank}.json").read_text()))
        return out


def _worker(target: str, work: str, backend: Optional[str]) -> None:
    from bigdl_tpu_torch.parallel.mesh import init_distributed

    init_distributed(backend=backend)
    import torch.distributed as dist

    mod, _, fn = target.partition(":")
    args = json.loads((Path(work) / "args.json").read_text())
    result = getattr(importlib.import_module(mod), fn)(args)
    rank = dist.get_rank() if dist.is_initialized() else 0
    (Path(work) / f"result{rank}.json").write_text(json.dumps(result))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.parallel.launch")
    p.add_argument("target")
    p.add_argument("work")
    p.add_argument("--backend", default=None)
    a = p.parse_args()
    _worker(a.target, a.work, a.backend)
