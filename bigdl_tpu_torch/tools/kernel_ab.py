"""A/B of the flash forward kernel against another version of its source,
in one run on one card.

    python -m bigdl_tpu_torch.tools.kernel_ab BASELINE.cu

``BASELINE.cu`` is another version of ``ops/csrc/flash_fwd.cu``, e.g. from
git history (``git show <commit>:bigdl_tpu_torch/ops/csrc/flash_fwd.cu >
build/ab/base.cu``), with the same C entry point or the one before its
``seg`` argument (commits up to e94eaf5), which is told from the source.
Both are built with the port's nvcc flags. At each serving
prefill shape (1 batch x 8 heads x s x s x 128, causal) and at the
training step's (8 batch x 8 heads x 1024 x 1024 x 128, bf16) both are
checked against the plain version and timed as CUDA-graph replays in 10
turns (baseline then current, current then baseline, ...), and the
medians printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import torch

SHAPES = [(1, 128, "bfloat16"), (1, 512, "bfloat16"), (1, 1024, "bfloat16"),
          (1, 1024, "float32"), (8, 1024, "bfloat16")]
TURNS = 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline", type=Path)
    args = ap.parse_args(argv)
    entry = re.search(r'extern "C" int flash_fwd\(([^)]*)\)',
                      args.baseline.read_text())
    if entry is None:
        raise SystemExit(f"{args.baseline} has no extern \"C\" flash_fwd")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import attention_kernel as ak
    from bigdl_tpu_torch.tools.timing import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = _build.BUILD_DIR.parent / "ab" / f"lib{args.baseline.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(out), str(args.baseline)], check=True,
                           capture_output=True, text=True)
    _build.build_all(("flash_fwd",))
    for name, log in (("baseline", built.stdout + built.stderr),
                      ("current", _build.build_info().get(
                          "flash_fwd", {}).get("log", ""))):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}", flush=True)
    current = ak._bind("flash_fwd")
    lib = ctypes.CDLL(str(out)).flash_fwd
    lib.restype = current.restype
    if "seg" not in entry.group(1):  # drop the seg pointer (4th argument)
        lib.argtypes = current.argtypes[:3] + current.argtypes[4:]
        baseline = lambda *a: lib(*a[:3], *a[4:])  # noqa: E731
    else:
        lib.argtypes = current.argtypes
        baseline = lib
    versions = {"baseline": baseline, "current": current}

    for b, s, dt in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(s)
        q, k, v = (torch.randn(b, 8, s, 128, device="cuda", generator=g)
                   .to(getattr(torch, dt)) for _ in range(3))
        o_ref, _ = ak.flash_attention_reference(q, k, v, True)
        times = {name: [] for name in versions}
        for i in range(TURNS):
            order = ("baseline", "current") if i % 2 == 0 else (
                "current", "baseline")
            for name in order:
                ak._fns["flash_fwd"] = versions[name]
                o, _ = ak.flash_fwd(q, k, v, True)
                err = float((o.float() - o_ref.float()).abs().max())
                if err > (2e-5 if dt == "float32" else 2e-2):
                    raise SystemExit(f"{name} disagrees with the plain "
                                     f"version at s={s} {dt}: {err:.3e}")
                times[name].append(device_ms(
                    lambda: ak.flash_fwd(q, k, v, True)))
        ak._fns["flash_fwd"] = current
        med = {n: statistics.median(t) for n, t in times.items()}
        wins = sum(c < b for b, c in zip(times["baseline"], times["current"]))
        print(f"b={b} s={s} {dt}: baseline {med['baseline']:.4f} ms, current "
              f"{med['current']:.4f} ms (medians of {len(times['current'])}); "
              f"current faster in {wins} of {len(times['current'])} turns; "
              f"baseline {[round(x, 4) for x in times['baseline']]} "
              f"current {[round(x, 4) for x in times['current']]}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
