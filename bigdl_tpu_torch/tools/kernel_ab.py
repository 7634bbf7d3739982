"""A/B of a flash kernel source against another version of it, in one run
on one card.

    python -m bigdl_tpu_torch.tools.kernel_ab BASELINE.cu

``BASELINE.cu`` is another version of ``ops/csrc/flash_fwd.cu`` or of
``ops/csrc/flash_bwd.cu``, told apart by its C entry points, e.g. from git
history (``git show <commit>:bigdl_tpu_torch/ops/csrc/flash_bwd.cu >
build/ab/base.cu``). Both are built with the port's nvcc flags, the
baseline against the headers of ``ops/csrc``.

* Forward (``flash_fwd``, with or without the ``seg`` argument that
  commits up to e94eaf5 lack), causal: at each serving prefill shape (1
  batch x 8 heads x s x s x 128, and s_q = 16 against 1024 keys), at the
  training step's (8 x 8 x 1024 x 1024 x 128, bf16) and at 2 x 8 x 512 x
  512 x 64.
* Backward (``flash_dq`` and ``flash_dkv``): at the training step's shape
  and at 2 x 8 x 512 x 512 x 64, bf16, causal; both kernels and their sum.

At each shape both versions are checked against the plain version and
timed as CUDA-graph replays in 10 turns (baseline then current, current
then baseline, ...), and the medians and the turns each version won are
printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import torch

# (batch, s_q, s_k, head_dim, dtype), 8 heads
FWD_SHAPES = [(1, 128, 128, 128, "bfloat16"), (1, 512, 512, 128, "bfloat16"),
              (1, 1024, 1024, 128, "bfloat16"),
              (1, 1024, 1024, 128, "float32"),
              (8, 1024, 1024, 128, "bfloat16"),
              (1, 16, 1024, 128, "bfloat16"), (2, 512, 512, 64, "bfloat16")]
BWD_SHAPES = [(8, 1024, 128), (2, 512, 64)]  # (batch, s, head_dim), 8 heads
TURNS = 10
BWD_TOL = 2e-2  # max|d| / max|ref| of each gradient, as chip_smoke.py


def _turns(versions: dict, install, check, timed):
    """Times of ``timed`` in TURNS alternating turns of each version:
    ``install(version)`` routes the wrappers to it, ``check(name)`` holds
    its result against the plain version first."""
    times = {name: [] for name in versions}
    for i in range(TURNS):
        order = list(versions) if i % 2 == 0 else list(versions)[::-1]
        for name in order:
            install(versions[name])
            check(name)
            times[name].append(timed())
    return times


def _report(label: str, times: dict) -> None:
    med = {n: statistics.median(t) for n, t in times.items()}
    wins = sum(c < b for b, c in zip(times["baseline"], times["current"]))
    print(f"{label}: baseline {med['baseline']:.4f} ms, current "
          f"{med['current']:.4f} ms (medians of {len(times['current'])}); "
          f"current faster in {wins} of {len(times['current'])} turns; "
          f"baseline {[round(x, 4) for x in times['baseline']]} "
          f"current {[round(x, 4) for x in times['current']]}", flush=True)


def _ab_fwd(ak, device_ms, lib, entry) -> None:
    current = ak._bind("flash_fwd")
    fn = lib.flash_fwd
    fn.restype = current.restype
    if "seg" not in entry:  # drop the seg pointer (4th argument)
        fn.argtypes = current.argtypes[:3] + current.argtypes[4:]
        baseline = lambda *a: fn(*a[:3], *a[4:])  # noqa: E731
    else:
        fn.argtypes = current.argtypes
        baseline = fn
    versions = {"baseline": baseline, "current": current}
    for b, sq, sk, d, dt in FWD_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(sq + sk)
        q, k, v = (torch.randn(b, 8, n, d, device="cuda", generator=g)
                   .to(getattr(torch, dt)) for n in (sq, sk, sk))
        o_ref, _ = ak.flash_attention_reference(q, k, v, True)

        def install(version):
            ak._fns["flash_fwd"] = version

        def check(name):
            o, _ = ak.flash_fwd(q, k, v, True)
            err = float((o.float() - o_ref.float()).abs().max())
            if err > (2e-5 if dt == "float32" else 2e-2):
                raise SystemExit(f"{name} disagrees with the plain version "
                                 f"at s_q={sq} s_k={sk} d={d} {dt}: "
                                 f"{err:.3e}")

        times = _turns(versions, install, check, lambda: device_ms(
            lambda: ak.flash_fwd(q, k, v, True)))
        ak._fns["flash_fwd"] = current
        _report(f"flash_fwd b={b} h=8 s_q={sq} s_k={sk} d={d} {dt} causal",
                times)


def _ab_bwd(ak, device_ms, lib) -> None:
    current = tuple(ak._bind(n) for n in ("flash_dq", "flash_dkv"))
    baseline = (lib.flash_dq, lib.flash_dkv)
    for fn, cur in zip(baseline, current):
        fn.argtypes, fn.restype = cur.argtypes, cur.restype
    versions = {"baseline": baseline, "current": current}
    for b, s, d in BWD_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(s + d)
        q, k, v = (torch.randn(b, 8, s, d, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        # dO as autograd hands it over: a (b, s, h, d) buffer seen as
        # (b, h, s, d)
        do = torch.randn(b, s, 8, d, device="cuda", generator=g).to(
            torch.bfloat16).transpose(1, 2)
        o, lse = ak.flash_fwd(q, k, v, True)
        delta = ak._delta(o, do)
        ref = ak.flash_bwd_reference(q, k, v, o, lse, do, True)

        def install(version):
            ak._fns["flash_dq"], ak._fns["flash_dkv"] = version

        def check(name):
            got = (ak.flash_dq(q, k, v, do, lse, delta, True),) + \
                ak.flash_dkv(q, k, v, do, lse, delta, True)
            for t, r, what in zip(got, ref, ("dq", "dk", "dv")):
                err = float((t.float() - r.float()).abs().max()
                            / r.float().abs().max())
                if err > BWD_TOL:
                    raise SystemExit(f"{name} {what} disagrees with the "
                                     f"plain version at b={b} s={s} d={d}: "
                                     f"{err:.3e}")

        per = {}
        for kernel, call in (
                ("flash_dq", lambda: ak.flash_dq(q, k, v, do, lse, delta,
                                                 True)),
                ("flash_dkv", lambda: ak.flash_dkv(q, k, v, do, lse, delta,
                                                   True))):
            per[kernel] = _turns(versions, install, check,
                                 lambda: device_ms(call))
            _report(f"{kernel} b={b} h=8 s={s} d={d} bf16 causal",
                     per[kernel])
        _report(f"pair (flash_dq + flash_dkv) b={b} h=8 s={s} d={d} bf16 "
                f"causal", {n: [x + y for x, y in zip(
                    per["flash_dq"][n], per["flash_dkv"][n])]
                    for n in versions})
        install(current)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline", type=Path)
    args = ap.parse_args(argv)
    text = args.baseline.read_text()
    fwd = re.search(r'extern "C" int flash_fwd\(([^)]*)\)', text)
    bwd = re.search(r'extern "C" int flash_dq\(', text)
    if fwd is None and bwd is None:
        raise SystemExit(f"{args.baseline} has no extern \"C\" flash_fwd "
                         f"or flash_dq")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import attention_kernel as ak
    from bigdl_tpu_torch.tools.timing import device_ms

    name = "flash_fwd" if fwd is not None else "flash_bwd"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = _build.BUILD_DIR.parent / "ab" / f"lib{args.baseline.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    print(f"baseline: {args.baseline}", flush=True)
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                            "-I", str(_build.CSRC), "-o", str(out),
                            str(args.baseline)], check=True,
                           capture_output=True, text=True)
    _build.build_all((name,))
    for version, log in (("baseline", built.stdout + built.stderr),
                         ("current", _build.build_info().get(
                             name, {}).get("log", ""))):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{version}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out))
    if fwd is not None:
        _ab_fwd(ak, device_ms, lib, fwd.group(1))
    else:
        _ab_bwd(ak, device_ms, lib)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
