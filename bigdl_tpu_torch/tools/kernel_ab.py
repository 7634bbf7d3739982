"""A/B of a kernel source against another version of it, in one run on
one card.

    python -m bigdl_tpu_torch.tools.kernel_ab BASELINE.cu

``BASELINE.cu`` is another version of ``ops/csrc/flash_fwd.cu``,
``ops/csrc/flash_bwd.cu`` or ``ops/csrc/bn.cu``, told apart by its C entry
points, e.g. from git history (``git show <commit>:bigdl_tpu_torch/ops/
csrc/flash_bwd.cu > build/ab/base.cu``). Both are built with the port's
nvcc flags, the baseline against the headers of ``ops/csrc``.

* Forward (``flash_fwd``, with or without the ``seg`` argument that
  commits up to e94eaf5 lack), causal: at each serving prefill shape (1
  batch x 8 heads x s x s x 128, and s_q = 16 against 1024 keys), at the
  training step's (8 x 8 x 1024 x 1024 x 128, bf16) and at 2 x 8 x 512 x
  512 x 64.
* Backward (``flash_dq`` and ``flash_dkv``): at the training step's shape
  and at 2 x 8 x 512 x 512 x 64, bf16, causal; both kernels and their sum.
* Batch norm (``bn_coop`` or ``bn_bwd``): ``bn_bwd_stats``,
  ``bn_bwd_fused`` (ReLU on and off), ``bn_stats`` and ``bn_fwd_apply``
  (ReLU on) at ResNet-50's BN shapes in bf16 and ResNet-20's in f32
  (``BN_CASES``), each row with its bytes bound (every input read once,
  every output written once, over 3.35 TB/s). A baseline with the current
  C entry point (``bn_coop``) runs behind the current wrappers; one whose
  forward is ``bn_reduce`` + ``bn_apply`` after a memset and whose
  backward is ``bn_bwd`` (as at 7bb8de4) behind that version's wrappers
  and launch plans, kept here. Older ``bn.cu`` files (backward modes of
  ``bn_reduce``, up to 7c8a5b1) are not taken: this tool's adapter for
  them is in its history at 7bb8de4.

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
# (rows, C, dtype): chip_smoke.py's BN_SHAPES (ResNet-50's stage 1-4
# shapes at batch 128 and a ragged one) in bf16, four more of ResNet-50's
# BNs (14 x 14 x 256, 7 x 7 x 512, 28 x 28 x 128 and 14 x 14 x 1024; the
# first three fit on chip whole), and resnet_cifar(20)'s three (32 x 32 x
# 16 .. 8 x 8 x 64) in f32, as the CIFAR CLI trains it
BN_CASES = [(1605632, 64, "bfloat16"), (401408, 256, "bfloat16"),
            (100352, 512, "bfloat16"), (6272, 2048, "bfloat16"),
            (1000, 100, "bfloat16"), (25088, 256, "bfloat16"),
            (6272, 512, "bfloat16"), (100352, 128, "bfloat16"),
            (25088, 1024, "bfloat16"), (131072, 16, "float32"),
            (32768, 32, "float32"), (8192, 64, "float32")]
HBM_BYTES_PER_S = 3.35e12
BN_EPS = 1e-5
# max|d| / max|ref|, as chip_smoke.py: y/dx by dtype, then the f32 sums
BN_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
BN_SUM_TOL = 1e-4


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


def _variant_bn(bk, lib):
    """The four BN wrappers run on ``lib``, a ``bn.cu`` with the current C
    entry points: each call swaps its functions (and its own cache of CTAs
    a launch may have) into the module for the call."""
    fns, ctas = {}, {}
    for name in ("bn_coop", "bn_coop_ctas"):
        fn, cur = getattr(lib, name), bk._bind(name)
        fn.argtypes, fn.restype = cur.argtypes, cur.restype
        fns[name] = fn

    def wrap(name):
        def call(*args):
            saved_fns, saved_ctas = dict(bk._fns), dict(bk._ctas)
            bk._fns.update(fns)
            bk._ctas.clear()
            bk._ctas.update(ctas)
            try:
                return getattr(bk, name)(*args)
            finally:
                ctas.update(bk._ctas)
                bk._fns.clear()
                bk._fns.update(saved_fns)
                bk._ctas.clear()
                bk._ctas.update(saved_ctas)
        return call

    return tuple(wrap(n) for n in ("bn_stats", "bn_bwd_stats",
                                   "bn_fwd_apply", "bn_bwd_fused"))


def _baseline_bn(bk, lib):
    """The four BN wrappers of a ``bn.cu`` whose forward is ``bn_reduce``
    (a memset of its counters first) + ``bn_apply`` and whose backward is
    one cooperative ``bn_bwd`` (as at 7bb8de4), on its library ``lib``,
    with that version's launch plans. Its backward shares the current
    wrappers' barrier counters (the same protocol)."""
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    red, app, bwd, bwd_ctas = (lib.bn_reduce, lib.bn_apply, lib.bn_bwd,
                               lib.bn_bwd_ctas)
    red.argtypes = [i32] * 5 + [i64] + [ptr] * 8 + [i64, i32, f32, i32, ptr]
    app.argtypes = [i32] * 5 + [i64] + [ptr] * 3 + [i64, i32, i32, ptr]
    bwd.argtypes = [i32] * 7 + [i64] + [ptr] * 11 + [i64, i32, i32, ptr]
    bwd_ctas.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_int)]
    for fn in (red, app, bwd, bwd_ctas):
        fn.restype = i32
    ctas = {}
    f32_ = dict(dtype=torch.float32)

    def lanes(c, mats):  # (vec, tx, channel blocks)
        vec = bk._vec(c, mats)
        tx = 1
        while tx < min(32, -(-c // vec)):
            tx *= 2
        return vec, tx, -(-c // (tx * vec))

    def reduce(mode, x, gamma=None, beta=None, eps=0.0):
        # ~4 CTAs an SM, at least 4 rows a thread per slab
        rows, c = x.shape
        vec, tx, blocks = lanes(c, (x,))
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        slabs = max(1, min(-(-rows // (4 * (256 // tx))),
                           -(-4 * sms // blocks), 65535))
        slab = -(-rows // slabs)
        slabs = -(-rows // slab)
        out0, out1 = (torch.empty(c, device=x.device, **f32_)
                      for _ in range(2))
        aux = torch.empty((2, c), device=x.device, **f32_) if mode else None
        part = torch.empty((2, slabs, c), device=x.device, **f32_)
        count = torch.zeros(blocks, dtype=torch.int32, device=x.device)
        bk._raise_on(red(mode, bk._DTYPES[x.dtype], vec, tx, slabs, slab,
                         x.data_ptr(), bk._ptr(gamma), bk._ptr(beta),
                         part.data_ptr(), count.data_ptr(), out0.data_ptr(),
                         out1.data_ptr(), bk._ptr(aux), rows, c, float(eps),
                         *bk._stream(x)), "baseline bn_reduce")
        return out0, out1, aux, (vec, tx, slabs, slab)

    def bn_stats(x):
        return reduce(0, x)[:2]

    def bn_fwd_apply(x, gamma, beta, eps, relu):
        mean, var, aux, (vec, tx, slabs, slab) = reduce(2, x, gamma, beta,
                                                        eps)
        y = torch.empty_like(x)
        bk._raise_on(app(bk._DTYPES[x.dtype], int(relu), vec, tx, slabs,
                         slab, x.data_ptr(), aux.data_ptr(), y.data_ptr(),
                         x.shape[0], x.shape[1], *bk._stream(x)),
                     "baseline bn_apply")
        return y, mean, var

    def backward(fused, dy, x, mean, inv, gamma=None, beta=None,
                 relu=False):
        # one (channel block, slab) a CTA, at least 8 rows a thread
        rows, c = x.shape
        is_bf16, relu = bk._DTYPES[x.dtype], bool(relu) and fused
        vec, tx, blocks = lanes(c, (dy, x))
        key = (fused, is_bf16, relu, vec)
        if key not in ctas:
            n = ctypes.c_int(0)
            bk._raise_on(bwd_ctas(int(fused), is_bf16, int(relu), vec,
                                  x.device.index or 0, ctypes.byref(n)),
                         "baseline bn_bwd_ctas")
            ctas[key] = n.value
        slabs = max(1, min(ctas[key] // blocks,
                           -(-rows // (8 * (256 // tx)))))
        slab = -(-rows // slabs)
        slabs = -(-rows // slab)
        sdy, sdyx = (torch.empty(c, device=x.device, **f32_)
                     for _ in range(2))
        part = torch.empty((2, slabs, c), device=x.device, **f32_)
        dx = torch.empty_like(x) if fused else None
        index, stream = bk._stream(x)
        sync = bk._sync(x.device, stream)
        bk._raise_on(bwd(int(fused), is_bf16, int(relu), vec, tx,
                         min(ctas[key], blocks * slabs), slabs, slab,
                         dy.data_ptr(), x.data_ptr(), mean.data_ptr(),
                         inv.data_ptr(), bk._ptr(gamma), bk._ptr(beta),
                         part.data_ptr(), sync.data_ptr(), sdy.data_ptr(),
                         sdyx.data_ptr(), bk._ptr(dx), rows, c, index,
                         stream), "baseline bn_bwd")
        return sdy, sdyx, dx

    def bn_bwd_stats(dy, x, mean, inv):
        return backward(False, dy, x, mean, inv)[:2]

    def bn_bwd_fused(dy, x, mean, inv, gamma, beta, relu):
        sdy, sdyx, dx = backward(True, dy, x, mean, inv, gamma, beta, relu)
        return dx, sdy, sdyx

    return bn_stats, bn_bwd_stats, bn_fwd_apply, bn_bwd_fused


def _bn_bound_ms(label: str, rows: int, c: int, item: int) -> float:
    """Bytes bound of one BN call: each (rows, C) input read once and
    output written once, over HBM_BYTES_PER_S (the (C,) vectors left
    out)."""
    mats = {"bn_stats": 1, "bn_bwd_stats": 2, "bn_fwd_apply": 2,
            "bn_bwd_fused": 3}[label.split()[0]]
    return 1e3 * mats * rows * c * item / HBM_BYTES_PER_S


def _ab_bn(bk, device_ms, lib, variant: bool) -> None:
    b_stats, b_bwd_stats, b_fwd_apply, b_bwd_fused = (
        _variant_bn if variant else _baseline_bn)(bk, lib)
    for rows, c, dt in BN_CASES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(rows + c)
        x = (torch.randn(rows, c, device="cuda", generator=g) * 1.5
             + 0.3).to(dtype)
        dy = torch.randn(rows, c, device="cuda", generator=g).to(dtype)
        gamma = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
        beta = 0.2 * torch.randn(c, device="cuda", generator=g)
        _, mean, var = bk.bn_fwd_apply_reference(x, gamma, beta, BN_EPS)
        inv = torch.rsqrt(var + BN_EPS)
        sums = [BN_SUM_TOL] * 2
        cases = {"bn_bwd_stats": (
            lambda: b_bwd_stats(dy, x, mean, inv),
            lambda: bk.bn_bwd_stats(dy, x, mean, inv),
            lambda: bk.bn_bwd_stats_reference(dy, x, mean, inv), sums)}
        for relu in (True, False):
            cases[f"bn_bwd_fused relu={int(relu)}"] = (
                lambda r=relu: b_bwd_fused(dy, x, mean, inv, gamma, beta, r),
                lambda r=relu: bk.bn_bwd_fused(dy, x, mean, inv, gamma,
                                               beta, r),
                lambda r=relu: bk.bn_bwd_fused_reference(
                    dy, x, mean, inv, gamma, beta, r), [BN_TOL[dt]] + sums)
        cases["bn_stats"] = (lambda: b_stats(x), lambda: bk.bn_stats(x),
                             lambda: bk.bn_stats_reference(x), sums)
        cases["bn_fwd_apply relu=1"] = (
            lambda: b_fwd_apply(x, gamma, beta, BN_EPS, True),
            lambda: bk.bn_fwd_apply(x, gamma, beta, BN_EPS, True),
            lambda: bk.bn_fwd_apply_reference(x, gamma, beta, BN_EPS, True),
            [BN_TOL[dt]] + sums)
        for label, (base, cur, plain, tols) in cases.items():
            ref = plain()
            chosen = {}

            def install(fn):
                chosen["fn"] = fn

            def check(name):
                got = chosen["fn"]()
                errs = [float((a.float() - r.float()).abs().max()
                              / r.float().abs().max().clamp_min(1e-30))
                        for a, r in zip(got, ref)]
                if any(e > t for e, t in zip(errs, tols)):
                    raise SystemExit(f"{name} {label} disagrees with the "
                                     f"plain version at rows={rows} C={c}: "
                                     f"{errs}")

            times = _turns({"baseline": base, "current": cur}, install, check,
                           lambda: device_ms(chosen["fn"]))
            bound = _bn_bound_ms(label, rows, c, x.element_size())
            _report(f"{label} rows={rows} C={c} {dt} (bound {bound:.4f} ms)",
                    times)
            del ref
        del x, dy
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline", type=Path)
    args = ap.parse_args(argv)
    text = args.baseline.read_text()
    fwd = re.search(r'extern "C" int flash_fwd\(([^)]*)\)', text)
    bwd = re.search(r'extern "C" int flash_dq\(', text)
    bn = re.search(r'extern "C" int bn_(coop|bwd)\(', text)
    if fwd is None and bwd is None and bn is None:
        raise SystemExit(f"{args.baseline} has no extern \"C\" flash_fwd, "
                         f"flash_dq, bn_coop or bn_bwd")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import attention_kernel as ak
    from bigdl_tpu_torch.tools.timing import device_ms

    name = ("flash_fwd" if fwd is not None else
            "flash_bwd" if bwd is not None else "bn")
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
    elif bwd is not None:
        _ab_bwd(ak, device_ms, lib)
    else:
        from bigdl_tpu_torch.ops import bn_kernel as bk
        _ab_bn(bk, device_ms, lib, variant=bn.group(1) == "coop")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
