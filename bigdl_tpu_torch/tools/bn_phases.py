"""Where the time of each BN kernel goes inside one launch, on the card.

    python -m bigdl_tpu_torch.tools.bn_phases

Builds ``ops/csrc/bn.cu`` with ``-DBN_STAMPS``: every CTA's first thread
writes ``%globaltimer`` at the kernel's start, at the end of phase 0, past
the first barrier, after the finalisation, past the second barrier and at
the end of phase 1 (the modes that have one). The launches are the
wrappers' own (plan, grid, CTAs), with a sync buffer long enough for the
stamps. For each mode at each of ``kernel_ab.BN_CASES`` it prints, in µs
after the first CTA started, medians of 10 eager calls after 2 warm-up
calls: the last CTA's start, the first and last CTA's end of phase 0, the
last CTA past barrier 1, the last finalised, the last past barrier 2, and
the first and last CTA's end of phase 1. The span from the first start
to the last end is the kernel's body; launch and drain are outside it.
Prints the card's name and power limit first; needs a card.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

CALLS, WARMUP = 10, 2
MODES = ("stats", "fwd", "bwd_stats", "bwd_fused")


def _build_stamped():
    from bigdl_tpu_torch.ops import _build
    out = _build.BUILD_DIR.parent / "ab" / "libbn_stamps.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DBN_STAMPS", "-o",
                    str(out), str(_build.CSRC / "bn.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def _phases(lib, bk, mode, x, dy, vecs):
    """Per-call stamps of ``mode`` on (rows, C) ``x``: a list of CALLS
    rows, each the stamp columns (µs after the first CTA's start)."""
    rows, c = x.shape
    is_bf16, emits = int(x.dtype == torch.bfloat16), mode in (1, 3)
    mats = (x,) if mode < 2 else (dy, x)
    vec = bk._vec(c, mats)
    n = ctypes.c_int(0)
    bk._raise_on(lib.bn_coop_ctas(mode, is_bf16, int(emits), vec, 0,
                                  ctypes.byref(n)), "bn_coop_ctas")
    p = bk._plan(mode, rows, c, vec, n.value)
    sync = torch.zeros(64 + 16 * p.grid, dtype=torch.int32, device="cuda")
    out0, out1 = (torch.empty(c, device="cuda") for _ in range(2))
    part = torch.empty((2, p.slabs, c), device="cuda")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    got = []
    for i in range(WARMUP + CALLS):
        bk._raise_on(lib.bn_coop(
            mode, is_bf16, int(emits), vec, p.tx, p.grid, p.slabs, p.slab,
            mats[0].data_ptr(), bk._ptr(mats[1] if mode >= 2 else None),
            *(v.data_ptr() for v in vecs), part.data_ptr(), sync.data_ptr(),
            out0.data_ptr(), out1.data_ptr(), y.data_ptr(), rows, c, 1e-5, 0,
            stream), "bn_coop")
        torch.cuda.synchronize()
        ts = sync[64:].view(torch.int64).view(p.grid, 8)[:, :6 if emits
                                                         else 4]
        us = ((ts - ts[:, 0].min()).double() / 1e3).cpu()
        if i >= WARMUP:
            got.append([float(us[:, 0].max()), float(us[:, 1].min()),
                        float(us[:, 1].max()), float(us[:, 2].max()),
                        float(us[:, 3].max())]
                       + ([float(us[:, 4].max()), float(us[:, 5].min()),
                           float(us[:, 5].max())] if emits else []))
    return p, got


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from bigdl_tpu_torch.ops import bn_kernel as bk
    from bigdl_tpu_torch.tools.kernel_ab import BN_CASES
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = _build_stamped()
    for name in ("bn_coop", "bn_coop_ctas"):
        fn, cur = getattr(lib, name), bk._bind(name)
        fn.argtypes, fn.restype = cur.argtypes, cur.restype
    for rows, c, dt in BN_CASES:
        g = torch.Generator(device="cuda").manual_seed(rows + c)
        x = (torch.randn(rows, c, device="cuda", generator=g) * 1.5
             + 0.3).to(getattr(torch, dt))
        dy = torch.randn(rows, c, device="cuda", generator=g).to(x.dtype)
        vecs = (torch.zeros(c, device="cuda"), torch.ones(c, device="cuda"),
                torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"))
        for mode, label in enumerate(MODES):
            p, got = _phases(lib, bk, mode, x, dy, vecs)
            med = [statistics.median(col) for col in zip(*got)]
            line = (f"{label} rows={rows} C={c} {dt} grid {p.grid}, "
                    f"{-(-p.slab // (256 // p.tx))} rows a thread, "
                    f"read once {int(p.once)}: last start {med[0]:.1f} us; "
                    f"phase 0 ends {med[1]:.1f}..{med[2]:.1f}; past barrier "
                    f"1 {med[3]:.1f}; finalised {med[4]:.1f}")
            if len(med) > 5:
                line += (f"; past barrier 2 {med[5]:.1f}; phase 1 ends "
                         f"{med[6]:.1f}..{med[7]:.1f}")
            print(line, flush=True)
        del x, dy
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
