"""Per-pass conv layout probe on the card (counterpart of the JAX
package's ``scripts/conv_bwd_probe.py`` and of ``scripts/
apply_conv_probe.py --geom``)::

    python -m bigdl_tpu_torch.tools.conv_probe [--iters 20] [--geom OUT]

For each of ResNet-50's representative conv shapes at batch 128 in bf16
(:data:`SHAPES`, the JAX probe's), times the three passes (forward,
input gradient, weight gradient) under NHWC, NCHW and, at a 1x1/stride-1
site, GEMM, each as ``ops/conv2d.py`` runs it under the policy (an NCHW
pass includes its copies to and from NCHW), with ``tools/timing.
device_ms`` (CUDA-graph replays, CUDA events). Prints one JSON row per
(shape, layout), the JAX probe's fields: the geometry, ``<pass>_ms`` and
``<pass>_tfs`` (TF/s from ``utils/flops.conv_unit_flops``, one number for
all three passes), the card's name. ``--geom OUT`` writes
``decide_geom_from_probe``'s per-geometry decisions to OUT, the file
``--convGeom`` takes. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from bigdl_tpu_torch.ops import conv2d as c2d
from bigdl_tpu_torch.tools.timing import device_ms
from bigdl_tpu_torch.utils.flops import conv_unit_flops

__all__ = ["SHAPES", "probe", "main"]

# (name, batch, h, w, cin, cout, k, stride), the JAX probe's shapes
SHAPES = [
    ("stem7x7s2", 128, 224, 224, 3, 64, 7, 2),
    ("s1_3x3", 128, 56, 56, 64, 64, 3, 1),
    ("s2_3x3", 128, 28, 28, 128, 128, 3, 1),
    ("s3_3x3", 128, 14, 14, 256, 256, 3, 1),
    ("s4_3x3", 128, 7, 7, 512, 512, 3, 1),
    ("s2_1x1", 128, 28, 28, 512, 128, 1, 1),
    ("s1_1x1_expand", 128, 56, 56, 64, 256, 1, 1),
    ("s1_1x1_reduce", 128, 56, 56, 256, 64, 1, 1),
]


def probe(iters: int = 20, shapes=SHAPES, out=sys.stdout) -> list:
    """Time every (shape, layout, pass) and print the rows; returns them."""
    if not torch.cuda.is_available():
        raise RuntimeError("the conv probe times the card: CUDA is not "
                           "available")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, b, h, w_, cin, cout, k, stride in shapes:
        pad = (k - 1) // 2
        ho, wo = (h + 2 * pad - k) // stride + 1, (w_ + 2 * pad - k) // \
            stride + 1
        flops = conv_unit_flops(b, ho, wo, cin, cout, k, k)
        x = torch.randn(b, h, w_, cin, device=dev, dtype=torch.bfloat16,
                        generator=gen)
        w = torch.randn(cout, cin, k, k, device=dev, dtype=torch.bfloat16,
                        generator=gen).contiguous(
                            memory_format=torch.channels_last)
        dy = torch.randn(b, ho, wo, cout, device=dev, dtype=torch.bfloat16,
                         generator=gen)
        args = ((stride, stride), (pad, pad), (1, 1), 1)
        layouts = ["NHWC", "NCHW"]
        if c2d.gemm_eligible(k, k, (stride, stride), ((pad, pad),) * 2,
                             (1, 1), 1):
            layouts.append("GEMM")
        for lay in layouts:
            row = {"shape": tag, "layout": lay,
                   "gflops": round(flops / 1e9, 1), "kh": k, "kw": k,
                   "stride": [stride, stride], "cin": cin, "cout": cout,
                   "groups": 1, "dilation": [1, 1], "dtype": "bfloat16",
                   "device": name}
            for pname, fn in (
                    ("fwd", lambda: c2d._conv_fwd(x, w, *args, lay)),
                    ("dgrad", lambda: c2d._conv_dgrad(dy, x, w, *args,
                                                      lay)),
                    ("wgrad", lambda: c2d._conv_wgrad(dy, x, w, *args,
                                                      lay))):
                ms = device_ms(fn, iters=iters)
                row[f"{pname}_ms"] = round(ms, 4)
                row[f"{pname}_tfs"] = round(flops / ms / 1e9, 2)
            print(json.dumps(row), file=out, flush=True)
            rows.append(row)
        del x, w, dy
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser("python -m bigdl_tpu_torch.tools.conv_probe")
    p.add_argument("--iters", type=int, default=20,
                   help="calls per timed CUDA graph")
    p.add_argument("--geom", default=None, metavar="OUT",
                   help="write the per-geometry decisions (--convGeom's "
                        "file) to OUT")
    args = p.parse_args(argv)
    rows = probe(args.iters)
    if args.geom:
        decisions = c2d.decide_geom_from_probe(json.dumps(r) for r in rows)
        with open(args.geom, "w") as f:
            json.dump({"decisions": decisions}, f, indent=1, sort_keys=True)
            f.write("\n")
    return rows


if __name__ == "__main__":
    main()
