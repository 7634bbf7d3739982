"""Device-time attribution: where each step-millisecond went
(counterpart of ``bigdl_tpu/obs/attrib.py``).

Every device event of a ``torch.profiler`` capture (``utils/kineto``:
CUDA kernels, copies and sets; a CPU-only trace's host operators) is
classified into the fixed taxonomy :data:`CATEGORIES`, the
**collective** category is broken out per collective kind (all-reduce,
all-gather, reduce-scatter, all-to-all, permute, broadcast: the name
patterns of ``utils/kineto.collectives``), and the flops-bearing
categories are joined against the analytic numerators of
``utils/flops.step_flops_by_kind`` for achieved-vs-roofline utilization
and an MFU decomposition::

    MFU(device) = compute_frac x compute_util
      compute_frac = (matmul+conv time) / total device time
      compute_util = achieved TF/s while in matmul/conv ops / peak

The names are CUDA kernel names, not HLO labels, so the rules are new
(:data:`_RULES`, first match wins); JAX's HLO rules are kept beside them,
so a label classifies the same in both packages:

* ``attention``: the flash kernels (``flash_fwd_sm90<...>``,
  ``flash_dq_bf16``, ``flash_dkv_bf16``, the f32 and mma.sync ones);
* ``bn_norm``: ``bn_coop_kernel`` (the four BN modes), cuDNN's and
  PyTorch's batch- and layer-norm kernels;
* ``conv``: cuDNN and CUTLASS convolutions (``*fprop*``, ``*dgrad*``,
  ``*wgrad*``, ``*implicit_gemm*``, ``*convolve*``) and cuDNN's layout
  transforms, tested before ``matmul`` since ``implicit_gemm`` contains
  "gemm";
* ``matmul``: cuBLAS and cuBLASLt (``nvjet_*``, ``*xmma_gemm*``,
  ``cutlass*gemm*``, ``*gemm*``, ``gemv*``), and ``aten::mm``-family
  host operators;
* ``collective``: NCCL kernels (``ncclDevKernel_AllReduce_*`` ...);
* ``infeed``: ``Memcpy HtoD``/``DtoH``;
* ``elementwise``: ``at::native`` elementwise, reduce and indexing
  kernels, ``CatArrayBatchedCopy``, ``Memcpy DtoD``, ``Memset``, the
  optimizer's multi-tensor kernels, pooling, and a loss's log-softmax
  (tested first: XLA fuses it into an elementwise fusion);
* ``host_other``: whatever none claims (the honest remainder).

Under gloo the collectives run on the host: on a shared card they show
only as copies (``infeed``/``elementwise``), and ``collective_s`` reads
0. Surfaces: ``cli/explain.py``, the post-capture attribution of
``obs/capture.py`` (``compact`` into every verified window, ``attrib_*``
gauges) and the ``collective_s``/``collective_frac``/``attrib`` columns
of ``cli.perf``'s line. No dependency beyond the stdlib: a renamed
kernel degrades to ``host_other``, never to a crash."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from bigdl_tpu_torch.utils.kineto import (XPlane, collective_kind,
                                          device_planes, find_trace,
                                          op_totals, parse_trace)

__all__ = ["CATEGORIES", "ATTRIB_CATEGORIES", "classify_op", "attribute",
           "attribute_profile", "compact", "publish", "render"]

# the fixed taxonomy, in display order; ``host_other`` is the honest
# remainder: attribution that cannot name a category must not hide it
CATEGORIES: Tuple[str, ...] = (
    "matmul", "conv", "bn_norm", "attention", "elementwise", "collective",
    "infeed", "host_other")
ATTRIB_CATEGORIES = CATEGORIES

# first match wins, most specific first: collectives are matched by
# collective_kind() before these; ``convert`` is elementwise (not
# ``conv``); ``implicit_gemm`` is conv (not matmul); ``Memcpy HtoD`` is
# infeed where ``Memcpy DtoD`` is elementwise. Each rule is JAX's HLO
# pattern, then the CUDA kernel names.
_RULES: Tuple[Tuple[str, "re.Pattern[str]"], ...] = (
    # a loss's log-softmax (``cunn_SoftMaxForward<...LogSoftMax...>``),
    # which XLA fuses into an elementwise fusion, is no attention
    ("elementwise", re.compile(r"logsoftmax", re.I)),
    ("infeed", re.compile(
        r"infeed|outfeed|host[-_]?transfer|host[-_]?to[-_]?device|"
        r"device[-_]?to[-_]?host|\bsend\b|\brecv\b|"
        r"memcpy\s*(?:htod|dtoh)", re.I)),
    ("attention", re.compile(
        r"attention|flash|\bmha\b|softmax|attn", re.I)),
    ("bn_norm", re.compile(
        r"batch[-_]?norm|layer[-_]?norm|rms[-_]?norm|group[-_]?norm|"
        r"\bbn_|_bn\b|batchnorm|layernorm|rmsnorm", re.I)),
    ("conv", re.compile(
        r"convolution|conv_general|conv2d|\bconv\b|dgrad|wgrad|"
        r"fprop|implicit_?gemm|convolve|nchw_?to_?nhwc|nhwc_?to_?nchw",
        re.I)),
    ("matmul", re.compile(
        r"dot_general|\bdot\b|dot\.|matmul|\bgemm\b|einsum|\bmxu\b|"
        r"gemm|gemv|nvjet|cublas|aten::(?:add|b|badd)?mm\b|aten::linear",
        re.I)),
    ("elementwise", re.compile(
        r"fusion|loop|copy|convert|transpose|reshape|broadcast|slice|"
        r"concatenate|\bpad\b|pad\.|select|compare|reduce|scatter|gather|"
        r"\badd\b|add\.|multiply|subtract|divide|\bmax\b|max\.|\bmin\b|"
        r"min\.|\bexp\b|exp\.|\blog\b|log\.|tanh|rsqrt|iota|\brng\b|"
        r"bitcast|tuple|\bsort\b|sort\.|cumsum|clamp|\babs\b|abs\.|"
        r"\bpower\b|negate|sign|floor|\band\b|\bor\b|\bnot\b|"
        r"dynamic[-_]?update|dynamic[-_]?slice|while|custom[-_]?call|"
        r"elementwise|memcpy|memset|multi_tensor_apply|pool|indexing|"
        r"index_|at::native::",
        re.I)),
)


def classify_op(name: str) -> Tuple[str, Optional[str]]:
    """``label -> (category, collective_kind|None)``; labels no rule
    claims land in ``host_other``."""
    kind = collective_kind(name)
    if kind is not None:
        return "collective", kind
    for cat, pat in _RULES:
        if pat.search(name):
            return cat, None
    return "host_other", None


def attribute(planes: Sequence[XPlane], steps: Optional[int] = None,
              step_flops: Optional[float] = None,
              flops_by_kind: Optional[dict] = None,
              peak_flops: Optional[float] = None,
              top_ops: int = 3) -> dict:
    """Classify every device op of ``planes`` into the taxonomy.

    Returns the full attribution dict: ``total_device_s`` (sum of event
    durations over all device planes — on an N-device mesh this is
    device-seconds, N x wall), per-category ``{time_s, frac, count,
    ops, top}``, the per-collective-kind breakout, and — when
    ``step_flops``/``peak_flops`` are given (per step / whole-mesh) —
    per-category FLOP share, achieved TF/s, roofline utilization, and
    the MFU decomposition above. Host-only captures (CPU test runs with
    no accelerator plane) fall back to every plane carrying events, so
    the answer degrades to host-op categories instead of emptiness."""
    planes = list(planes)
    dev = device_planes(planes)
    if not any(ln.events for p in dev for ln in p.lines):
        dev = [p for p in planes if any(ln.events for ln in p.lines)]
    totals = op_totals(dev)

    cats: Dict[str, dict] = {
        c: {"time_s": 0.0, "count": 0, "ops": 0, "top": []}
        for c in CATEGORIES}
    colls: Dict[str, dict] = {}
    total_ps = 0.0
    for name, ent in totals.items():
        ps, cnt = ent["total_ps"], int(ent["count"])
        total_ps += ps
        cat, kind = classify_op(name)
        c = cats[cat]
        c["time_s"] += ps / 1e12
        c["count"] += cnt
        c["ops"] += 1
        c["top"].append((ps, name))
        if kind is not None:
            k = colls.setdefault(kind, {"time_s": 0.0, "count": 0})
            k["time_s"] += ps / 1e12
            k["count"] += cnt

    total_s = total_ps / 1e12
    for c in cats.values():
        c["frac"] = (c["time_s"] / total_s) if total_s else 0.0
        c["top"] = [n for _, n in
                    sorted(c["top"], key=lambda t: -t[0])[:top_ops]]
    for k in colls.values():
        k["frac"] = (k["time_s"] / total_s) if total_s else 0.0

    coll_s = cats["collective"]["time_s"]
    out = {
        "total_device_s": total_s,
        "steps": steps,
        "device_planes": len(dev),
        "categories": cats,
        "collectives": colls,
        "collective_s": coll_s,
        "collective_frac": cats["collective"]["frac"],
    }
    if steps:
        out["per_step_ms"] = {c: cats[c]["time_s"] * 1e3 / steps
                              for c in CATEGORIES}
        out["collective_s_per_step"] = coll_s / steps

    # ----- flops join: share of the numerator + roofline utilization
    if step_flops:
        kinds = dict(flops_by_kind or {})
        if not kinds:
            kinds = {"matmul": float(step_flops), "conv": 0.0}
        window = float(steps or 1)
        tot_f = float(step_flops) * window
        for cat in CATEGORIES:
            f = kinds.get(cat, 0.0) * window
            c = cats[cat]
            c["flop_share"] = (f / tot_f) if tot_f else 0.0
            if f and c["time_s"]:
                c["achieved_tflops"] = f / c["time_s"] / 1e12
                if peak_flops:
                    c["roofline_util"] = f / c["time_s"] / peak_flops
        compute_s = cats["matmul"]["time_s"] + cats["conv"]["time_s"]
        mfu = {
            "step_flops": float(step_flops),
            "compute_s": compute_s,
            "compute_frac": (compute_s / total_s) if total_s else 0.0,
        }
        if compute_s:
            mfu["achieved_tflops"] = tot_f / compute_s / 1e12
        if peak_flops:
            mfu["peak_flops"] = float(peak_flops)
            if compute_s:
                mfu["compute_util"] = tot_f / compute_s / peak_flops
            if total_s:
                mfu["mfu_device"] = tot_f / total_s / peak_flops
        out["mfu"] = mfu
    return out


def attribute_profile(profile_dir: str, **kw) -> dict:
    """:func:`attribute` over the newest ``torch.profiler`` trace under a
    directory (``utils/kineto.find_trace``); SystemExit (not a stack
    trace) when it holds none: this is the CLI entry. The trace's path
    rides as ``trace``."""
    path = find_trace(profile_dir)
    if path is None:
        raise SystemExit(f"no torch.profiler trace (trace.json, "
                         f"*.pt.trace.json) under {profile_dir}: is this "
                         "a cli.perf --profile or capture_<step> dir?")
    out = attribute(parse_trace(path), **kw)
    out["trace"] = path
    return out


def compact(attrib: dict, min_frac: float = 0.001) -> dict:
    """The result-JSON spelling of an attribution: categories above
    ``min_frac`` as ``{s, frac}`` (seconds rounded to 10 us), the
    collective breakout, and the MFU decomposition when present —
    small enough to ride in every perf line / capture record."""
    out = {
        "total_device_s": round(attrib["total_device_s"], 5),
        "collective_s": round(attrib["collective_s"], 6),
        "collective_frac": round(attrib["collective_frac"], 4),
        "categories": {
            c: {"s": round(d["time_s"], 5), "frac": round(d["frac"], 4)}
            for c, d in attrib["categories"].items()
            if d["time_s"] and d["frac"] >= min_frac},
        "collectives": {
            k: {"s": round(d["time_s"], 5), "frac": round(d["frac"], 4)}
            for k, d in attrib["collectives"].items()},
    }
    if attrib.get("steps"):
        out["steps"] = attrib["steps"]
    if "mfu" in attrib:
        out["mfu"] = {k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in attrib["mfu"].items()}
    return out


def publish(attrib: dict, registry=None, prefix: str = "attrib") -> None:
    """Expose one attribution on the shared registry as ``attrib_*``
    gauges (scrape surface of the latest capture window): per-category
    seconds + fraction, per-collective-kind seconds, total device time,
    and the MFU decomposition."""
    if registry is None:
        from bigdl_tpu_torch.obs.metrics import get_registry
        registry = get_registry()
    registry.gauge(f"{prefix}_total_device_seconds",
                   "device time in the last attributed capture").set(
        attrib["total_device_s"])
    for c, d in attrib["categories"].items():
        registry.gauge(f"{prefix}_{c}_seconds",
                       f"device seconds in {c} ops").set(d["time_s"])
        registry.gauge(f"{prefix}_{c}_frac",
                       f"fraction of device time in {c} ops").set(d["frac"])
    for k, d in attrib["collectives"].items():
        registry.gauge(f"{prefix}_collective_{k}_seconds",
                       f"device seconds in {k}").set(d["time_s"])
    mfu = attrib.get("mfu", {})
    for key in ("compute_frac", "compute_util", "mfu_device"):
        if key in mfu:
            registry.gauge(f"{prefix}_{key}",
                           "attribution MFU decomposition").set(mfu[key])


def render(attrib: dict) -> str:
    """Human table (``utils/table.format_table``): one row per category
    (zero rows included — an absent collective row and a 0.0% one are
    different findings), the collective breakout, and the MFU
    decomposition footer."""
    from bigdl_tpu_torch.utils.table import format_table

    steps = attrib.get("steps")
    have_flops = any("flop_share" in d
                     for d in attrib["categories"].values())
    heads = ["category", "time_s", "frac"]
    if steps:
        heads.append("ms/step")
    heads.append("count")
    if have_flops:
        heads += ["flop_share", "util"]
    heads.append("top ops")
    rows: List[list] = []
    for c in CATEGORIES:
        d = attrib["categories"][c]
        row = [c, f"{d['time_s']:.5f}", f"{100 * d['frac']:.1f}%"]
        if steps:
            row.append(f"{d['time_s'] * 1e3 / steps:.3f}")
        row.append(d["count"])
        if have_flops:
            fs = d.get("flop_share")
            u = d.get("roofline_util")
            row += ["-" if fs is None else f"{100 * fs:.1f}%",
                    "-" if u is None else f"{100 * u:.1f}%"]
        row.append(", ".join(d["top"]) or "-")
        rows.append(row)
    lines = [format_table(heads, rows)]
    if attrib["collectives"]:
        crows = [[k, f"{d['time_s']:.5f}", f"{100 * d['frac']:.1f}%",
                  d["count"]]
                 for k, d in sorted(attrib["collectives"].items())]
        lines += ["", "collective breakout:",
                  format_table(["kind", "time_s", "frac", "count"], crows)]
    lines += ["", f"total device time: {attrib['total_device_s']:.5f}s "
                  f"over {attrib.get('device_planes', '?')} device "
                  f"plane(s)"
                  + (f", {steps} step(s)" if steps else "")]
    mfu = attrib.get("mfu")
    if mfu:
        bits = [f"compute_frac={100 * mfu['compute_frac']:.1f}%"]
        if "compute_util" in mfu:
            bits.append(f"compute_util={100 * mfu['compute_util']:.1f}%")
        if "mfu_device" in mfu:
            bits.append(f"MFU(device)={100 * mfu['mfu_device']:.1f}%")
        lines.append("mfu decomposition: " + " x ".join(bits[:2])
                     + (" -> " + bits[2] if len(bits) > 2 else ""))
    return "\n".join(lines)
