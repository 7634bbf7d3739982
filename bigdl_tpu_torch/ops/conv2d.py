"""Per-pass, per-geometry conv layout policy (counterpart of
``bigdl_tpu/ops/conv2d.py``).

:func:`conv2d` is a ``torch.autograd.Function`` whose three passes
(forward, input gradient "dgrad", weight gradient "wgrad") each run under
a layout chosen independently:

* ``NHWC``: the activation as the port keeps it, (B, H, W, C) seen as an
  NCHW-shaped view with channels_last strides; one cuDNN call (the plain
  path of ``nn.SpatialConvolution``).
* ``NCHW``: the activation (and the output gradient) copied to contiguous
  NCHW for that pass, the weight to contiguous OIHW, and the result copied
  back to (B, H, W, C). Where XLA fuses such transposes into neighbours,
  eager PyTorch pays one copy for each.
* ``GEMM``: at a 1x1, stride-1, unpadded, ungrouped, undilated site the
  convolution is a product over the flattened pixels: ``x.reshape(-1,
  Cin) @ Wᵀ`` forward, ``dy @ W`` for dgrad, ``dyᵀ @ x`` for wgrad. At
  any other site a GEMM choice takes NHWC, with the same numbers.

The backward passes never recompute the forward: each is one
``aten.convolution_backward`` with its output mask (or one product under
GEMM), and dgrad is skipped where the input needs no gradient (the stem).
Nothing reads the device from the host, so the function captures into a
CUDA graph.

A pass's layout is resolved from the site's geometry ``(kh, kw, sh, sw,
cin, cout, groups, dh, dw, dtype)`` with the JAX package's precedence: an
explicit spec (``--convLayout``) wins; else an installed per-geometry
decision (``--convGeom``); else the tuner's ``conv_geom`` decision
(``--autotune cached|measure``, :func:`_tuned_geom_layout`); else the
global triple, which :func:`maybe_install_auto` installs for a run
(``tuning.install_conv_layouts``). The dtype strings are the JAX
package's (``"bfloat16"``, ``"float32"``), so one decision file means the
same to both packages. :data:`MEASURED_DECISIONS` holds no entry: the JAX
package's one row was measured on a TPU, so ``auto`` resolves to
all-NHWC on a GPU, as on any device the JAX package has not measured.

The policy is process-global state, set by the CLI flags before a model
runs. With the default (all-NHWC, no geometry entry, the tuner off)
:func:`policy_active` is False and ``nn.SpatialConvolution`` keeps its
single-op path.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "set_conv_pass_layouts", "reset_conv_pass_layouts",
           "get_conv_pass_layouts", "decide_from_probe",
           "decide_geom_from_probe", "probe_totals", "resolve_layout_spec",
           "install_layout_spec", "conv_layouts_if_nondefault",
           "install_geom_decisions", "install_geom_file",
           "clear_geom_policy", "geom_policy_if_any", "gemm_eligible",
           "geom_to_json", "geom_from_json", "resolve_site_layouts",
           "policy_snapshot", "restore_policy", "policy_active",
           "maybe_install_auto",
           "MEASURED_DECISIONS", "LEGACY_PROBE_SHAPES"]

_PASSES = ("fwd", "dgrad", "wgrad")
_LAYOUTS = ("NHWC", "NCHW", "GEMM")
_DEFAULT = {"fwd": "NHWC", "dgrad": "NHWC", "wgrad": "NHWC"}
_POLICY: Dict[str, str] = dict(_DEFAULT)
# True once a caller installed a policy explicitly (CLI flag or API call):
# per-geometry decisions are then ignored
_EXPLICIT = False
# geometry tuple (see _geom_of) -> partial per-pass layout dict
_GEOM_POLICY: Dict[tuple, Dict[str, str]] = {}

# Device name -> per-pass decision measured on that device and shipped as
# its default. Empty: no GPU has been measured.
MEASURED_DECISIONS: Dict[str, Dict[str, str]] = {}


def set_conv_pass_layouts(fwd: str = "NHWC", dgrad: str = "NHWC",
                          wgrad: str = "NHWC") -> Dict[str, str]:
    """Install the per-pass activation layouts (each "NHWC", "NCHW" or
    "GEMM"; GEMM applies only at 1x1/stride-1/unpadded/ungrouped conv
    sites and falls back to NHWC elsewhere). Returns the installed
    policy."""
    global _EXPLICIT
    for v in (fwd, dgrad, wgrad):
        if v not in _LAYOUTS:
            raise ValueError(
                f"layout must be one of {_LAYOUTS}, got {v!r}")
    _POLICY.update(fwd=fwd, dgrad=dgrad, wgrad=wgrad)
    _EXPLICIT = True
    return dict(_POLICY)


def reset_conv_pass_layouts() -> Dict[str, str]:
    """Restore the all-NHWC default, clear the explicit flag and drop every
    per-geometry decision."""
    global _EXPLICIT
    _POLICY.update(_DEFAULT)
    _EXPLICIT = False
    _GEOM_POLICY.clear()
    return dict(_POLICY)


def _device_name(device) -> str:
    """``torch.cuda.get_device_name`` of ``device`` (default: the current
    card), or the device type off CUDA."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def resolve_layout_spec(spec: str, device=None) -> Dict[str, str]:
    """Resolve a ``--convLayout`` value to a per-pass dict (not installed).

    ``"default"`` is all-NHWC; ``"auto"`` looks the device's name up in
    :data:`MEASURED_DECISIONS` (all-NHWC when absent); ``"FWD,DGRAD,WGRAD"``
    is explicit. Raises ValueError on a malformed spec."""
    low = (spec or "auto").strip().lower()
    if low == "default":
        return dict(_DEFAULT)
    if low == "auto":
        return dict(MEASURED_DECISIONS.get(_device_name(device), _DEFAULT))
    parts = spec.strip().upper().split(",")
    if len(parts) != 3 or any(p not in _LAYOUTS for p in parts):
        raise ValueError("convLayout spec wants FWD,DGRAD,WGRAD "
                         "(NHWC|NCHW|GEMM each), 'auto' or 'default'; "
                         f"got {spec!r}")
    return dict(zip(_PASSES, parts))


def install_layout_spec(spec: str, device=None) -> Dict[str, str]:
    """Resolve ``spec`` and install it as an explicit policy. Returns the
    installed dict."""
    return set_conv_pass_layouts(**resolve_layout_spec(spec, device))


def conv_layouts_if_nondefault() -> "Dict[str, str] | None":
    """The active global triple when it differs from all-NHWC, else None
    (the perf line's ``conv_layouts``)."""
    return None if _POLICY == _DEFAULT else dict(_POLICY)


def maybe_install_auto(device=None, guarded: bool = False,
                       policy: "Dict[str, str] | None" = None
                       ) -> Dict[str, str]:
    """Install this device's measured triple (``auto``), or ``policy`` (a
    tuner decision), unless a policy was installed explicitly; the
    all-NHWC default where ``guarded`` (a run configuration, K > 1 or the
    s2d stem, whose decision is its own). The training entry points call
    it through ``tuning.install_conv_layouts``. Returns the active
    triple."""
    if not _EXPLICIT:
        if guarded:
            _POLICY.update(_DEFAULT)
        elif policy is not None:
            for v in policy.values():
                if v not in _LAYOUTS:
                    raise ValueError(
                        f"layout must be one of {_LAYOUTS}, got {v!r}")
            _POLICY.update({p: policy[p] for p in _PASSES})
        else:
            _POLICY.update(resolve_layout_spec("auto", device))
    return dict(_POLICY)


def policy_snapshot() -> tuple:
    """(policy, explicit flag, per-geometry table), for
    :func:`restore_policy`."""
    return (dict(_POLICY), _EXPLICIT,
            {g: dict(v) for g, v in _GEOM_POLICY.items()})


def restore_policy(snap: tuple) -> Dict[str, str]:
    """Restore a :func:`policy_snapshot` (a two-tuple restores with an
    empty geometry table)."""
    global _EXPLICIT
    pol, explicit = snap[0], snap[1]
    _POLICY.update({p: pol[p] for p in _PASSES})
    _EXPLICIT = bool(explicit)
    _GEOM_POLICY.clear()
    if len(snap) > 2:
        _GEOM_POLICY.update({g: dict(v) for g, v in snap[2].items()})
    return dict(_POLICY)


def get_conv_pass_layouts() -> Dict[str, str]:
    return dict(_POLICY)


def policy_active() -> bool:
    """True when a layout decision of any kind can apply: a non-default
    global triple, an installed per-geometry table, or the tuner on (its
    ``conv_geom`` decisions are read per site). ``nn.SpatialConvolution``
    routes through :func:`conv2d` exactly when this is true."""
    if _POLICY != _DEFAULT or _GEOM_POLICY:
        return True
    from bigdl_tpu_torch.tuning import autotune as _at
    return _at.get_mode() != "off"


def probe_totals(lines: Iterable[str]) -> Dict[str, Dict[str, float]]:
    """Per-pass, per-layout total milliseconds of probe JSON rows (NHWC
    and NCHW rows only; other lines are skipped). Raises on no usable row
    or on a pass whose two layouts were probed a different number of
    times (a truncated probe)."""
    totals = {p: {"NHWC": 0.0, "NCHW": 0.0} for p in _PASSES}
    counts = {p: {"NHWC": 0, "NCHW": 0} for p in _PASSES}
    for row in _rows(lines):
        lay = row.get("layout")
        if lay not in ("NHWC", "NCHW"):
            continue
        for p in _PASSES:
            ms = row.get(f"{p}_ms")
            if ms is not None:
                totals[p][lay] += float(ms)
                counts[p][lay] += 1
    if not any(c for per in counts.values() for c in per.values()):
        raise ValueError("no probe rows found")
    for p in _PASSES:
        if counts[p]["NHWC"] != counts[p]["NCHW"]:
            raise ValueError(
                f"asymmetric probe coverage for pass {p!r}: "
                f"{counts[p]['NHWC']} NHWC vs {counts[p]['NCHW']} NCHW "
                "rows — probe was truncated, re-run it")
    return totals


def decide_from_probe(lines: Iterable[str]) -> Dict[str, str]:
    """Per-pass layout decision from probe rows: the layout with the lower
    :func:`probe_totals` time wins each pass (not installed)."""
    totals = probe_totals(lines)
    return {p: min(totals[p], key=totals[p].get) for p in _PASSES}


def _rows(lines: Iterable[str]):
    """The JSON objects among ``lines`` (other lines skipped)."""
    for line in lines:
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError:
            continue


# ------------------------------------------------------ per-geometry policy
def _dtype_name(dtype) -> str:
    """The JAX package's spelling of a dtype ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


def _geom_of(x, w, stride, dilation, groups) -> tuple:
    """Geometry key of one site, from an NHWC ``x`` and an (out, in/g, kh,
    kw) ``w``: (kh, kw, sh, sw, cin, cout, groups, dh, dw, dtype)."""
    return (int(w.shape[2]), int(w.shape[3]), int(stride[0]),
            int(stride[1]), int(x.shape[-1]), int(w.shape[0]), int(groups),
            int(dilation[0]), int(dilation[1]), _dtype_name(x.dtype))


def geom_to_json(g: tuple) -> dict:
    """JSON spelling of a geometry key."""
    return {"kh": g[0], "kw": g[1], "stride": [g[2], g[3]],
            "cin": g[4], "cout": g[5], "groups": g[6],
            "dilation": [g[7], g[8]], "dtype": g[9]}


def geom_from_json(d: dict) -> tuple:
    """Inverse of :func:`geom_to_json`; raises ValueError on a malformed
    geometry dict."""
    try:
        s, dil = d["stride"], d.get("dilation", [1, 1])
        return (int(d["kh"]), int(d["kw"]), int(s[0]), int(s[1]),
                int(d["cin"]), int(d["cout"]), int(d.get("groups", 1)),
                int(dil[0]), int(dil[1]), str(d.get("dtype", "bfloat16")))
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError(f"malformed conv geometry {d!r}: {e}")


def gemm_eligible(kh: int, kw: int, stride, padding, dilation,
                  groups: int) -> bool:
    """True when the site is exactly a matmul: 1x1 kernel, stride 1, zero
    padding, no dilation, no grouping."""
    if kh != 1 or kw != 1 or int(groups) != 1:
        return False
    if tuple(int(s) for s in stride) != (1, 1):
        return False
    if tuple(int(d) for d in dilation) != (1, 1):
        return False
    if isinstance(padding, str):
        return padding.upper() == "VALID"
    return all(int(lo) == 0 and int(hi) == 0 for lo, hi in padding)


def install_geom_decisions(decisions: Iterable[dict]) -> int:
    """Install per-geometry decisions, each ``{"geom": {...}, "layouts":
    {"fwd"|"dgrad"|"wgrad": layout}}``. An unknown pass or layout raises.
    Returns the number of geometry entries installed."""
    n = 0
    for d in decisions:
        g = geom_from_json(d.get("geom", {}))
        lays = d.get("layouts") or {}
        for p, v in lays.items():
            if p not in _PASSES or v not in _LAYOUTS:
                raise ValueError(
                    f"bad per-geometry decision {p!r}={v!r} (passes "
                    f"{_PASSES}, layouts {_LAYOUTS})")
        if lays:
            _GEOM_POLICY.setdefault(g, {}).update(lays)
            n += 1
    return n


def install_geom_file(path: str) -> int:
    """Load a decision JSON file (a list, or ``{"decisions": [...]}``) and
    install it: the ``--convGeom FILE`` spelling."""
    with open(path) as f:
        blob = json.load(f)
    if isinstance(blob, dict):
        blob = blob.get("decisions", [])
    return install_geom_decisions(blob)


def clear_geom_policy() -> None:
    _GEOM_POLICY.clear()


def geom_policy_if_any() -> "List[dict] | None":
    """The installed per-geometry decisions as a sorted JSON-able list, or
    None when the table is empty (the perf line's ``conv_geom``)."""
    if not _GEOM_POLICY:
        return None
    return [{"geom": geom_to_json(g), "layouts": dict(_GEOM_POLICY[g])}
            for g in sorted(_GEOM_POLICY)]


# names of the rows of probes that predate the geometry fields
LEGACY_PROBE_SHAPES: Dict[str, tuple] = {
    "stem7x7s2": (7, 7, 2, 2, 3, 64, 1, 1, 1, "bfloat16"),
    "s1_3x3": (3, 3, 1, 1, 64, 64, 1, 1, 1, "bfloat16"),
    "s2_3x3": (3, 3, 1, 1, 128, 128, 1, 1, 1, "bfloat16"),
    "s3_3x3": (3, 3, 1, 1, 256, 256, 1, 1, 1, "bfloat16"),
    "s4_3x3": (3, 3, 1, 1, 512, 512, 1, 1, 1, "bfloat16"),
    "s2_1x1": (1, 1, 1, 1, 512, 128, 1, 1, 1, "bfloat16"),
}


def _row_geom(row: dict) -> "tuple | None":
    if "kh" in row:
        try:
            return geom_from_json(row)
        except ValueError:
            return None
    return LEGACY_PROBE_SHAPES.get(row.get("shape", ""))


def decide_geom_from_probe(lines: Iterable[str]) -> List[dict]:
    """Per-geometry, per-pass decisions from probe rows: each pass of each
    geometry takes the layout with the lowest time among those probed for
    it; geometries sorted, ties broken NHWC < NCHW < GEMM. Not
    installed."""
    best: Dict[tuple, Dict[str, Tuple[float, int, str]]] = {}
    for row in _rows(lines):
        lay = row.get("layout")
        if lay not in _LAYOUTS:
            continue
        g = _row_geom(row)
        if g is None:
            continue
        rank = _LAYOUTS.index(lay)
        per = best.setdefault(g, {})
        for p in _PASSES:
            ms = row.get(f"{p}_ms")
            if ms is None:
                continue
            cand = (float(ms), rank, lay)
            if p not in per or cand < per[p]:
                per[p] = cand
    if not best:
        raise ValueError("no usable probe rows (geometry fields or a "
                         "known legacy shape name required)")
    return [{"geom": geom_to_json(g),
             "layouts": {p: best[g][p][2] for p in _PASSES if p in best[g]}}
            for g in sorted(best)]


def _tuned_geom_layout(pass_name: str, geom: tuple, x_shape, gemm_ok: bool
                       ) -> "str | None":
    """The tuner's ``conv_geom`` decision for one (pass, geometry), or
    None (tuner off, or no decision: the caller takes the global triple).
    Without ``x_shape`` (a static lookup) it only reads the cache."""
    from bigdl_tpu_torch.tuning import autotune as _at
    if _at.get_mode() == "off":
        return None
    if x_shape is None:
        return _at.peek_geom_layout(pass_name, geom, gemm_ok)
    return _at.conv_geom_layout(pass_name, geom,
                                tuple(int(d) for d in x_shape), gemm_ok)


def _layout(pass_name: str, geom: tuple, eligible: bool,
            x_shape=None) -> str:
    """One pass's layout: explicit spec > per-geometry decision > tuned
    decision > global triple; GEMM at an ineligible site is NHWC."""
    lay = None
    if not _EXPLICIT:
        per = _GEOM_POLICY.get(geom)
        if per:
            lay = per.get(pass_name)
        if lay is None:
            lay = _tuned_geom_layout(pass_name, geom, x_shape, eligible)
    if lay is None:
        lay = _POLICY[pass_name]
    if lay == "GEMM" and not eligible:
        lay = "NHWC"
    return lay


def resolve_site_layouts(kh: int, kw: int, stride, padding, dilation,
                         groups: int, cin: int, cout: int,
                         dtype="bfloat16") -> Dict[str, str]:
    """The layout each pass of one site resolves to under the installed
    policy, from the site's static description."""
    stride = tuple(int(s) for s in stride)
    dilation = tuple(int(d) for d in dilation)
    geom = (int(kh), int(kw), stride[0], stride[1], int(cin), int(cout),
            int(groups), dilation[0], dilation[1], _dtype_name(dtype))
    ok = gemm_eligible(int(kh), int(kw), stride, padding, dilation,
                       int(groups))
    return {p: _layout(p, geom, ok) for p in _PASSES}


# --------------------------------------------------------------- the conv
def _nchw(t):
    """An NHWC tensor as a contiguous NCHW copy."""
    return t.permute(0, 3, 1, 2).contiguous()


def _conv_fwd(x, w, stride, padding, dilation, groups, layout):
    """NHWC ``x``, (out, in/g, kh, kw) ``w`` -> NHWC output."""
    if layout == "GEMM":
        b, h, wd, cin = x.shape
        y = x.reshape(-1, cin) @ w.reshape(w.shape[0], cin).t()
        return y.reshape(b, h, wd, w.shape[0])
    if layout == "NHWC":
        return F.conv2d(x.permute(0, 3, 1, 2), w, None, stride, padding,
                        dilation, groups).permute(0, 2, 3, 1)
    y = F.conv2d(_nchw(x), w.contiguous(), None, stride, padding, dilation,
                 groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _conv_dgrad(dy, x, w, stride, padding, dilation, groups, layout):
    """Gradient of the NHWC input ``x`` from ``dy`` (NHWC); the values of
    ``x`` are not read, only its shape and, under NHWC, its strides."""
    if layout == "GEMM":
        return (dy.reshape(-1, dy.shape[-1])
                @ w.reshape(w.shape[0], x.shape[-1])).reshape(x.shape)
    if layout == "NHWC":
        g, xl, wl = dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w
    else:
        b, h, wd, cin = x.shape
        g, wl = _nchw(dy), w.contiguous()
        xl = dy.new_empty(1).expand(b, cin, h, wd)  # a shape, no storage
    dx = torch.ops.aten.convolution_backward(
        g, xl, wl, None, stride, padding, dilation, False, [0, 0], groups,
        [True, False, False])[0].permute(0, 2, 3, 1)
    return dx if layout == "NHWC" else dx.contiguous()


def _conv_wgrad(dy, x, w, stride, padding, dilation, groups, layout):
    """Gradient of the (out, in/g, kh, kw) weight from ``dy`` (NHWC)."""
    if layout == "GEMM":
        cin = x.shape[-1]
        dw = dy.reshape(-1, dy.shape[-1]).t() @ x.reshape(-1, cin)
        return dw.reshape(w.shape)
    if layout == "NHWC":
        g, xl, wl = dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w
    else:
        g, xl, wl = _nchw(dy), _nchw(x), w.contiguous()
    return torch.ops.aten.convolution_backward(
        g, xl, wl, None, stride, padding, dilation, False, [0, 0], groups,
        [False, True, False])[1]


class _Conv2d(torch.autograd.Function):
    """The JAX package's ``conv2d`` custom VJP: the three passes under the
    layouts resolved before the call."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups, layouts):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, padding, dilation, groups)
        ctx.layouts = layouts
        return _conv_fwd(x, w, stride, padding, dilation, groups,
                         layouts["fwd"])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.args
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv_dgrad(dy, x, w, stride, padding, dilation,
                             groups, ctx.layouts["dgrad"])
        if ctx.needs_input_grad[1]:
            dw = _conv_wgrad(dy, x, w, stride, padding, dilation, groups,
                             ctx.layouts["wgrad"])
        return dx, dw, None, None, None, None, None


def conv2d(x, w, stride=(1, 1), padding=((0, 0), (0, 0)),
           dilation=(1, 1), groups: int = 1):
    """2-D convolution of an NHWC ``x`` with an (out, in/groups, kh, kw)
    ``w`` (the port's weight layout), under the installed policy.
    ``padding`` is ((lo, hi), (lo, hi)) as in the JAX package (an
    uneven pair pads ``x`` first). Returns NHWC."""
    stride = tuple(int(s) for s in stride)
    dilation = tuple(int(d) for d in dilation)
    pad = tuple((int(lo), int(hi)) for lo, hi in padding)
    geom = _geom_of(x, w, stride, dilation, groups)
    ok = gemm_eligible(geom[0], geom[1], stride, pad, dilation, groups)
    # the backward passes are looked up only where there is a backward (a
    # forward-only site consults no dgrad/wgrad decision, as under jit)
    # and a count on fake tensors (utils/flops) only reads decisions
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    from torch._subclasses.fake_tensor import FakeTensor
    x_shape = None if isinstance(x, FakeTensor) else x.shape
    layouts = {p: _layout(p, geom, ok, x_shape) if p == "fwd" or grad
               else _POLICY[p] for p in _PASSES}
    if any(lo != hi for lo, hi in pad):
        x = F.pad(x, (0, 0, pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
        sym = (0, 0)
    else:
        sym = (pad[0][0], pad[1][0])
    return _Conv2d.apply(x, w, stride, sym, dilation, int(groups), layouts)
