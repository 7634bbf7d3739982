"""Reader of a ``torch.profiler`` Chrome trace (the counterpart of
``bigdl_tpu/utils/xplane.py``, the JAX package's XSpace reader).

``torch.profiler.profile(...).export_chrome_trace(path)`` writes Kineto's
JSON: ``{"traceEvents": [...]}`` of complete events (``"ph": "X"``) with
``ts``/``dur`` in microseconds and a category ``cat``. The events CUPTI
records on the card are ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
(kernels launched through ``ctypes`` and kernels inside a CUDA-graph
replay included: neither has a ``cpu_op`` row, both have a kernel row);
the host's operators are ``cpu_op``. This module groups them into the
planes of the XSpace reader, so ``obs.attrib`` reads either the same way:

* one device plane ``/device:GPU:<d>`` a card, a line a stream, holding
  the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events;
* one host plane ``/host:CPU``, a line a thread, holding the ``cpu_op``
  events (what a trace of a CPU-only run has; :func:`device_planes`
  returns no plane for it, and ``attrib.attribute`` falls back to the
  planes that carry events, as the JAX attribution does).

Durations are kept in picoseconds (``dur`` x 1e6), so :func:`op_totals`
gives the XSpace reader's ``{name: {"total_ps", "count"}}``. The
collective kinds are the JAX reader's, with NCCL's spellings of a
broadcast and of a send/receive added (``ncclDevKernel_Broadcast_*``,
``ncclDevKernel_SendRecv``)."""

from __future__ import annotations

import gzip
import json
import os
import re
from typing import Dict, List, Tuple

__all__ = ["parse_trace", "find_trace", "device_planes", "op_totals",
           "collectives", "collective_kind", "COLLECTIVE_KINDS",
           "DEVICE_CATEGORIES", "HOST_CATEGORY", "XPlane", "XLine",
           "XEvent"]

# the Kineto categories of events that ran on the card, and of the host's
# operators
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORY = "cpu_op"


class XEvent:
    __slots__ = ("metadata_id", "offset_ps", "duration_ps")

    def __init__(self, metadata_id: int, offset_ps: int, duration_ps: int):
        self.metadata_id = metadata_id
        self.offset_ps = offset_ps
        self.duration_ps = duration_ps


class XLine:
    __slots__ = ("name", "events")

    def __init__(self, name: str):
        self.name = name
        self.events: List[XEvent] = []


class XPlane:
    __slots__ = ("name", "lines", "event_names")

    def __init__(self, name: str):
        self.name = name
        self.lines: List[XLine] = []
        # metadata id -> the event's name (kernel or operator)
        self.event_names: Dict[int, str] = {}


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def parse_trace(path: str) -> List[XPlane]:
    """Parse one Kineto Chrome-trace file into its planes: the device
    planes (one a card, in device order) first, then the host plane when
    it has events. Raises ValueError on a file with no ``traceEvents``."""
    doc = _load(path)
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    planes: Dict[str, XPlane] = {}
    lines: Dict[Tuple[str, object], XLine] = {}
    ids: Dict[Tuple[str, str], int] = {}
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        if cat in DEVICE_CATEGORIES:
            args = ev.get("args") or {}
            pname = f"/device:GPU:{args.get('device', ev.get('pid', 0))}"
            lkey = args.get("stream", ev.get("tid", 0))
        elif cat == HOST_CATEGORY:
            pname, lkey = "/host:CPU", ev.get("tid", 0)
        else:
            continue
        pl = planes.get(pname)
        if pl is None:
            pl = planes[pname] = XPlane(pname)
        ln = lines.get((pname, lkey))
        if ln is None:
            ln = lines[(pname, lkey)] = XLine(str(lkey))
            pl.lines.append(ln)
        name = str(ev.get("name", ""))
        mid = ids.get((pname, name))
        if mid is None:
            mid = ids[(pname, name)] = len(pl.event_names) + 1
            pl.event_names[mid] = name
        ln.events.append(XEvent(mid, int(round(float(ev.get("ts", 0))
                                               * 1e6)),
                                int(round(float(ev.get("dur", 0)) * 1e6))))
    return ([planes[k] for k in sorted(p for p in planes
                                       if p.startswith("/device"))]
            + [planes[k] for k in planes if not k.startswith("/device")])


def _is_trace(fn: str) -> bool:
    # torch.profiler's own names: trace.json (export_chrome_trace here)
    # and <worker>.<ts>.pt.trace.json (tensorboard_trace_handler)
    return fn in ("trace.json", "trace.json.gz") or fn.endswith(
        (".pt.trace.json", ".pt.trace.json.gz"))


def find_trace(profile_dir: str) -> "str | None":
    """Newest ``torch.profiler`` trace under a directory (a ``cli.perf
    --profile`` directory, a ``capture_<step>`` window, or a parent of
    them), or None."""
    newest, newest_m = None, -1.0
    for root, _dirs, files in os.walk(profile_dir):
        for fn in files:
            if _is_trace(fn):
                p = os.path.join(root, fn)
                m = os.path.getmtime(p)
                if m > newest_m:
                    newest, newest_m = p, m
    return newest


def device_planes(planes: List[XPlane]) -> List[XPlane]:
    """The card's planes (``/device:GPU:<d>``), the host plane excluded;
    without one, every non-host plane carrying events (so a renamed plane
    degrades to noise, not emptiness)."""
    dev = [p for p in planes
           if "TPU" in p.name.upper() or "GPU" in p.name.upper()]
    if dev:
        return dev
    return [p for p in planes
            if "HOST" not in p.name.upper()
            and any(ln.events for ln in p.lines)]


# the JAX reader's spellings of the cross-device collectives, most
# specific first, plus NCCL's kernel names where they differ
# (ncclDevKernel_AllReduce_Sum_f32_RING_LL, _ReduceScatter_, _AllGather_
# match the JAX patterns; _Broadcast_ and _SendRecv are added)
COLLECTIVE_KINDS: Tuple[Tuple[str, "re.Pattern[str]"], ...] = (
    ("all_reduce", re.compile(r"all[-_]?reduce|\bpsum\b", re.I)),
    ("reduce_scatter", re.compile(r"reduce[-_]?scatter", re.I)),
    ("all_gather", re.compile(r"all[-_]?gather", re.I)),
    ("all_to_all", re.compile(r"all[-_]?to[-_]?all", re.I)),
    ("collective_permute",
     re.compile(r"collective[-_]?permute|\bppermute\b|nccl\w*sendrecv",
                re.I)),
    ("collective_broadcast",
     re.compile(r"collective[-_]?broadcast|nccl\w*broadcast", re.I)),
)


def collective_kind(name: str) -> "str | None":
    """Collective kind of one kernel or op name, or None.
    reduce-scatter is tested before all_reduce so the compound name never
    degrades into the wrong bucket."""
    if re.search(r"reduce[-_]?scatter", name, re.I):
        return "reduce_scatter"
    for kind, pat in COLLECTIVE_KINDS:
        if pat.search(name):
            return kind
    return None


def collectives(planes: List[XPlane]) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind totals across the planes: ``kind ->
    {"total_ps", "count"}``; kinds with no events are absent (an empty
    dict: no collective ran on these planes)."""
    out: Dict[str, Dict[str, float]] = {}
    for name, ent in op_totals(planes).items():
        kind = collective_kind(name)
        if kind is None:
            continue
        agg = out.setdefault(kind, {"total_ps": 0.0, "count": 0})
        agg["total_ps"] += ent["total_ps"]
        agg["count"] += ent["count"]
    return out


def op_totals(planes: List[XPlane]) -> Dict[str, Dict[str, float]]:
    """Event durations summed by name across the planes: ``name ->
    {"total_ps", "count"}``."""
    totals: Dict[str, Dict[str, float]] = {}
    for pl in planes:
        for ln in pl.lines:
            for ev in ln.events:
                name = pl.event_names.get(
                    ev.metadata_id, f"<unnamed:{ev.metadata_id}>")
                ent = totals.setdefault(name, {"total_ps": 0.0,
                                               "count": 0})
                ent["total_ps"] += float(ev.duration_ps)
                ent["count"] += 1
    return totals
