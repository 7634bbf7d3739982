"""Cross-process metrics aggregation (counterpart of
``bigdl_tpu/obs/aggregate.py``).

The fleet router scrapes each worker's ``/metrics`` page and re-exports
the fleet view from one endpoint: each worker page is re-emitted with a
``worker="i"`` label, and every summable sample is folded into an
unlabelled fleet total, which comes first.

Not summed:

* ``quantile=...`` samples (quantiles do not add; the ``_bucket`` series
  do);
* ``<ns>_info`` provenance gauges (each worker's is its own);
* non-finite values (a gauge whose sampling fn failed renders NaN).

Pure text in, text out, so the router aggregates pages of any worker
that speaks the exposition format.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

__all__ = ["aggregate_pages", "parse_samples"]

_SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")


def parse_samples(page: str) -> List[Tuple[str, str, float]]:
    """``(name, labels_str, value)`` per sample line; comments, blanks,
    and unparseable values are skipped. ``labels_str`` is the raw text
    between the braces ("" when unlabelled) — kept verbatim so
    relabelling never has to re-escape quoted label values."""
    out = []
    for line in page.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels, raw = m.group(1), m.group(2) or "", m.group(3)
        try:
            value = float(raw)
        except ValueError:
            continue
        out.append((name, labels, value))
    return out


def _relabel(labels: str, key: str, val: str) -> str:
    tag = f'{key}="{val}"'
    return f"{tag},{labels}" if labels else tag


def aggregate_pages(pages: Dict[str, str], label: str = "worker") -> str:
    """Fold worker exposition pages into one fleet page: summed
    unlabelled series first, then every sample relabelled with
    ``label="<page key>"``. ``pages`` maps the label value (worker
    index as a string) to that worker's raw ``/metrics`` text."""
    sums: Dict[Tuple[str, str], float] = {}
    order: List[Tuple[str, str]] = []
    relabelled: List[str] = []
    for idx in sorted(pages, key=lambda k: (len(k), k)):
        for name, labels, value in parse_samples(pages[idx]):
            if f'{label}="' in labels:
                continue  # already fleet-labelled: never double-count
            relabelled.append(
                f"{name}{{{_relabel(labels, label, idx)}}} "
                f"{value:g}")
            if (name.endswith("_info") or 'quantile="' in labels
                    or not math.isfinite(value)):
                continue
            key = (name, labels)
            if key not in sums:
                sums[key] = 0.0
                order.append(key)
            sums[key] += value
    lines = [f"# fleet aggregate over {len(pages)} worker page(s)"]
    for name, labels in order:
        sfx = f"{{{labels}}}" if labels else ""
        lines.append(f"{name}{sfx} {sums[(name, labels)]:g}")
    lines.extend(relabelled)
    return "\n".join(lines) + "\n"
