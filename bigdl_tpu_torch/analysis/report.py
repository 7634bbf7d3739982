"""Finding/Report containers of the lint (counterpart of
``bigdl_tpu/analysis/report.py``, the same classes and JSON).

A :class:`Finding` is one rule hit: rule id, family, severity, a human
message, *provenance* (``where``: a node path inside the traced FX graph,
or a module path inside the model tree), a fix hint, and a free-form
``detail`` dict (counts, byte totals, example sites). A :class:`Report`
is the ordered collection the CLI renders (human table via
``utils/table.format_table``, or JSON), summarizes into perf-JSON
provenance (``annotation()``, the ``lint`` field of a ``cli.perf`` line),
and turns into an exit code (``--lint=strict`` = nonzero on any
error-severity finding). For the same findings the JSON is the JAX
package's, byte for byte.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

__all__ = ["SEVERITIES", "Finding", "Report"]

# ordered most → least severe; strict mode fails on "error" only
SEVERITIES = ("error", "warning", "info")


@dataclass
class Finding:
    rule: str            # catalog id, e.g. "fusion-bn-unfused"
    family: str          # rule family: dtype|donation|tiling|fusion|layout|host-sync|meta
    severity: str        # one of SEVERITIES
    message: str         # one-line human statement of the problem
    where: str = ""      # eqn path / module path provenance
    hint: str = ""       # how to fix (flag spelling, API call)
    detail: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def to_json(self) -> dict:
        out = {"rule": self.rule, "family": self.family,
               "severity": self.severity, "message": self.message}
        if self.where:
            out["where"] = self.where
        if self.hint:
            out["hint"] = self.hint
        if self.detail:
            out["detail"] = self.detail
        return out


class Report:
    """Ordered findings + the summaries every consumer needs."""

    def __init__(self, findings: Optional[Iterable[Finding]] = None):
        self.findings: List[Finding] = list(findings or [])

    def add(self, finding: Finding) -> "Report":
        self.findings.append(finding)
        return self

    def extend(self, findings: Iterable[Finding]) -> "Report":
        self.findings.extend(findings)
        return self

    def count(self, severity: str) -> int:
        return sum(1 for f in self.findings if f.severity == severity)

    @property
    def errors(self) -> int:
        return self.count("error")

    @property
    def warnings(self) -> int:
        return self.count("warning")

    def families(self) -> List[str]:
        """Distinct families with at least one finding, first-hit order."""
        seen: List[str] = []
        for f in self.findings:
            if f.family not in seen:
                seen.append(f.family)
        return seen

    def by_family(self, family: str) -> List[Finding]:
        return [f for f in self.findings if f.family == family]

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def sorted(self) -> List[Finding]:
        """Severity-major (errors first), then family, stable within."""
        rank = {s: i for i, s in enumerate(SEVERITIES)}
        return sorted(self.findings,
                      key=lambda f: (rank[f.severity], f.family))

    # ------------------------------------------------------------ outputs
    def annotation(self) -> dict:
        """Compact provenance for perf JSON lines (the ``lint`` field,
        stamped like ``bn_fused``/``autotune`` decisions are)."""
        return {"errors": self.errors, "warnings": self.warnings,
                "infos": self.count("info"),
                "rules": sorted({f.rule for f in self.findings})}

    def to_json(self) -> dict:
        return {"summary": self.annotation(),
                "families": self.families(),
                "findings": [f.to_json() for f in self.sorted()]}

    def render(self) -> str:
        """Human table (severity-sorted) + one summary line."""
        from bigdl_tpu_torch.utils.table import format_table

        if not self.findings:
            return "lint: no findings"
        rows = [[f.severity.upper(), f.rule, f.message,
                 f.where, f.hint] for f in self.sorted()]
        table = format_table(
            ["severity", "rule", "finding", "where", "fix hint"], rows)
        summary = (f"lint: {self.errors} error(s), {self.warnings} "
                   f"warning(s), {self.count('info')} info(s) across "
                   f"{len(self.families())} rule familie(s)")
        return f"{table}\n{summary}"

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=False)
            f.write("\n")

    def exit_code(self, strict: bool = False) -> int:
        """0 unless strict and at least one error-severity finding."""
        return 2 if (strict and self.errors) else 0
