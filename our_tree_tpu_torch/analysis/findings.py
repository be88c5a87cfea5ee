"""Port of ``our_tree_tpu.analysis.findings``: the one finding shape every
analyzer layer emits, with the same fingerprint scheme.

A finding's identity is its **fingerprint** — a stable hash of the rule
plus a location anchor that survives line-number drift: AST findings
anchor on the normalized source *text* of the flagged line (plus an
occurrence index for textually identical lines), graph findings on the
(entry point, operator) pair, san findings on call-site text or a
canonical cycle/attribute string. Line numbers ride along for humans
and go stale harmlessly; the baseline matches by fingerprint only.

The fingerprint also folds in the emitting rule's **semantic version**:
tightening a rule's semantics (catching more, anchoring differently)
bumps its version, which invalidates every baseline entry minted under
the old semantics — stale entries are *reported*, never silently
honored. Bump the version whenever a rule change would make an old
suppression unsound; leave it alone for message-only edits.

Stdlib only: layer 1 and the baseline machinery load without torch.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

#: Severities, most severe first (report ordering).
SEVERITIES = ("error", "warning")


@dataclass
class Finding:
    rule: str          #: rule id, e.g. "constant-time" or "subprocess-isolate"
    severity: str      #: "error" | "warning"
    message: str       #: one human line naming the violation
    path: str          #: repo-relative file, or "<graph>" for layer 2
    line: int = 0      #: 1-based; 0 = no source location (graph findings
                       #: put any recovered file:line in the message)
    anchor: str = ""   #: stable identity component (see module docstring)
    layer: str = "ast"  #: "ast" | "graph" | "san"
    version: int = 1   #: emitting rule's semantic version (fingerprinted)
    baselined: bool = field(default=False, compare=False)
    baseline_reason: str = field(default="", compare=False)

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha1(
            f"{self.layer}|{self.rule}|v{self.version}|{self.path}|"
            f"{self.anchor}".encode()).hexdigest()[:16]
        return f"{self.layer}:{self.rule}:{h}"

    @property
    def location(self) -> str:
        if self.layer == "graph":
            return f"<graph:{self.anchor}>"
        return f"{self.path}:{self.line}" if self.line else self.path

    def render(self) -> str:
        tag = " [baselined]" if self.baselined else ""
        return (f"{self.location}: {self.severity}: {self.rule}: "
                f"{self.message}{tag}")

    def to_json(self) -> dict:
        return {
            "fingerprint": self.fingerprint, "rule": self.rule,
            "severity": self.severity, "message": self.message,
            "location": self.location, "layer": self.layer,
        }


def anchored(findings: list[Finding]) -> list[Finding]:
    """Disambiguate findings whose (rule, path, anchor) collide by
    suffixing an occurrence index — two textually identical violations
    in one file stay two baseline entries, in source order."""
    seen: dict[tuple, int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        key = (f.layer, f.rule, f.path, f.anchor)
        n = seen.get(key, 0)
        seen[key] = n + 1
        if n:
            f.anchor = f"{f.anchor}#{n}"
    return findings
