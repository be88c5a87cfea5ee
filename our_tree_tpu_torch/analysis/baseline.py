"""Port of ``our_tree_tpu.analysis.baseline``: suppress the KNOWN, gate on
the NEW.

``our_tree_tpu_torch/analysis/baseline.json`` is the committed ledger of
findings the tree knowingly carries — each entry a fingerprint plus a
**required reason** (the loader rejects reasonless entries: a baseline
that can absorb findings without justification is just a mute button).
The CI gate (``--fail-on-new``) fails on any finding whose fingerprint
is not on file, so the analyzer ratchets: the baseline can only shrink
without review, never silently grow.

Schema::

    {"version": 1,
     "findings": [{"fingerprint": "...", "rule": "...",
                   "location": "...", "reason": "..."}, ...]}

``rule`` and ``location`` ride along for humans diffing the file; only
the fingerprint matches. ``--write-baseline`` regenerates the file from
the current findings, PRESERVING existing reasons by fingerprint and
stamping ``TODO: justify`` on new entries — a reasonless entry fails
the next load, so a lazily regenerated baseline cannot merge quietly.
"""

from __future__ import annotations

import json
import os

from .findings import Finding

VERSION = 1


class BaselineError(ValueError):
    """Malformed baseline file (bad schema, missing reasons)."""


def load(path: str) -> dict[str, dict]:
    """fingerprint -> entry. Raises BaselineError on schema problems."""
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != VERSION:
        raise BaselineError(
            f"{path}: unsupported baseline version {data.get('version')!r}")
    out: dict[str, dict] = {}
    for i, entry in enumerate(data.get("findings", [])):
        fp = entry.get("fingerprint")
        if not fp:
            raise BaselineError(f"{path}: entry {i} has no fingerprint")
        reason = (entry.get("reason") or "").strip()
        if not reason or reason.startswith("TODO"):
            raise BaselineError(
                f"{path}: entry {fp} ({entry.get('location', '?')}) has no "
                "reason — every baselined finding must say why it is "
                "acceptable")
        if fp in out:
            raise BaselineError(f"{path}: duplicate fingerprint {fp}")
        out[fp] = entry
    return out


def apply(findings: list[Finding], baseline: dict[str, dict]) -> list[str]:
    """Mark baselined findings in place; returns the STALE fingerprints
    (baseline entries no finding matched — fixed violations whose entries
    should be deleted, reported so the baseline cannot rot)."""
    seen = set()
    for f in findings:
        entry = baseline.get(f.fingerprint)
        if entry is not None:
            f.baselined = True
            f.baseline_reason = entry.get("reason", "")
            seen.add(f.fingerprint)
    return sorted(set(baseline) - seen)


def write(path: str, findings: list[Finding],
          old: dict[str, dict] | None = None) -> int:
    """Write the baseline for ``findings``, preserving reasons from
    ``old`` by fingerprint; new entries get a TODO reason the loader
    will reject until a human justifies them. Returns the entry count.

    When a rule's semantic **version** bumps, every fingerprint it
    minted changes, so a reason preserved only by fingerprint would be
    lost on regeneration. The fallback match on (rule, location)
    carries the human's justification across the migration — the entry
    still names the same violation at the same place; only the hash
    moved. A finding that genuinely moved or changed shape misses both
    matches and surfaces as TODO, which the loader rejects: migration
    cannot silently launder an unsound suppression."""
    old = old or {}
    by_rule_loc = {(e.get("rule"), e.get("location")): e
                   for e in old.values()}
    entries = []
    for f in sorted(findings, key=lambda f: (f.layer, f.rule, f.location)):
        prev = old.get(f.fingerprint)
        if prev is None:
            prev = by_rule_loc.get((f.rule, f.location), {})
        entries.append({
            "fingerprint": f.fingerprint,
            "rule": f.rule,
            "location": f.location,
            "reason": prev.get("reason", "TODO: justify this finding"),
        })
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": VERSION, "findings": entries}, fh, indent=2)
        fh.write("\n")
    return len(entries)
