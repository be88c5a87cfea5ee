"""SLO regression gates: compare a serve run against a baseline artifact.

Port of the JAX package's ``obs/slo.py``, whole. ``compare(baseline,
candidate, tolerances)`` checks a run's metrics against a baseline run with
per-metric tolerances and names every violation; ``serve.bench --slo
<baseline.json>`` runs it after a drive and exits 1 on any regression.

Two classes of metric:

* **Bounded ratios** (latency percentiles, goodput), compared relatively:
  a latency may exceed the baseline's by at most ``1 + tol``, goodput may
  fall below it by at most ``1 - tol``. ``--slo-tolerance`` widens them.
* **Counts** (errors, lost, recompiles, mismatches, pulse alerts), compared
  absolutely: the candidate may not exceed the baseline at all.

The per-stage p95 budgets and the cost rows' GB/s moved per engine x mode x
rung gate too, each failure naming its stage or rung. Baselines and
candidates are the serve artifact (``load``/``queue``/``compiles``
sections) or the bench's JSON line; ``python -m our_tree_tpu_torch.obs.slo
BASELINE CANDIDATE`` gates two recorded files with the same code.

Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import sys

#: Relative tolerances for the bounded-ratio metrics: how much WORSE
#: the candidate may be. Latency: candidate <= baseline * (1 + tol);
#: goodput: candidate >= baseline * (1 - tol). Chosen for same-host
#: rerun noise; a run on another host passes wider values per metric.
DEFAULT_TOLERANCES = {
    "p50_ms": 0.50,
    "p95_ms": 0.50,
    "p99_ms": 0.75,
    "goodput_gbps": 0.25,
    #: per-STAGE p95 budget (the waterfall gate): each stage in the
    #: baseline artifact's "stages" section may grow by at most this
    #: fraction. Looser than the end-to-end bands on purpose — single
    #: stages are noisier than their sum — but tight enough that a
    #: regression names WHICH stage moved instead of only that the
    #: total did.
    "stage_p95_us": 1.0,
    #: per-(engine x mode x rung) achieved-GB/s-moved budget (the cost
    #: section's roofline rows, obs/costmodel.py): each row's modeled-
    #: traffic-over-device-time may FALL by at most this fraction of
    #: the baseline. Wide by default (device-time on a shared CPU host
    #: is noisy); the point is the failure NAMES the engine x rung
    #: whose utilization moved, same shape as the per-stage gates.
    "cost_gbps": 0.5,
}

#: Lower-is-better vs higher-is-better among the ratio metrics.
_HIGHER_IS_BETTER = ("goodput_gbps",)

#: Zero-noise count metrics: candidate must not exceed baseline, ever.
COUNT_METRICS = ("errors_total", "lost", "recompiles", "mismatches",
                 "alerts_total")


def extract(doc: dict) -> dict:
    """Normalise a SERVE artifact (or the one-line bench JSON) into the
    flat metric dict ``compare`` consumes."""
    load = doc.get("load", doc)  # artifact nests under "load"; the
    #                              bench line is already flat
    out = {
        "p50_ms": float(load.get("p50_ms", 0.0)),
        "p95_ms": float(load.get("p95_ms", 0.0)),
        "p99_ms": float(load.get("p99_ms", 0.0)),
        "goodput_gbps": float(load.get("goodput_gbps", 0.0)),
        "errors_total": float(sum((load.get("errors") or {}).values())),
        "mismatches": float(load.get("mismatches", 0)),
        "requests": float(load.get("requests", 0)),
    }
    if "queue" in doc:
        out["lost"] = float(doc["queue"].get("lost", 0))
    else:
        out["lost"] = float(load.get("lost", 0))
    if "compiles" in doc:
        out["recompiles"] = float(doc["compiles"].get("steady", 0))
    else:
        out["recompiles"] = float(load.get("recompiles", 0))
    # Pulse alert count (artifact "alerts" section, obs/pulse.py): set
    # ONLY when the artifact carries the section — a baseline from
    # before the pulse engine (or with pulse disabled) promised
    # nothing, and ``compare`` skips count metrics the baseline never
    # recorded.
    alerts = doc.get("alerts")
    if isinstance(alerts, dict) and isinstance(
            alerts.get("total"), (int, float)):
        out["alerts_total"] = float(alerts["total"])
    # The per-stage waterfall budgets (artifact "stages" section:
    # {stage: {p50_us, p95_us, p99_us, count}} — route.bench /
    # serve.bench schema): p95 per stage is the gated quantity.
    stages = doc.get("stages")
    if isinstance(stages, dict):
        out["stages"] = {
            str(name): float(v.get("p95_us", 0.0)
                             if isinstance(v, dict) else v)
            for name, v in stages.items()}
    # The cost-section roofline rows (artifact "cost": {"rows": [...]},
    # obs/costmodel.py): achieved GB/s moved per engine x mode x rung —
    # the utilization-regression gate's surface. Explicit dispatches=0
    # rows (a warmed rung the traffic skipped — present since ot-scope
    # so trend diffs never read omission as coverage) are NOT gate
    # material: "no traffic at this rung this run" must gate nothing,
    # exactly as the row's former absence did.
    cost = doc.get("cost")
    if isinstance(cost, dict) and isinstance(cost.get("rows"), list):
        out["cost"] = {
            f"{r.get('engine')}|{r.get('mode')}|r{r.get('rung')}"
            f"|nr{r.get('nr', 0)}":
                float(r.get("achieved_gbps", 0.0))
            for r in cost["rows"]
            if isinstance(r, dict) and float(r.get("dispatches", 1)) > 0}
    return out


def parse_tolerances(spec: str | None) -> dict:
    """``p95_ms=2.0,goodput_gbps=0.5`` -> overrides merged over the
    defaults. Unknown metric names are rejected (a typo'd override that
    silently kept the default would gate the wrong thing)."""
    tol = dict(DEFAULT_TOLERANCES)
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, sep, val = tok.partition("=")
        name = name.strip()
        if not sep or name not in DEFAULT_TOLERANCES:
            raise ValueError(
                f"bad --slo-tolerance token {tok!r} "
                f"(known: {', '.join(sorted(DEFAULT_TOLERANCES))})")
        tol[name] = max(float(val), 0.0)
    return tol


def compare(baseline: dict, candidate: dict,
            tolerances: dict | None = None) -> list[str]:
    """Every SLO the candidate violates, as human-readable one-liners
    (empty list = the gate is green). ``baseline``/``candidate`` are
    ``extract`` outputs (call it first on raw artifacts)."""
    tol = dict(DEFAULT_TOLERANCES)
    tol.update(tolerances or {})
    failures: list[str] = []
    for name, t in sorted(tol.items()):
        if name in ("stage_p95_us", "cost_gbps"):
            continue  # the per-stage / per-row loops below consume them
        base = baseline.get(name, 0.0)
        cand = candidate.get(name, 0.0)
        if not isinstance(base, (int, float)) or base <= 0:
            continue  # nothing promised (e.g. a zero-latency stub row)
        if name in _HIGHER_IS_BETTER:
            floor = base * (1.0 - t)
            if cand < floor:
                failures.append(
                    f"{name}: {cand:g} < {floor:g} "
                    f"(baseline {base:g}, tolerance -{t:.0%})")
        else:
            ceil = base * (1.0 + t)
            if cand > ceil:
                failures.append(
                    f"{name}: {cand:g} > {ceil:g} "
                    f"(baseline {base:g}, tolerance +{t:.0%})")
    for name in COUNT_METRICS:
        if name not in baseline:
            # Absent = the baseline never promised this count (e.g. a
            # pre-pulse artifact has no alerts_total). The classic four
            # are always present in extract()'s output, so this skip
            # only ever applies to later-added counts.
            continue
        base = baseline.get(name, 0.0)
        cand = candidate.get(name, 0.0)
        if cand > base:
            failures.append(
                f"{name}: {cand:g} > baseline {base:g} "
                "(count metric: no tolerance)")
    # The per-stage budgets: a regression here NAMES the stage that
    # moved (wire vs device vs queue), which is the whole reason the
    # waterfall exists. Stages only the candidate has are new work and
    # gate nothing; stages only the baseline has went to zero — fine.
    st = tol.get("stage_p95_us", 0.0)
    base_stages = baseline.get("stages") or {}
    cand_stages = candidate.get("stages") or {}
    for name in sorted(base_stages):
        base = base_stages.get(name, 0.0)
        cand = cand_stages.get(name, 0.0)
        if base <= 0:
            continue
        ceil = base * (1.0 + st)
        if cand > ceil:
            failures.append(
                f"stage:{name}: p95 {cand:g}µs > {ceil:g}µs "
                f"(baseline {base:g}µs, tolerance +{st:.0%}) — "
                "this stage moved")
    # The utilization budgets: achieved GB/s moved per engine x rung
    # (lower is worse — a drop past tolerance is a device-efficiency
    # regression that NAMES its engine x rung). Rows only the candidate
    # has are new coverage; rows only the baseline has saw no traffic
    # this run — neither gates.
    ct = tol.get("cost_gbps", 0.0)
    base_cost = baseline.get("cost") or {}
    cand_cost = candidate.get("cost") or {}
    for name in sorted(base_cost):
        base = base_cost.get(name, 0.0)
        cand = cand_cost.get(name)
        if base <= 0 or cand is None:
            continue
        floor = base * (1.0 - ct)
        if cand < floor:
            failures.append(
                f"cost:{name}: achieved {cand:g} GB/s moved < {floor:g} "
                f"(baseline {base:g}, tolerance -{ct:.0%}) — this "
                "engine x rung's device utilization moved")
    return failures


def render(baseline: dict, candidate: dict, failures: list[str],
           out=None, prefix: str = "# slo") -> None:
    """The per-metric gate table, pass or fail, repo-`#`-line style."""
    out = out if out is not None else sys.stdout  # bound at CALL time
    names = sorted((set(DEFAULT_TOLERANCES) | set(COUNT_METRICS))
                   - {"stage_p95_us", "cost_gbps"})
    for name in names:
        base = baseline.get(name, 0.0)
        cand = candidate.get(name, 0.0)
        bad = any(f.startswith(name + ":") for f in failures)
        out.write(f"{prefix}: {name:<14} baseline={base:<10g} "
                  f"run={cand:<10g} {'FAIL' if bad else 'ok'}\n")
    base_stages = baseline.get("stages") or {}
    cand_stages = candidate.get("stages") or {}
    for name in sorted(base_stages):
        bad = any(f.startswith(f"stage:{name}:") for f in failures)
        out.write(f"{prefix}: stage:{name:<14} "
                  f"baseline={base_stages.get(name, 0.0):<10g} "
                  f"run={cand_stages.get(name, 0.0):<10g} "
                  f"{'FAIL' if bad else 'ok'}\n")
    base_cost = baseline.get("cost") or {}
    cand_cost = candidate.get("cost") or {}
    for name in sorted(base_cost):
        if cand_cost.get(name) is None:
            continue  # no traffic at this engine x rung this run
        bad = any(f.startswith(f"cost:{name}:") for f in failures)
        out.write(f"{prefix}: cost:{name:<18} "
                  f"baseline={base_cost.get(name, 0.0):<10g} "
                  f"run={cand_cost.get(name, 0.0):<10g} "
                  f"{'FAIL' if bad else 'ok'}\n")
    for f in failures:
        out.write(f"{prefix}: REGRESSION {f}\n")


def gate(baseline_path: str, candidate_doc: dict,
         tolerance_spec: str | None = None, out=None) -> int:
    """Load the baseline artifact, compare, render, return the exit
    code (0 green / 1 regression) — the ``serve.bench --slo`` body."""
    out = out if out is not None else sys.stdout
    with open(baseline_path, encoding="utf-8") as fh:
        baseline = extract(json.load(fh))
    candidate = extract(candidate_doc)
    failures = compare(baseline, candidate,
                       parse_tolerances(tolerance_spec))
    render(baseline, candidate, failures, out=out)
    if failures:
        out.write(f"# slo: GATE FAILED against {baseline_path}: "
                  f"{len(failures)} regression(s)\n")
        return 1
    out.write(f"# slo: gate passed against {baseline_path}\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m our_tree_tpu_torch.obs.slo",
        description="SLO regression gate between two serve artifacts "
                    "(or bench JSON lines)")
    ap.add_argument("baseline", help="the committed promise")
    ap.add_argument("candidate", help="the run under test (artifact or "
                                      "bench JSON line file)")
    ap.add_argument("--tolerance", default=None, metavar="SPEC",
                    help="per-metric overrides, e.g. "
                         "'p95_ms=2.0,goodput_gbps=0.5' (fractions of "
                         "the baseline value)")
    args = ap.parse_args(argv)
    with open(args.candidate, encoding="utf-8") as fh:
        cand = json.load(fh)
    return gate(args.baseline, cand, args.tolerance)


if __name__ == "__main__":
    sys.exit(main())
