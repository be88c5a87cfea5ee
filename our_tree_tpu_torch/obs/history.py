"""The perf-history ledger: the ``*_r*.json`` artifacts of a directory as
trends.

Port of the JAX package's ``obs/history.py``, whole. Every artifact named
``FAMILY_rNN[_variant].json`` (``BENCH``, ``SERVE``, ``ROUTE``, ``STREAM``,
``SESSION``, ``MULTICHIP``) becomes one record of a trend series; serve-like
families are grouped into workload classes (modes x sizes x engine x lanes),
so only runs of the same shape of load trend against each other.

* ``python -m our_tree_tpu_torch.obs.history [--root DIR]`` renders each
  series' trajectory, one row a round, best-ever marked ``*``; the default
  root is the repo's.
* ``--check`` holds each series' head (highest round) against the series'
  best-ever: goodput-like metrics may sit below it by at most the tolerance,
  count metrics (lost, recompiles, mismatches, errors, alerts) never above
  the series' minimum. A failure names the artifact and the metric.

Stdlib only and read-only; an artifact whose schema predates a section
contributes fewer metrics (absent is "nothing promised", never zero).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

#: ``FAMILY_rNN[_variant].json`` at the repo root.
ARTIFACT_RE = re.compile(
    r"^([A-Z]+)_r(\d+)(?:_([A-Za-z0-9_]+))?\.json$")

#: Higher-is-better trend metrics and how far below best-ever the head
#: may sit (fraction of best). Wide enough for same-host rerun noise;
#: tight enough that an order-of-magnitude rot (the failure mode trend
#: diffs exist for) can never ride a new artifact in.
DEFAULT_TOLERANCES = {
    "gbps": 0.25,          # BENCH offline GB/s
    "goodput_gbps": 0.35,  # serve/route payload goodput
    "utilization": 0.50,   # device-time utilization (noisy on CPU)
    "devices": 0.0,        # multichip healthy-device count
    "ok": 0.0,             # multichip all-healthy flag (1/0)
    "session_hit_rate": 0.05,  # keystream prefetch hit rate (SESSION)
}

#: Zero-noise count metrics: the head may never exceed the class's
#: best-ever (minimum) — a lineage that ever achieved 0 lost requests
#: has promised 0 forever.
COUNT_METRICS = ("lost", "recompiles", "mismatches", "errors_total",
                 "alerts_total")

#: Latency percentiles are RENDERED but not gated by default: they are
#: config-sensitive in exactly the way the class key cannot fully pin
#: (request counts, concurrency), and same-config latency gating is
#: the SLO gate's job (obs/slo.py).
RENDER_ONLY = ("p50_ms", "p95_ms", "p99_ms")


def _num(v) -> float | None:
    return float(v) if isinstance(v, (int, float)) else None


def _extract_servelike(doc: dict) -> dict:
    """SERVE_r* / ROUTE_r* artifacts share the load/queue/compiles
    shape (obs/slo.py's extract is the same contract; duplicated
    minimally here because history also reads families slo never
    sees)."""
    load = doc.get("load") or {}
    out: dict = {}
    for k in ("goodput_gbps", "p50_ms", "p95_ms", "p99_ms"):
        v = _num(load.get(k))
        if v is not None:
            out[k] = v
    errors = load.get("errors")
    if isinstance(errors, dict):
        out["errors_total"] = float(sum(errors.values()))
    v = _num(load.get("mismatches"))
    if v is not None:
        out["mismatches"] = v
    q = doc.get("queue") or {}
    v = _num(q.get("lost"))
    if v is not None:
        out["lost"] = v
    comp = doc.get("compiles") or {}
    v = _num(comp.get("steady"))
    if v is not None:
        out["recompiles"] = v
    dev = doc.get("device") or {}
    v = _num(dev.get("utilization"))
    if v is not None:
        out["utilization"] = v
    # Pulse alert counts (obs/pulse.py): only promised when the round
    # actually ran an engine — an artifact without the section (older
    # rounds, pulse disabled) promises nothing, same as any absent
    # metric.
    alerts = doc.get("alerts")
    if isinstance(alerts, dict):
        v = _num(alerts.get("total"))
        if v is not None:
            out["alerts_total"] = v
    return out


def _extract(family: str, doc: dict) -> dict:
    if family == "BENCH":
        parsed = doc.get("parsed") or {}
        out = {}
        if parsed.get("unit") == "GB/s" and _num(parsed.get("value")):
            out["gbps"] = float(parsed["value"])
        rc = _num(doc.get("rc"))
        if rc is not None:
            out["errors_total"] = rc
        return out
    if family == "MULTICHIP":
        out = {}
        v = _num(doc.get("n_devices"))
        if v is not None:
            out["devices"] = v
        if isinstance(doc.get("ok"), bool):
            out["ok"] = 1.0 if doc["ok"] else 0.0
        return out
    if family in ("SERVE", "ROUTE", "STREAM", "SESSION"):
        # STREAM (route.bench --transfer-sizes: the chunked-transfer
        # chaos drive) is servelike too — same load/queue/compiles
        # contract, plus a transfers section the class key pins below.
        # SESSION (serve.bench --sessions: the stateful rc4 drive) adds
        # the keystream prefetch hit rate as a gated gauge.
        out = _extract_servelike(doc)
        if family == "SESSION":
            sess = doc.get("sessions") or {}
            v = _num((sess.get("prefetch") or {}).get("hit_rate"))
            if v is not None:
                out["session_hit_rate"] = v
        return out
    return {}


def _series_class(family: str, doc: dict) -> str:
    """The workload-class half of a series' identity: two rounds only
    trend against each other when they drove the same shape of load.
    Config keys chosen so the real lineages line up (r03→r04→r07→r08
    share a class; the mixed-AEAD and tenant-heavy drives each get
    their own) without making every artifact a singleton."""
    c = doc.get("config") or {}
    if family in ("SERVE", "ROUTE", "STREAM", "SESSION"):
        modes = ",".join(c.get("modes") or ["ctr"])
        sizes = c.get("sizes") or ([c["size_bytes"]]
                                   if c.get("size_bytes") else [])
        parts = [f"modes={modes}",
                 f"sizes={','.join(str(s) for s in sizes)}",
                 f"engine={c.get('engine')}"]
        if family in ("SERVE", "SESSION"):
            parts.append(f"lanes={c.get('lanes')}")
        else:
            parts.append(f"backends={c.get('backends')}")
        if family == "STREAM":
            t = doc.get("transfers") or {}
            tsizes = t.get("sizes") or []
            parts.append(
                f"transfers={','.join(str(s) for s in tsizes)}")
        return ";".join(parts)
    return ""


def collect(root: str) -> list[dict]:
    """Every committed artifact as one trend record:
    {family, round, variant, file, series (family:variant@class),
    metrics, parsed} — sorted by (family, variant, round)."""
    records = []
    for path in sorted(glob.glob(os.path.join(root, "*_r*.json"))):
        m = ARTIFACT_RE.match(os.path.basename(path))
        if not m:
            continue
        family, rnd, variant = m.group(1), int(m.group(2)), m.group(3)
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            records.append({
                "family": family, "round": rnd, "variant": variant,
                "file": os.path.basename(path), "series": family,
                "metrics": {}, "parsed": False,
                "error": f"unreadable: {e}"})
            continue
        if not isinstance(doc, dict):
            doc = {}
        metrics = _extract(family, doc)
        series = family + (f":{variant}" if variant else "")
        cls = _series_class(family, doc)
        if cls:
            series += f"@{cls}"
        records.append({
            "family": family, "round": rnd, "variant": variant,
            "file": os.path.basename(path), "series": series,
            "metrics": metrics, "parsed": bool(metrics)})
    records.sort(key=lambda r: (r["family"], r["variant"] or "",
                                r["round"]))
    return records


def parse_tolerances(spec: str | None) -> dict:
    """``goodput_gbps=0.5,gbps=0.1`` -> overrides merged over the
    defaults (same contract as obs/slo.py — unknown names rejected)."""
    tol = dict(DEFAULT_TOLERANCES)
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, sep, val = tok.partition("=")
        name = name.strip()
        if not sep or name not in DEFAULT_TOLERANCES:
            raise ValueError(
                f"bad --tolerance token {tok!r} "
                f"(known: {', '.join(sorted(DEFAULT_TOLERANCES))})")
        tol[name] = max(float(val), 0.0)
    return tol


def check(records: list[dict],
          tolerances: dict | None = None) -> list[str]:
    """Best-ever gating: for each series, the HEAD (highest round) must
    hold every higher-is-better metric within tolerance of the series'
    best and every count metric at the series' minimum. Returns
    human-readable violations (empty = green). Unreadable artifacts
    are violations; artifacts with no extractable metrics (a schema
    this ledger does not know) are listed by render() but gate
    nothing."""
    tol = dict(DEFAULT_TOLERANCES)
    tol.update(tolerances or {})
    failures = [f"{r['file']}: {r['error']}"
                for r in records if r.get("error")]
    by_series: dict[str, list[dict]] = {}
    for r in records:
        if r["metrics"]:
            by_series.setdefault(r["series"], []).append(r)
    for series, rs in sorted(by_series.items()):
        head = max(rs, key=lambda r: r["round"])
        for name, t in sorted(tol.items()):
            vals = [(r["metrics"][name], r["file"]) for r in rs
                    if name in r["metrics"]]
            if not vals or name not in head["metrics"]:
                continue
            best, best_file = max(vals)
            floor = best * (1.0 - t)
            if head["metrics"][name] < floor:
                failures.append(
                    f"{series}: {name}: head {head['file']} "
                    f"{head['metrics'][name]:g} < {floor:g} "
                    f"(best-ever {best:g} in {best_file}, "
                    f"tolerance -{t:.0%}) — this metric moved")
        for name in COUNT_METRICS:
            vals = [(r["metrics"][name], r["file"]) for r in rs
                    if name in r["metrics"]]
            if not vals or name not in head["metrics"]:
                continue
            best, best_file = min(vals)
            if head["metrics"][name] > best:
                failures.append(
                    f"{series}: {name}: head {head['file']} "
                    f"{head['metrics'][name]:g} > best-ever {best:g} "
                    f"({best_file}; count metric: no tolerance)")
    return failures


#: The trajectory table's metric columns, in render order.
_COLUMNS = ("gbps", "goodput_gbps", "p95_ms", "p99_ms", "utilization",
            "devices", "errors_total", "lost", "recompiles")


def render(records: list[dict], out=None) -> None:
    """The per-series trajectory tables, one row per round, best-ever per
    column marked ``*``."""
    out = out if out is not None else sys.stdout  # bound at CALL time
    by_series: dict[str, list[dict]] = {}
    for r in records:
        by_series.setdefault(r["series"], []).append(r)
    for series, rs in sorted(by_series.items()):
        rs = sorted(rs, key=lambda r: r["round"])
        cols = [c for c in _COLUMNS
                if any(c in r["metrics"] for r in rs)]
        out.write(f"\n{series}: {len(rs)} round(s)\n")
        header = ["round", "file"] + list(cols)
        best = {}
        for c in cols:
            vals = [r["metrics"][c] for r in rs if c in r["metrics"]]
            if vals:
                best[c] = (min(vals) if c in COUNT_METRICS
                           or c in RENDER_ONLY else max(vals))
        rows = []
        for r in rs:
            row = [f"r{r['round']:02d}", r["file"]]
            for c in cols:
                v = r["metrics"].get(c)
                if v is None:
                    row.append("-")
                else:
                    mark = "*" if v == best.get(c) else ""
                    row.append(f"{v:g}{mark}")
            if not r["parsed"]:
                row[-1] = row[-1] if cols else ""
                row.append("(schema unknown to the ledger)")
            rows.append(row)
        widths = [max(len(str(x[i])) for x in [header] + rows)
                  for i in range(len(header))]
        for row in [header] + rows:
            out.write("  " + "  ".join(
                str(c).ljust(w) for c, w in zip(row, widths)).rstrip()
                + "\n")


def repo_root() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m our_tree_tpu_torch.obs.history",
        description="perf-history ledger over the *_r*.json artifacts "
                    "of a directory")
    ap.add_argument("--root", default=None,
                    help="artifact directory (default: the repo root)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless every series' head artifact "
                         "holds best-ever within tolerance (a "
                         "regressing artifact is named with the metric "
                         "that moved)")
    ap.add_argument("--tolerance", default=None, metavar="SPEC",
                    help="per-metric overrides, e.g. "
                         "'goodput_gbps=0.5,gbps=0.1' (fractions of "
                         "best-ever; count metrics tolerate nothing)")
    ap.add_argument("--json", action="store_true",
                    help="emit the records as JSON instead of tables")
    args = ap.parse_args(argv)
    records = collect(args.root or repo_root())
    if not records:
        print("no *_r*.json artifacts found", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(records, indent=1, sort_keys=True))
    else:
        render(records)
    if args.check:
        failures = check(records, parse_tolerances(args.tolerance))
        for f in failures:
            print(f"# history: REGRESSION {f}", file=sys.stderr)
        n_series = len({r['series'] for r in records if r['metrics']})
        if failures:
            print(f"# history: CHECK FAILED: {len(failures)} "
                  f"regression(s) across {len(records)} artifact(s)",
                  file=sys.stderr)
            return 1
        print(f"# history: check green: {len(records)} artifact(s), "
              f"{n_series} series, every head holds best-ever",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
