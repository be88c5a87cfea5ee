"""Run-dir parsing and the Chrome/Perfetto ``trace.json`` exporter.

Port of the JAX package's ``obs/export.py``, whole. ``load_run(run_dir)``
stitches every ``trace-*.jsonl`` of a run directory into one ``Run``: spans
paired from their begin and end events (a begin with no end is an orphan,
the evidence of a process killed or a dispatch abandoned mid-span), points,
counters and gauges kept as events, and every line checked against the v1
schema (violations are collected, never raised). A process's rotated
segments (``OT_TRACE_MAX_MB``) are read in the order they were written
(``_segment_order``). The ``metrics-*.jsonl`` snapshot files are parsed
beside them under the same rule: ``Run.snapshots`` keeps the time series,
``Run.metrics_totals()`` folds the last snapshot of each process into final
totals. ``to_chrome_trace``/``write_chrome_trace`` emit the Trace Event
Format JSON that ``chrome://tracing`` and https://ui.perfetto.dev open,
with the snapshots' gauges as counter tracks.

Stdlib only.
"""

from __future__ import annotations

import glob
import json
import os
import re

from . import trace as _trace

#: Required fields per event type (the schema the --check gate enforces).
_REQUIRED = {
    "b": ("id", "name", "ts"),
    "e": ("id", "ts", "status"),
    "c": ("name", "ts", "n"),
    "g": ("name", "ts", "value"),
    "p": ("name", "ts"),
}

#: Required fields per metrics snapshot line, and the shape of each
#: series entry ([name, {labels}, value-or-hist]) — obs/metrics.py's
#: ``_snapshot_rec`` schema, gated by --check like span events.
_SNAP_SECTIONS = ("counters", "gauges", "hists")
METRICS_KIND = "ot-metrics"


class SpanRec:
    """One reconstructed span. ``end_ts`` is None for an orphan (no end
    event reached the file — the process died inside the span); callers
    use ``dur_us(run_end)`` which closes orphans at the run's end."""

    __slots__ = ("id", "name", "parent", "ts", "end_ts", "status", "attrs",
                 "pid", "proc", "tid")

    def __init__(self, rec: dict, pid: int, proc: str):
        self.id = rec["id"]
        self.name = rec["name"]
        self.parent = rec.get("parent")
        self.ts = rec["ts"]
        self.attrs = rec.get("attrs", {})
        self.pid, self.proc, self.tid = pid, proc, rec.get("tid", 0)
        self.end_ts = None
        self.status = None

    @property
    def orphan(self) -> bool:
        return self.end_ts is None

    def dur_us(self, run_end: int) -> int:
        return max((self.end_ts if self.end_ts is not None else run_end)
                   - self.ts, 0)


class Run:
    """A parsed run: ``spans`` (id -> SpanRec, orphans included),
    ``events`` (the raw c/g/p records, each annotated with ``pid``),
    ``procs`` (pid -> header), ``violations`` (file, line-no, reason),
    ``t0``/``t1`` (first/last event timestamps, µs)."""

    def __init__(self):
        self.spans: dict[str, SpanRec] = {}
        self.events: list[dict] = []
        self.procs: dict[int, dict] = {}
        #: proc token -> metrics-file header, and the snapshot time
        #: series (cumulative; each annotated with "pid" and "proc" —
        #: the token is the aggregation key, like the trace side, so
        #: pid reuse across a long run cannot merge two processes).
        self.metric_procs: dict[str, dict] = {}
        self.snapshots: list[dict] = []
        self.violations: list[tuple[str, int, str]] = []
        self.t0: int | None = None
        self.t1: int | None = None

    def _see(self, ts) -> None:
        if isinstance(ts, int):
            self.t0 = ts if self.t0 is None else min(self.t0, ts)
            self.t1 = ts if self.t1 is None else max(self.t1, ts)

    def orphans(self) -> list[SpanRec]:
        return [s for s in self.spans.values() if s.orphan]

    def points(self, name: str | None = None) -> list[dict]:
        return [e for e in self.events
                if e["ev"] == "p" and (name is None or e["name"] == name)]

    def counter_totals(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for e in self.events:
            if e["ev"] == "c":
                out[e["name"]] = out.get(e["name"], 0) + e.get("n", 0)
        return out

    def ancestor_attr(self, span: SpanRec, key: str):
        """Walk the (cross-process) parent chain until a span carrying
        ``attrs[key]`` — how a barrier span deep inside a child is
        attributed to the supervisor's unit attempt."""
        seen = set()
        cur: SpanRec | None = span
        while cur is not None and cur.id not in seen:
            seen.add(cur.id)
            if key in cur.attrs:
                return cur.attrs[key]
            cur = self.spans.get(cur.parent) if cur.parent else None
        return None

    def clock_offsets(self) -> dict[int, int]:
        """Per-pid clock offsets (µs) estimated from the wire handshake.

        The router traces a ``wire-skew`` point per canary exchange:
        ``skew_us`` = backend reply timestamp minus the exchange
        midpoint, ``pid`` = the backend process (from the response
        frame). The MEDIAN per pid is that process's estimated offset
        from the router's clock — subtracting it re-aligns the merged
        timeline (``to_chrome_trace(align=True)``) so a backend with a
        skewed clock no longer renders its spans displaced from the
        router spans that caused them. Empty when no handshake points
        exist (single-process runs need no alignment)."""
        by_pid: dict[int, list[int]] = {}
        for p in self.points("wire-skew"):
            a = p.get("attrs", {})
            pid, skew = a.get("pid"), a.get("skew_us")
            if isinstance(pid, int) and isinstance(skew, (int, float)):
                by_pid.setdefault(pid, []).append(int(skew))
        out = {}
        for pid, skews in by_pid.items():
            skews.sort()
            out[pid] = skews[len(skews) // 2]
        return out

    def metrics_totals(self) -> dict:
        """Final registry totals across the run's processes: the LAST
        snapshot per pid (snapshots are cumulative), counters and
        histogram buckets SUMMED across pids, gauges last-write by
        snapshot timestamp. Keys are ``name`` / ``name{k=v,...}`` flat
        series names (obs.metrics.flat_name layout); hist values are
        {"buckets", "count", "sum"}."""
        last: dict[str, dict] = {}
        for snap in self.snapshots:
            # Keyed by the PROC TOKEN, not the pid: snapshots are
            # cumulative PER PROCESS, and a reused pid late in a soak
            # would otherwise silently replace (and so drop) the dead
            # process's final totals — the same reuse hazard the trace
            # file names absorb with their 8-hex token.
            proc = snap.get("proc", str(snap.get("pid", -1)))
            if proc not in last or snap.get("ts", 0) >= last[proc].get(
                    "ts", 0):
                last[proc] = snap
        counters: dict[str, float] = {}
        gauges: dict[str, tuple] = {}
        hists: dict[str, dict] = {}
        for _proc, snap in sorted(last.items()):
            ts = snap.get("ts", 0)
            for name, labels, v in snap.get("counters", []):
                key = _flat(name, labels)
                counters[key] = counters.get(key, 0) + v
            for name, labels, v in snap.get("gauges", []):
                key = _flat(name, labels)
                if key not in gauges or ts >= gauges[key][0]:
                    gauges[key] = (ts, v)
            for name, labels, h in snap.get("hists", []):
                key = _flat(name, labels)
                agg = hists.setdefault(
                    key, {"buckets": {}, "count": 0, "sum": 0.0})
                for b, c in h.get("buckets", {}).items():
                    agg["buckets"][b] = agg["buckets"].get(b, 0) + c
                agg["count"] += h.get("count", 0)
                agg["sum"] += h.get("sum", 0.0)
                # Tail exemplars (obs/metrics.py): per bucket, the max
                # observation wins across processes — same retention
                # rule the live registry applies within one.
                for b, e in (h.get("exemplars") or {}).items():
                    if not isinstance(e, dict) or "v" not in e:
                        continue
                    ex = agg.setdefault("exemplars", {})
                    cur = ex.get(b)
                    if cur is None or e["v"] >= cur.get("v", 0):
                        ex[b] = dict(e)
        return {"counters": counters,
                "gauges": {k: v for k, (_, v) in gauges.items()},
                "hists": hists}


def _segment_order(path: str):
    """Sort key putting a process's rotated segments in WRITE order.

    A rotating writer (``OT_TRACE_MAX_MB``) names segments
    ``trace-<pid>-<proc>.jsonl`` then ``trace-<pid>-<proc>-s1.jsonl``,
    ``-s2``, ... — and plain ``sorted()`` puts ``-s1`` BEFORE the bare
    first segment (``-`` < ``.``), which would feed span ends to the
    parser before their begins and misreport a healthy rotated run as
    full of violations. Key: (base name, segment number). The metrics
    snapshot files rotate under the same cap with the same naming, so
    the same key orders them (cumulative snapshots make order matter
    less there, but last-per-proc folding still wants write order)."""
    name = os.path.basename(path)
    m = re.fullmatch(
        r"((?:trace|metrics)-\d+-[0-9a-f]+)(?:-s(\d+))?\.jsonl", name)
    if m:
        return (m.group(1), int(m.group(2) or 0))
    return (name, 0)


def _flat(name, labels) -> str:
    """The flat series key (obs.metrics.flat_name layout, duplicated
    here because this module stays import-free of its siblings)."""
    if not labels:
        return str(name)
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def _valid_series(entry, hist: bool) -> bool:
    """One snapshot series entry: [name, {labels}, number-or-hist]."""
    if not (isinstance(entry, (list, tuple)) and len(entry) == 3):
        return False
    name, labels, v = entry
    if not isinstance(name, str) or not isinstance(labels, dict):
        return False
    if hist:
        return (isinstance(v, dict)
                and isinstance(v.get("buckets"), dict)
                and isinstance(v.get("count"), int))
    return isinstance(v, (int, float))


def _load_metrics_file(run: Run, path: str) -> None:
    """Parse one ``metrics-*.jsonl`` snapshot file into ``run`` with the
    same violations-not-raised discipline as the trace files."""
    fname = os.path.basename(path)
    pid, proc = -1, "?"
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                run.violations.append((fname, lineno, "unparseable"))
                continue
            if lineno == 1:
                if rec.get("kind") != METRICS_KIND or rec.get("v") != 1:
                    run.violations.append(
                        (fname, 1, "bad or missing metrics header"))
                    break
                pid = rec.get("pid", -1)
                proc = str(rec.get("proc", pid))
                run.metric_procs[proc] = rec
                run._see(rec.get("start_us"))
                continue
            if not isinstance(rec.get("ts"), int):
                run.violations.append(
                    (fname, lineno, "snapshot missing ts"))
                continue
            bad = [s for s in _SNAP_SECTIONS
                   if not isinstance(rec.get(s), list)]
            if bad:
                run.violations.append(
                    (fname, lineno, f"snapshot missing {bad}"))
                continue
            malformed = (
                [e for s in ("counters", "gauges")
                 for e in rec[s] if not _valid_series(e, hist=False)]
                + [e for e in rec["hists"]
                   if not _valid_series(e, hist=True)])
            if malformed:
                run.violations.append(
                    (fname, lineno,
                     f"malformed series entry {malformed[0]!r}"))
                continue
            run._see(rec["ts"])
            rec["pid"], rec["proc"] = pid, proc
            run.snapshots.append(rec)


def load_run(run_dir: str) -> Run:
    """Parse every ``trace-*.jsonl`` (and ``metrics-*.jsonl``) under
    ``run_dir`` into a ``Run``
    (a process's rotated segments in write order — ``_segment_order``)."""
    run = Run()
    for path in sorted(glob.glob(os.path.join(run_dir, "metrics-*.jsonl")),
                       key=_segment_order):
        _load_metrics_file(run, path)
    for path in sorted(glob.glob(os.path.join(run_dir, "trace-*.jsonl")),
                       key=_segment_order):
        fname = os.path.basename(path)
        pid, proc = -1, "?"
        with open(path, "r", encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # Unparseable line — a torn tail from a killed
                    # writer, or a writer bug. Recorded as a violation
                    # either way: --check fails on any of them, which is
                    # fine because a run with killed children fails the
                    # orphan check regardless (healthy runs tear
                    # nothing: every event is written with one flushed
                    # write()).
                    run.violations.append((fname, lineno, "unparseable"))
                    continue
                if lineno == 1:
                    if (rec.get("kind") != _trace.KIND
                            or rec.get("v") != _trace.VERSION):
                        run.violations.append(
                            (fname, 1, "bad or missing header"))
                        break
                    pid, proc = rec.get("pid", -1), rec.get("proc", "?")
                    run.procs[pid] = rec
                    run._see(rec.get("start_us"))
                    continue
                ev = rec.get("ev")
                if ev not in _REQUIRED:
                    run.violations.append(
                        (fname, lineno, f"unknown ev {ev!r}"))
                    continue
                missing = [k for k in _REQUIRED[ev] if k not in rec]
                if missing:
                    run.violations.append(
                        (fname, lineno, f"{ev} missing {missing}"))
                    continue
                run._see(rec.get("ts"))
                if ev == "b":
                    run.spans[rec["id"]] = SpanRec(rec, pid, proc)
                elif ev == "e":
                    sp = run.spans.get(rec["id"])
                    if sp is None:
                        run.violations.append(
                            (fname, lineno, f"end without begin {rec['id']}"))
                        continue
                    sp.end_ts, sp.status = rec["ts"], rec["status"]
                    if rec.get("attrs"):
                        # End-event attrs (trace.note): measurements
                        # only known at close — device/host time split —
                        # merged into the reconstructed span.
                        sp.attrs = {**sp.attrs, **rec["attrs"]}
                else:
                    rec["pid"] = pid
                    run.events.append(rec)
    return run


def to_chrome_trace(run: Run, align: bool = True) -> dict:
    """The run as a Trace Event Format object (Perfetto/chrome loadable).

    Closed spans become complete ("X") events; orphans become "X" events
    stretched to the run's end with ``killed: true`` in their args — in
    the Perfetto timeline the hung child's dispatch reads as a bar cut
    off at the kill, which is exactly the picture that matters. Points
    are instants ("i"), counters cumulative "C" tracks, gauges "C"
    tracks of their raw value. Timestamps are rebased to the run's
    first event so traces open at t=0.

    ``align=True`` (the default) subtracts each process's estimated
    clock offset (``Run.clock_offsets``, from the wire-skew handshake
    points) from its timestamps, so a multi-HOST run's spans line up on
    one causally-consistent timeline — the router's dispatch bar and the
    backend's queued/dispatch bars nest instead of drifting apart. A
    run with no handshake points is unchanged.
    """
    t0 = run.t0 or 0
    run_end = run.t1 if run.t1 is not None else t0
    offsets = run.clock_offsets() if align else {}

    def ts_of(ts: int, pid: int) -> int:
        return ts - t0 - offsets.get(pid, 0)

    out: list[dict] = []
    for pid, hdr in sorted(run.procs.items()):
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": hdr.get("argv", "?")}})
    for sp in sorted(run.spans.values(), key=lambda s: s.ts):
        args = dict(sp.attrs)
        if sp.orphan:
            args["killed"] = True
        elif sp.status != "ok":
            args["status"] = sp.status
        out.append({"ph": "X", "cat": "ot", "name": sp.name, "pid": sp.pid,
                    "tid": sp.tid, "ts": ts_of(sp.ts, sp.pid),
                    "dur": sp.dur_us(run_end), "args": args})
    # Counter tracks are per-PROCESS in the Trace Event Format, so the
    # cumulative totals must be too — one shared total would show the
    # second child's track starting where the first's ended.
    totals: dict[tuple, float] = {}
    for e in sorted(run.events, key=lambda e: e["ts"]):
        if e["ev"] == "p":
            out.append({"ph": "i", "cat": "ot", "name": e["name"],
                        "pid": e["pid"], "tid": 0,
                        "ts": ts_of(e["ts"], e["pid"]),
                        "s": "p", "args": e.get("attrs", {})})
        elif e["ev"] == "c":
            key = (e["pid"], e["name"])
            totals[key] = totals.get(key, 0) + e.get("n", 0)
            out.append({"ph": "C", "name": e["name"], "pid": e["pid"],
                        "ts": ts_of(e["ts"], e["pid"]),
                        "args": {"value": totals[key]}})
        elif e["ev"] == "g":
            out.append({"ph": "C", "name": e["name"], "pid": e["pid"],
                        "ts": ts_of(e["ts"], e["pid"]),
                        "args": {"value": e.get("value", 0)}})
    # Registry snapshot gauges as counter tracks ("metrics:" prefixed so
    # the flusher's 2 s samples sit beside, not inside, the per-event
    # trace tracks): serve_inflight and serve_queue_depth become visible
    # ON the span timeline — queue pressure lined up against the
    # dispatches that caused it, at any OT_TRACE_SAMPLE rate.
    for snap in sorted(run.snapshots, key=lambda s: s["ts"]):
        for name, labels, v in snap.get("gauges", []):
            out.append({"ph": "C", "name": f"metrics:{_flat(name, labels)}",
                        "pid": snap.get("pid", -1),
                        "ts": ts_of(snap["ts"], snap.get("pid", -1)),
                        "args": {"value": v}})
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if offsets:
        doc["otClockOffsetsUs"] = {str(k): v for k, v in
                                   sorted(offsets.items())}
    return doc


def write_chrome_trace(run: Run, path: str, align: bool = True) -> str:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(to_chrome_trace(run, align=align), fh,
                  separators=(",", ":"), default=repr)
    return path
