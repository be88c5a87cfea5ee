"""``python -m our_tree_tpu_torch.obs.report <run-dir>``: reconstruct a run.

Port of the JAX package's ``obs/report.py``, whole; ``render`` writes the
same text as the reference's on the same run directory. From the trace and
metrics files alone it answers what each sweep unit cost (wall and card
time), which units were retried or quarantined and why, which faults were
injected and which observed, what degraded and where the time went. An
orphaned span is rendered as a span closed by the kill of its process.

Flags:

* ``--check``: exit 2 on schema violations or orphaned spans.
* ``--expected-orphans NAMES``: a comma list of span names whose orphans are
  expected (a faulted run's gate); each listed name licenses exactly one
  orphan, so repeat a name to allow more.
* ``--trace-json P``: also write the Chrome/Perfetto export
  (``obs/export.py``) to P.
* ``--top N``: the slowest-span table's size (default 10).
* ``--incidents``: render the run's incident bundles (``obs/incident.py``)
  instead; with ``--check``, exit 2 unless every bundle validates.
* ``--profile``: after the report, the run's capture summaries
  (``obs/profiler.py``, the port's ``torch`` and ``stack`` tiers) joined
  with its cost records; with ``--check``, exit 2 unless a capture exists,
  every summary validates and every slowest-exemplar row resolves.
* ``--min-join-frac FRAC``: the routed fleet's trace-join gate: the share of
  the router's ``route-request`` roots with a worker span chained under
  them across processes (``fleet_join_stats``); a no-op on a run without
  ``route-request`` spans (the port's router writes them, ``route/proxy.py``).

Tables, where the run has their spans or series: per unit, per engine (spans
with an ``engine`` attr), per lane (``lane-dispatch``/``lane-probe``: kills
counted), per mode, the serve overlap, the metrics registry's final totals
and percentiles, the stage waterfall, the slowest exemplars resolved to span
chains (``exemplar_rows``), the roofline from the ``cost-*.json`` records,
the warmup build cost (``serve_compile_us``), incident bundles, pulse
alerts and cross-process joins (``fleet_join_stats``).

``<run-dir>`` is ``$OT_TRACE_DIR/<run-id>``; passing ``$OT_TRACE_DIR``
itself picks the newest run inside it (and says so).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

from . import costmodel, export, incident, profiler
from . import metrics as _metrics

#: Span names that count as device-seam time in the per-unit table
#: (the tracer's analogue of the AES-multicore paper's per-phase,
#: per-worker attribution).
DEVICE_SPANS = ("timed-call", "barrier", "chained-dispatch")

#: Span names that represent one attempt at one sweep unit. The
#: supervisor's view ("unit-attempt", includes spawn/kill overhead)
#: wins over the in-process view ("unit") when both exist for a unit —
#: counting both would double every isolated unit's wall time.
ATTEMPT_SPANS = ("unit-attempt", "unit")

#: The fleet waterfall's stage order — the shared vocabulary
#: (obs/metrics.py; route/proxy.py _build_ledger and serve/server.py
#: produce it, route.bench's completeness gate consumes the same tuple).
WATERFALL_STAGES = _metrics.WATERFALL_STAGES


def exemplar_rows(run: export.Run, top: int = 10) -> list[dict]:
    """The slowest-exemplars rows: every tail exemplar the registry
    retained (obs/metrics.py, riding the metrics snapshots), ranked by
    value, each resolved against the trace stream — ``chain`` is the
    exemplar span's ancestor path and ``complete`` whether it reaches a
    root with no missing link. This is the exemplar -> trace
    walk-through as data: a p99 bucket's number becomes one concrete
    request's full span chain (the acceptance gate: rendered rows must
    all resolve on a sampled run)."""
    rows: list[dict] = []
    if not run.snapshots:
        return rows
    for key, h in run.metrics_totals()["hists"].items():
        for b, e in (h.get("exemplars") or {}).items():
            if not isinstance(e, dict):
                continue
            rows.append({"hist": key, "bucket": int(b),
                         "v": float(e.get("v", 0.0)),
                         "span": e.get("span"), "attrs": e})
    rows.sort(key=lambda r: (-r["v"], r["hist"]))
    rows = rows[:top]
    for r in rows:
        chain: list[str] = []
        complete = False
        seen: set[str] = set()
        sp = run.spans.get(r["span"]) if r["span"] else None
        while sp is not None and sp.id not in seen:
            seen.add(sp.id)
            chain.append(sp.name)
            if not sp.parent:
                complete = True  # reached a root: the chain is whole
                break
            sp = run.spans.get(sp.parent)
        r["chain"] = chain
        r["complete"] = complete
    return rows


def fleet_join_stats(run: export.Run) -> dict:
    """Cross-process trace joins: of the run's ``route-request`` spans
    (the router-side roots, one per sampled request), how many have a
    child span in ANOTHER process — i.e. the backend's ``request-queued``
    span actually chained under the router's span id over the wire. The
    CI route drive gates ``joined/total`` (``--min-join-frac``): a
    propagation regression shows up as roots with no cross-process
    children, not as a parse error."""
    roots = [s for s in run.spans.values() if s.name == "route-request"]
    children: dict[str, list] = {}
    for s in run.spans.values():
        if s.parent:
            children.setdefault(s.parent, []).append(s)
    joined = linked = 0
    for r in roots:
        kids = children.get(r.id, [])
        if kids:
            linked += 1
        if any(k.proc != r.proc for k in kids):
            joined += 1
    return {"roots": len(roots), "linked": linked, "joined": joined,
            "frac": (joined / len(roots)) if roots else 0.0}


def _resolve_run_dir(path: str, say=print) -> str:
    if glob.glob(os.path.join(path, "trace-*.jsonl")):
        return path
    runs = sorted(
        d for d in glob.glob(os.path.join(path, "*"))
        if os.path.isdir(d) and glob.glob(os.path.join(d, "trace-*.jsonl")))
    if runs:
        say(f"# {path} holds {len(runs)} run(s); reporting the newest: "
            f"{os.path.basename(runs[-1])}")
        return runs[-1]
    return path


def _s(us: int) -> str:
    return f"{us / 1e6:.3f}"


def _unit_of(run: export.Run, sp: export.SpanRec):
    return sp.attrs.get("unit") or run.ancestor_attr(sp, "unit")


def _nested_in_named_span(run: export.Run, sp: export.SpanRec,
                          names: tuple) -> bool:
    """Whether a span named in ``names`` encloses ``sp`` — only the
    outermost span of a chain may count toward a time sum."""
    seen = set()
    cur = run.spans.get(sp.parent) if sp.parent else None
    while cur is not None and cur.id not in seen:
        if cur.name in names:
            return True
        seen.add(cur.id)
        cur = run.spans.get(cur.parent) if cur.parent else None
    return False


def _nested_in_device_span(run: export.Run, sp: export.SpanRec) -> bool:
    """Whether another device-seam span encloses ``sp``. The e2e timing
    path opens a "barrier" span INSIDE its "timed-call" span (the timed
    region is `block_until_ready(run(...))`), so summing both would
    book the same wall time twice — only the outermost device span of a
    chain counts toward a unit's device_s."""
    return _nested_in_named_span(run, sp, DEVICE_SPANS)


def _table(rows: list[list[str]], header: list[str], out) -> None:
    widths = [max(len(r[i]) for r in [header] + rows)
              for i in range(len(header))]
    for r in [header] + rows:
        out.write("  " + "  ".join(c.ljust(w)
                                   for c, w in zip(r, widths)).rstrip()
                  + "\n")


def render(run: export.Run, top: int = 10, out=sys.stdout,
           expected_orphans: dict | None = None,
           run_dir: str | None = None) -> None:
    run_id = next((h.get("run", "?") for h in run.procs.values()), "?")
    run_end = run.t1 if run.t1 is not None else 0
    orphans = sorted(run.orphans(), key=lambda s: (s.ts, s.id))
    wall = (run.t1 - run.t0) if run.t0 is not None else 0
    out.write(f"run {run_id}: {len(run.procs)} process(es), "
              f"{len(run.spans)} span(s) ({len(orphans)} orphaned), "
              f"{len(run.events)} event(s), wall {_s(wall)}s\n")
    out.write("schema: " + ("OK" if not run.violations else
                            f"{len(run.violations)} violation(s)") + "\n")
    for fname, lineno, why in run.violations:
        out.write(f"  ! {fname}:{lineno}: {why}\n")

    # -- per-unit table ----------------------------------------------------
    attempts: dict[str, list[export.SpanRec]] = {}
    preferred: dict[str, str] = {}
    for sp in run.spans.values():
        if sp.name not in ATTEMPT_SPANS:
            continue
        unit = sp.attrs.get("unit")
        if unit is None:
            continue
        # First listed attempt-span name present for a unit wins
        # (supervisor view over in-process view).
        have = preferred.get(unit)
        if have is None or (ATTEMPT_SPANS.index(sp.name)
                            < ATTEMPT_SPANS.index(have)):
            preferred[unit] = sp.name
        attempts.setdefault(unit, []).append(sp)
    device: dict[str, int] = {}
    rows_fresh: dict[str, int] = {}
    for sp in run.spans.values():
        unit = _unit_of(run, sp)
        if unit is None:
            continue
        if sp.name in DEVICE_SPANS:
            # Closed spans only: an orphan's "duration" runs to the end
            # of the run, which would book the whole post-kill sweep as
            # this unit's device time. Orphans are reported as kills,
            # not as measurements. And outermost-of-chain only: a
            # barrier span nested inside its timed-call span is the
            # same wall time twice.
            if not sp.orphan and not _nested_in_device_span(run, sp):
                device[unit] = device.get(unit, 0) + sp.dur_us(run_end)
        elif sp.name == "row":
            rows_fresh[unit] = rows_fresh.get(unit, 0) + 1
    rows_replayed: dict[str, int] = {}
    for p in run.points("row-replayed"):
        u = p.get("attrs", {}).get("unit", "?")
        rows_replayed[u] = rows_replayed.get(u, 0) + 1
    replayed_units = {p.get("attrs", {}).get("unit")
                      for p in run.points("unit-replayed")}
    failures: dict[str, list[str]] = {}
    for p in run.points("unit-failed"):
        a = p.get("attrs", {})
        failures.setdefault(a.get("unit", "?"), []).append(
            a.get("reason", "?"))
    quarantined = {p.get("attrs", {}).get("unit")
                   for p in run.points("quarantine")}
    released = {p.get("attrs", {}).get("unit")
                for p in run.points("quarantine-release")}

    units = sorted(set(attempts) | set(failures) | quarantined - {None}
                   | (replayed_units - {None}))
    if units:
        out.write("\nper-unit:\n")
        table = []
        for unit in units:
            sps = sorted((s for s in attempts.get(unit, [])
                          if s.name == preferred.get(unit)),
                         key=lambda s: s.ts)
            n_kill = sum(1 for s in sps if s.orphan)
            wall_us = sum(s.dur_us(run_end) for s in sps)
            if unit in quarantined:
                outcome = "quarantined"
            elif sps and sps[-1].end_ts is not None \
                    and sps[-1].status == "ok":
                outcome = "ok"
            elif unit in replayed_units and not sps:
                outcome = "replayed"
            elif sps and sps[-1].orphan:
                outcome = "killed"
            else:
                outcome = (sps[-1].status if sps else "failed")
            fr = rows_fresh.get(unit, 0)
            rp = rows_replayed.get(unit, 0)
            table.append([
                unit, str(len(sps)), _s(wall_us),
                _s(device.get(unit, 0)),
                f"{fr}/{rp}" if fr or rp else "-",
                str(len(failures.get(unit, []))) + (
                    f" kill={n_kill}" if n_kill else ""),
                outcome,
            ])
        _table(table, ["unit", "attempts", "wall_s", "device_s",
                       "rows f/r", "failures", "outcome"], out)

    # -- per-engine device time --------------------------------------------
    # Attribution rides the `engine` attr (the repo-root bench stamps it
    # on probe/measure spans; harness spans inherit it via ancestors).
    # Closed spans only, outermost-of-chain only — same double-counting
    # rules as the per-unit device_s column.
    engine_spans = DEVICE_SPANS + ("measure", "batch-dispatched",
                                   "lane-dispatch", "lane-probe")
    eng_time: dict[str, int] = {}
    eng_count: dict[str, int] = {}
    for sp in run.spans.values():
        if sp.name not in engine_spans or sp.orphan:
            continue
        eng = sp.attrs.get("engine") or run.ancestor_attr(sp, "engine")
        if eng is None:
            continue
        if _nested_in_named_span(run, sp, engine_spans):
            continue
        eng = str(eng)
        eng_time[eng] = eng_time.get(eng, 0) + sp.dur_us(run_end)
        eng_count[eng] = eng_count.get(eng, 0) + 1
    if eng_time:
        out.write("\nper-engine device time:\n")
        _table([[eng, str(eng_count[eng]), _s(eng_time[eng])]
                for eng in sorted(eng_time,
                                  key=lambda e: (-eng_time[e], e))],
               ["engine", "spans", "device_s"], out)

    # -- per-lane device time (serve) --------------------------------------
    # The serve path's fault-domain breakdown: `lane-dispatch` /
    # `lane-probe` spans carry a `lane` attr (serve/lanes.py). Closed
    # spans sum into device_s; an ORPHANED lane span is a kill (a hung
    # dispatch the watchdog ended) and is counted, not timed.
    lane_time: dict[str, int] = {}
    lane_count: dict[str, int] = {}
    lane_probes: dict[str, int] = {}
    lane_kills: dict[str, int] = {}
    for sp in run.spans.values():
        if sp.name not in ("lane-dispatch", "lane-probe"):
            continue
        lane = sp.attrs.get("lane")
        if lane is None:
            continue
        key = str(lane)
        if sp.orphan:
            lane_kills[key] = lane_kills.get(key, 0) + 1
            continue
        if sp.name == "lane-probe":
            lane_probes[key] = lane_probes.get(key, 0) + 1
        else:
            lane_count[key] = lane_count.get(key, 0) + 1
        lane_time[key] = lane_time.get(key, 0) + sp.dur_us(run_end)
    lane_keys = sorted(set(lane_time) | set(lane_kills),
                       key=lambda k: (len(k), k))
    if lane_keys:
        out.write("\nper-lane device time (serve):\n")
        _table([[k, str(lane_count.get(k, 0)),
                 str(lane_probes.get(k, 0)), _s(lane_time.get(k, 0)),
                 (f"{lane_time.get(k, 0) / wall:.0%}" if wall else "-"),
                 str(lane_kills.get(k, 0))]
                for k in lane_keys],
               ["lane", "dispatches", "probes", "device_s", "busy",
                "killed"], out)

    # -- per-mode dispatch (serve) -----------------------------------------
    # The served-workload split (ot-aead): `mode` rides the request,
    # batch-blocks, dispatch-latency, and auth-failure series
    # (serve/queue.py MODES — ctr, gcm, gcm-open, cbc), so a mixed-mode
    # run renders one row per mode: exact request/auth-failed totals
    # from the counters, batches + payload blocks from the
    # serve_batch_blocks histogram, dispatch-latency p50/p95 from the
    # serve_dispatch_us buckets. Registry-fed, so the table stays exact
    # at any OT_TRACE_SAMPLE rate.
    if run.snapshots:
        totals_m = run.metrics_totals()

        def _by_mode(series: dict, name: str) -> dict:
            got: dict[str, list] = {}
            for key, v in series.items():
                m = re.fullmatch(re.escape(name) + r"\{(.*)\}", key)
                if not m:
                    continue
                labels = dict(p.split("=", 1)
                              for p in m.group(1).split(",") if "=" in p)
                mode = labels.get("mode")
                if mode is not None:
                    got.setdefault(mode, []).append(v)
            return got

        req_c = _by_mode(totals_m["counters"], "serve_requests")
        auth_c = _by_mode(totals_m["counters"], "serve_auth_failed")
        blocks_h = _by_mode(totals_m["hists"], "serve_batch_blocks")
        disp_h = _by_mode(totals_m["hists"], "serve_dispatch_us")
        mode_keys = sorted(set(req_c) | set(blocks_h) | set(disp_h))
        if mode_keys:
            rows = []
            for mk in mode_keys:
                batches = sum(h["count"] for h in blocks_h.get(mk, []))
                blocks = sum(h["sum"] for h in blocks_h.get(mk, []))
                disp = _metrics.merge_buckets(
                    [h["buckets"] for h in disp_h.get(mk, [])])
                rows.append([
                    mk, f"{sum(req_c.get(mk, [0])):g}",
                    str(batches), f"{blocks:g}",
                    (f"{_metrics.percentile_from_buckets(disp, 50):.0f}"
                     if disp else "-"),
                    (f"{_metrics.percentile_from_buckets(disp, 95):.0f}"
                     if disp else "-"),
                    f"{sum(auth_c.get(mk, [0])):g}",
                ])
            out.write("\nper-mode dispatch (serve):\n")
            _table(rows, ["mode", "requests", "batches", "blocks",
                          "disp_p50_us", "disp_p95_us", "auth_failed"],
                   out)

    # -- per-backend dispatch (route) --------------------------------------
    # The routing tier's fault-domain breakdown, mirroring the per-lane
    # table one level up: `route-dispatch` / `backend-probe` spans carry
    # a `backend` attr (route/proxy.py). Closed spans sum into wall_s;
    # an ORPHANED route-dispatch span is a kill (a hung backend request
    # the attempt deadline ended) and is counted, not timed.
    be_time: dict[str, int] = {}
    be_count: dict[str, int] = {}
    be_probes: dict[str, int] = {}
    be_kills: dict[str, int] = {}
    be_redisp: dict[str, int] = {}
    for sp in run.spans.values():
        if sp.name not in ("route-dispatch", "backend-probe"):
            continue
        backend = sp.attrs.get("backend")
        if backend is None:
            continue
        key = str(backend)
        if sp.orphan:
            be_kills[key] = be_kills.get(key, 0) + 1
            continue
        if sp.name == "backend-probe":
            be_probes[key] = be_probes.get(key, 0) + 1
        else:
            be_count[key] = be_count.get(key, 0) + 1
            if sp.attrs.get("redispatch"):
                be_redisp[key] = be_redisp.get(key, 0) + 1
        be_time[key] = be_time.get(key, 0) + sp.dur_us(run_end)
    be_keys = sorted(set(be_time) | set(be_kills), key=lambda k: (len(k), k))
    if be_keys:
        out.write("\nper-backend dispatch (route):\n")
        _table([[k, str(be_count.get(k, 0)), str(be_probes.get(k, 0)),
                 str(be_redisp.get(k, 0)), _s(be_time.get(k, 0)),
                 str(be_kills.get(k, 0))]
                for k in be_keys],
               ["backend", "dispatches", "probes", "redispatched",
                "wall_s", "killed"], out)

    # -- serve overlap: the in-flight gauge, reconstructed -----------------
    # The lane pool emits a `serve_inflight` gauge event on every
    # TRAFFIC-dispatch lane window (serve/lanes.py:_inflight — canary
    # probes are excluded: they bypass the server's in-flight cap, so
    # counting them would let a serialized control run read as
    # overlapped); its max over the run is the measured dispatch
    # concurrency — the number the overlapped lane executors exist to
    # push past 1, and the one `serve.bench --min-inflight` gates. The
    # lane-SPAN sweep is the independent cross-check over the SAME
    # population (lane-dispatch spans only): peak simultaneous open
    # spans, orphans counted in flight until the end of the run (a
    # wedged dispatch WAS occupying its lane while it hung).
    inflight = [e for e in run.events
                if e["ev"] == "g" and e["name"] == "serve_inflight"]
    if inflight:
        peak_gauge = int(max(e.get("value", 0) for e in inflight))
        edges: list[tuple[int, int]] = []
        for sp in run.spans.values():
            if sp.name != "lane-dispatch":
                continue
            edges.append((sp.ts, 1))
            edges.append((run_end if sp.end_ts is None else sp.end_ts, -1))
        live = peak_spans = 0
        for _, d in sorted(edges):
            live += d
            peak_spans = max(peak_spans, live)
        out.write(f"\nserve overlap: max in-flight {peak_gauge} "
                  f"(gauge, {len(inflight)} samples), peak concurrent "
                  f"lane spans {peak_spans}\n")

    # -- the metrics registry (final snapshot totals) ----------------------
    # The flusher's cumulative snapshots (obs/metrics.py): counters
    # summed across processes, gauges last-write, histogram percentiles
    # interpolated from the log2 buckets. This table stays EXACT when
    # span tracing is sampled — it is the reconciliation surface for a
    # sampled run ("did we really serve N requests?").
    if run.snapshots:
        totals = run.metrics_totals()
        out.write(f"\nmetrics ({len(run.snapshots)} snapshot(s) from "
                  f"{len(run.metric_procs)} process(es)):\n")
        if totals["counters"]:
            _table([[k, f"{v:g}"]
                    for k, v in sorted(totals["counters"].items())],
                   ["counter", "total"], out)
        if totals["gauges"]:
            _table([[k, f"{v:g}"]
                    for k, v in sorted(totals["gauges"].items())],
                   ["gauge", "last"], out)
        if totals["hists"]:
            rows = []
            for k, h in sorted(totals["hists"].items()):
                b = h["buckets"]
                rows.append([
                    k, str(h["count"]),
                    f"{_metrics.percentile_from_buckets(b, 50):.0f}",
                    f"{_metrics.percentile_from_buckets(b, 95):.0f}",
                    f"{_metrics.percentile_from_buckets(b, 99):.0f}",
                    (f"{h['sum'] / h['count']:.0f}" if h["count"] else "-"),
                ])
            _table(rows, ["histogram", "count", "p50", "p95", "p99",
                          "mean"], out)

    # -- the fleet waterfall (per-stage time attribution) ------------------
    # The cross-process answer to "where does a request's latency go":
    # the router and backends each observe their ledger stages into
    # `route_stage_us{stage=...}` / `serve_stage_us{stage=...}` (the
    # registry is the fleet-wide aggregation — the flusher's snapshots
    # from every process merge here), rendered in request-path order
    # with percentiles interpolated from the log2 buckets. This is the
    # table a goodput gap decomposes on: a miss names its stage, not just
    # its total.
    stage_hists: dict[str, dict] = {}
    if run.snapshots:
        totals_w = run.metrics_totals()
        for key, h in totals_w["hists"].items():
            m = re.fullmatch(r"(?:route|serve)_stage_us\{stage=(\w+)\}",
                             key)
            if m:
                agg = stage_hists.setdefault(
                    m.group(1), {"buckets": {}, "count": 0, "sum": 0.0})
                agg["buckets"] = _metrics.merge_buckets(
                    [agg["buckets"], h["buckets"]])
                agg["count"] += h["count"]
                agg["sum"] += h["sum"]
        if stage_hists:
            out.write("\nfleet waterfall (per-stage time attribution, "
                      "µs):\n")
            rows = []
            known = [s for s in WATERFALL_STAGES if s in stage_hists]
            extra = sorted(set(stage_hists) - set(known))
            for name in known + extra:
                h = stage_hists[name]
                b = h["buckets"]
                rows.append([
                    name, str(h["count"]),
                    f"{_metrics.percentile_from_buckets(b, 50):.0f}",
                    f"{_metrics.percentile_from_buckets(b, 95):.0f}",
                    f"{_metrics.percentile_from_buckets(b, 99):.0f}",
                    (f"{h['sum'] / h['count']:.0f}" if h["count"]
                     else "-"),
                ])
            _table(rows, ["stage", "count", "p50", "p95", "p99", "mean"],
                   out)

    # -- slowest exemplars (histogram tails -> span chains) ----------------
    # The registry's retained tail exemplars (obs/metrics.py), ranked
    # by value and resolved against the trace: the table that turns "a
    # p99 bucket exists" into "THIS request, THIS chain". A row whose
    # chain breaks (span or an ancestor missing from the stream) says
    # so — `--profile --check` gates that none do on a sampled run.
    ex_rows = exemplar_rows(run, top=top)
    if ex_rows:
        out.write("\nslowest exemplars (histogram tails -> span "
                  "chains):\n")
        _table([[r["hist"], f"{r['v']:.0f}", str(r["span"] or "-"),
                 (" < ".join(r["chain"]) if r["chain"] else "-"),
                 ("complete" if r["complete"] else "BROKEN")]
                for r in ex_rows],
               ["histogram", "value_us", "span", "chain", "resolve"],
               out)

    # -- the roofline (cost model x measured device time) ------------------
    # The run dir's cost-*.json records (obs/costmodel.py, stamped at
    # serve warmup) joined with the registry's per-rung dispatch/device
    # counters: modeled HBM bytes moved over measured device time, per
    # engine x mode x rung, with utilization against the measured
    # ceiling when one was recorded — the table that decomposes a serve
    # number below the offline BENCH_r* figure into "which kernel, what
    # utilization, which rung".
    cost_recs: list = []
    ceiling = None
    if run_dir:
        cost_recs, ceiling = costmodel.load_run_records(run_dir)
    if cost_recs and run.snapshots:
        counters_flat = run.metrics_totals()["counters"]
        cs = costmodel.cost_section(cost_recs, counters_flat,
                                    ceiling_gbps=ceiling)
        if cs["rows"]:
            out.write("\nroofline (modeled HBM traffic vs achieved "
                      "device rate):\n")
            _table([[r["engine"], r["mode"], str(r["rung"]),
                     str(r.get("nr", 0)),
                     str(r["dispatches"]),
                     f"{r['modeled_dispatch_bytes'] / 1e6:.3f}",
                     f"{r['device_s']:.3f}",
                     f"{r['achieved_gbps']:.3f}",
                     (f"{r['utilization']:.1%}"
                      if r["utilization"] is not None else "-")]
                    for r in cs["rows"]],
                   ["engine", "mode", "rung", "nr", "disp", "MB/disp",
                    "device_s", "GB/s moved", "util"], out)
            # The one-line gap explain: payload vs modeled traffic over
            # the device windows, utilization vs the roofline, and the
            # dominant NON-device waterfall stage, in a sentence instead of
            # four tables.
            moved = sum(r["modeled_bytes"] for r in cs["rows"])
            dev_s = sum(r["device_s"] for r in cs["rows"])
            served = counters_flat.get("serve_served_bytes", 0.0)
            parts = []
            if dev_s > 0:
                parts.append(f"device moved {moved / 1e9 / dev_s:.3f} "
                             f"GB/s modeled"
                             + (f" ({served / 1e9 / dev_s:.3f} GB/s "
                                f"payload)" if served else ""))
            if ceiling and dev_s > 0:
                parts.append(f"{moved / 1e9 / dev_s / ceiling:.1%} of "
                             f"the {ceiling:g} GB/s ceiling")
            off_device = {s: h for s, h in stage_hists.items()
                          if s != "device" and h["count"]}
            if off_device:
                worst = max(off_device.items(),
                            key=lambda kv: kv[1]["sum"])
                total_stage = sum(h["sum"] for h in stage_hists.values())
                frac = (worst[1]["sum"] / total_stage
                        if total_stage else 0.0)
                parts.append(
                    f"biggest off-device stage: {worst[0]} "
                    f"(p95 {_metrics.percentile_from_buckets(worst[1]['buckets'], 95):.0f}µs, "
                    f"{frac:.0%} of summed stage time)")
            if parts:
                out.write("gap explain: " + "; ".join(parts) + "\n")

    # -- warmup compile cost ------------------------------------------------
    # serve_compile_us{engine, rung}: the kernel-library builds and loads
    # and the seams' first calls, timed into the registry (serve/server.py)
    # — exact at any sample rate, so the startup bill is attributable per
    # rung even on a fully sampled-out run.
    if run.snapshots:
        comp_rows = []
        for key, h in sorted(run.metrics_totals()["hists"].items()):
            m = re.fullmatch(r"serve_compile_us\{engine=([^,}]*),"
                             r"rung=(\d+)\}", key)
            if not m:
                continue
            comp_rows.append([
                m.group(1), m.group(2), str(h["count"]),
                f"{h['sum'] / 1e6:.3f}",
                f"{_metrics.percentile_from_buckets(h['buckets'], 95) / 1e6:.3f}",
            ])
        if comp_rows:
            comp_rows.sort(key=lambda r: (r[0], int(r[1])))
            out.write("\nwarmup compile cost (serve_compile_us):\n")
            _table(comp_rows,
                   ["engine", "rung", "compiles", "total_s", "p95_s"],
                   out)

    # -- incident bundles ---------------------------------------------------
    if run_dir:
        bundles = incident.bundle_index(run_dir)
        if bundles:
            reasons = ", ".join(str(b["reason"]) for b in bundles)
            bad = sum(1 for b in bundles if not b["valid"])
            out.write(f"\nincidents: {len(bundles)} bundle(s): {reasons}"
                      + (f" ({bad} INVALID)" if bad else "")
                      + "  [obs.report --incidents renders them]\n")

    # -- pulse alerts (obs/pulse.py trace points) --------------------------
    alerts = run.points("pulse-alert")
    if alerts:
        by_rule: dict[tuple[str, str], int] = {}
        for p in alerts:
            a = p.get("attrs", {})
            k = (str(a.get("rule", "?")), str(a.get("severity", "?")))
            by_rule[k] = by_rule.get(k, 0) + 1
        out.write(f"\npulse alerts: {len(alerts)}: "
                  + ", ".join(f"{r} x{n} ({sev})"
                              for (r, sev), n in sorted(by_rule.items()))
                  + "  [obs.pulse <run-dir> replays the rule engine]\n")

    # -- cross-process joins + clock skew (fleet tracing) ------------------
    join = fleet_join_stats(run)
    if join["roots"]:
        out.write(f"\nfleet join: {join['joined']}/{join['roots']} "
                  "route-request spans joined by a cross-process backend "
                  f"span ({join['frac']:.1%}; {join['linked']} with any "
                  "child)\n")
    offsets = run.clock_offsets()
    if offsets:
        out.write("clock skew (wire handshake): "
                  + ", ".join(f"pid {pid}: {off:+d}µs"
                              for pid, off in sorted(offsets.items()))
                  + "\n")

    # -- faults: injected vs observed --------------------------------------
    injected: dict[str, int] = {}
    for p in run.points("fault-injected"):
        name = p.get("attrs", {}).get("point", "?")
        injected[name] = injected.get(name, 0) + 1
    observed = {
        "watchdog-expired": len(run.points("watchdog-expired")),
        "child-killed": len(run.points("child-killed")),
        "unit-failed": len(run.points("unit-failed")),
    }
    out.write("\nfaults injected: "
              + (", ".join(f"{k} x{v}" for k, v in sorted(injected.items()))
                 if injected else "none") + "\n")
    out.write("faults observed: "
              + ", ".join(f"{k}={v}" for k, v in sorted(observed.items()))
              + "\n")

    # -- degradations / quarantines ----------------------------------------
    degr = run.points("degrade")
    out.write("degradations: " + (
        "; ".join(
            f"{p['attrs'].get('kind', '?')}"
            + (f" ({p['attrs'].get('why')})" if p.get("attrs", {}).get("why")
               else "")
            for p in degr) if degr else "none") + "\n")
    q = sorted(u for u in quarantined if u)
    out.write("quarantined: " + (", ".join(q) if q else "none"))
    r = sorted(u for u in released if u)
    out.write((f"  released: {', '.join(r)}" if r else "") + "\n")

    # -- slowest spans ------------------------------------------------------
    ranked = sorted(run.spans.values(),
                    key=lambda s: (-s.dur_us(run_end), s.ts, s.id))[:top]
    if ranked:
        out.write(f"\nslowest spans (top {min(top, len(ranked))}):\n")
        _table([[sp.name, _unit_of(run, sp) or "-", str(sp.pid),
                 _s(sp.dur_us(run_end)),
                 "killed" if sp.orphan else (sp.status or "?")]
                for sp in ranked],
               ["span", "unit", "pid", "dur_s", "status"], out)

    # -- orphans ------------------------------------------------------------
    if orphans:
        out.write(f"\norphaned spans ({len(orphans)} — begin with no end: "
                  "the process was killed or died mid-span):\n")
        budget = dict(expected_orphans or {})
        for sp in orphans:
            tag = ""
            if budget.get(sp.name, 0) > 0:
                budget[sp.name] -= 1
                tag = " (expected)"
            out.write(f"  {sp.name} (unit={_unit_of(run, sp) or '-'}, "
                      f"pid {sp.pid}) open {_s(sp.dur_us(run_end))}s "
                      f"until end of run — closed by kill{tag}\n")


def render_incidents(run_dir: str, check: bool = False,
                     out=None, tail: int = 8) -> int:
    """The ``--incidents`` mode: render every flight-recorder bundle in
    the run dir (reason, trigger attrs, the ring's tail, snapshot
    headline counters, cost-record count) and — with ``check`` — exit
    2 unless every bundle validates against the schema
    (``incident.validate_bundle``). A run with NO bundles is a clean
    rc 0 either way: bundle COUNT expectations are the CI drive's own
    asserts, presence is not an error."""
    out = out if out is not None else sys.stdout  # bound at CALL time
    paths = incident.list_bundles(run_dir)
    if not paths:
        out.write(f"no incident bundles under {run_dir}\n")
        return 0
    bad = 0
    for path in paths:
        doc = incident.load_bundle(path)
        viols = incident.validate_bundle(doc)
        d = doc or {}
        out.write(f"incident {os.path.basename(path)}: "
                  f"reason={d.get('reason')} pid={d.get('pid')} "
                  f"ts_us={d.get('ts_us')} "
                  f"ring={len(d.get('ring') or [])} "
                  f"cost_records={len(d.get('cost') or [])}"
                  + (" SCHEMA-INVALID" if viols else "") + "\n")
        for a, v in sorted((d.get("attrs") or {}).items()):
            out.write(f"  attr {a} = {v}\n")
        ring = d.get("ring") or []
        for rec in ring[-tail:]:
            if not isinstance(rec, dict):
                continue
            out.write(
                "  ring "
                f"t={rec.get('t_us')} lane={rec.get('lane')} "
                f"rung={rec.get('rung')} engine={rec.get('engine')} "
                f"mode={rec.get('mode')} outcome={rec.get('outcome')} "
                f"device_us={rec.get('device_us')} "
                f"wall_us={rec.get('wall_us')}\n")
        counters = (d.get("metrics") or {}).get("counters") or {}
        for k in ("serve_served_bytes", "serve_redispatch",
                  "serve_lane_timeout", "serve_auth_failed"):
            hits = {kk: v for kk, v in counters.items()
                    if kk == k or kk.startswith(k + "{")}
            if hits:
                out.write(f"  metric {k} = "
                          f"{sum(hits.values()):g}\n")
        for v in viols:
            out.write(f"  ! {v}\n")
            bad += 1
    if check and bad:
        print(f"CHECK FAILED: {bad} incident-bundle schema "
              "violation(s)", file=sys.stderr)
        return 2
    return 0


def render_profile(run_dir: str, check: bool = False, out=None) -> int:
    """The ``--profile`` section: every capture summary in the run dir
    (obs/profiler.py) — window span, tier, the per-rung kernel wall —
    JOINED against the run dir's cost records (``profiler.crosscheck``)
    so modeled utilization gets its measured in-window cross-check,
    plus the stack-tier hot frames when that tier captured. With
    ``check``: exit 2 on schema-invalid summaries or when NO capture
    exists (the CI mid-drive curl gates that the armed window actually
    landed its artifact)."""
    out = out if out is not None else sys.stdout  # bound at CALL time
    paths = profiler.list_summaries(run_dir)
    if not paths:
        out.write(f"no profile captures under {run_dir}\n")
        if check:
            print("CHECK FAILED: --profile expected at least one "
                  "capture summary in the run dir", file=sys.stderr)
            return 2
        return 0
    cost_recs, ceiling = costmodel.load_run_records(run_dir)
    bad = 0
    for path in paths:
        doc = profiler.load_summary(path)
        viols = profiler.validate_summary(doc)
        d = doc or {}
        out.write(
            f"profile {os.path.basename(path)}: "
            f"tier={d.get('tier')} armed_by={d.get('armed_by')} "
            f"window={d.get('seconds')}s pid={d.get('pid')} "
            f"device {d.get('device_us', 0) / 1e6:.3f}s / busy "
            f"{d.get('busy_us', 0) / 1e6:.3f}s in-window"
            + (" SCHEMA-INVALID" if viols else "") + "\n")
        if d.get("torch_dir"):
            out.write(f"  torch trace: {d['torch_dir']} (chrome://tracing / "
                      "ui.perfetto.dev loadable)\n")
        cc = profiler.crosscheck(d, cost_recs, ceiling)
        if cc["rows"]:
            _table([[r["engine"], r["mode"], str(r["rung"]),
                     str(r["dispatches"]), f"{r['device_s']:.3f}",
                     (f"{r['window_gbps']:.3f}"
                      if r["window_gbps"] is not None else "-"),
                     (f"{r['utilization']:.1%}"
                      if r["utilization"] is not None else "-")]
                    for r in cc["rows"]],
                   ["engine", "mode", "rung", "disp", "device_s",
                    "GB/s moved", "util"], out)
        for st in (d.get("stacks") or [])[:5]:
            out.write(f"  stack x{st.get('count')}: "
                      f"{st.get('frames')}\n")
        for v in viols:
            out.write(f"  ! {v}\n")
            bad += 1
    if check and bad:
        print(f"CHECK FAILED: {bad} profile-summary schema "
              "violation(s)", file=sys.stderr)
        return 2
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="reconstruct a traced run of the port")
    ap.add_argument("run_dir", help="$OT_TRACE_DIR/<run-id> (or "
                                    "$OT_TRACE_DIR: newest run inside)")
    ap.add_argument("--check", action="store_true",
                    help="exit 2 on schema violations or orphaned spans")
    ap.add_argument("--expected-orphans", default="", metavar="NAMES",
                    help="comma list of span names whose orphans are "
                         "EXPECTED (faulted-run gating: a dispatch_hang "
                         "rehearsal's SIGKILLed child leaves exactly its "
                         "open spans orphaned). Each listed name licenses "
                         "ONE orphan (repeat a name to allow more); an "
                         "unlisted-name orphan or an extra orphan past a "
                         "name's budget still fails --check")
    ap.add_argument("--incidents", action="store_true",
                    help="INCIDENT mode: render the run dir's "
                         "flight-recorder bundles (incident-*.json, "
                         "obs/incident.py) instead of the trace "
                         "report; with --check, exit 2 unless every "
                         "bundle is schema-valid (orphan/violation "
                         "gating stays with the plain report run)")
    ap.add_argument("--profile", action="store_true",
                    help="PROFILE mode: render the run dir's capture "
                         "summaries (profile-*.json, obs/profiler.py) "
                         "joined against its cost records — per-rung "
                         "in-window kernel wall vs modeled traffic — "
                         "after the trace report; with --check, exit 2 "
                         "unless at least one capture exists, every "
                         "summary is schema-valid, AND every rendered "
                         "slowest-exemplar row resolves to a complete "
                         "span chain")
    ap.add_argument("--trace-json", default=None, metavar="PATH",
                    help="also write the Chrome/Perfetto trace.json "
                         "(clock-aligned across processes when wire-skew "
                         "handshake points exist)")
    ap.add_argument("--min-join-frac", type=float, default=None,
                    metavar="FRAC",
                    help="fail (exit 2) unless at least FRAC of the "
                         "run's route-request spans are joined by a "
                         "cross-process backend span — the fleet trace-"
                         "propagation gate (no-op when the run has no "
                         "route-request spans)")
    ap.add_argument("--top", type=int, default=10,
                    help="slowest-span table size")
    args = ap.parse_args(argv)

    run_dir = _resolve_run_dir(args.run_dir,
                               say=lambda m: print(m, file=sys.stderr))
    if args.incidents:
        return render_incidents(run_dir, check=args.check)
    run = export.load_run(run_dir)
    if not run.procs:
        print(f"no trace-*.jsonl files under {run_dir}", file=sys.stderr)
        return 1
    expected: dict[str, int] = {}
    for tok in args.expected_orphans.split(","):
        tok = tok.strip()
        if tok:
            expected[tok] = expected.get(tok, 0) + 1
    render(run, top=args.top, expected_orphans=expected,
           run_dir=run_dir)
    if args.profile:
        rc = render_profile(run_dir, check=args.check)
        if rc:
            return rc
        if args.check:
            broken = [r for r in exemplar_rows(run, top=args.top)
                      if not r["complete"]]
            if broken:
                print(f"CHECK FAILED: {len(broken)} slowest-exemplar "
                      "row(s) do not resolve to a complete span chain: "
                      + ", ".join(f"{r['hist']}->{r['span']}"
                                  for r in broken), file=sys.stderr)
                return 2
    if args.trace_json:
        path = export.write_chrome_trace(run, args.trace_json)
        print(f"# perfetto export: {path} "
              f"({len(run.spans)} spans) — open at https://ui.perfetto.dev",
              file=sys.stderr)
    # Per-name BUDGET, not a name allowlist: each listed name licenses
    # one orphan, so two killed children in a rehearsal that kills one
    # cannot hide behind the same three span names.
    budget = dict(expected)
    unexpected = []
    for s in run.orphans():
        if budget.get(s.name, 0) > 0:
            budget[s.name] -= 1
        else:
            unexpected.append(s)
    if args.check and (run.violations or unexpected):
        n_ok = len(run.orphans()) - len(unexpected)
        print(f"CHECK FAILED: {len(run.violations)} schema violation(s), "
              f"{len(unexpected)} unexpected orphaned span(s)"
              + (f" ({n_ok} expected orphan(s) allowed)" if n_ok else ""),
              file=sys.stderr)
        return 2
    if args.min_join_frac is not None:
        join = fleet_join_stats(run)
        if join["roots"] and join["frac"] < args.min_join_frac:
            print(f"CHECK FAILED: only {join['joined']}/{join['roots']} "
                  f"({join['frac']:.1%}) route-request spans joined "
                  f"across processes (< {args.min_join_frac:.1%}) — "
                  "cross-process trace propagation regressed",
                  file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
