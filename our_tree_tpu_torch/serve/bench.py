"""``python -m our_tree_tpu_torch.serve.bench``: the serving benchmark.

Port of the ctr part of ``our_tree_tpu.serve.bench``. Closed-loop (or
open-loop, ``--arrival-rate``) load against an in-process ``Server``:
mixed request sizes, multi-tenant keys, p50/p95/p99 latency, goodput GB/s,
the batch-occupancy histogram, the per-lane breakdown with its health
transitions and the dispatch's stage split. Human-readable ``#`` lines, then
one JSON line last on stdout: the JAX bench line's keys, plus the
artifact's sections (``config``, ``load``, ``batches``, ``coalesce``,
``occupancy``, ``compiles``, ``keycache``, ``lanes``, ``queue``,
``device``, ``stages``, ``cost``, ``profile``). It writes the artifact
(those sections and the metrics snapshot) only to a path given with
``--artifact``.

The roofline sections, as in the reference: ``--ceiling-gbps`` gives the
``device`` section a utilization (card-time goodput over the ceiling) and
the ``cost`` section (``obs/costmodel.py``: per warmed rung, modeled bytes
per dispatch x dispatches over the rung's card time, printed as ``# cost:``
rows) one per rung. ``--profile-window START:DUR`` opens one capture window
(``obs/profiler.py``) DUR seconds long, START seconds into the drive: the
``torch`` tier on a card, the ``stack`` tier on the CPU; its summary and
its cross-check against the cost records form the ``profile`` section. The
window needs ``OT_TRACE_DIR``, where the summary, the exported trace and
the ``cost-*.json`` records land; a window that cannot open is reported as
not armed and the drive goes on.

Exit 1 on any of: a lost request (accepted, never answered), a kernel
library build or load after warmup, a probe whose bytes differ from the
host T-table reference, a coalesce efficiency below ``--min-coalesce``.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` serves on the plain version.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..obs import costmodel, metrics, profiler, trace
from ..resilience import degrade, watchdog
from . import batcher, loadgen
from .server import Server, ServerConfig


async def _arm_profile_window(start_s: float, dur_s: float, device) -> None:
    """The ``--profile-window`` arm: wait out the offset, then open one
    bounded window. A refusal is reported, never fatal."""
    await asyncio.sleep(start_s)
    try:
        out = profiler.start_window(dur_s, armed_by="cli", device=device)
        print(f"# profile-window: armed {dur_s:g}s (tier={out['tier']})", file=sys.stderr)
    except (profiler.CaptureBusy, profiler.CaptureDisabled) as e:
        print(f"# profile-window: not armed: {e}", file=sys.stderr)


async def _drive(args, probes):
    cfg = ServerConfig(
        device=args.device, engine=args.engine, min_bucket_blocks=args.bucket_min,
        max_bucket_blocks=args.bucket_max, key_slots=args.key_slots,
        max_depth=args.queue_depth, request_deadline_s=args.deadline,
        dispatch_deadline_s=args.dispatch_deadline, retries=args.retries, lanes=args.lanes,
        probe_every=args.probe_every, max_inflight=args.max_inflight,
        ceiling_gbps=args.ceiling_gbps)
    server = Server(cfg)
    await server.start()
    arm_task = None
    if args.profile_window is not None:
        arm_task = asyncio.ensure_future(_arm_profile_window(*args.profile_window,
                                                             server.device))
    report = await loadgen.run(
        server, args.requests, concurrency=args.concurrency, sizes=args.sizes,
        tenants=args.tenants, keys_per_tenant=args.keys_per_tenant, seed=args.seed,
        verify_every=args.verify_every, probes=probes, arrival_rate=args.arrival_rate)
    if arm_task is not None and not arm_task.done():
        arm_task.cancel()  # the drive ended before the window's offset
        try:
            await arm_task
        except asyncio.CancelledError:
            pass
    await server.stop()
    # A window still open at drain closes here, shortened, before the
    # sections are stamped; the torch tier's export may take a while.
    profiler.finish(timeout_s=profiler.TORCH_STOP_S)
    return server, report


def _lane_summary(stats: dict, wall_s: float) -> dict:
    """The pool's aggregates plus per-lane goodput and busy fraction."""
    pool = dict(stats["lanes"])
    for row in pool.get("per_lane", []):
        row["goodput_gbps"] = round(row["bytes"] / 1e9 / wall_s, 4) if wall_s > 0 else 0.0
        row["busy_fraction"] = round(row["busy_s"] / wall_s, 4) if wall_s > 0 else 0.0
    return pool


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m our_tree_tpu_torch.serve.bench",
                                 description="closed-loop serving benchmark of the port (ctr)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu (the plain version)")
    ap.add_argument("--engine", default="auto",
                    help="serve engine: auto (the kernels on a card, the plain version on the "
                         "CPU) or a registered engine name")
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--arrival-rate", type=float, default=None, metavar="REQ_PER_S",
                    help="open loop: submit at this fixed rate (--concurrency ignored)")
    ap.add_argument("--max-inflight", type=int, default=None, metavar="N",
                    help="dispatches in flight at once (default: one per lane)")
    ap.add_argument("--mixed-sizes", action="store_true",
                    help=f"request sizes drawn from {loadgen.MIXED_SIZES}")
    ap.add_argument("--sizes", default=None, metavar="B1,B2",
                    help="explicit request-size menu in bytes (comma list)")
    ap.add_argument("--size-bytes", type=int, default=4096,
                    help="fixed request size when --mixed-sizes is off")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--keys-per-tenant", type=int, default=2)
    ap.add_argument("--tenant-heavy", action="store_true",
                    help="many tenants, one key each, sizes "
                         f"{loadgen.TENANT_HEAVY_SIZES}: full rungs only from multi-key packing")
    ap.add_argument("--key-slots", type=int, default=batcher.DEFAULT_KEY_SLOTS, metavar="K")
    ap.add_argument("--bucket-min", type=int, default=batcher.DEFAULT_MIN_BLOCKS,
                    metavar="BLOCKS")
    ap.add_argument("--bucket-max", type=int, default=batcher.DEFAULT_MAX_BLOCKS,
                    metavar="BLOCKS")
    ap.add_argument("--queue-depth", type=int, default=1024)
    ap.add_argument("--deadline", type=float, default=30.0,
                    help="per-request residency deadline, seconds")
    ap.add_argument("--dispatch-deadline", type=float,
                    default=watchdog.default_deadline_s() or 10.0,
                    help="watchdog deadline per lane engine call, seconds "
                         "(default: OT_DISPATCH_DEADLINE, else 10)")
    ap.add_argument("--retries", type=int, default=2,
                    help="dispatch attempts per batch per lane")
    ap.add_argument("--lanes", type=int, default=None, metavar="N",
                    help="dispatch lanes (default: one per visible card)")
    ap.add_argument("--probe-every", type=int, default=8, metavar="BATCHES")
    ap.add_argument("--verify-every", type=int, default=8,
                    help="every Nth request replays a pinned probe (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ceiling-gbps", type=float, default=None, metavar="GBPS",
                    help="the measured ceiling in GB/s of modeled traffic: the device section "
                         "reports card-time goodput over it, the cost rows their utilization")
    ap.add_argument("--profile-window", default=None, metavar="START:DUR",
                    help="open one capture window DUR seconds long, START seconds into the "
                         "drive (torch.profiler on a card, stack sampling on the CPU); needs "
                         "OT_TRACE_DIR, where the summary and trace land")
    ap.add_argument("--min-coalesce", type=float, default=None, metavar="FRAC",
                    help="exit 1 if coalesce efficiency ends below FRAC")
    ap.add_argument("--artifact", default=None, metavar="PATH",
                    help="write the run's artifact JSON here (nothing is written otherwise)")
    args = ap.parse_args(argv)
    if args.profile_window is not None:
        try:
            start_s, _, dur_s = args.profile_window.partition(":")
            args.profile_window = (max(float(start_s), 0.0), max(float(dur_s), 0.05))
        except ValueError:
            ap.error(f"--profile-window wants START:DUR seconds, got {args.profile_window!r}")
    if args.tenant_heavy:
        args.sizes = loadgen.TENANT_HEAVY_SIZES
        args.tenants = max(args.tenants, 24)
        args.keys_per_tenant = 1
    elif args.sizes:
        try:
            args.sizes = tuple(int(s) for s in args.sizes.split(",") if s)
        except ValueError:
            ap.error(f"--sizes wants a comma list of byte counts, got {args.sizes!r}")
    else:
        args.sizes = loadgen.MIXED_SIZES if args.mixed_sizes else (args.size_bytes,)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    trace.ensure_run()
    metrics.reset()
    # Reference outputs before the server starts (host T-table, no kernel).
    probes = loadgen.make_probes(args.sizes, args.seed) if args.verify_every else []
    profile_before = profiler.last_summary()
    server, report = asyncio.run(_drive(args, probes))
    stats = server.stats()
    lanes = _lane_summary(stats, report.wall_s)
    lost = stats["queue"]["lost"]
    overlap = stats["overlap"]
    coal = stats["coalesce"]
    loop_desc = (f"open-loop {args.arrival_rate:g}/s" if args.arrival_rate
                 else f"concurrency={args.concurrency}")
    print(f"# serve: engine={stats['engine']} device={stats['device']} "
          f"ladder={stats['rungs']} lanes={lanes['count']} {loop_desc} tenants={args.tenants}")
    print(f"# requests={report.requests} ok={report.ok} errors={report.errors or '{}'} "
          f"lost={lost} verified={report.verified} mismatches={report.mismatches}")
    print(f"# latency ms: p50={report.p50_ms} p95={report.p95_ms} p99={report.p99_ms}  "
          f"goodput={report.goodput_gbps:.4f} GB/s wall={report.wall_s:.3f}s")
    print(f"# batches={stats['batches']} failed={stats['batches_failed']} "
          f"timed_out={stats['batches_timed_out']} redispatches={lanes['redispatches']} "
          f"quarantines={lanes['quarantine_events']} engine_calls={lanes['engine_calls']} "
          f"builds: warmup={stats['compiles']['warmup']} steady={stats['compiles']['steady']}")
    print(f"# coalesce: efficiency={coal['efficiency']:.4f} "
          f"({coal['payload_blocks']}/{coal['dispatched_blocks']} blocks) "
          f"slot_fill={coal['slot_fill']:.4f} "
          f"({coal['slots_used']}/{stats['batches']}x{coal['key_slots']} slots)")
    for row in lanes["per_lane"]:
        tr = "".join(f" [{t['prev']}->{t['to']}:{t['why']}]" for t in row["transitions"])
        print(f"#   lane {row['lane']} ({row['device']}): {row['dispatches']} dispatch(es), "
              f"{row['blocks']} blocks, {row['goodput_gbps']:.4f} GB/s, "
              f"busy {row['busy_fraction']:.2f}, state={row['state']}{tr}")
    for bucket, h in stats["occupancy"].items():
        print(f"#   bucket {bucket:>5}: {h['batches']} batch(es), "
              f"mean occupancy {h['mean_occupancy']:.2%}")
    stages = metrics.stage_percentiles()
    if stages:
        print("# stages (µs p50/p95): " + "  ".join(
            f"{s}:{st['p50_us']:.0f}/{st['p95_us']:.0f}" for s, st in stages.items()))
    per_lane = lanes["per_lane"]
    busy_s = sum(row["busy_s"] for row in per_lane)
    device_s = sum(row["device_s"] for row in per_lane)
    served_bytes = metrics.counter_total("serve_served_bytes")
    device = {
        "busy_s": round(busy_s, 6),
        "staging_s": round(sum(row["staging_s"] for row in per_lane), 6),
        "device_s": round(device_s, 6),
        "fence_s": round(sum(row["fence_s"] for row in per_lane), 6),
        "device_share": round(device_s / busy_s, 4) if busy_s > 0 else 0.0,
        "device_gbps": round(served_bytes / 1e9 / device_s, 4) if device_s > 0 else 0.0,
        "dispatches_per_s": (round(stats["batches"] / report.wall_s, 3)
                             if report.wall_s > 0 else 0.0),
        "first_dispatch": lanes["first_dispatch"],
        "window_p50_us": round(metrics.percentile_from_buckets(
            metrics.hist_by_label("serve_dispatch_us", "outcome").get("ok", {}), 50), 1),
        "device_p50_us": stages.get("device", {}).get("p50_us", 0.0),
    }
    device["ceiling_gbps"] = args.ceiling_gbps
    device["utilization"] = (round(device["device_gbps"] / args.ceiling_gbps, 4)
                             if args.ceiling_gbps else None)
    print(f"# device: busy_s={device['busy_s']:.3f} staging_s={device['staging_s']:.3f} "
          f"device_s={device['device_s']:.3f} fence_s={device['fence_s']:.3f} "
          f"device_share={device['device_share']:.4f} "
          f"dispatches/s={device['dispatches_per_s']:.1f} "
          f"device_goodput={device['device_gbps']:.4f} GB/s"
          + (f" utilization={device['utilization']:.1%} of {args.ceiling_gbps:g} GB/s ceiling"
             if args.ceiling_gbps else ""))
    first = device["first_dispatch"]
    if first:
        print(f"# first traffic dispatch (rung {first['rung']}): window {first['window_us']} µs, "
              f"device {first['device_us']} µs, staging {first['staging_us']} µs; all "
              f"dispatches' p50 (log2 histogram): window {device['window_p50_us']:.0f} µs, "
              f"device {device['device_p50_us']:.0f} µs")

    # The cost join: modeled bytes per dispatch x per-rung dispatches over
    # the rung's card time -> GB/s moved (traffic, not payload: counters,
    # slots and schedules are the difference) and its utilization.
    cost = costmodel.cost_section(server.cost_records, metrics.snapshot()["counters"],
                                  ceiling_gbps=args.ceiling_gbps)
    for row in cost["rows"]:
        util = f" util={row['utilization']:.1%}" if row["utilization"] is not None else ""
        print(f"# cost: {row['engine']}/{row['mode']} r{row['rung']} nr{row['nr']}: "
              f"{row['dispatches']} disp x {row['modeled_dispatch_bytes'] / 1e6:.3f} MB modeled, "
              f"device {row['device_s']:.6f}s -> {row['achieved_gbps']:.3f} GB/s moved{util}")

    # The profile section: the window's summary joined with the cost
    # records; present iff a window captured during this drive.
    profile_doc = profiler.last_summary()
    profile_section = None
    if profile_doc is not None and profile_doc is not profile_before:
        profile_section = {"capture": profile_doc,
                           "crosscheck": profiler.crosscheck(profile_doc, server.cost_records,
                                                             ceiling_gbps=args.ceiling_gbps)}
        print(f"# profile: tier={profile_doc['tier']} window={profile_doc['seconds']:g}s "
              f"({profile_doc['armed_by']}), {len(profile_doc['rungs'])} rung row(s), device "
              f"{profile_doc['device_us'] / 1e6:.3f}s of {profile_doc['busy_us'] / 1e6:.3f}s "
              "busy in-window" + (f", trace {profile_doc['torch_dir']}"
                                  if profile_doc.get("torch_dir") else ""))
        for row in profile_section["crosscheck"]["rows"]:
            if row["window_gbps"] is None:
                continue
            util = f" util={row['utilization']:.1%}" if row["utilization"] is not None else ""
            print(f"# profile: {row['engine']}/{row['mode']} r{row['rung']}: "
                  f"{row['dispatches']} disp in-window -> {row['window_gbps']:.3f} GB/s "
                  f"moved{util}")

    artifact = {
        "config": {"requests": args.requests, "concurrency": args.concurrency,
                   "sizes": list(args.sizes), "tenants": args.tenants,
                   "keys_per_tenant": args.keys_per_tenant, "engine": stats["engine"],
                   "device": stats["device"], "rungs": stats["rungs"],
                   "key_slots": args.key_slots, "tenant_heavy": bool(args.tenant_heavy),
                   "retries": args.retries, "dispatch_deadline_s": args.dispatch_deadline,
                   "lanes": lanes["count"], "probe_every": args.probe_every,
                   "max_inflight": args.max_inflight, "arrival_rate": args.arrival_rate,
                   "seed": args.seed, "ceiling_gbps": args.ceiling_gbps,
                   "profile_window": (list(args.profile_window) if args.profile_window
                                      else None)},
        "load": report.to_json(),
        "overlap": overlap,
        "coalesce": coal,
        "batches": {k: stats[k] for k in ("batches", "batches_failed", "batches_timed_out")},
        "lanes": lanes,
        "occupancy": stats["occupancy"],
        "queue": stats["queue"],
        "keycache": stats["keycache"],
        "compiles": stats["compiles"],
        "stages": stages,
        "device": device,
        "cost": cost,
        "profile": profile_section,
        "degraded": degrade.events(),
        "metrics": metrics.snapshot(),
    }
    if trace.enabled():
        artifact["obs"] = trace.metrics_snapshot()
    if args.artifact:
        with open(args.artifact, "w", encoding="utf-8") as fh:
            json.dump(artifact, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"# artifact: {args.artifact}", file=sys.stderr)

    # The artifact's sections (``batches``, ``lanes`` and ``device`` are
    # sections here, as in the JAX artifact), then the JAX line's scalar keys.
    line = {k: v for k, v in artifact.items() if k not in ("metrics", "degraded", "obs")}
    line.update({"unit": "serve", "engine": stats["engine"], "requests": report.requests,
                 "ok": report.ok, "errors": dict(sorted(report.errors.items())), "lost": lost,
                 "p50_ms": report.p50_ms, "p95_ms": report.p95_ms, "p99_ms": report.p99_ms,
                 "goodput_gbps": round(report.goodput_gbps, 4),
                 "coalesce_efficiency": coal["efficiency"], "slot_fill": coal["slot_fill"],
                 "max_inflight": overlap["max_inflight"],
                 "inflight_limit": overlap["inflight_limit"],
                 "engine_calls": lanes["engine_calls"], "lanes_used": lanes["placed_across"],
                 "redispatches": lanes["redispatches"],
                 "quarantines": lanes["quarantine_events"],
                 "recompiles": stats["compiles"]["steady"], "mismatches": report.mismatches,
                 "verified": report.verified})
    if degrade.events():
        line["degraded"] = degrade.events()
    if trace.enabled():
        line["obs"] = trace.metrics_snapshot()
    print(json.dumps(line))

    rc = 0
    if report.mismatches:
        print(f"# FAIL: {report.mismatches} probe response(s) mismatched the host T-table "
              "reference", file=sys.stderr)
        rc = 1
    if lost:
        print(f"# FAIL: {lost} request(s) lost: accepted but never answered", file=sys.stderr)
        rc = 1
    if stats["compiles"]["steady"]:
        print(f"# FAIL: {stats['compiles']['steady']} kernel-library build(s) or load(s) "
              "after warmup", file=sys.stderr)
        rc = 1
    if args.min_coalesce is not None and coal["efficiency"] < args.min_coalesce:
        print(f"# FAIL: coalesce_efficiency {coal['efficiency']:.4f} < {args.min_coalesce}",
              file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
