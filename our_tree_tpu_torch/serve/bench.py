"""``python -m our_tree_tpu_torch.serve.bench``: the serving benchmark.

Port of ``our_tree_tpu.serve.bench``.
Closed-loop (or open-loop, ``--arrival-rate``) load against an in-process
``Server``: mixed request sizes, multi-tenant keys, the served-mode mix
(``--modes``, from ``ctr``, ``gcm``, ``gcm-open``, ``cbc`` and ``rc4``: the
server enables and warms exactly these ladders, and each request draws its
mode uniformly from them, ``rc4`` aside, whose traffic is the sessions;
``gcm-open`` needs ``--verify-every`` > 0, since open traffic replays the
sealed probe pairs),
p50/p95/p99 latency (per mode too, with more than ``ctr``), goodput GB/s,
the batch-occupancy histogram, the per-lane breakdown with its health
transitions and the dispatch's stage split. Human-readable ``#`` lines, then
one JSON line last on stdout: the JAX bench line's keys (``modes``, the
requests by mode, when the mix is not ``ctr`` alone), plus the artifact's
sections (``config``, ``load``, ``batches``, ``coalesce``, ``occupancy``,
``compiles``, ``keycache``, ``lanes``, ``queue``, ``device``, ``stages``,
``cost``, ``profile``, ``per_mode``: requests, dispatches, engine calls and
GCM auth failures by mode; ``launches``: the launches during the run of the
kernels the enabled modes call (``ctr_mk`` always, as warmup's ``ctr``
ladder is the canary's; ``ghash_at`` with a GCM mode; ``cbc_mk`` with
``cbc``; ``arc4_prga`` with ``rc4``), and of any other kernel of the port
that launched, 0 on the CPU; ``sessions``: the session store's stats). It
writes the artifact (those sections and the metrics snapshot) only to a
path given with ``--artifact``.

RC4 sessions (``--sessions N --session-chunks M`` with ``rc4`` in
``--modes``): N session clients beside the ordinary traffic, every chunk
verified against the host PRGA; the store's shape is the five
``--session-*`` options (the JAX server's defaults). ``--min-session-hit-rate``
and ``--min-session-replays`` gate the prefetch hit rate and the carry
replays. The lanes' journal: ``--journal PATH`` persists quarantines (lanes
with failure rows start quarantined), and ``--journal PATH --unquarantine
lane:<i>`` clears the named lanes' rows (``resilience.journal.clear_failures``)
and exits without serving.

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

Exit 1 on any of: a lost request (accepted, never answered), a kernel library
build or load after warmup, a probe or session chunk whose bytes (or ``gcm``
tag) differ from the host reference, a coalesce efficiency below
``--min-coalesce``, a prefetch hit rate below ``--min-session-hit-rate``,
fewer carry replays than ``--min-session-replays``. A request that answers
``auth-failed`` is an answer (``errors``), not a failure of the run.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` serves on the plain version.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..obs import costmodel, metrics, profiler, trace
from ..ops import cuda_aes, cuda_arc4, cuda_ghash
from ..resilience import degrade, watchdog
from ..resilience import journal as journal_mod
from . import batcher, loadgen
from .queue import GCM_MODES, unknown_modes
from .server import Server, ServerConfig

#: The kernel wrappers the served modes launch on the card, by kernel name.
MODE_KERNELS = {"ctr_mk": cuda_aes.ctr_scattered_multikey,
                "cbc_mk": cuda_aes.cbc_scattered_multikey,
                "ghash_at": cuda_ghash.ghash_at,
                "arc4_prga": cuda_arc4.prga}

#: The port's other kernel wrappers: a serve run launches none of them, and
#: the ``launches`` section names any that did.
OTHER_KERNELS = {"ctr_gen": cuda_aes.ctr_crypt_words_fused,
                 "ecb_encrypt": cuda_aes.encrypt_words,
                 "ecb_decrypt": cuda_aes.decrypt_words,
                 "ctr_mk_k1": cuda_aes.ctr_crypt_words_explicit,
                 "seq_encrypt": cuda_aes.seq_encrypt,
                 "ghash_scan": cuda_ghash.ghash_scan}


def mode_kernels(modes) -> dict:
    """The kernels a server of ``modes`` launches, by name: ``ctr_mk`` always
    (warmup's ``ctr`` ladder), ``ghash_at`` with a GCM mode, ``cbc_mk``
    with ``cbc``, ``arc4_prga`` with ``rc4``."""
    used = {"ctr_mk"} | ({"ghash_at"} if set(modes) & set(GCM_MODES) else set()) | (
        {"cbc_mk"} if "cbc" in modes else set()) | ({"arc4_prga"} if "rc4" in modes else set())
    return {name: fn for name, fn in MODE_KERNELS.items() if name in used}


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
        native_threads=args.native_threads, max_depth=args.queue_depth,
        request_deadline_s=args.deadline,
        dispatch_deadline_s=args.dispatch_deadline, retries=args.retries, lanes=args.lanes,
        probe_every=args.probe_every, journal=args.journal, max_inflight=args.max_inflight,
        ceiling_gbps=args.ceiling_gbps, modes=args.modes,
        session_window_bytes=args.session_window_bytes,
        session_quantum_bytes=args.session_quantum_bytes,
        session_prefetch_slots=args.session_prefetch_slots,
        session_budget_bytes=args.session_budget_bytes,
        session_per_tenant=args.session_per_tenant)
    server = Server(cfg)
    await server.start()
    arm_task = None
    if args.profile_window is not None:
        arm_task = asyncio.ensure_future(_arm_profile_window(*args.profile_window,
                                                             server.device))
    report = await loadgen.run(
        server, args.requests, concurrency=args.concurrency, sizes=args.sizes,
        tenants=args.tenants, keys_per_tenant=args.keys_per_tenant, seed=args.seed,
        verify_every=args.verify_every, probes=probes, arrival_rate=args.arrival_rate,
        modes=args.mix_modes, session_scripts=args.session_scripts)
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
                                 description="closed-loop serving benchmark of the port "
                                             "(ctr, gcm, gcm-open, cbc, rc4 sessions)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu (the plain version)")
    ap.add_argument("--engine", default="auto",
                    help="serve engine: auto (the kernels on a card, the native C tier on the "
                         "CPU, the plain version where it cannot build), native (ctr in C on "
                         "the host, the other modes on the device's auto engine), or a "
                         "registered engine (ttable: a gather path, not constant time)")
    ap.add_argument("--native-threads", type=int, default=0, metavar="N",
                    help="native-tier ECB threads a slot run (0 = one per 256 KiB)")
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
    ap.add_argument("--modes", default="ctr", metavar="M1,M2",
                    help="served-mode mix (comma list from ctr, gcm, gcm-open, cbc, rc4): the "
                         "server enables and warms exactly these ladders, and each request "
                         "draws its mode uniformly from them (rc4 aside: its traffic is "
                         "--sessions); gcm probes pin ciphertext and tag against the host GCM")
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
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="serve journal: lane quarantines persist there, and lanes with "
                         "failure rows start quarantined")
    ap.add_argument("--unquarantine", action="append", default=None, metavar="LANE",
                    help="release the named lane (e.g. lane:1) by clearing its failure rows "
                         "from --journal (repeatable), then exit without serving")
    ap.add_argument("--sessions", type=int, default=0, metavar="N",
                    help="run N concurrent rc4 sessions beside the ordinary traffic (needs rc4 "
                         "in --modes); every chunk is verified against the host PRGA")
    ap.add_argument("--session-chunks", type=int, default=8, metavar="M",
                    help="data chunks a session (default 8)")
    ap.add_argument("--session-chunk-bytes", default="256,1024,4096", metavar="B1,B2",
                    help="the chunk sizes the session scripts cycle through (16-byte multiples)")
    ap.add_argument("--session-window-bytes", type=int, default=65536)
    ap.add_argument("--session-quantum-bytes", type=int, default=4096)
    ap.add_argument("--session-prefetch-slots", type=int, default=8)
    ap.add_argument("--session-budget-bytes", type=int, default=8 << 20)
    ap.add_argument("--session-per-tenant", type=int, default=16)
    ap.add_argument("--min-session-hit-rate", type=float, default=None, metavar="FRAC",
                    help="exit 1 if the keystream prefetch hit rate ends below FRAC")
    ap.add_argument("--min-session-replays", type=int, default=None, metavar="N",
                    help="exit 1 unless at least N keystream refills were replayed from a "
                         "carry on another lane")
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
    args.modes = tuple(m.strip() for m in args.modes.split(",") if m.strip()) or ("ctr",)
    why = unknown_modes(args.modes)
    if why is not None:
        ap.error(why)
    if "gcm-open" in args.modes and not args.verify_every:
        ap.error("--modes gcm-open requires --verify-every > 0: open traffic replays the "
                 "per-size sealed probe pairs (a made-up tag would answer auth-failed)")
    if args.sessions and "rc4" not in args.modes:
        ap.error("--sessions requires rc4 in --modes: session traffic is the rc4 mode")
    try:
        args.session_chunk_bytes = tuple(int(b) for b in args.session_chunk_bytes.split(",")
                                         if b)
    except ValueError:
        ap.error(f"--session-chunk-bytes wants a comma list of byte counts, got "
                 f"{args.session_chunk_bytes!r}")
    if any(b <= 0 or b % 16 for b in args.session_chunk_bytes):
        ap.error("--session-chunk-bytes must be positive 16-byte multiples (the queue refuses "
                 "partial blocks)")
    # rc4 never rides the uniform mode draw (a chunk needs an open session):
    # the server enables it, the random mix and the probes leave it out.
    args.mix_modes = tuple(m for m in args.modes if m != "rc4") or ("ctr",)
    if args.modes == ("rc4",) and args.requests:
        ap.error("--modes rc4 alone serves only session traffic: pass --requests 0, or add a "
                 "stateless mode for the ordinary mix (e.g. --modes ctr,rc4)")
    if args.unquarantine and not args.journal:
        ap.error("--unquarantine requires --journal (the ledger being edited)")
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
    if args.unquarantine:
        trace.ensure_run()
        cleared = journal_mod.clear_failures(args.journal, args.unquarantine)
        for unit, n in sorted(cleared.items()):
            if n:
                trace.point("quarantine-release", unit=unit, cleared=n)
            print(f"# unquarantine: {unit}: cleared {n} failure row(s)"
                  + ("" if n else " (none recorded)"))
        return 0
    trace.ensure_run()
    metrics.reset()
    # Reference outputs before the server starts (host T-table and host
    # PRGA, no kernel).
    probes = (loadgen.make_probes(args.sizes, args.seed, args.mix_modes) if args.verify_every
              else [])
    args.session_scripts = (loadgen.make_session_probes(
        args.sessions, args.session_chunks, args.seed, chunk_sizes=args.session_chunk_bytes,
        tenants=args.tenants) if args.sessions else None)
    profile_before = profiler.last_summary()
    kernels = {**mode_kernels(args.modes), **OTHER_KERNELS}
    launches_before = {name: fn.launches for name, fn in kernels.items()}
    server, report = asyncio.run(_drive(args, probes))
    used = mode_kernels(args.modes)
    launches = {name: fn.launches - launches_before[name] for name, fn in kernels.items()
                if name in used or fn.launches != launches_before[name]}
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
    # The per-workload split: the mixed-mode drive's evidence that every
    # enabled mode carried traffic, and what each one's requests waited.
    dispatches_by_mode = metrics.counter_by_label("serve_rung_dispatches", "mode")
    device_us_by_mode = metrics.counter_by_label("serve_rung_device_us", "mode")
    windows = metrics.hist_by_label("serve_dispatch_us", "mode")
    per_mode = {
        "requests": metrics.counter_by_label("serve_requests", "mode"),
        "dispatches": dispatches_by_mode,
        "engine_calls": stats["lanes"]["engine_calls_by_mode"],
        "auth_failed": metrics.counter_by_label("serve_auth_failed", "mode"),
        "latency": report.modes,
        # A served dispatch's card time (CUDA events; the compute window on
        # the CPU) and its whole window, by mode.
        "device_us_per_dispatch": {m: round(device_us_by_mode.get(m, 0) / n, 1)
                                   for m, n in dispatches_by_mode.items() if n},
        "window_p50_us": {m: round(metrics.percentile_from_buckets(b, 50), 1)
                          for m, b in windows.items()},
    }
    if args.modes != ("ctr",):
        print("# modes: " + "  ".join(
            f"{m}:{int(n)}" for m, n in per_mode["requests"].items())
            + ("" if not per_mode["auth_failed"] else "  auth_failed: " + "  ".join(
                f"{m}:{int(n)}" for m, n in per_mode["auth_failed"].items())))
        for m, r in report.modes.items():
            print(f"#   mode {m}: requests={r['requests']} ok={r['ok']} "
                  f"verified={r['verified']} p50={r['p50_ms']} p95={r['p95_ms']} "
                  f"p99={r['p99_ms']} ms, dispatches={int(dispatches_by_mode.get(m, 0))}, "
                  f"engine calls={per_mode['engine_calls'].get(m, 0)}, device "
                  f"{per_mode['device_us_per_dispatch'].get(m, 0.0)} µs a dispatch, window "
                  f"p50 {per_mode['window_p50_us'].get(m, 0.0)} µs")
    # The session plane: the store's view beside the scripts' outcomes
    # (load.sessions); the refills are the rc4-prep dispatches.
    sess_stats = stats["sessions"]
    if args.sessions and sess_stats is not None:
        pf = sess_stats["prefetch"]
        hr = pf["hit_rate"]
        print(f"# sessions: opened={sess_stats['opened']} closed={sess_stats['closed']} "
              f"chunks={sess_stats['chunks']} evicted={sess_stats['evicted']} "
              f"shed={sess_stats['shed']} prefetch: dispatches={pf['dispatches']} "
              f"hit_rate={'n/a' if hr is None else f'{hr:.4f}'} stalls={pf['stalls']} "
              f"replays={pf['replays']}; rc4-prep engine calls="
              f"{per_mode['engine_calls'].get('rc4-prep', 0)}, device "
              f"{per_mode['device_us_per_dispatch'].get('rc4-prep', 0.0)} µs a refill")
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
                   "modes": list(args.modes), "journal": args.journal,
                   "profile_window": (list(args.profile_window) if args.profile_window
                                      else None),
                   **({"sessions": args.sessions, "session_chunks": args.session_chunks,
                       "session_chunk_bytes": list(args.session_chunk_bytes),
                       "session_quantum_bytes": args.session_quantum_bytes,
                       "session_prefetch_slots": args.session_prefetch_slots,
                       "session_window_bytes": args.session_window_bytes}
                      if args.sessions else {})},
        "per_mode": per_mode,
        "launches": launches,
        "load": report.to_json(),
        "overlap": overlap,
        "coalesce": coal,
        "batches": {k: stats[k] for k in ("batches", "batches_failed", "batches_timed_out")},
        "lanes": lanes,
        "occupancy": stats["occupancy"],
        "queue": stats["queue"],
        "keycache": stats["keycache"],
        "compiles": stats["compiles"],
        "sessions": sess_stats,
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
    if args.modes != ("ctr",):
        line["modes"] = {m: int(n) for m, n in per_mode["requests"].items()}
    if args.sessions and sess_stats is not None:
        pf = sess_stats["prefetch"]
        line["sessions"] = {
            "opened": sess_stats["opened"], "closed": sess_stats["closed"],
            "chunks": sess_stats["chunks"], "evicted": sess_stats["evicted"],
            "shed": sess_stats["shed"], "hit_rate": pf["hit_rate"], "stalls": pf["stalls"],
            "replays": pf["replays"], "prefetch_dispatches": pf["dispatches"],
            **{k: int(v) for k, v in report.sessions.items()
               if k in ("open_failed", "chunk_failed", "mismatches") and v}}
    if degrade.events():
        line["degraded"] = degrade.events()
    if trace.enabled():
        line["obs"] = trace.metrics_snapshot()
    print(json.dumps(line))

    rc = 0
    if report.mismatches:
        print(f"# FAIL: {report.mismatches} probe response(s) mismatched the host "
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
    pf = (sess_stats or {}).get("prefetch", {})
    if args.min_session_hit_rate is not None:
        hr = pf.get("hit_rate")
        if hr is None or hr < args.min_session_hit_rate:
            print(f"# FAIL: keystream prefetch hit rate {'n/a' if hr is None else f'{hr:.4f}'} "
                  f"< {args.min_session_hit_rate}: chunks waited on demand refills",
                  file=sys.stderr)
            rc = 1
    if args.min_session_replays is not None and pf.get("replays", 0) < args.min_session_replays:
        print(f"# FAIL: {pf.get('replays', 0)} keystream carry replay(s) < "
              f"{args.min_session_replays}: the replay path never ran", file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
