"""``python -m our_tree_tpu_torch.route.bench``: the routing tier's drive.

Port of ``our_tree_tpu.route.bench``. Spawns N port workers (``python -m
our_tree_tpu_torch.serve.worker --device <--device>``, on the card by
default, each in its own session through ``resilience.isolate``, SIGTERM
drained and SIGKILLed past the deadline), routes the port's serve load
generator through a ``route.proxy.Router`` over them, and writes its
artifact only to ``--artifact PATH`` (the JAX bench numbers ``ROUTE_r*.json``
files at the repo root; this one adds no file unless asked). A worker that
does not come ready fails the drive: nothing respawns it elsewhere.

The run exits 1 unless:

* **zero lost**, at the router (accepted == answered) and in every worker
  (each worker's EXIT line carries its drain ledger, and a nonzero worker
  rc is a failed drain);
* **bit-exact probes**: every ``verify_every``-th request replays a pinned
  reference through the router, failover included;
* **zero builds after warmup**, summed over the workers' EXIT lines
  (``--allow-recompiles`` waives);
* the fault drives' gates hold: ``--expect-quarantines N``,
  ``--expect-releases N``, ``--min-redispatch N``,
  ``--require-zero-errors``.

``--ab`` runs the drive twice over fresh worker sets, affinity routing then
seeded-random routing, and records both arms' keycache hit ratios
(``--min-affinity-gain``: affinity must be higher). Fault specs in
``OT_FAULTS`` arm this process only (the router's ``backend_fail`` and
``backend_hang`` seams); the spawner strips them from the workers.
``--unquarantine backend:<name>`` (with ``--journal``) is the shared release
edit. The router process touches no device: the summary line prints
``torch.cuda.is_initialized()`` for it (the load generator's reference
imports torch on the CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import sys
import time

import numpy as np

from ..obs import metrics, slo, trace
from ..resilience import degrade, faults, isolate
from ..resilience import journal as journal_mod
from ..serve import loadgen, wire
from ..serve.queue import ERR_TRANSFER_ABORT
from .fleet import (REPLICA_EXIT_KIND, REPLICA_KIND, FailoverClient,
                    FleetConfig, FleetSupervisor, ProcessWorkerHandle,
                    RouterServer, worker_argv)
from .proxy import BackendSpec, Router, RouterConfig
from .status import RouterStatus

#: How long one worker gets to import torch, build/resolve its engine,
#: warm every lane x rung, and print its READY line.
READY_DEADLINE_S = 180.0


def router_cuda_initialized() -> bool | None:
    """Whether this (router) process made a CUDA context: None when torch
    was never imported here, else ``torch.cuda.is_initialized()``. The
    router touches no device; only the workers run kernels."""
    torch = sys.modules.get("torch")
    return None if torch is None else bool(torch.cuda.is_initialized())


def _write_artifact(path: str | None, artifact: dict) -> None:
    """Write the artifact to ``--artifact PATH`` only: a run adds no file
    to the tree unless asked."""
    if not path:
        return
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(artifact, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(f"# artifact: {path}", file=sys.stderr)


def _spawn_backends(args, tag: str):
    """Spawn N serve.worker processes; returns (handles, specs, ready_s),
    ``ready_s[i]`` the wall seconds from the spawns to the bench's read of
    worker i's READY line. Raises after cleaning up if any worker fails to
    come ready."""
    env = dict(os.environ)
    # The router owns this drive's fault points; a backend re-parsing
    # the same spec would double-fire it inside the serve seams.
    env.pop("OT_FAULTS", None)
    handles, specs, ready = [], [], []
    kill_last = getattr(args, "kill_backend_after", None) is not None
    t_spawn = time.monotonic()
    try:
        for i in range(args.backends):
            name = f"b{i}"
            wenv = dict(env)
            if i == 0 and getattr(args, "worker_faults", None):
                # The hung-lane half of the mid-transfer chaos drive
                # lives in exactly ONE worker; the rest stay clean so
                # the blast radius is attributable.
                wenv["OT_FAULTS"] = args.worker_faults
            if kill_last and i == args.backends - 1:
                # The SIGKILL victim writes no trace files: a process
                # that vanishes mid-frame leaves torn spans behind, and
                # obs.report's orphan licensing is for EXPECTED shapes,
                # not collateral.
                wenv.pop("OT_TRACE_DIR", None)
            argv = [sys.executable, "-m", "our_tree_tpu_torch.serve.worker",
                    "--port", "0", "--status-port", "0",
                    "--device", args.device, "--engine", args.engine,
                    "--bucket-min", str(args.bucket_min),
                    "--bucket-max", str(args.bucket_max),
                    "--queue-depth", str(args.worker_queue_depth),
                    "--tenant-depth-frac", str(args.tenant_depth_frac),
                    "--dispatch-deadline", str(args.dispatch_deadline),
                    "--modes", ",".join(args.mode_list)]
            if args.worker_lanes is not None:
                argv += ["--lanes", str(args.worker_lanes)]
            h = isolate.spawn_service(argv, env=wenv,
                                      name=f"{tag}:{name}")
            handles.append(h)
        for i, h in enumerate(handles):
            line = h.read_line(READY_DEADLINE_S)
            doc = None
            if line:
                try:
                    doc = json.loads(line)
                except ValueError:
                    doc = None
            if not (isinstance(doc, dict)
                    and doc.get("kind") == "ot-serve-worker"):
                raise RuntimeError(
                    f"backend b{i} (pid {h.pid}) never came ready "
                    f"within {READY_DEADLINE_S:.0f}s "
                    f"(got {line!r})")
            specs.append(BackendSpec(
                name=f"b{i}", host="127.0.0.1", port=int(doc["port"]),
                status_port=doc.get("status_port"),
                pid=doc.get("pid")))
            ready_s = round(time.monotonic() - t_spawn, 3)
            ready.append(ready_s)
            print(f"# backend b{i}: pid {h.pid} port {doc['port']} "
                  f"status {doc.get('status_port')} "
                  f"engine {doc.get('engine')} lanes {doc.get('lanes')} "
                  f"ready_s {ready_s}",
                  file=sys.stderr)
    except BaseException:
        for h in handles:
            h.stop(term_deadline_s=5.0)
        raise
    return handles, specs, ready


def _teardown(handles, killed=frozenset(),
              ready=()) -> tuple[list[dict], int]:
    """SIGTERM-drain every worker, collect their exit-line docs and the
    worst rc (a worker that lost work exits nonzero; one SIGKILLed past
    the drain deadline reports a negative rc). Indices in ``killed``
    were SIGKILLed ON PURPOSE mid-drive (the chaos arm): their rc is
    recorded in the doc but exempt from the drain verdict — the
    contract they prove is the ROUTER absorbing their loss, not their
    own drain."""
    docs, worst = [], 0
    for i, h in enumerate(handles):
        rc = h.stop(term_deadline_s=60.0)
        out, err = h.drain_output()
        doc = {}
        for line in reversed(out.splitlines()):
            try:
                cand = json.loads(line)
            except ValueError:
                continue
            if (isinstance(cand, dict)
                    and cand.get("kind") == "ot-serve-worker-exit"):
                doc = cand
                break
        if rc != 0 and i not in killed:
            tail = err.strip().splitlines()[-3:]
            print(f"# worker {h.name}: rc={rc}"
                  + (": " + " | ".join(tail) if tail else ""),
                  file=sys.stderr)
        row = {"rc": rc, **doc}
        if i < len(ready):
            row["ready_s"] = ready[i]
        if i in killed:
            row["killed"] = True
        docs.append(row)
        if i not in killed:
            worst = worst if rc == 0 else (rc if worst == 0 else worst)
    return docs, worst


#: Every stage a COMPLETE cross-process waterfall carries (router +
#: backend halves of the per-request ledger) — the shared vocabulary,
#: so this gate and the report's fleet table can never drift apart.
WATERFALL_STAGES = metrics.WATERFALL_STAGES


def waterfall_stats(ledgers: list, tolerance: float = 0.05) -> dict:
    """Aggregate the sampled requests' time-attribution ledgers: how
    many reconstruct a COMPLETE cross-process waterfall (backend half
    arrived and every stage present), how many of those have a stage
    sum within ``tolerance`` of the measured end-to-end latency, and
    per-stage p50/p95/p99 over the complete population (the artifact's
    ``stages`` section, which the SLO per-stage budgets gate).

    What the sum check can and cannot catch: the ``wire`` and host
    ``dispatch`` stages are RESIDUALS of the same clock readings that
    produce ``total_us``, so genuinely unmeasured work folds into them
    by design (that is what makes the stages exhaustive). The check
    therefore guards against OVERCOUNTING — a stage double-booked
    across the wire, clamp saturation when the backend reports more
    time than the router observed, µs-truncation drift — not against
    an unmeasured stage, which cannot exist by construction."""
    complete = [
        l for l in ledgers
        if l.get("complete")
        and all(s in l.get("stages", {}) for s in WATERFALL_STAGES)]
    sum_ok = 0
    per_stage: dict[str, list] = {s: [] for s in WATERFALL_STAGES}
    for l in complete:
        stages, total = l["stages"], l.get("total_us", 0)
        if total > 0 and abs(sum(stages.values()) - total) \
                <= tolerance * total:
            sum_ok += 1
        for s in WATERFALL_STAGES:
            per_stage[s].append(stages[s])
    stages_out = {}
    for s, vals in per_stage.items():
        vals.sort()
        stages_out[s] = {
            "p50_us": metrics.percentile_exact(vals, 50),
            "p95_us": metrics.percentile_exact(vals, 95),
            "p99_us": metrics.percentile_exact(vals, 99),
            "count": len(vals),
        }
    n, nc = len(ledgers), len(complete)
    return {
        "sampled": n,
        "complete": nc,
        "complete_frac": round(nc / n, 4) if n else 0.0,
        "sum_within_tol_frac": round(sum_ok / nc, 4) if nc else 0.0,
        "tolerance": tolerance,
        "stages": stages_out,
    }


def router_stage_p50s(ledgers: list) -> dict:
    """p50 (µs) of the router's own stages, ``router_queue`` and ``wire``,
    over every sampled ledger, complete or not. The port's workers return
    no per-request ledger (``lg``), so no waterfall is complete and each
    ``wire`` is the whole attempt wall, the worker's residency inside it."""
    out = {}
    for s in ("router_queue", "wire"):
        vals = sorted(l["stages"][s] for l in ledgers
                      if s in (l.get("stages") or {}))
        out[s] = metrics.percentile_exact(vals, 50) if vals else None
    out["n"] = len(ledgers)
    return out


def _keycache_ratio(exit_docs: list[dict]) -> float:
    """Aggregate backend keycache hit ratio: hits / (hits + misses)
    summed across every backend's exit ledger — the affinity A/B's
    measured quantity (affinity routes a tenant's key to the one
    backend that already expanded it; random routing re-expands it
    once per backend it wanders to)."""
    hits = sum(d.get("keycache", {}).get("hits", 0) for d in exit_docs)
    misses = sum(d.get("keycache", {}).get("misses", 0) for d in exit_docs)
    return round(hits / (hits + misses), 4) if hits + misses else 0.0


async def _resume_drill(args, router) -> dict:
    """Interrupt one oversized transfer mid-stream (a scoped
    ``transfer_abort`` shot at the LAST chunk's admission, so earlier
    chunks have already landed, been emitted in order, and been acked
    into the ledger), then resume it with the same token: only the
    unacked chunks may be re-sent and the spliced output must be
    byte-identical to an uninterrupted run — the artifact's ``resume``
    section (docs/SERVING.md, streaming transfers)."""
    size = max(args.transfer_sizes)
    step = router.transfers.chunk_blocks * 16
    chunks = (size + step - 1) // step
    rng = random.Random(args.seed ^ 0x51E4A11)
    key = bytes(rng.getrandbits(8) for _ in range(16))
    nonce = bytes(rng.getrandbits(8) for _ in range(16))
    payload = np.frombuffer(rng.randbytes(size), dtype=np.uint8)

    # The reference: the same bytes, uninterrupted, its own token.
    ref = await router.submit_transfer(
        "drill", key, nonce, payload, deadline_s=args.transfer_deadline)

    out = np.zeros(size, dtype=np.uint8)

    def collect(spec, resp):
        piece = np.asarray(resp.payload, dtype=np.uint8)
        out[spec.offset:spec.offset + spec.nbytes] = piece[:spec.nbytes]

    token = f"drill-{args.seed}"
    prev = os.environ.get("OT_FAULTS")
    os.environ["OT_FAULTS"] = f"transfer_abort:1@chunk={chunks - 1}"
    faults.reset()
    try:
        first = await router.submit_transfer(
            "drill", key, nonce, payload,
            deadline_s=args.transfer_deadline,
            resume_token=token, on_chunk=collect)
    finally:
        if prev is None:
            os.environ.pop("OT_FAULTS", None)
        else:
            os.environ["OT_FAULTS"] = prev
        faults.reset()
    second = await router.submit_transfer(
        "drill", key, nonce, payload,
        deadline_s=args.transfer_deadline,
        resume_token=token, on_chunk=collect)

    t2 = dict(second.transfer or {})
    doc = {
        "size": size,
        "chunks": chunks,
        "interrupted": bool(not first.ok
                            and first.error == ERR_TRANSFER_ABORT),
        "first": dict(first.transfer or {}),
        "second": t2,
        "completed": bool(second.ok),
        "byte_identical": bool(
            ref.ok and second.ok
            and out.tobytes()
            == np.asarray(ref.payload, dtype=np.uint8).tobytes()),
        "resent_only_unacked": bool(
            second.ok and t2.get("resumed")
            and t2.get("skipped", 0) > 0
            and t2.get("sent", chunks) < chunks),
    }
    print(f"# resume drill: size={size} chunks={chunks} "
          f"interrupted={doc['interrupted']} "
          f"acked_before_resume={t2.get('skipped')} "
          f"resent={t2.get('sent')} "
          f"byte_identical={doc['byte_identical']}", file=sys.stderr)
    return doc


def _pulse_section(pulse_t) -> dict | None:
    """The artifact's ``alerts`` section from the router's live pulse
    engine (same shape as serve/bench.py's): one final ``tick()`` so
    the tail of the drive sits inside the last window, then the
    engine's document. None when the engine never ran."""
    if pulse_t is None:
        return None
    try:
        pulse_t.tick()
        adoc = pulse_t.engine.alerts_doc()
    except Exception:
        return None
    return {"total": adoc["total"], "fired": adoc["fired"],
            "rows": adoc["alerts"], "frames": adoc["frames"]}


def _fleet_capacity(healthz) -> dict | None:
    """The artifact's ``capacity`` section: each worker's pulse engine
    publishes its live blocks/s estimate on /healthz, the router's
    gossip cached the documents — sum them into the fleet view the
    headroom autoscaler polices."""
    rows = {}
    total = 0.0
    for name, doc in sorted((healthz or {}).items()):
        cap = (doc or {}).get("capacity")
        if isinstance(cap, dict):
            rows[name] = cap
            try:
                total += float(cap.get("total_blocks_per_s") or 0.0)
            except (TypeError, ValueError):
                pass
    if not rows:
        return None
    return {"backends": rows, "total_blocks_per_s": round(total, 3)}


async def _drive(args, specs, affinity: bool, probes,
                 handles=None, drill: bool = False):
    transfers_on = bool(getattr(args, "transfer_sizes", ()))
    cfg = RouterConfig(
        deadline_s=args.deadline,
        attempt_timeout_s=args.attempt_timeout,
        gossip_every_s=args.gossip_every,
        probation_batches=args.probation_batches,
        vnodes=args.vnodes,
        affinity=affinity,
        seed=args.seed,
        journal=args.journal if affinity else None,
        # Response frames carry up to one full top-rung payload; size
        # the router's read ceiling to THIS fleet's ladder.
        max_frame_bytes=max(args.bucket_max * 16 * 2, wire.MAX_PAYLOAD),
        # The chunk rung IS the fleet's top rung: every chunk is an
        # ordinary ladder-shaped request to a backend.
        transfer_chunk_blocks=(args.bucket_max if transfers_on else None),
        transfer_deadline_s=(args.transfer_deadline if transfers_on
                             else 300.0),
        # Size the reassembly budget so the drive's own mix can never
        # shed itself (backpressure is exercised by tests, not here).
        transfer_budget_bytes=(max(64 << 20,
                                   2 * max(args.transfer_sizes))
                               if transfers_on else 64 << 20),
        transfer_ledger=(args.transfer_ledger
                         if transfers_on and affinity else None))
    router = Router(specs, cfg)
    await router.start()
    status = None
    if args.status_port is not None and affinity:
        status = RouterStatus(router, args.status_port,
                              federate=not args.no_federate)
        await status.start()
        print(f"# router status: 127.0.0.1:{status.port} "
              f"(federated /metrics: {not args.no_federate})",
              file=sys.stderr)
    killer = None
    if handles and getattr(args, "kill_backend_after", None) is not None:

        async def _kill():
            await asyncio.sleep(args.kill_backend_after)
            h = handles[-1]
            print(f"# chaos: SIGKILL backend {h.name} (pid {h.pid}) "
                  f"at +{args.kill_backend_after:g}s", file=sys.stderr)
            await asyncio.get_running_loop().run_in_executor(None, h.kill)

        killer = asyncio.create_task(_kill())
    report = await loadgen.run(
        router, args.requests, concurrency=args.concurrency,
        sizes=args.sizes, tenants=args.tenants,
        keys_per_tenant=args.keys_per_tenant, seed=args.seed,
        verify_every=args.verify_every, probes=probes,
        arrival_rate=args.arrival_rate, modes=args.mode_list,
        transfer_sizes=(args.transfer_sizes if transfers_on else ()),
        transfer_every=(getattr(args, "transfer_every", 0)
                        if transfers_on else 0))
    if killer is not None:
        killer.cancel()
        try:
            await killer
        except asyncio.CancelledError:
            pass
    resume = None
    if drill and router.transfers is not None:
        resume = await _resume_drill(args, router)
    # One final gossip pass so the artifact's backend view is current.
    await router.gossip_once()
    healthz = {name: b.last_healthz
               for name, b in router.backends.items()}
    if status is not None:
        await status.stop()
    await router.stop()
    return router, report, healthz, resume


async def _drive_fleet(args, probes) -> dict:
    """The ELASTICITY drive (``--autoscale``): the fleet supervisor owns
    every worker's lifecycle over one live open-loop drive — scale up
    against real pressure, roll one worker through the bit-exact canary
    handoff, lose one router replica to SIGKILL, scale back down to the
    floor once the load passes — while the zero-lost / bit-exact /
    zero-recompile contracts hold throughout. Returns everything
    ``_main_fleet`` folds into the artifact."""
    env = {k: v for k, v in os.environ.items() if k != "OT_FAULTS"}
    wargv = worker_argv(
        engine=args.engine, bucket_min=args.bucket_min,
        bucket_max=args.bucket_max, queue_depth=args.worker_queue_depth,
        tenant_depth_frac=args.tenant_depth_frac,
        dispatch_deadline=args.dispatch_deadline,
        modes=",".join(args.mode_list), lanes=args.worker_lanes,
        device=args.device)

    def factory(name: str) -> ProcessWorkerHandle:
        return ProcessWorkerHandle(name, wargv, env=dict(env),
                                   ready_deadline_s=READY_DEADLINE_S)

    loop = asyncio.get_running_loop()
    max_frame = max(args.bucket_max * 16 * 2, wire.MAX_PAYLOAD)

    # -- the floor fleet (b0..), booted concurrently through the SAME
    # handle/argv template the autoscaler will spawn with, then handed
    # to the supervisor so retire/roll own the full lifecycle.
    names = [f"b{i}" for i in range(args.backends)]
    handles = [factory(n) for n in names]
    replicas: list[dict] = []
    sup = None

    async def _abandon():
        for r in replicas:
            await loop.run_in_executor(None, r["handle"].kill)
        fleet = (list(sup.workers.values()) if sup is not None
                 else list(handles))
        for h in fleet:
            await h.kill()

    try:
        specs = []
        for n, spec in zip(names,
                           await asyncio.gather(*(h.start()
                                                  for h in handles))):
            if spec is None:
                raise RuntimeError(
                    f"fleet worker {n} never came ready within "
                    f"{READY_DEADLINE_S:.0f}s")
            specs.append(spec)
            print(f"# worker {n}: port {spec.port} "
                  f"status {spec.status_port} pid {spec.pid}",
                  file=sys.stderr)

        cfg = RouterConfig(
            deadline_s=args.deadline,
            attempt_timeout_s=args.attempt_timeout,
            gossip_every_s=args.gossip_every,
            probation_batches=args.probation_batches,
            vnodes=args.vnodes, affinity=True, seed=args.seed,
            journal=args.journal, max_frame_bytes=max_frame)
        router = Router(specs, cfg)
        await router.start()

        sup = FleetSupervisor(router, factory, FleetConfig(
            min_workers=args.backends, max_workers=args.fleet_max,
            up_depth=args.up_depth, down_depth=args.down_depth,
            up_busy=args.up_busy, settle_ticks=args.settle_ticks,
            down_settle_ticks=args.down_settle_ticks,
            cooldown_s=args.cooldown, poll_every_s=args.poll_every,
            policy=args.fleet_policy,
            headroom_frac=args.headroom_frac))
        for n, h in zip(names, handles):
            sup.adopt(n, h)

        status = None
        if args.status_port is not None:
            status = RouterStatus(router, args.status_port,
                                  federate=not args.no_federate,
                                  fleet=sup)
            await status.start()
            print(f"# router status: 127.0.0.1:{status.port} "
                  f"(/fleetz live)", file=sys.stderr)

        # -- the replicated router tier: the owner exposes its Router +
        # membership authority on the framed wire; each replica process
        # gossips with it and serves the same fleet. The failover
        # client leads with replica r0 (the one the chaos step kills)
        # and falls back to the owner, then the remaining replicas.
        owner_server = None
        client = router
        if args.routers > 0:
            owner_server = RouterServer(
                router, view_fn=lambda: (sup.epoch, sup.view()),
                max_frame_bytes=max_frame)
            await owner_server.start()
            member_json = json.dumps([
                {"name": s.name, "host": s.host, "port": s.port,
                 "status_port": s.status_port} for s in specs])
            for j in range(args.routers):
                argv = [sys.executable, "-m", "our_tree_tpu_torch.route.fleet",
                        "--port", "0", "--backends", member_json,
                        "--peer", f"127.0.0.1:{owner_server.port}",
                        "--gossip-every",
                        str(min(args.gossip_every, 0.25)),
                        "--attempt-timeout", str(args.attempt_timeout),
                        "--deadline", str(args.deadline),
                        "--max-frame-bytes", str(max_frame)]
                h = isolate.spawn_service(argv, env=dict(env),
                                          name=f"route:r{j}")
                line = await loop.run_in_executor(
                    None, h.read_line, READY_DEADLINE_S)
                doc = None
                if line:
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        doc = None
                if not (isinstance(doc, dict)
                        and doc.get("kind") == REPLICA_KIND):
                    replicas.append({"name": f"r{j}", "handle": h,
                                     "killed": False})
                    raise RuntimeError(
                        f"router replica r{j} (pid {h.pid}) never came "
                        f"ready (got {line!r})")
                replicas.append({"name": f"r{j}", "handle": h,
                                 "port": int(doc["port"]),
                                 "killed": False})
                print(f"# router replica r{j}: pid {h.pid} "
                      f"port {doc['port']}", file=sys.stderr)
            peers = ([("127.0.0.1", replicas[0]["port"]),
                      ("127.0.0.1", owner_server.port)]
                     + [("127.0.0.1", r["port"]) for r in replicas[1:]])
            client = FailoverClient(
                peers, attempt_timeout_s=args.attempt_timeout,
                deadline_s=args.deadline, max_frame_bytes=max_frame)

        # -- the chaos timeline, next to the supervisor loop.
        stop_ev = asyncio.Event()
        sup_task = asyncio.ensure_future(sup.run(stop_ev))
        t0 = time.monotonic()
        chaos: list[asyncio.Task] = []

        async def arm_faults_later():
            # Armed AFTER the startup canaries (and optionally deep
            # into the drive): the injected fault rehearses the
            # steady-state seams — a stale pooled socket with a live
            # fleet to redispatch into — not the join checks, and not
            # a one-member ring with nowhere to go.
            await asyncio.sleep(args.drive_faults_after)
            os.environ["OT_FAULTS"] = args.drive_faults
            faults.reset()
            print(f"# faults armed at +{time.monotonic() - t0:.1f}s: "
                  f"{args.drive_faults}", file=sys.stderr)

        if args.drive_faults:
            chaos.append(asyncio.ensure_future(arm_faults_later()))

        async def roll_later():
            await asyncio.sleep(args.roll_after)
            ok = await sup.roll_one()
            print(f"# roll at +{time.monotonic() - t0:.1f}s: "
                  f"{'replaced' if ok else 'ABORTED'}", file=sys.stderr)

        async def kill_router_later():
            await asyncio.sleep(args.kill_router_after)
            r = replicas[0]
            r["killed"] = True
            await loop.run_in_executor(None, r["handle"].kill)
            trace.point("router-killed", replica=r["name"],
                        pid=r["handle"].pid)
            print(f"# router {r['name']} SIGKILLed at "
                  f"+{time.monotonic() - t0:.1f}s", file=sys.stderr)

        if args.roll_after is not None:
            chaos.append(asyncio.ensure_future(roll_later()))
        if args.kill_router_after is not None and replicas:
            chaos.append(asyncio.ensure_future(kill_router_later()))

        report = await loadgen.run(
            client, args.requests, concurrency=args.concurrency,
            sizes=args.sizes, tenants=args.tenants,
            keys_per_tenant=args.keys_per_tenant, seed=args.seed,
            verify_every=args.verify_every, probes=probes,
            arrival_rate=args.arrival_rate, modes=args.mode_list)
        for c in await asyncio.gather(*chaos, return_exceptions=True):
            if isinstance(c, BaseException):
                raise c

        # -- the settle window: load has passed, the supervisor keeps
        # ticking against an idle fleet until it has shrunk back to the
        # floor (the deterministic scale-down) or the window closes.
        # A held resize lock counts as "not settled": a queued scale
        # event may still move the size after we read it.
        t_end = time.monotonic() + args.settle_timeout
        while (time.monotonic() < t_end
               and (len(router.backends) > args.backends
                    or sup.resizing)):
            await asyncio.sleep(args.poll_every)
        stop_ev.set()
        await sup_task

        await router.gossip_once()
        healthz = {name: b.last_healthz
                   for name, b in router.backends.items()}
        rstats = router.stats()
        releases = router.release_events()
        fleet_doc = sup.fleetz()

        router_docs = []
        for r in replicas:
            h = r["handle"]
            rc = await loop.run_in_executor(None, h.stop, 30.0)
            out, _err = h.drain_output()
            doc = {}
            for raw in reversed(out.splitlines()):
                try:
                    cand = json.loads(raw)
                except ValueError:
                    continue
                if (isinstance(cand, dict)
                        and cand.get("kind") == REPLICA_EXIT_KIND):
                    doc = cand
                    break
            router_docs.append({"name": r["name"], "rc": rc,
                                "killed": r["killed"], **doc})

        if status is not None:
            await status.stop()
        if owner_server is not None:
            await owner_server.stop()
        await sup.close(drain=True)
        await router.stop()
        # The engine object outlives its thread: fold the router-tier
        # pulse verdict into the result before the router goes out of
        # scope (the fleet drive returns a dict, not the router).
        pulse_doc = _pulse_section(router.pulse)
    except BaseException:
        await _abandon()
        raise

    client_stats = None
    if isinstance(client, FailoverClient):
        client_stats = {"submitted": client.submitted,
                        "failovers": client.failovers,
                        "backpressure_retries": client.backpressure_retries,
                        "peers": len(client.peers)}
    return {"report": report, "router": rstats, "healthz": healthz,
            "releases": releases, "fleet": fleet_doc, "t0": t0,
            "events": list(sup.events), "workers": sup.exit_docs,
            "routers": router_docs, "client": client_stats,
            "pulse": pulse_doc}


def _main_fleet(args, probes) -> int:
    """The ``--autoscale`` tail of ``main``: run the elasticity drive,
    narrate it, write the artifact, apply the fleet gates."""
    res = asyncio.run(_drive_fleet(args, probes))
    report, rstats = res["report"], res["router"]
    fleet, client = res["fleet"], res["client"]
    exit_docs = res["workers"]

    lost_workers = sum(int(d.get("lost") or 0) for d in exit_docs)
    crashed = [d for d in exit_docs if d.get("rc")]
    lost_replicas = sum(int(d.get("lost") or 0) for d in res["routers"]
                        if not d["killed"])
    replica_bad_rc = [d for d in res["routers"]
                      if not d["killed"] and d.get("rc")]
    lost_router = rstats["lost"]
    recompiles = sum(int(d.get("recompiles") or 0) for d in exit_docs)
    waterfall = waterfall_stats(report.ledgers)
    stage_p50 = router_stage_p50s(report.ledgers)
    wire = waterfall["stages"].get("wire") or {}
    # No complete waterfall (the port's workers return no ``lg``): the
    # wire p50 over every sampled ledger, the worker's residency inside.
    wire_p50 = wire["p50_us"] if wire.get("count") else stage_p50["wire"]
    pool = dict(rstats.get("pool_retired")
                or {"hits": 0, "dials": 0, "stale": 0})
    for b in rstats["backends"].values():
        for k in pool:
            pool[k] += int((b.get("pool") or {}).get(k, 0))

    print(f"# fleet: floor={args.backends} max={args.fleet_max} "
          f"policy={args.fleet_policy} "
          f"up_depth={args.up_depth:g} down_depth={args.down_depth:g} "
          f"cooldown={args.cooldown:g}s routers={args.routers}")
    print(f"# requests={report.requests} ok={report.ok} "
          f"errors={report.errors or '{}'} lost_router={lost_router} "
          f"lost_replicas={lost_replicas} lost_workers={lost_workers} "
          f"verified={report.verified} mismatches={report.mismatches}")
    print(f"# latency ms: p50={report.p50_ms} p95={report.p95_ms} "
          f"p99={report.p99_ms}  goodput={report.goodput_gbps:.4f} GB/s "
          f"wall={report.wall_s:.3f}s")
    print(f"# elasticity: ups={fleet['scale_ups']} "
          f"downs={fleet['scale_downs']} rolled={fleet['rolled']} "
          f"roll_aborts={fleet['roll_aborts']} stalls={fleet['stalls']} "
          f"spawn_failures={fleet['spawn_failures']} "
          f"drained_lost={fleet['drained_lost']}")
    for ev in res["events"]:
        print(f"#   event {ev['kind']:<12} worker={ev['worker'] or '-'} "
              f"size={ev['size']} epoch={ev['epoch']} "
              f"at +{ev['t_s'] - res['t0']:.1f}s"
              + (f" successor={ev['successor']}"
                 if "successor" in ev else ""))
    for d in exit_docs:
        spawned = d.get("spawned_at")
        print(f"#   worker {d.get('name')}: spawned "
              + (f"+{spawned - res['t0']:.1f}s" if spawned is not None
                 else "-")
              + f" ready_s={d.get('ready_s')} lost={d.get('lost')} "
              f"rc={d.get('rc')} engine_calls={d.get('diag_engine_calls')} "
              f"launches={d.get('diag_launches')}")
    if client is not None:
        print(f"# router tier: peers={client['peers']} "
              f"client_failovers={client['failovers']} "
              f"backpressure_retries={client['backpressure_retries']} "
              + " ".join(f"{d['name']}:"
                         f"{'KILLED' if d['killed'] else d.get('rc')}"
                         f"/lost={d.get('lost')}"
                         for d in res["routers"]))
    print(f"# pool: hits={pool['hits']} dials={pool['dials']} "
          f"stale={pool['stale']}  wire_p50={wire_p50}µs  "
          f"redispatches={rstats['redispatches']}")
    if waterfall["sampled"]:
        print(f"# router stages: router_queue p50="
              f"{stage_p50['router_queue']}µs wire p50={stage_p50['wire']}µs "
              f"(n={stage_p50['n']} sampled)")
        print(f"# waterfall: {waterfall['complete']}/"
              f"{waterfall['sampled']} sampled requests complete "
              f"({waterfall['complete_frac']:.1%}), stage sum within "
              f"{waterfall['tolerance']:.0%} of e2e on "
              f"{waterfall['sum_within_tol_frac']:.1%} of them")
        for s in WATERFALL_STAGES:
            st = waterfall["stages"].get(s)
            if st and st["count"]:
                print(f"#   stage {s:<13} p50={st['p50_us']:>8.0f}µs "
                      f"p95={st['p95_us']:>8.0f}µs "
                      f"p99={st['p99_us']:>8.0f}µs  (n={st['count']})")
    pulse_doc = res["pulse"]
    capacity = _fleet_capacity(res["healthz"])
    if pulse_doc is not None:
        fired = (" ".join(f"{r}x{n}"
                          for r, n in pulse_doc["fired"].items())
                 or "none")
        print(f"# pulse: {pulse_doc['total']} alert(s) over "
              f"{pulse_doc['frames']} frame(s) (fired: {fired})")
    if capacity is not None:
        print(f"# capacity: fleet "
              f"{capacity['total_blocks_per_s']:g} blocks/s across "
              f"{len(capacity['backends'])} worker(s)")

    artifact = {
        "config": {
            "backends": args.backends, "requests": args.requests,
            "concurrency": args.concurrency, "sizes": list(args.sizes),
            "tenants": args.tenants,
            "keys_per_tenant": args.keys_per_tenant,
            "device": args.device,
            "engine": args.engine, "vnodes": args.vnodes,
            "modes": list(args.mode_list),
            "affinity": True, "ab": False, "autoscale": True,
            "attempt_timeout_s": args.attempt_timeout,
            "gossip_every_s": args.gossip_every,
            "worker_lanes": args.worker_lanes,
            "arrival_rate": args.arrival_rate,
            "seed": args.seed,
            "fleet": {"max_workers": args.fleet_max,
                      "policy": args.fleet_policy,
                      "headroom_frac": args.headroom_frac,
                      "up_depth": args.up_depth,
                      "down_depth": args.down_depth,
                      "up_busy": args.up_busy,
                      "settle_ticks": args.settle_ticks,
                      "down_settle_ticks": args.down_settle_ticks,
                      "cooldown_s": args.cooldown,
                      "poll_every_s": args.poll_every,
                      "roll_after_s": args.roll_after,
                      "routers": args.routers,
                      "kill_router_after_s": args.kill_router_after,
                      "drive_faults": args.drive_faults,
                      "drive_faults_after_s": args.drive_faults_after},
        },
        "load": report.to_json(),
        "router": rstats,
        "queue": {"lost": lost_router + lost_replicas + lost_workers,
                  "lost_router": lost_router,
                  "lost_replicas": lost_replicas,
                  "lost_workers": lost_workers},
        "compiles": {"steady": recompiles},
        "workers": exit_docs,
        "fleet": {**fleet, "events": res["events"]},
        "routers": {"count": args.routers, "docs": res["routers"],
                    "client": client},
        "pool": {**pool, "wire_p50_us": wire_p50},
        "waterfall": waterfall,
        "stages": waterfall["stages"],
        "healthz": res["healthz"],
        "alerts": pulse_doc,
        "capacity": capacity,
        "degraded": degrade.events(),
        "metrics": metrics.snapshot(),
    }
    if trace.enabled():
        artifact["obs"] = trace.metrics_snapshot()
        artifact["trace_sample"] = trace.sample_rate()
    _write_artifact(args.artifact, artifact)

    slo_rc = 0
    if args.slo:
        try:
            slo_rc = slo.gate(args.slo, artifact, args.slo_tolerance)
        except (OSError, ValueError, KeyError) as e:
            print(f"# slo: gate unusable: {e}", file=sys.stderr)
            slo_rc = 1

    line = {"unit": "route-fleet", "backends": args.backends,
            "requests": report.requests, "ok": report.ok,
            "errors": dict(sorted(report.errors.items())),
            "lost": lost_router + lost_replicas + lost_workers,
            "p50_ms": report.p50_ms, "p95_ms": report.p95_ms,
            "p99_ms": report.p99_ms,
            "goodput_gbps": round(report.goodput_gbps, 4),
            "scale_ups": fleet["scale_ups"],
            "scale_downs": fleet["scale_downs"],
            "rolled": fleet["rolled"],
            "roll_aborts": fleet["roll_aborts"],
            "client_failovers": (client or {}).get("failovers", 0),
            "redispatches": rstats["redispatches"],
            "recompiles": recompiles,
            "mismatches": report.mismatches,
            "pool_hits": pool["hits"], "wire_p50_us": wire_p50,
            "waterfall_complete_frac": waterfall["complete_frac"],
            "waterfall_sum_ok_frac": waterfall["sum_within_tol_frac"],
            "router_cuda_initialized": router_cuda_initialized()}
    if args.slo:
        line["slo"] = "fail" if slo_rc else "pass"
    if degrade.events():
        line["degraded"] = degrade.events()
    if pulse_doc is not None and pulse_doc["total"]:
        line["alerts"] = pulse_doc["fired"]
    print(json.dumps(line))

    rc = 0
    if report.mismatches:
        print(f"# FAIL: {report.mismatches} probe response(s) mismatched "
              "the byte-exact reference THROUGH the elastic fleet",
              file=sys.stderr)
        rc = 1
    if lost_router or lost_replicas or lost_workers:
        print(f"# FAIL: lost requests (router={lost_router}, "
              f"replicas={lost_replicas}, workers={lost_workers}) — the "
              "drain/failover contract is broken", file=sys.stderr)
        rc = 1
    if crashed:
        print(f"# FAIL: worker(s) exited nonzero: "
              + ", ".join(f"{d['name']}:rc={d['rc']}" for d in crashed),
              file=sys.stderr)
        rc = 1
    if replica_bad_rc:
        print(f"# FAIL: surviving router replica(s) exited nonzero: "
              + ", ".join(f"{d['name']}:rc={d['rc']}"
                          for d in replica_bad_rc), file=sys.stderr)
        rc = 1
    if recompiles and not args.allow_recompiles:
        print(f"# FAIL: {recompiles} post-warmup backend compile(s) "
              "across the fleet (--allow-recompiles to waive)",
              file=sys.stderr)
        rc = 1
    if args.require_zero_errors and report.errors:
        print(f"# FAIL: request errors {report.errors} — failover did "
              "not absorb the churn", file=sys.stderr)
        rc = 1
    if (args.min_scale_ups is not None
            and fleet["scale_ups"] < args.min_scale_ups):
        print(f"# FAIL: {fleet['scale_ups']} scale-up(s) < "
              f"{args.min_scale_ups} — the autoscaler never grew the "
              "fleet", file=sys.stderr)
        rc = 1
    if (args.min_scale_downs is not None
            and fleet["scale_downs"] < args.min_scale_downs):
        print(f"# FAIL: {fleet['scale_downs']} scale-down(s) < "
              f"{args.min_scale_downs} — the fleet never shrank back",
              file=sys.stderr)
        rc = 1
    if args.expect_rolls is not None:
        if fleet["rolled"] != args.expect_rolls:
            print(f"# FAIL: {fleet['rolled']} rolled worker(s), expected "
                  f"exactly {args.expect_rolls}", file=sys.stderr)
            rc = 1
        if fleet["roll_aborts"]:
            print(f"# FAIL: {fleet['roll_aborts']} roll abort(s) — the "
                  "canary handoff rejected a successor", file=sys.stderr)
            rc = 1
    if (args.min_client_failovers is not None
            and (client or {}).get("failovers", 0)
            < args.min_client_failovers):
        print(f"# FAIL: {(client or {}).get('failovers', 0)} client "
              f"failover(s) < {args.min_client_failovers} — the router "
              "kill never exercised the tier", file=sys.stderr)
        rc = 1
    if (args.min_redispatch is not None
            and rstats["redispatches"] < args.min_redispatch):
        print(f"# FAIL: redispatches {rstats['redispatches']} < "
              f"{args.min_redispatch} — the injected pool fault never "
              "rode the ring-retry failover", file=sys.stderr)
        rc = 1
    if args.max_wire_p50_us is not None:
        if wire_p50 is None or wire_p50 > args.max_wire_p50_us:
            print(f"# FAIL: wire stage p50 {wire_p50}µs not under "
                  f"{args.max_wire_p50_us:g}µs — pooling bought nothing",
                  file=sys.stderr)
            rc = 1
    if (args.min_waterfall_complete is not None
            and waterfall["complete_frac"] < args.min_waterfall_complete):
        print(f"# FAIL: only {waterfall['complete_frac']:.1%} of sampled "
              f"requests reconstructed a complete cross-process "
              f"waterfall (< {args.min_waterfall_complete:.1%})",
              file=sys.stderr)
        rc = 1
    if (args.min_stage_sum_ok is not None
            and waterfall["sum_within_tol_frac"] < args.min_stage_sum_ok):
        print(f"# FAIL: stage sums match end-to-end latency on only "
              f"{waterfall['sum_within_tol_frac']:.1%} of complete "
              f"waterfalls (< {args.min_stage_sum_ok:.1%})",
              file=sys.stderr)
        rc = 1
    if slo_rc:
        print(f"# FAIL: SLO regression against {args.slo}",
              file=sys.stderr)
        rc = 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m our_tree_tpu_torch.route.bench",
        description="routing-tier drive over N spawned ot-serve backend "
                    "processes (docs/SERVING.md)")
    ap.add_argument("--backends", type=int, default=3, metavar="N")
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--arrival-rate", type=float, default=None,
                    metavar="REQ_PER_S",
                    help="open-loop mode (serve.bench semantics)")
    ap.add_argument("--mixed-sizes", action="store_true")
    ap.add_argument("--sizes", default=None, metavar="B1,B2",
                    help="explicit request-size menu in bytes (comma "
                         "list; overrides --mixed-sizes/--size-bytes). "
                         "A gcm mix wants the top size one rung under "
                         "the bucket ceiling: the J0 row rides each "
                         "request (serve.bench's sizing note)")
    ap.add_argument("--size-bytes", type=int, default=4096)
    ap.add_argument("--modes", default="ctr", metavar="M1,M2",
                    help="served-mode MIX routed through the fleet "
                         "(serve/queue.py MODES): every worker enables "
                         "and warms exactly these ladders, the loadgen "
                         "draws each request's mode uniformly, and gcm "
                         "probes pin ciphertext AND tag bit-exactly "
                         "THROUGH the router (affinity + failover "
                         "included — docs/SERVING.md, AEAD section)")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--keys-per-tenant", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="each worker's --device: cuda (the kernels; a "
                         "worker that cannot come ready on the card fails "
                         "the drive) or cpu (the plain versions)")
    ap.add_argument("--engine", default="auto",
                    help="backend serve engine tier (serve.worker "
                         "--engine; auto = the kernels on a card, the "
                         "native C tier on the CPU)")
    ap.add_argument("--worker-lanes", type=int, default=None, metavar="N")
    ap.add_argument("--worker-queue-depth", type=int, default=1024)
    ap.add_argument("--tenant-depth-frac", type=float, default=1.0,
                    metavar="FRAC")
    ap.add_argument("--bucket-min", type=int, default=32, metavar="BLOCKS")
    ap.add_argument("--bucket-max", type=int, default=4096,
                    metavar="BLOCKS")
    ap.add_argument("--deadline", type=float, default=30.0,
                    help="per-request end-to-end Budget, seconds")
    ap.add_argument("--attempt-timeout", type=float, default=5.0,
                    metavar="S",
                    help="wall deadline per backend attempt — the bound "
                         "that turns a hung backend into failover")
    ap.add_argument("--dispatch-deadline", type=float, default=10.0,
                    help="each BACKEND's per-lane watchdog deadline")
    ap.add_argument("--gossip-every", type=float, default=1.0, metavar="S")
    ap.add_argument("--probation-batches", type=int, default=2)
    ap.add_argument("--vnodes", type=int, default=64)
    ap.add_argument("--no-affinity", action="store_true",
                    help="random routing only (the control arm alone)")
    ap.add_argument("--ab", action="store_true",
                    help="run BOTH arms over fresh backend sets and "
                         "record the keycache hit-ratio comparison")
    ap.add_argument("--min-affinity-gain", type=float, default=None,
                    metavar="FRAC",
                    help="with --ab: fail unless affinity hit ratio "
                         "exceeds the random arm's by more than FRAC "
                         "(default 0: strictly greater)")
    ap.add_argument("--verify-every", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="router journal (backend quarantine "
                         "persistence; docs/RESILIENCE.md)")
    ap.add_argument("--unquarantine", action="append", default=None,
                    metavar="BACKEND",
                    help="release the named backend (e.g. backend:b1) by "
                         "dropping its failure rows from --journal, then "
                         "exit — the same clear_failures edit as "
                         "harness.bench/serve.bench")
    ap.add_argument("--status-port", type=int, default=None, metavar="PORT",
                    help="router /metrics + /healthz (with the "
                         "ring/backend membership view) for the drive's "
                         "duration (0 = ephemeral). /metrics is the "
                         "FEDERATED fleet scrape by default: the "
                         "router's registry plus every backend's, "
                         "relabeled backend=<name> (docs/SERVING.md)")
    ap.add_argument("--no-federate", action="store_true",
                    help="serve only the router's own /metrics (no "
                         "backend federation)")
    ap.add_argument("--min-waterfall-complete", type=float, default=None,
                    metavar="FRAC",
                    help="fail unless at least FRAC of the sampled "
                         "requests reconstructed a COMPLETE cross-"
                         "process waterfall (router + backend ledger "
                         "halves, every stage present)")
    ap.add_argument("--min-stage-sum-ok", type=float, default=None,
                    metavar="FRAC",
                    help="fail unless at least FRAC of the complete "
                         "waterfalls have a stage sum within 5%% of the "
                         "measured end-to-end latency (the attribution "
                         "consistency gate)")
    ap.add_argument("--slo", default=None, metavar="BASELINE.json",
                    help="gate this run against a baseline artifact "
                         "written by --artifact (obs/slo.py)")
    ap.add_argument("--slo-tolerance", default=None, metavar="SPEC")
    ap.add_argument("--artifact", default=None, metavar="PATH",
                    help="write the run's JSON artifact here (nothing is "
                         "written without it)")
    ap.add_argument("--allow-recompiles", action="store_true")
    ap.add_argument("--require-zero-errors", action="store_true",
                    help="fail on ANY per-request error response (the "
                         "backend-kill drive's 0-errors gate: failover "
                         "must absorb the fault)")
    ap.add_argument("--expect-quarantines", type=int, default=None,
                    metavar="N",
                    help="fail unless the run saw exactly N backend "
                         "quarantine events")
    ap.add_argument("--expect-releases", type=int, default=None,
                    metavar="N",
                    help="fail unless exactly N probation releases "
                         "completed")
    ap.add_argument("--min-redispatch", type=int, default=None, metavar="N",
                    help="fail unless redispatches >= N (the failover "
                         "actually happened)")
    st = ap.add_argument_group(
        "streaming transfers (ot-stream; docs/SERVING.md)")
    st.add_argument("--transfer-sizes", default=None, metavar="B1,B2",
                    help="oversized payload menu in bytes (comma list, "
                         "each a multiple of 16 ABOVE the top "
                         "--bucket-max rung): enables router-side "
                         "chunked transfers sized to this fleet's "
                         "ladder and mixes one ALWAYS-verified "
                         "transfer into the load every "
                         "--transfer-every requests")
    st.add_argument("--transfer-every", type=int, default=32,
                    metavar="N",
                    help="issue a transfer probe every N requests "
                         "(default 32)")
    st.add_argument("--transfer-deadline", type=float, default=300.0,
                    metavar="S",
                    help="per-TRANSFER end-to-end Budget, seconds "
                         "(each chunk dispatch gets the remainder)")
    st.add_argument("--transfer-ledger", default=None, metavar="PATH",
                    help="durable acked-chunk ledger (the resume "
                         "contract; docs/RESILIENCE.md)")
    st.add_argument("--kill-backend-after", type=float, default=None,
                    metavar="S",
                    help="SIGKILL the LAST backend this many seconds "
                         "in — mid-transfer chunks must fail over "
                         "bit-exactly; the victim's rc is exempt from "
                         "the drain gate")
    st.add_argument("--worker-faults", default=None, metavar="SPEC",
                    help="OT_FAULTS spec armed in worker b0 ONLY "
                         "(e.g. lane_hang:1 — the hung-lane half of "
                         "the mid-transfer chaos drive; the spawner "
                         "still strips the ROUTER's spec from every "
                         "worker)")
    st.add_argument("--resume-drill", action="store_true",
                    help="after the load: interrupt one transfer with "
                         "a transfer_abort shot, resume it by token, "
                         "and gate byte-identity + only-unacked-chunks"
                         "-resent")
    st.add_argument("--min-chunk-redispatch", type=int, default=None,
                    metavar="N",
                    help="fail unless the transfer engine re-sent at "
                         "least N chunks (chunk_lost discards + shed "
                         "retries)")
    fl = ap.add_argument_group(
        "fleet elasticity (--autoscale; docs/SERVING.md)")
    fl.add_argument("--autoscale", action="store_true",
                    help="hand the worker fleet to the FleetSupervisor: "
                         "--backends is the floor, the drive scales up "
                         "under pressure and drains back down once load "
                         "passes (route/fleet.py)")
    fl.add_argument("--fleet-max", type=int, default=4, metavar="N",
                    help="autoscaler ceiling (default 4)")
    fl.add_argument("--fleet-policy", choices=("static", "headroom"),
                    default="static",
                    help="grow policy: 'static' keeps the depth/busy "
                         "thresholds alone; 'headroom' ALSO grows when "
                         "measured offered load reaches --headroom-frac "
                         "of the fleet's live capacity estimate (the "
                         "workers' pulse engines publish blocks/s on "
                         "/healthz; route/fleet.py folds them)")
    fl.add_argument("--headroom-frac", type=float, default=0.80,
                    metavar="FRAC",
                    help="offered/capacity ratio that triggers headroom "
                         "growth (default 0.8)")
    fl.add_argument("--up-depth", type=float, default=8.0, metavar="D",
                    help="mean queue depth per worker that triggers a "
                         "scale-up (default 8)")
    fl.add_argument("--down-depth", type=float, default=1.0, metavar="D",
                    help="mean depth the fleet must idle UNDER before a "
                         "scale-down (default 1)")
    fl.add_argument("--up-busy", type=float, default=0.95, metavar="FRAC",
                    help="lane-busy fraction that also triggers growth")
    fl.add_argument("--settle-ticks", type=int, default=2, metavar="N",
                    help="consecutive out-of-band polls before a scale "
                         "event (hysteresis; default 2)")
    fl.add_argument("--down-settle-ticks", type=int, default=None,
                    metavar="N",
                    help="separate (usually much larger) settle count "
                         "for shrinking: pressure is bursty, idleness "
                         "must be sustained (default: --settle-ticks)")
    fl.add_argument("--cooldown", type=float, default=3.0, metavar="S",
                    help="minimum seconds between fleet resizes")
    fl.add_argument("--poll-every", type=float, default=0.25, metavar="S",
                    help="supervisor poll period")
    fl.add_argument("--roll-after", type=float, default=None, metavar="S",
                    help="start a rolling upgrade of ONE worker this many "
                         "seconds into the drive (bit-exact canary "
                         "handoff — the successor must answer the join "
                         "canaries byte-for-byte or the roll aborts)")
    fl.add_argument("--routers", type=int, default=0, metavar="N",
                    help="spawn N replicated router processes "
                         "(route.fleet replicas) gossiping with the "
                         "in-process owner; the loadgen drives the tier "
                         "through the failover client")
    fl.add_argument("--kill-router-after", type=float, default=None,
                    metavar="S",
                    help="SIGKILL replica r0 this many seconds in — the "
                         "failover client must carry every in-flight and "
                         "subsequent request to the surviving peers")
    fl.add_argument("--drive-faults", default=None, metavar="SPEC",
                    help="OT_FAULTS spec armed AFTER router start + "
                         "startup canaries (so join checks never absorb "
                         "the shots), e.g. pool_stale:1@backend=0")
    fl.add_argument("--drive-faults-after", type=float, default=0.0,
                    metavar="S",
                    help="arm --drive-faults this many seconds into the "
                         "drive (late enough that the fleet has already "
                         "scaled up: a stale-socket redispatch needs a "
                         "second member to land on)")
    fl.add_argument("--settle-timeout", type=float, default=30.0,
                    metavar="S",
                    help="post-load window for the fleet to drain back "
                         "to the floor before the drive stops waiting")
    fl.add_argument("--min-scale-ups", type=int, default=None, metavar="N",
                    help="fail unless the autoscaler grew the fleet at "
                         "least N times")
    fl.add_argument("--min-scale-downs", type=int, default=None,
                    metavar="N",
                    help="fail unless the fleet shrank at least N times")
    fl.add_argument("--expect-rolls", type=int, default=None, metavar="N",
                    help="fail unless exactly N workers rolled AND no "
                         "roll aborted")
    fl.add_argument("--min-client-failovers", type=int, default=None,
                    metavar="N",
                    help="fail unless the failover client rerouted at "
                         "least N times (the router kill was felt)")
    fl.add_argument("--max-wire-p50-us", type=float, default=None,
                    metavar="US",
                    help="fail unless the wire stage p50 lands under US "
                         "microseconds (the pooled-connection gate)")
    args = ap.parse_args(argv)
    if args.autoscale:
        if args.ab:
            ap.error("--autoscale owns the worker fleet for one live "
                     "drive; --ab wants two disposable fleets — run the "
                     "A/B without the supervisor")
        if args.no_affinity:
            ap.error("--autoscale drives the affinity ring (rendezvous "
                     "handoff across resizes is the point)")
        if args.fleet_max < args.backends:
            ap.error(f"--fleet-max {args.fleet_max} < --backends "
                     f"{args.backends} (the floor)")
        if args.kill_router_after is not None and args.routers < 1:
            ap.error("--kill-router-after needs --routers >= 1")
    elif (args.roll_after is not None or args.routers
          or args.kill_router_after is not None or args.drive_faults
          or args.fleet_policy != "static"
          or args.min_scale_ups is not None
          or args.min_scale_downs is not None
          or args.expect_rolls is not None
          or args.min_client_failovers is not None):
        ap.error("fleet-elasticity flags require --autoscale")
    if args.autoscale and (args.transfer_sizes or args.resume_drill
                           or args.kill_backend_after is not None
                           or args.worker_faults):
        ap.error("streaming-transfer flags drive the plain (non-"
                 "autoscale) path; --autoscale owns its own chaos "
                 "schedule")
    if args.ab and args.no_affinity:
        ap.error("--ab compares affinity AGAINST random routing; with "
                 "--no-affinity both arms would be random and the "
                 "affinity-gain gate could only report a false verdict")
    if args.sizes:
        try:
            args.sizes = tuple(int(s) for s in args.sizes.split(",") if s)
        except ValueError:
            ap.error(f"--sizes wants a comma list of byte counts, "
                     f"got {args.sizes!r}")
    else:
        args.sizes = (loadgen.MIXED_SIZES if args.mixed_sizes
                      else (args.size_bytes,))
    if args.transfer_sizes:
        try:
            args.transfer_sizes = tuple(
                int(s) for s in args.transfer_sizes.split(",") if s)
        except ValueError:
            ap.error(f"--transfer-sizes wants a comma list of byte "
                     f"counts, got {args.transfer_sizes!r}")
        rung = args.bucket_max * 16
        for b in args.transfer_sizes:
            if b % 16 or b <= rung:
                ap.error(f"--transfer-sizes entries must be multiples "
                         f"of 16 ABOVE the top rung ({rung} bytes) — "
                         f"anything under it is an ordinary request; "
                         f"got {b}")
        if args.transfer_every <= 0:
            ap.error("--transfer-sizes needs --transfer-every > 0")
    else:
        args.transfer_sizes = ()
        if args.resume_drill or args.min_chunk_redispatch is not None:
            ap.error("--resume-drill/--min-chunk-redispatch need "
                     "--transfer-sizes (nothing would chunk)")
    args.mode_list = tuple(m.strip() for m in args.modes.split(",")
                           if m.strip()) or ("ctr",)
    if "gcm-open" in args.mode_list and not args.verify_every:
        ap.error("--modes gcm-open requires --verify-every > 0: open "
                 "traffic replays the per-size sealed probe pairs "
                 "(serve.bench's contract, one tier up)")

    if args.unquarantine:
        if not args.journal:
            ap.error("--unquarantine requires --journal "
                     "(the ledger being edited)")
        trace.ensure_run()
        cleared = journal_mod.clear_failures(args.journal,
                                             args.unquarantine)
        for unit, n in sorted(cleared.items()):
            if n:
                trace.point("quarantine-release", unit=unit, cleared=n)
            print(f"# unquarantine: {unit}: cleared {n} failure row(s)"
                  + ("" if n else " (none recorded)"))
        return 0

    trace.ensure_run()
    probes = (loadgen.make_probes(args.sizes, args.seed, args.mode_list)
              if args.verify_every else [])

    if args.autoscale:
        return _main_fleet(args, probes)

    affinity = not args.no_affinity
    handles, specs, ready = _spawn_backends(args, "route")
    killed = ({len(handles) - 1}
              if args.kill_backend_after is not None else frozenset())
    try:
        router, report, healthz, resume = asyncio.run(
            _drive(args, specs, affinity, probes,
                   handles=handles, drill=args.resume_drill))
    except BaseException:
        _teardown(handles, killed=killed)
        raise
    exit_docs, worker_rc = _teardown(handles, killed=killed, ready=ready)

    control = None
    if args.ab:
        # The control arm: fresh backends (cold keycaches — the A/B is
        # meaningless over warm ones), same seed, random routing.
        c_handles, c_specs, c_ready = _spawn_backends(args, "route-ctl")
        try:
            c_router, c_report, _, _ = asyncio.run(
                _drive(args, c_specs, False, probes))
        except BaseException:
            _teardown(c_handles)
            raise
        c_exit_docs, c_rc = _teardown(c_handles, ready=c_ready)
        worker_rc = worker_rc or c_rc
        control = {
            "load": c_report.to_json(),
            "router": c_router.stats(),
            "keycache_hit_ratio": _keycache_ratio(c_exit_docs),
            "workers": c_exit_docs,
        }

    rstats = router.stats()
    lost_router = rstats["lost"]
    lost_workers = sum(d.get("lost", 0) for d in exit_docs)
    recompiles = sum(d.get("recompiles", 0) for d in exit_docs)
    backend_quarantines = sum(d.get("quarantines", 0) for d in exit_docs)
    kc_ratio = _keycache_ratio(exit_docs)
    releases = router.release_events()
    waterfall = waterfall_stats(report.ledgers)
    stage_p50 = router_stage_p50s(report.ledgers)
    pulse_doc = _pulse_section(router.pulse)
    capacity = _fleet_capacity(healthz)

    print(f"# route: backends={args.backends} affinity={affinity} "
          f"vnodes={args.vnodes} tenants={args.tenants} "
          f"attempt_timeout={args.attempt_timeout:g}s "
          f"gossip={args.gossip_every:g}s")
    print(f"# requests={report.requests} ok={report.ok} "
          f"errors={report.errors or '{}'} lost_router={lost_router} "
          f"lost_workers={lost_workers} verified={report.verified} "
          f"mismatches={report.mismatches}")
    print(f"# latency ms: p50={report.p50_ms} p95={report.p95_ms} "
          f"p99={report.p99_ms}  goodput={report.goodput_gbps:.4f} GB/s "
          f"wall={report.wall_s:.3f}s")
    print(f"# failover: redispatches={rstats['redispatches']} "
          f"quarantines={rstats['quarantine_events']} releases={releases} "
          f"shed_retries={rstats['shed_retries']} "
          f"router_sheds={rstats['router_sheds']}")
    tstats = rstats.get("transfers")
    if tstats:
        print(f"# transfers: started={tstats['started']} "
              f"completed={tstats['completed']} "
              f"resumed={tstats['resumed']} "
              f"aborted={tstats['aborted']} shed={tstats['shed']} "
              f"chunks_sent={tstats['chunks_sent']} "
              f"chunk_redispatches={tstats['chunk_redispatches']} "
              f"held_peak={tstats['held_peak_bytes']}B")
    print(f"# affinity: ratio={rstats['affinity']['ratio']:.4f} "
          f"(hits={rstats['affinity']['hits']} "
          f"misses={rstats['affinity']['misses']}) "
          f"backend_keycache_hit_ratio={kc_ratio:.4f}"
          + (f" vs random={control['keycache_hit_ratio']:.4f}"
             if control else ""))
    for name, b in sorted(rstats["backends"].items()):
        tr = "".join(f" [{t['prev']}->{t['to']}:{t['why']}]"
                     for t in b["transitions"])
        skew = (f" skew={b['skew_us']:+d}µs"
                if b.get("skew_us") is not None else "")
        print(f"#   backend {name} ({b['addr']}): "
              f"{b['dispatches']} dispatch(es), {b['bytes']} bytes, "
              f"state={b['state']}{skew}{tr}")
    for i, d in enumerate(exit_docs):
        print(f"#   worker b{i}: ready_s={d.get('ready_s')} "
              f"lost={d.get('lost')} rc={d.get('rc')} "
              f"engine_calls={d.get('diag_engine_calls')} "
              f"launches={d.get('diag_launches')}")
    cuda_init = router_cuda_initialized()
    print(f"# router process: torch.cuda.is_initialized()={cuda_init}"
          + (" (torch not imported)" if cuda_init is None else ""))
    if waterfall["sampled"]:
        print(f"# router stages: router_queue p50="
              f"{stage_p50['router_queue']}µs wire p50={stage_p50['wire']}µs "
              f"(n={stage_p50['n']} sampled)")
        print(f"# waterfall: {waterfall['complete']}/"
              f"{waterfall['sampled']} sampled requests complete "
              f"({waterfall['complete_frac']:.1%}), stage sum within "
              f"{waterfall['tolerance']:.0%} of e2e on "
              f"{waterfall['sum_within_tol_frac']:.1%} of them")
        for s in WATERFALL_STAGES:
            st = waterfall["stages"].get(s)
            if st and st["count"]:
                print(f"#   stage {s:<13} p50={st['p50_us']:>8.0f}µs "
                      f"p95={st['p95_us']:>8.0f}µs "
                      f"p99={st['p99_us']:>8.0f}µs  (n={st['count']})")
    if pulse_doc is not None:
        fired = (" ".join(f"{r}x{n}"
                          for r, n in pulse_doc["fired"].items())
                 or "none")
        print(f"# pulse: {pulse_doc['total']} alert(s) over "
              f"{pulse_doc['frames']} frame(s) (fired: {fired})")
    if capacity is not None:
        print(f"# capacity: fleet "
              f"{capacity['total_blocks_per_s']:g} blocks/s across "
              f"{len(capacity['backends'])} worker(s)")

    artifact = {
        "config": {
            "backends": args.backends, "requests": args.requests,
            "concurrency": args.concurrency, "sizes": list(args.sizes),
            "tenants": args.tenants,
            "keys_per_tenant": args.keys_per_tenant,
            "device": args.device,
            "engine": args.engine, "vnodes": args.vnodes,
            "modes": list(args.mode_list),
            "affinity": affinity, "ab": bool(args.ab),
            "attempt_timeout_s": args.attempt_timeout,
            "gossip_every_s": args.gossip_every,
            "worker_lanes": args.worker_lanes,
            "seed": args.seed,
        },
        "load": report.to_json(),
        "router": rstats,
        "queue": {"lost": lost_router + lost_workers,
                  "lost_router": lost_router,
                  "lost_workers": lost_workers},
        "compiles": {"steady": recompiles},
        "workers": exit_docs,
        "backend_quarantines_internal": backend_quarantines,
        "affinity_ab": {
            "affinity_keycache_hit_ratio": kc_ratio,
            "random_keycache_hit_ratio": (
                control["keycache_hit_ratio"] if control else None),
        },
        # The cross-process time-attribution waterfall (sampled ledger
        # population) and its per-stage percentiles — the SLO gate's
        # "stages" section, so a regression names which stage moved.
        "waterfall": waterfall,
        "stages": waterfall["stages"],
        "control": control,
        "healthz": healthz,
        "alerts": pulse_doc,
        "capacity": capacity,
        "degraded": degrade.events(),
        "metrics": metrics.snapshot(),
    }
    if tstats:
        artifact["transfers"] = {
            "chunk_blocks": args.bucket_max,
            "sizes": list(args.transfer_sizes),
            "every": args.transfer_every,
            "router": tstats,
            "load": dict(report.transfers),
        }
    if resume is not None:
        artifact["resume"] = resume
    if args.kill_backend_after is not None:
        artifact["config"]["kill_backend_after_s"] = \
            args.kill_backend_after
        artifact["killed_backend"] = f"b{args.backends - 1}"
    if args.worker_faults:
        artifact["config"]["worker_faults"] = args.worker_faults
    if trace.enabled():
        artifact["obs"] = trace.metrics_snapshot()
        artifact["trace_sample"] = trace.sample_rate()
    _write_artifact(args.artifact, artifact)

    slo_rc = 0
    if args.slo:
        try:
            slo_rc = slo.gate(args.slo, artifact, args.slo_tolerance)
        except (OSError, ValueError, KeyError) as e:
            print(f"# slo: gate unusable: {e}", file=sys.stderr)
            slo_rc = 1

    line = {"unit": "route", "backends": args.backends,
            "affinity": affinity,
            "requests": report.requests, "ok": report.ok,
            "errors": dict(sorted(report.errors.items())),
            "lost": lost_router + lost_workers,
            "p50_ms": report.p50_ms, "p95_ms": report.p95_ms,
            "p99_ms": report.p99_ms,
            "goodput_gbps": round(report.goodput_gbps, 4),
            "redispatches": rstats["redispatches"],
            "quarantines": rstats["quarantine_events"],
            "releases": releases,
            "recompiles": recompiles,
            "mismatches": report.mismatches,
            "affinity_ratio": rstats["affinity"]["ratio"],
            "keycache_hit_ratio": kc_ratio,
            "waterfall_complete_frac": waterfall["complete_frac"],
            "waterfall_sum_ok_frac": waterfall["sum_within_tol_frac"],
            "stage_p50_us": {s: stage_p50[s]
                             for s in ("router_queue", "wire")},
            "ready_s": [d.get("ready_s") for d in exit_docs],
            "router_cuda_initialized": cuda_init}
    if control:
        line["keycache_hit_ratio_random"] = control["keycache_hit_ratio"]
    if tstats:
        line["transfers"] = dict(report.transfers)
        line["chunk_redispatches"] = tstats["chunk_redispatches"]
    if resume is not None:
        line["resume"] = ("pass" if resume["interrupted"]
                          and resume["completed"]
                          and resume["byte_identical"]
                          and resume["resent_only_unacked"] else "fail")
    if args.slo:
        line["slo"] = "fail" if slo_rc else "pass"
    if degrade.events():
        line["degraded"] = degrade.events()
    if pulse_doc is not None and pulse_doc["total"]:
        line["alerts"] = pulse_doc["fired"]
    print(json.dumps(line))

    rc = 0
    if report.mismatches:
        print(f"# FAIL: {report.mismatches} probe response(s) mismatched "
              "the byte-exact reference THROUGH the router",
              file=sys.stderr)
        rc = 1
    if lost_router or lost_workers:
        print(f"# FAIL: lost requests (router={lost_router}, "
              f"workers={lost_workers}) — the drain/failover contract is "
              "broken", file=sys.stderr)
        rc = 1
    if worker_rc:
        print(f"# FAIL: a worker exited rc={worker_rc} (failed drain or "
              "SIGKILL past the drain deadline)", file=sys.stderr)
        rc = 1
    if recompiles and not args.allow_recompiles:
        print(f"# FAIL: {recompiles} post-warmup backend compile(s) "
              "across the fleet (--allow-recompiles to waive)",
              file=sys.stderr)
        rc = 1
    if args.require_zero_errors and report.errors:
        print(f"# FAIL: request errors {report.errors} — failover did "
              "not absorb the fault", file=sys.stderr)
        rc = 1
    if (args.expect_quarantines is not None
            and rstats["quarantine_events"] != args.expect_quarantines):
        print(f"# FAIL: {rstats['quarantine_events']} quarantine "
              f"event(s), expected exactly {args.expect_quarantines}",
              file=sys.stderr)
        rc = 1
    if (args.expect_releases is not None
            and releases != args.expect_releases):
        print(f"# FAIL: {releases} probation release(s), expected "
              f"exactly {args.expect_releases}", file=sys.stderr)
        rc = 1
    if (args.min_redispatch is not None
            and rstats["redispatches"] < args.min_redispatch):
        print(f"# FAIL: redispatches {rstats['redispatches']} < "
              f"{args.min_redispatch} — the failover never happened",
              file=sys.stderr)
        rc = 1
    if args.transfer_sizes:
        t = report.transfers or {}
        if not t.get("requests") or t.get("ok", 0) != t.get("requests"):
            print(f"# FAIL: transfers {t or '{}'} — every oversized "
                  "payload in the mix must complete bit-exact",
                  file=sys.stderr)
            rc = 1
    if args.min_chunk_redispatch is not None:
        got = (tstats or {}).get("chunk_redispatches", 0)
        if got < args.min_chunk_redispatch:
            print(f"# FAIL: chunk redispatches {got} < "
                  f"{args.min_chunk_redispatch} — the per-chunk "
                  "failover never happened", file=sys.stderr)
            rc = 1
    if args.resume_drill:
        if not (resume and resume["interrupted"] and resume["completed"]
                and resume["byte_identical"]
                and resume["resent_only_unacked"]):
            print(f"# FAIL: resume drill {resume} — interrupted-then-"
                  "resumed output must be byte-identical with only the "
                  "unacked chunks re-sent", file=sys.stderr)
            rc = 1
    if control is not None:
        gain = kc_ratio - control["keycache_hit_ratio"]
        floor = args.min_affinity_gain if args.min_affinity_gain is not None else 0.0
        if gain <= floor:
            print(f"# FAIL: affinity keycache hit ratio {kc_ratio:.4f} "
                  f"not better than random "
                  f"{control['keycache_hit_ratio']:.4f} by more than "
                  f"{floor:g} — key affinity bought nothing",
                  file=sys.stderr)
            rc = 1
    if (args.min_waterfall_complete is not None
            and waterfall["complete_frac"] < args.min_waterfall_complete):
        print(f"# FAIL: only {waterfall['complete_frac']:.1%} of sampled "
              f"requests reconstructed a complete cross-process "
              f"waterfall (< {args.min_waterfall_complete:.1%}) — the "
              "ledger propagation broke somewhere on the wire",
              file=sys.stderr)
        rc = 1
    if (args.min_stage_sum_ok is not None
            and waterfall["sum_within_tol_frac"] < args.min_stage_sum_ok):
        print(f"# FAIL: stage sums match end-to-end latency on only "
              f"{waterfall['sum_within_tol_frac']:.1%} of complete "
              f"waterfalls (< {args.min_stage_sum_ok:.1%}) — a stage "
              "is being double-counted across the wire (or clamps are "
              "saturating: the backend reports more time than the "
              "router observed)", file=sys.stderr)
        rc = 1
    if slo_rc:
        print(f"# FAIL: SLO regression against {args.slo}",
              file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
