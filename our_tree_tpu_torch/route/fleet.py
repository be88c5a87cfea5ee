"""Fleet elasticity: the autoscaler, rolling upgrades and the replicated
router tier.

Port of ``our_tree_tpu.route.fleet``. The router (``route/proxy.py``)
assumes a fixed back-end set; this module changes that set safely while
traffic is in flight, and makes the router itself replaceable:

* **FleetSupervisor**: the autoscale and upgrade loop beside a ``Router``.
  Decisions come from the fleet's own reconnaissance (each back end's
  ``/healthz`` queue depth and lane occupancy, mirrored as
  ``route_fleet_*`` gauges) with a hysteresis band, a settle count and a
  cooldown; the ``headroom`` policy grows on the offered load against the
  capacity the workers' pulse engines measure. Growing spawns a port
  worker (``worker_argv``: ``python -m our_tree_tpu_torch.serve.worker``
  with ``--device``, on the card by default) through
  ``resilience.isolate.spawn_service`` and admits it only through
  ``Router.add_backend`` (the canary). Shrinking is drain then remove: the
  victim leaves placement, is SIGTERMed, and leaves the ring only after its
  zero-lost exit line.
* **Rolling upgrades** (``roll_one``): boot the successor, check it against
  the pinned canary with ``Router.canary_check`` without membership, and
  only on identical bytes admit it and drain the predecessor; a mismatch
  aborts the roll and the old worker keeps serving.
* **RouterServer, FailoverClient and gossip**: ``RouterServer`` puts a
  ``Router`` on the framed wire the workers speak, so N router processes
  are interchangeable front doors; a ``{"g": 1}`` frame is the gossip
  exchange (an epoch-stamped membership view with the ring digest, adopted
  by ``adopt_view`` when its epoch is higher; the document is the JAX
  package's). ``FailoverClient`` resends on the next peer when a router
  dies, so a killed router loses no request. ``python -m
  our_tree_tpu_torch.route.fleet`` is one replica: READY line, SIGTERM
  drain, zero-lost exit line.

Fault points ``worker_slow_start`` and ``scale_stall`` (scoped
``@backend=``) sit in the spawn and retire seams. Every socket here rides
the framed wire helpers and every child ``resilience.isolate``; no torch in
this process.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from ..obs import metrics, trace
from ..resilience import faults, isolate
from ..serve import wire
from ..serve.queue import (ERR_BAD_REQUEST, ERR_DISPATCH, ERR_SHED,
                           ERR_SHUTDOWN, ERR_TOO_LARGE, Response)
from .health import QUARANTINED
from .proxy import BackendSpec, Router

#: READY-line kinds (the spawn contract, serve/worker.py one tier up).
REPLICA_KIND = "ot-route-replica"
REPLICA_EXIT_KIND = "ot-route-replica-exit"


# ---------------------------------------------------------------------------
# Worker handles: how the supervisor owns one backend's process.
# ---------------------------------------------------------------------------


class ProcessWorkerHandle:
    """One spawned ``serve.worker`` process, owned through the
    ``resilience.isolate.ServiceChild`` seam (never a raw subprocess).

    The supervisor's handle contract (tests substitute an in-process
    twin): ``start()`` spawns and returns the READY-line
    ``BackendSpec`` (None if the child died or never answered),
    ``drain()`` SIGTERMs and returns the exit-line accounting,
    ``kill()`` ends it now, ``alive()`` polls it. ``read_line`` and
    ``stop`` block on pipes/waitpid, so both run in the default
    executor — the supervisor shares the router's event loop and must
    never stall it.
    """

    def __init__(self, name: str, argv: list, *, env: dict | None = None,
                 ready_deadline_s: float = 180.0,
                 drain_deadline_s: float = 90.0):
        self.name = name
        self.argv = list(argv)
        if env is None:
            # The spawner strips OT_FAULTS (route/bench.py convention):
            # injected faults rehearse the SUPERVISOR's seams, not every
            # child's first dispatch.
            env = {k: v for k, v in os.environ.items() if k != "OT_FAULTS"}
        self.env = env
        self.ready_deadline_s = float(ready_deadline_s)
        self.drain_deadline_s = float(drain_deadline_s)
        self.child: isolate.ServiceChild | None = None
        self.ready: dict | None = None
        #: monotonic time of the spawn, and the seconds until its READY
        #: line (None until it came ready)
        self.spawned_at: float | None = None
        self.ready_s: float | None = None

    async def start(self) -> BackendSpec | None:
        # Popen (pipes, fork/exec) blocks; the supervisor shares the
        # router's event loop, so the spawn runs in the executor like
        # read_line/stop below.
        self.spawned_at = time.monotonic()
        self.child = await asyncio.to_thread(
            isolate.spawn_service, self.argv, env=self.env,
            name=f"fleet:{self.name}")
        loop = asyncio.get_running_loop()
        line = await loop.run_in_executor(
            None, self.child.read_line, self.ready_deadline_s)
        if not line:
            return None
        try:
            doc = json.loads(line)
        except ValueError:
            return None
        if not isinstance(doc, dict) or not doc.get("port"):
            return None
        self.ready = doc
        self.ready_s = round(time.monotonic() - self.spawned_at, 3)
        return BackendSpec(self.name, "127.0.0.1", int(doc["port"]),
                           doc.get("status_port"), pid=doc.get("pid"))

    async def drain(self) -> dict:
        """SIGTERM -> graceful worker drain -> reap; returns the FULL
        exit-line accounting plus ``{"rc": ...}`` (``lost`` is None when
        the child never printed one — a crash, not a drain). The bench's
        zero-lost / zero-recompile gates read the same doc the classic
        teardown parses."""
        if self.child is None:
            return {"rc": None, "lost": None}
        loop = asyncio.get_running_loop()
        rc = await loop.run_in_executor(
            None, self.child.stop, self.drain_deadline_s)
        out, _err = self.child.drain_output()
        res: dict = {"lost": None}
        for raw in reversed(out.splitlines()):
            try:
                doc = json.loads(raw)
            except ValueError:
                continue
            if isinstance(doc, dict) and "lost" in doc:
                res.update(doc)
                break
        res["rc"] = rc
        res["ready_s"] = self.ready_s
        res["spawned_at"] = self.spawned_at
        return res

    async def kill(self) -> None:
        """End the child NOW (the abort path: a successor that failed
        its canary, a spawn that never went ready). stop(0) degrades
        SIGTERM straight into the group SIGKILL."""
        if self.child is None:
            return
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self.child.stop, 0.0)

    def alive(self) -> bool:
        return self.child is not None and self.child.alive()


def worker_argv(*, engine: str = "auto", bucket_min: int = 32,
                bucket_max: int = 4096, queue_depth: int = 1024,
                tenant_depth_frac: float = 1.0,
                dispatch_deadline: float | None = None,
                modes: str = "ctr", lanes: int | None = None,
                device: str = "cuda") -> list:
    """The ``serve.worker`` argv the fleet boots new backends with —
    one template per fleet, so every generation serves the same ladder
    (a scaled-up worker must be a bit-exact peer, not a variant).
    ``device`` is the worker's ``--device``: the card unless a caller
    asks for the CPU."""
    argv = ["-m", "our_tree_tpu_torch.serve.worker", "--port", "0",
            "--status-port", "0", "--device", device, "--engine", engine,
            "--bucket-min", str(bucket_min),
            "--bucket-max", str(bucket_max),
            "--queue-depth", str(queue_depth),
            "--tenant-depth-frac", str(tenant_depth_frac),
            "--modes", modes]
    if dispatch_deadline is not None:
        argv += ["--dispatch-deadline", str(dispatch_deadline)]
    if lanes is not None:
        argv += ["--lanes", str(lanes)]
    return [sys.executable] + argv


# ---------------------------------------------------------------------------
# The supervisor.
# ---------------------------------------------------------------------------


@dataclass
class FleetConfig:
    #: fleet size floor/ceiling the autoscaler moves between
    min_workers: int = 1
    max_workers: int = 4
    #: hysteresis band (mean /healthz queue depth per placeable
    #: backend): grow above ``up_depth``, shrink below ``down_depth``
    #: — the gap between them is what keeps steady load from flapping
    up_depth: float = 8.0
    down_depth: float = 1.0
    #: lane-occupancy grow trigger (mean inflight / lanes): a fleet can
    #: be saturated with an empty queue when requests are large
    up_busy: float = 0.95
    #: consecutive out-of-band ticks before acting (settle count).
    #: ``down_settle_ticks`` defaults to the same, but a drive usually
    #: wants it much larger: pressure is bursty (grow on a short
    #: streak), idleness must be sustained (shrink only when the lull
    #: is real — a few calm polls mid-load are noise, not a signal).
    settle_ticks: int = 2
    down_settle_ticks: int | None = None
    #: minimum seconds between scale events (the cooldown)
    cooldown_s: float = 3.0
    #: supervisor poll period
    poll_every_s: float = 0.25
    #: refresh gossip each tick (off when the router's own gossip loop
    #: already polls — double-polling is harmless but noisy)
    refresh_gossip: bool = True
    #: spawned-worker name prefix (ring identity: ``<prefix><seq>``)
    name_prefix: str = "w"
    #: retained fleet-event ledger entries (the /fleetz tail)
    max_events: int = 256
    #: scaling policy: ``"static"`` (the depth/busy/shed thresholds
    #: above — the default until a measured capacity baseline
    #: exists) or ``"headroom"`` — grow when the measured offered load
    #: reaches ``headroom_frac`` of the fleet's MEASURED capacity (the
    #: per-worker blocks/s estimate each backend's pulse engine
    #: publishes on /healthz, summed over placeable members). The
    #: static triad stays active as the safety net in headroom mode:
    #: a fleet whose capacity estimate is missing or stale still grows
    #: on depth/busy/shed.
    policy: str = "static"
    headroom_frac: float = 0.80


class FleetSupervisor:
    """The fleet-lifecycle control loop over one ``Router``.

    Owns the worker handles it spawned (or adopted), decides scale
    events off the gossip reconnaissance, and is the membership
    AUTHORITY for the replicated router tier: every join/leave bumps
    ``epoch``, and ``view()`` is the epoch-stamped document gossip
    serves to replica routers.
    """

    def __init__(self, router: Router, factory, config: FleetConfig
                 | None = None, clock=time.monotonic):
        self.router = router
        self.factory = factory
        self.config = config or FleetConfig()
        self._clock = clock
        self.workers: dict[str, object] = {}
        self.epoch = 1
        self.scale_ups = 0
        self.scale_downs = 0
        self.rolled = 0
        self.roll_aborts = 0
        self.stalls = 0
        self.spawn_failures = 0
        self.drained_lost = 0
        #: every drained worker's full exit-line doc (+name) — the
        #: bench's "workers" artifact section when the supervisor owns
        #: the whole lifecycle (classic drives parse _teardown instead)
        self.exit_docs: list[dict] = []
        self.events: list[dict] = []
        self._seq = 0
        self._up_ticks = 0
        self._down_ticks = 0
        self._last_event_t: float | None = None
        self._last_sheds = 0
        #: offered-load watermarks: last signals() wall-clock and the
        #: fleet-wide dispatched-bytes total at that instant — the
        #: deltas are the measured offered blocks/s the headroom
        #: policy compares against the capacity estimate.
        self._last_signal_t: float | None = None
        self._last_bytes_out = 0.0
        self._last_signals: dict = {}
        self._task: asyncio.Task | None = None
        #: serializes scale EVENTS (up/down/roll): each one awaits a
        #: child boot or drain, and an interleaved tick() deciding off
        #: the mid-event membership could otherwise shrink a fleet the
        #: roll is about to shrink again — straight through the floor.
        self._resize = asyncio.Lock()
        self._gauges()

    # -- bookkeeping -------------------------------------------------------
    def _gauges(self) -> None:
        metrics.gauge("route_fleet_size", len(self.router.backends))

    def _event(self, kind: str, worker: str, **attrs) -> dict:
        ev = {"kind": kind, "worker": worker,
              "t_s": round(self._clock(), 3), "epoch": self.epoch,
              "size": len(self.router.backends), **attrs}
        self.events.append(ev)
        del self.events[:-self.config.max_events]
        metrics.counter("route_scale_events", kind=kind)
        trace.point("fleet-scale", kind=kind, worker=worker,
                    size=ev["size"], epoch=self.epoch)
        self._last_event_t = self._clock()
        return ev

    @property
    def resizing(self) -> bool:
        """True while a scale event (up/down/roll) is in flight — the
        bench's settle loop waits this out before reading the fleet
        size as final (a queued event may still move it)."""
        return self._resize.locked()

    def adopt(self, name: str, handle) -> None:
        """Take ownership of a pre-spawned worker already registered
        with the router (the drive boots the floor fleet itself, then
        hands the handles over so retire/roll own the full lifecycle)."""
        self.workers[name] = handle
        self._seq = max(self._seq, len(self.workers))
        self._gauges()

    def view(self) -> dict:
        """The epoch-stamped membership view gossip serves: enough for
        a replica to rebuild the SAME ring (names are the ring
        identity) and the same placement intent (draining flags ride
        along, non-punitively)."""
        members = []
        for name, b in sorted(self.router.backends.items()):
            members.append({
                "name": name, "host": b.spec.host, "port": b.spec.port,
                "status_port": b.spec.status_port,
                "state": b.health.state,
                "draining": b.health.draining,
            })
        return {"epoch": self.epoch, "members": members,
                "ring": self.router.ring.digest()}

    def fleetz(self) -> dict:
        """The /fleetz document (route/status.py serves it): live fleet
        size + thresholds + the recent scale-event tail — the operator's
        answer to "what has the autoscaler been doing"."""
        c = self.config
        return {
            "size": len(self.router.backends),
            "owned": sorted(self.workers),
            "min_workers": c.min_workers, "max_workers": c.max_workers,
            "up_depth": c.up_depth, "down_depth": c.down_depth,
            "cooldown_s": c.cooldown_s,
            "policy": c.policy,
            "headroom_frac": c.headroom_frac,
            "signals": dict(self._last_signals),
            "epoch": self.epoch,
            "scale_ups": self.scale_ups, "scale_downs": self.scale_downs,
            "rolled": self.rolled, "roll_aborts": self.roll_aborts,
            "stalls": self.stalls, "spawn_failures": self.spawn_failures,
            "drained_lost": self.drained_lost,
            "events": self.events[-32:],
        }

    # -- signals -----------------------------------------------------------
    def signals(self) -> dict:
        """The autoscale inputs off the gossip reconnaissance: mean
        /healthz queue depth and lane occupancy across polled placeable
        backends, plus the router-side shed delta since the last tick
        (backpressure that already reached the router). Mirrored into
        the registry as gauges — the same numbers an operator's scrape
        sees are the numbers the loop acted on."""
        depths, inflight, lanes = [], 0.0, 0.0
        capacity_bps = 0.0
        for b in self.router.backends.values():
            doc = b.last_healthz
            if not isinstance(doc, dict) or not b.health.placeable():
                continue
            q = doc.get("queue")
            ln = doc.get("lanes")
            if isinstance(q, dict):
                depths.append(float(q.get("depth", 0)))
            if isinstance(ln, dict):
                inflight += float(ln.get("inflight", 0))
                lanes += max(float(ln.get("count", 1)), 1.0)
            # The per-worker MEASURED capacity estimate (obs/pulse.py
            # via the worker's /healthz "capacity" section): summed
            # over placeable members = the fleet's live ceiling.
            cap = doc.get("capacity")
            if isinstance(cap, dict):
                try:
                    capacity_bps += float(
                        cap.get("total_blocks_per_s", 0) or 0)
                except (TypeError, ValueError):
                    pass
        sheds_now = self.router.shed_retries + self.router.router_sheds
        shed_delta = sheds_now - self._last_sheds
        self._last_sheds = sheds_now
        # Offered load, measured router-side: dispatched payload bytes
        # across ALL backends (16-byte blocks) over the tick interval.
        # At saturation dispatch tracks capacity, so offered/capacity
        # approaches 1.0 — exactly when headroom is gone.
        now = self._clock()
        bytes_now = sum(float(b.bytes_out)
                        for b in self.router.backends.values())
        dt = (now - self._last_signal_t
              if self._last_signal_t is not None else 0.0)
        offered_bps = (max(bytes_now - self._last_bytes_out, 0.0) / 16.0
                       / dt if dt > 0 else 0.0)
        shed_rate = (shed_delta / dt) if dt > 0 else 0.0
        self._last_signal_t = now
        self._last_bytes_out = bytes_now
        depth = sum(depths) / len(depths) if depths else 0.0
        busy = (inflight / lanes) if lanes else 0.0
        headroom = (offered_bps / capacity_bps) if capacity_bps > 0 else 0.0
        metrics.gauge("route_fleet_depth", depth)
        metrics.gauge("route_fleet_busy", busy)
        metrics.gauge("route_fleet_shed_rate", shed_rate)
        metrics.gauge("route_fleet_capacity_blocks", capacity_bps)
        metrics.gauge("route_fleet_offered_blocks", offered_bps)
        if shed_delta:
            metrics.counter("route_fleet_shed_seen", shed_delta)
        sig = {"depth": depth, "busy": busy, "shed": shed_delta,
               "shed_rate": round(shed_rate, 3),
               "capacity_bps": round(capacity_bps, 3),
               "offered_bps": round(offered_bps, 3),
               "headroom_used": round(headroom, 4),
               "polled": len(depths)}
        self._last_signals = sig
        return sig

    # -- the loop ----------------------------------------------------------
    async def tick(self) -> str:
        """One decision pass; returns what it did (the bench narrates
        it). Hysteresis: the up/down depth thresholds bound a dead band,
        a decision needs ``settle_ticks`` consecutive out-of-band
        observations, and any event starts the cooldown window."""
        c = self.config
        if c.refresh_gossip:
            await self.router.gossip_once()
        sig = self.signals()
        self._gauges()
        now = self._clock()
        if (self._last_event_t is not None
                and now - self._last_event_t < c.cooldown_s):
            return "cooldown"
        grow = (sig["depth"] >= c.up_depth or sig["busy"] >= c.up_busy
                or sig["shed"] > 0)
        if c.policy == "headroom":
            # Measured-capacity policy (the ROADMAP payoff): grow when
            # offered load eats into the headroom band of the fleet's
            # MEASURED capacity. The static triad above stays live as
            # the safety net — a missing/stale capacity estimate must
            # never make the fleet blind to pressure. Shrink/floor
            # behavior is deliberately unchanged.
            grow = grow or (sig["capacity_bps"] > 0
                            and sig["offered_bps"]
                            >= c.headroom_frac * sig["capacity_bps"])
        shrink = (sig["depth"] <= c.down_depth and sig["busy"] < c.up_busy
                  and sig["shed"] == 0)
        if grow:
            self._up_ticks += 1
            self._down_ticks = 0
            if (self._up_ticks >= c.settle_ticks
                    and len(self.router.backends) < c.max_workers):
                self._up_ticks = 0
                return ("scaled-up" if await self.scale_up() else "stalled")
            return "pressure"
        self._up_ticks = 0
        if shrink:
            self._down_ticks += 1
            down_ticks = (c.down_settle_ticks
                          if c.down_settle_ticks is not None
                          else c.settle_ticks)
            if (self._down_ticks >= down_ticks
                    and len(self.workers) > 0
                    and len(self.router.backends) > c.min_workers):
                self._down_ticks = 0
                return ("scaled-down" if await self.scale_down()
                        else "stalled")
            return "idle"
        self._down_ticks = 0
        return "steady"

    async def run(self, stop_ev: asyncio.Event) -> None:
        """The supervisor loop (the drive runs it as a task next to the
        load): tick until told to stop."""
        while not stop_ev.is_set():
            await self.tick()
            try:
                await asyncio.wait_for(stop_ev.wait(),
                                       timeout=self.config.poll_every_s)
            except asyncio.TimeoutError:
                pass

    # -- scale events ------------------------------------------------------
    async def _boot(self, name: str):
        """Spawn one worker through the handle factory and wait for its
        READY spec. The ``worker_slow_start`` fault point injects a
        boot delay HERE — the seam where a slow worker stalls the scale
        event (never a rider: the fleet keeps serving on the old set
        while the newcomer boots)."""
        handle = self.factory(name)
        if faults.fire_backend("worker_slow_start", self._seq - 1):
            # The async twin of faults.injected_slow: same OT_SLOW_S
            # knob, but awaited — the supervisor shares the router's
            # event loop and must not block it to simulate a slow boot.
            trace.point("fault-slow-start", worker=name)
            try:
                slow_s = max(float(os.environ.get("OT_SLOW_S", 0.05)), 0.0)
            except ValueError:
                slow_s = 0.05
            await asyncio.sleep(slow_s)
        spec = await handle.start()
        return handle, spec

    async def scale_up(self, kind: str = "up") -> str | None:
        """Grow by one: spawn, READY, canary-gated join. Returns the
        new member's name, or None when the event stalled, the spawn
        died, or the canary rejected the newcomer (each a counted
        event; the serving fleet is untouched in every abort path)."""
        async with self._resize:
            return await self._scale_up(kind)

    async def _scale_up(self, kind: str = "up") -> str | None:
        if (kind == "up"
                and len(self.router.backends) >= self.config.max_workers):
            # Re-checked under the lock: the tick that queued this
            # event read the pre-event membership.
            return None
        if faults.fire_backend("scale_stall", self._seq):
            self.stalls += 1
            self._event("stall", "", seam="spawn")
            return None
        name = f"{self.config.name_prefix}{self._seq}"
        self._seq += 1
        with trace.span("fleet-spawn", worker=name):
            handle, spec = await self._boot(name)
            if spec is None:
                self.spawn_failures += 1
                await handle.kill()
                self._event("spawn-failed", name)
                return None
            await self.router.add_backend(spec)
            b = self.router.backends[name]
            if b.health.state == QUARANTINED:
                # The join canary failed or mismatched: placement never
                # trusted it — undo the join and retire the child.
                self.router.remove_backend(name)
                await handle.kill()
                self.spawn_failures += 1
                self._event("join-rejected", name)
                return None
        self.workers[name] = handle
        self.epoch += 1
        if kind == "up":
            self.scale_ups += 1
        self._gauges()
        self._event(kind, name)
        return name

    async def scale_down(self, name: str | None = None,
                         kind: str = "down") -> bool:
        """Shrink by one, always drain-then-remove: mark the victim
        draining (placement drops it now), SIGTERM it and wait for the
        zero-lost exit line, THEN remove it from the ring — the
        minimal-motion rebalance happens once, after the member is
        truly gone, and moves only its keys."""
        async with self._resize:
            return await self._scale_down(name, kind)

    async def _scale_down(self, name: str | None = None,
                          kind: str = "down") -> bool:
        if (kind == "down"
                and len(self.router.backends) <= self.config.min_workers):
            # Re-checked under the lock: a roll or another shrink may
            # have moved the fleet while this event waited its turn —
            # the floor holds no matter how the decisions interleaved.
            return False
        if name is None:
            owned = [n for n in reversed(list(self.workers))
                     if n in self.router.backends]
            if not owned:
                return False
            name = owned[0]
        handle = self.workers.get(name)
        if handle is None:
            return False
        b = self.router.backends.get(name)
        if b is not None and faults.fire_backend("scale_stall", b.idx):
            self.stalls += 1
            self._event("stall", name, seam="retire")
            return False
        with trace.span("fleet-drain", worker=name):
            if b is not None:
                b.health.note_gossip("draining")
                # Publish the draining flag NOW (epoch bump before the
                # drain, not only after the removal): replica routers
                # adopt the view and stop placing on the victim while
                # it is still finishing its in-flight work.
                self.epoch += 1
                # Release the victim's PARKED pool sockets and stop
                # re-parking: the worker's frontend drain waits out a
                # grace window on every open connection, and an idle
                # pooled socket would wedge that wait for the full
                # grace. In-flight exchanges keep their conns and
                # discard them on completion (pool_size 0 = no park).
                b.pool_size = 0
                b.close_pool()
            res = await handle.drain()
            if name in self.router.backends:
                self.router.remove_backend(name)
            self.workers.pop(name, None)
        self.epoch += 1
        self.exit_docs.append({"name": name, **res})
        lost = res.get("lost")
        if lost:
            self.drained_lost += int(lost)
        if kind == "down":
            self.scale_downs += 1
        self._gauges()
        self._event(kind, name, rc=res.get("rc"), lost=lost)
        return True

    async def roll_one(self, name: str | None = None) -> bool:
        """Replace ONE worker: boot the successor, cross-check it
        against the live fleet with the pinned startup canary
        bit-exactly (``Router.canary_check`` — membership is NOT
        granted yet), and only on a byte-identical answer admit it and
        drain the predecessor. Any mismatch aborts the roll — the
        successor dies, the old worker keeps serving."""
        async with self._resize:
            return await self._roll_one(name)

    async def _roll_one(self, name: str | None = None) -> bool:
        if name is None:
            candidates = [n for n in self.workers
                          if n in self.router.backends]
            if not candidates:
                return False
            name = candidates[0]
        succ = f"{self.config.name_prefix}{self._seq}"
        self._seq += 1
        with trace.span("fleet-roll", worker=name, successor=succ):
            handle, spec = await self._boot(succ)
            if spec is None:
                self.spawn_failures += 1
                self.roll_aborts += 1
                await handle.kill()
                self._event("roll-abort", name, successor=succ,
                            why="spawn-failed")
                return False
            ok, why = await self.router.canary_check(spec)
            if not ok:
                # The bit-exact handoff gate: the successor answered
                # the pinned canary wrong (or not at all). Old worker
                # stays; the roll is a counted abort, not a downgrade.
                self.roll_aborts += 1
                await handle.kill()
                self._event("roll-abort", name, successor=succ, why=why)
                return False
            await self.router.add_backend(spec)
            b = self.router.backends[succ]
            if b.health.state == QUARANTINED:
                self.router.remove_backend(succ)
                self.roll_aborts += 1
                await handle.kill()
                self._event("roll-abort", name, successor=succ,
                            why="join-canary")
                return False
            self.workers[succ] = handle
            self.epoch += 1
            await self._scale_down(name, kind="roll-out")
        self.rolled += 1
        self._event("roll", name, successor=succ)
        return True

    async def close(self, drain: bool = True) -> None:
        """Retire every owned worker (teardown). ``drain=False`` kills
        them (the abandon path)."""
        async with self._resize:
            await self._close(drain)

    async def _close(self, drain: bool) -> None:
        for name in list(reversed(list(self.workers))):
            handle = self.workers.pop(name)
            b = self.router.backends.get(name)
            if b is not None:
                # As in a scale-down: a parked pooled socket would hold
                # the worker's drain for its whole connection grace.
                b.pool_size = 0
                b.close_pool()
            if drain:
                res = await handle.drain()
                if res.get("lost"):
                    self.drained_lost += int(res["lost"])
                self.exit_docs.append({"name": name, **res})
            else:
                await handle.kill()
            if name in self.router.backends:
                self.router.remove_backend(name)
            self.epoch += 1
        self._gauges()


# ---------------------------------------------------------------------------
# The replicated router tier: wire frontend, gossip, failover client.
# ---------------------------------------------------------------------------


class RouterServer:
    """A ``Router`` behind the framed wire (serve/wire.py) — the same
    protocol the backends speak, one tier up, so N router processes
    are interchangeable front doors for the same fleet. A ``{"g": 1}``
    frame is the gossip exchange: the answer carries ``view_fn()``'s
    epoch-stamped membership document instead of payload bytes.
    ``view_fn`` is the membership authority hook — the owner serves its
    supervisor's view, a replica serves the view it last adopted."""

    def __init__(self, router: Router, port: int = 0,
                 host: str = "127.0.0.1", view_fn=None,
                 max_frame_bytes: int = wire.MAX_PAYLOAD):
        self.router = router
        self._host = host
        self._port = int(port)
        self._view_fn = view_fn
        self._max_len = int(max_frame_bytes)
        self._srv: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.Task] = set()
        self.port: int | None = None
        self.frames = 0
        self.gossip_frames = 0
        self.protocol_errors = 0

    async def start(self) -> None:
        self._srv = await asyncio.start_server(
            self._on_conn, self._host, self._port)
        self.port = self._srv.sockets[0].getsockname()[1]

    async def stop(self, grace_s: float = 5.0) -> None:
        if self._srv is not None:
            self._srv.close()
            await self._srv.wait_closed()
            self._srv = None
        if self._conns:
            _done, pending = await asyncio.wait(
                list(self._conns), timeout=max(grace_s, 0.0))
            for task in pending:
                task.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)

    def abort(self) -> None:
        """Die NOW: close the listener and cancel every connection
        mid-frame — the in-process stand-in for SIGKILL (the CI drive
        kills a real replica process; tests kill this). Clients see a
        torn connection, exactly as they would from a dead process."""
        if self._srv is not None:
            self._srv.close()
            self._srv = None
        for task in list(self._conns):
            task.cancel()

    def _on_conn(self, reader, writer) -> None:
        task = asyncio.ensure_future(self._serve_conn(reader, writer))
        self._conns.add(task)
        task.add_done_callback(self._conns.discard)

    async def _serve_conn(self, reader, writer) -> None:
        try:
            while True:
                try:
                    frame = await wire.read_frame(reader, self._max_len)
                except wire.FrameTooLarge as e:
                    # The router frontend's half of the frame-bound
                    # hardening (serve/worker.py has the backend's): the
                    # declared length failed validation BEFORE any
                    # allocation, the header parsed, so answer a TYPED
                    # error frame — and when the declared payload is
                    # modest enough to drain, keep the connection.
                    self.protocol_errors += 1
                    try:
                        writer.write(wire.encode_frame(
                            {"ok": False, "error": ERR_TOO_LARGE,
                             "detail": f"wire: {e}"}))
                        await writer.drain()
                    except Exception:  # noqa: BLE001 - peer already gone
                        return
                    if 0 <= e.declared <= 4 * self._max_len and \
                            await wire.skip_payload(reader, e.declared):
                        continue
                    return
                except wire.WireError as e:
                    # A torn or unparseable frame leaves no boundary to
                    # trust: answer the typed error (best effort), then
                    # close — but never a silent reset.
                    self.protocol_errors += 1
                    try:
                        writer.write(wire.encode_frame(
                            {"ok": False, "error": ERR_BAD_REQUEST,
                             "detail": f"wire: {e}"}))
                        await writer.drain()
                    except Exception:  # noqa: BLE001 - peer already gone
                        pass
                    return
                if frame is None:
                    return
                header, payload = frame
                if header.get("g"):
                    self.gossip_frames += 1
                    epoch, view = (self._view_fn()
                                   if self._view_fn is not None
                                   else (0, {}))
                    writer.write(wire.encode_frame(
                        {"g": 1, "epoch": epoch},
                        json.dumps(view).encode("utf-8")))
                    await writer.drain()
                    continue
                self.frames += 1
                await self._answer(writer, header, payload)
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - peer already gone
                pass

    async def _answer(self, writer, header: dict, payload: bytes) -> None:
        """One request frame -> ``Router.submit`` -> one response frame
        (the ``serve.worker`` answer shape, so a client cannot tell a
        router from a backend — which is the point)."""
        try:
            key = bytes.fromhex(str(header.get("k", "")))
            nonce = bytes.fromhex(str(header.get("n", "")))
            iv = bytes.fromhex(str(header.get("iv", "")))
            aad = bytes.fromhex(str(header.get("a", "")))
            tag = bytes.fromhex(str(header.get("tg", "")))
        except ValueError:
            key = nonce = iv = aad = tag = b""
        try:
            deadline = header.get("deadline_s")
            deadline = float(deadline) if deadline is not None else None
        except (TypeError, ValueError):
            deadline = None
        resp = await self.router.submit(
            str(header.get("t", "")), key, nonce, payload,
            deadline_s=deadline, mode=str(header.get("m") or "ctr"),
            iv=iv, aad=aad, tag=tag)
        if resp.ok:
            out = {"ok": True, "batch": resp.batch}
            if resp.tag is not None:
                out["tg"] = resp.tag.hex()
            body = (resp.payload.tobytes()
                    if hasattr(resp.payload, "tobytes")
                    else bytes(resp.payload or b""))
        else:
            out = {"ok": False, "error": resp.error,
                   "detail": resp.detail, "batch": resp.batch}
            body = b""
        out["pid"] = os.getpid()
        if resp.ledger is not None:
            out["lg"] = resp.ledger
        writer.write(wire.encode_frame(out, body))
        await writer.drain()


async def gossip_exchange(host: str, port: int, epoch: int,
                          timeout_s: float = 2.0) -> dict | None:
    """One gossip round trip against a peer router's wire port:
    ``{"g": 1, "epoch": E}`` out, the peer's epoch-stamped view back.
    None on any failure — gossip is reconnaissance, never load-bearing
    for an in-flight request."""
    async def once():
        reader, writer = await asyncio.open_connection(host, port)
        try:
            writer.write(wire.encode_frame({"g": 1, "epoch": epoch}))
            await writer.drain()
            frame = await wire.read_frame(reader)
            if frame is None:
                return None
            header, payload = frame
            if not header.get("g"):
                return None
            doc = json.loads(payload) if payload else {}
            if isinstance(doc, dict):
                doc["epoch"] = int(header.get("epoch", doc.get("epoch", 0)))
                return doc
            return None
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - peer already gone
                pass
    try:
        return await asyncio.wait_for(once(), timeout=max(timeout_s, 0.001))
    except Exception:  # noqa: BLE001 - unreachable IS the data point
        return None


async def adopt_view(router: Router, doc: dict) -> dict:
    """Fold a higher-epoch membership view into ``router``: joins run
    through ``add_backend`` (each newcomer re-proves bit-exactness
    against THIS router's pinned canary), leaves through
    ``remove_backend`` (minimal motion), and draining flags land
    non-punitively. Returns {"joined": [...], "left": [...]} for the
    caller's ledger. A stale window between views is safe by design:
    any backend serves any key, so placement disagreement costs an
    affinity miss, never a wrong answer."""
    members = {m["name"]: m for m in doc.get("members", [])
               if isinstance(m, dict) and m.get("name")}
    joined, left = [], []
    for name in list(router.backends):
        if name not in members:
            router.remove_backend(name)
            left.append(name)
    for name, m in sorted(members.items()):
        if name not in router.backends:
            try:
                await router.add_backend(BackendSpec(
                    name, str(m.get("host", "127.0.0.1")),
                    int(m["port"]), m.get("status_port")))
                joined.append(name)
            except (KeyError, TypeError, ValueError):
                continue
        b = router.backends.get(name)
        if b is not None and m.get("draining"):
            b.health.note_gossip("draining")
    want = doc.get("ring")
    if want and router.ring.digest() != want:
        # Same members must mean the same ring (the hash is
        # deterministic); a digest mismatch is a vnodes/config skew —
        # loud evidence, not silent divergence.
        trace.point("fleet-ring-skew", want=want,
                    have=router.ring.digest())
    trace.point("fleet-view-adopted", epoch=doc.get("epoch", 0),
                members=len(members), joined=len(joined), left=len(left))
    return {"joined": joined, "left": left}


class FailoverClient:
    """The loadgen-compatible submit facade over N router peers.

    Holds the peer list; each request rides one framed exchange against
    the current peer, and ANY transport failure — refused connect, torn
    frame, attempt timeout — advances to the next peer and RESENDS
    (CTR/AEAD dispatch is a pure function of the request bytes, so the
    replay is bit-identical wherever it lands). A SIGKILLed router
    therefore costs its in-flight requests one failover each, never a
    loss; only a dead WHOLE tier answers an error, after every peer was
    tried against the request deadline.

    Answered backpressure — ``shed`` (a worker queue was full) and
    ``dispatch-failed`` (the ring was mid-churn: a member draining, a
    stale pooled socket discarded with nowhere to redispatch) — is
    retried here too, after ``retry_backoff_s``: both mean "not now",
    not "never", and the client's retry budget is the request deadline.
    Only a mismatch-class error (bad tag, bad frame) surfaces at once.
    """

    def __init__(self, peers: list, attempt_timeout_s: float = 5.0,
                 deadline_s: float = 30.0,
                 max_frame_bytes: int = wire.MAX_PAYLOAD,
                 retry_backoff_s: float = 0.02, clock=time.monotonic):
        self.peers = [(str(h), int(p)) for h, p in peers]
        if not self.peers:
            raise ValueError("FailoverClient needs at least one peer")
        self.attempt_timeout_s = float(attempt_timeout_s)
        self.deadline_s = float(deadline_s)
        self.max_frame_bytes = int(max_frame_bytes)
        self.retry_backoff_s = float(retry_backoff_s)
        self._clock = clock
        self._cur = 0
        self.submitted = 0
        self.failovers = 0
        self.backpressure_retries = 0

    async def _exchange(self, host: str, port: int, header: dict,
                        data: bytes):
        reader, writer = await asyncio.open_connection(host, port)
        try:
            writer.write(wire.encode_frame(header, data))
            await writer.drain()
            frame = await wire.read_frame(reader, self.max_frame_bytes)
            if frame is None:
                raise ConnectionError(f"router {host}:{port} closed "
                                      "mid-exchange")
            return frame
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - peer already gone
                pass

    async def submit(self, tenant: str, key: bytes, nonce: bytes, payload,
                     deadline_s: float | None = None, mode: str = "ctr",
                     iv: bytes = b"", aad: bytes = b"",
                     tag: bytes = b"") -> Response:
        data = (payload.tobytes() if hasattr(payload, "tobytes")
                else bytes(payload))
        total_s = self.deadline_s if deadline_s is None else float(deadline_s)
        header = {"t": tenant, "k": bytes(key).hex(),
                  "n": bytes(nonce).hex(),
                  "deadline_s": round(total_s, 3) or None}
        if mode != "ctr":
            header["m"] = mode
            if iv:
                header["iv"] = bytes(iv).hex()
            if aad:
                header["a"] = bytes(aad).hex()
            if tag:
                header["tg"] = bytes(tag).hex()
        self.submitted += 1
        t0 = self._clock()
        last: Exception | None = None
        dead_streak = 0
        while dead_streak < 2 * len(self.peers):
            left = total_s - (self._clock() - t0)
            if left <= 0:
                break
            host, port = self.peers[self._cur % len(self.peers)]
            try:
                rh, body = await asyncio.wait_for(
                    self._exchange(host, port, header, data),
                    timeout=max(min(self.attempt_timeout_s, left), 0.001))
            except Exception as e:  # noqa: BLE001 - fail over, then resend
                last = e
                dead_streak += 1
                self._cur += 1
                self.failovers += 1
                metrics.counter("route_client_failover")
                trace.point("client-failover", peer=f"{host}:{port}",
                            why=type(e).__name__)
                continue
            # An ANSWER — whatever it says, this peer (and the tier) is
            # alive, so the whole-tier-dead streak resets.
            dead_streak = 0
            if not rh.get("ok") and rh.get("error") == ERR_SHUTDOWN:
                # This router is draining; the fleet behind the tier is
                # still fine — move to a peer like any other failover.
                last = ConnectionError("router draining")
                self._cur += 1
                self.failovers += 1
                metrics.counter("route_client_failover")
                continue
            if not rh.get("ok") and rh.get("error") in (ERR_SHED,
                                                        ERR_DISPATCH):
                # Backpressure, not verdict: a full worker queue or a
                # mid-churn ring. Back off and resend — same peer, same
                # bytes — against the request deadline.
                last = ConnectionError(f"backpressure: {rh.get('error')}")
                self.backpressure_retries += 1
                metrics.counter("route_client_backpressure_retry")
                await asyncio.sleep(min(self.retry_backoff_s,
                                        max(left, 0.0)))
                continue
            tg = rh.get("tg")
            try:
                resp_tag = (bytes.fromhex(str(tg))
                            if isinstance(tg, str) and tg else None)
            except ValueError:
                resp_tag = None
            if rh.get("ok"):
                return Response(ok=True,
                                payload=np.frombuffer(body, np.uint8),
                                batch=rh.get("batch"),
                                ledger=rh.get("lg"), tag=resp_tag)
            return Response(ok=False, error=rh.get("error"),
                            detail=str(rh.get("detail", "")),
                            batch=rh.get("batch"), ledger=rh.get("lg"))
        detail = (f"{type(last).__name__}: {last}" if last is not None
                  else "request deadline spent before any peer answered")
        return Response(ok=False, error=ERR_DISPATCH,
                        detail=f"no router peer answered ({detail})")


# ---------------------------------------------------------------------------
# The replica router process entry.
# ---------------------------------------------------------------------------


@dataclass
class _ReplicaState:
    epoch: int = 0
    view: dict = field(default_factory=dict)
    adopts: int = 0


async def _replica_amain(args) -> int:
    from .proxy import RouterConfig

    specs = [BackendSpec(m["name"], m.get("host", "127.0.0.1"),
                         int(m["port"]), m.get("status_port"))
             for m in json.loads(args.backends)]
    cfg = RouterConfig(attempt_timeout_s=args.attempt_timeout,
                       deadline_s=args.deadline,
                       gossip_every_s=args.gossip_every,
                       max_frame_bytes=args.max_frame_bytes)
    router = Router(specs, cfg)
    await router.start()
    st = _ReplicaState(view={"epoch": 0, "members": []})

    def view_fn():
        return st.epoch, st.view

    server = RouterServer(router, args.port, view_fn=view_fn,
                          max_frame_bytes=args.max_frame_bytes)
    await server.start()
    peer = None
    if args.peer:
        host, _, port = args.peer.rpartition(":")
        peer = (host or "127.0.0.1", int(port))

    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    import signal
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop_ev.set)

    async def gossip_loop():
        while True:
            await asyncio.sleep(max(args.gossip_every, 0.05))
            if peer is None:
                continue
            doc = await gossip_exchange(peer[0], peer[1], st.epoch)
            if doc and int(doc.get("epoch", 0)) > st.epoch:
                await adopt_view(router, doc)
                st.epoch = int(doc["epoch"])
                st.view = doc
                st.adopts += 1

    gtask = asyncio.ensure_future(gossip_loop())
    print(json.dumps({"kind": REPLICA_KIND, "port": server.port,
                      "pid": os.getpid(),
                      "backends": len(router.backends)}), flush=True)
    trace.point("replica-ready", port=server.port,
                backends=len(router.backends))
    await stop_ev.wait()
    gtask.cancel()
    try:
        await gtask
    except (asyncio.CancelledError, Exception):  # noqa: BLE001
        pass
    await server.stop()
    await router.stop()
    stats = router.stats()
    lost = stats["lost"]
    print(json.dumps({"kind": REPLICA_EXIT_KIND, "lost": lost,
                      "accepted": stats["accepted"],
                      "answered": stats["answered"],
                      "routed_ok": stats["routed_ok"],
                      "adopts": st.adopts,
                      "frames": server.frames,
                      "gossip_frames": server.gossip_frames}), flush=True)
    return 1 if lost else 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m our_tree_tpu_torch.route.fleet",
        description="one replica router process for the replicated "
                    "front-door tier (docs/SERVING.md, fleet "
                    "elasticity)")
    ap.add_argument("--port", type=int, default=0,
                    help="wire port (0 = ephemeral; rides the READY "
                         "line)")
    ap.add_argument("--backends", required=True, metavar="JSON",
                    help="initial membership: JSON list of "
                         '{"name","host","port","status_port"}')
    ap.add_argument("--peer", default=None, metavar="HOST:PORT",
                    help="membership authority to gossip with (the "
                         "owner router's wire port); absent = static "
                         "membership")
    ap.add_argument("--gossip-every", type=float, default=0.25)
    ap.add_argument("--attempt-timeout", type=float, default=5.0)
    ap.add_argument("--deadline", type=float, default=30.0)
    ap.add_argument("--max-frame-bytes", type=int,
                    default=wire.MAX_PAYLOAD)
    args = ap.parse_args(argv)
    trace.ensure_run()
    return asyncio.run(_replica_amain(args))


if __name__ == "__main__":
    sys.exit(main())
