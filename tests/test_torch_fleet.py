"""The port's fleet tier (``our_tree_tpu_torch.route.fleet``) held against
the JAX package's, as ``tests/test_fleet.py`` holds the JAX one. Worker
handles wrap a real in-process server behind its frontend (the port's on the
CPU); each script runs through both packages and the results must be equal:

* the autoscaler's decisions on one scripted sequence of signals (depth,
  busy, settle ticks, cooldown, the floor and the ceiling, the headroom
  policy), its events and ``/fleetz`` document;
* a worker that dies before READY, the ``scale_stall`` and
  ``worker_slow_start`` fault points, drain-then-remove under load;
* the rolling upgrade and its abort on a canary mismatch;
* gossip: a replica adopting the owner's view (a view written by either
  package adopted by the other's ``adopt_view``), ring digests, the draining
  flag;
* a router killed mid-drive behind ``FailoverClient``, a dead tier;
* the connection pool's reuse and a stale pooled socket riding the ring
  retry;
* ``worker_argv`` (``python -m our_tree_tpu_torch.serve.worker`` with
  ``--device``, ``cuda`` by default), ``ProcessWorkerHandle``'s spawn off
  the loop, and the replica entry's kinds.

Bytes, counts and decisions are exact: no tolerance.
"""

import asyncio
import os
import threading
import time

import numpy as np
import pytest

import route_pair as rp


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("OT_FAULTS", raising=False)
    monkeypatch.delenv("OT_DISPATCH_DEADLINE", raising=False)
    monkeypatch.delenv("OT_TRACE_DIR", raising=False)
    rp.reset_state()
    yield
    monkeypatch.delenv("OT_FAULTS", raising=False)
    rp.reset_state()


class InProcWorkerHandle:
    """The supervisor's handle contract over an in-process server and
    frontend of package ``pkg``; ``die_on_start`` answers no READY."""

    def __init__(self, pkg, name, die_on_start=False):
        self.pkg, self.name, self.die_on_start = pkg, name, die_on_start
        self.server = self.front = None
        self._alive = self.killed = self.drained = False

    async def start(self):
        if self.die_on_start:
            return None
        self.server = rp.new_server(self.pkg, status_port=0)
        await self.server.start()
        self.front = self.pkg.RequestFrontend(self.server, 0)
        await self.front.start()
        self._alive = True
        return self.pkg.BackendSpec(self.name, "127.0.0.1", self.front.port,
                                    self.server.status.port)

    async def drain(self):
        if not self._alive:
            return {"rc": None, "lost": None}
        self.server.queue.close()
        await self.front.stop()
        await self.server.stop()
        self._alive, self.drained = False, True
        return {"rc": 0, "lost": self.server.queue.stats()["lost"]}

    async def kill(self):
        self.killed = True
        if not self._alive:
            return
        self._alive = False
        await self.front.stop(grace_s=0.0)
        await self.server.stop()

    def alive(self):
        return self._alive


class RiggedCanaryHandle:
    """A successor whose answers are zero bytes: never the pinned canary."""

    def __init__(self, pkg, name):
        self.pkg, self.name = pkg, name
        self._srv = None
        self.killed = False

    async def start(self):
        pkg = self.pkg

        async def serve(reader, writer):
            try:
                while True:
                    frame = await pkg.wire.read_frame(reader)
                    if frame is None:
                        return
                    writer.write(pkg.wire.encode_frame(
                        {"ok": True, "pid": os.getpid(), "ts": pkg.trace.now_us()},
                        bytes(len(frame[1]) or 64)))
                    await writer.drain()
            finally:
                writer.close()

        self._srv = await asyncio.start_server(serve, "127.0.0.1", 0)
        return self.pkg.BackendSpec(self.name, "127.0.0.1", self._srv.sockets[0].getsockname()[1],
                                    None)

    async def drain(self):
        await self.kill()
        return {"rc": 0, "lost": 0}

    async def kill(self):
        self.killed = True
        if self._srv is not None:
            self._srv.close()
            await self._srv.wait_closed()
            self._srv = None

    def alive(self):
        return self._srv is not None


class Fleet:
    """N in-process workers adopted by a supervisor over a router."""

    def __init__(self, pkg, n=1, fleet_cfg=None, factory=None, clock=None):
        self.pkg, self.n, self.clock = pkg, n, clock or time.monotonic
        self.fleet_cfg = fleet_cfg
        self.factory = factory or (lambda name: InProcWorkerHandle(pkg, name))

    async def __aenter__(self):
        self.handles, specs = {}, []
        for i in range(self.n):
            h = InProcWorkerHandle(self.pkg, f"w{i}")
            specs.append(await h.start())
            self.handles[h.name] = h
        self.router = self.pkg.Router(specs, self.pkg.RouterConfig(gossip_every_s=0.0,
                                                                   attempt_timeout_s=2.0))
        await self.router.start()
        self.sup = self.pkg.fleet.FleetSupervisor(self.router, self.factory, self.fleet_cfg,
                                                  clock=self.clock)
        for name, h in self.handles.items():
            self.sup.adopt(name, h)
        return self

    async def __aexit__(self, *exc):
        await self.router.stop()
        await self.sup.close(drain=False)


async def _nist(target, tenant="t0"):
    resp = await target.submit(tenant, rp.NIST_KEY, rp.NIST_CTR0,
                               np.frombuffer(rp.NIST_PT, np.uint8))
    assert resp.ok, (resp.error, resp.detail)
    return bytes(np.asarray(resp.payload))


def _pressure(router, depth, busy=0.0, capacity=None):
    for b in router.backends.values():
        b.last_healthz = {"queue": {"depth": depth}, "lanes": {"inflight": busy, "count": 1}}
        if capacity is not None:
            b.last_healthz["capacity"] = {"total_blocks_per_s": capacity}


def _events(sup):
    return [{k: v for k, v in e.items() if k != "t_s"} for e in sup.events]


# ---------------------------------------------------------------------------
# The autoscaler: one scripted signal sequence, the same decisions.
# ---------------------------------------------------------------------------


def test_autoscale_decisions_on_a_scripted_signal_sequence():
    script_steps = [("depth", 4.0, 0.0), ("depth", 20.0, 0.0), ("depth", 20.0, 0.0),
                    ("depth", 20.0, 0.0), ("advance", 10.0), ("depth", 0.0, 0.0),
                    ("depth", 0.0, 0.0), ("advance", 10.0), ("depth", 0.0, 0.0),
                    ("depth", 0.0, 0.0), ("depth", 2.0, 0.99), ("depth", 2.0, 0.99),
                    ("advance", 10.0), ("depth", 0.0, 0.0), ("depth", 0.0, 0.0)]

    async def script(pkg):
        clk = {"t": 0.0}
        cfg = pkg.fleet.FleetConfig(min_workers=1, max_workers=3, up_depth=8.0, down_depth=1.0,
                                    settle_ticks=2, cooldown_s=5.0, refresh_gossip=False)
        async with Fleet(pkg, n=1, fleet_cfg=cfg, clock=lambda: clk["t"]) as f:
            decisions = []
            for step in script_steps:
                if step[0] == "advance":
                    clk["t"] += step[1]
                    continue
                _pressure(f.router, step[1], step[2])
                decisions.append((await f.sup.tick(), len(f.router.backends)))
            ct = await _nist(f.router)
            doc = f.sup.fleetz()
            doc.pop("signals")
            return decisions, _events(f.sup), doc, ct, f.sup.drained_lost

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    decisions, events, doc, ct, lost = port_out
    assert [d for d, _ in decisions[:4]] == ["steady", "pressure", "scaled-up", "cooldown"]
    assert [e["kind"] for e in events] == ["up", "down", "up", "down"]
    assert ct == rp.NIST_CT and lost == 0 and doc["size"] == 1


def test_headroom_policy_decisions_match():
    async def script(pkg):
        clk = {"t": 0.0}
        cfg = pkg.fleet.FleetConfig(min_workers=1, max_workers=2, up_depth=100.0,
                                    settle_ticks=1, cooldown_s=1.0, refresh_gossip=False,
                                    policy="headroom", headroom_frac=0.5)
        async with Fleet(pkg, n=1, fleet_cfg=cfg, clock=lambda: clk["t"]) as f:
            out = []
            _pressure(f.router, 0.0, capacity=100.0)
            out.append(await f.sup.tick())           # primes the offered-load clock
            clk["t"] += 1.0
            f.router.backends["w0"].bytes_out += 16 * 80  # 80 blocks/s offered
            out.append((await f.sup.tick(), len(f.router.backends)))
            sig = dict(f.sup._last_signals)
            return out, sig, [e["kind"] for e in f.sup.events]

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out[0][1] == ("scaled-up", 2)


def test_scale_up_aborts_on_worker_killed_mid_spawn():
    async def script(pkg):
        async with Fleet(pkg, n=1, factory=lambda name: InProcWorkerHandle(
                pkg, name, die_on_start=True)) as f:
            r = await f.sup.scale_up()
            return (r, f.sup.spawn_failures, f.sup.events[-1]["kind"], set(f.router.backends),
                    f.sup.epoch, await _nist(f.router))

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == (None, 1, "spawn-failed", {"w0"}, 1, rp.NIST_CT)


def test_scale_stall_fault_point_aborts_the_event(monkeypatch):
    async def script(pkg):
        async with Fleet(pkg, n=1) as f:
            monkeypatch.setenv("OT_FAULTS", "scale_stall:1")
            pkg.faults.reset()
            first = await f.sup.scale_up()
            ev = dict(f.sup.events[-1])
            second = await f.sup.scale_up()
            return first, f.sup.stalls, ev["kind"], ev.get("seam"), second, await _nist(f.router)

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == (None, 1, "stall", "spawn", "w1", rp.NIST_CT)


def test_worker_slow_start_delays_join_without_rider_impact(monkeypatch):
    async def script(pkg):
        async with Fleet(pkg, n=1) as f:
            monkeypatch.setenv("OT_FAULTS", "worker_slow_start:1")
            monkeypatch.setenv("OT_SLOW_S", "0.08")
            pkg.faults.reset()
            t0 = time.monotonic()
            task = asyncio.ensure_future(f.sup.scale_up())
            mid = await _nist(f.router)
            name = await task
            slow = time.monotonic() - t0 >= 0.08
            return mid, name, slow, sorted(f.router.backends), f.sup.stalls, await _nist(f.router)

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == (rp.NIST_CT, "w1", True, ["w0", "w1"], 0, rp.NIST_CT)


def test_scale_down_drain_loses_nothing_under_load():
    async def script(pkg):
        async with Fleet(pkg, n=2) as f:
            router = f.sup.router
            tasks = [asyncio.ensure_future(router.submit(
                f"t{i}", rp.NIST_KEY, rp.NIST_CTR0, np.frombuffer(rp.NIST_PT, np.uint8)))
                for i in range(24)]
            await asyncio.sleep(0)
            t0 = time.monotonic()
            down = await f.sup.scale_down()
            quick = time.monotonic() - t0 < 4.0
            results = [rp.answer(r) for r in await asyncio.gather(*tasks)]
            st = router.stats()
            return (down, quick, results, len(router.backends), f.sup.drained_lost,
                    f.handles["w1"].drained, f.handles["w1"].killed, st["lost"],
                    st["routed_ok"] == st["answered"])

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    down, quick, results, size, lost, drained, killed, rlost, balanced = port_out
    assert down and quick and size == 1 and lost == 0 and drained and not killed
    assert all(r[0] and r[2] == rp.NIST_CT for r in results) and rlost == 0 and balanced


# ---------------------------------------------------------------------------
# Rolling upgrades.
# ---------------------------------------------------------------------------


def test_roll_one_replaces_exactly_one_worker_bit_exact():
    async def script(pkg):
        async with Fleet(pkg, n=2) as f:
            ok = await f.sup.roll_one()
            return (ok, f.sup.rolled, f.sup.roll_aborts, sorted(f.router.backends),
                    f.handles["w0"].drained, f.sup.drained_lost, _events(f.sup)[-1]["kind"],
                    f.sup.events[-1].get("successor"), await _nist(f.router))

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == (True, 1, 0, ["w1", "w2"], True, 0, "roll", "w2", rp.NIST_CT)


def test_roll_abort_on_canary_mismatch_keeps_old_worker_serving():
    async def script(pkg):
        rigged = []

        def factory(name):
            rigged.append(RiggedCanaryHandle(pkg, name))
            return rigged[-1]

        async with Fleet(pkg, n=1, factory=factory) as f:
            ok = await f.sup.roll_one()
            ev = f.sup.events[-1]
            return (ok, f.sup.roll_aborts, f.sup.rolled, ev["kind"], ev["why"],
                    sorted(f.router.backends), f.handles["w0"].drained, rigged[0].killed,
                    await _nist(f.router))

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == (False, 1, 0, "roll-abort", "mismatch", ["w0"], False, True, rp.NIST_CT)


# ---------------------------------------------------------------------------
# The replicated router tier.
# ---------------------------------------------------------------------------


def test_gossip_view_adoption_converges_replica_ring():
    async def script(pkg):
        async with Fleet(pkg, n=2) as f:
            server = pkg.fleet.RouterServer(f.router, view_fn=lambda: (f.sup.epoch, f.sup.view()))
            await server.start()
            w0 = f.router.backends["w0"].spec
            replica = pkg.Router([pkg.BackendSpec("w0", w0.host, w0.port, w0.status_port)],
                                 pkg.RouterConfig(gossip_every_s=0.0, attempt_timeout_s=2.0))
            await replica.start()
            doc = await pkg.fleet.gossip_exchange("127.0.0.1", server.port, 0)
            res = await pkg.fleet.adopt_view(replica, doc)
            converged = (replica.ring.digest() == f.router.ring.digest() == doc["ring"])
            ct = await _nist(replica)
            f.router.backends["w1"].health.note_gossip("draining")
            doc2 = await pkg.fleet.gossip_exchange("127.0.0.1", server.port, 0)
            await pkg.fleet.adopt_view(replica, doc2)
            flags = (replica.backends["w1"].health.draining,
                     replica.backends["w1"].health.placeable())
            await replica.stop()
            await server.stop()
            view = rp.masked({**doc, "members": [{k: v for k, v in m.items()
                                                  if k not in ("port", "status_port")}
                                                 for m in doc["members"]]})
            return doc["epoch"] == f.sup.epoch, res, converged, ct, flags, server.gossip_frames, view

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out[:6] == (True, {"joined": ["w1"], "left": []}, True, rp.NIST_CT,
                            (True, False), 2)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_gossip_view_written_by_either_package_is_adopted_by_the_other(writer, reader):
    """The owner's view document crosses packages: a replica router of the
    other package adopts it (joins re-proved by its own canary) and reaches
    the owner's ring digest."""
    pk = {"jax": rp.JAX, "port": rp.PORT}
    w, r = pk[writer], pk[reader]

    async def main():
        async with Fleet(w, n=2) as f:
            server = w.fleet.RouterServer(f.router, view_fn=lambda: (f.sup.epoch, f.sup.view()))
            await server.start()
            w0 = f.router.backends["w0"].spec
            replica = r.Router([r.BackendSpec("w0", w0.host, w0.port, w0.status_port)],
                               r.RouterConfig(gossip_every_s=0.0, attempt_timeout_s=2.0))
            await replica.start()
            doc = await r.fleet.gossip_exchange("127.0.0.1", server.port, 0)
            res = await r.fleet.adopt_view(replica, doc)
            assert res == {"joined": ["w1"], "left": []}
            assert replica.ring.digest() == f.router.ring.digest() == doc["ring"]
            assert await _nist(replica) == rp.NIST_CT
            await replica.stop()
            await server.stop()

    asyncio.run(main())


def test_router_killed_mid_drive_fails_over_bit_exact_zero_lost():
    async def script(pkg):
        async with Fleet(pkg, n=2) as f:
            specs = [b.spec for b in f.router.backends.values()]
            other = pkg.Router([pkg.BackendSpec(s.name, s.host, s.port, s.status_port)
                                for s in specs],
                               pkg.RouterConfig(gossip_every_s=0.0, attempt_timeout_s=2.0))
            await other.start()
            srv_a, srv_b = pkg.fleet.RouterServer(f.router), pkg.fleet.RouterServer(other)
            await srv_a.start()
            await srv_b.start()
            client = pkg.fleet.FailoverClient([("127.0.0.1", srv_a.port),
                                               ("127.0.0.1", srv_b.port)], attempt_timeout_s=2.0)
            cts = [await _nist(client, tenant=f"t{i}") for i in range(6)]
            srv_a.abort()
            cts += [await _nist(client, tenant=f"t{i}") for i in range(6, 12)]
            lost = [r.stats()["lost"] for r in (f.router, other)]
            out = (cts, client.failovers >= 1, client.submitted,
                   pkg.metrics.counter_total("route_client_failover") >= 1, lost)
            await srv_b.stop()
            await other.stop()
            return out

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == ([rp.NIST_CT] * 12, True, 12, True, [0, 0])


def test_failover_client_error_only_when_whole_tier_dead():
    async def script(pkg):
        client = pkg.fleet.FailoverClient([("127.0.0.1", 1), ("127.0.0.1", 1)],
                                          attempt_timeout_s=0.2, deadline_s=1.0)
        resp = await client.submit("t0", rp.NIST_KEY, rp.NIST_CTR0,
                                   np.frombuffer(rp.NIST_PT, np.uint8))
        return resp.ok, resp.error, "no router peer answered" in resp.detail, client.failovers >= 2

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out[0] is False and port_out[2] and port_out[3]


# ---------------------------------------------------------------------------
# The pooled transport.
# ---------------------------------------------------------------------------


def test_pool_reuses_connections_and_stale_socket_rides_ring_retry(monkeypatch):
    async def script(pkg):
        async with Fleet(pkg, n=2) as f:
            router = f.router
            for i in range(8):
                await _nist(router, tenant=f"t{i}")
            hits = sum(b.pool_hits for b in router.backends.values())
            dials = sum(b.pool_dials for b in router.backends.values())
            monkeypatch.setenv("OT_FAULTS", "pool_stale:1")
            pkg.faults.reset()
            before = router.redispatches
            ct = await _nist(router, tenant="t0")
            st = router.stats()
            return (hits, dials, ct, router.redispatches - before, st["lost"],
                    sorted(router.backends["w0"].stats()["pool"]))

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    hits, dials, ct, redispatched, lost, pool_keys = port_out
    assert hits >= 6 and dials <= 4 and ct == rp.NIST_CT and redispatched == 1 and lost == 0
    assert pool_keys == ["dials", "hits", "idle", "stale"]


def test_pool_survives_backend_restart_via_reconnect():
    async def script(pkg):
        async with Fleet(pkg, n=1) as f:
            first = await _nist(f.router)
            b = f.router.backends["w0"]
            for _reader, writer in list(b._pool):
                writer.transport.abort()
            await asyncio.sleep(0.05)
            cts = [await _nist(f.router, tenant=f"t{i}") for i in range(4)]
            st = f.router.stats()
            return first, cts, st["lost"], st["routed_ok"] == st["answered"]

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == (rp.NIST_CT, [rp.NIST_CT] * 4, 0, True)


# ---------------------------------------------------------------------------
# /fleetz and the entry points.
# ---------------------------------------------------------------------------


def test_fleetz_endpoint_serves_supervisor_doc():
    async def script(pkg):
        async with Fleet(pkg, n=1) as f:
            status = pkg.RouterStatus(f.router, 0, fleet=f.sup)
            await status.start()
            head, body = await rp.http_get(status.port, "/fleetz")
            bare = pkg.RouterStatus(f.router, 0)
            await bare.start()
            bhead, bbody = await rp.http_get(bare.port, "/fleetz")
            await bare.stop()
            await status.stop()
            doc = __import__("json").loads(body)
            doc.pop("signals")
            return head.split(b"\r\n")[0], rp.masked(doc), bhead.split(b"\r\n")[0], bbody

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    head, doc, bhead, _ = port_out
    assert head.startswith(b"HTTP/1.1 200") and doc["size"] == 1 and doc["owned"] == ["w0"]
    assert bhead.startswith(b"HTTP/1.1 404")


def test_worker_argv_names_the_port_worker_and_its_device():
    argv = rp.fleet.worker_argv(engine="ttable", bucket_min=32, bucket_max=256, lanes=1)
    assert argv[1:3] == ["-m", "our_tree_tpu_torch.serve.worker"]
    assert argv[argv.index("--device") + 1] == "cuda"
    assert argv[argv.index("--engine") + 1] == "ttable"
    assert argv[argv.index("--lanes") + 1] == "1"
    cpu = rp.fleet.worker_argv(device="cpu")
    assert cpu[cpu.index("--device") + 1] == "cpu"
    # Everything else is the JAX template's, flag for flag.
    ref = rp.jfleet.worker_argv(engine="ttable", bucket_min=32, bucket_max=256, lanes=1)
    mine = [a for i, a in enumerate(argv) if a != "--device" and argv[i - 1] != "--device"]
    assert mine[3:] == ref[3:]


def test_process_handle_spawn_runs_off_the_event_loop(monkeypatch):
    seen = {}

    class FakeChild:
        def read_line(self, deadline):
            return ""

    def fake_spawn(argv, env=None, name=""):
        seen["thread"] = threading.current_thread()
        return FakeChild()

    monkeypatch.setattr(rp.fleet.isolate, "spawn_service", fake_spawn)
    handle = rp.fleet.ProcessWorkerHandle("w0", ["prog"], ready_deadline_s=1.0)

    async def drive():
        seen["loop_thread"] = threading.current_thread()
        return await handle.start()

    assert asyncio.run(drive()) is None
    assert seen["thread"] is not seen["loop_thread"]


def test_replica_entry_module_shape():
    assert rp.fleet.REPLICA_KIND == rp.jfleet.REPLICA_KIND == "ot-route-replica"
    assert rp.fleet.REPLICA_EXIT_KIND == rp.jfleet.REPLICA_EXIT_KIND == "ot-route-replica-exit"
    assert callable(rp.fleet.main)
