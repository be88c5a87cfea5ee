"""The port's router (``our_tree_tpu_torch.route``) held against the JAX
package's, as ``tests/test_route.py`` holds the JAX one. Each case runs one
script through the JAX router over JAX servers and through the port's router
over port servers on the CPU (``route_pair.Cluster``: three servers on the
32-256 block ladder, each behind its frontend), and asserts equal answers
(each equal to the NIST KAT or the plain AES), the back end that served each
request, health transitions, the quarantine and release counts, the
``stats()`` keys, the ``/healthz`` membership view and the trace evidence:

* NIST F.5.1 through the router, both ways; affinity and the seeded-random
  control arm's dispatch tables; the GCM KATs sealed and opened through the
  port's router with a scoped ``backend_fail`` failover;
* ``backend_fail`` and ``backend_hang`` at the backend seam, the quarantine,
  gossip, canary, probation and release cycle (one orphaned
  ``route-dispatch`` span), the rescue canary of a lone quarantined back end;
* shed backpressure and the router's shed, a joiner whose canary mismatches,
  minimal-motion membership changes, drain, the router's ``/healthz``;
* the journal's ``backend:<name>`` rows adopted across a restart and
  released by ``route.bench --unquarantine``, and a journal written by either
  package adopted by the other's router;
* the frontend's wire containment;
* crossed: the port's router in front of JAX frontends and the JAX router in
  front of port frontends give the same bytes;
* no module of ``our_tree_tpu_torch/route`` imports torch, JAX or the JAX
  package; ``route.bench``'s options are the JAX bench's plus ``--device``;
  the bench run in a process with two CPU workers writes nothing into the
  repo without ``--artifact``.

Bytes and counts are exact: no tolerance.
"""

import ast
import asyncio
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import route_pair as rp
from our_tree_tpu.serve.queue import ERR_SHED as JERR_SHED
from our_tree_tpu_torch.models.aes import AES
from our_tree_tpu_torch.serve.queue import ERR_SHED

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("OT_FAULTS", raising=False)
    monkeypatch.delenv("OT_DISPATCH_DEADLINE", raising=False)
    monkeypatch.delenv("OT_TRACE_DIR", raising=False)
    rp.reset_state()
    yield
    monkeypatch.delenv("OT_FAULTS", raising=False)
    rp.reset_state()


def _traced(pkg, base, monkeypatch):
    """Trace this package's run into a directory of its own."""
    monkeypatch.setenv("OT_TRACE_DIR", str(base / pkg.name))
    monkeypatch.setenv("OT_TRACE_RUN", "t-route")
    monkeypatch.delenv("OT_TRACE_PARENT", raising=False)
    for p in rp.PKGS:
        p.trace.reset_for_tests()
    return base / pkg.name / "t-route"


def _arm(pkg, monkeypatch, spec):
    monkeypatch.setenv("OT_FAULTS", spec)
    pkg.faults.reset()


def _plain_ctr(key, nonce, pt) -> bytes:
    ct, *_ = AES(key, device="cpu").crypt_ctr(
        0, np.frombuffer(nonce, np.uint8).copy(), np.zeros(16, np.uint8),
        np.frombuffer(pt, np.uint8))
    return bytes(np.asarray(ct, np.uint8))


# ---------------------------------------------------------------------------
# Bit-exactness and affinity.
# ---------------------------------------------------------------------------


def test_router_end_to_end_bit_exact_nist_kat():
    async def script(pkg):
        async with rp.Cluster(pkg, n=3) as c:
            pt = np.frombuffer(rp.NIST_PT, np.uint8)
            resp, by = await rp.served(c.router, c.router.submit("t0", rp.NIST_KEY, rp.NIST_CTR0, pt))
            back, by2 = await rp.served(c.router, c.router.submit(
                "t0", rp.NIST_KEY, rp.NIST_CTR0, np.asarray(resp.payload)))
            st = c.router.stats()
            return rp.answer(resp), by, rp.answer(back), by2, st["lost"], rp.shape(st)

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out[0][2] == rp.NIST_CT and port_out[2][2] == rp.NIST_PT
    assert port_out[4] == 0


def test_affinity_same_key_lands_one_backend_control_spreads():
    async def script(pkg):
        key, nonce = b"\x01" * 16, b"\x02" * 16
        pt = np.zeros(64, np.uint8)
        async with rp.Cluster(pkg, n=3) as c:
            homes = []
            for _ in range(3):
                for t in range(12):
                    resp, by = await rp.served(c.router, c.router.submit(f"t{t}", key, nonce, pt))
                    assert resp.ok
                    homes.append(by)
            st = c.router.stats()
            arm = (homes, st["affinity"], rp.dispatches(c.router))
        async with rp.Cluster(pkg, n=3, router_kw=dict(affinity=False, seed=3)) as c:
            order = []
            for _ in range(12):
                resp, by = await rp.served(c.router, c.router.submit("t0", key, nonce, pt))
                order.append((by, rp.answer(resp)))
            ctl = (order, rp.dispatches(c.router))
        return arm, ctl

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    (homes, aff, table), (order, ctl_table) = port_out
    assert aff["ratio"] == 1.0 and len({h for h in homes}) >= 2
    assert sum(1 for n in ctl_table.values() if n) >= 2  # one tenant, many back ends
    assert all(a[2] == _plain_ctr(b"\x01" * 16, b"\x02" * 16, bytes(64)) for _, a in order)


def test_router_gcm_kat_seal_open_affinity_and_failover(monkeypatch):
    kats = [k for k in json.loads((ROOT / "tests" / "golden" / "gcm_kats.json").read_text())["kats"]
            if len(k["iv"]) == 24 and k["ct"] and len(k["ct"]) % 32 == 0 and len(k["key"]) == 32]
    assert kats

    async def main():
        async with rp.Cluster(rp.PORT, n=3, server_kw=dict(modes=("ctr", "gcm", "gcm-open"))) as c:
            for k in kats:
                key, iv, aad = (bytes.fromhex(k[f]) for f in ("key", "iv", "aad"))
                seal = await c.router.submit("t0", key, b"", np.frombuffer(bytes.fromhex(k["pt"]),
                                                                           np.uint8),
                                             mode="gcm", iv=iv, aad=aad)
                assert seal.ok, (k["name"], seal.error, seal.detail)
                assert bytes(np.asarray(seal.payload)).hex() == k["ct"]
                assert seal.tag.hex() == k["tag"]
                opened = await c.router.submit("t0", key, b"",
                                               np.frombuffer(bytes.fromhex(k["ct"]), np.uint8),
                                               mode="gcm-open", iv=iv, aad=aad,
                                               tag=bytes.fromhex(k["tag"]))
                assert opened.ok and bytes(np.asarray(opened.payload)).hex() == k["pt"]
            k = kats[0]
            bad = await c.router.submit("t0", bytes.fromhex(k["key"]), b"",
                                        np.frombuffer(bytes.fromhex(k["ct"]), np.uint8),
                                        mode="gcm-open", iv=bytes.fromhex(k["iv"]),
                                        aad=bytes.fromhex(k["aad"]), tag=b"\x00" * 16)
            assert not bad.ok and bad.error == "auth-failed"
            assert c.router.stats()["affinity"]["ratio"] == 1.0
            k = kats[-1]
            key = bytes.fromhex(k["key"])
            tenant = rp.tenant_for(c.router, rp.ring, "b1", key)
            _arm(rp.PORT, monkeypatch, "backend_fail:1@backend=1")
            seal = await c.router.submit(tenant, key, b"",
                                         np.frombuffer(bytes.fromhex(k["pt"]), np.uint8),
                                         mode="gcm", iv=bytes.fromhex(k["iv"]),
                                         aad=bytes.fromhex(k["aad"]))
            assert seal.ok and bytes(np.asarray(seal.payload)).hex() == k["ct"]
            assert seal.tag.hex() == k["tag"]
            st = c.router.stats()
            assert st["redispatches"] == 1 and st["lost"] == 0

    asyncio.run(main())


# ---------------------------------------------------------------------------
# The fault matrix at the backend seam.
# ---------------------------------------------------------------------------


def test_backend_fail_scoped_redispatch_bit_exact(monkeypatch):
    async def script(pkg):
        async with rp.Cluster(pkg, n=3) as c:
            tenant = rp.tenant_for(c.router, pkg.ring, "b1", rp.NIST_KEY)
            _arm(pkg, monkeypatch, "backend_fail:1@backend=1")
            resp, by = await rp.served(c.router, c.router.submit(
                tenant, rp.NIST_KEY, rp.NIST_CTR0, np.frombuffer(rp.NIST_PT, np.uint8)))
            st = c.router.stats()
            return (rp.answer(resp), by, st["redispatches"], rp.transitions(c.router),
                    {n: b["failures"] for n, b in st["backends"].items()}, st["lost"])

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out[0][2] == rp.NIST_CT and port_out[2] == 1
    assert port_out[3]["b1"] == [("healthy", "suspect", "ConnectionError")] or \
        port_out[3]["b1"][0][:2] == ("healthy", "suspect")
    assert port_out[4] == {"b0": 0, "b1": 1, "b2": 0}


def test_backend_hang_quarantine_gossip_release_cycle(monkeypatch, tmp_path):
    async def script(pkg):
        run_dir = _traced(pkg, tmp_path, monkeypatch)
        async with rp.Cluster(pkg, n=3) as c:
            tenant = rp.tenant_for(c.router, pkg.ring, "b1", rp.NIST_KEY)
            _arm(pkg, monkeypatch, "backend_hang:1@backend=1")
            c.router.config.attempt_timeout_s = 0.5
            pt = np.frombuffer(rp.NIST_PT, np.uint8)
            resp, by = await rp.served(c.router, c.router.submit(tenant, rp.NIST_KEY,
                                                                 rp.NIST_CTR0, pt))
            states = [c.router.backends["b1"].health.state]
            q = (c.router.redispatches, c.router.quarantine_events(),
                 "quarantined:backend:b1" in pkg.degrade.events())
            await c.router.gossip_once()
            states.append(c.router.backends["b1"].health.state)
            later = []
            for _ in range(4):
                r, b = await rp.served(c.router, c.router.submit(tenant, rp.NIST_KEY,
                                                                 rp.NIST_CTR0, pt))
                later.append((rp.answer(r), b))
            states.append(c.router.backends["b1"].health.state)
            out = (rp.answer(resp), by, states, q, later, c.router.release_events(),
                   rp.transitions(c.router), c.router.stats()["lost"])
        pkg.trace.reset_for_tests()
        run = pkg.export.load_run(str(run_dir))
        orphans = [(s.name, str(s.attrs.get("backend"))) for s in run.orphans()]
        return out, orphans

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    (ans, _by, states, q, _later, releases, trans, lost), orphans = port_out
    assert ans[2] == rp.NIST_CT and lost == 0 and releases == 1
    assert states == ["quarantined", "probation", "healthy"] and q == (1, 1, True)
    assert [t[1] for t in trans["b1"]] == ["quarantined", "probation", "released", "healthy"]
    assert orphans == [("route-dispatch", "1")]


def test_rescue_canaries_quarantined_backend_when_none_placeable(monkeypatch):
    async def script(pkg):
        async with rp.Cluster(pkg, n=1) as c:
            _arm(pkg, monkeypatch, "backend_hang:1@backend=0")
            c.router.config.attempt_timeout_s = 0.5
            pt = np.zeros(64, np.uint8)
            r1 = await c.router.submit("t0", b"\x01" * 16, b"\x02" * 16, pt)
            q = c.router.quarantine_events()
            r2 = await c.router.submit("t0", b"\x01" * 16, b"\x02" * 16, pt)
            return (r1.ok, r1.error, q, rp.answer(r2), c.router.backends["b0"].health.state,
                    c.router.stats()["lost"])

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out[:3] == (False, "deadline", 1) and port_out[3][0]
    assert port_out[4] == "probation" and port_out[5] == 0


# ---------------------------------------------------------------------------
# Backpressure and joins over fake back ends.
# ---------------------------------------------------------------------------


def test_shed_propagates_retry_then_router_shed():
    async def script(pkg):
        shed_code = JERR_SHED if pkg is rp.JAX else ERR_SHED

        def echo_or_shed(h, p):
            if h.get("t") == "_canary":
                return {"ok": True}, p
            return {"ok": False, "error": shed_code, "detail": "full"}, b""

        s1, p1 = await rp.fake_backend(pkg, echo_or_shed)
        s2, p2 = await rp.fake_backend(pkg, echo_or_shed)
        router = pkg.Router([pkg.BackendSpec("b0", "127.0.0.1", p1),
                             pkg.BackendSpec("b1", "127.0.0.1", p2)],
                            pkg.RouterConfig(gossip_every_s=0.0, attempt_timeout_s=1.0,
                                             shed_backoff_s=0.001))
        await router.start()
        resp = await router.submit("t0", b"\x01" * 16, b"\x02" * 16, np.zeros(64, np.uint8))
        st = router.stats()
        out = (resp.error, st["shed_retries"], st["router_sheds"],
               {n: b["state"] for n, b in st["backends"].items()},
               "route->shed" in pkg.degrade.events())
        await router.stop()
        s1.close()
        s2.close()
        return out

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out[0] == ERR_SHED and port_out[1] >= 1 and port_out[2] == 1
    assert set(port_out[3].values()) == {"healthy"} and port_out[4]


def test_join_canary_mismatch_quarantines_new_backend():
    async def script(pkg):
        s1, p1 = await rp.fake_backend(pkg, lambda h, p: ({"ok": True}, p))
        s2, p2 = await rp.fake_backend(pkg, lambda h, p: ({"ok": True}, b"\xff" * len(p)))
        router = pkg.Router([pkg.BackendSpec("b0", "127.0.0.1", p1)],
                            pkg.RouterConfig(gossip_every_s=0.0, attempt_timeout_s=1.0))
        await router.start()
        await router.add_backend(pkg.BackendSpec("b1", "127.0.0.1", p2))
        out = (rp.transitions(router), "quarantined:backend:b1" in pkg.degrade.events())
        await router.stop()
        s1.close()
        s2.close()
        return out

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out[0]["b1"] == [("healthy", "quarantined", "canary-mismatch")] and port_out[1]


# ---------------------------------------------------------------------------
# Membership, drain, status, journal.
# ---------------------------------------------------------------------------


def test_membership_change_traces_minimal_motion(monkeypatch, tmp_path):
    async def script(pkg):
        run_dir = _traced(pkg, tmp_path, monkeypatch)
        srvs, specs = [], []
        for i in range(3):
            s, p = await rp.fake_backend(pkg, lambda h, p: ({"ok": True}, p))
            srvs.append(s)
            specs.append(pkg.BackendSpec(f"b{i}", "127.0.0.1", p))
        router = pkg.Router(specs[:2], pkg.RouterConfig(gossip_every_s=0.0,
                                                        attempt_timeout_s=1.0))
        await router.start()
        for t in range(40):
            await router.submit(f"t{t}", b"\x01" * 16, b"\x02" * 16, np.zeros(16, np.uint8))
        await router.add_backend(specs[2])
        members = list(router.ring.members())
        router.remove_backend("b2")
        changes = router.ring_changes
        await router.stop()
        for s in srvs:
            s.close()
        pkg.trace.reset_for_tests()
        run = pkg.export.load_run(str(run_dir))
        rebal = [{k: p["attrs"][k] for k in ("action", "member", "moved", "tracked", "members")}
                 for p in run.points("ring-rebalance")]
        return members, changes, rebal

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    members, changes, rebal = port_out
    assert members == ["b0", "b1", "b2"] and changes == 2
    assert [a["action"] for a in rebal] == ["join", "leave"]
    assert rebal[0]["tracked"] == 40 and 0 < rebal[0]["moved"] <= 40 * 0.6


def test_drain_answers_everything_and_refuses_new(monkeypatch, tmp_path):
    async def script(pkg):
        run_dir = _traced(pkg, tmp_path, monkeypatch)
        async with rp.Cluster(pkg, n=2) as c:
            pt = np.zeros(1024, np.uint8)
            pending = [asyncio.ensure_future(c.router.submit(f"t{i}", b"\x01" * 16, b"\x02" * 16,
                                                             pt)) for i in range(16)]
            stop = asyncio.ensure_future(c.router.stop())
            done = await asyncio.gather(*pending)
            await stop
            late = await c.router.submit("tx", b"\x01" * 16, b"\x02" * 16, pt)
            out = ([rp.answer(r) for r in done], c.router.accepted, c.router.answered, late.error)
        pkg.trace.reset_for_tests()
        drained = pkg.export.load_run(str(run_dir)).points("route-drained")
        return out, drained[-1]["attrs"]["lost"]

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    (answers, accepted, answered, late), lost = port_out
    assert all(a[0] for a in answers) and accepted == answered == 16
    assert late == "shutdown" and lost == 0
    assert answers[0][2] == _plain_ctr(b"\x01" * 16, b"\x02" * 16, bytes(1024))


def test_router_healthz_membership_view_and_draining():
    async def script(pkg):
        async with rp.Cluster(pkg, n=2) as c:
            st = pkg.RouterStatus(c.router, 0)
            await st.start()
            for t in range(8):
                await c.router.submit(f"t{t}", b"\x01" * 16, b"\x02" * 16, np.zeros(16, np.uint8))
            head, body = await rp.http_get(st.port, "/healthz")
            doc = json.loads(body)
            mhead, mbody = await rp.http_get(st.port, "/metrics")
            fhead, fbody = await rp.http_get(st.port, "/fleetz")
            await c.router.stop()
            _, body2 = await rp.http_get(st.port, "/healthz")
            await st.stop()
            return (head.split(b"\r\n")[0], rp.masked(doc), mhead.split(b"\r\n")[0],
                    b"route_affinity" in mbody, fhead.split(b"\r\n")[0], fbody,
                    json.loads(body2)["status"])

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    head, doc, mhead, has_aff, fhead, fbody, draining = port_out
    assert head.startswith(b"HTTP/1.1 200") and doc["status"] == "ok"
    assert doc["ring"]["members"] == ["b0", "b1"] and doc["ring"]["tracked_keys"] == 8
    assert sum(doc["ring"]["placement"].values()) == 8
    assert mhead.startswith(b"HTTP/1.1 200") and has_aff
    assert fhead.startswith(b"HTTP/1.1 404") and draining == "draining"


def test_journal_quarantine_persists_and_unquarantine(monkeypatch, tmp_path, capsys):
    jpath = str(tmp_path / "route.journal")

    async def phase1():
        async with rp.Cluster(rp.PORT, n=2, router_kw=dict(journal=jpath)) as c:
            tenant = rp.tenant_for(c.router, rp.ring, "b1", b"\x01" * 16)
            _arm(rp.PORT, monkeypatch, "backend_hang:1@backend=1")
            c.router.config.attempt_timeout_s = 0.5
            resp = await c.router.submit(tenant, b"\x01" * 16, b"\x02" * 16,
                                         np.zeros(64, np.uint8))
            assert resp.ok
            assert c.router.backends["b1"].health.state == rp.health.QUARANTINED

    async def restart(pkg):
        async with rp.Cluster(pkg, n=2, router_kw=dict(journal=jpath)) as c:
            return c.router.backends["b1"].health.state, rp.transitions(c.router)["b1"]

    asyncio.run(phase1())
    monkeypatch.delenv("OT_FAULTS")
    rp.reset_state()
    state, trans = asyncio.run(restart(rp.PORT))
    assert state == rp.health.QUARANTINED and trans == [("healthy", "quarantined", "journal:1")]
    # The JAX router adopts the port's journal row as its own.
    assert asyncio.run(restart(rp.JAX)) == (state, trans)
    assert rp.route_bench.main(["--journal", jpath, "--unquarantine", "backend:b1"]) == 0
    assert "cleared 1 failure row(s)" in capsys.readouterr().out
    assert asyncio.run(restart(rp.PORT))[0] == rp.health.HEALTHY


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_rows_cross_packages(tmp_path, writer, reader):
    """A journal's ``backend:<name>`` failure row written by either package's
    router health machine is the other's: the same file bytes, adopted as a
    quarantine, released by the other's ``--unquarantine``."""
    pk = {"jax": rp.JAX, "port": rp.PORT}
    w, r = pk[writer], pk[reader]
    paths = {}
    for p in rp.PKGS:
        path = str(tmp_path / f"{p.name}.journal")
        j = p.journal.SweepJournal(path, {"kind": "route-backends", "members": ["b0", "b1"]})
        h = p.health.BackendHealth(1, "b1", journal=j)
        h.note_timeout()
        j.close()
        paths[p.name] = path
    strip = [{k: v for k, v in json.loads(line).items() if k not in ("t", "ts", "time")}
             for p in rp.PKGS for line in open(paths[p.name])]
    half = len(strip) // 2
    assert strip[:half] == strip[half:]

    async def adopt(pkg, path):
        async with rp.Cluster(pkg, n=2, router_kw=dict(journal=path)) as c:
            return rp.transitions(c.router)

    got = asyncio.run(adopt(r, paths[writer]))
    assert got["b1"] == [("healthy", "quarantined", "journal:1")] and got["b0"] == []
    assert r.journal.clear_failures(paths[writer], ["backend:b1"]) == {"backend:b1": 1}
    assert asyncio.run(adopt(w, paths[writer]))["b1"] == []


def test_frontend_refuses_torn_and_oversized_frames():
    async def script(pkg):
        s = rp.new_server(pkg)
        await s.start()
        f = pkg.RequestFrontend(s, 0)
        await f.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", f.port)
        writer.write(b"x" * (pkg.wire.MAX_HEADER + 10) + b"\n")
        await writer.drain()
        bad = await pkg.wire.read_frame(reader)
        writer.close()
        reader, writer = await asyncio.open_connection("127.0.0.1", f.port)
        writer.write(pkg.wire.encode_frame({"t": "t0", "k": (b"\x01" * 16).hex(),
                                            "n": (b"\x02" * 16).hex()}, b"\x00" * 64))
        await writer.drain()
        h, body = await pkg.wire.read_frame(reader)
        writer.close()
        errors = f.protocol_errors
        s.queue.close()
        await f.stop()
        await s.stop()
        return bad[0]["ok"], bad[0].get("error"), h["ok"], body, errors

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out[0] is False and port_out[2] and port_out[4] == 1
    assert port_out[3] == _plain_ctr(b"\x01" * 16, b"\x02" * 16, bytes(64))


# ---------------------------------------------------------------------------
# Across packages, and the package's own rules.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
def test_router_serves_the_other_packages_frontends_bit_exact(router_pkg, server_pkg):
    pk = {"jax": rp.JAX, "port": rp.PORT}
    rng = np.random.default_rng(11)
    script_reqs = [(f"t{int(rng.integers(6))}", rng.bytes(16), rng.bytes(16),
                    rng.bytes(int(rng.choice([16, 64, 256, 1024, 4096]))))
                   for _ in range(24)]

    async def run(pkg, spkg):
        async with rp.Cluster(pkg, n=3, servers=spkg) as c:
            out = []
            for t, k, n, p in script_reqs:
                resp, by = await rp.served(c.router, c.router.submit(t, k, n,
                                                                     np.frombuffer(p, np.uint8)))
                out.append((rp.answer(resp), by))
            return out, c.router.stats()["lost"]

    crossed = asyncio.run(run(pk[router_pkg], pk[server_pkg]))
    rp.reset_state()
    same = asyncio.run(run(pk[router_pkg], pk[router_pkg]))
    assert crossed == same and crossed[1] == 0
    for (t, k, n, p), ((ok, _err, payload, _tag), _by) in zip(script_reqs, crossed[0]):
        assert ok and payload == _plain_ctr(k, n, p)


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_route_modules_import_no_device_package():
    mods = sorted((ROOT / "our_tree_tpu_torch" / "route").glob("*.py"))
    assert {m.stem for m in mods} >= {"__init__", "ring", "health", "proxy", "status", "fleet",
                                      "bench"}
    for m in mods:
        bad = {n for n in _imports(m)
               if n.split(".")[0] in ("torch", "jax", "jaxlib", "our_tree_tpu")}
        assert not bad, (m.name, bad)
    # The router's modules load no torch at all (the bench's load generator
    # does, for its CPU reference).
    code = ("import sys; import our_tree_tpu_torch.route.proxy, our_tree_tpu_torch.route.status, "
            "our_tree_tpu_torch.route.fleet; print('torch' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.stdout.split() == ["False", "False"], out.stderr


def _options(main, capsys) -> set:
    with pytest.raises(SystemExit):
        main(["--help"])
    text = capsys.readouterr().out
    import re
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z0-9-]*)", text))


def test_bench_options_are_the_references_plus_device(capsys):
    port = _options(rp.route_bench.main, capsys)
    ref = _options(rp.jroute_bench.main, capsys)
    assert port == ref | {"--device"}


def test_bench_in_a_process_writes_nothing_without_artifact(tmp_path):
    before = set(os.listdir(ROOT))
    cmd = [sys.executable, "-m", "our_tree_tpu_torch.route.bench", "--device", "cpu",
           "--backends", "2", "--requests", "40", "--bucket-max", "256", "--sizes",
           "16,256,1024", "--tenants", "4"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["lost"] == 0 and line["mismatches"] == 0 and line["ok"] == 40
    assert line["router_cuda_initialized"] is False
    assert set(os.listdir(ROOT)) == before
    assert "# artifact:" not in out.stderr


def test_bench_artifact_carries_the_workers_exit_lines(tmp_path):
    before = set(os.listdir(ROOT))
    art = tmp_path / "route.json"
    cmd = [sys.executable, "-m", "our_tree_tpu_torch.route.bench", "--device", "cpu",
           "--backends", "2", "--requests", "20", "--bucket-max", "256", "--sizes", "16,256",
           "--tenants", "2", "--artifact", str(art)]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(art.read_text())
    assert doc["config"]["device"] == "cpu" and len(doc["workers"]) == 2
    assert all("diag_launches" in w and "diag_engine_calls" in w for w in doc["workers"])
    assert set(os.listdir(ROOT)) == before


def test_spawn_service_matches_reference():
    """``resilience.isolate.spawn_service``, the seam ``route.bench`` and
    ``route.fleet`` spawn workers through: the READY line read within its
    deadline, a silent child's deadline, SIGTERM then the rc, a SIGKILL, and
    the output drained after exit, as the JAX package's."""
    from our_tree_tpu.resilience import isolate as jisolate
    from our_tree_tpu_torch.resilience import isolate

    talk = [sys.executable, "-c",
            "import sys, time; sys.stdout.write('READY\\nmore\\n'); sys.stdout.flush(); "
            "time.sleep(60)"]
    silent = [sys.executable, "-c", "import time; time.sleep(60)"]
    out = []
    for mod in (jisolate, isolate):
        h = mod.spawn_service(talk, name="svc")
        first = h.read_line(30.0)
        alive = h.alive()
        rc = h.stop(term_deadline_s=10.0)
        rest, _err = h.drain_output()
        s = mod.spawn_service(silent, name="quiet")
        none = s.read_line(0.3)
        krc = s.kill()
        out.append((first, alive, rc, rest.strip(), none, krc, h.name, h.alive()))
    assert out[1] == out[0] == ("READY", True, -15, "more", None, -9, "svc", False)
