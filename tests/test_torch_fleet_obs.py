"""The routing tier's observability in the port, held against the JAX
package's, as ``tests/test_fleet_obs.py`` holds the JAX one:

* ``route.bench.waterfall_stats`` equal in both packages on the same ledgers
  (complete ones from a JAX fleet, incomplete and malformed ones made from a
  numpy seed); the port's router assembling complete waterfalls in front of
  JAX frontends (whose answers carry the per-request ledger ``lg``), and the
  router's own stages over port frontends (which send none), as the JAX
  router does over them;
* the head-sampling decision carried over the wire (``OT_TRACE_SAMPLE=0``:
  no ledgers, no request spans), the cross-process parentage of the
  workers' ``request-queued`` spans under the router's ``route-request``
  roots, and the clock-skew handshake;
* ``fleet_join_stats`` and ``relabel_prometheus`` equal across packages;
* the federated ``/metrics`` (``ot_route_federate_up``), ``/alertz`` and
  ``/profilez`` relays, ``/healthz`` with quarantined and probation states,
  the endpoint's containment of malformed requests;
* the Chrome trace aligned by the ``wire-skew`` points.

Counts and documents are exact; the stage sums are within the bench's 5 %.
"""

import asyncio
import json
import os

import numpy as np
import pytest

import route_pair as rp
from our_tree_tpu.obs.report import fleet_join_stats as jfleet_join_stats
from our_tree_tpu_torch.obs.report import fleet_join_stats


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("OT_FAULTS", "OT_DISPATCH_DEADLINE", "OT_TRACE_DIR", "OT_TRACE_SAMPLE"):
        monkeypatch.delenv(var, raising=False)
    rp.reset_state()
    yield
    rp.reset_state()


def _traced(pkg, base, monkeypatch, run="t-fleet"):
    monkeypatch.setenv("OT_TRACE_DIR", str(base / pkg.name))
    monkeypatch.setenv("OT_TRACE_RUN", run)
    monkeypatch.delenv("OT_TRACE_PARENT", raising=False)
    for p in rp.PKGS:
        p.trace.reset_for_tests()
    return base / pkg.name / run


async def _ledgers(pkg, servers, n=12, size=2048):
    async with rp.Cluster(pkg, n=2, servers=servers) as c:
        out = []
        for t in range(n):
            resp = await c.router.submit(f"t{t}", b"\x01" * 16, b"\x02" * 16,
                                         np.zeros(size, np.uint8))
            assert resp.ok
            out.append(resp.ledger)
        b0 = c.router.backends["b0"]
        return out, (b0.skew_us, b0.pid)


# ---------------------------------------------------------------------------
# The waterfall.
# ---------------------------------------------------------------------------


def test_waterfall_stats_equal_on_the_same_ledgers():
    complete, _ = asyncio.run(_ledgers(rp.JAX, rp.JAX))
    rng = np.random.default_rng(3)
    made = []
    for i in range(40):
        stages = {s: int(rng.integers(0, 5000)) for s in rp.route_bench.WATERFALL_STAGES}
        if i % 5 == 0:
            stages.pop("device")  # a stage missing: not complete
        total = int(sum(stages.values()) * (1 + rng.choice([0.0, 0.01, 0.2])))
        made.append({"stages": stages, "total_us": total, "complete": bool(i % 7)})
    for ledgers in (complete, made, complete + made, []):
        for tol in (0.05, 0.01):
            assert rp.route_bench.waterfall_stats(ledgers, tol) == \
                rp.jroute_bench.waterfall_stats(ledgers, tol)
    assert rp.route_bench.WATERFALL_STAGES == rp.jroute_bench.WATERFALL_STAGES
    wf = rp.route_bench.waterfall_stats(complete)
    assert wf["sampled"] == wf["complete"] == 12 and wf["sum_within_tol_frac"] == 1.0


def test_port_router_builds_complete_waterfalls_over_jax_frontends():
    ledgers, (skew, pid) = asyncio.run(_ledgers(rp.PORT, rp.JAX))
    wf = rp.route_bench.waterfall_stats(ledgers)
    assert wf["sampled"] == wf["complete"] == 12
    assert wf["complete_frac"] == 1.0 and wf["sum_within_tol_frac"] == 1.0
    assert wf["stages"]["device"]["count"] == 12
    assert skew is not None and abs(skew) < 50_000 and pid == os.getpid()


def test_router_stages_over_port_frontends_match_the_reference_routers():
    """The port's workers send no ``lg``: both packages' routers build the
    same incomplete ledger shape over them, with the router's own stages."""
    port, _ = asyncio.run(_ledgers(rp.PORT, rp.PORT, n=6))
    rp.reset_state()
    ref, _ = asyncio.run(_ledgers(rp.JAX, rp.PORT, n=6))
    for got in (port, ref):
        assert all(l is not None and not l["complete"] for l in got)
        assert all(set(l["stages"]) == {"router_queue", "retry", "wire"} for l in got)
    assert [rp.shape(l) for l in port] == [rp.shape(l) for l in ref]
    p50 = rp.route_bench.router_stage_p50s(port)
    assert p50["n"] == 6 and p50["wire"] > 0 and p50["router_queue"] >= 0


def test_sampling_decision_propagates_over_wire(monkeypatch, tmp_path):
    async def script(pkg):
        run_dir = _traced(pkg, tmp_path, monkeypatch)
        monkeypatch.setenv("OT_TRACE_SAMPLE", "0")
        async with rp.Cluster(pkg, n=2) as c:
            ledgers = []
            for t in range(6):
                resp = await c.router.submit(f"t{t}", b"\x01" * 16, b"\x02" * 16,
                                             np.zeros(256, np.uint8))
                ledgers.append((resp.ok, resp.ledger))
        pkg.trace.reset_for_tests()
        run = pkg.export.load_run(str(run_dir))
        names = {s.name for s in run.spans.values()}
        return ledgers, "route-request" in names, "request-queued" in names, run.violations

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == ([(True, None)] * 6, False, False, [])


def test_request_spans_chain_under_the_routers_roots(monkeypatch, tmp_path):
    async def script(pkg):
        run_dir = _traced(pkg, tmp_path, monkeypatch)
        await _ledgers(pkg, pkg)
        pkg.trace.reset_for_tests()
        run = pkg.export.load_run(str(run_dir))
        roots = {s.id for s in run.spans.values() if s.name == "route-request"}
        queued = [s for s in run.spans.values()
                  if s.name == "request-queued" and s.attrs.get("tenant") != "_canary"]
        offs = run.clock_offsets()
        return (len(roots), len(queued), all(s.parent in roots for s in queued),
                bool(offs) and all(abs(v) < 50_000 for v in offs.values()), run.violations)

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == (12, 12, True, True, [])


def test_fleet_join_stats_equal_across_packages():
    runs = []
    for p in rp.PKGS:
        run = p.export.Run()

        def span(sid, name, parent, proc, run=run, p=p):
            rec = {"id": sid, "name": name, "parent": parent, "ts": 0}
            run.spans[sid] = p.export.SpanRec(rec, pid=1 if proc == "a" else 2, proc=proc)

        span("a.1", "route-request", None, "a")
        span("b.1", "request-queued", "a.1", "b")
        span("a.2", "route-request", None, "a")
        span("a.3", "request-queued", "a.2", "a")
        span("a.4", "route-request", None, "a")
        runs.append(run)
    assert fleet_join_stats(runs[1]) == jfleet_join_stats(runs[0]) == {
        "roots": 3, "linked": 2, "joined": 1, "frac": pytest.approx(1 / 3)}


# ---------------------------------------------------------------------------
# Federation and the router's endpoint.
# ---------------------------------------------------------------------------


def test_relabel_prometheus_equal_across_packages():
    text = ("# TYPE serve_requests_total counter\nserve_requests_total 5\n"
            'serve_shed_total{reason="depth"} 2\n\nnot a sample line\n')
    for p in rp.PKGS:
        p.metrics.counter("serve_requests", 3, mode="ctr")
        p.metrics.observe("serve_dispatch_us", 120.0, lane=0, outcome="ok")
        p.metrics.gauge("serve_queue_depth", 4)
    docs = [text, rp.metrics.render_prometheus(), rp.jmetrics.render_prometheus()]
    for doc in docs:
        for labels in ({"backend": "b1"}, {"backend": "b0", "zone": "a"}):
            assert rp.status.relabel_prometheus(doc, **labels) == \
                rp.jstatus.relabel_prometheus(doc, **labels)
    out = rp.status.relabel_prometheus(text, backend="b1")
    assert 'serve_requests_total{backend="b1"} 5' in out
    assert 'serve_shed_total{reason="depth",backend="b1"} 2' in out


def test_federated_metrics_alertz_and_profilez_relays():
    async def script(pkg):
        async with rp.Cluster(pkg, n=2) as c:
            st = pkg.RouterStatus(c.router, 0)
            await st.start()
            for t in range(4):
                assert (await c.router.submit(f"t{t}", b"\x01" * 16, b"\x02" * 16,
                                              np.zeros(256, np.uint8))).ok
            head, body = await rp.http_get(st.port, "/metrics")
            text = body.decode()
            up = sorted(ln for ln in text.splitlines() if ln.startswith("ot_route_federate_up"))
            labelled = all(f'backend="{n}"' in text for n in ("b0", "b1"))
            ahead, abody = await rp.http_get(st.port, "/alertz")
            alerts = json.loads(abody)
            phead, pbody = await rp.http_get(st.port, "/profilez?seconds=0.1")
            prof = json.loads(pbody)
            st.federate = False
            _, own = await rp.http_get(st.port, "/metrics")
            await st.stop()
            return (head.split(b"\r\n")[0], up, labelled, "route_affinity" in text,
                    ahead.split(b"\r\n")[0], sorted(alerts), sorted(alerts["federated"]),
                    phead.split(b"\r\n")[0], sorted(prof["federated"]), prof["armed"],
                    b"ot_route_federate_up" in own)

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out[1] == ['ot_route_federate_up{backend="b0"} 1',
                           'ot_route_federate_up{backend="b1"} 1']
    assert port_out[2] and port_out[3] and not port_out[10]


def test_router_healthz_renders_quarantined_and_probation_states():
    async def script(pkg):
        async with rp.Cluster(pkg, n=3) as c:
            st = pkg.RouterStatus(c.router, 0)
            await st.start()
            c.router.backends["b1"].health._quarantine("test-evidence")
            c.router.backends["b2"].health.canary_ok()
            _, body = await rp.http_get(st.port, "/healthz")
            first = rp.masked(json.loads(body))
            c.router.backends["b0"].health._quarantine("test-evidence")
            c.router.backends["b2"].health._quarantine("test-evidence")
            _, body = await rp.http_get(st.port, "/healthz")
            second = rp.masked(json.loads(body))
            await st.stop()
            return first, second

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    first, second = port_out
    assert first["backends"]["b1"]["state"] == "quarantined"
    assert first["backends"]["b2"]["state"] == "probation"
    assert (first["status"], first["placeable"]) == ("ok", 2)
    assert (second["status"], second["placeable"]) == ("degraded", 0)


def test_router_status_ephemeral_port_and_malformed_requests():
    async def script(pkg):
        async with rp.Cluster(pkg, n=1) as c:
            st = pkg.RouterStatus(c.router, 0)
            await st.start()
            resolved = bool(st.port)
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", st.port)
                writer.write(b"\x00\xff garbage\r\n\r\n")
                await writer.drain()
                await asyncio.wait_for(reader.read(1 << 16), timeout=10.0)
                writer.close()
            except (ConnectionError, asyncio.TimeoutError):
                pass
            head, _ = await rp.http_get(st.port, "/healthz")
            nope, _ = await rp.http_get(st.port, "/nope")
            await st.stop()
            return resolved, head.split(b"\r\n")[0], nope.split(b"\r\n")[0]

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == (True, b"HTTP/1.1 200 OK", b"HTTP/1.1 404 Not Found")


def test_chrome_trace_aligns_clocks_from_wire_skew(monkeypatch, tmp_path):
    run_dir = _traced(rp.PORT, tmp_path, monkeypatch, run="t-skew")
    with rp.trace.span("work"):
        pass
    rp.trace.point("wire-skew", backend=0, pid=os.getpid(), skew_us=1000, rtt_us=50)
    rp.trace.reset_for_tests()
    for export in (rp.export, rp.JAX.export):
        run = export.load_run(str(run_dir))
        assert run.clock_offsets() == {os.getpid(): 1000}
        plain = export.to_chrome_trace(run, align=False)
        aligned = export.to_chrome_trace(run, align=True)
        assert aligned["otClockOffsetsUs"] == {str(os.getpid()): 1000}
        sp = [e for e in plain["traceEvents"] if e.get("name") == "work"][0]
        sa = [e for e in aligned["traceEvents"] if e.get("name") == "work"][0]
        assert sp["ts"] - sa["ts"] == 1000
