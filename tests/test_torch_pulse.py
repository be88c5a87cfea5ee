"""The port's pulse engine (``our_tree_tpu_torch.obs.pulse``) against the JAX
package's (``our_tree_tpu.obs.pulse``): the same hand-built frame sequences
fire the same rules at the same frames, for each of the five rules and a
healthy corpus; frames built from either registry fed the same series are
equal; the replay CLI gives equal documents on the same metrics files. Then
the port's live contract on the CPU: ``/alertz`` and the ``/healthz``
``capacity`` section on a running server, 404 with ``OT_PULSE=0``, the
``dispatch_slow`` drill (the burn-rate alert and exactly one incident
bundle), ``Server.stop`` joining the pulse thread, and ``on_alert`` arming
a capture window. Frames carry their own timestamps: nothing here depends on
the host's timing but the drill, which loops until the alert fires."""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from our_tree_tpu.obs import metrics as jmetrics
from our_tree_tpu.obs import pulse as jpulse
from our_tree_tpu_torch.obs import incident, metrics, profiler, pulse, trace
from our_tree_tpu_torch.resilience import degrade, faults
from our_tree_tpu_torch.serve.server import Server, ServerConfig

LADDER = dict(device="cpu", engine="bitslice", lanes=1, min_bucket_blocks=32,
              max_bucket_blocks=64)

#: Small deterministic thresholds (the JAX package's tests/test_pulse.py).
CFG = dict(fast_window_s=1.0, slow_window_s=2.0, budget=0.05, fast_burn=8.0, slow_burn=2.0,
           min_events=5, collapse_frac=0.5, ewma_alpha=0.5, baseline_frames=2,
           min_dispatches=4, flap_n=3, flap_window_s=2.0, storm_n=3, storm_window_s=2.0,
           pressure_frac=0.9, pressure_ticks=3)

_PULSE_ENV = ("OT_PULSE", "OT_PULSE_EVERY_S", "OT_PULSE_FAST_S", "OT_PULSE_SLOW_S",
              "OT_PULSE_BUDGET", "OT_PULSE_FAST_BURN", "OT_PULSE_SLOW_BURN",
              "OT_PULSE_MIN_EVENTS", "OT_PULSE_COLLAPSE_FRAC", "OT_PULSE_ALPHA",
              "OT_PULSE_BASELINE_FRAMES", "OT_PULSE_MIN_DISPATCHES", "OT_PULSE_FLAP_N",
              "OT_PULSE_FLAP_S", "OT_PULSE_STORM_N", "OT_PULSE_STORM_S",
              "OT_PULSE_PRESSURE_FRAC", "OT_PULSE_PRESSURE_TICKS", "OT_PROFILE_ON_ALERT")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _PULSE_ENV + ("OT_FAULTS", "OT_SLOW_S", "OT_INCIDENT_COOLDOWN_S", "OT_TRACE_DIR",
                           "OT_DISPATCH_DEADLINE"):
        monkeypatch.delenv(k, raising=False)
    faults.reset()
    degrade.clear()
    metrics.reset_for_tests()
    incident.reset_for_tests()
    yield
    faults.reset()
    degrade.clear()
    metrics.reset_for_tests()
    incident.reset_for_tests()


def _frame(ts_s, counters=None, gauges=None, hcounts=None):
    return {"ts_us": int(ts_s * 1e6), "counters": dict(counters or {}),
            "gauges": dict(gauges or {}), "hcounts": dict(hcounts or {})}


_DISP = "serve_rung_dispatches{engine=cuda,mode=ctr,nr=10,rung=64}"
_DEV = "serve_rung_device_us{engine=cuda,mode=ctr,nr=10,rung=64}"
_COMPILE = "serve_compile_us{engine=cuda,rung=64}"


def _burn_frames():
    frames, req, bad, t = [], 0, 0, 0.0
    for phase, (until, dbad) in enumerate(((5.0, 0), (8.0, 5), (12.0, 0), (15.0, 5))):
        while t <= until:
            req += 10
            bad += dbad
            frames.append(_frame(t, {"serve_requests{mode=ctr}": req,
                                     "serve_batches{outcome=deadline}": bad,
                                     "serve_deadline_expired": phase}))
            t += 0.5
    return frames


def _collapse_frames():
    frames, disp, dev, t = [], 0, 0, 0.0
    while t <= 3.0:
        disp += 8
        dev += 1000
        frames.append(_frame(t, {_DISP: disp, _DEV: dev}, {"serve_queue_depth": 4}))
        t += 0.5
    while t <= 8.0:
        frames.append(_frame(t, {_DISP: disp, _DEV: dev}, {"serve_queue_depth": 4}))
        t += 0.5
    while t <= 9.0:
        frames.append(_frame(t, {_DISP: disp, _DEV: dev}, {"serve_queue_depth": 0}))
        t += 0.5
    return frames


def _flap_frames():
    lane_q = "serve_lane_transitions{lane=0,state=quarantined}"
    backend_q = "route_backend_transitions{backend=b1,state=quarantined}"
    frames, t = [], 0.0
    while t <= 3.0:
        frames.append(_frame(t, {lane_q: 1, backend_q: 0}))
        t += 0.5
    for extra in (1, 2, 3):
        frames.append(_frame(t, {lane_q: 1 + extra, backend_q: 1}))
        t += 0.5
    return frames


def _storm_frames():
    frames, t, compiles, batches = [], 0.0, 0, 0
    while t <= 1.0:
        compiles += 2
        frames.append(_frame(t, {"serve_batches{outcome=ok}": 0}, hcounts={_COMPILE: compiles}))
        t += 0.5
    while t <= 4.0:
        batches += 10
        frames.append(_frame(t, {"serve_batches{outcome=ok}": batches},
                             hcounts={_COMPILE: compiles}))
        t += 0.5
    while t <= 6.0:
        batches += 10
        compiles += 2
        frames.append(_frame(t, {"serve_batches{outcome=ok}": batches},
                             hcounts={_COMPILE: compiles}))
        t += 0.5
    return frames


def _pressure_frames():
    g = {"serve_transfer_budget_bytes": 100.0}
    held = (95, 10, 95, 95, 95, 99, 20, 95, 95, 95)
    return [_frame(0.5 * (i + 1), gauges={**g, "serve_reassembly_held_bytes": h})
            for i, h in enumerate(held)]


def _healthy_frames():
    frames = []
    req = bad = disp = batches = 0
    for i in range(40):
        req += 20
        disp += 8
        batches += 10
        if i % 10 == 0:
            bad += 1
        frames.append(_frame(
            i * 0.5,
            {"serve_requests{mode=ctr}": req, "serve_batches{outcome=ok}": batches,
             "serve_batches{outcome=deadline}": bad,
             "serve_lane_transitions{lane=0,state=healthy}": 1, _DISP: disp, _DEV: disp * 100},
            gauges={"serve_queue_depth": 2, "serve_transfer_budget_bytes": 100.0,
                    "serve_reassembly_held_bytes": 30.0},
            hcounts={_COMPILE: 4}))
    return frames


CORPORA = {"burn_rate": (_burn_frames, {"burn_rate": 2}),
           "capacity_collapse": (_collapse_frames, {"capacity_collapse": 1}),
           "quarantine_flap": (_flap_frames, {"quarantine_flap": 1}),
           "compile_storm": (_storm_frames, {"compile_storm": 1}),
           "reassembly_pressure": (_pressure_frames, {"reassembly_pressure": 2}),
           "healthy": (_healthy_frames, {})}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_rules_fire_like_the_reference(corpus):
    make, want = CORPORA[corpus]
    ours = pulse.PulseEngine(pulse.PulseConfig(**CFG), proc="test", emit=False)
    ref = jpulse.PulseEngine(jpulse.PulseConfig(**CFG), proc="test", emit=False)
    for i, frame in enumerate(make()):
        got = ours.observe(json.loads(json.dumps(frame)))
        exp = ref.observe(json.loads(json.dumps(frame)))
        assert got == exp, f"frame {i}"
    assert ours.fired == ref.fired == want
    assert list(ours.alerts) == list(ref.alerts)
    assert ours.capacity() == ref.capacity()
    assert ours._baseline == ref._baseline
    assert (ours.errors, ref.errors) == (0, 0)
    doc, jdoc = ours.alerts_doc(), ref.alerts_doc()
    assert doc == jdoc


def test_config_from_env_and_vocabulary_match(monkeypatch):
    monkeypatch.setenv("OT_PULSE_FAST_S", "3")
    monkeypatch.setenv("OT_PULSE_MIN_EVENTS", "7")
    monkeypatch.setenv("OT_PULSE_COLLAPSE_FRAC", "bad")
    assert pulse.PulseConfig.from_env().doc() == jpulse.PulseConfig.from_env().doc()
    assert (pulse.RULES, pulse.SEVERITIES, pulse.PAGE_RULES, pulse.BAD_BATCH_OUTCOMES,
            pulse.KIND, pulse.VERSION) == (jpulse.RULES, jpulse.SEVERITIES, jpulse.PAGE_RULES,
                                           jpulse.BAD_BATCH_OUTCOMES, jpulse.KIND,
                                           jpulse.VERSION)
    monkeypatch.setenv("OT_PULSE", "off")
    assert pulse.enabled() is jpulse.enabled() is False


def _feed_both(rng):
    for m in (metrics, jmetrics):
        m.reset_for_tests()
    for i in range(60):
        name = str(rng.choice(["serve_requests", "serve_batches", "pulse_alerts", "serve_shed"]))
        labels = {"mode": str(rng.choice(["ctr", "gcm"]))}
        n = int(rng.integers(1, 9))
        depth = int(rng.integers(0, 5))
        us = float(rng.integers(1, 1 << 16))
        rung = int(rng.choice([32, 64]))
        for m in (metrics, jmetrics):
            m.counter(name, n, **labels)
            m.gauge("serve_queue_depth", depth)
            m.observe("serve_compile_us", us, engine="cuda", rung=rung)


def test_frames_from_both_registries_are_equal():
    _feed_both(np.random.default_rng(19))
    ts = 1_700_000_000_000_000
    ours = pulse.frame_from_snapshot(metrics.snapshot(), ts)
    ref = jpulse.frame_from_snapshot(jmetrics.snapshot(), ts)
    assert ours == ref
    assert not any(k.startswith("pulse_") for k in ours["counters"])
    assert pulse._parse_flat("a{b=1,c=x}") == jpulse._parse_flat("a{b=1,c=x}") == (
        "a", (("b", "1"), ("c", "x")))
    rec = json.loads(json.dumps(metrics._snapshot_rec(ts)))
    assert pulse.frame_from_record(rec) == jpulse.frame_from_record(rec) == ours
    jmetrics.reset_for_tests()


def _snap_rec(ts_s, counters):
    return {"ts": int(ts_s * 1e6), "counters": [[n, lab, v] for n, lab, v in counters],
            "gauges": [], "hists": []}


def _burn_records(live_rules=("burn_rate",)):
    recs, req, bad, t = [{"kind": metrics.KIND, "v": 1, "interval_s": 0.5}], 0, 0, 0.0
    while t <= 8.0:
        req += 10
        if t > 5.0:
            bad += 5
        counters = [("serve_requests", {"mode": "ctr"}, req)]
        if bad:
            counters.append(("serve_batches", {"outcome": "deadline"}, bad))
        recs.append(_snap_rec(t, counters))
        t += 0.5
    recs[-1]["counters"].extend([["pulse_alerts", {"rule": r, "severity": "page"}, 1]
                                 for r in live_rules])
    return recs


def _write(path, recs):
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))


def _pulse_env(monkeypatch):
    for k, v in (("OT_PULSE_FAST_S", "1"), ("OT_PULSE_SLOW_S", "2"),
                 ("OT_PULSE_MIN_EVENTS", "5"), ("OT_PULSE_BUDGET", "0.05"),
                 ("OT_PULSE_FAST_BURN", "8"), ("OT_PULSE_SLOW_BURN", "2")):
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("layout", ["one", "reference_rotated", "two_procs"])
@pytest.mark.parametrize("live_rules", [("burn_rate",), ("burn_rate", "quarantine_flap")])
def test_replay_docs_equal_reference(tmp_path, monkeypatch, capsys, layout, live_rules):
    _pulse_env(monkeypatch)
    recs = _burn_records(live_rules)
    if layout == "one":
        _write(tmp_path / "metrics-1234-ab12cd.jsonl", recs)
    elif layout == "reference_rotated":
        # The layout the JAX package's test writes: -s0 the older prefix, the
        # bare name the newer tail.
        _write(tmp_path / "metrics-1234-ab12cd-s0.jsonl", recs[:8])
        _write(tmp_path / "metrics-1234-ab12cd.jsonl", recs[8:])
    else:
        _write(tmp_path / "metrics-1234-ab12cd.jsonl", recs)
        _write(tmp_path / "metrics-99-0f0f0f0f.jsonl", _burn_records(())[:6])
    ours = pulse.replay_run(str(tmp_path), pulse.PulseConfig.from_env())
    ref = jpulse.replay_run(str(tmp_path), jpulse.PulseConfig.from_env())
    assert ours == ref
    assert pulse.check(ours) == jpulse.check(ref)
    rc = pulse.main([str(tmp_path), "--check"])
    out = capsys.readouterr().out
    jrc = jpulse.main([str(tmp_path), "--check"])
    jout = capsys.readouterr().out
    assert (rc, out) == (jrc, jout)
    assert rc == (0 if live_rules == ("burn_rate",) else 1)


def test_replay_orders_the_port_s_rotated_segments_by_time(tmp_path, monkeypatch):
    """The port's writer names the first segment bare and the later ones
    ``-s1``, ``-s2``: the replay reads them in timestamp order, so a rotated
    stream gives the verdict of the same stream unrotated."""
    _pulse_env(monkeypatch)
    recs = _burn_records()
    whole = tmp_path / "whole"
    whole.mkdir()
    _write(whole / "metrics-7-1a2b3c4d.jsonl", recs)
    rot = tmp_path / "rot"
    rot.mkdir()
    _write(rot / "metrics-7-1a2b3c4d.jsonl", recs[:6])
    _write(rot / "metrics-7-1a2b3c4d-s1.jsonl", [recs[0]] + recs[6:12])
    _write(rot / "metrics-7-1a2b3c4d-s2.jsonl", [recs[0]] + recs[12:])
    a = pulse.replay_run(str(whole), pulse.PulseConfig.from_env())
    b = pulse.replay_run(str(rot), pulse.PulseConfig.from_env())
    for doc in (a, b):
        doc.pop("run_dir")
        for s in doc["streams"]:
            s.pop("proc")
    assert a == b and a["fired"] == {"burn_rate": 1} and pulse.check(b) == []


def test_replay_empty_run_dir_fails_check(tmp_path, capsys):
    assert pulse.main([str(tmp_path), "--check"]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# The live engine on a CPU server.
# ---------------------------------------------------------------------------


def _run_server(config, fn):
    async def main():
        server = Server(config)
        await server.start()
        try:
            return server, await fn(server)
        finally:
            await server.stop()

    return asyncio.run(main())


def _fetch(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _pulse_threads():
    return [t for t in threading.enumerate() if t.name == "ot-pulse" and t.is_alive()]


def test_alertz_and_healthz_capacity_on_a_running_server(monkeypatch):
    monkeypatch.setenv("OT_PULSE_EVERY_S", "0.05")
    before = len(_pulse_threads())

    async def drive(server):
        assert server.pulse is not None and server.pulse.is_alive()
        for i in range(4):
            await server.submit("t", bytes(16), bytes(16), np.full(64 * (i + 1), i, np.uint8))
        server.pulse.tick()
        loop = asyncio.get_running_loop()
        alertz = await loop.run_in_executor(None, _fetch, server.status.port, "/alertz")
        healthz = await loop.run_in_executor(None, _fetch, server.status.port, "/healthz")
        fleetz = await loop.run_in_executor(None, _fetch, server.status.port, "/fleetz")
        return alertz, healthz, fleetz

    server, ((code, body), (hcode, hbody), (fcode, _)) = _run_server(
        ServerConfig(status_port=0, **LADDER), drive)
    doc = json.loads(body)
    assert code == 200 and doc["kind"] == pulse.KIND and doc["source"] == "serve"
    assert doc["total"] == 0 and doc["alerts"] == [] and doc["frames"] >= 1
    assert set(doc) == set(jpulse.PulseEngine(emit=False).alerts_doc())
    health = json.loads(hbody)
    assert hcode == 200 and health["status"] == "ok"
    cap = health["capacity"]
    assert set(cap) == {"rows", "total_blocks_per_s", "measured", "frames"}
    assert cap["frames"] >= 1
    assert fcode == 404
    # stop() joined the thread.
    assert not server.pulse.is_alive() and len(_pulse_threads()) == before


def test_alertz_404_and_no_capacity_when_pulse_is_off(monkeypatch):
    monkeypatch.setenv("OT_PULSE", "0")

    async def drive(server):
        assert server.pulse is None
        loop = asyncio.get_running_loop()
        alertz = await loop.run_in_executor(None, _fetch, server.status.port, "/alertz")
        healthz = await loop.run_in_executor(None, _fetch, server.status.port, "/healthz")
        return alertz, healthz

    _server, ((code, body), (_h, hbody)) = _run_server(ServerConfig(status_port=0, **LADDER),
                                                       drive)
    assert code == 404 and body == "no pulse engine on this endpoint\n"
    assert "capacity" not in json.loads(hbody)


@pytest.mark.parametrize("status_port", [None, 0])
def test_stop_leaves_no_pulse_thread(monkeypatch, status_port):
    monkeypatch.setenv("OT_PULSE_EVERY_S", "0.05")
    before = len(_pulse_threads())

    async def drive(server):
        return await server.submit("t", bytes(16), bytes(16), np.zeros(32, np.uint8))

    server, resp = _run_server(ServerConfig(status_port=status_port, **LADDER), drive)
    assert resp.ok
    assert server.pulse is not None and not server.pulse.is_alive()
    assert len(_pulse_threads()) == before
    # Its verdict stays readable after the stop, as the bench reads it.
    server.pulse.tick()
    assert server.pulse.engine.alerts_doc()["total"] == 0


@pytest.fixture
def traced(tmp_path, monkeypatch):
    monkeypatch.setenv("OT_TRACE_DIR", str(tmp_path / "tr"))
    monkeypatch.setenv("OT_TRACE_RUN", "t-pulse")
    monkeypatch.delenv("OT_TRACE_PARENT", raising=False)
    trace.reset_for_tests()
    metrics.reset_for_tests()
    yield tmp_path / "tr" / "t-pulse"
    trace.reset_for_tests()
    metrics.reset_for_tests()


def test_dispatch_slow_drill_fires_burn_rate_and_one_bundle(traced, monkeypatch, tmp_path):
    """The JAX package's alert drill on the port: every dispatch slowed past
    a tight dispatch deadline burns the error budget in both windows; the
    page alert's incident trigger and the watchdog's own land within one
    cooldown, so exactly one bundle is written."""
    monkeypatch.setenv("OT_FAULTS", "dispatch_slow")
    monkeypatch.setenv("OT_SLOW_S", "0.4")
    monkeypatch.setenv("OT_PULSE_EVERY_S", "0.05")
    monkeypatch.setenv("OT_PULSE_FAST_S", "1.0")
    monkeypatch.setenv("OT_PULSE_SLOW_S", "2.0")
    monkeypatch.setenv("OT_PULSE_MIN_EVENTS", "1")
    monkeypatch.setenv("OT_CRASH_DIR", str(tmp_path / "crash"))
    faults.reset()

    async def drive(server):
        assert server.pulse is not None
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            await server.submit("t", b"k" * 16, b"n" * 16, np.zeros(64, np.uint8))
            if "burn_rate" in server.pulse.engine.fired:
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.6)  # abandoned dispatch threads finish their sleep
        return dict(server.pulse.engine.fired)

    _server, fired = _run_server(ServerConfig(dispatch_deadline_s=0.2, retries=1, **LADDER),
                                 drive)
    assert "burn_rate" in fired
    counters = metrics.snapshot()["counters"]
    assert counters.get("pulse_alerts{rule=burn_rate,severity=page}", 0) >= 1
    bundles = incident.list_bundles(str(traced))
    assert len(bundles) == 1
    doc = incident.load_bundle(bundles[0])
    assert incident.validate_bundle(doc) == []
    assert doc["reason"] in ("watchdog-kill", "pulse-alert")
    from our_tree_tpu_torch.obs import export

    run = export.load_run(str(traced))
    assert [p["attrs"]["rule"] for p in run.points("pulse-alert")][:1] == ["burn_rate"]


def test_on_alert_arms_a_capture_window(traced, monkeypatch):
    monkeypatch.setenv("OT_PROFILE_ON_ALERT", "0.2")
    monkeypatch.setenv("OT_PROFILE_TIER", "stack")
    profiler.reset_for_tests()
    assert profiler.alert_seconds() == 0.2
    eng = pulse.PulseEngine(pulse.PulseConfig(**CFG), proc="test", device="cpu")
    for frame in _burn_frames()[:18]:
        eng.observe(frame)
    assert eng.fired == {"burn_rate": 1}
    deadline = time.monotonic() + 10
    while profiler.last_summary() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert profiler.wait_idle(10)
    summary = profiler.last_summary()
    assert summary is not None and summary["armed_by"] == "alert"
    assert profiler.validate_summary(summary) == []
    profiler.reset_for_tests()


# ---------------------------------------------------------------------------
# The routing tier's alert view and the fleet's headroom policy (the JAX
# package's tests/test_pulse.py router cases, through both packages).
# ---------------------------------------------------------------------------


def test_router_alertz_always_answers():
    """The router's ``/alertz`` is the fleet view: a merged document even
    with no pulse engine and no back ends, as the JAX router's."""
    import route_pair as rp

    class _Router:
        pulse = None
        backends: dict = {}

    docs = [asyncio.run(p.RouterStatus(_Router(), 0).alertz_async()) for p in rp.PKGS]
    assert docs[0] == docs[1] == {"router": None, "federated": {}, "fired": {}, "total": 0}


class _FakeHealth:
    state = "healthy"
    draining = False

    def placeable(self):
        return True


class _FakeBackend:
    def __init__(self, cap_bps):
        self.last_healthz = {"queue": {"depth": 0.0}, "lanes": {"inflight": 0.0, "count": 1},
                             "capacity": {"total_blocks_per_s": cap_bps}}
        self.health = _FakeHealth()
        self.bytes_out = 0


class _FakeRouter:
    def __init__(self, caps):
        self.backends = {f"w{i}": _FakeBackend(c) for i, c in enumerate(caps)}
        self.shed_retries = 0
        self.router_sheds = 0


def _fleet_sup(pkg, policy, clk, caps=(100.0,)):
    cfg = pkg.fleet.FleetConfig(min_workers=1, max_workers=2, settle_ticks=1, cooldown_s=0.0,
                                refresh_gossip=False, policy=policy, headroom_frac=0.8)
    router = _FakeRouter(caps)
    sup = pkg.fleet.FleetSupervisor(router, lambda name: None, cfg, clock=lambda: clk["t"])
    ups = []

    async def fake_up():
        ups.append(1)
        return True

    sup.scale_up = fake_up
    return sup, router, ups


@pytest.mark.parametrize("policy", ["headroom", "static"])
def test_fleet_policy_on_measured_capacity_matches_reference(policy):
    """90 blocks/s offered against a measured 100: the headroom policy grows,
    the static one stays idle; the port's supervisor decides as the JAX
    one and publishes the same signals and gauges."""
    import route_pair as rp

    out = []
    for pkg in rp.PKGS:
        rp.reset_state()
        clk = {"t": 0.0}
        sup, router, ups = _fleet_sup(pkg, policy, clk)

        async def main():
            first = await sup.tick()
            clk["t"] += 1.0
            router.backends["w0"].bytes_out = 90 * 16
            return first, await sup.tick()

        ticks = asyncio.run(main())
        doc = sup.fleetz()
        gauges = {k: v for k, v in pkg.metrics.snapshot()["gauges"].items()
                  if k.startswith("route_fleet_")}
        out.append((ticks, ups, doc["signals"], doc["policy"], doc["headroom_frac"], gauges))
    rp.reset_state()
    assert out[1] == out[0]
    ticks, ups, sig, pol, frac, _ = out[1]
    if policy == "headroom":
        assert ticks == ("idle", "scaled-up") and ups == [1]
        assert sig["capacity_bps"] == 100.0 and sig["offered_bps"] == pytest.approx(90.0)
        assert sig["headroom_used"] == pytest.approx(0.9)
    else:
        assert ticks == ("idle", "idle") and ups == []
    assert (pol, frac) == (policy, 0.8)


def test_fleet_signals_publish_shed_rate_and_capacity_gauges():
    import route_pair as rp

    out = []
    for pkg in rp.PKGS:
        rp.reset_state()
        clk = {"t": 0.0}
        sup, router, _ups = _fleet_sup(pkg, "static", clk)
        sup.signals()
        clk["t"] += 2.0
        router.shed_retries = 6
        sig = sup.signals()
        g = pkg.metrics.snapshot()["gauges"]
        out.append((sig, {k: g[k] for k in g if k.startswith("route_fleet_")}))
    rp.reset_state()
    assert out[1] == out[0]
    sig, g = out[1]
    assert sig["shed_rate"] == pytest.approx(3.0)
    assert g["route_fleet_shed_rate"] == pytest.approx(3.0)
    assert g["route_fleet_capacity_blocks"] == pytest.approx(100.0)
    assert "route_fleet_offered_blocks" in g
