"""The port's run-dir readers (``our_tree_tpu_torch.obs.export``/``report``)
against the JAX package's on the same run directory: one written by the
port's server on the CPU (a small ladder, ``ctr``, ``gcm`` and ``cbc``, the
trace and the metrics streams both rotated under ``OT_TRACE_MAX_MB``).
``load_run`` gives the same spans, orphans, violations, events and
snapshots; ``to_chrome_trace`` the same dict; ``report.render`` the same
text line for line; the CLI the same exit codes for ``--check``,
``--expected-orphans`` and ``--incidents`` on the run and on a copy with a
planted orphan. Integer data, exact comparisons; nothing depends on timing
(the rotation is forced by explicit snapshot flushes and a cap sized from
the run's own trace)."""

import asyncio
import io
import json
import shutil

import numpy as np
import pytest

from our_tree_tpu.obs import export as jexport
from our_tree_tpu.obs import report as jreport
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.obs import costmodel, export, incident, metrics, report, trace
from our_tree_tpu_torch.resilience import degrade
from our_tree_tpu_torch.serve.server import Server, ServerConfig

MODES = ("ctr", "gcm", "cbc")


def _requests(seed):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(3)]
    out = []
    for i in range(18):
        mode = MODES[i % 3]
        size = int(rng.choice([16, 48, 256, 512]))
        out.append((f"t{i % 3}", keys[i % 3], rng.integers(0, 256, 16, np.uint8).tobytes(),
                    rng.integers(0, 256, size, dtype=np.uint8), mode,
                    rng.integers(0, 256, 12, np.uint8).tobytes()))
    return out


def _drive(run_dir_parent, run, cap_mb, monkeypatch):
    monkeypatch.setenv("OT_TRACE_DIR", str(run_dir_parent))
    monkeypatch.setenv("OT_TRACE_RUN", run)
    monkeypatch.setenv("OT_PULSE", "0")
    if cap_mb:
        monkeypatch.setenv("OT_TRACE_MAX_MB", str(cap_mb))
    else:
        monkeypatch.delenv("OT_TRACE_MAX_MB", raising=False)
    # Each drive's warmup makes the seams' first calls (serve_compile_us).
    monkeypatch.setattr(aes, "_SEAM_CALLS", set())
    trace.reset_for_tests()
    metrics.reset_for_tests()
    costmodel.reset_for_tests()

    async def main():
        server = Server(ServerConfig(device="cpu", engine="bitslice", lanes=1, modes=MODES,
                                     min_bucket_blocks=32, max_bucket_blocks=64))
        await server.start()
        try:
            for t, k, n, p, mode, iv in _requests(5):
                resp = await server.submit(t, k, n, p, mode=mode,
                                           iv=iv if mode == "gcm" else n)
                assert resp.ok
                # Explicit snapshots: the metrics stream rotates whatever the
                # flusher's timing.
                metrics.flush_now()
        finally:
            await server.stop()

    asyncio.run(main())
    trace.reset_for_tests()
    metrics.reset_for_tests()
    return run_dir_parent / run


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        degrade.clear()
        base = tmp_path_factory.mktemp("runs")
        # First unbounded, to size the cap: the rotated run must rotate both
        # streams and evict nothing (the trace under 4 segments of cap/4).
        plain = _drive(base, "plain", 0, mp)
        size = sum(f.stat().st_size for f in plain.glob("trace-*.jsonl"))
        cap_mb = 2.0 * size / (1 << 20)
        rotated = _drive(base, "rotated", cap_mb, mp)
        yield rotated
    finally:
        mp.undo()
        trace.reset_for_tests()
        metrics.reset_for_tests()
        costmodel.reset_for_tests()


def test_the_run_rotated_both_streams(run_dir):
    names = sorted(f.name for f in run_dir.glob("*.jsonl"))
    assert sum(n.startswith("trace-") for n in names) >= 2
    assert sum(n.startswith("metrics-") for n in names) >= 2
    # The trace kept every segment (a span's begin and end both on disk);
    # the snapshots, cumulative, may have lost their oldest segments.
    assert any(n.endswith("-s1.jsonl") for n in names if n.startswith("trace-"))
    assert any("-s" in n for n in names if n.startswith("metrics-"))
    assert list(run_dir.glob("cost-*.json"))


def _spans(run):
    return {sid: (s.name, s.parent, s.ts, s.end_ts, s.status, s.attrs, s.pid, s.proc, s.tid)
            for sid, s in run.spans.items()}


def test_load_run_equals_reference(run_dir):
    run, jrun = export.load_run(str(run_dir)), jexport.load_run(str(run_dir))
    assert _spans(run) == _spans(jrun)
    assert [s.id for s in run.orphans()] == [s.id for s in jrun.orphans()] == []
    assert run.violations == jrun.violations == []
    assert run.events == jrun.events
    assert run.snapshots == jrun.snapshots and len(run.snapshots) >= 2
    assert run.procs == jrun.procs and run.metric_procs == jrun.metric_procs
    assert (run.t0, run.t1) == (jrun.t0, jrun.t1)
    assert run.metrics_totals() == jrun.metrics_totals()
    assert run.counter_totals() == jrun.counter_totals()
    names = {s.name for s in run.spans.values()}
    assert {"serve-warmup", "lane-warmup", "lane-dispatch", "request-queued"} <= names
    totals = run.metrics_totals()
    assert any(k.startswith("serve_compile_us{") for k in totals["hists"])


def test_chrome_trace_equals_reference(run_dir, tmp_path):
    run, jrun = export.load_run(str(run_dir)), jexport.load_run(str(run_dir))
    doc = export.to_chrome_trace(run)
    assert doc == jexport.to_chrome_trace(jrun)
    assert any(e["name"].startswith("metrics:") for e in doc["traceEvents"])
    path = export.write_chrome_trace(run, str(tmp_path / "t.json"))
    jpath = jexport.write_chrome_trace(jrun, str(tmp_path / "j.json"))
    with open(path) as a, open(jpath) as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("top", [3, 10])
def test_render_equals_reference_line_for_line(run_dir, top):
    out, jout = io.StringIO(), io.StringIO()
    report.render(export.load_run(str(run_dir)), top=top, out=out, run_dir=str(run_dir))
    jreport.render(jexport.load_run(str(run_dir)), top=top, out=jout, run_dir=str(run_dir))
    assert out.getvalue().splitlines() == jout.getvalue().splitlines()
    text = out.getvalue()
    assert "per-lane device time (serve):" in text
    assert "per-mode dispatch (serve):" in text
    assert "warmup compile cost (serve_compile_us):" in text
    assert "roofline (modeled HBM traffic vs achieved device rate):" in text


def _plant_orphan(src, dst):
    shutil.copytree(src, dst)
    seg = sorted(dst.glob("trace-*.jsonl"))[-1]
    with open(seg, "a") as fh:
        fh.write(json.dumps({"ev": "b", "id": "deadbeef.1", "parent": None,
                             "name": "lane-dispatch", "ts": 1, "tid": 0}) + "\n")
    return dst


@pytest.mark.parametrize("case,args,want", [
    ("clean", ["--check"], 0),
    ("clean", ["--check", "--top", "4"], 0),
    ("orphan", ["--check"], 2),
    ("orphan", ["--check", "--expected-orphans", "lane-dispatch"], 0),
    ("orphan", ["--check", "--expected-orphans", "request-queued"], 2),
    ("orphan", [], 0),
    ("clean", ["--incidents", "--check"], 0),
])
def test_cli_exit_codes_equal_reference(run_dir, tmp_path, capsys, case, args, want):
    d = run_dir if case == "clean" else _plant_orphan(run_dir, tmp_path / "orphan")
    rc = report.main([str(d), *args, "--trace-json", str(tmp_path / "ours.json")])
    out = capsys.readouterr()
    jrc = jreport.main([str(d), *args, "--trace-json", str(tmp_path / "ref.json")])
    jout = capsys.readouterr()
    assert rc == jrc == want
    assert out.out == jout.out
    if "--incidents" not in args:
        with open(tmp_path / "ours.json") as a, open(tmp_path / "ref.json") as b:
            assert json.load(a) == json.load(b)


def test_incidents_mode_renders_port_bundles_like_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OT_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("OT_TRACE_RUN", "inc")
    monkeypatch.setenv("OT_INCIDENT_COOLDOWN_S", "0")
    incident.reset_for_tests()
    try:
        incident.record(lane=0, rung=32, engine="cuda", mode="ctr", outcome="timeout",
                        device_us=0, wall_us=9, batch="b")
        incident.trigger("pulse-alert", rule="burn_rate")
        incident.trigger("watchdog-kill", lane=0)
        trace.point("filler")
    finally:
        incident.reset_for_tests()
        trace.reset_for_tests()
    d = tmp_path / "inc"
    rc = report.main([str(d), "--incidents", "--check"])
    out = capsys.readouterr().out
    jrc = jreport.main([str(d), "--incidents", "--check"])
    assert (rc, out) == (jrc, capsys.readouterr().out)
    assert rc == 0 and out.count("incident ") == 2


def test_exemplar_rows_and_join_stats_equal_reference(run_dir):
    run, jrun = export.load_run(str(run_dir)), jexport.load_run(str(run_dir))
    assert report.exemplar_rows(run, top=5) == jreport.exemplar_rows(jrun, top=5)
    assert report.fleet_join_stats(run) == jreport.fleet_join_stats(jrun) == {
        "roots": 0, "linked": 0, "joined": 0, "frac": 0.0}
