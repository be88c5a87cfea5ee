"""Trace and metrics rotation under ``OT_TRACE_MAX_MB`` in the port
(``our_tree_tpu_torch.obs.trace``/``metrics``), as the JAX package's
``tests/test_obs.py`` rotation tests hold its own: the ``-s<k>`` segment
names, the cap on disk, a span reconstructed across segments, a failed
segment open that keeps the live handle, and the evicted bytes counted. Each
rotated run is also read by the JAX package's ``obs.export``, which must
reconstruct what the port's does. Then the warmup build cost
(``serve_compile_us{engine, rung}``) through a fake kernel-library loader on
the CPU. No timing is involved."""

import asyncio
import ctypes
import json
import re

import numpy as np
import pytest

from our_tree_tpu.obs import export as jexport
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.obs import export, metrics, trace
from our_tree_tpu_torch.runtime import cuda_build, monitoring
from our_tree_tpu_torch.serve import server as server_mod
from our_tree_tpu_torch.serve.server import Server, ServerConfig

SEG_NAME = re.compile(r"^(trace|metrics)-\d+-[0-9a-f]{8}(-s(\d+))?\.jsonl$")


@pytest.fixture
def traced(tmp_path, monkeypatch):
    def _set(run, cap_mb):
        monkeypatch.setenv("OT_TRACE_DIR", str(tmp_path / "tr"))
        monkeypatch.setenv("OT_TRACE_RUN", run)
        monkeypatch.setenv("OT_TRACE_MAX_MB", str(cap_mb))
        monkeypatch.delenv("OT_TRACE_PARENT", raising=False)
        # Metrics first: their reset stops a daemon flusher that an earlier
        # test's server left running, which would otherwise open a snapshot
        # file of its own under the new run before the registry is cleared.
        metrics.reset_for_tests()
        trace.reset_for_tests()
        return tmp_path / "tr" / run

    yield _set
    trace.reset_for_tests()
    metrics.reset_for_tests()


def _same_run(a, b):
    assert sorted(a.spans) == sorted(b.spans)
    for sid, sp in a.spans.items():
        other = b.spans[sid]
        assert (sp.name, sp.parent, sp.ts, sp.end_ts, sp.status, sp.attrs) == (
            other.name, other.parent, other.ts, other.end_ts, other.status, other.attrs)
    assert a.violations == b.violations
    assert a.events == b.events
    assert a.snapshots == b.snapshots


def test_trace_rotation_caps_disk(traced):
    cap_mb = 0.05  # about 12 KiB segments
    run_dir = traced("t-rot", cap_mb)
    n = 2000
    for i in range(n):
        trace.point("soak", i=i, pad="x" * 80)
    trace.reset_for_tests()
    files = sorted(run_dir.glob("trace-*.jsonl"))
    assert len(files) > 1 and all(SEG_NAME.match(f.name) for f in files)
    assert sum(f.stat().st_size for f in files) <= cap_mb * (1 << 20) * 1.1
    segs = sorted(int(SEG_NAME.match(f.name).group(3) or 0) for f in files)
    assert segs == list(range(segs[0], segs[0] + len(segs))) and segs[0] > 0  # oldest deleted
    last_seen = -1
    for f in files:
        recs = [json.loads(ln) for ln in f.read_text().splitlines()]
        assert recs[0]["kind"] == "ot-trace" and recs[0]["v"] == 1
        assert recs[0].get("seg", 0) == int(SEG_NAME.match(f.name).group(3) or 0)
        last_seen = max(last_seen, max(r["attrs"]["i"] for r in recs[1:] if r.get("ev") == "p"))
    assert last_seen == n - 1


def test_trace_evicted_bytes_are_counted(traced):
    run_dir = traced("t-evict", 0.02)
    for i in range(600):
        trace.point("soak", i=i, pad="y" * 100)
    snap = trace.metrics_snapshot()
    written = sum(f.stat().st_size for f in run_dir.glob("trace-*.jsonl"))
    assert snap["evicted_bytes"] > 0
    # What is on disk plus what was deleted is every byte written.
    lines = [json.dumps({"ev": "p", "name": "soak", "ts": 0, "attrs": {"i": i, "pad": "y" * 100}},
                        separators=(",", ":")) for i in range(600)]
    assert written + snap["evicted_bytes"] >= sum(len(ln) + 1 for ln in lines)


def test_rotated_run_reconstructs_spans_across_segments(traced):
    run_dir = traced("t-seg", 0.02)  # about 5 KiB segments
    cm = trace.detached_span("long-lived", tag="spans-the-rotation")
    cm.__enter__()
    trace.point("quarantine", unit="lane:3", reason="rehearsal")
    for i in range(40):
        trace.point("filler", i=i, pad="x" * 100)
    cm.__exit__(None, None, None)
    trace.reset_for_tests()
    files = sorted(run_dir.glob("trace-*.jsonl"))
    assert len(files) >= 2
    # Name order is not write order: -s1 sorts before the bare first segment.
    assert [f.name for f in files] != [f.name for f in sorted(files, key=export._segment_order)]
    run = export.load_run(str(run_dir))
    assert not run.violations and not run.orphans()
    long = [s for s in run.spans.values() if s.name == "long-lived"]
    assert len(long) == 1 and long[0].end_ts is not None
    assert [p["attrs"]["unit"] for p in run.points("quarantine")] == ["lane:3"]
    _same_run(run, jexport.load_run(str(run_dir)))


def test_trace_rotation_survives_failed_segment_open(traced, monkeypatch):
    run_dir = traced("t-rotfail", 0.01)
    trace.point("first")

    def refuse(state):
        raise OSError(28, "No space left on device")

    real = trace._open_segment_locked
    monkeypatch.setattr(trace, "_open_segment_locked", refuse)
    for i in range(200):  # crosses the segment size again and again
        trace.point("soak", i=i, pad="x" * 100)
    dropped_mid = trace.metrics_snapshot().get("dropped", 0)
    monkeypatch.setattr(trace, "_open_segment_locked", real)  # space freed
    trace.point("after", tag="recovered")
    trace.reset_for_tests()
    files = sorted(run_dir.glob("trace-*.jsonl"))
    assert dropped_mid == 0
    pts = [json.loads(ln) for f in files for ln in f.read_text().splitlines()]
    pts = [r for r in pts if r.get("ev") == "p"]
    assert sum(1 for r in pts if r["name"] == "soak") == 200
    assert any(r["name"] == "after" for r in pts)
    assert len(files) >= 2


def _feed_registry(i):
    metrics.counter("serve_requests", 3, mode="ctr")
    metrics.gauge("serve_queue_depth", i % 5)
    for lane in range(8):
        metrics.observe("serve_dispatch_us", 100.0 * (i + lane), lane=lane, outcome="ok")


def test_metrics_rotation_caps_disk_and_keeps_totals(traced):
    cap_mb = 0.02
    run_dir = traced("m-rot", cap_mb)
    for i in range(120):
        _feed_registry(i)
        assert metrics.flush_now()
    files = sorted(run_dir.glob("metrics-*.jsonl"))
    assert len(files) > 1 and all(SEG_NAME.match(f.name) for f in files)
    assert len({SEG_NAME.match(f.name).group(0).split("-")[2] for f in files}) == 1  # one proc
    assert sum(f.stat().st_size for f in files) <= cap_mb * (1 << 20) * 1.2
    assert metrics.evicted_bytes() > 0
    heads = [json.loads(f.read_text().splitlines()[0]) for f in files]
    assert all(h["kind"] == "ot-metrics" for h in heads)
    assert "# TYPE ot_metrics_evicted_bytes_total counter" in metrics.render_prometheus()
    # Snapshots are cumulative: the last surviving one holds the exact totals,
    # and both packages' export fold the segments to the same totals.
    run, jrun = export.load_run(str(run_dir)), jexport.load_run(str(run_dir))
    assert not run.violations and not jrun.violations
    assert run.snapshots[-1]["evicted_bytes"] > 0
    totals = run.metrics_totals()
    assert totals == jrun.metrics_totals()
    assert totals["counters"]["serve_requests{mode=ctr}"] == 360


def test_metrics_rotation_survives_failed_segment_open(traced, monkeypatch):
    run_dir = traced("m-rotfail", 0.01)
    real = metrics._open_segment
    assert metrics.flush_now()  # opens segment 0

    calls = []

    def refuse(sink):
        if sink["seg"]:  # the opener of a next segment
            calls.append(sink["seg"])
            raise OSError(28, "No space left on device")
        return real(sink)

    monkeypatch.setattr(metrics, "_open_segment", refuse)
    for i in range(20):
        _feed_registry(i)
        assert metrics.flush_now()  # the live segment keeps taking lines
    assert calls and metrics.dropped() == 0
    monkeypatch.setattr(metrics, "_open_segment", real)
    _feed_registry(99)
    assert metrics.flush_now()
    files = sorted(run_dir.glob("metrics-*.jsonl"))
    assert len(files) == 2
    lines = [ln for f in files for ln in f.read_text().splitlines()]
    assert sum(1 for ln in lines if '"ts"' in ln and '"kind"' not in ln) == 22


def test_helpers_match_reference_semantics(traced):
    traced("helpers", 0)
    metrics.observe("serve_compile_us", 5.0, engine="cuda", rung=32)
    metrics.observe("serve_compile_us", 9.0, engine="cuda", rung=32)
    metrics.observe("serve_compile_us", 700.0, engine="cuda", rung=0)
    items = sorted(metrics.hist_items("serve_compile_us"), key=lambda it: it[0]["rung"])
    assert [(lb["rung"], h["count"], h["sum"]) for lb, h in items] == [(0, 1, 700.0),
                                                                       (32, 2, 14.0)]
    assert metrics.hist_merged("serve_compile_us") == {3: 1, 4: 1, 10: 1}
    assert metrics._label_str((("a", 1), ("b", "x"))) == "a=1,b=x"
    assert metrics.dropped() == 0 and metrics.evicted_bytes() == 0


# ---------------------------------------------------------------------------
# serve_compile_us: the warmup's builds by rung, through a fake loader.
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_loader(tmp_path, monkeypatch):
    """``cuda_build.load`` with the build and the ``dlopen`` faked: a build
    writes an empty file, a load binds nothing. The plain ``ctr`` and
    ``cbc`` seams load the library first, as the kernel wrappers do."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "library_path", lambda: tmp_path / "_build" / "lib.so")
    monkeypatch.setattr(cuda_build, "_build", lambda so: so.write_bytes(b""))
    monkeypatch.setattr(cuda_build, "_bind", lambda lib: lib)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(cuda_build, "_lib", None)
    monkeypatch.setattr(aes, "_SEAM_CALLS", set())
    for table in (aes.MULTIKEY_CTR, aes.MULTIKEY_CBC):
        plain = table[aes.PLAIN_ENGINE]

        def loading(*args, _plain=plain):
            cuda_build.load()
            return _plain(*args)

        monkeypatch.setitem(table, aes.PLAIN_ENGINE, loading)
    metrics.reset_for_tests()
    yield
    metrics.reset_for_tests()


def _serve(config, payloads):
    async def main():
        server = Server(config)
        await server.start()
        try:
            out = [await server.submit("t0", key, bytes(16), p) for key, p in payloads]
        finally:
            await server.stop()
        return server, out

    return asyncio.run(main())


def test_serve_compile_us_counts_each_build_by_rung(fake_loader, monkeypatch):
    monkeypatch.setenv("OT_PULSE", "0")
    builds0, loads0 = cuda_build._builds, cuda_build._loads
    key128, key256 = bytes(range(16)), bytes(range(32))
    payload = np.arange(64, dtype=np.uint8)
    server, out = _serve(ServerConfig(device="cpu", engine=aes.PLAIN_ENGINE, lanes=1,
                                      modes=("ctr", "cbc"), min_bucket_blocks=32,
                                      max_bucket_blocks=64),
                         [(key128, payload), (key256, payload)])
    assert all(r.ok for r in out)
    assert (cuda_build._builds - builds0, cuda_build._loads - loads0) == (1, 1)
    by_rung = {(lb["engine"], lb["rung"]): h["count"]
               for lb, h in metrics.hist_items("serve_compile_us")}
    # Warmup: the build, the load and the first ctr seam call at the canary
    # rung, the first cbc call at the same rung; the AES-256 request's first
    # seam call outside the walk, at rung 0.
    assert by_rung == {(aes.PLAIN_ENGINE, 32): 4, (aes.PLAIN_ENGINE, 0): 1}
    assert server.warmup_compiles == 4
    assert server.stats()["compiles"] == {"warmup": 4, "steady": 1}
    assert sum(by_rung.values()) == server.warmup_compiles + server.steady_compiles()


def test_seam_first_call_subtracts_the_load_it_triggered(fake_loader, monkeypatch):
    events = []
    monkeypatch.setattr(monitoring, "_LISTENERS", [lambda name, s: events.append((name, s))])
    real_load = cuda_build.load

    def slow_load():
        first = cuda_build._lib is None
        lib = real_load()
        if first:
            cuda_build._load_s += 1000.0  # as if the load had taken 1000 s
        return lib

    monkeypatch.setattr(cuda_build, "load", slow_load)
    w = np.zeros((32, 4), np.int32)
    import torch

    t = torch.from_numpy(w)
    _nr, rk = aes.expand_key_enc(bytes(16))
    rks = torch.from_numpy(np.stack([rk.astype(np.int32)] * 8))
    for _ in range(3):
        aes.ctr_crypt_words_scattered_multikey(t, t, rks, torch.zeros(32, dtype=torch.int32),
                                               10, engine=aes.PLAIN_ENGINE)
    names = [n for n, _ in events]
    # The build, the load, then the seam's first call (once).
    assert names == [monitoring.LIBRARY_LOAD] * 2 + [monitoring.SEAM_FIRST_CALL]
    assert events[-1][1] < 0  # the 1000 s load came off the seam call's time
    assert server_mod._COMPILE_CTX["rung"] == 0
