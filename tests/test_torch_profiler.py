"""The port's capture window (``our_tree_tpu_torch.obs.profiler``) against the
JAX package's (``our_tree_tpu.obs.profiler``): the same summary rows and the
same cross-check from the same registry snapshots; then the window's own
contracts on the CPU: the stack tier around a serve drive, the torch tier
(forced) exporting its trace, one window at a time, tracing required.
``OT_TRACE_DIR`` points at each test's ``tmp_path``."""

import asyncio
import json
import os
import time

import numpy as np
import pytest

from our_tree_tpu.obs import profiler as jprof
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.obs import costmodel, metrics, profiler, trace
from our_tree_tpu_torch.resilience import watchdog
from our_tree_tpu_torch.serve.server import Server, ServerConfig


@pytest.fixture(autouse=True)
def _trace_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("OT_TRACE_DIR", str(tmp_path))
    monkeypatch.delenv("OT_TRACE_RUN", raising=False)
    monkeypatch.delenv("OT_PROFILE_TIER", raising=False)
    monkeypatch.delenv("OT_DISPATCH_DEADLINE", raising=False)
    profiler.reset_for_tests()
    metrics.reset()
    yield
    profiler.reset_for_tests()
    metrics.reset()


def _snapshots(engine):
    """(before, after) registry snapshots: two rungs dispatched in the
    window, one idle, stage histograms that moved and one that did not."""
    def snap(scale):
        counters, hists = {}, {}
        for rung, disp, dev_us in ((32, 4, 300), (4096, 2, 5000), (256, 1, 700)):
            labels = f"engine={engine},mode=ctr,nr=10,rung={rung}"
            moves = rung != 256
            counters[f"serve_rung_dispatches{{{labels}}}"] = disp * (scale if moves else 1)
            counters[f"serve_rung_device_us{{{labels}}}"] = dev_us * (scale if moves else 1)
        counters["serve_lane_busy_us{lane=0}"] = 9000.0 * scale
        counters["serve_device_us{lane=0}"] = 6000.0 * scale
        counters["serve_requests"] = 10.0 * scale
        for stage, count, total in (("pack", 10, 500.0), ("device", 6, 5300.0)):
            hists[f"serve_stage_us{{stage={stage}}}"] = {"buckets": {}, "count": count * scale,
                                                         "sum": total * scale}
        hists["serve_stage_us{stage=reply}"] = {"buckets": {}, "count": 3, "sum": 30.0}
        hists["serve_dispatch_us{lane=0}"] = {"buckets": {}, "count": 7 * scale, "sum": 1.0}
        return {"counters": counters, "gauges": {}, "hists": hists}

    return snap(1), snap(3)


FIELDS = ("rungs", "stages", "busy_us", "device_us", "host_us", "armed_by", "tier", "seq",
          "t0_us", "t1_us", "seconds", "kind", "v")


def test_summarise_and_crosscheck_match_jax():
    engine = aes.CUDA_ENGINE
    before, after = _snapshots(engine)
    entry = {"before": before, "run": "r1", "seq": 3, "t0_us": 100, "t1_us": 2_000_100,
             "measured_s": 2.0, "t0_mono": time.monotonic(), "armed_by": "cli",
             "tier": "stack"}
    got = profiler._summarise({**entry, "torch_dir": None}, after, {}, 0)
    want = jprof._summarise({**entry, "jax_dir": None}, after, {}, 0)
    assert {f: got[f] for f in FIELDS} == {f: want[f] for f in FIELDS}
    assert [r["rung"] for r in got["rungs"]] == [32, 4096]
    assert profiler.validate_summary(got) == []
    recs = costmodel.ladder_costs(engine, ("ctr",), (32, 256, 4096))
    for ceiling in (None, 50.0):
        assert profiler.crosscheck(got, recs, ceiling) == jprof.crosscheck(want, recs, ceiling)
    rows = profiler.crosscheck(got, recs, 50.0)["rows"]
    assert [r["dispatches"] for r in rows] == [8, 4]
    assert all(r["modeled_dispatch_bytes"] == 52 * r["rung"] + 8 * 4 * 11 * 4 for r in rows)
    # A rung without a record has no modeled bytes and no rate.
    assert profiler.crosscheck(got, recs[:1], None)["rows"][1]["window_gbps"] is None


def test_validate_summary_flags_what_the_reference_flags():
    good = {**dict.fromkeys(profiler.REQUIRED_KEYS, 0), "kind": profiler.KIND, "tier": "stack",
            "armed_by": "cli", "rungs": [], "stages": {}}
    for doc in (None, {"kind": "x", "tier": "stack"}, {**good, "rungs": [{}]}, {**good, "armed_by": "nobody"},
                {**good, "stages": []}, good):
        assert profiler.validate_summary(doc) == jprof.validate_summary(doc)
    assert profiler.validate_summary(good) == []
    assert profiler.validate_summary({**good, "tier": "jax"}) == [
        "tier 'jax' outside ('torch', 'stack')"]


def test_stack_window_around_cpu_serve_drive():
    server = Server(ServerConfig(device="cpu", min_bucket_blocks=32, max_bucket_blocks=256))

    async def main():
        await server.start()
        try:
            out = profiler.start_window(None, armed_by="api", device=server.device)
            assert out["tier"] == "stack" and "torch_dir" not in out
            assert profiler.active()["seq"] == out["seq"]
            rng = np.random.default_rng(3)
            key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            resps = await asyncio.gather(*[
                server.submit("t0", key, rng.integers(0, 256, 16, dtype=np.uint8).tobytes(),
                              rng.integers(0, 256, 1024, dtype=np.uint8)) for _ in range(12)])
            assert all(r.ok for r in resps)
            await asyncio.sleep(0.1)
            return profiler.stop_window(expected_seq=out["seq"])
        finally:
            await server.stop()

    path = asyncio.run(main())
    assert path is not None and os.path.dirname(path) == trace.run_dir()
    doc = profiler.load_summary(path)
    assert profiler.validate_summary(doc) == []
    assert doc == profiler.last_summary()
    assert doc["tier"] == "stack" and doc["armed_by"] == "api" and doc["samples"] >= 1
    assert sum(r["dispatches"] for r in doc["rungs"]) >= 1
    assert doc["busy_us"] >= doc["device_us"] > 0
    assert profiler.list_summaries(trace.run_dir()) == [path]
    assert profiler.active() is None and profiler.wait_idle(1.0)


def test_one_window_at_a_time_and_bounded_close():
    out = profiler.start_window(0.2, armed_by="cli", device="cpu")
    with pytest.raises(profiler.CaptureBusy):
        profiler.start_window(1.0, armed_by="api", device="cpu")
    # A closer of another window leaves this one open.
    assert profiler.stop_window(expected_seq=out["seq"] + 100) is None
    assert profiler.wait_idle(5.0)
    doc = profiler.last_summary()
    assert doc["seq"] == out["seq"] and 0.15 <= doc["seconds"] < 2.0
    # The next window may open; finish() closes it at once.
    nxt = profiler.start_window(30.0, armed_by="api", device="cpu")
    assert nxt["seq"] > out["seq"]
    assert profiler.finish() is not None and profiler.active() is None


def test_tracing_off_refuses(monkeypatch):
    monkeypatch.delenv("OT_TRACE_DIR")
    with pytest.raises(profiler.CaptureDisabled, match="OT_TRACE_DIR"):
        profiler.start_window(1.0, device="cpu")
    assert profiler.active() is None


def test_tier_choice(monkeypatch):
    assert profiler._resolve_tier("cuda") == ("torch", True)
    assert profiler._resolve_tier("cuda:1") == ("torch", True)
    assert profiler._resolve_tier("cpu") == ("stack", False)
    assert profiler._resolve_tier(None) == ("stack", False)
    monkeypatch.setenv("OT_PROFILE_TIER", "stack")
    assert profiler._resolve_tier("cuda") == ("stack", True)
    monkeypatch.setenv("OT_PROFILE_TIER", "jax")  # not a tier of the port
    assert profiler.tier_override() is None
    monkeypatch.setenv("OT_PROFILE_HZ", "1000")
    assert profiler.sample_hz() == 200.0


def test_forced_torch_tier_on_cpu_exports_trace(monkeypatch):
    import torch

    monkeypatch.setenv("OT_PROFILE_TIER", "torch")
    out = profiler.start_window(None, armed_by="api", device="cpu")
    assert out["tier"] == "torch" and out["torch_dir"].endswith(".torchtrace")
    (torch.arange(1000) ^ 7).sum()  # on this thread, not the capture thread
    path = profiler.stop_window()
    doc = profiler.load_summary(path)
    assert profiler.validate_summary(doc) == [] and doc["tier"] == "torch"
    assert doc["torch_dir"] == os.path.basename(out["torch_dir"])
    with open(os.path.join(trace.run_dir(), doc["torch_dir"], "trace.json")) as fh:
        ops = {e.get("name") for e in json.load(fh)["traceEvents"] if e.get("cat") == "cpu_op"}
    assert {"aten::bitwise_xor", "aten::sum"} <= ops


def test_torch_window_opens_only_once_the_profiler_runs(monkeypatch):
    """``start_window`` returns after the capture thread has entered the
    profiler (a slow start, as CUPTI's first one is, must not leave the
    window's first traffic uncaptured), and the same thread exits it."""
    import threading

    import torch

    log = []

    class SlowProfiler:
        def __init__(self, activities, experimental_config):
            log.append(("init", tuple(activities)))

        def __enter__(self):
            time.sleep(0.3)
            log.append(("entered", threading.get_ident()))
            return self

        def __exit__(self, *exc):
            log.append(("exited", threading.get_ident()))

        def export_chrome_trace(self, path):
            with open(path, "w") as fh:
                json.dump({"traceEvents": []}, fh)

    monkeypatch.setattr(torch.profiler, "profile", SlowProfiler)
    out = profiler.start_window(None, armed_by="api", device="cuda")
    assert [e[0] for e in log] == ["init", "entered"]
    assert log[0][1] == (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    assert log[1][1] != threading.get_ident()
    assert profiler.stop_window(expected_seq=out["seq"]) is not None
    assert log[2] == ("exited", log[1][1])
    assert profiler.last_summary()["torch_dir"] == os.path.basename(out["torch_dir"])


def test_torch_tier_that_fails_to_start_is_not_armed(monkeypatch):
    import torch

    def broken(**_kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.raises(profiler.CaptureDisabled, match="failed to start"):
        profiler.start_window(1.0, armed_by="cli", device="cuda")
    assert profiler.active() is None and profiler.last_summary() is None


def test_current_stacks_names_threads():
    stacks = watchdog.current_stacks(depth=2)
    import threading

    name, frames = stacks[threading.get_ident()]
    assert name == threading.current_thread().name
    # Leaf first: the walk itself, then its caller.
    assert len(frames) == 2 and frames[0].startswith("current_stacks (watchdog.py:")
    assert frames[1].startswith("test_current_stacks_names_threads (test_torch_profiler.py:")
