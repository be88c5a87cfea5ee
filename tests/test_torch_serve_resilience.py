"""The serve side's resilience in the port (``serve/lanes.py``'s fault seams,
the journal-backed quarantine, ``serve.bench --journal/--unquarantine``)
held against the JAX package's on the CPU:

* each fault seam of ``Lane.engine_call`` (``serve_dispatch``,
  ``dispatch_fail``, ``lane_fail`` scoped and plain, ``dispatch_hang``,
  ``lane_hang`` scoped and plain, ``dispatch_slow``) armed the same way on a
  two-lane server of each package, the same sequential requests: the same
  answers, lane states, transition logs, failure, timeout and redispatch
  counters, quarantine events, degrade kinds and journal rows;
* the journal round trip across packages: rows the port's server writes are
  adopted by the JAX server and cleared by the JAX ``clear_failures``, and
  the reverse through ``serve.bench --unquarantine``; a third run starts with
  both lanes healthy;
* the port's lane executor at close: it waits for a worker the watchdog
  abandoned in the ``dispatch_slow`` seam, and not for one parked in an
  injected hang.

The JAX server runs its default engine on this host (the native tier), the
port's the plain version: health and failover do not depend on the engine.
Tolerance: exact."""

import asyncio
import json
import threading
import time

import numpy as np
import pytest

from our_tree_tpu.resilience import degrade as jdegrade
from our_tree_tpu.resilience import faults as jfaults
from our_tree_tpu.resilience import journal as jjournal
from our_tree_tpu.serve.server import Server as JServer
from our_tree_tpu.serve.server import ServerConfig as JServerConfig
from our_tree_tpu_torch.models.aes import AES
from our_tree_tpu_torch.resilience import degrade, faults, journal, watchdog
from our_tree_tpu_torch.serve import bench as serve_bench
from our_tree_tpu_torch.serve import lanes
from our_tree_tpu_torch.serve.dispatch import LaneExecutor
from our_tree_tpu_torch.serve.server import Server, ServerConfig

CFG = dict(min_bucket_blocks=32, max_bucket_blocks=64, lanes=2, probe_every=10_000,
           transfer_chunk_blocks=0)
#: The seams, each with its arming, its retries a lane and the watchdog
#: deadline (a hang needs one).
SEAMS = {
    "dispatch_fail:1": (2, 0.0), "dispatch_fail:2": (2, 0.0), "serve_dispatch:1": (1, 0.0),
    "lane_fail:2@lane=1": (1, 0.0), "lane_fail:1": (1, 0.0), "dispatch_slow:2": (1, 0.0),
    "dispatch_hang:1": (1, 1.0), "lane_hang:1@lane=1": (1, 1.0), "lane_hang:1": (1, 1.0),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("OT_FAULTS", "OT_DISPATCH_DEADLINE", "OT_TRACE_DIR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OT_COST_XLA", "0")
    monkeypatch.setenv("OT_PULSE", "0")
    monkeypatch.setenv("OT_SLOW_S", "0.01")
    for mod in (faults, jfaults):
        mod.reset()
    degrade.clear()
    jdegrade.clear()
    yield
    monkeypatch.delenv("OT_FAULTS", raising=False)
    for mod in (faults, jfaults):
        mod.reset()
    degrade.clear()
    jdegrade.clear()


def _requests(n=6):
    rng = np.random.default_rng(5)
    return [(f"t{i % 2}", rng.bytes(16), rng.bytes(16),
             rng.integers(0, 256, 16 * int(rng.integers(1, 60)), dtype=np.uint8))
            for i in range(n)]


def _serve(port: bool, cfg: dict, spec: str, monkeypatch, reqs):
    """One server's run of ``reqs``, one at a time, with ``spec`` armed:
    (answers, the pool's health, degrade kinds)."""
    fault_mod, deg = (faults, degrade) if port else (jfaults, jdegrade)
    if spec:
        monkeypatch.setenv("OT_FAULTS", spec)
    else:
        monkeypatch.delenv("OT_FAULTS", raising=False)
    fault_mod.reset()
    deg.clear()
    server = (Server(ServerConfig(device="cpu", **cfg)) if port
              else JServer(JServerConfig(**cfg)))

    async def go():
        await server.start()
        try:
            return [await server.submit(t, k, n, p) for t, k, n, p in reqs]
        finally:
            await server.stop()

    answers = asyncio.run(go())
    monkeypatch.delenv("OT_FAULTS", raising=False)
    fault_mod.reset()
    pool = server.pool
    health = {
        "redispatches": pool.redispatches, "quarantine_events": pool.quarantine_events(),
        "lanes": [{"state": ln.state, "dispatches": ln.dispatches, "failures": ln.failures,
                   "timeouts": ln.timeouts, "redispatches_in": ln.redispatches_in,
                   "transitions": [(t["prev"], t["to"], t["why"]) for t in ln.transitions]}
                  for ln in pool.lanes]}
    kinds = sorted(deg.events())
    return ([(r.ok, r.error, None if r.payload is None else np.asarray(r.payload).tobytes())
             for r in answers], health, kinds)


@pytest.mark.parametrize("spec", sorted(SEAMS))
def test_fault_seam_matches_reference(spec, monkeypatch):
    retries, deadline = SEAMS[spec]
    cfg = dict(CFG, retries=retries, dispatch_deadline_s=deadline)
    reqs = _requests()
    got = _serve(True, cfg, spec, monkeypatch, reqs)
    want = _serve(False, cfg, spec, monkeypatch, reqs)
    assert got == want
    answers, health, _kinds = got
    # Failover answers every request, with the host T-table's bytes.
    for (ok, _err, body), (_t, key, nonce, pt) in zip(answers, reqs):
        ref = AES(key, engine="ttable", device="cpu").crypt_ctr(
            0, np.frombuffer(nonce, np.uint8), np.zeros(16, np.uint8), pt)[0]
        assert ok and body == np.asarray(ref).tobytes()
    quarantined = [ln["state"] for ln in health["lanes"]].count(lanes.QUARANTINED)
    assert quarantined == (1 if "hang" in spec or spec == "lane_fail:2@lane=1" else 0)


def _rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_round_trip_across_packages(writer, monkeypatch, tmp_path, capsys):
    """Run 1 (``lane_fail:2@lane=1``, one attempt a lane) quarantines lane 1
    and writes one failure row, byte for byte the same file from either
    package; run 2 on the other package starts lane 1 quarantined
    (``journal:1``) and serves everything on lane 0; the other package's
    release edit clears the row; run 3 starts both lanes healthy."""
    reqs = _requests(4)
    paths = {name: str(tmp_path / f"{name}.jsonl") for name in ("port", "jax")}
    runs = {name: _serve(name == "port", dict(CFG, retries=1, journal=paths[name]),
                         "lane_fail:2@lane=1", monkeypatch, reqs)
            for name in ("port", "jax")}
    assert runs["port"] == runs["jax"]
    assert _rows(paths["port"]) == _rows(paths["jax"])
    assert _rows(paths["port"])[1:] == [{"unit": "lane:1", "failed": True,
                                         "reason": "PolicyExhausted"}]

    reader = "jax" if writer == "port" else "port"
    cfg = dict(CFG, retries=1, journal=paths[writer])
    _answers, health, kinds = _serve(reader == "port", cfg, "", monkeypatch, reqs)
    lane1 = health["lanes"][1]
    assert lane1["state"] == lanes.QUARANTINED and lane1["dispatches"] == 0
    assert lane1["transitions"] == [("healthy", "quarantined", "journal:1")]
    assert "quarantined:lane:1" in kinds

    if reader == "jax":
        assert jjournal.clear_failures(paths[writer], ["lane:1"]) == {"lane:1": 1}
    else:
        capsys.readouterr()
        assert serve_bench.main(["--journal", paths[writer], "--unquarantine", "lane:1"]) == 0
        assert capsys.readouterr().out == "# unquarantine: lane:1: cleared 1 failure row(s)\n"
    j = journal.SweepJournal(paths[writer], {"kind": "serve-lanes", "lanes": 2, "engine": "auto"})
    assert j.fail_count("lane:1") == 0
    j.close()
    _answers, health, _kinds = _serve(writer == "port", cfg, "", monkeypatch, reqs)
    assert [ln["state"] for ln in health["lanes"]] == [lanes.HEALTHY, lanes.HEALTHY]
    assert all(not ln["transitions"] for ln in health["lanes"])


@pytest.mark.parametrize("seam", ["dispatch_slow", "dispatch_hang"])
def test_close_waits_for_abandoned_workers_but_not_parked_hangs(seam, monkeypatch):
    """A worker the watchdog abandoned wakes later and still runs its unit's
    rest; ``close`` waits for it, so no worker of a stopped server is left in
    torch while the interpreter shuts down. A worker parked in an injected
    hang (24 h by default) is not waited for."""
    monkeypatch.setenv("OT_FAULTS", seam)
    monkeypatch.setenv("OT_SLOW_S", "0.6")
    monkeypatch.delenv("OT_HANG_S", raising=False)
    faults.reset()
    ex = LaneExecutor("t-close")
    workers = []

    def unit():
        workers.append(threading.current_thread())
        with watchdog.deadline(0.1, what="slowed unit"):
            watchdog.injected_hang("dispatch_hang")
            faults.injected_slow("dispatch_slow")
        return "late"

    with pytest.raises(watchdog.DispatchTimeout):
        ex.submit(unit).result(5)
    assert ex.abandoned == 1
    (worker,) = workers
    t0 = time.monotonic()
    ex.close()
    waited = time.monotonic() - t0
    if seam == "dispatch_slow":
        assert not worker.is_alive()
    else:
        assert worker.is_alive() and watchdog.parked(worker) and waited < 1.0
