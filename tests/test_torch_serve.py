"""The port's CTR serve path (``our_tree_tpu_torch.serve``) against the JAX
package's (``our_tree_tpu.serve``) on the same seeded requests: the ladder
and rung-packer give the same batches, the keycache and the queue make the
same decisions, and a whole server answers every request with the same
bytes and codes. Then the port's own contracts on the CPU: failover,
deadline, drain, the bench CLI and the no-card refusal. Integer
cryptography: the tolerance is zero."""

import asyncio
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from our_tree_tpu.resilience import degrade as jdegrade
from our_tree_tpu.serve import batcher as jbatcher
from our_tree_tpu.serve import keycache as jkeycache
from our_tree_tpu.serve import queue as jqueue
from our_tree_tpu.serve.server import Server as JServer
from our_tree_tpu.serve.server import ServerConfig as JServerConfig
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.resilience import degrade, watchdog
from our_tree_tpu_torch.serve import batcher, keycache, lanes
from our_tree_tpu_torch.serve import bench as serve_bench
from our_tree_tpu_torch.serve import queue as otq
from our_tree_tpu_torch.serve.server import Server, ServerConfig

LADDER = dict(min_bucket_blocks=32, max_bucket_blocks=256)
NIST_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
NIST_CTR0 = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
NIST_PT = bytes.fromhex("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
                        "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
NIST_CT = bytes.fromhex("874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
                        "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee")


@pytest.fixture(autouse=True)
def _clean_ledgers(monkeypatch):
    monkeypatch.delenv("OT_DISPATCH_DEADLINE", raising=False)
    monkeypatch.delenv("OT_TRACE_DIR", raising=False)
    degrade.clear()
    jdegrade.clear()
    yield
    degrade.clear()
    jdegrade.clear()


def _ref_ctr(key: bytes, nonce: bytes, payload: np.ndarray) -> np.ndarray:
    ctx = aes.AES(key, engine=aes.TTABLE_ENGINE, device="cpu")
    return ctx.crypt_ctr(0, np.frombuffer(nonce, np.uint8), np.zeros(16, np.uint8), payload)[0]


def _request_specs(seed, n=40, sizes=(16, 48, 256, 1024, 2048, 4096), tenants=3,
                   keys_per_tenant=2, key_bytes=(16,)):
    """Seeded (tenant, key, nonce, payload) tuples: ``tenants`` x
    ``keys_per_tenant`` keys, sizes drawn from ``sizes``."""
    rng = np.random.default_rng(seed)
    keys = {(t, k): rng.integers(0, 256, int(rng.choice(key_bytes)), dtype=np.uint8).tobytes()
            for t in range(tenants) for k in range(keys_per_tenant)}
    specs = []
    for _ in range(n):
        t, k = int(rng.integers(tenants)), int(rng.integers(keys_per_tenant))
        nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        payload = rng.integers(0, 256, int(rng.choice(sizes)), dtype=np.uint8)
        specs.append((f"t{t}", keys[(t, k)], nonce, payload))
    return specs


def _run(server, fn):
    async def main():
        await server.start()
        try:
            return await fn(server)
        finally:
            await server.stop()

    return asyncio.run(main())


# ---------------------------------------------------------------------------
# Ladder, rung-packer, keycache and queue against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bounds", [(32, 4096), (32, 256), (1, 1), (3, 100), (64, 64)])
def test_bucket_ladder_and_bucket_for_match_reference(bounds):
    rungs = batcher.bucket_ladder(*bounds)
    assert rungs == jbatcher.bucket_ladder(*bounds)
    for n in range(1, rungs[-1] + 1, max(rungs[-1] // 97, 1)):
        assert batcher.bucket_for(n, rungs) == jbatcher.bucket_for(n, rungs)
    with pytest.raises(ValueError):
        batcher.bucket_for(rungs[-1] + 1, rungs)
    with pytest.raises(ValueError):
        batcher.bucket_ladder(bounds[1] + 1, bounds[1])


@pytest.mark.parametrize("key_slots", [1, 3, 8])
def test_form_batches_match_reference(key_slots):
    """The same request list through both rung-packers: the same batches,
    slots, rungs, runs and slot vectors, and bit-equal dispatch arrays.
    Key lengths mix, so the nr flush runs too."""
    specs = _request_specs(7, n=60, sizes=(16, 32, 256, 512, 1024, 4096),
                           key_bytes=(16, 16, 32))
    mine = [otq.Request(id=i, tenant=t, key=k, nonce=n, payload=p, future=None)
            for i, (t, k, n, p) in enumerate(specs)]
    ref = [jqueue.Request(id=i, tenant=t, key=k, nonce=n, payload=p, future=None)
           for i, (t, k, n, p) in enumerate(specs)]
    rungs = batcher.bucket_ladder(32, 256)
    got = batcher.form_batches(mine, rungs, keycache.key_digest, key_slots)
    want = jbatcher.form_batches(ref, rungs, jkeycache.key_digest, key_slots)
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert (g.bucket, g.blocks, g.nr, g.key_slots, g.label) == (
            w.bucket, w.blocks, w.nr, w.key_slots, w.label)
        assert [(s.tenant, s.digest, s.blocks, [r.id for r in s.requests]) for s in g.slots] == \
            [(s.tenant, s.digest, s.blocks, [r.id for r in s.requests]) for s in w.slots]
        g.materialise()
        w.materialise()
        assert g.req_spans == w.req_spans
        for name in ("words", "ctr_words", "slot_index"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        fake_out = np.arange(4 * g.bucket, dtype=np.uint32)
        for a, b in zip(g.split_output(fake_out), w.split_output(fake_out)):
            np.testing.assert_array_equal(a, b)


def test_keycache_matches_reference():
    """LRU per tenant, tenant isolation and the memo of stacks: the same
    calls give the same digests, schedules, stacks and counts."""
    mine, ref = keycache.KeyCache(per_tenant=2, stacked_capacity=3), \
        jkeycache.KeyCache(per_tenant=2, stacked_capacity=3)
    rng = np.random.default_rng(3)
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(4)]
    calls = [("a", 0), ("a", 1), ("a", 0), ("a", 2), ("a", 1), ("b", 0), ("b", 0), ("a", 0)]
    for tenant, k in calls:
        g, w = mine.get(tenant, keys[k]), ref.get(tenant, keys[k])
        assert g[0] == w[0] and g[1] == w[1]
        np.testing.assert_array_equal(g[2], w[2])
    for tenant, k in calls:
        assert mine.holds(tenant, keys[k]) == ref.holds(tenant, keys[k])
    stacks = [[("a", keys[0]), ("b", keys[1])], [("a", keys[0])], [("a", keys[0]), ("b", keys[1])],
              [("c", keys[2]), ("c", keys[3])], [("d", keys[0])], [("a", keys[0])]]
    for slots in stacks:
        g, w = mine.stacked(slots, 4), ref.stacked(slots, 4)
        assert g.nr == w.nr and g.digests == w.digests
        np.testing.assert_array_equal(g.rks, w.rks)
    ref_stats = ref.stats()
    assert mine.stats() == {k: ref_stats[k] for k in mine.stats()}
    with pytest.raises(ValueError, match="mixed key lengths"):
        mine.stacked([("a", keys[0]), ("a", bytes(32))], 4)
    with pytest.raises(ValueError):
        mine.stacked([], 4)


def test_queue_admission_shedding_and_deadlines_match_reference():
    """Refusals, the three shed reasons and deadline expiry give the same
    codes and counts in both queues."""
    async def drive(mod, clock):
        q = mod.RequestQueue(max_depth=6, max_request_blocks=8, default_deadline_s=1.0,
                             tenant_depth_frac=0.5, low_priority_tenants=("low",),
                             priority_depth_frac=0.5, clock=lambda: clock["t"])
        z = np.zeros(16, np.uint8)
        futs = [
            q.submit("t", b"k" * 16, b"n" * 16, np.zeros(15, np.uint8)),
            q.submit("t", b"k" * 16, b"n" * 8, z),
            q.submit("t", b"k" * 16, b"n" * 16, np.zeros(16 * 9, np.uint8)),
            q.submit("t", b"k" * 15, b"n" * 16, z),
            q.submit("t", b"k" * 16, b"n" * 16, z, mode="gcm"),
            q.submit("t", b"k" * 16, b"n" * 16, z, mode="bogus"),
            q.submit("hog", b"k" * 16, b"n" * 16, z),
            q.submit("hog", b"k" * 16, b"n" * 16, z, deadline_s=10.0),
            q.submit("hog", b"k" * 16, b"n" * 16, z),
            q.submit("hog", b"k" * 16, b"n" * 16, z),
            q.submit("low", b"k" * 16, b"n" * 16, z),
            q.submit("t", b"k" * 16, b"n" * 16, z, priority=0),
            q.submit("t", b"k" * 16, b"n" * 16, z),
            q.submit("u", b"k" * 16, b"n" * 16, z),
            q.submit("v", b"k" * 16, b"n" * 16, z),
            q.submit("w", b"k" * 16, b"n" * 16, z),
        ]
        clock["t"] = 2.0
        live = q.drain()
        for r in live:
            r.fail(mod.ERR_SHUTDOWN)
        codes = [(await f).error for f in futs]
        stats = q.stats()
        return codes, [r.id for r in live], stats

    got = asyncio.run(drive(otq, {"t": 0.0}))
    want = asyncio.run(drive(jqueue, {"t": 0.0}))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    codes = got[0]
    assert codes[:6] == [otq.ERR_BAD_REQUEST, otq.ERR_BAD_REQUEST, otq.ERR_TOO_LARGE,
                         otq.ERR_BAD_REQUEST, otq.ERR_BAD_REQUEST, otq.ERR_BAD_REQUEST]
    assert {"shed", "deadline", "shutdown"} <= set(codes)
    assert got[2]["shed_tenant"] >= 1 and got[2]["shed_priority"] >= 1
    assert got[2]["shed"] > got[2]["shed_tenant"] + got[2]["shed_priority"]
    assert got[2]["expired"] >= 1
    assert {"accept->shed", "tenant->shed", "priority->shed"} <= set(degrade.events())


# ---------------------------------------------------------------------------
# The slice as a whole: the same requests through both servers.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["auto", aes.CUDA_ENGINE])
def test_server_answers_match_reference_server(engine, monkeypatch):
    """Seeded mixed sizes up to the 256-block rung plus one above it, 6 keys
    over 3 tenants, through the JAX server (jnp engine) and the port's on
    the CPU. ``auto`` on the CPU is the native C tier (its ``ctr`` makes no
    first seam call); ``cuda`` with CPU tensors takes the kernels' plain
    versions through the same wrappers. Every response's bytes and code
    must be equal."""
    specs = _request_specs(11, n=36, sizes=(16, 48, 256, 1024, 4096))
    specs.append(("t1", specs[0][1], specs[0][2], np.arange(4112, dtype=np.uint8)))

    async def drive(server):
        return await asyncio.gather(*(server.submit(t, k, n, p) for t, k, n, p in specs))

    want = _run(JServer(JServerConfig(engine="jnp", lanes=1, transfer_chunk_blocks=0, **LADDER)),
                drive)
    monkeypatch.setattr(aes, "_SEAM_CALLS", set())
    # Transfers off on both servers: the request above the top rung answers
    # too-large (with transfers on, tests/test_torch_transfer.py).
    server = Server(ServerConfig(device="cpu", engine=engine, lanes=1, transfer_chunk_blocks=0,
                                 **LADDER))
    got = _run(server, drive)
    assert server.engine == (aes.NATIVE_ENGINE if engine == "auto" else engine)
    for g, w in zip(got, want):
        assert (g.ok, g.error) == (w.ok, w.error)
        if g.ok:
            np.testing.assert_array_equal(np.asarray(g.payload), np.asarray(w.payload))
    assert got[-1].error == otq.ERR_TOO_LARGE
    assert sum(r.ok for r in got) == len(specs) - 1
    for (_t, k, n, p), g in zip(specs[:5], got[:5]):
        np.testing.assert_array_equal(np.asarray(g.payload), _ref_ctr(k, n, p))
    stats = server.stats()
    # Warmup made the one first seam call (128-bit keys, nr 10), none on the
    # native tier; traffic none.
    warm = 0 if server.engine == aes.NATIVE_ENGINE else 1
    assert stats["queue"]["lost"] == 0 and stats["compiles"] == {"warmup": warm, "steady": 0}
    assert stats["lanes"]["engine_calls"] == len(server.rungs) + stats["batches"]


# ---------------------------------------------------------------------------
# The port's own contracts.
# ---------------------------------------------------------------------------


def _submit_n(server, n, size=256, tenant="t0", seed=5):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    reqs = [(rng.integers(0, 256, 16, dtype=np.uint8).tobytes(),
             rng.integers(0, 256, size, dtype=np.uint8)) for _ in range(n)]
    return key, reqs, [server.submit(tenant, key, nonce, p) for nonce, p in reqs]


def test_two_lane_failover_bit_exact_and_quarantine(monkeypatch):
    """Lane 0's engine call raises on traffic: every batch fails over to
    lane 1 bit-exactly (the NIST KAT among them), nothing is lost, and
    lane 0 goes suspect, then quarantined."""
    real = lanes.Lane.engine_call

    def flaky(self, *a, warmup=False, **kw):
        if self.idx == 0 and not warmup:
            raise RuntimeError("lane 0 is sick")
        return real(self, *a, warmup=warmup, **kw)

    monkeypatch.setattr(lanes.Lane, "engine_call", flaky)

    async def drive(server):
        out = []
        for rnd in range(3):
            key, reqs, futs = _submit_n(server, 3, seed=rnd)
            kat = server.submit("kat", NIST_KEY, NIST_CTR0, np.frombuffer(NIST_PT, np.uint8))
            resps = await asyncio.gather(kat, *futs)
            out.append((key, reqs, resps))
        return out

    server = Server(ServerConfig(device="cpu", lanes=2, retries=1, probe_every=1000, **LADDER))
    rounds = _run(server, drive)
    for key, reqs, resps in rounds:
        assert all(r.ok for r in resps)
        assert bytes(np.asarray(resps[0].payload)) == NIST_CT
        for (nonce, p), r in zip(reqs, resps[1:]):
            np.testing.assert_array_equal(np.asarray(r.payload), _ref_ctr(key, nonce, p))
    lane0 = server.pool.lanes[0]
    assert lane0.state == lanes.QUARANTINED
    assert [t["to"] for t in lane0.transitions] == [lanes.SUSPECT, lanes.QUARANTINED]
    assert server.pool.redispatches >= 2 and server.pool.lanes[1].redispatches_in >= 2
    assert server.queue.stats()["lost"] == 0 and server.batches_failed == 0
    assert "quarantined:lane:0" in degrade.events()


def test_crash_dir_defaults_under_the_temporary_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("OT_CRASH_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert watchdog.crash_dir() == str(tmp_path / "ot_crash")
    monkeypatch.setenv("OT_CRASH_DIR", str(tmp_path / "elsewhere"))
    assert watchdog.crash_dir() == str(tmp_path / "elsewhere")


@pytest.mark.parametrize("warm_bits,steady", [((128,), 1), ((128, 256), 0)])
def test_steady_compile_gate_sees_an_unwarmed_key_length(monkeypatch, warm_bits, steady):
    """The zero-recompile count sees the first seam call at a key length
    that warmup did not cover (on the card: a ``ctr_mk`` instantiation's
    first launch), and stays 0 when warmup covered it."""
    monkeypatch.setattr(aes, "_SEAM_CALLS", set())
    rng = np.random.default_rng(17)
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    nonce, payload = bytes(16), rng.integers(0, 256, 112, dtype=np.uint8)

    async def drive(server):
        return await server.submit("t0", key, nonce, payload)

    server = Server(ServerConfig(device="cpu", engine=aes.PLAIN_ENGINE, lanes=1,
                                 warmup_key_bits=warm_bits, **LADDER))
    resp = _run(server, drive)
    assert resp.ok
    np.testing.assert_array_equal(np.asarray(resp.payload), _ref_ctr(key, nonce, payload))
    assert server.warmup_compiles == len(warm_bits)
    assert server.stats()["compiles"] == {"warmup": len(warm_bits), "steady": steady}


def test_deadline_hang_answers_deadline_and_server_stays_up(monkeypatch, tmp_path):
    """One traffic dispatch sleeps past the lane's watchdog deadline: its
    riders answer ``deadline``, the lane is quarantined, the watchdog's
    stack dump lands in ``OT_CRASH_DIR``, and the next requests are served
    after the canary releases it."""
    crash = tmp_path / "crash"
    monkeypatch.setenv("OT_CRASH_DIR", str(crash))
    real = lanes.Lane._call_cpu
    state = {"calls": 0}
    woke = threading.Event()

    def hang_once(self, *a, **kw):
        state["calls"] += 1
        if state["calls"] == len(server.rungs) + 1:  # the first traffic dispatch
            time.sleep(1.5)
            woke.set()
        return real(self, *a, **kw)

    monkeypatch.setattr(lanes.Lane, "_call_cpu", hang_once)

    async def drive(server):
        _k, _r, futs = _submit_n(server, 2)
        first = await asyncio.gather(*futs)
        key, reqs, futs = _submit_n(server, 3, seed=9)
        later = await asyncio.gather(*futs)
        return first, key, reqs, later

    server = Server(ServerConfig(device="cpu", engine=aes.PLAIN_ENGINE, lanes=1, retries=1,
                                 dispatch_deadline_s=0.3, **LADDER))
    first, key, reqs, later = _run(server, drive)
    assert [r.error for r in first] == [otq.ERR_DEADLINE] * 2
    assert all(r.ok for r in later)
    for (nonce, p), r in zip(reqs, later):
        np.testing.assert_array_equal(np.asarray(r.payload), _ref_ctr(key, nonce, p))
    lane = server.pool.lanes[0]
    assert lane.timeouts == 1 and lane.canaries >= 1
    assert [t["to"] for t in lane.transitions][:2] == [lanes.QUARANTINED, lanes.PROBATION]
    assert server.batches_timed_out == 1 and server.queue.stats()["lost"] == 0
    assert server.pool.stats()["abandoned_workers"] == 1
    assert "dispatch-timeout" in degrade.events()
    reports = list(crash.glob("watchdog-*.txt"))
    assert len(reports) == 1 and "exceeded" in reports[0].read_text()
    assert woke.wait(5)


def test_stop_drains_with_nothing_lost():
    """stop() while requests are queued and in flight: every accepted
    request is answered with its bytes."""
    async def drive(server):
        key, reqs, futs = _submit_n(server, 24, size=1024)
        tasks = [asyncio.ensure_future(f) for f in futs]
        await asyncio.sleep(0)
        await server.stop()
        return key, reqs, await asyncio.gather(*tasks)

    server = Server(ServerConfig(device="cpu", lanes=2, **LADDER))

    async def main():
        await server.start()
        return await drive(server)

    key, reqs, resps = asyncio.run(main())
    assert all(r.ok for r in resps)
    for (nonce, p), r in zip(reqs, resps):
        np.testing.assert_array_equal(np.asarray(r.payload), _ref_ctr(key, nonce, p))
    q = server.queue.stats()
    assert q["lost"] == 0 and q["accepted"] == q["answered"] == 24


def test_bench_cli_on_cpu(capsys, tmp_path):
    art = tmp_path / "serve.json"
    rc = serve_bench.main(["--device", "cpu", "--engine", "bitslice", "--requests", "40",
                           "--concurrency", "8",
                           "--sizes", "16,256,1024,4096", "--bucket-max", "256",
                           "--verify-every", "4", "--artifact", str(art)])
    out = capsys.readouterr().out.strip().splitlines()
    import json

    line = json.loads(out[-1])
    assert rc == 0
    assert line["engine"] == aes.PLAIN_ENGINE and line["config"]["device"] == "cpu"
    assert line["lost"] == 0 and line["mismatches"] == 0 and line["recompiles"] == 0
    assert line["ok"] == line["requests"] == 40 and line["verified"] == 10
    assert line["engine_calls"] == 4 + line["batches"]["batches"]
    assert {"config", "load", "batches", "coalesce", "occupancy", "compiles", "keycache",
            "lanes", "queue", "device", "stages"} <= set(line)
    first = line["device"]["first_dispatch"]
    assert first["rung"] in (32, 64, 128, 256) and first["window_us"] >= first["device_us"] > 0
    assert line["device"]["window_p50_us"] > 0 and line["device"]["device_p50_us"] > 0
    assert any(o.startswith("# first traffic dispatch") for o in out)
    doc = json.loads(art.read_text())
    assert doc["load"]["ok"] == 40 and doc["queue"]["lost"] == 0
    assert {"backend_queue", "pack", "device", "reply"} <= set(doc["stages"])
    rc = serve_bench.main(["--device", "cpu", "--requests", "30", "--tenant-heavy",
                           "--bucket-max", "256", "--min-coalesce", "1.01"])
    assert rc == 1  # the coalesce gate fails a run that cannot reach it


def test_default_config_without_card_raises_at_start(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    server = Server()
    assert server.config.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(server.start())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bench.main(["--requests", "1"])
    # The native tier does not move a card's server to the CPU: without a
    # card it raises as the kernels do.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(Server(ServerConfig(engine="native")).start())
