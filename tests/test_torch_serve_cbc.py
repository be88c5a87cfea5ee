"""The ``cbc`` serve mode (parallel multi-key CBC decrypt) of the port's
serve stack against the JAX package's on the same seeded requests: the
keycache's decrypt-schedule stack and memo, the CBC batch layout (words,
PREV stream, slots, spans), the admission refusals code for code, a mixed
``ctr,cbc`` server's answers, and the analytic cost row. Then the port's
own contracts on the CPU: a two-lane failover replay of a ``cbc`` batch,
the bench CLI with ``--modes ctr,cbc``, and the configuration of every
served mode (an unknown one refused). Integer cryptography: the
tolerance is zero."""

import asyncio
import json

import numpy as np
import pytest

from our_tree_tpu.obs import costmodel as jcost
from our_tree_tpu.obs import metrics as jmetrics
from our_tree_tpu.resilience import degrade as jdegrade
from our_tree_tpu.serve import batcher as jbatcher
from our_tree_tpu.serve import keycache as jkeycache
from our_tree_tpu.serve import queue as jqueue
from our_tree_tpu.serve.server import Server as JServer
from our_tree_tpu.serve.server import ServerConfig as JServerConfig
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.obs import costmodel
from our_tree_tpu_torch.resilience import degrade
from our_tree_tpu_torch.serve import batcher, keycache, lanes, loadgen
from our_tree_tpu_torch.serve import bench as serve_bench
from our_tree_tpu_torch.serve import queue as otq
from our_tree_tpu_torch.serve.server import Server, ServerConfig

LADDER = dict(min_bucket_blocks=32, max_bucket_blocks=256)
MODES = ("ctr", "cbc")
SP800_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
SP800_IV = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
SP800_PT = bytes.fromhex("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
                         "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
SP800_CBC_CT = bytes.fromhex("7649abac8119b246cee98e9b12e9197d5086cb9b507219ee95db113a917678b2"
                             "73bed6b8e3c1743b7116e69e222295163ff1caa1681fac09120eca307586e1a7")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("OT_DISPATCH_DEADLINE", raising=False)
    monkeypatch.delenv("OT_TRACE_DIR", raising=False)
    monkeypatch.setenv("OT_COST_XLA", "0")
    degrade.clear()
    jdegrade.clear()
    yield
    degrade.clear()
    jdegrade.clear()
    # The JAX servers' counters stay with this file: a JAX test later in
    # the same process reads the registry's modes.
    jmetrics.reset_for_tests()


def _specs(seed, n=40, sizes=(16, 48, 256, 1024, 2048, 4096), key_bytes=(16,)):
    """Seeded (tenant, key, mode, nonce, iv, payload): 3 tenants x 2 keys, each
    request ctr or cbc."""
    rng = np.random.default_rng(seed)
    keys = {(t, k): rng.integers(0, 256, int(rng.choice(key_bytes)), dtype=np.uint8).tobytes()
            for t in range(3) for k in range(2)}
    out = []
    for _ in range(n):
        t, k = int(rng.integers(3)), int(rng.integers(2))
        mode = MODES[int(rng.integers(2))]
        nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes() if mode == "ctr" else b""
        iv = rng.integers(0, 256, 16, dtype=np.uint8).tobytes() if mode == "cbc" else b""
        payload = rng.integers(0, 256, int(rng.choice(sizes)), dtype=np.uint8)
        out.append((f"t{t}", keys[(t, k)], mode, nonce, iv, payload))
    return out


def _run(server, fn):
    async def main():
        await server.start()
        try:
            return await fn(server)
        finally:
            await server.stop()

    return asyncio.run(main())


def _ref_cbc_decrypt(key: bytes, iv: bytes, ct: np.ndarray) -> np.ndarray:
    ctx = aes.AES(key, engine=aes.TTABLE_ENGINE, device="cpu")
    return ctx.crypt_cbc(aes.AES_DECRYPT, np.frombuffer(iv, np.uint8), ct)[0]


def test_keycache_decrypt_stack_matches_reference():
    """``stacked(..., mode="cbc")`` attaches the same decrypt schedules, and
    the per-digest memo and the cache's counts move as the reference's, over
    a sequence of ctr and cbc stacks that hits, misses and evicts."""
    mine = keycache.KeyCache(per_tenant=2, stacked_capacity=2)
    ref = jkeycache.KeyCache(per_tenant=2, stacked_capacity=2)
    rng = np.random.default_rng(3)
    keys = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (16, 16, 16, 32, 32)]
    calls = [([("a", keys[0]), ("b", keys[1])], "ctr"),
             ([("a", keys[0]), ("b", keys[1])], "cbc"),
             ([("a", keys[0])], "cbc"),
             ([("c", keys[2]), ("a", keys[0])], "cbc"),
             ([("d", keys[3]), ("d", keys[4])], "cbc"),
             ([("a", keys[0]), ("b", keys[1])], "cbc"),
             ([("d", keys[3])], "ctr")]
    for slots, mode in calls:
        g, w = mine.stacked(slots, 4, mode=mode), ref.stacked(slots, 4, mode=mode)
        assert g.nr == w.nr and g.digests == w.digests
        np.testing.assert_array_equal(g.rks, w.rks)
        if w.rks_dec is None:
            assert g.rks_dec is None
        else:
            np.testing.assert_array_equal(g.rks_dec, w.rks_dec)
        assert list(mine._dec) == list(ref._dec)
        for d in ref._dec:
            np.testing.assert_array_equal(mine._dec[d], ref._dec[d])
    ref_stats = ref.stats()
    assert mine.stats() == {k: ref_stats[k] for k in mine.stats()}
    assert len(mine._dec) == 5 and mine.stats()["stacked_misses"] == 6


@pytest.mark.parametrize("key_slots", [1, 3, 8])
def test_cbc_batch_layout_matches_reference(key_slots):
    """The same ctr and cbc requests through both rung-packers: the same
    batches (never mixing modes), and for each the same words, PREV stream
    (or counters), slot vector and spans."""
    specs = _specs(7, n=60, sizes=(16, 32, 256, 512, 1024, 4096), key_bytes=(16, 16, 32))
    mine = [otq.Request(id=i, tenant=t, key=k, nonce=n, payload=p, future=None, mode=m, iv=iv)
            for i, (t, k, m, n, iv, p) in enumerate(specs)]
    ref = [jqueue.Request(id=i, tenant=t, key=k, nonce=n, payload=p, future=None, mode=m,
                          iv=iv) for i, (t, k, m, n, iv, p) in enumerate(specs)]
    rungs = batcher.bucket_ladder(32, 256)
    got = batcher.form_batches(mine, rungs, keycache.key_digest, key_slots)
    want = jbatcher.form_batches(ref, rungs, jkeycache.key_digest, key_slots)
    assert len(got) == len(want) > 3
    assert {b.mode for b in got} == set(MODES)
    for g, w in zip(got, want):
        assert (g.mode, g.bucket, g.blocks, g.nr, g.key_slots, g.label) == (
            w.mode, w.bucket, w.blocks, w.nr, w.key_slots, w.label)
        assert {r.mode for r in g.requests} == {g.mode}
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


def test_admission_refusals_match_reference():
    """Unknown mode, a mode not enabled, a cbc IV of the wrong length, a ctr
    nonce of the wrong length, good requests of both modes, and rc4 session
    chunks (a good one with no AES key, one without a session id, a negative
    one, a missing and a short keystream slice): the same codes and counts
    from both queues, with ctr,cbc enabled, with ctr alone and with
    ctr,cbc,rc4."""
    async def drive(mod, modes):
        q = mod.RequestQueue(max_depth=64, max_request_blocks=8, modes=modes)
        z = np.zeros(32, np.uint8)
        k, n, iv = b"k" * 16, b"n" * 16, b"i" * 16
        futs = [
            q.submit("t", k, n, z, mode="bogus"),
            q.submit("t", k, n, z, mode="gcm"),
            q.submit("t", k, n, z, mode="gcm-open"),
            q.submit("t", k, n, z, mode="rc4"),
            q.submit("t", k, b"", z, mode="cbc", iv=iv),
            q.submit("t", k, b"", z, mode="cbc", iv=iv[:12]),
            q.submit("t", k, b"", z, mode="cbc"),
            q.submit("t", k, b"", z, mode="cbc", iv=iv + b"x"),
            q.submit("t", k, n[:8], z),
            q.submit("t", k, n, z),
            q.submit("t", k, b"", np.zeros(15, np.uint8), mode="cbc", iv=iv),
            q.submit("t", k[:15], b"", z, mode="cbc", iv=iv),
            q.submit("t", k, b"", np.zeros(16 * 9, np.uint8), mode="cbc", iv=iv),
            q.submit("t", b"", b"", z, mode="rc4", sid=3, ks=z, ks_offset=0),
            q.submit("t", b"", b"", z, mode="rc4", ks=z),
            q.submit("t", b"", b"", z, mode="rc4", sid=-2, ks=z),
            q.submit("t", b"", b"", z, mode="rc4", sid=3),
            q.submit("t", b"", b"", z, mode="rc4", sid=3, ks=z[:16]),
        ]
        live = q.drain()
        for r in live:
            r.fail(mod.ERR_SHUTDOWN)
        return ([(await f).error for f in futs],
                [(r.id, r.mode, r.iv, r.sid, r.ks_offset) for r in live], q.stats())

    for modes in (MODES, ("ctr",), MODES + ("rc4",)):
        got = asyncio.run(drive(otq, modes))
        want = asyncio.run(drive(jqueue, modes))
        assert got == want, modes
    codes = asyncio.run(drive(otq, MODES))[0]
    bad = otq.ERR_BAD_REQUEST
    assert codes == [bad, bad, bad, bad, otq.ERR_SHUTDOWN, bad, bad, bad, bad, otq.ERR_SHUTDOWN,
                     bad, bad, otq.ERR_TOO_LARGE] + [bad] * 5  # rc4 not enabled
    assert asyncio.run(drive(otq, ("ctr",)))[0][4] == bad  # cbc not enabled
    codes, live, _ = asyncio.run(drive(otq, MODES + ("rc4",)))
    assert codes[13:] == [otq.ERR_SHUTDOWN, bad, bad, bad, bad]
    assert live[-1][1:] == ("rc4", b"", 3, 0)


def test_mixed_server_answers_match_reference_server():
    """Seeded ctr and cbc requests up to the 256-block rung, 6 keys over 3
    tenants, through the JAX server (jnp engine, modes ctr,cbc) and the
    port's on the CPU: every response's bytes and code are equal, and the
    cbc ones are the host T-table's CBC decrypt."""
    specs = _specs(11, n=36, sizes=(16, 48, 256, 1024, 4096))

    async def drive(server):
        return await asyncio.gather(*(server.submit(t, k, n, p, mode=m, iv=iv)
                                      for t, k, m, n, iv, p in specs))

    want = _run(JServer(JServerConfig(engine="jnp", lanes=1, transfer_chunk_blocks=0,
                                      modes=MODES, **LADDER)), drive)
    server = Server(ServerConfig(device="cpu", lanes=1, modes=MODES, **LADDER))
    got = _run(server, drive)
    assert all(r.ok for r in got) and len(got) == len(want) == len(specs)
    for g, w in zip(got, want):
        assert (g.ok, g.error) == (w.ok, w.error)
        np.testing.assert_array_equal(np.asarray(g.payload), np.asarray(w.payload))
    cbc = [(k, iv, p, g) for (_t, k, m, _n, iv, p), g in zip(specs, got) if m == "cbc"]
    assert len(cbc) >= 10
    for k, iv, p, g in cbc[:6]:
        np.testing.assert_array_equal(np.asarray(g.payload), _ref_cbc_decrypt(k, iv, p))
    stats = server.stats()
    lane = stats["lanes"]["per_lane"][0]
    warm = len(server.rungs)
    assert lane["engine_calls_by_mode"]["cbc"] > warm and lane["engine_calls_by_mode"]["ctr"] > warm
    assert sum(lane["engine_calls_by_mode"].values()) == lane["engine_calls"]
    assert stats["queue"]["lost"] == 0 and stats["compiles"]["steady"] == 0
    assert stats["modes"] == list(MODES)


def test_two_lane_failover_replays_a_cbc_batch_bit_exactly(monkeypatch):
    """Lane 0's engine call raises on traffic: each cbc batch (the SP800-38A
    F.2.2 vector among its riders) is replayed on lane 1 with the same
    bytes, nothing is lost, and lane 0 is quarantined."""
    real = lanes.Lane.engine_call
    seen = []

    def flaky(self, *a, warmup=False, mode="ctr", **kw):
        if self.idx == 0 and not warmup:
            seen.append(mode)
            raise RuntimeError("lane 0 is sick")
        return real(self, *a, warmup=warmup, mode=mode, **kw)

    monkeypatch.setattr(lanes.Lane, "engine_call", flaky)
    rng = np.random.default_rng(5)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()

    async def drive(server):
        out = []
        for _ in range(3):
            reqs = [(rng.integers(0, 256, 16, dtype=np.uint8).tobytes(),
                     rng.integers(0, 256, 256, dtype=np.uint8)) for _ in range(3)]
            kat = server.submit("kat", SP800_KEY, b"", np.frombuffer(SP800_CBC_CT, np.uint8),
                                mode="cbc", iv=SP800_IV)
            futs = [server.submit("t0", key, b"", p, mode="cbc", iv=iv) for iv, p in reqs]
            out.append((reqs, await asyncio.gather(kat, *futs)))
        return out

    server = Server(ServerConfig(device="cpu", lanes=2, retries=1, probe_every=1000,
                                 modes=MODES, **LADDER))
    rounds = _run(server, drive)
    for reqs, resps in rounds:
        assert all(r.ok for r in resps)
        assert bytes(np.asarray(resps[0].payload)) == SP800_PT
        for (iv, p), r in zip(reqs, resps[1:]):
            np.testing.assert_array_equal(np.asarray(r.payload), _ref_cbc_decrypt(key, iv, p))
    assert seen and set(seen) == {"cbc"}
    lane0 = server.pool.lanes[0]
    assert [t["to"] for t in lane0.transitions] == [lanes.SUSPECT, lanes.QUARANTINED]
    assert server.pool.redispatches >= 2 and server.queue.stats()["lost"] == 0
    assert server.batches_failed == 0


@pytest.mark.parametrize("nr", [10, 12, 14])
@pytest.mark.parametrize("key_slots", [1, 8])
def test_cbc_cost_row_matches_reference(nr, key_slots):
    """The analytic ``cbc`` record (payload + PREV + decrypt schedules +
    slots in, payload out) equals the reference's at every rung."""
    fields = ("mode", "rung", "nr", "key_slots", "bytes_in", "bytes_out", "hbm_bytes", "ops")
    costmodel.reset_for_tests()
    for rung in batcher.bucket_ladder(batcher.DEFAULT_MIN_BLOCKS, batcher.DEFAULT_MAX_BLOCKS):
        got = costmodel.analytic_cost(aes.CUDA_ENGINE, "cbc", rung, nr, key_slots)
        want = jcost.analytic_cost("pallas-dense-bp", "cbc", rung, nr, key_slots)
        assert {f: got[f] for f in fields} == {f: want[f] for f in fields}
    recs = costmodel.ladder_costs(aes.CUDA_ENGINE, MODES, (32, 64), key_slots=key_slots)
    assert [(r["mode"], r["rung"]) for r in recs] == [
        ("ctr", 32), ("ctr", 64), ("cbc", 32), ("cbc", 64)]


def test_bench_cli_with_ctr_and_cbc(capsys):
    rc = serve_bench.main(["--device", "cpu", "--modes", "ctr,cbc", "--requests", "40",
                           "--concurrency", "8", "--sizes", "16,256,4096", "--verify-every",
                           "2"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert rc == 0
    assert line["lost"] == 0 and line["errors"] == {} and line["ok"] == line["requests"] == 40
    assert line["mismatches"] == 0 and line["recompiles"] == 0
    assert set(line["modes"]) == set(MODES) and sum(line["modes"].values()) == 40
    per = line["per_mode"]
    assert set(per["latency"]) == set(MODES)
    assert all(per["latency"][m]["verified"] > 0 for m in MODES)
    assert sum(per["latency"][m]["requests"] for m in MODES) == 40
    warm = len(line["config"]["rungs"])
    for m in MODES:
        assert per["engine_calls"][m] == warm + per["dispatches"][m]
    assert line["launches"] == {"ctr_mk": 0, "cbc_mk": 0}
    assert {r["mode"] for r in line["cost"]["rows"]} == set(MODES)
    assert any(o.startswith("#   mode cbc:") for o in out)


def test_loadgen_draws_follow_the_reference():
    """The same seed draws the same probes (mode, key, IV, payload and
    expected output) as the JAX loadgen."""
    from our_tree_tpu.serve import loadgen as jloadgen

    got = loadgen.make_probes((16, 48, 256), seed=4, modes=MODES)
    want = jloadgen.make_probes((16, 48, 256), seed=4, modes=MODES)
    assert [(p.mode, p.key, p.nonce, p.iv) for p in got] == \
        [(p.mode, p.key, p.nonce, p.iv) for p in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.payload, w.payload)
        np.testing.assert_array_equal(g.expected, w.expected)


@pytest.mark.parametrize("mode", ["gcm", "gcm-open", "rc4", "bogus"])
def test_modes_not_ported_are_refused_at_configuration(mode, capsys):
    """``bogus`` (not a mode) is refused when a server or a bench run is
    configured; ``gcm``, ``gcm-open`` and ``rc4`` (served since their
    slices) start both, ``rc4`` with its session store and two verified
    sessions at small session shapes."""
    if mode != "bogus":
        assert otq.unknown_modes(("ctr", mode)) is None
        server = Server(ServerConfig(device="cpu", modes=("ctr", mode)))
        assert (server.sessions is not None) == (mode == "rc4")
        extra = (["--sessions", "2", "--session-chunks", "2", "--session-chunk-bytes", "256",
                  "--session-quantum-bytes", "1024", "--session-prefetch-slots", "2",
                  "--session-window-bytes", "2048"] if mode == "rc4" else [])
        assert serve_bench.main(["--device", "cpu", "--modes", f"ctr,{mode}", "--requests", "4",
                                 "--sizes", "16", "--bucket-max", "32", "--verify-every",
                                 "2", *extra]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        want_ok = 4 + (4 if mode == "rc4" else 0)
        assert line["lost"] == 0 and line["ok"] == want_ok and set(line["modes"]) <= {"ctr", mode}
        if mode == "rc4":
            assert line["sessions"]["chunks"] == 4 and line["mismatches"] == 0
    else:
        with pytest.raises(ValueError, match="unknown serve mode"):
            Server(ServerConfig(device="cpu", modes=("ctr", mode)))
        with pytest.raises(SystemExit):
            serve_bench.main(["--device", "cpu", "--modes", f"ctr,{mode}", "--requests", "1"])
    assert otq.unknown_modes(otq.MODES) is None
    assert "unknown serve mode" in otq.unknown_modes(("ctr", "bogus"))
    assert "unknown serve mode" in otq.unknown_modes(())
