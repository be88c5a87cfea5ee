"""The ``gcm`` (AES-GCM seal) and ``gcm-open`` serve modes of the port's
serve stack against the JAX package's on the same seeded requests: the
admission codes and counts, ``span_blocks``, the GCM batch layout (words,
counters, slots, inject, keep, spans) for K 1/3/8, with and without AAD,
96-bit and 7-byte IVs, the keycache's GHASH subkeys, a mixed
``ctr,gcm,gcm-open,cbc`` server's answers (payload, tag, error code), the
cost rows and the loadgen's draws. Then the port's own contracts on the
CPU: the SP 800-38D KATs through a live server, one tampered byte giving
exactly one ``auth-failed``, the ``tag_mismatch`` fault point, a two-lane
failover replaying GCM batches bit-exactly and a canary releasing the sick
lane, and the bench CLI with the GCM modes and the auth-failure rehearsal.
Small ladder (32-256 blocks), 128-bit warmup. Integer cryptography: the
tolerance is zero."""

import asyncio
import json
import pathlib

import numpy as np
import pytest

from our_tree_tpu.obs import costmodel as jcost
from our_tree_tpu.resilience import degrade as jdegrade
from our_tree_tpu.resilience import faults as jfaults
from our_tree_tpu.serve import batcher as jbatcher
from our_tree_tpu.serve import keycache as jkeycache
from our_tree_tpu.serve import loadgen as jloadgen
from our_tree_tpu.serve import queue as jqueue
from our_tree_tpu.serve.server import Server as JServer
from our_tree_tpu.serve.server import ServerConfig as JServerConfig
from our_tree_tpu_torch.aead import ghash
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.obs import costmodel, metrics
from our_tree_tpu_torch.resilience import degrade, faults
from our_tree_tpu_torch.serve import batcher, keycache, lanes, loadgen
from our_tree_tpu_torch.serve import bench as serve_bench
from our_tree_tpu_torch.serve import queue as otq
from our_tree_tpu_torch.serve.server import Server, ServerConfig

LADDER = dict(min_bucket_blocks=32, max_bucket_blocks=256)
MODES = ("ctr", "gcm", "gcm-open", "cbc")
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "gcm_kats.json"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("OT_DISPATCH_DEADLINE", raising=False)
    monkeypatch.delenv("OT_TRACE_DIR", raising=False)
    monkeypatch.delenv("OT_FAULTS", raising=False)
    monkeypatch.setenv("OT_COST_XLA", "0")
    faults.reset()
    jfaults.reset()
    degrade.clear()
    jdegrade.clear()
    yield
    monkeypatch.delenv("OT_FAULTS", raising=False)
    faults.reset()
    jfaults.reset()
    degrade.clear()
    jdegrade.clear()


def _run(server, fn):
    async def main():
        await server.start()
        try:
            return await fn(server)
        finally:
            await server.stop()

    return asyncio.run(main())


def _server(**kw):
    return Server(ServerConfig(device="cpu", lanes=1, modes=MODES, **{**LADDER, **kw}))


def _sealed(key, iv, aad, pt):
    ct, tag = ghash.np_gcm_seal(key, iv, aad, bytes(pt))
    return np.frombuffer(ct, np.uint8), tag


def _specs(seed, n=40, sizes=(16, 48, 256, 1024, 4000), iv_lens=(12,)):
    """Seeded (tenant, key, mode, nonce, iv, aad, tag, payload) over the four
    modes: 3 tenants x 2 keys; a gcm-open request carries a host-sealed
    ciphertext and its valid tag."""
    rng = np.random.default_rng(seed)
    keys = {(t, k): rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for t in range(3) for k in range(2)}
    out = []
    for _ in range(n):
        t, k = int(rng.integers(3)), int(rng.integers(2))
        key = keys[(t, k)]
        mode = MODES[int(rng.integers(len(MODES)))]
        payload = rng.integers(0, 256, int(rng.choice(sizes)), dtype=np.uint8)
        nonce = iv = aad = tag = b""
        if mode == "ctr":
            nonce = rng.bytes(16)
        elif mode == "cbc":
            iv = rng.bytes(16)
        else:
            iv = rng.bytes(int(rng.choice(iv_lens)))
            aad = rng.bytes(int(rng.integers(0, 40)))
            if mode == "gcm-open":
                payload, tag = _sealed(key, iv, aad, payload)
        out.append((f"t{t}", key, mode, nonce, iv, aad, tag, payload))
    return out


# ---------------------------------------------------------------------------
# Admission, span_blocks, the batch layout and the keycache, held against the
# JAX package's.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("modes", [MODES, ("ctr", "cbc"), ("gcm-open",)])
def test_admission_codes_match_reference(modes):
    """Empty IV, short and long open tags, a 4,096-block GCM request
    (too-large with its J0 row), 96-bit, 7-, 8- and 16-byte IVs, a bad key,
    unknown and not-enabled modes: the same codes, counts and admitted
    requests (J0 included) from both queues."""
    async def drive(mod):
        q = mod.RequestQueue(max_depth=64, max_request_blocks=4096, modes=modes)
        k, z = b"k" * 16, np.zeros(32, np.uint8)
        iv12, t16 = bytes(range(12)), bytes(range(16))
        futs = [
            q.submit("t", k, b"", z, mode="gcm", iv=b""),
            q.submit("t", k, b"", z, mode="gcm-open", iv=iv12, tag=t16[:8]),
            q.submit("t", k, b"", z, mode="gcm-open", iv=iv12, tag=t16 + b"x"),
            q.submit("t", k, b"", z, mode="gcm-open", iv=iv12),
            q.submit("t", k, b"", np.zeros(16 * 4096, np.uint8), mode="gcm", iv=iv12),
            q.submit("t", k, b"", np.zeros(16 * 4095, np.uint8), mode="gcm", iv=iv12),
            q.submit("t", k, t16, np.zeros(16 * 4096, np.uint8), mode="ctr"),
            q.submit("t", k, b"", z, mode="gcm", iv=iv12, aad=b"hdr"),
            q.submit("t", k, b"", z, mode="gcm", iv=iv12[:7]),
            q.submit("t", k, b"", z, mode="gcm-open", iv=iv12[:8], tag=t16, aad=b"a" * 33),
            q.submit("t", k, b"", z, mode="gcm", iv=t16),
            q.submit("t", k[:15], b"", z, mode="gcm", iv=iv12),
            q.submit("t", k, b"", np.zeros(15, np.uint8), mode="gcm", iv=iv12),
            q.submit("t", k, b"", z, mode="cbc", iv=iv12),
            q.submit("t", k, b"", z, mode="xts", iv=iv12),
        ]
        live = q.drain()
        for r in live:
            r.fail(mod.ERR_SHUTDOWN)
        return ([(await f).error for f in futs],
                [(r.id, r.mode, r.iv, r.aad, r.tag, r.j0, r.span_blocks) for r in live],
                q.stats())

    got = asyncio.run(drive(otq))
    assert got == asyncio.run(drive(jqueue))
    if modes == MODES:
        bad, ok = otq.ERR_BAD_REQUEST, otq.ERR_SHUTDOWN
        assert got[0] == [bad, bad, bad, bad, otq.ERR_TOO_LARGE, ok, ok, ok, ok, ok, ok, bad, bad,
                          bad, bad]
        j0s = {len(iv): j0 for (_i, _m, iv, _a, _t, j0, _s) in got[1]}
        assert j0s[12] == bytes(range(12)) + b"\x00\x00\x00\x01"
        assert len(j0s[7]) == len(j0s[16]) == 16 and j0s[16] != bytes(range(16))
        assert [s for (*_, s) in got[1]] == [4096, 4096, 3, 3, 3, 3]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nblocks", [1, 15, 255])
def test_span_blocks_match_reference(mode, nblocks):
    """A GCM request spans its blocks and its J0 row, and the rung-packer
    packs by span: 8 requests of 16 blocks fill the 128 rung exactly, but
    with their J0 rows 8 GCM ones take 136 rows, a 128 rung and a 32."""
    kw = dict(id=0, tenant="t", key=b"k" * 16, nonce=b"n" * 16,
              payload=np.zeros(16 * nblocks, np.uint8), future=None, mode=mode, iv=b"i" * 12)
    assert otq.Request(**kw).span_blocks == jqueue.Request(**kw).span_blocks == (
        nblocks + (mode in otq.GCM_MODES))
    reqs = [otq.Request(**{**kw, "id": i, "payload": np.zeros(16 * 16, np.uint8)})
            for i in range(8)]
    jreqs = [jqueue.Request(**{**kw, "id": i, "payload": np.zeros(16 * 16, np.uint8)})
             for i in range(8)]
    got = batcher.form_batches(reqs, batcher.bucket_ladder(32, 128), keycache.key_digest)
    want = jbatcher.form_batches(jreqs, batcher.bucket_ladder(32, 128), jkeycache.key_digest)
    assert [(b.bucket, b.blocks) for b in got] == [(b.bucket, b.blocks) for b in want] == (
        [(128, 112), (32, 16)] if mode in otq.GCM_MODES else [(128, 128)])


@pytest.mark.parametrize("key_slots", [1, 3, 8])
@pytest.mark.parametrize("with_aad", [False, True])
@pytest.mark.parametrize("iv_len", [12, 7])
def test_gcm_batch_layout_matches_reference(key_slots, with_aad, iv_len):
    """The same admitted requests through both rung-packers and both
    keycaches: the same batches, and for each the same words, counters,
    slot vector, inject words, keep vector and spans; ``rows`` is each
    request's last data row, sorted."""
    rng = np.random.default_rng(key_slots * 10 + iv_len + with_aad)
    keys = [rng.bytes(16) for _ in range(5)] + [rng.bytes(32)]
    specs = []
    for i in range(40):
        mode = ("gcm", "gcm-open")[i % 2]
        specs.append((f"t{i % 4}", keys[int(rng.integers(len(keys)))], mode,
                      rng.integers(0, 256, 16 * int(rng.choice([1, 2, 7, 31, 64, 200])),
                                   dtype=np.uint8),
                      rng.bytes(iv_len), rng.bytes(int(rng.integers(1, 50))) if with_aad else b"",
                      rng.bytes(16)))

    async def admit(mod):
        q = mod.RequestQueue(max_depth=64, max_request_blocks=256, modes=MODES)
        for t, k, m, p, iv, aad, tag in specs:
            q.submit(t, k, b"", p, mode=m, iv=iv, aad=aad, tag=tag)
        return q.drain()

    mine, ref = asyncio.run(admit(otq)), asyncio.run(admit(jqueue))
    rungs = batcher.bucket_ladder(32, 256)
    got = batcher.form_batches(mine, rungs, keycache.key_digest, key_slots)
    want = jbatcher.form_batches(ref, rungs, jkeycache.key_digest, key_slots)
    assert len(got) == len(want) > 4
    kc, jkc = keycache.KeyCache(), jkeycache.KeyCache()
    for g, w in zip(got, want):
        assert (g.mode, g.bucket, g.blocks, g.nr, g.key_slots, g.label) == (
            w.mode, w.bucket, w.blocks, w.nr, w.key_slots, w.label)
        assert [[r.id for r in s.requests] for s in g.slots] == \
            [[r.id for r in s.requests] for s in w.slots]
        g.materialise(sched=kc.stacked(g.keys, g.key_slots, mode=g.mode))
        w.materialise(sched=jkc.stacked(w.keys, w.key_slots, mode=w.mode))
        assert g.req_spans == w.req_spans
        for name in ("words", "ctr_words", "slot_index", "inject_words", "seg_keep"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        assert g.rows.dtype == np.int64
        assert g.rows.tolist() == [off + n - 1 for off, n in g.req_spans]
        assert g.rows.tolist() == sorted(g.rows.tolist()) and g.rows[-1] < g.bucket
    with pytest.raises(ValueError, match="needs the stack's H"):
        batcher.form_batches(mine[:1], rungs, keycache.key_digest)[0].materialise()


def test_keycache_aead_memo_matches_reference():
    """``stacked(..., mode="gcm"|"gcm-open")`` attaches the same ``hmats`` and
    ``h_ints``, derives once a digest (``aead_derives``, the
    ``keycache{outcome="aead-derive"}`` counter), and its memo holds and
    evicts as the reference's, over gcm, gcm-open, cbc and ctr stacks."""
    metrics.reset()
    mine = keycache.KeyCache(per_tenant=2, stacked_capacity=1)
    ref = jkeycache.KeyCache(per_tenant=2, stacked_capacity=1)
    rng = np.random.default_rng(9)
    keys = [rng.bytes(n) for n in (16, 16, 16, 24, 32, 16, 16)]
    calls = [([("a", keys[0]), ("b", keys[1])], "gcm"),
             ([("a", keys[0]), ("b", keys[1])], "gcm-open"),
             ([("a", keys[0]), ("b", keys[1])], "ctr"),
             ([("a", keys[0])], "cbc"),
             ([("c", keys[2]), ("a", keys[0])], "gcm-open"),
             ([("d", keys[3])], "gcm"),
             ([("e", keys[4])], "gcm"),
             ([("f", keys[5]), ("g", keys[6])], "gcm"),
             ([("a", keys[0]), ("b", keys[1])], "gcm")]
    for slots, mode in calls:
        g, w = mine.stacked(slots, 4, mode=mode), ref.stacked(slots, 4, mode=mode)
        assert g.digests == w.digests and g.nr == w.nr
        np.testing.assert_array_equal(g.rks, w.rks)
        if w.hmats is None:
            assert g.hmats is None and g.h_ints is None
        else:
            np.testing.assert_array_equal(g.hmats, w.hmats)
            assert g.h_ints == w.h_ints and g.hmats.dtype == np.uint32
        assert list(mine._aead) == list(ref._aead)
    ref_stats = ref.stats()
    assert mine.stats() == {k: ref_stats[k] for k in mine.stats()}
    # Bounded at 4 x capacity: the last stack derives its two keys again.
    assert mine.aead_derives == 9 and len(mine._aead) == 4
    assert metrics.counter_by_label("keycache", "outcome")["aead-derive"] == 9


# ---------------------------------------------------------------------------
# Whole servers.
# ---------------------------------------------------------------------------


def test_mixed_server_answers_match_reference_server():
    """Seeded ctr, gcm, gcm-open and cbc requests (96-bit and 7-byte IVs,
    AAD 0-39 bytes, 6 keys over 3 tenants, one gcm-open tampered) through
    the JAX server (jnp engine) and the port's on the CPU: every response's
    payload, tag and code are equal; the seals equal the host GCM's."""
    specs = _specs(13, n=48, iv_lens=(12, 7))
    opens = [i for i, s in enumerate(specs) if s[2] == "gcm-open"]
    t, k, m, n, iv, aad, tag, p = specs[opens[1]]
    bad = p.copy()
    bad[5] ^= 0x40
    specs[opens[1]] = (t, k, m, n, iv, aad, tag, bad)

    async def drive(server):
        return await asyncio.gather(*(server.submit(t, k, n, p, mode=m, iv=iv, aad=aad, tag=tag)
                                      for t, k, m, n, iv, aad, tag, p in specs))

    want = _run(JServer(JServerConfig(engine="jnp", lanes=1, transfer_chunk_blocks=0,
                                      modes=MODES, **LADDER)), drive)
    server = _server()
    got = _run(server, drive)
    assert len(got) == len(want) == len(specs)
    for g, w in zip(got, want):
        assert (g.ok, g.error, g.tag) == (w.ok, w.error, w.tag)
        if w.ok:
            np.testing.assert_array_equal(np.asarray(g.payload), np.asarray(w.payload))
        else:
            assert g.payload is None
    assert [g.error for g in got].count(otq.ERR_AUTH) == 1 and got[opens[1]].error == otq.ERR_AUTH
    seals = [(s, g) for s, g in zip(specs, got) if s[2] == "gcm"]
    assert len(seals) >= 6 and len(opens) >= 6
    for (_t, k, _m, _n, iv, aad, _tag, p), g in seals:
        ct, tag = _sealed(k, iv, aad, p)
        assert bytes(g.payload) == bytes(ct) and g.tag == tag
    stats = server.stats()
    calls = stats["lanes"]["engine_calls_by_mode"]
    warm = len(server.rungs)
    assert all(calls[m] > warm for m in MODES)
    assert stats["queue"]["lost"] == 0 and stats["compiles"]["steady"] == 0
    assert metrics.counter_by_label("serve_auth_failed", "mode") == {"gcm-open": 1}


def _served_kats():
    return [k for k in json.loads(GOLDEN.read_text())["kats"]
            if k["ct"] and len(k["ct"]) % 32 == 0]


def test_sp800_38d_kats_through_a_live_server():
    """The SP 800-38D vectors the block-granular serve path carries, seal and
    open through a live port server warmed at 128 and 256 bits: the KAT's
    ciphertext and tag, its plaintext back, a tampered tag refused; a 7- and
    an 8-byte IV against the host GCM too. No build after warmup."""
    kats = _served_kats()
    assert len(kats) >= 4 and {len(k["key"]) for k in kats} == {32, 64}
    rng = np.random.default_rng(38)
    extra = []
    for iv_len in (7, 8):
        key, iv, aad, pt = rng.bytes(16), rng.bytes(iv_len), rng.bytes(11), rng.bytes(48)
        ct, tag = ghash.np_gcm_seal(key, iv, aad, pt)
        extra.append({"name": f"iv{iv_len}", "key": key.hex(), "iv": iv.hex(), "aad": aad.hex(),
                      "pt": pt.hex(), "ct": ct.hex(), "tag": tag.hex()})

    async def drive(server):
        outs = []
        for k in kats + extra:
            key, iv, aad = (bytes.fromhex(k[f]) for f in ("key", "iv", "aad"))
            pt, ct = (np.frombuffer(bytes.fromhex(k[f]), np.uint8) for f in ("pt", "ct"))
            tag = bytes.fromhex(k["tag"])
            outs.append((k, await server.submit("t0", key, b"", pt, mode="gcm", iv=iv, aad=aad),
                         await server.submit("t0", key, b"", ct, mode="gcm-open", iv=iv,
                                             aad=aad, tag=tag),
                         await server.submit("t0", key, b"", ct, mode="gcm-open", iv=iv,
                                             aad=aad, tag=tag[:-1] + bytes([tag[-1] ^ 1]))))
        return outs

    server = _server(warmup_key_bits=(128, 256))
    for k, seal, opened, tampered in _run(server, drive):
        assert seal.ok and opened.ok, (k["name"], seal.error, opened.error)
        assert (bytes(seal.payload).hex(), seal.tag.hex()) == (k["ct"], k["tag"]), k["name"]
        assert bytes(opened.payload).hex() == k["pt"] and opened.tag is None, k["name"]
        assert tampered.error == otq.ERR_AUTH and tampered.payload is None, k["name"]
    assert server.steady_compiles() == 0 and server.stats()["queue"]["lost"] == 0


def test_one_tampered_byte_gives_exactly_one_auth_failed():
    """Five valid opens and one with a flipped ciphertext byte, riding one
    batch: exactly one ``auth-failed``, no plaintext for it, the others'
    plaintext; the server serves on afterwards."""
    rng = np.random.default_rng(21)
    key, iv, aad = rng.bytes(16), rng.bytes(12), rng.bytes(12)
    pt = rng.bytes(512)
    ct, tag = ghash.np_gcm_seal(key, iv, aad, pt)
    bad = bytearray(ct)
    bad[17] ^= 0x20

    async def drive(server):
        good = [server.submit("t0", key, b"", np.frombuffer(ct, np.uint8), mode="gcm-open",
                              iv=iv, aad=aad, tag=tag) for _ in range(5)]
        tampered = server.submit("t0", key, b"", np.frombuffer(bytes(bad), np.uint8),
                                 mode="gcm-open", iv=iv, aad=aad, tag=tag)
        resps = await asyncio.gather(*good, tampered)
        after = await server.submit("t0", key, b"", np.frombuffer(ct, np.uint8),
                                    mode="gcm-open", iv=iv, aad=aad, tag=tag)
        return resps, after

    server = _server()
    resps, after = _run(server, drive)
    assert [r.error for r in resps] == [None] * 5 + [otq.ERR_AUTH]
    assert all(bytes(r.payload) == pt for r in resps[:5]) and resps[5].payload is None
    assert len({r.batch for r in resps}) == 1
    assert after.ok and bytes(after.payload) == pt
    assert server.steady_compiles() == 0 and server.stats()["queue"]["lost"] == 0
    assert server.batches_failed == 0


def test_tag_mismatch_fault_point(monkeypatch):
    """``OT_FAULTS=tag_mismatch:1`` fails exactly one valid open, at the
    finisher; seals never consult it."""
    monkeypatch.setenv("OT_FAULTS", "tag_mismatch:1")
    faults.reset()
    rng = np.random.default_rng(22)
    key, iv = rng.bytes(16), rng.bytes(12)
    pt = rng.bytes(256)
    ct, tag = ghash.np_gcm_seal(key, iv, b"", pt)

    async def drive(server):
        seal = await server.submit("t0", key, b"", np.frombuffer(pt, np.uint8), mode="gcm",
                                   iv=iv)
        return seal, [await server.submit("t0", key, b"", np.frombuffer(ct, np.uint8),
                                          mode="gcm-open", iv=iv, tag=tag) for _ in range(3)]

    server = _server()
    seal, opens = _run(server, drive)
    assert seal.ok and seal.tag == tag
    assert [r.error for r in opens] == [otq.ERR_AUTH, None, None]
    assert all(bytes(r.payload) == pt for r in opens[1:])
    assert server.stats()["queue"]["lost"] == 0


def test_two_lane_failover_replays_gcm_batches_and_the_canary_releases_the_lane(monkeypatch):
    """Lane 0 fails its first two GCM engine calls: each batch is replayed
    on lane 1 with the same bytes and tags, and lane 0 goes suspect, then
    quarantined; the canary releases it into probation, and it serves GCM
    batches bit-exactly until it is healthy again."""
    real = lanes.Lane.engine_call
    sick = {"left": 2, "modes": []}

    def flaky(self, *a, warmup=False, mode="ctr", **kw):
        if self.idx == 0 and not warmup and mode in otq.GCM_MODES and sick["left"]:
            sick["left"] -= 1
            sick["modes"].append(mode)
            raise RuntimeError("lane 0 is sick")
        return real(self, *a, warmup=warmup, mode=mode, **kw)

    monkeypatch.setattr(lanes.Lane, "engine_call", flaky)
    rng = np.random.default_rng(5)
    key = rng.bytes(16)

    async def one_round(server, mode):
        reqs = []
        for _ in range(3):
            iv, aad, pt = rng.bytes(12), rng.bytes(7), rng.integers(0, 256, 256, dtype=np.uint8)
            ct, tag = _sealed(key, iv, aad, pt)
            reqs.append((iv, aad, pt, ct, tag))
        resps = await asyncio.gather(*(
            server.submit("t0", key, b"", pt if mode == "gcm" else ct, mode=mode, iv=iv, aad=aad,
                          tag=b"" if mode == "gcm" else tag) for iv, aad, pt, ct, tag in reqs))
        return reqs, resps

    async def drive(server):
        out = [await one_round(server, "gcm"), await one_round(server, "gcm-open")]
        await server.pool.probe_pass()
        out += [await one_round(server, m) for m in ("gcm", "gcm-open", "gcm")]
        return out

    server = Server(ServerConfig(device="cpu", lanes=2, retries=1, probe_every=1000,
                                 probation_batches=2, modes=("gcm", "gcm-open"), **LADDER))
    rounds = _run(server, drive)
    for reqs, resps in rounds:
        for (iv, aad, pt, ct, tag), r in zip(reqs, resps):
            assert r.ok
            if r.tag is None:
                assert bytes(r.payload) == bytes(pt)
            else:
                assert bytes(r.payload) == bytes(ct) and r.tag == tag
    assert sick["modes"] == ["gcm", "gcm-open"]
    lane0 = server.pool.lanes[0]
    assert [t["to"] for t in lane0.transitions] == [
        lanes.SUSPECT, lanes.QUARANTINED, lanes.PROBATION, lanes.RELEASED, lanes.HEALTHY]
    assert lane0.canaries == 1 and lane0.dispatches >= 2
    assert server.pool.redispatches == 2 and server.queue.stats()["lost"] == 0
    assert server.batches_failed == 0


# ---------------------------------------------------------------------------
# The cost rows, the loadgen and the bench CLI.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nr", [10, 12, 14])
@pytest.mark.parametrize("key_slots", [1, 8])
@pytest.mark.parametrize("mode", ["gcm", "gcm-open"])
def test_gcm_cost_rows(mode, nr, key_slots):
    """The port's GCM record: the reference's ops (``OPS_PER_GHASH_BLOCK``
    a block on top of the AES budget) and the port's own bytes, the
    reference's ``ctr`` traffic plus H words, inject words, the keep vector
    and E = K named rows in, and the named rows' states out."""
    costmodel.reset_for_tests()
    assert costmodel.OPS_PER_GHASH_BLOCK == jcost.OPS_PER_GHASH_BLOCK
    for rung in batcher.bucket_ladder(batcher.DEFAULT_MIN_BLOCKS, batcher.DEFAULT_MAX_BLOCKS):
        got = costmodel.analytic_cost(aes.CUDA_ENGINE, mode, rung, nr, key_slots)
        want = jcost.analytic_cost("pallas-dense-bp", mode, rung, nr, key_slots)
        ctr = jcost.analytic_cost("pallas-dense-bp", "ctr", rung, nr, key_slots)
        assert (got["mode"], got["rung"], got["nr"], got["ops"]) == (
            want["mode"], want["rung"], want["nr"], want["ops"])
        assert got["bytes_in"] == ctr["bytes_in"] + 16 * key_slots + 16 * rung + 4 * rung \
            + 8 * key_slots
        assert got["bytes_out"] == ctr["bytes_out"] + 16 * key_slots
        assert got["hbm_bytes"] == got["bytes_in"] + got["bytes_out"] < want["hbm_bytes"]
    recs = costmodel.ladder_costs(aes.CUDA_ENGINE, MODES, (32, 64), key_slots=key_slots)
    assert [(r["mode"], r["rung"]) for r in recs] == [
        (m, r) for m in MODES for r in (32, 64)]


class _Recorder:
    """A stand-in server: records each submit and answers it."""

    def __init__(self, mod):
        self.mod, self.calls = mod, []

    async def submit(self, tenant, key, nonce, payload, deadline_s=None, **kw):
        self.calls.append((tenant, key, nonce, bytes(np.asarray(payload)), kw.get("mode", "ctr"),
                           kw.get("iv", b""), kw.get("aad", b""), kw.get("tag", b"")))
        return self.mod.Response(ok=True, payload=np.zeros(np.asarray(payload).size, np.uint8))


def test_loadgen_draws_follow_the_reference():
    """The same seed draws the same probes (mode, key, IV, AAD, tag,
    payload, expected output and tag) and the same request stream as the
    JAX loadgen, unverified gcm-open requests replaying the sealed pair; a
    mix with gcm-open and no sealed pair for a size is refused by both."""
    sizes = (16, 48, 256)
    got = loadgen.make_probes(sizes, seed=4, modes=MODES)
    want = jloadgen.make_probes(sizes, seed=4, modes=MODES)
    assert [(p.mode, p.key, p.nonce, p.iv, p.aad, p.tag, p.expected_tag) for p in got] == \
        [(p.mode, p.key, p.nonce, p.iv, p.aad, p.tag, p.expected_tag) for p in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.payload, w.payload)
        np.testing.assert_array_equal(g.expected, w.expected)
    assert {p.mode for p in got} == set(MODES)

    async def drive(mod, lg, probes):
        rec = _Recorder(mod)
        await lg.run(rec, 60, concurrency=1, sizes=sizes, seed=4, verify_every=3, probes=probes,
                     modes=MODES)
        return rec.calls

    mine, ref = asyncio.run(drive(otq, loadgen, got)), asyncio.run(drive(jqueue, jloadgen, want))
    assert mine == ref
    assert {c[4] for c in mine} == set(MODES)
    by_mode = {(p.mode, p.payload.size): p for p in got}
    for tenant, key, _n, payload, mode, iv, aad, tag in mine:
        if mode == "gcm-open":
            p = by_mode[(mode, len(payload))]
            assert (key, iv, aad, tag, payload) == (p.key, p.iv, p.aad, p.tag, bytes(p.payload))
    for lg, mod in ((loadgen, otq), (jloadgen, jqueue)):
        with pytest.raises(ValueError, match="sealed probe pair"):
            asyncio.run(lg.run(_Recorder(mod), 4, sizes=sizes, seed=4, probes=[],
                               modes=("gcm-open",)))


def test_bench_cli_with_the_gcm_modes(capsys):
    """``--modes ctr,gcm,gcm-open,cbc``: every mode served and verified, 0
    lost, failed or mismatching, 0 builds after warmup, each mode's engine
    calls its warmed rungs plus its dispatches, ``auth_failed`` empty, the
    GCM cost rows; ``--modes gcm-open`` without verification is refused."""
    rc = serve_bench.main(["--device", "cpu", "--modes", ",".join(MODES), "--requests", "48",
                           "--concurrency", "8", "--sizes", "16,256,1024", "--bucket-max", "256",
                           "--verify-every", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert rc == 0
    assert line["lost"] == 0 and line["errors"] == {} and line["ok"] == line["requests"] == 48
    assert line["mismatches"] == 0 and line["recompiles"] == 0
    per = line["per_mode"]
    assert set(line["modes"]) == set(MODES) and per["auth_failed"] == {}
    assert all(per["latency"][m]["verified"] > 0 for m in MODES)
    warm = len(line["config"]["rungs"])
    for m in MODES:
        assert per["engine_calls"][m] == warm + per["dispatches"][m]
    assert line["launches"] == {"ctr_mk": 0, "cbc_mk": 0, "ghash_at": 0}
    assert {r["mode"] for r in line["cost"]["rows"]} == set(MODES)
    assert line["keycache"]["aead_derives"] > 0
    with pytest.raises(SystemExit):
        serve_bench.main(["--device", "cpu", "--modes", "gcm-open", "--verify-every", "0"])


def test_bench_auth_failure_rehearsal(monkeypatch, capsys):
    """``OT_FAULTS=tag_mismatch:1`` with ``--modes gcm,gcm-open``: exactly one
    request answers ``auth-failed``, counted under ``gcm-open``; rc 0, 0
    lost."""
    monkeypatch.setenv("OT_FAULTS", "tag_mismatch:1")
    faults.reset()
    rc = serve_bench.main(["--device", "cpu", "--modes", "gcm,gcm-open", "--requests", "30",
                           "--sizes", "256,1024", "--bucket-max", "256"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["lost"] == 0
    assert line["errors"] == {otq.ERR_AUTH: 1} and line["ok"] == 29
    assert line["per_mode"]["auth_failed"] == {"gcm-open": 1}
    assert line["launches"] == {"ctr_mk": 0, "ghash_at": 0}
