"""The port's rc4 sessions (``our_tree_tpu_torch.serve.session`` and the
serve stack around it) held against the JAX package's on the CPU:

* the served entries ``models.arc4.prep_batch_words`` (the batched PRGA, one
  ``arc4_prga`` launch on the card, its plain version here) and
  ``xor_words`` against the JAX functions and the host oracle
  ``keystream_np``;
* the session store's arms, each the scenario of ``tests/test_session.py``
  run on both packages' ``SessionManager`` over the same host-oracle
  dispatcher, with equal answers, keystream bytes and ``stats()``: bit-exact
  reserve, tenant isolation, LRU eviction of idle rows and refusal when all
  are busy, the keystream budget shed, an injected ``keystream_miss``
  regenerated bit-exactly, ``session_stall`` as backpressure, a forced
  ``session_evict``, drain with open sessions, open validation;
* a ``ctr,gcm,rc4`` server of each package (the JAX one on its ``jnp``
  engine) answering the same script of opens, interleaved chunks, ``ctr``
  and ``gcm`` requests and bad requests with the same bytes, tags, codes
  and session counters, with no build after warmup;
* ``lane_hang`` in the middle of a refill on two lanes: one quarantine, the
  carry replayed on the other lane, every chunk equal to the host PRGA.

Session shapes as the JAX tests take them (quantum 2,048 or less, 2 slots,
a 4,096-byte window, rungs 32-256 or less). Tolerance: bit-exact."""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from our_tree_tpu.models import arc4 as jarc4
from our_tree_tpu.obs import metrics as jmetrics
from our_tree_tpu.resilience import degrade as jdegrade
from our_tree_tpu.resilience import faults as jfaults
from our_tree_tpu.serve import queue as jqueue
from our_tree_tpu.serve import session as jsession
from our_tree_tpu.serve.server import Server as JServer
from our_tree_tpu.serve.server import ServerConfig as JServerConfig
from our_tree_tpu_torch.models import arc4
from our_tree_tpu_torch.resilience import degrade, faults
from our_tree_tpu_torch.serve import queue as otq
from our_tree_tpu_torch.serve import session
from our_tree_tpu_torch.serve.server import Server, ServerConfig

PORT = SimpleNamespace(session=session, queue=otq, faults=faults)
JAX = SimpleNamespace(session=jsession, queue=jqueue, faults=jfaults)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("OT_FAULTS", "OT_DISPATCH_DEADLINE", "OT_TRACE_DIR", "OT_SLOW_S"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OT_COST_XLA", "0")
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
    # The JAX servers' counters stay with this file: a JAX test later in
    # the same process reads the registry's modes.
    jmetrics.reset_for_tests()


def _oracle_rows(m_words, xy_words, length: int) -> np.ndarray:
    """``prep_batch_words``'s rows from the host PRGA: per slot [x', y',
    m'[256], keystream packed little-endian 4 bytes a word]."""
    s = int(xy_words.shape[0]) // 2
    rows = np.zeros((s, 258 + length // 4), np.uint32)
    for i in range(s):
        state = (int(xy_words[i]), int(xy_words[s + i]),
                 np.asarray(m_words[i * 256:(i + 1) * 256]).astype(np.uint8))
        ks, (x2, y2, m2) = arc4.keystream_np(state, length)
        rows[i, 0], rows[i, 1] = x2, y2
        rows[i, 2:258] = m2
        rows[i, 258:] = np.frombuffer(np.asarray(ks, np.uint8).tobytes(), "<u4")
    return rows


def _port_prep(m_words, xy_words, length):
    """The port's entry on CPU tensors, as uint32 rows."""
    out = arc4.prep_batch_words(torch.from_numpy(np.asarray(m_words, np.uint32).view(np.int32)),
                                torch.from_numpy(np.asarray(xy_words, np.uint32).view(np.int32)),
                                length)
    return out.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# The served entries.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_n,length", [(3, 128), (2, 2048)])
def test_prep_batch_words_matches_reference_and_oracle(s_n, length):
    rng = np.random.default_rng(s_n * length)
    m_words = np.concatenate([arc4.key_schedule(rng.bytes(16)) for _ in range(s_n)]
                             ).astype(np.uint32)
    xy_words = rng.integers(0, 256, 2 * s_n).astype(np.uint32)
    got = _port_prep(m_words, xy_words, length)
    want = np.asarray(jarc4.prep_batch_words(m_words, xy_words, length))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle_rows(m_words, xy_words, length))


def test_prep_batch_words_resumes_from_carry():
    """Two 64-byte quanta from the carry are one 128-byte run."""
    key = bytes(range(16))
    m_words = arc4.key_schedule(key).astype(np.uint32)
    r1 = _port_prep(m_words, np.zeros(2, np.uint32), 64)
    r2 = _port_prep(r1[0, 2:258], r1[0, :2], 64)
    want, _ = jarc4.keystream_np((0, 0, jarc4.key_schedule(key)), 128)
    assert r1[0, 258:].astype("<u4").tobytes() + r2[0, 258:].astype("<u4").tobytes() == \
        np.asarray(want, np.uint8).tobytes()


def test_xor_words_matches_reference():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**32, 64, dtype=np.uint32)
    b = rng.integers(0, 2**32, 64, dtype=np.uint32)
    got = arc4.xor_words(torch.from_numpy(a.view(np.int32)),
                         torch.from_numpy(b.view(np.int32))).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jarc4.xor_words(a, b)))
    np.testing.assert_array_equal(got, a ^ b)


# ---------------------------------------------------------------------------
# The store's arms, on both packages' SessionManager.
# ---------------------------------------------------------------------------


class _Ref:
    """A session's expected keystream, from the host PRGA."""

    def __init__(self, key: bytes):
        self.state = (0, 0, arc4.key_schedule(key))

    def next(self, n: int) -> bytes:
        ks, self.state = arc4.keystream_np(self.state, n)
        return ks.tobytes()


def _host_dispatch(quantum: int):
    async def dispatch(m_words, xy_words, sampled):
        return _oracle_rows(m_words, xy_words, quantum), 0
    return dispatch


def _manager(pkg, quantum=1024, window=2048, slots=4, per_tenant=4, budget=1 << 20):
    return pkg.session.SessionManager(_host_dispatch(quantum), per_tenant=per_tenant,
                                      window_bytes=window, quantum_bytes=quantum,
                                      prefetch_slots=slots, budget_bytes=budget)


def _obs(r):
    """An answer as comparable data: a Response's (ok, error), or a reserved
    slice's bytes and offset."""
    if isinstance(r, tuple):
        ks, off = r
        return ("ks", bytes(ks), off)
    return ("resp", r.ok, r.error)


async def _arm_reserve(pkg, arm_faults, log):
    sm = _manager(pkg, quantum=1024, window=4096)
    key = b"\x01" * 16
    ref = _Ref(key)
    log(await sm.open("t", 0, key))
    for n in (256, 1024, 512):
        r = await sm.reserve("t", 0, n)
        log(r)
        assert bytes(r[0]) == ref.next(n)
        sm.ack("t", 0, r[1], n)
    log(await sm.close("t", 0))
    await sm.drain()
    return sm


async def _arm_tenants(pkg, arm_faults, log):
    sm = _manager(pkg)
    ka, kb = b"\xaa" * 16, b"\xbb" * 16
    ra, rb = _Ref(ka), _Ref(kb)
    log(await sm.open("ta", 7, ka))
    log(await sm.open("tb", 7, kb))
    a, b = await sm.reserve("ta", 7, 256), await sm.reserve("tb", 7, 256)
    assert bytes(a[0]) == ra.next(256) and bytes(b[0]) == rb.next(256)
    log(a), log(b)
    sm.ack("ta", 7, a[1], 256)
    sm.ack("tb", 7, b[1], 256)
    log(await sm.close("ta", 7))
    b2 = await sm.reserve("tb", 7, 256)
    assert bytes(b2[0]) == rb.next(256)
    log(b2)
    await sm.drain()
    return sm


async def _arm_lru(pkg, arm_faults, log):
    sm = _manager(pkg, per_tenant=2)
    for sid in (0, 1):
        log(await sm.open("t", sid, bytes([sid]) * 16))
    r = await sm.reserve("t", 0, 256)
    sm.ack("t", 0, r[1], 256)
    log(await sm.open("t", 2, b"\x02" * 16))  # evicts the idle LRU row, sid 1
    log(await sm.reserve("t", 1, 16))
    for sid in (0, 2):
        log(await sm.reserve("t", sid, 256))  # every row busy
    log(await sm.open("t", 3, b"\x03" * 16))  # sheds: eviction mid-session refused
    await sm.drain()
    return sm


async def _arm_budget(pkg, arm_faults, log):
    sm = _manager(pkg, quantum=1024, window=1024, budget=1024)
    log(await sm.open("t", 0, b"\x0a" * 16))
    log(await sm.open("t", 1, b"\x0b" * 16))  # the prefill would pass the budget
    r = await sm.reserve("t", 0, 1024)
    log(r)
    sm.ack("t", 0, r[1], 1024)
    log(await sm.open("t", 1, b"\x0b" * 16))
    await sm.drain()
    return sm


async def _arm_miss(pkg, arm_faults, log):
    sm = _manager(pkg, quantum=512, window=1024)
    key = b"\x42" * 16
    ref = _Ref(key)
    log(await sm.open("t", 0, key))
    r = await sm.reserve("t", 0, 256)
    assert bytes(r[0]) == ref.next(256)
    sm.ack("t", 0, r[1], 256)
    arm_faults("keystream_miss:1@session=0")
    r = await sm.reserve("t", 0, 512)  # regenerated from the acked carry
    assert bytes(r[0]) == ref.next(512)
    log(r)
    sm.ack("t", 0, r[1], 512)
    await sm.drain()
    return sm


async def _arm_stall(pkg, arm_faults, log):
    arm_faults("session_stall:1@session=0")
    sm = _manager(pkg, quantum=512, window=512)
    key = b"\x05" * 16
    log(await sm.open("t", 0, key))  # the prefill stalls, then serves
    r = await sm.reserve("t", 0, 512)
    assert bytes(r[0]) == _Ref(key).next(512)
    log(r)
    sm.ack("t", 0, r[1], 512)
    await sm.drain()
    return sm


async def _arm_evict(pkg, arm_faults, log):
    arm_faults("session_evict:1@session=1")
    sm = _manager(pkg, per_tenant=8)
    log(await sm.open("t", 0, b"\x00" * 16))
    log(await sm.open("t", 1, b"\x01" * 16))  # evicts sid 0 though far below capacity
    log(await sm.reserve("t", 0, 16))
    await sm.drain()
    return sm


async def _arm_drain(pkg, arm_faults, log):
    sm = _manager(pkg)
    for sid in (0, 1):
        log(await sm.open("t", sid, bytes([sid]) * 16))
    await sm.drain()
    log(await sm.open("t", 9, b"\x09" * 16))
    log(await sm.reserve("t", 0, 16))
    return sm


async def _arm_validation(pkg, arm_faults, log):
    sm = _manager(pkg)
    for sid, key in (("x", b"\x01" * 16), (-1, b"\x01" * 16), (0, b""), (0, b"\x01" * 257),
                     (0, b"\x01" * 16), (0, b"\x01" * 16)):
        log(await sm.open("t", sid, key))
    log(await sm.reserve("t", 0, 0))
    log(await sm.close("t", 5))
    await sm.drain()
    return sm


ARMS = {"reserve_bit_exact": _arm_reserve, "tenant_isolation": _arm_tenants,
        "lru_evicts_idle_refuses_busy": _arm_lru, "budget_sheds": _arm_budget,
        "keystream_miss_regenerates": _arm_miss, "stall_is_backpressure": _arm_stall,
        "forced_evict": _arm_evict, "drain_with_open_sessions": _arm_drain,
        "open_validation": _arm_validation}

#: What each arm must show, beyond agreeing with the reference: the
#: answers' codes (ok/error in order) and stats() entries.
EXPECT = {
    "reserve_bit_exact": ([True] * 5, {"opened": 1, "closed": 1, "chunks": 3,
                                       "prefetch.hits": 3, "prefetch.misses": 0}),
    "tenant_isolation": ([True] * 6, {"opened": 2, "closed": 1}),
    "lru_evicts_idle_refuses_busy": ([True, True, True, "bad-request", True, True, "shed"],
                                     {"evicted": 1, "shed": 1}),
    "budget_sheds": ([True, "shed", True, True], {"shed": 1, "held_bytes": 0}),
    "keystream_miss_regenerates": ([True, True], {"prefetch.injected_misses": 1}),
    "stall_is_backpressure": ([True, True], {"prefetch.stalls": 1}),
    "forced_evict": ([True, True, "bad-request"], {"evicted": 1}),
    "drain_with_open_sessions": ([True, True, "shutdown", "bad-request"],
                                 {"drained_open": 2}),
    "open_validation": (["bad-request"] * 4 + [True, "bad-request", "bad-request",
                                               "bad-request"], {"opened": 1, "refused": 7}),
}


def _run_arm(pkg, name, monkeypatch):
    log = []

    def arm_faults(spec):
        monkeypatch.setenv("OT_FAULTS", spec)
        pkg.faults.reset()

    monkeypatch.setenv("OT_SLOW_S", "0.01")
    monkeypatch.delenv("OT_FAULTS", raising=False)
    pkg.faults.reset()
    sm = asyncio.run(ARMS[name](pkg, arm_faults, lambda r: log.append(_obs(r))))
    monkeypatch.delenv("OT_FAULTS", raising=False)
    pkg.faults.reset()
    return log, sm.stats()


@pytest.mark.parametrize("name", sorted(ARMS))
def test_store_arm_matches_reference(name, monkeypatch):
    got = _run_arm(PORT, name, monkeypatch)
    want = _run_arm(JAX, name, monkeypatch)
    assert got == want
    log, stats = got
    codes, entries = EXPECT[name]
    assert [o[1] if o[0] == "resp" and o[1] else (o[2] if o[0] == "resp" else True)
            for o in log] == codes
    flat = {**stats, **{f"prefetch.{k}": v for k, v in stats["prefetch"].items()}}
    assert {k: flat[k] for k in entries} == entries


# ---------------------------------------------------------------------------
# A ctr,gcm,rc4 server of each package on one script.
# ---------------------------------------------------------------------------

SESSION_SHAPE = dict(session_quantum_bytes=2048, session_prefetch_slots=2,
                     session_window_bytes=4096)
SERVE_CFG = dict(min_bucket_blocks=32, max_bucket_blocks=64, lanes=1, modes=("ctr", "gcm", "rc4"),
                 transfer_chunk_blocks=0, **SESSION_SHAPE)


def _script():
    """Sequential steps: each a list of calls run together (at most one chunk
    of a session at once), (kind, args). Chunk bytes stay inside each
    session's prefilled window, so every reserve is a hit whatever the
    background refill's timing."""
    rng = np.random.default_rng(21)
    keys = {sid: rng.bytes(16) for sid in range(3)}
    steps = [[("open", (f"t{sid % 2}", sid, keys[sid]))] for sid in range(3)]
    steps.append([("open", ("t0", 0, keys[0])),            # already open
                  ("open", ("t1", 7, b"")),                 # no key
                  ("close", ("t1", 42))])                   # never opened
    for rnd in range(3):
        step = [("rc4", (f"t{sid % 2}", sid, rng.integers(0, 256, 16 * int(rng.integers(1, 40)),
                                                          dtype=np.uint8)))
                for sid in range(3)]
        step.append(("ctr", ("tc", rng.bytes(16), rng.bytes(16),
                             rng.integers(0, 256, 16 * int(rng.integers(1, 30)), dtype=np.uint8))))
        step.append(("gcm", ("tg", rng.bytes(16), rng.bytes(12),
                             rng.integers(0, 256, 16 * int(rng.integers(1, 30)), dtype=np.uint8))))
        steps.append(step)
    steps.append([("rc4", ("t0", 99, np.zeros(32, np.uint8))),   # unknown session
                  ("rc4", ("t0", -1, np.zeros(32, np.uint8))),   # no session id
                  ("rc4", ("t1", 1, np.zeros(15, np.uint8))),    # not a block multiple
                  ("rc4", ("t0", 2, np.zeros(64 * 16 + 16, np.uint8)))])  # above the top rung
    steps.append([("rc4", ("t1", 1, rng.integers(0, 256, 48, dtype=np.uint8)))])
    steps.append([("close", (f"t{sid % 2}", sid)) for sid in range(3)])
    steps.append([("rc4", ("t0", 0, np.zeros(16, np.uint8)))])  # closed
    return keys, steps


async def _drive(server, steps):
    async def call(kind, args):
        if kind == "open":
            return await server.open_session(*args)
        if kind == "close":
            return await server.close_session(*args)
        if kind == "rc4":
            tenant, sid, data = args
            return await server.submit(tenant, b"", b"", data, mode="rc4", sid=sid)
        if kind == "ctr":
            tenant, key, nonce, data = args
            return await server.submit(tenant, key, nonce, data)
        tenant, key, iv, data = args
        return await server.submit(tenant, key, b"", data, mode="gcm", iv=iv)

    await server.start()
    base = server.steady_compiles()
    try:
        out = []
        for step in steps:
            out += await asyncio.gather(*(call(kind, args) for kind, args in step))
        return out, server.stats()["sessions"], server.steady_compiles() - base
    finally:
        await server.stop()


def _answer(r):
    return (r.ok, r.error, None if r.payload is None else np.asarray(r.payload).tobytes(), r.tag)


def test_server_script_matches_reference_server():
    keys, steps = _script()
    got, got_st, steady = asyncio.run(_drive(Server(ServerConfig(device="cpu", **SERVE_CFG)),
                                             steps))
    want, want_st, _ = asyncio.run(_drive(JServer(JServerConfig(engine="jnp", **SERVE_CFG)),
                                          steps))
    assert [_answer(r) for r in got] == [_answer(r) for r in want]
    counters = ("opened", "closed", "evicted", "refused", "shed", "chunks", "drained_open")
    assert {k: got_st[k] for k in counters} == {k: want_st[k] for k in counters}
    assert (got_st["prefetch"]["hits"], got_st["prefetch"]["misses"]) == \
        (want_st["prefetch"]["hits"], want_st["prefetch"]["misses"])
    assert steady == 0
    # Every served chunk against the host PRGA, in each session's order (a
    # refused chunk consumed its reserved bytes all the same).
    refs = {sid: _Ref(k) for sid, k in keys.items()}
    closed, served = set(), 0
    for (kind, args), r in zip([c for step in steps for c in step], got):
        if kind == "close" and r.ok:
            closed.add(args[1])
        if kind != "rc4" or args[1] not in refs or args[1] in closed:
            continue
        ks = np.frombuffer(refs[args[1]].next(args[2].size), np.uint8)
        if r.ok:
            assert np.asarray(r.payload).tobytes() == (args[2] ^ ks).tobytes()
            served += 1
    assert served == 10 and got_st["chunks"] == 12


def test_server_without_rc4_has_no_session_store():
    server = Server(ServerConfig(device="cpu", min_bucket_blocks=32, max_bucket_blocks=64,
                                 lanes=1))
    assert server.sessions is None

    async def go():
        await server.start()
        try:
            return (await server.open_session("t", 0, b"\x01" * 16),
                    await server.submit("t", b"", b"", np.zeros(16, np.uint8), mode="rc4",
                                        sid=0))
        finally:
            await server.stop()

    opened, chunk = asyncio.run(go())
    assert (opened.ok, opened.error, chunk.ok, chunk.error) == \
        (False, "bad-request", False, "bad-request")
    assert server.stats()["sessions"] is None


def test_lane_hang_mid_refill_replays_carry_bit_exact(monkeypatch):
    """The lane-kill drill at the session seam (the JAX test's scenario): the
    first traffic dispatch, the session's prefill, hangs; the watchdog
    quarantines its lane and the same carry runs on the other lane; every
    chunk equals the host PRGA."""
    monkeypatch.setenv("OT_FAULTS", "lane_hang:1")
    monkeypatch.setenv("OT_DISPATCH_DEADLINE", "2")
    faults.reset()
    server = Server(ServerConfig(device="cpu", modes=("ctr", "rc4"), min_bucket_blocks=32,
                                 max_bucket_blocks=256, lanes=2, **SESSION_SHAPE))
    key = bytes(range(16))
    ref = _Ref(key)

    async def go():
        await server.start()
        try:
            assert (await server.open_session("t", 0, key)).ok
            rng = np.random.default_rng(1)
            for i in range(6):
                data = rng.integers(0, 256, 16 * 128, dtype=np.uint8)
                r = await server.submit("t", b"", b"", data, mode="rc4", sid=0)
                assert r.ok, (i, r.error, r.detail)
                assert np.asarray(r.payload).tobytes() == (
                    data ^ np.frombuffer(ref.next(data.size), np.uint8)).tobytes(), i
            return server.stats()
        finally:
            await server.stop()

    stats = asyncio.run(go())
    lanes_st = stats["lanes"]
    assert lanes_st["quarantine_events"] == 1 and lanes_st["redispatches"] >= 1
    assert stats["sessions"]["prefetch"]["replays"] >= 1
    assert stats["compiles"]["steady"] == 0
    # The hung call never reached its kernel: rc4-prep calls are the warmups
    # and the refills that ran.
    assert lanes_st["engine_calls_by_mode"]["rc4-prep"] == \
        2 + stats["sessions"]["prefetch"]["dispatches"]


# ---------------------------------------------------------------------------
# Sessions through the router: the pin (the JAX package's
# tests/test_session.py router case, and a pinned session end to end).
# ---------------------------------------------------------------------------


def test_router_session_data_requires_a_pin():
    import route_pair as rp

    out = []
    for pkg in rp.PKGS:
        router = pkg.Router([pkg.BackendSpec("b0", "127.0.0.1", 1)], pkg.RouterConfig())
        r = asyncio.run(router.submit_session("t", 3, b"\x00" * 16))
        c = asyncio.run(router.close_session("t", 3))
        out.append((r.ok, r.error, "not open" in r.detail, c.ok, c.error,
                    router.stats()["accepted"]))
    assert out[1] == out[0] == (False, "bad-request", True, False, "bad-request", 0)


def test_router_pins_a_session_to_one_backend_bit_exact():
    """An rc4 session through the port's router over port servers: every
    frame walks the session's one replica sequence (the JAX router's
    ``session_order``), each chunk equal to the host PRGA's keystream XOR,
    and the pin is dropped at close."""
    import route_pair as rp

    key = b"\x77" * 16
    rng = np.random.default_rng(23)
    chunks = [rng.integers(0, 256, 16 * n, dtype=np.uint8) for n in (4, 32, 7)]
    ks, _ = arc4.keystream_np((0, 0, arc4.key_schedule(key)), sum(c.size for c in chunks))
    ks = np.asarray(ks, np.uint8)

    async def main():
        async with rp.Cluster(rp.PORT, n=3, server_kw=dict(
                modes=("ctr", "rc4"), session_quantum_bytes=1024, session_prefetch_slots=2,
                session_window_bytes=2048)) as c:
            jr = rp.JAX.Router([rp.JAX.BackendSpec(s.name, s.host, s.port) for s in c.specs],
                               rp.JAX.RouterConfig())
            for s in c.specs:
                jr._register(rp.JAX.BackendSpec(s.name, s.host, s.port))
            assert c.router.session_order("wt", 5) == jr.session_order("wt", 5)
            opened = await c.router.open_session("wt", 5, key)
            assert opened.ok
            pin = c.router._session_pins[("wt", 5)]
            assert pin == c.router.session_order("wt", 5)[0]
            off = 0
            for chunk in chunks:
                before = rp.dispatches(c.router)
                r = await c.router.submit("wt", b"", b"", chunk, mode="rc4", sid=5)
                assert r.ok, (r.error, r.detail)
                assert bytes(np.asarray(r.payload)) == np.bitwise_xor(
                    chunk, ks[off:off + chunk.size]).tobytes()
                assert rp.dispatches(c.router) == before  # session frames are not dispatches
                off += chunk.size
            closed = await c.router.close_session("wt", 5)
            assert closed.ok
            st = c.router.stats()["sessions"]
            assert st == {"opened": 1, "closed": 1, "chunks": 3, "pinned": 0, "pin_misses": 0}
            again = await c.router.submit("wt", b"", b"", chunks[0], mode="rc4", sid=5)
            assert not again.ok and again.error == "bad-request"

    asyncio.run(main())
