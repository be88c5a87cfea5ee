"""Chunked transfers in the port (``our_tree_tpu_torch.serve.transfer``) held
against the JAX package's (``our_tree_tpu.serve.transfer``) on the same
inputs, made from seeds with numpy:

* ``chunk_nonce``, ``plan`` (CTR, and CBC from the payload or from ledger
  ``tails``) and ``fingerprint`` in random cases, with counter wraps at
  2^32, 2^64 and 2^128 that land exactly on a chunk boundary;
* the ledger's file: one written by either package loads in the other with
  the same acked chunks and tails, and a torn tail is truncated;
* the port's ``Server(device="cpu")`` and the JAX server (``engine="jnp"``)
  answer the same oversized ``ctr`` and ``cbc`` payloads byte for byte on a
  32-64 block ladder (3-9 chunks each), the SP 800-38A F.5.1 KAT across a
  chunk boundary among them, with the same codes for an oversized ``gcm``
  (``transfer-unsupported``), a payload over the transfer cap and a server
  with transfers off (``too-large``);
* the manager's ``chunk_lost`` redispatch, its shedding, an abort then a
  resume, and ``reassembly_stall``, each over one deterministic stand-in
  cipher in both managers, with equal results and tallies;
* the loadgen's oversized probes equal to the JAX loadgen's, and its
  oversized mix through a CPU server, every transfer verified.

Integer cryptography and byte splicing: the tolerance is exact (bytes).
"""

import asyncio
import hashlib
import json

import numpy as np
import pytest

from our_tree_tpu.resilience import faults as jfaults
from our_tree_tpu.serve import queue as jqueue
from our_tree_tpu.serve import transfer as jtransfer
from our_tree_tpu.serve.server import Server as JServer
from our_tree_tpu.serve.server import ServerConfig as JServerConfig
from our_tree_tpu_torch.models.aes import AES, AES_DECRYPT
from our_tree_tpu_torch.obs import metrics
from our_tree_tpu_torch.resilience import degrade, faults
from our_tree_tpu_torch.serve import queue as otq
from our_tree_tpu_torch.serve import transfer
from our_tree_tpu_torch.serve.server import Server, ServerConfig

CHUNK = 64  # the ladder's top rung, and so the chunk, in blocks
LADDER = dict(min_bucket_blocks=32, max_bucket_blocks=CHUNK, lanes=1)
#: the transfer cap of both servers: 9 chunks
CAP = 9 * CHUNK * 16

# NIST SP 800-38A F.5.1 (CTR-AES128.Encrypt).
NIST_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
NIST_CTR0 = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
NIST_PT = bytes.fromhex("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
                        "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
NIST_CT = bytes.fromhex("874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
                        "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("OT_FAULTS", raising=False)
    monkeypatch.delenv("OT_TRACE_DIR", raising=False)
    monkeypatch.delenv("OT_DISPATCH_DEADLINE", raising=False)
    faults.reset()
    jfaults.reset()
    degrade.clear()
    yield
    monkeypatch.delenv("OT_FAULTS", raising=False)
    faults.reset()
    jfaults.reset()
    degrade.clear()
    metrics.reset()


def _sub(nonce: bytes, blocks: int) -> bytes:
    """``nonce`` minus ``blocks`` mod 2^128, big-endian."""
    return ((int.from_bytes(nonce, "big") - blocks) % (1 << 128)).to_bytes(16, "big")


# ---------------------------------------------------------------------------
# The decomposition math.
# ---------------------------------------------------------------------------


#: Counter starts whose wrap (at 2^32, 2^64 or 2^128) lands exactly on the
#: boundary before chunk 1, 2 or 3 of a 4-chunk plan.
WRAPS = [(w, k) for w in (32, 64, 128) for k in (1, 2, 3)]


@pytest.mark.parametrize("bits,k", WRAPS)
def test_chunk_nonces_match_reference_across_wraps(bits, k):
    rng = np.random.default_rng(bits * 10 + k)
    high = int(rng.integers(0, 1 << 62)) << 66 if bits < 128 else 0
    nonce = ((high + (1 << bits) - k * CHUNK) % (1 << 128)).to_bytes(16, "big")
    specs = transfer.plan("ctr", CHUNK, 4 * CHUNK * 16, nonce=nonce)
    want = jtransfer.plan("ctr", CHUNK, 4 * CHUNK * 16, nonce=nonce)
    assert [(s.index, s.offset, s.nbytes, s.nonce, s.iv) for s in specs] == \
        [(s.index, s.offset, s.nbytes, s.nonce, s.iv) for s in want]
    # The chunk after the wrap starts at the wrapped counter.
    assert int.from_bytes(specs[k].nonce, "big") % (1 << bits) == 0


@pytest.mark.parametrize("seed", range(6))
def test_plan_and_fingerprint_match_reference(seed):
    rng = np.random.default_rng(seed)
    chunk_blocks = int(rng.integers(1, 9))
    total = 16 * int(rng.integers(1, 80))
    nonce, iv = rng.bytes(16), rng.bytes(16)
    key = rng.bytes(int(rng.choice([16, 24, 32])))
    ct = rng.integers(0, 256, total, dtype=np.uint8)
    for mode in ("ctr", "cbc"):
        got = transfer.plan(mode, chunk_blocks, total, nonce=nonce, iv=iv, payload=ct)
        want = jtransfer.plan(mode, chunk_blocks, total, nonce=nonce, iv=iv, payload=ct)
        assert [tuple(vars(s).values()) for s in got] == [tuple(vars(s).values()) for s in want]
        assert transfer.fingerprint(mode, key, nonce, iv, total, chunk_blocks) == \
            jtransfer.fingerprint(mode, key, nonce, iv, total, chunk_blocks)
    # A resume plans cbc IVs from the ledger's tails without the payload.
    specs = transfer.plan("cbc", chunk_blocks, total, iv=iv, payload=ct)
    tails = {s.index: ct[s.offset + s.nbytes - 16:s.offset + s.nbytes].tobytes()
             for s in specs}
    assert transfer.plan("cbc", chunk_blocks, total, iv=iv, tails=tails) == specs
    assert [s.iv for s in jtransfer.plan("cbc", chunk_blocks, total, iv=iv, tails=tails)] == \
        [s.iv for s in specs]


def test_plan_refusals_match_reference():
    for args, kw in [(("ctr", 4, 40), {"nonce": b"\0" * 16}), (("ctr", 0, 64), {"nonce": b"\0" * 16}),
                     (("gcm", 4, 64), {}), (("cbc", 4, 128), {"iv": b"\0" * 16})]:
        with pytest.raises(ValueError) as got:
            transfer.plan(*args, **kw)
        with pytest.raises(ValueError) as want:
            jtransfer.plan(*args, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        transfer.chunk_nonce(b"\0" * 12, 1)


# ---------------------------------------------------------------------------
# The ledger's file, across the packages.
# ---------------------------------------------------------------------------


def _fill(ledger, rng):
    """Three transfers: one done, two live with acks and cbc tails."""
    for tid in ("a", "b", "c"):
        ledger.begin(tid, f"fp-{tid}", 6)
    for i in (0, 1, 3):
        ledger.ack("a", i, tail=rng.bytes(16))
    ledger.ack("b", 2)
    ledger.done("c")


@pytest.mark.parametrize("writer,reader", [(transfer, jtransfer), (jtransfer, transfer)],
                         ids=["port-writes", "jax-writes"])
def test_ledger_file_loads_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "tx.jsonl")
    led = writer.TransferLedger(path)
    _fill(led, np.random.default_rng(5))
    want = {t: (led.acked(t), led.tails(t)) for t in ("a", "b", "c")}
    led.close()
    back = reader.TransferLedger(path)
    assert {t: (back.acked(t), back.tails(t)) for t in ("a", "b", "c")} == want
    assert back.live() == 2
    # A resume with the same fingerprint sees the acks; another restarts.
    assert back.begin("a", "fp-a", 6) == {0, 1, 3}
    assert back.begin("b", "fp-other", 6) == set()
    back.close()


@pytest.mark.parametrize("pkg", [transfer, jtransfer], ids=["port", "jax"])
def test_ledger_torn_tail_truncated_in_both(tmp_path, pkg):
    path = str(tmp_path / "tx.jsonl")
    led = transfer.TransferLedger(path)
    led.begin("t", "fp", 4)
    led.ack("t", 0)
    led.close()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"op":"ack","tid":"t","i":')  # the torn tail
    back = pkg.TransferLedger(path)
    assert back.acked("t") == {0}
    back.ack("t", 1)
    back.close()
    rows = [json.loads(line) for line in open(path, encoding="utf-8")]
    assert rows[0]["kind"] == transfer.LEDGER_KIND == jtransfer.LEDGER_KIND
    assert [r.get("i") for r in rows if r.get("op") == "ack"] == [0, 1]


# ---------------------------------------------------------------------------
# The servers: the port's against the JAX package's.
# ---------------------------------------------------------------------------


def _cases():
    """(name, mode, key, nonce, iv, payload) over oversized payloads."""
    rng = np.random.default_rng(2024)
    out = []
    for i in range(6):
        size = 16 * int(rng.integers(2 * CHUNK + 1, 9 * CHUNK + 1))
        out.append((f"ctr-{i}", "ctr", rng.bytes(16), rng.bytes(16), b"",
                    rng.integers(0, 256, size, dtype=np.uint8)))
    for i in range(4):
        size = 16 * int(rng.integers(2 * CHUNK + 1, 9 * CHUNK + 1))
        key = rng.bytes(32 if i == 3 else 16)
        out.append((f"cbc-{i}", "cbc", key, b"", rng.bytes(16),
                    rng.integers(0, 256, size, dtype=np.uint8)))
    # F.5.1 across the boundary between chunks 0 and 1: blocks 62-65.
    kat = rng.integers(0, 256, 16 * (2 * CHUNK + 2), dtype=np.uint8)
    kat[16 * (CHUNK - 2):16 * (CHUNK + 2)] = np.frombuffer(NIST_PT, np.uint8)
    out.append(("ctr-kat", "ctr", NIST_KEY, _sub(NIST_CTR0, CHUNK - 2), b"", kat))
    for bits in (32, 64, 128):
        out.append((f"ctr-wrap-{bits}", "ctr", rng.bytes(16),
                    (((1 << bits) - 2 * CHUNK) % (1 << 128)).to_bytes(16, "big"), b"",
                    rng.integers(0, 256, 16 * 4 * CHUNK, dtype=np.uint8)))
    out.append(("gcm-over", "gcm", rng.bytes(16), b"", rng.bytes(12),
                rng.integers(0, 256, 16 * (CHUNK + 1), dtype=np.uint8)))
    out.append(("gcm-at-rung", "gcm", rng.bytes(16), b"", rng.bytes(12),
                rng.integers(0, 256, 16 * CHUNK, dtype=np.uint8)))
    out.append(("ctr-over-cap", "ctr", rng.bytes(16), rng.bytes(16), b"",
                np.zeros(CAP + 16, np.uint8)))
    return out


CASES = _cases()


def _serve(server, cases):
    async def main():
        await server.start()
        try:
            return [await server.submit("t", key, nonce, payload, mode=mode, iv=iv)
                    for _, mode, key, nonce, iv, payload in cases]
        finally:
            await server.stop()

    return asyncio.run(main())


@pytest.fixture(scope="module")
def answers():
    """Every case through the JAX server and the port's, and the ``ctr``
    cases through both with transfers off."""
    cfg = dict(modes=("ctr", "cbc", "gcm"), transfer_max_bytes=CAP, **LADDER)
    want = _serve(JServer(JServerConfig(engine="jnp", **cfg)), CASES)
    port = Server(ServerConfig(device="cpu", **cfg))
    got = _serve(port, CASES)
    off = [c for c in CASES if c[1] == "ctr"][:2]
    want_off = _serve(JServer(JServerConfig(engine="jnp", transfer_chunk_blocks=0, **LADDER)),
                      off)
    got_off = _serve(Server(ServerConfig(device="cpu", transfer_chunk_blocks=0, **LADDER)), off)
    return {"got": dict(zip([c[0] for c in CASES], got)),
            "want": dict(zip([c[0] for c in CASES], want)),
            "off": (got_off, want_off), "stats": port.stats()}


def _tallies(tx):
    return None if tx is None else {k: v for k, v in tx.items() if k != "token"}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_server_answers_equal_reference(answers, case):
    name, mode, key, nonce, iv, payload = case
    g, w = answers["got"][name], answers["want"][name]
    assert (g.ok, g.error, g.detail) == (w.ok, w.error, w.detail)
    assert _tallies(g.transfer) == _tallies(w.transfer)
    if not w.ok:
        assert g.payload is None
        return
    assert g.payload.tobytes() == np.asarray(w.payload).tobytes()
    # And the single-shot reference on the host.
    ref = AES(key, device="cpu")
    if mode == "ctr":
        want = ref.crypt_ctr(0, np.frombuffer(nonce, np.uint8), np.zeros(16, np.uint8),
                             payload)[0]
    else:
        want = ref.crypt_cbc(AES_DECRYPT, np.frombuffer(iv, np.uint8), payload)[0]
    assert g.payload.tobytes() == np.asarray(want).tobytes()
    assert g.transfer["chunks"] == -(-payload.size // (16 * CHUNK))


def test_server_codes_for_gcm_cap_and_kat(answers):
    got = answers["got"]
    assert got["gcm-over"].error == got["gcm-at-rung"].error == otq.ERR_TRANSFER_MODE == \
        jqueue.ERR_TRANSFER_MODE
    assert got["ctr-over-cap"].error == otq.ERR_TOO_LARGE
    kat = got["ctr-kat"].payload[16 * (CHUNK - 2):16 * (CHUNK + 2)].tobytes()
    assert kat == NIST_CT
    assert 3 <= min(r.transfer["chunks"] for r in got.values() if r.ok)
    assert max(r.transfer["chunks"] for r in got.values() if r.ok) <= 9
    stats = answers["stats"]
    assert stats["queue"]["lost"] == 0
    assert stats["transfers"]["refused"] == 3 and stats["transfers"]["held_bytes"] == 0
    assert stats["transfers"]["ledger_live"] == 0


def test_server_with_transfers_off_answers_too_large(answers):
    got, want = answers["off"]
    assert [(g.ok, g.error, g.detail) for g in got] == [(w.ok, w.error, w.detail) for w in want]
    assert all(g.error == otq.ERR_TOO_LARGE for g in got)


# ---------------------------------------------------------------------------
# The manager over a stand-in cipher, the port's against the JAX package's.
# ---------------------------------------------------------------------------


def _chunk_bytes(key, spec, piece) -> bytes:
    """A deterministic stand-in cipher: the output depends only on (key,
    the chunk's parameters, its bytes), the property a resume relies on."""
    seed = hashlib.sha256(bytes(key) + spec.nonce + spec.iv + spec.index.to_bytes(4, "big")
                          + np.asarray(piece, np.uint8).tobytes()).digest()
    return (seed * (len(piece) // 32 + 1))[:len(piece)]


def _submit(response_cls, calls):
    async def submit(tenant, key, spec, piece, *, mode, deadline_s, sampled, parent):
        calls.append(spec.index)
        await asyncio.sleep(0)
        return response_cls(ok=True, payload=np.frombuffer(_chunk_bytes(key, spec, piece),
                                                           np.uint8))
    return submit


def _managers(**kw):
    """(port manager, its calls), (JAX manager, its calls)."""
    out = []
    for pkg, resp in ((transfer, otq.Response), (jtransfer, jqueue.Response)):
        calls = []
        out.append((pkg.TransferManager(_submit(resp, calls), chunk_blocks=4, **kw), calls))
    return out


def _arm(monkeypatch, spec):
    if spec:
        monkeypatch.setenv("OT_FAULTS", spec)
    else:
        monkeypatch.delenv("OT_FAULTS", raising=False)
    faults.reset()
    jfaults.reset()


def _run_both(monkeypatch, fault, payload, **run_kw):
    """The same run through both managers, each under a fresh fault charge;
    [(response, calls, manager)] port first."""
    out = []
    for tm, calls in _managers(window=3):
        _arm(monkeypatch, fault)
        resp = asyncio.run(tm.run("t", b"k" * 16, b"\x05" * 16, payload, **run_kw))
        out.append((resp, list(calls), tm))
    return out


def _same(a, b):
    ra, ca, ta = a
    rb, cb, tb = b
    assert (ra.ok, ra.error, ra.detail) == (rb.ok, rb.error, rb.detail)
    assert _tallies(ra.transfer) == _tallies(rb.transfer)
    assert (ra.payload is None) == (rb.payload is None)
    if ra.payload is not None:
        assert ra.payload.tobytes() == np.asarray(rb.payload).tobytes()
    assert sorted(ca) == sorted(cb)
    assert ta.stats() == tb.stats()


def test_manager_chunk_lost_redispatch_matches_reference(monkeypatch):
    payload = np.arange(16 * 24, dtype=np.uint8) % 247
    port, ref = _run_both(monkeypatch, "chunk_lost:1@chunk=2", payload)
    _same(port, ref)
    assert port[0].ok and port[0].transfer["redispatched"] == 1
    assert port[0].transfer["sent"] == 7 and port[1].count(2) == 2


def test_manager_reassembly_stall_matches_reference(monkeypatch):
    monkeypatch.setenv("OT_SLOW_S", "0.01")
    payload = np.arange(16 * 12, dtype=np.uint8) % 233
    port, ref = _run_both(monkeypatch, "reassembly_stall:1@chunk=0", payload)
    _same(port, ref)
    assert port[0].ok


def test_manager_sheds_like_reference():
    payload = np.zeros(16 * 8, np.uint8)
    answers = []
    for tm, _ in _managers(max_transfers=2, reassembly_budget_bytes=1024):
        tm.active = 2  # the transfer table is full
        first = asyncio.run(tm.run("t", b"k" * 16, b"n" * 16, payload))
        tm.active, tm.held_bytes = 0, 2048  # the consumer is slow
        second = asyncio.run(tm.run("t", b"k" * 16, b"n" * 16, payload))
        tm.held_bytes = 0
        third = asyncio.run(tm.run("t", b"k" * 16, b"n" * 16, payload))
        answers.append([(r.ok, r.error, r.detail) for r in (first, second, third)]
                       + [tm.shed, tm.completed])
    assert answers[0] == answers[1]
    assert answers[0][0][1] == otq.ERR_SHED and answers[0][3:] == [2, 1]


def test_manager_abort_then_resume_matches_reference(monkeypatch):
    key, nonce = b"k" * 16, b"\x0b" * 16
    payload = np.arange(16 * 32, dtype=np.uint8) % 239  # 8 chunks
    whole = b"".join(_chunk_bytes(key, s, payload[s.offset:s.offset + s.nbytes])
                     for s in transfer.plan("ctr", 4, payload.size, nonce=nonce))
    runs = []
    for pkg, resp_cls in ((transfer, otq.Response), (jtransfer, jqueue.Response)):
        calls = []
        tm = pkg.TransferManager(_submit(resp_cls, calls), chunk_blocks=4, window=2,
                                 ledger=pkg.TransferLedger())
        out = np.zeros(payload.size, np.uint8)

        def collect(spec, resp, out=out):
            out[spec.offset:spec.offset + spec.nbytes] = resp.payload

        _arm(monkeypatch, "transfer_abort:1@chunk=7")
        first = asyncio.run(tm.run("t", key, nonce, payload, resume_token="tok",
                                   on_chunk=collect))
        _arm(monkeypatch, "")
        second = asyncio.run(tm.run("t", key, nonce, payload, resume_token="tok",
                                    on_chunk=collect))
        runs.append(((first.ok, first.error, first.detail, _tallies(first.transfer)),
                     (second.ok, second.error, _tallies(second.transfer)),
                     out.tobytes(), sorted(calls), tm.stats()))
    assert runs[0] == runs[1]
    (ok1, err1, _, tx1), (ok2, _, tx2), spliced, _, stats = runs[0]
    assert not ok1 and err1 == otq.ERR_TRANSFER_ABORT and 0 < tx1["acked"] < 8
    assert ok2 and tx2["resumed"] and tx2["skipped"] == tx1["acked"]
    assert tx2["sent"] == 8 - tx1["acked"] and spliced == whole
    assert stats["held_bytes"] == 0 and stats["ledger_live"] == 0


# ---------------------------------------------------------------------------
# The loadgen's oversized mix.
# ---------------------------------------------------------------------------


def test_transfer_probes_match_reference():
    from our_tree_tpu.serve import loadgen as jloadgen
    from our_tree_tpu_torch.serve import loadgen

    sizes = (16 * 3 * CHUNK, 16 * 5 * CHUNK + 48)
    got = loadgen.make_transfer_probes(sizes, seed=3)
    want = jloadgen.make_transfer_probes(sizes, seed=3)
    for g, w in zip(got, want):
        assert (g.tenant, g.key, g.nonce, g.mode) == (w.tenant, w.key, w.nonce, w.mode)
        assert g.payload.tobytes() == w.payload.tobytes()
        assert g.expected.tobytes() == np.asarray(w.expected).tobytes()
    with pytest.raises(ValueError):
        loadgen.make_transfer_probes((40,), seed=3)


def test_loadgen_transfer_mix_verified():
    """Every third request oversized (3 and 5 chunks in turn): each transfer
    verified against its single-shot reference, tallied, none mismatching."""
    from our_tree_tpu_torch.serve import loadgen

    server = Server(ServerConfig(device="cpu", **LADDER))

    async def main():
        await server.start()
        try:
            return await loadgen.run(server, 12, concurrency=3, sizes=(16, 256, 1024), seed=4,
                                     transfer_sizes=(16 * 3 * CHUNK, 16 * 4 * CHUNK + 16),
                                     transfer_every=3)
        finally:
            await server.stop()

    report = asyncio.run(main())
    assert report.ok == report.requests == 12 and report.mismatches == 0
    assert report.transfers == {"requests": 4, "ok": 4, "chunks_sent": 16, "redispatched": 0}
    assert report.verified >= 4 and report.to_json()["transfers"] == report.transfers


# ---------------------------------------------------------------------------
# Transfers at the router: the replica router's frame hardening, the chunk
# spray, and a routed transfer against the JAX router's (the JAX package's
# tests/test_transfer.py router cases, through both packages).
# ---------------------------------------------------------------------------


async def _send_raw(pkg, port: int, blob: bytes, then: bytes = b""):
    """Write raw bytes and read one frame; optionally one more frame on the
    same connection and its answer."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(blob)
        await writer.drain()
        first = await pkg.wire.read_frame(reader, max_len=1 << 24)
        second = None
        if then:
            writer.write(then)
            await writer.drain()
            second = await pkg.wire.read_frame(reader, max_len=1 << 24)
        return first, second
    finally:
        writer.close()


def test_router_frontend_hardening_typed_errors():
    import route_pair as rp

    async def script(pkg):
        router = pkg.Router([pkg.BackendSpec("b0", "127.0.0.1", 1, None)], pkg.RouterConfig())
        srv = pkg.fleet.RouterServer(router, max_frame_bytes=4096)
        await srv.start()
        try:
            declared = 4096 + 16
            hdr = json.dumps({"t": "t", "len": declared}).encode() + b"\n"
            (h1, _), second = await _send_raw(pkg, srv.port, hdr + b"\x00" * declared,
                                              then=pkg.wire.encode_frame({"g": 1}))
            (h2, _), _ = await _send_raw(pkg, srv.port, b"garbage header\n")
            return ((h1["ok"], h1["error"]), second[0].get("g"), (h2["ok"], h2["error"]),
                    srv.protocol_errors)
        finally:
            await srv.stop()

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    assert port_out == ((False, otq.ERR_TOO_LARGE), 1, (False, otq.ERR_BAD_REQUEST), 2)


def test_router_rotate_spreads_chunks_across_replica_set():
    import route_pair as rp

    orders = []
    for pkg in rp.PKGS:
        specs = [pkg.BackendSpec(f"b{i}", "127.0.0.1", i + 1, None) for i in range(3)]
        router = pkg.Router(specs, pkg.RouterConfig(vnodes=16, seed=3))
        for s in specs:
            router._register(s)
        orders.append(router._order_for("tenant/deadbeef"))
    assert orders[0] == orders[1]
    base = orders[1]
    heads = {(base[i:] + base[:i])[0] for i in range(len(base))}
    assert sorted(base) == ["b0", "b1", "b2"] and len(heads) == 3


def test_routed_transfer_sprays_chunks_and_resumes_like_reference(monkeypatch):
    """A 5-chunk CTR transfer through each package's router over its own
    three servers: the same output (equal to the plain AES over the whole
    payload), the same chunks on the same back ends, and a ``transfer_abort``
    at the last chunk resumed by token with only the unacked chunks sent."""
    import route_pair as rp

    rng = np.random.default_rng(31)
    key, nonce = rng.bytes(16), rng.bytes(16)
    payload = np.frombuffer(rng.bytes(5 * 256 * 16 - 48), np.uint8)
    want, *_ = AES(key, device="cpu").crypt_ctr(0, np.frombuffer(nonce, np.uint8).copy(),
                                                 np.zeros(16, np.uint8), payload)

    async def script(pkg):
        # A window of one chunk: the abort at the last chunk's admission
        # comes after every earlier chunk was acked.
        async with rp.Cluster(pkg, n=3, router_kw=dict(transfer_chunk_blocks=256,
                                                      transfer_window=1)) as c:
            resp = await c.router.submit("tx", key, nonce, payload)
            spray = rp.dispatches(c.router)
            out = np.zeros(payload.size, np.uint8)

            def collect(spec, r):
                out[spec.offset:spec.offset + spec.nbytes] = np.asarray(r.payload)[:spec.nbytes]

            monkeypatch.setenv("OT_FAULTS", "transfer_abort:1@chunk=4")
            pkg.faults.reset()
            first = await c.router.submit_transfer("tx", key, nonce, payload, resume_token="tok",
                                                   on_chunk=collect)
            monkeypatch.delenv("OT_FAULTS")
            pkg.faults.reset()
            second = await c.router.submit_transfer("tx", key, nonce, payload,
                                                    resume_token="tok", on_chunk=collect)
            t2 = second.transfer or {}
            return (rp.answer(resp), spray, (first.ok, first.error), second.ok,
                    (t2.get("resumed"), t2.get("skipped"), t2.get("sent")), out.tobytes(),
                    c.router.stats()["lost"])

    jax_out, port_out = rp.run_both(script)
    assert port_out == jax_out
    ans, spray, first, ok, (resumed, skipped, sent), spliced, lost = port_out
    assert ans[0] and ans[2] == np.asarray(want, np.uint8).tobytes() == spliced
    assert sum(1 for n in spray.values() if n) >= 2 and sum(spray.values()) == 5
    assert first == (False, otq.ERR_TRANSFER_ABORT) and ok and resumed
    assert skipped > 0 and sent < 5 and lost == 0
