"""The port's wire front end, status endpoint, incident recorder and
Prometheus rendering held against the JAX package's on the same inputs:

* ``encode_frame``/``read_frame`` byte for byte on random headers and
  payloads, and the same ``FrameTooLarge``/``WireError`` cases;
* ``render_prometheus`` equal to the JAX rendering after the same counter,
  gauge and observe calls on each registry, exemplars on and off;
* the port's incident bundles pass the JAX ``validate_bundle``, and the
  auth-spike threshold triggers as in ``tests/test_incident.py``;
* the port's ``RequestFrontend`` and the JAX one (``engine="jnp"``, a 32-64
  block ladder) answer the same frame sequences with the same frames (the
  clock stamps and pid masked), in process and over loopback: one-frame
  requests of every mode, a tampered ``gcm-open``, ``tx`` exchanges and
  their refusals, a ``transfer_abort`` and its resume, oversized,
  undrainable and garbage frames, and ``ss`` session frames (two sessions'
  ``open``, interleaved ``data`` and ``close``, a ``data`` on a closed
  session, a bad sid and an unknown op; every chunk also against the host
  PRGA);
* ``/healthz`` with the JAX body's keys, ``/incidentz`` with the same body,
  ``/alertz`` and ``/fleetz`` answering 404 with the JAX bodies;
* ``python -m our_tree_tpu_torch.serve.worker --device cpu`` in a process:
  READY, one request, SIGTERM, the EXIT line with ``lost: 0``, rc 0; the
  worker's options (``--journal``, the ``--session-*`` store shape,
  ``--native-threads``) reach its ``ServerConfig``.

Integer cryptography and byte framing: the tolerance is exact (bytes).
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from our_tree_tpu.obs import incident as jincident
from our_tree_tpu.obs import metrics as jmetrics
from our_tree_tpu.resilience import faults as jfaults
from our_tree_tpu.serve import wire as jwire
from our_tree_tpu.serve.server import Server as JServer
from our_tree_tpu.serve.server import ServerConfig as JServerConfig
from our_tree_tpu.serve.worker import RequestFrontend as JFrontend
from our_tree_tpu_torch.aead import ghash
from our_tree_tpu_torch.models import arc4
from our_tree_tpu_torch.models.aes import AES, AES_DECRYPT
from our_tree_tpu_torch.obs import incident, metrics
from our_tree_tpu_torch.resilience import degrade, faults
from our_tree_tpu_torch.serve import wire
from our_tree_tpu_torch.serve.server import Server, ServerConfig
from our_tree_tpu_torch.serve.worker import RequestFrontend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 64
CFG = dict(min_bucket_blocks=32, max_bucket_blocks=CHUNK, lanes=1, transfer_window=2,
           transfer_max_bytes=16 * CHUNK * 16, modes=("ctr", "cbc", "gcm", "gcm-open", "rc4"),
           session_quantum_bytes=1024, session_prefetch_slots=2, session_window_bytes=2048,
           status_port=0)
#: The ``session`` sequence's sessions: (sid, key) and each one's chunks.
SESSION_KEYS = {1: bytes(16), 2: bytes(range(16))}
SESSION_CHUNKS = {1: (32, 512, 16), 2: (256, 48)}
#: What a worker's answer frames may differ in: the clocks and the pid.
MASKED = ("tr", "ts", "pid")
#: The longest wait on any one line or frame.
WAIT_S = 60


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("OT_FAULTS", raising=False)
    monkeypatch.delenv("OT_TRACE_DIR", raising=False)
    monkeypatch.delenv("OT_TRACE_RUN", raising=False)
    faults.reset()
    jfaults.reset()
    degrade.clear()
    yield
    monkeypatch.delenv("OT_FAULTS", raising=False)
    faults.reset()
    jfaults.reset()
    degrade.clear()
    # The JAX servers' counters stay with this file: a JAX test later in
    # the same process reads the registry's modes.
    jmetrics.reset_for_tests()


# ---------------------------------------------------------------------------
# Framing.
# ---------------------------------------------------------------------------


def _reader(blob: bytes) -> asyncio.StreamReader:
    r = asyncio.StreamReader(limit=1 << 16)
    r.feed_data(blob)
    r.feed_eof()
    return r


async def _read_all(mod, blob: bytes, max_len: int):
    """Every frame ``mod.read_frame`` takes from ``blob``, then the error
    (type name and text) or None at a clean EOF."""
    r, frames = _reader(blob), []
    try:
        while True:
            f = await mod.read_frame(r, max_len)
            if f is None:
                return frames, None
            frames.append(f)
    except mod.WireError as e:
        declared = getattr(e, "declared", None)
        return frames, (type(e).__name__, str(e), declared)


@pytest.mark.parametrize("seed", range(8))
def test_frames_byte_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    blob = b""
    for _ in range(int(rng.integers(1, 6))):
        header = {"t": f"t{int(rng.integers(100))}", "k": rng.bytes(16).hex(),
                  "n": rng.bytes(16).hex(), "m": str(rng.choice(["ctr", "gcm", "cbc"])),
                  "deadline_s": None if rng.integers(2) else float(rng.random()),
                  "sm": bool(rng.integers(2)), "tx": "chunk", "i": int(rng.integers(9))}
        payload = rng.bytes(int(rng.choice([0, 1, 16, 4096, 70000])))
        frame = wire.encode_frame(header, payload)
        assert frame == jwire.encode_frame(header, payload)
        blob += frame
    got = asyncio.run(_read_all(wire, blob, wire.MAX_PAYLOAD))
    assert got == asyncio.run(_read_all(jwire, blob, jwire.MAX_PAYLOAD))
    assert got[1] is None


BAD = {
    "oversized": json.dumps({"t": "x", "len": 1 << 23}).encode() + b"\n",
    "negative": json.dumps({"len": -1}).encode() + b"\n",
    "garbage": b"not json\n",
    "not-an-object": b"[1, 2]\n",
    "len-not-int": b'{"len": "x"}\n',
    "header-too-long": json.dumps({"t": "x" * 5000}).encode() + b"\n",
    "torn-header": b'{"t": "x"',
    "torn-payload": json.dumps({"len": 10}).encode() + b"\nabc",
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_frame_errors_match_reference(name):
    blob = wire.encode_frame({"t": "ok"}, b"\x01" * 16) + BAD[name]
    got = asyncio.run(_read_all(wire, blob, wire.MAX_PAYLOAD))
    want = asyncio.run(_read_all(jwire, blob, jwire.MAX_PAYLOAD))
    assert got == want
    assert len(got[0]) == 1
    if name == "torn-header":
        # asyncio's IncompleteReadError is an EOFError: both packages read
        # a header torn by EOF as the end of the stream.
        assert got[1] is None
        return
    assert (got[1][0] == "FrameTooLarge") == (name in ("oversized", "negative"))
    assert (wire.MAX_HEADER, wire.MAX_PAYLOAD) == (jwire.MAX_HEADER, jwire.MAX_PAYLOAD)


def test_skip_payload_resyncs_like_reference():
    blob = b"\x00" * 100 + wire.encode_frame({"t": "next"}, b"ab")

    async def go(mod):
        r = _reader(blob)
        ok = await mod.skip_payload(r, 100, chunk=7)
        return ok, await mod.read_frame(r), await mod.skip_payload(_reader(b"x"), 5)

    assert asyncio.run(go(wire)) == asyncio.run(go(jwire)) == (True, ({"t": "next", "len": 2},
                                                                       b"ab"), False)


# ---------------------------------------------------------------------------
# Prometheus text.
# ---------------------------------------------------------------------------


def _feed(m):
    rng = np.random.default_rng(7)
    for i in range(40):
        m.counter("serve_requests", mode=str(rng.choice(["ctr", "cbc"])))
        m.counter("serve_transfer_bytes", int(rng.integers(1, 1 << 40)), mode="ctr")
        m.gauge("serve_queue_depth", int(rng.integers(0, 9)))
        m.gauge("serve_ratio", float(rng.random()))
        m.observe("serve_stage_us", float(rng.integers(0, 1 << 20)), stage="device",
                  exemplar={"span": f"s{i}", "trace": "run-1", "lane": 0})
        m.observe("serve_transfer_us", float(rng.random() * 1e6))
    m.counter("serve_auth_failed", mode="gcm-open")


@pytest.mark.parametrize("exemplars", [False, True])
def test_render_prometheus_equals_reference(monkeypatch, exemplars):
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)
    metrics.reset()
    jmetrics.reset_for_tests()
    _feed(metrics)
    _feed(jmetrics)
    got = metrics.render_prometheus(exemplars=exemplars)
    assert got == jmetrics.render_prometheus(exemplars=exemplars)
    assert "serve_transfer_bytes_total" in got and "serve_auth_failed_total" in got
    assert ("# {" in got) == exemplars
    metrics.reset()
    jmetrics.reset_for_tests()


# ---------------------------------------------------------------------------
# The incident recorder.
# ---------------------------------------------------------------------------


@pytest.fixture
def traced(tmp_path, monkeypatch):
    monkeypatch.setenv("OT_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("OT_TRACE_RUN", "incident-run")
    incident.reset_for_tests()
    yield tmp_path / "incident-run"
    incident.reset_for_tests()


def test_auth_spike_threshold_like_reference(traced, monkeypatch):
    monkeypatch.setenv("OT_INCIDENT_AUTH_SPIKE", "3")
    assert incident.note_auth_failure() is None
    assert incident.note_auth_failure() is None
    path = incident.note_auth_failure()  # the third within the window
    assert path is not None
    doc = incident.load_bundle(path)
    assert doc["reason"] == "auth-spike" and doc["attrs"]["failures"] == 3
    assert jincident.validate_bundle(doc) == [] == incident.validate_bundle(doc)
    # A fourth inside the cooldown is suppressed, not a second bundle.
    assert incident.note_auth_failure() is None
    assert incident.counts()["suppressed"] == 1
    assert [b["reason"] for b in incident.bundle_index(str(traced))] == ["auth-spike"]


def test_incident_bundles_pass_reference_schema(traced, monkeypatch):
    monkeypatch.setenv("OT_INCIDENT_COOLDOWN_S", "0")
    incident.set_cost_records([{"rung": 32, "mode": "ctr"}])
    incident.record(lane=0, rung=32, engine="cuda", mode="ctr", outcome="timeout",
                    device_us=0, wall_us=9, batch="b")
    paths = [incident.trigger(r, lane=0) for r in ("watchdog-kill", "quarantine")]
    for p in paths:
        doc = jincident.load_bundle(p)
        assert jincident.validate_bundle(doc) == []
        assert doc["ring"][0]["outcome"] == "timeout" and doc["cost"][0]["rung"] == 32
    assert [b["file"] for b in jincident.bundle_index(str(traced))] == \
        [b["file"] for b in incident.bundle_index(str(traced))]
    assert incident.REASONS == jincident.REASONS
    assert incident.REQUIRED_KEYS == jincident.REQUIRED_KEYS


def test_incident_off_without_tracing():
    incident.reset_for_tests()
    incident.record(lane=0, outcome="ok")
    assert incident.trigger("quarantine") is None
    assert incident.counts() == {"dumped": 0, "suppressed": 0, "ring": 1}
    incident.reset_for_tests()


# ---------------------------------------------------------------------------
# The front ends, the port's against the JAX package's.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fronts():
    """(loop, server, frontend) for the port's server and the JAX one."""
    old = os.environ.get("OT_PULSE")
    os.environ["OT_PULSE"] = "0"  # the JAX endpoint's /healthz without a pulse engine
    out = {}
    for name, srv in (("port", Server(ServerConfig(device="cpu", **CFG))),
                      ("jax", JServer(JServerConfig(engine="jnp", **CFG)))):
        loop = asyncio.new_event_loop()
        loop.run_until_complete(srv.start())
        front = (RequestFrontend if name == "port" else JFrontend)(srv, 0)
        loop.run_until_complete(front.start())
        out[name] = (loop, srv, front)
    yield out
    for loop, srv, front in out.values():
        loop.run_until_complete(front.stop())
        loop.run_until_complete(srv.stop())
        loop.close()
    if old is None:
        os.environ.pop("OT_PULSE", None)
    else:
        os.environ["OT_PULSE"] = old


def _frames(blob: bytes) -> list:
    """Parse answer frames, the masked keys dropped."""
    out, pos = [], 0
    while pos < len(blob):
        nl = blob.index(b"\n", pos)
        h = json.loads(blob[pos:nl])
        n = int(h["len"])
        body = blob[nl + 1:nl + 1 + n]
        pos = nl + 1 + n
        out.append(({k: v for k, v in h.items() if k not in MASKED}, body))
    return out


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def write(self, b):
        self.buf += b

    async def drain(self):
        await asyncio.sleep(0)

    def close(self):
        pass


async def _in_process(front, blob):
    w = _Writer()
    await asyncio.wait_for(front._serve_conn(_reader(blob), w), WAIT_S)
    return bytes(w.buf)


async def _loopback(front, blob):
    r, w = await asyncio.open_connection("127.0.0.1", front.port)
    try:
        w.write(blob)
        await w.drain()
        w.write_eof()
        return await asyncio.wait_for(r.read(), WAIT_S)
    finally:
        w.close()


def _req(mode, key, payload, nonce=b"", iv=b"", aad=b"", tag=b"", **extra):
    h = {"t": "tenant", "k": key.hex(), "m": mode, **extra}
    if nonce:
        h["n"] = nonce.hex()
    if iv:
        h["iv"] = iv.hex()
    if aad:
        h["a"] = aad.hex()
    if tag:
        h["tg"] = tag.hex()
    return wire.encode_frame(h, bytes(payload))


def _tx(mode, key, payload, tid, nonce=b"", iv=b"", skip=(), total=None, order=None):
    """A ``tx`` exchange's client frames: begin, then every chunk not in
    ``skip`` (in ``order`` when given)."""
    h = {"tx": "begin", "t": "tenant", "k": key.hex(), "m": mode, "tid": tid,
         "total": len(payload) if total is None else total}
    if nonce:
        h["n"] = nonce.hex()
    if iv:
        h["iv"] = iv.hex()
    step = CHUNK * 16
    idx = [i for i in range(-(-len(payload) // step)) if i not in skip]
    return wire.encode_frame(h) + b"".join(
        wire.encode_frame({"tx": "chunk", "i": i}, bytes(payload[i * step:(i + 1) * step]))
        for i in (order or idx))


def _sequences():
    rng = np.random.default_rng(99)
    key = rng.bytes(16)
    seqs = {}
    one = b""
    for size in (16, 512, 1008):
        pt = rng.integers(0, 256, size, dtype=np.uint8)
        iv12, aad = rng.bytes(12), rng.bytes(int(rng.integers(0, 30)))
        ct, tag = ghash.np_gcm_seal(key, iv12, aad, pt.tobytes())
        bad = bytes([tag[0] ^ 1]) + tag[1:]
        one += (_req("ctr", key, pt, nonce=rng.bytes(16)) + _req("cbc", key, pt, iv=rng.bytes(16))
                + _req("gcm", key, pt, iv=iv12, aad=aad)
                + _req("gcm-open", key, ct, iv=iv12, aad=aad, tag=tag)
                + _req("gcm-open", key, ct, iv=iv12, aad=aad, tag=bad))
    one += _req("ctr", key, b"\x00" * 15, nonce=rng.bytes(16))          # not a block multiple
    one += _req("rc4", key, b"\x00" * 16)                               # not enabled
    one += _req("ctr", key, b"\x00" * 16, nonce=rng.bytes(16), deadline_s="soon")
    one += _req("ctr", rng.bytes(16), rng.integers(0, 256, 16 * 3 * CHUNK + 32, dtype=np.uint8),
                nonce=rng.bytes(16))                                   # transferred
    one += _req("gcm", key, b"\x00" * 16 * CHUNK, iv=rng.bytes(12))     # transfer-unsupported
    seqs["one-frame"] = one
    big = rng.integers(0, 256, 16 * 3 * CHUNK + 48, dtype=np.uint8)
    seqs["tx"] = (_tx("ctr", key, big, "tx-ctr", nonce=b"\xff" * 16, order=[3, 0, 2, 1])
                  + _tx("cbc", rng.bytes(16), big, "tx-cbc", iv=rng.bytes(16))
                  + _req("ctr", key, b"\x01" * 32, nonce=rng.bytes(16)))
    seqs["tx-refusals"] = b"".join([
        _tx("gcm", key, big, "r1", iv=rng.bytes(12)),
        _tx("ctr", key, big, "r2", nonce=rng.bytes(16), total=40),
        _tx("ctr", key, big, "r3", nonce=rng.bytes(16), total=1 << 30),
        wire.encode_frame({"tx": "chunk", "i": 0}, b"\x00" * 16),
        wire.encode_frame({"tx": "begin", "t": "t", "k": key.hex(), "n": "00" * 16,
                           "total": 16 * 2 * CHUNK, "tid": "r4"})
        + wire.encode_frame({"tx": "chunk", "i": 0}, b"\x00" * 16),
    ])
    seqs["tx-malformed"] = wire.encode_frame({"tx": "begin", "t": "t", "total": "many"})
    frames = [({"ss": "open", "t": "t", "sid": sid, "k": key.hex()}, b"")
              for sid, key in SESSION_KEYS.items()]
    for i in range(3):  # the two sessions' chunks interleaved
        for sid, sizes in SESSION_CHUNKS.items():
            if i < len(sizes):
                frames.append(({"ss": "data", "t": "t", "sid": sid},
                               bytes(range(sid, sid + sizes[i])) if sizes[i] <= 250
                               else rng.bytes(sizes[i])))
    frames += [({"ss": "close", "t": "t", "sid": 1}, b""),
               ({"ss": "data", "t": "t", "sid": 1}, b"\x00" * 32),   # closed
               ({"ss": "open", "t": "t", "sid": "x"}, b""),
               ({"ss": "rewind", "t": "t", "sid": 2}, b""),
               ({"ss": "data", "t": "t", "sid": 2}, b"\x00" * 15),   # not a block multiple
               ({"ss": "close", "t": "t", "sid": 2}, b"")]
    seqs["session"] = b"".join(wire.encode_frame(h, p) for h, p in frames)
    seqs["garbage"] = _req("ctr", key, b"\x02" * 16, nonce=b"\x00" * 16) + b"not json\n" + \
        _req("ctr", key, b"\x02" * 16, nonce=b"\x00" * 16)
    return seqs


SEQUENCES = _sequences()


def _answer_both(fronts, blob, how):
    out = {}
    for name, (loop, _srv, front) in fronts.items():
        run = _in_process if how == "in-process" else _loopback
        out[name] = _frames(loop.run_until_complete(run(front, blob)))
    return out["port"], out["jax"]


@pytest.mark.parametrize("how", ["in-process", "loopback"])
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_frontend_answers_equal_reference(fronts, seq, how):
    got, want = _answer_both(fronts, SEQUENCES[seq], how)
    assert got == want
    assert got, "no answer frames"
    if seq == "session":
        # Each session's chunks against the host PRGA, in stream order.
        sent = _frames(SEQUENCES[seq])
        states = {sid: (0, 0, arc4.key_schedule(k)) for sid, k in SESSION_KEYS.items()}
        datas = [(h, b, ans) for (h, b), ans in zip(sent, got) if h["ss"] == "data"]
        assert sum(ans[0]["ok"] for _h, _b, ans in datas) == sum(map(len,
                                                                   SESSION_CHUNKS.values()))
        for h, body, (ans, out) in datas:
            if ans["ok"]:
                ks, states[h["sid"]] = arc4.keystream_np(states[h["sid"]], len(body))
                assert out == bytes(np.frombuffer(body, np.uint8) ^ ks)
            else:
                assert ans["error"] == "bad-request" and out == b""


def test_frontend_answers_are_right(fronts):
    """The one-frame sequence's answers against the host references."""
    loop, _srv, front = fronts["port"]
    got = _frames(loop.run_until_complete(_in_process(front, SEQUENCES["one-frame"])))
    rng = np.random.default_rng(99)
    key = rng.bytes(16)
    i = 0
    for size in (16, 512, 1008):
        pt = rng.integers(0, 256, size, dtype=np.uint8)
        iv12, aad = rng.bytes(12), rng.bytes(int(rng.integers(0, 30)))
        ct, tag = ghash.np_gcm_seal(key, iv12, aad, pt.tobytes())
        nonce, iv16 = rng.bytes(16), rng.bytes(16)
        ref = AES(key, device="cpu")
        ctr = ref.crypt_ctr(0, np.frombuffer(nonce, np.uint8), np.zeros(16, np.uint8), pt)[0]
        cbc = ref.crypt_cbc(AES_DECRYPT, np.frombuffer(iv16, np.uint8), pt)[0]
        assert got[i][1] == np.asarray(ctr).tobytes()
        assert got[i + 1][1] == np.asarray(cbc).tobytes()
        assert got[i + 2][1] == ct and got[i + 2][0]["tg"] == tag.hex()
        assert got[i + 3][1] == pt.tobytes() and got[i + 3][0]["ok"]
        assert got[i + 4][0]["error"] == "auth-failed" and got[i + 4][1] == b""
        i += 5
    assert [h.get("error") for h, _ in got[i:]] == [
        "bad-request", "bad-request", "bad-request", None, "transfer-unsupported"]


def _resume(front, loop, payload, key, nonce):
    step = CHUNK * 16
    chunks = -(-len(payload) // step)

    async def go():
        f1 = _frames(await _loopback(front, _tx("ctr", key, payload, "resume", nonce=nonce)))
        acked = sorted(h["i"] for h, _ in f1 if h.get("tx") == "out")
        f2 = _frames(await _loopback(front, _tx("ctr", key, payload, "resume", nonce=nonce,
                                                skip=set(acked))))
        return f1, f2

    faults.reset()
    jfaults.reset()
    os.environ["OT_FAULTS"] = f"transfer_abort:1@chunk={chunks - 1}"
    try:
        faults.reset()
        jfaults.reset()
        return loop.run_until_complete(go())
    finally:
        del os.environ["OT_FAULTS"]
        faults.reset()
        jfaults.reset()


def test_frontend_tx_resume_matches_reference(fronts):
    rng = np.random.default_rng(5)
    key, nonce = rng.bytes(16), rng.bytes(16)
    payload = rng.integers(0, 256, 16 * 5 * CHUNK, dtype=np.uint8)
    runs = {name: _resume(front, loop, payload, key, nonce)
            for name, (loop, _srv, front) in fronts.items()}
    assert runs["port"] == runs["jax"]
    f1, f2 = runs["port"]
    assert f1[-1][0]["error"] == "transfer-abort" and f1[-1][0]["tid"] == "resume"
    acked = [h["i"] for h, _ in f1 if h.get("tx") == "out"]
    assert 0 < len(acked) < 5 and f2[0][0]["acked"] == acked
    assert f2[-1][0]["ok"] and f2[-1][0]["transfer"]["sent"] == 5 - len(acked)
    spliced = b"".join(b for h, b in f1 + f2 if h.get("tx") == "out")
    want = AES(key, device="cpu").crypt_ctr(0, np.frombuffer(nonce, np.uint8),
                                            np.zeros(16, np.uint8), payload)[0]
    assert spliced == np.asarray(want).tobytes()


def test_frontend_oversized_frame_keeps_connection(fronts):
    """A drainable oversized frame answers too-large and the connection
    serves the next frame; an undrainable one answers and closes."""
    key = b"\x07" * 16
    for drainable in (True, False):
        answers = []
        for loop, _srv, front in fronts.values():
            declared = front._max_len + 16 if drainable else 8 * front._max_len
            blob = json.dumps({"t": "t", "len": declared}).encode() + b"\n"
            if drainable:
                blob += b"\x00" * declared
            blob += _req("ctr", key, b"\x00" * 16, nonce=b"\x00" * 16)
            answers.append(_frames(loop.run_until_complete(_loopback(front, blob))))
        assert answers[0] == answers[1]
        assert answers[0][0][0]["error"] == "too-large"
        assert len(answers[0]) == (2 if drainable else 1)


# ---------------------------------------------------------------------------
# The status endpoint.
# ---------------------------------------------------------------------------


async def _get(port, path, accept=""):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    try:
        extra = f"Accept: {accept}\r\n" if accept else ""
        w.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n{extra}\r\n".encode())
        await w.drain()
        raw = await asyncio.wait_for(r.read(), WAIT_S)
    finally:
        w.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), head.decode("latin-1"), body.decode()


def _get_both(fronts, path, accept=""):
    return {name: loop.run_until_complete(_get(srv.status.port, path, accept))
            for name, (loop, srv, _f) in fronts.items()}


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("keycache", "queue"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_healthz_keys_match_reference(fronts):
    got = _get_both(fronts, "/healthz")
    port, ref = (json.loads(got[n][2]) for n in ("port", "jax"))
    assert got["port"][0] == got["jax"][0] == 200
    drop = {"lanes.states.0"}
    assert _keys(port) - drop == _keys(ref) - drop
    assert port["status"] == "ok" and port["compiles"]["steady"] == 0
    assert set(port["transfers"]) == set(ref["transfers"])


def test_incidentz_equal_and_alertz_fleetz_404(fronts):
    incident.reset_for_tests()
    jincident.reset_for_tests()
    got = _get_both(fronts, "/incidentz")
    port, ref = (json.loads(got[n][2]) for n in ("port", "jax"))
    assert {k: v for k, v in port.items() if k != "ring"} == \
        {k: v for k, v in ref.items() if k != "ring"}
    assert set(port) == set(ref)
    for path in ("/alertz", "/fleetz", "/nope"):
        got = _get_both(fronts, path)
        assert got["port"][0] == got["jax"][0] == 404
        assert got["port"][2] == got["jax"][2]


def test_incidentz_builds_off_the_loop(fronts, monkeypatch, tmp_path):
    seen = {}
    real = incident.bundle_index

    def spy(run_dir):
        seen["thread"] = threading.current_thread()
        return real(run_dir)

    monkeypatch.setenv("OT_TRACE_DIR", str(tmp_path))
    # A run id of the test's own, taken away again at teardown.
    monkeypatch.setenv("OT_TRACE_RUN", "incidentz-off-the-loop")
    monkeypatch.setattr(incident, "bundle_index", spy)
    loop, srv, _front = fronts["port"]
    code, _, _ = loop.run_until_complete(_get(srv.status.port, "/incidentz"))
    assert code == 200 and seen["thread"] is not threading.main_thread()


def test_metrics_endpoint_renders_registry(fronts):
    loop, srv, _front = fronts["port"]
    code, head, body = loop.run_until_complete(_get(srv.status.port, "/metrics"))
    assert code == 200 and "version=0.0.4" in head
    assert "# TYPE serve_requests_total counter" in body and "# {" not in body
    code, head, body = loop.run_until_complete(
        _get(srv.status.port, "/metrics", accept="application/openmetrics-text"))
    assert "openmetrics" in head and body.endswith("# EOF\n")


def test_profilez_without_tracing_answers_503(fronts):
    got = _get_both(fronts, "/profilez?seconds=0.1")
    assert got["port"][0] == got["jax"][0] == 503


# ---------------------------------------------------------------------------
# The worker process.
# ---------------------------------------------------------------------------


def _line(proc):
    """One stdout line, waited for at most WAIT_S."""
    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()), daemon=True)
    t.start()
    t.join(WAIT_S)
    if not out or not out[0]:
        proc.kill()
        raise AssertionError(f"no line from the worker: {proc.stderr.read()[-2000:]}")
    return json.loads(out[0])


def test_worker_process_on_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("OT_")}
    proc = subprocess.Popen([sys.executable, "-m", "our_tree_tpu_torch.serve.worker",
                             "--device", "cpu", "--engine", "bitslice", "--port", "0",
                             "--status-port", "0"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ready = _line(proc)
        assert ready["kind"] == "ot-serve-worker" and ready["engine"] == "bitslice"
        assert set(ready) == {"kind", "port", "status_port", "engine", "lanes", "pid"}
        key, nonce, pt = b"\x11" * 16, b"\x22" * 16, bytes(range(48))

        async def one():
            r, w = await asyncio.open_connection("127.0.0.1", ready["port"])
            w.write(_req("ctr", key, pt, nonce=nonce))
            await w.drain()
            frame = await asyncio.wait_for(wire.read_frame(r), WAIT_S)
            w.close()
            return frame

        h, body = asyncio.run(one())
        want = AES(key, device="cpu").crypt_ctr(0, np.frombuffer(nonce, np.uint8),
                                                np.zeros(16, np.uint8),
                                                np.frombuffer(pt, np.uint8))[0]
        assert h["ok"] and body == np.asarray(want).tobytes()
        proc.send_signal(signal.SIGTERM)
        exit_line = _line(proc)
        assert proc.wait(WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert exit_line["kind"] == "ot-serve-worker-exit" and exit_line["lost"] == 0
    assert exit_line["answered"] == exit_line["accepted"] == 1


@pytest.mark.parametrize("argv", [["--journal", "j.jsonl"], ["--native-threads", "4"],
                                  ["--session-per-tenant", "16"],
                                  ["--session-budget-bytes", "1024"]])
def test_worker_refuses_what_the_port_lacks(argv):
    """``--journal`` and the ``--session-*`` options, ported with the lanes'
    journal and the rc4 sessions, and ``--native-threads``, ported with the
    native serve engine, reach the server's config: the worker refuses none
    of them now."""
    from our_tree_tpu_torch.serve import worker

    cfg = worker.server_config(worker.parse_args(["--device", "cpu", "--modes", "ctr,rc4",
                                                   *argv]))
    field = argv[0][2:].replace("-", "_")
    assert str(getattr(cfg, field)) == argv[1] and cfg.modes == ("ctr", "rc4")
    # The JAX server's defaults for the options not given.
    defaults = JServerConfig()
    for name in ("journal", "session_per_tenant", "session_window_bytes",
                 "session_quantum_bytes", "session_prefetch_slots", "session_budget_bytes"):
        if name != field:
            assert getattr(cfg, name) == getattr(defaults, name), name


def test_frontend_stop_ends_with_an_idle_connection_open():
    """A router keeps idle pooled connections to its workers: the frontend's
    drain cancels them after its grace and ends (awaiting the listener's
    ``wait_closed`` first would wait on them for good on Python 3.12)."""

    async def main():
        server = Server(ServerConfig(device="cpu", lanes=1, min_bucket_blocks=32,
                                     max_bucket_blocks=64))
        await server.start()
        front = RequestFrontend(server, 0)
        await front.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", front.port)
        writer.write(wire.encode_frame({"t": "t0", "k": (b"\x01" * 16).hex(),
                                        "n": (b"\x02" * 16).hex()}, b"\x00" * 64))
        await writer.drain()
        h, body = await wire.read_frame(reader)
        assert h["ok"] and len(body) == 64
        server.queue.close()
        t0 = time.monotonic()
        await asyncio.wait_for(front.stop(grace_s=0.2), timeout=WAIT_S)
        stopped_s = time.monotonic() - t0
        assert await reader.read(16) == b""  # the idle connection was closed
        writer.close()
        await server.stop()
        return stopped_s

    assert asyncio.run(main()) < 5.0
