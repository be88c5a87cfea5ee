"""The native serve engine of the port (``engine="native"``: ``ctr`` in C on
the host, the other modes on the lane device's ``auto`` engine) against the
JAX package's native-tier server on the CPU: one script of ``ctr``,
``cbc``, ``gcm``, ``gcm-open`` and ``rc4`` session requests through both
servers gives the same answers and codes. Then the pieces: the per-request
C CTR (``native_runs``) against the counter-array path and the plain
engine, across a 128-bit counter wrap; the batcher's ``counters=False``
layout; the keycache's memoized ``native_ctxs``; ``resolve_serve_engine``'s
rules; the worker taking ``--native-threads``; the bench CLI with ``--engine
native``. Integer cryptography: the tolerance is exact (bytes)."""

import asyncio
import contextlib
import io
import json

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
from our_tree_tpu_torch.ops.keyschedule import expand_key_enc
from our_tree_tpu_torch.resilience import degrade
from our_tree_tpu_torch.runtime import native
from our_tree_tpu_torch.serve import batcher, keycache
from our_tree_tpu_torch.serve import bench as serve_bench
from our_tree_tpu_torch.serve import queue as otq
from our_tree_tpu_torch.serve import worker
from our_tree_tpu_torch.serve.server import Server, ServerConfig
from our_tree_tpu_torch.utils import packing

CFG = dict(min_bucket_blocks=32, max_bucket_blocks=64, lanes=1, transfer_chunk_blocks=0,
           session_quantum_bytes=2048, session_prefetch_slots=2, session_window_bytes=4096)
MODES = ("ctr", "cbc", "gcm", "gcm-open", "rc4")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("OT_DISPATCH_DEADLINE", raising=False)
    monkeypatch.delenv("OT_TRACE_DIR", raising=False)
    monkeypatch.delenv("OT_FAULTS", raising=False)
    degrade.clear()
    jdegrade.clear()
    yield
    degrade.clear()
    jdegrade.clear()


def _script(seed=17):
    """Sequential steps of concurrent calls: the rc4 sessions open first,
    then rounds of every mode at once (one chunk of a session at a time, in
    its prefilled window), a tampered open, refusals, then the closes."""
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(int(rng.choice((16, 24, 32)))) for _ in range(4)]
    keys = [k for k in keys if len(k) == 16] + [rng.bytes(16)] * 2
    steps = [[("open", ("t0", sid, rng.bytes(16))) for sid in (1, 2)]]
    for _ in range(3):
        step = []
        for i in range(6):
            key, nonce = keys[i % 2], rng.bytes(16)
            data = rng.integers(0, 256, 16 * int(rng.integers(1, 70)), dtype=np.uint8)
            step.append(("submit", (f"t{i % 3}", key, nonce, data), {}))
            step.append(("submit", (f"t{i % 3}", key, b"", data), {"mode": "cbc",
                                                                   "iv": rng.bytes(16)}))
            step.append(("submit", (f"t{i % 3}", key, b"", data), {"mode": "gcm",
                                                                   "iv": rng.bytes(12),
                                                                   "aad": rng.bytes(i)}))
        for sid in (1, 2):
            step.append(("submit", ("t0", b"", b"", rng.integers(
                0, 256, 16 * int(rng.integers(1, 20)), dtype=np.uint8)), {"mode": "rc4",
                                                                         "sid": sid}))
        steps.append(step)
    steps.append([("submit", ("t0", keys[0], rng.bytes(16), np.zeros(65 * 16, np.uint8)), {}),
                  ("submit", ("t0", keys[0], b"", np.zeros(15, np.uint8)), {"mode": "cbc",
                                                                          "iv": bytes(16)}),
                  ("submit", ("t0", b"", b"", np.zeros(32, np.uint8)), {"mode": "rc4",
                                                                       "sid": 9})])
    steps.append([("close", ("t0", sid)) for sid in (1, 2)])
    return steps


async def _drive(server, steps):
    await server.start()
    try:
        out = []
        for si, step in enumerate(steps):
            calls = []
            for kind, args, *kw in step:
                if kind == "open":
                    calls.append(server.open_session(*args))
                elif kind == "close":
                    calls.append(server.close_session(*args))
                else:
                    calls.append(server.submit(*args, **kw[0]))
            answers = await asyncio.gather(*calls)
            out += answers
            # Open each round's seals, one of them tampered.
            opens = []
            for j, ((kind, args, *kw), r) in enumerate(zip(step, answers)):
                if kind == "submit" and kw[0].get("mode") == "gcm" and r.ok:
                    ct = np.asarray(r.payload).copy()
                    if j == 2 and si == 1:
                        ct[0] ^= 1
                    opens.append(server.submit(args[0], args[1], b"", ct, mode="gcm-open",
                                               iv=kw[0]["iv"], aad=kw[0]["aad"], tag=r.tag))
            out += await asyncio.gather(*opens)
        return out, server.stats()
    finally:
        await server.stop()


def _answer(r):
    return (r.ok, r.error, None if r.payload is None else np.asarray(r.payload).tobytes(), r.tag)


def test_native_tier_server_matches_the_jax_native_tier_server():
    steps = _script()
    want, _ = asyncio.run(_drive(JServer(JServerConfig(engine="native", modes=MODES, **CFG)),
                                 steps))
    server = Server(ServerConfig(device="cpu", engine="native", native_threads=2, modes=MODES,
                                 **CFG))
    got, stats = asyncio.run(_drive(server, steps))
    assert server.engine == aes.NATIVE_ENGINE
    assert [_answer(r) for r in got] == [_answer(r) for r in want]
    codes = [r.error for r in got]
    assert codes.count(otq.ERR_AUTH) == 1 and codes.count(None) > 60
    assert otq.ERR_TOO_LARGE in codes and otq.ERR_BAD_REQUEST in codes
    calls = stats["lanes"]["engine_calls_by_mode"]
    assert all(calls[m] > len(server.rungs) for m in ("ctr", "cbc", "gcm", "gcm-open"))
    assert stats["queue"]["lost"] == 0 and stats["compiles"]["steady"] == 0


def test_auto_on_the_cpu_is_the_native_tier_and_matches_bitslice():
    """``auto`` on the CPU serves on the native tier; a ``ctr``-only script
    through it and through a server pinned to the plain engine answers the
    same."""
    steps = [[s for s in step if s[0] == "submit" and not s[2]] for step in _script(5)[1:4]]

    def run(engine):
        cfg = {k: v for k, v in CFG.items() if not k.startswith("session")}
        server = Server(ServerConfig(device="cpu", engine=engine, **cfg))
        out, stats = asyncio.run(_drive(server, steps))
        return server, out, stats

    s_auto, got, stats = run("auto")
    s_plain, want, _ = run(aes.PLAIN_ENGINE)
    assert s_auto.engine == aes.NATIVE_ENGINE and s_plain.engine == aes.PLAIN_ENGINE
    assert [_answer(r) for r in got] == [_answer(r) for r in want]
    assert sum(r.ok for r in got) > 10
    # The native ctr path makes no first seam call: nothing to warm.
    assert stats["compiles"] == {"warmup": 0, "steady": 0}


def test_native_runs_path_matches_counter_array_path():
    """The per-request C CTR (counters made in C from each request's nonce)
    equals the counter-array path and the plain engine, across a 128-bit
    counter wrap; the kind of the input (numpy or a CPU tensor) is the kind
    of the output."""
    rng = np.random.default_rng(3)
    rks = np.stack([expand_key_enc(bytes([i]) * 16)[1] for i in (5, 6)])
    nr = 10
    ctxs = [native.aes_ctx_from_schedule(nr, r) for r in rks]
    nonces = [((1 << 128) - 3).to_bytes(16, "big"), rng.bytes(16), rng.bytes(16)]
    runs = [(0, 0, 7, nonces[0]), (0, 7, 3, nonces[1]), (1, 10, 5, nonces[2])]
    n = 15
    words = packing.np_bytes_to_words(rng.integers(0, 256, 16 * n, dtype=np.uint8))
    ctr = np.empty((n, 4), np.uint32)
    for _s, start, nb, nc in runs:
        packing.np_ctr_le_blocks(nc, np.arange(nb, dtype=np.uint32), out=ctr[start:start + nb])
    sv = np.zeros(n, np.uint32)
    sv[10:] = 1
    via_array = aes.ctr_crypt_words_scattered_multikey(
        words, ctr.reshape(-1), rks, sv, nr, "native", native_ctxs=ctxs)
    via_runs = aes.ctr_crypt_words_scattered_multikey(
        words, None, rks, None, nr, "native", native_ctxs=ctxs, native_runs=runs,
        native_threads=2)
    t = lambda a: packing.words_tensor(np.asarray(a, np.uint32), "cpu")  # noqa: E731
    via_plain = aes.ctr_crypt_words_scattered_multikey(
        t(words), t(ctr.reshape(-1)), t(rks), t(sv), nr, aes.PLAIN_ENGINE)
    via_tensor = aes.ctr_crypt_words_scattered_multikey(
        t(words), t(ctr.reshape(-1)), t(rks), t(sv), nr, "native")
    assert isinstance(via_runs, np.ndarray) and via_runs.dtype == np.uint32
    np.testing.assert_array_equal(via_array.reshape(-1), via_runs.reshape(-1))
    np.testing.assert_array_equal(via_array.reshape(-1), via_plain.numpy().view(np.uint32))
    assert isinstance(via_tensor, torch.Tensor) and torch.equal(via_tensor, via_plain)
    with pytest.raises(ValueError, match="host arrays"):
        aes.ctr_crypt_words_scattered_multikey(t(words).to("meta"), None, rks, None, nr,
                                               "native", native_runs=runs)


def test_batcher_without_counters_keeps_the_request_layout():
    """``counters=False`` builds the payload words and ``runs`` only, as the
    JAX batcher's does; the runs give the counter array's bytes through the
    C tier."""
    rng = np.random.default_rng(8)
    specs = [(f"t{i % 2}", bytes([i % 3]) * 16, rng.bytes(16),
              rng.integers(0, 256, 16 * int(rng.integers(1, 40)), dtype=np.uint8))
             for i in range(9)]
    mine = [otq.Request(id=i, tenant=t, key=k, nonce=n, payload=p, future=None)
            for i, (t, k, n, p) in enumerate(specs)]
    ref = [jqueue.Request(id=i, tenant=t, key=k, nonce=n, payload=p, future=None)
           for i, (t, k, n, p) in enumerate(specs)]
    rungs = batcher.bucket_ladder(32, 64)
    kc = keycache.KeyCache()
    got_b = batcher.form_batches(mine, rungs, keycache.key_digest, 4)
    want_b = jbatcher.form_batches(ref, rungs, jkeycache.key_digest, 4)
    assert len(got_b) == len(want_b) > 1
    for b, w in zip(got_b, want_b):
        full = batcher.Batch(b.slots, b.bucket, b.blocks, b.nr, b.key_slots, b.mode)
        full.materialise()
        b.materialise(counters=False)
        w.materialise(counters=False)
        assert b.ctr_words is None and b.slot_index is None
        assert b.runs == w.runs and full.runs is None and b.req_spans == full.req_spans
        np.testing.assert_array_equal(b.words, w.words)
        np.testing.assert_array_equal(b.words, full.words)
        sched = kc.stacked(b.keys, b.key_slots)
        got = aes.ctr_crypt_words_scattered_multikey(
            b.words, None, sched.rks, None, sched.nr, "native",
            native_ctxs=sched.native_ctxs(), native_runs=b.runs)
        want = aes.ctr_crypt_words_scattered_multikey(
            full.words, full.ctr_words, sched.rks, full.slot_index, sched.nr, "native")
        for off, n in b.req_spans:
            np.testing.assert_array_equal(got[4 * off:4 * (off + n)], want[4 * off:4 * (off + n)])


def test_keycache_native_ctxs_are_built_once_per_stack(monkeypatch):
    kc = keycache.KeyCache()
    built = []
    real = native.aes_ctx_from_schedule
    monkeypatch.setattr(native, "aes_ctx_from_schedule",
                        lambda nr, row: built.append(nr) or real(nr, row))
    slots = [("a", bytes(16)), ("b", bytes(range(16)))]
    sched = kc.stacked(slots, 4)
    assert sched._native_ctxs is None and built == []  # lazy
    ctxs = sched.native_ctxs()
    assert len(ctxs) == 4 and built == [10] * 4
    assert sched.native_ctxs() is ctxs
    assert kc.stacked(slots, 4).native_ctxs() is ctxs and built == [10] * 4  # memoized stack
    ctx = native.NativeAES(bytes(range(16)))
    assert bytes(ctxs[1].rk)[:16 * 11] == bytes(ctx.ctx.rk)[:16 * 11]


def test_resolve_serve_engine_rules(monkeypatch):
    assert aes.resolve_serve_engine("native", "cpu") == aes.NATIVE_ENGINE
    assert aes.resolve_serve_engine("auto", "cpu") == aes.NATIVE_ENGINE
    assert aes.resolve_serve_engine("ttable", "cpu") == aes.TTABLE_ENGINE
    monkeypatch.setattr(aes, "_NATIVE_OK", False)
    assert aes.resolve_serve_engine("auto", "cpu") == aes.PLAIN_ENGINE
    assert degrade.events() == ["native->bitslice"]
    with pytest.raises(RuntimeError, match="native C runtime failed"):
        aes.resolve_serve_engine("native", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aes.resolve_serve_engine("native")


def test_native_runtime_available_is_memoized(monkeypatch):
    monkeypatch.setattr(aes, "_NATIVE_OK", None)
    calls = []
    monkeypatch.setattr(native, "load", lambda: calls.append(1) or (_ for _ in ()).throw(
        OSError("no cc")))
    assert aes.native_runtime_available() is False and aes.native_runtime_available() is False
    assert calls == [1]


def test_worker_takes_native_threads():
    cfg = worker.server_config(worker.parse_args(["--device", "cpu", "--engine", "native",
                                                  "--native-threads", "3"]))
    assert cfg.native_threads == 3 and cfg.engine == "native"
    assert JServerConfig().native_threads == ServerConfig().native_threads == 0


def test_bench_cli_with_the_native_engine():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_bench.main(["--device", "cpu", "--engine", "native", "--native-threads", "2",
                               "--modes", "ctr,cbc", "--requests", "40", "--sizes",
                               "16,256,1024", "--bucket-max", "256"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["engine"] == "native" and line["lost"] == 0
    assert line["mismatches"] == 0 and line["verified"] > 0 and line["errors"] == {}
    assert line["per_mode"]["engine_calls"]["ctr"] > 0 and line["launches"]["ctr_mk"] == 0
