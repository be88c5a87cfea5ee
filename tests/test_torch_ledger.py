"""The per-request time ledger of the port's server (``Response.ledger``),
held against the JAX package's: the same seeded requests through a port
server and a JAX server on the CPU.

* sampled answers carry ledgers with the same keys, ``{"stages":
  {backend_queue, pack, worker_wait, dispatch, device, reply}, "total_us"}``
  (the port's staging inside ``dispatch``), for ``ctr``, ``cbc`` and
  ``gcm`` riders and rc4 session chunks; unsampled answers carry none;
* each ledger's stages are non-negative and sum to its ``total_us`` within
  the route bench's 5 %: they are contiguous by clock;
* a worker answers ``lg`` only when the frame asked, in the request
  exchange and in the ``ss`` exchange;
* a routed run of two port workers on the CPU (``route.bench``) has
  complete waterfalls on at least 0.99 of its sampled requests and stage
  sums within 5 % on at least 0.95 of them.
"""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import route_pair as rp
from our_tree_tpu_torch.obs.metrics import WATERFALL_STAGES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The route bench's stage-sum tolerance.
TOL = 0.05
#: The backend's half of the waterfall, in order.
BACKEND_STAGES = WATERFALL_STAGES[3:]
CFG = dict(modes=("ctr", "cbc", "gcm", "rc4"), session_quantum_bytes=1024,
           session_prefetch_slots=2, session_window_bytes=2048)
SIZES = (16, 256, 1024, 2048)  # gcm spans one block more: all under the top rung


def _requests(n: int, seed: int = 7) -> list:
    """(tenant, key, nonce or IV, payload, mode, sampled) from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mode = ("ctr", "cbc", "gcm")[i % 3]
        size = int(rng.choice(SIZES))
        out.append((f"t{i % 4}", rng.bytes(16), rng.bytes(12 if mode == "gcm" else 16),
                    rng.integers(0, 256, size, np.uint8), mode, bool(i % 2)))
    return out


async def _serve(pkg, reqs) -> list:
    srv = rp.new_server(pkg, **CFG)
    await srv.start()
    try:
        async def one(t, k, n, p, mode, sm):
            if mode == "ctr":
                return await srv.submit(t, k, n, p, sampled=sm)
            return await srv.submit(t, k, b"", p, sampled=sm, mode=mode, iv=n)

        resps = await asyncio.gather(*(one(*r) for r in reqs))
        # Two rc4 session chunks, one sampled and one not.
        assert (await srv.open_session("s", 1, b"session-key")).ok
        chunks = [await srv.submit("s", b"", b"", np.zeros(64, np.uint8), sampled=sm,
                                   mode="rc4", sid=1) for sm in (True, False)]
    finally:
        await srv.stop()
    return list(resps) + chunks


def _sum_ok(ledger) -> bool:
    total = ledger["total_us"]
    return abs(sum(ledger["stages"].values()) - total) <= TOL * max(total, 1)


def test_sampled_answers_carry_the_reference_ledger_and_unsampled_none():
    reqs = _requests(24)
    jax_out, port_out = rp.run_both(lambda pkg: _serve(pkg, reqs))
    sampled = [r[5] for r in reqs] + [True, False]
    assert len(port_out) == len(jax_out) == len(sampled)
    for sm, jr, pr in zip(sampled, jax_out, port_out):
        assert pr.ok and jr.ok
        assert bytes(pr.payload) == bytes(jr.payload)
        if not sm:
            assert pr.ledger is None and jr.ledger is None
            continue
        assert rp.shape(pr.ledger) == rp.shape(jr.ledger)
        assert list(pr.ledger["stages"]) == list(BACKEND_STAGES)
        assert all(isinstance(v, int) and v >= 0 for v in pr.ledger["stages"].values())
        assert _sum_ok(pr.ledger), pr.ledger


async def _frames(pkg, frames) -> list:
    """Each (header, payload) frame through one worker front end of ``pkg``
    on its own connection; the answer headers."""
    srv = rp.new_server(pkg, **CFG)
    await srv.start()
    front = pkg.RequestFrontend(srv, 0)
    await front.start()
    out = []
    try:
        for header, payload in frames:
            reader, writer = await asyncio.open_connection("127.0.0.1", front.port)
            writer.write(pkg.wire.encode_frame(header, payload))
            await writer.drain()
            head, _body = await pkg.wire.read_frame(reader, pkg.wire.MAX_PAYLOAD)
            writer.close()
            out.append(head)
    finally:
        await front.stop(grace_s=0.5)
        await srv.stop()
    return out


def test_worker_answers_lg_only_when_asked_in_both_exchanges():
    key, nonce = bytes(range(16)), bytes(16)
    data = np.arange(256, dtype=np.uint8).tobytes()
    req = {"t": "t0", "k": key.hex(), "n": nonce.hex(), "sm": 1}
    frames = [({**req, "lg": 1}, data), (req, data), ({**req, "lg": 1, "sm": 0}, data),
              ({"ss": "open", "t": "s", "sid": 3, "k": key.hex()}, b""),
              ({"ss": "data", "t": "s", "sid": 3, "sm": 1, "lg": 1}, data[:64]),
              ({"ss": "data", "t": "s", "sid": 3, "sm": 1}, data[:64]),
              ({"ss": "close", "t": "s", "sid": 3, "lg": 1}, b"")]
    jax_out, port_out = rp.run_both(lambda pkg: _frames(pkg, frames))
    has_lg = [("lg" in h) for h in port_out]
    assert has_lg == [("lg" in h) for h in jax_out]
    assert has_lg == [True, False, False, False, True, False, False]
    assert all(h.get("ok") for h in port_out)
    for h in (port_out[0], port_out[4]):
        assert list(h["lg"]["stages"]) == list(BACKEND_STAGES) and _sum_ok(h["lg"])


def test_routed_run_of_two_port_workers_completes_its_waterfalls(tmp_path):
    art = tmp_path / "route.json"
    res = subprocess.run(
        [sys.executable, "-m", "our_tree_tpu_torch.route.bench", "--device", "cpu",
         "--backends", "2", "--requests", "120", "--sizes", "16,256,4096", "--bucket-max", "256",
         "--min-waterfall-complete", "0.99", "--min-stage-sum-ok", "0.95",
         "--artifact", str(art)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={k: v for k, v in os.environ.items() if k not in ("OT_FAULTS", "OT_TRACE_DIR")})
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["waterfall_complete_frac"] >= 0.99
    assert line["waterfall_sum_ok_frac"] >= 0.95
    assert "stage_p50_us" not in line
    wf = json.loads(art.read_text())["waterfall"]
    assert wf["sampled"] == 120 and set(wf["stages"]) == set(WATERFALL_STAGES)
    assert "# waterfall:" in res.stdout


@pytest.mark.parametrize("pkg", rp.PKGS, ids=lambda p: p.name)
def test_lanes_fill_the_timing_of_the_attempt_that_served(pkg):
    """``LanePool.dispatch(timing=...)``: the port fills ``worker_wait_us``,
    ``device_us`` and ``total_us`` as the reference does, and its own
    ``staging_us``."""
    async def run():
        srv = rp.new_server(pkg)
        await srv.start()
        timing = {}
        orig = srv.pool.dispatch

        async def spy(*a, **kw):
            out = await orig(*a, **kw)
            timing.update(kw.get("timing") or {})
            return out

        srv.pool.dispatch = spy
        try:
            resp = await srv.submit("t0", bytes(16), bytes(16), np.zeros(256, np.uint8))
        finally:
            await srv.stop()
        return resp.ok, timing

    ok, timing = asyncio.run(run())
    assert ok
    want = {"worker_wait_us", "device_us", "total_us"}
    assert want <= set(timing)
    if pkg is rp.PORT:
        assert "staging_us" in timing
    assert all(isinstance(v, int) and v >= 0 for v in timing.values())
    assert timing["total_us"] >= timing["worker_wait_us"]
