"""Closed- and open-loop load generators for the serve path.

Port of ``our_tree_tpu.serve.loadgen``, every served mode.
Closed loop (the default): ``concurrency`` clients each draw a (size, mode,
tenant, key) from a seeded generator, submit, await, repeat. Open loop
(``arrival_rate=R``): one request every 1/R seconds whatever the service
rate, latency measured from each request's scheduled arrival. ``modes`` is
the mix: each request draws its mode uniformly, so CTR, GCM seal and open
and CBC decrypt interleave in one queue. The same seed draws the same sizes,
modes, keys, nonces, IVs, AAD and probes in the same order as the JAX
loadgen. A ``gcm-open`` request replays its size's sealed probe pair
(verified or not: a made-up tag would answer ``auth-failed`` by design), so
a mix with ``gcm-open`` needs a sealed probe for every size and ``run``
refuses one without.

Correctness rides along: one pinned probe per (mode, request size) (key,
nonce or IV, and payload from the seed) is computed before the server
starts, and every ``verify_every``-th request replays a probe and checks the
bytes. The expected outputs come from the host, independent of the kernels
under test: the T-table engine (``AES(key, engine="ttable",
device="cpu")``: CTR, and ``_np_cbc_encrypt`` for the ciphertext a ``cbc``
probe decrypts back to its plaintext) and the host GCM
(``aead.ghash.np_gcm_seal``: a ``gcm`` probe pins ciphertext and tag, and
the ``gcm-open`` probe opens the sealed pair back to its plaintext). It is
the check, not a fallback.

Oversized requests (``transfer_sizes`` with ``transfer_every=N``): every
N-th request is a pinned ``ctr`` probe above the top rung
(``make_transfer_probes``), which the server serves as a chunked transfer
(``serve/transfer.py``), always verified against its single-shot reference
and tallied in ``LoadReport.transfers``.

RC4 sessions (``sessions=N``, ``session_chunks=M``): N session clients run
beside the ordinary ones, each opening its session, sending M data chunks
and closing it (``session_client``). Every chunk is verified against its
pinned script (``make_session_probes``: keys and payloads from the seed,
the expected bytes from the host PRGA ``models.arc4.keystream_np``). The
stream is stateful, so a failed chunk ends its session's script. The
chunks join the request totals and the ``rc4`` latencies;
``LoadReport.sessions`` tallies the scripts.

Percentiles are nearest-rank over the full sample, and per mode when the mix
holds more than ``ctr``; goodput counts OK payload bytes only.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import numpy as np

from ..aead import ghash as aead_ghash
from ..models.aes import AES, AES_ENCRYPT, TTABLE_ENGINE
from ..models.arc4 import key_schedule, keystream_np
from ..obs import metrics as obs_metrics

#: The mixed-size menu (bytes): one block to the default bucket ceiling.
MIXED_SIZES = (16, 64, 256, 1024, 4096, 16384, 65536)

#: The multi-tenant-heavy menu: small requests only, so a full rung comes
#: only from packing many tenants' key groups into one dispatch.
TENANT_HEAVY_SIZES = (16, 64, 256, 1024)


def percentile(sorted_vals: list[float], p: float) -> float:
    """Nearest-rank percentile (``obs.metrics.percentile_exact``)."""
    return obs_metrics.percentile_exact(sorted_vals, p)


@dataclass
class Probe:
    tenant: str
    key: bytes
    nonce: bytes
    payload: np.ndarray
    expected: np.ndarray
    #: the served mode and its request fields (``ctr`` leaves them empty);
    #: ``expected_tag`` pins a ``gcm`` probe's tag
    mode: str = "ctr"
    iv: bytes = b""
    aad: bytes = b""
    tag: bytes = b""
    expected_tag: bytes = b""


@dataclass
class LoadReport:
    requests: int = 0
    ok: int = 0
    errors: dict = field(default_factory=dict)  #: error code -> count
    verified: int = 0
    mismatches: int = 0
    wall_s: float = 0.0
    goodput_gbps: float = 0.0
    p50_ms: float = 0.0
    p95_ms: float = 0.0
    p99_ms: float = 0.0
    latencies_ms: list = field(default_factory=list, repr=False)
    #: the time ledgers of sampled responses (``Response.ledger``, which the
    #: router attaches): the population ``route.bench``'s waterfall reads
    ledgers: list = field(default_factory=list, repr=False)
    #: mode -> its requests' latencies (ms), ok count and verified probes
    by_mode: dict = field(default_factory=dict, repr=False)
    #: mode -> {requests, ok, verified, p50_ms, p95_ms, p99_ms}, set by
    #: ``finish`` when the mix holds more than ``ctr``
    modes: dict = field(default_factory=dict)
    #: the chunked transfers' tallies (requests whose Response carried a
    #: ``transfer`` section): requests, ok, chunks_sent, redispatched; empty
    #: when the drive sent none
    transfers: dict = field(default_factory=dict)
    #: the rc4 session scripts' tallies (sessions, opened, chunks, verified,
    #: closed, and open_failed, chunk_failed, mismatches when nonzero);
    #: empty when the drive ran no sessions
    sessions: dict = field(default_factory=dict)

    def finish(self, wall_s: float, ok_bytes: int) -> None:
        self.wall_s = wall_s
        self.goodput_gbps = (ok_bytes / 1e9 / wall_s) if wall_s > 0 else 0.0
        lat = sorted(self.latencies_ms)
        self.p50_ms = round(percentile(lat, 50), 3)
        self.p95_ms = round(percentile(lat, 95), 3)
        self.p99_ms = round(percentile(lat, 99), 3)
        if set(self.by_mode) - {"ctr"}:
            self.modes = {}
            for mode, m in sorted(self.by_mode.items()):
                ml = sorted(m["latencies_ms"])
                self.modes[mode] = {"requests": len(ml), "ok": m["ok"], "verified": m["verified"],
                                    "p50_ms": round(percentile(ml, 50), 3),
                                    "p95_ms": round(percentile(ml, 95), 3),
                                    "p99_ms": round(percentile(ml, 99), 3)}

    def to_json(self) -> dict:
        return {"requests": self.requests, "ok": self.ok,
                "errors": dict(sorted(self.errors.items())), "verified": self.verified,
                "mismatches": self.mismatches, "wall_s": round(self.wall_s, 3),
                "goodput_gbps": round(self.goodput_gbps, 4), "p50_ms": self.p50_ms,
                "p95_ms": self.p95_ms, "p99_ms": self.p99_ms,
                **({"transfers": dict(self.transfers)} if self.transfers else {}),
                **({"sessions": dict(self.sessions)} if self.sessions else {}),
                **({"modes": dict(self.modes)} if self.modes else {})}


def _np_cbc_encrypt(key: bytes, iv16: bytes, pt: bytes) -> bytes:
    """Host-reference CBC encrypt (the sequential direction serving does not
    offer): the T-table engine's chained encrypt on the CPU, which makes
    each ``cbc`` probe's ciphertext."""
    ref = AES(key, engine=TTABLE_ENGINE, device="cpu")
    return ref.crypt_cbc(AES_ENCRYPT, np.frombuffer(iv16, np.uint8),
                         np.frombuffer(pt, np.uint8))[0].tobytes()


def make_probes(sizes, seed: int, modes=("ctr",)) -> list[Probe]:
    """One pinned request per (mode, size) with its expected output from the
    host: a ``ctr`` probe's ciphertext (T-table engine), a ``gcm`` probe's
    ciphertext and tag (``np_gcm_seal``), the ``gcm-open`` probe's plaintext
    (the sealed pair replayed), or a ``cbc`` probe's plaintext (its payload
    is ``_np_cbc_encrypt`` of it). The draws follow the JAX loadgen's order.
    Call before the server starts."""
    rng = np.random.default_rng(seed ^ 0x9E3779B9)
    probes = []
    for size in sizes:
        key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        payload = rng.integers(0, 256, size, dtype=np.uint8)
        if "ctr" in modes:
            ref = AES(key, engine=TTABLE_ENGINE, device="cpu")
            expected = ref.crypt_ctr(0, np.frombuffer(nonce, np.uint8), np.zeros(16, np.uint8),
                                     payload)[0]
            probes.append(Probe("probe", key, nonce, payload, np.asarray(expected)))
        gcm_wanted = [m for m in ("gcm", "gcm-open") if m in modes]
        if gcm_wanted:
            iv = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
            aad = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            ct, tag = aead_ghash.np_gcm_seal(key, iv, aad, payload.tobytes())
            if "gcm" in gcm_wanted:
                probes.append(Probe("probe", key, b"", payload, np.frombuffer(ct, np.uint8),
                                    mode="gcm", iv=iv, aad=aad, expected_tag=tag))
            if "gcm-open" in gcm_wanted:
                probes.append(Probe("probe", key, b"", np.frombuffer(ct, np.uint8), payload,
                                    mode="gcm-open", iv=iv, aad=aad, tag=tag))
        if "cbc" in modes:
            iv16 = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            ct = _np_cbc_encrypt(key, iv16, payload.tobytes())
            probes.append(Probe("probe", key, b"", np.frombuffer(ct, np.uint8), payload,
                                mode="cbc", iv=iv16))
    return probes


def make_transfer_probes(sizes, seed: int) -> list[Probe]:
    """One pinned oversized ``ctr`` request a size, with its single-shot
    reference from the host (the T-table engine on the CPU): every transfer
    of a drive is one of these, always verified. Call before the server
    starts."""
    rng = np.random.default_rng(seed ^ 0x7F4A7C15)
    probes = []
    for size in sizes:
        if size % 16:
            raise ValueError(f"transfer size {size} is not a multiple of 16 bytes")
        key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        payload = rng.integers(0, 256, size, dtype=np.uint8)
        ref = AES(key, engine=TTABLE_ENGINE, device="cpu")
        expected = ref.crypt_ctr(0, np.frombuffer(nonce, np.uint8), np.zeros(16, np.uint8),
                                 payload)[0]
        probes.append(Probe("transfer", key, nonce, payload, np.asarray(expected)))
    return probes


@dataclass
class SessionScript:
    """One pinned rc4 session: its key, its chunks' payloads and each
    chunk's expected bytes (the stream is stateful, so the unit of
    verification is the ordered script)."""

    tenant: str
    sid: int
    key: bytes
    payloads: list
    expected: list


def make_session_probes(sessions: int, chunks: int, seed: int, chunk_sizes=(256, 1024, 4096),
                        tenants: int = 4) -> list[SessionScript]:
    """Pinned session scripts with expected bytes from the host PRGA
    (``keystream_np``). Chunk sizes cycle the menu with a phase a session, so
    concurrent sessions' chunks land on different rungs; every size is a
    multiple of 16 bytes. The draws follow the JAX loadgen's."""
    rng = np.random.default_rng(seed ^ 0x2545F491)
    scripts = []
    for s in range(int(sessions)):
        key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        state = (0, 0, key_schedule(key))
        payloads, expected = [], []
        for c in range(int(chunks)):
            size = int(chunk_sizes[(s + c) % len(chunk_sizes)])
            data = rng.integers(0, 256, size, dtype=np.uint8)
            ks, state = keystream_np(state, size)
            payloads.append(data)
            expected.append(np.bitwise_xor(data, ks))
        scripts.append(SessionScript(f"t{s % max(int(tenants), 1)}", s, key, payloads, expected))
    return scripts


async def run(server, n_requests: int, concurrency: int = 32, sizes=MIXED_SIZES,
              tenants: int = 4, keys_per_tenant: int = 2, seed: int = 0,
              verify_every: int = 8, deadline_s: float | None = None,
              probes: list[Probe] | None = None, arrival_rate: float | None = None,
              modes=("ctr",), transfer_sizes=(), transfer_every: int = 0,
              transfer_probes: list[Probe] | None = None, sessions: int = 0,
              session_chunks: int = 0, session_chunk_bytes=(256, 1024, 4096),
              session_scripts: list[SessionScript] | None = None,
              clock=time.monotonic) -> LoadReport:
    """Drive ``server`` with ``n_requests`` in total; the aggregated report.
    ``arrival_rate=None``: ``concurrency`` closed-loop clients;
    ``arrival_rate=R``: open loop, one request every 1/R seconds. ``modes``:
    the mix, each request's mode drawn uniformly from it; with ``gcm-open``
    every size needs its sealed probe pair (``ValueError`` otherwise).
    ``transfer_sizes`` with ``transfer_every=N``: every N-th request is an
    oversized probe (round robin over the sizes), verified. ``sessions=N``
    with ``session_chunks=M``: N rc4 session clients beside the others (the
    module docstring)."""
    sizes = tuple(sizes)
    modes = tuple(modes) or ("ctr",)
    if probes is None:
        probes = make_probes(sizes, seed, modes)
    tprobes = list(transfer_probes or ())
    if not tprobes and transfer_sizes and transfer_every:
        tprobes = make_transfer_probes(tuple(transfer_sizes), seed)
    scripts = list(session_scripts or ())
    if not scripts and sessions and session_chunks:
        scripts = make_session_probes(sessions, session_chunks, seed,
                                      chunk_sizes=tuple(session_chunk_bytes), tenants=tenants)
    by_key = {(p.mode, p.payload.size): p for p in probes}
    if "gcm-open" in modes:
        missing = [sz for sz in sizes if ("gcm-open", sz) not in by_key]
        if missing:
            raise ValueError(f"gcm-open in the mode mix needs a sealed probe pair per size "
                             f"(missing sizes {missing}): enable verify_every or pass probes "
                             "covering every size")
    keys = {}
    key_rng = np.random.default_rng(seed)
    for t in range(tenants):
        for k in range(keys_per_tenant):
            keys[(t, k)] = key_rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    report = LoadReport()
    counter = {"next": 0, "ok_bytes": 0}
    # One pre-generated payload per size, shared by every client: making
    # random bytes per request inside the timed window would charge payload
    # manufacture to goodput.
    pool_rng = np.random.default_rng(seed ^ 0x5DEECE66D)
    payloads = {s: pool_rng.integers(0, 256, s, dtype=np.uint8) for s in sizes}

    def pick(i: int, rng):
        """Request i's (tenant, key, nonce, payload, probe, mode, iv, aad,
        tag); the mix depends only on the seed and the request order, not on
        the loop shape."""
        if tprobes and transfer_every and i % transfer_every == 0:
            p = tprobes[(i // transfer_every) % len(tprobes)]
            return p.tenant, p.key, p.nonce, p.payload, p, p.mode, p.iv, p.aad, p.tag
        size = int(rng.choice(sizes))
        mode = modes[int(rng.integers(len(modes)))]
        probe = by_key.get((mode, size)) if (verify_every and i % verify_every == 0) else None
        if probe is None and mode == "gcm-open":
            # Unverified open traffic replays the sealed pair all the same.
            p = by_key[(mode, size)]
            return p.tenant, p.key, p.nonce, p.payload, None, p.mode, p.iv, p.aad, p.tag
        if probe is not None:
            return (probe.tenant, probe.key, probe.nonce, probe.payload, probe, probe.mode,
                    probe.iv, probe.aad, probe.tag)
        tenant = f"t{int(rng.integers(tenants))}"
        key = keys[(int(tenant[1:]), int(rng.integers(keys_per_tenant)))]
        nonce = iv = aad = b""
        if mode == "ctr":
            nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        elif mode == "gcm":
            iv = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
            aad = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        elif mode == "cbc":
            iv = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        return tenant, key, nonce, payloads[size], None, mode, iv, aad, b""

    def account(resp, payload, probe, mode, dt_ms: float):
        report.requests += 1
        report.latencies_ms.append(dt_ms)
        if resp.ledger is not None:
            report.ledgers.append(resp.ledger)
        m = report.by_mode.setdefault(mode, {"latencies_ms": [], "ok": 0, "verified": 0})
        m["latencies_ms"].append(dt_ms)
        tx = resp.transfer
        if tx is not None:
            t = report.transfers
            t["requests"] = t.get("requests", 0) + 1
            t["ok"] = t.get("ok", 0) + (1 if resp.ok else 0)
            t["chunks_sent"] = t.get("chunks_sent", 0) + int(tx.get("sent", 0))
            t["redispatched"] = t.get("redispatched", 0) + int(tx.get("redispatched", 0))
        obs_metrics.counter("loadgen_requests", outcome=(resp.error or "ok"))
        obs_metrics.observe("loadgen_latency_us", dt_ms * 1e3, outcome=(resp.error or "ok"))
        if resp.ok:
            report.ok += 1
            m["ok"] += 1
            counter["ok_bytes"] += int(payload.size)
            obs_metrics.counter("loadgen_ok_bytes", int(payload.size))
            if probe is not None:
                report.verified += 1
                m["verified"] += 1
                if not np.array_equal(np.asarray(resp.payload), probe.expected):
                    report.mismatches += 1
                elif probe.expected_tag and resp.tag != probe.expected_tag:
                    report.mismatches += 1  # a gcm probe pins its tag too
        else:
            report.errors[resp.error] = report.errors.get(resp.error, 0) + 1

    async def submit_one(tenant, key, nonce, payload, mode, iv, aad, tag):
        kw = {} if mode == "ctr" else {"mode": mode, "iv": iv, "aad": aad, "tag": tag}
        return await server.submit(tenant, key, nonce, payload, deadline_s=deadline_s, **kw)

    async def client(cid: int):
        rng = np.random.default_rng((seed << 8) ^ cid)
        while True:
            i = counter["next"]
            if i >= n_requests:
                return
            counter["next"] = i + 1
            tenant, key, nonce, payload, probe, mode, iv, aad, tag = pick(i, rng)
            t0 = clock()
            resp = await submit_one(tenant, key, nonce, payload, mode, iv, aad, tag)
            account(resp, payload, probe, mode, (clock() - t0) * 1e3)

    async def open_request(i: int, scheduled: float, rng):
        tenant, key, nonce, payload, probe, mode, iv, aad, tag = pick(i, rng)
        resp = await submit_one(tenant, key, nonce, payload, mode, iv, aad, tag)
        account(resp, payload, probe, mode, (clock() - scheduled) * 1e3)

    async def session_client(script: SessionScript):
        """One session's life: open, its chunks (each verified), close."""
        t = report.sessions
        t["sessions"] = t.get("sessions", 0) + 1
        r = await server.open_session(script.tenant, script.sid, script.key)
        if not r.ok:
            t["open_failed"] = t.get("open_failed", 0) + 1
            err = r.error or "open-failed"
            report.errors[err] = report.errors.get(err, 0) + 1
            obs_metrics.counter("loadgen_sessions", outcome="open-failed")
            return
        t["opened"] = t.get("opened", 0) + 1
        obs_metrics.counter("loadgen_sessions", outcome="opened")
        m = report.by_mode.setdefault("rc4", {"latencies_ms": [], "ok": 0, "verified": 0})
        for data, want in zip(script.payloads, script.expected):
            t0 = clock()
            resp = await server.submit(script.tenant, b"", b"", data, deadline_s=deadline_s,
                                       mode="rc4", sid=script.sid)
            dt_ms = (clock() - t0) * 1e3
            report.requests += 1
            report.latencies_ms.append(dt_ms)
            m["latencies_ms"].append(dt_ms)
            t["chunks"] = t.get("chunks", 0) + 1
            obs_metrics.counter("loadgen_requests", outcome=(resp.error or "ok"))
            obs_metrics.observe("loadgen_latency_us", dt_ms * 1e3, outcome=(resp.error or "ok"))
            if not resp.ok:
                # The stream position is gone: the rest of the script would
                # mis-verify by construction.
                report.errors[resp.error] = report.errors.get(resp.error, 0) + 1
                t["chunk_failed"] = t.get("chunk_failed", 0) + 1
                break
            report.ok += 1
            m["ok"] += 1
            counter["ok_bytes"] += int(data.size)
            obs_metrics.counter("loadgen_ok_bytes", int(data.size))
            report.verified += 1
            m["verified"] += 1
            t["verified"] = t.get("verified", 0) + 1
            if not np.array_equal(np.asarray(resp.payload, np.uint8).reshape(-1), want):
                report.mismatches += 1
                t["mismatches"] = t.get("mismatches", 0) + 1
            await asyncio.sleep(0)  # the other sessions interleave
        r = await server.close_session(script.tenant, script.sid)
        if r.ok:
            t["closed"] = t.get("closed", 0) + 1

    async def open_loop(t_start: float):
        interval = 1.0 / arrival_rate
        rng = np.random.default_rng(seed << 8)
        pending = []
        for i in range(n_requests):
            scheduled = t_start + i * interval
            delay = scheduled - clock()
            if delay > 0:
                await asyncio.sleep(delay)
            pending.append(asyncio.ensure_future(open_request(i, scheduled, rng)))
        await asyncio.gather(*pending)

    t_start = clock()
    # The ordinary clients first, then the sessions, as the JAX loadgen
    # orders them.
    sess_tasks = [session_client(s) for s in scripts]
    if arrival_rate is not None and arrival_rate > 0:
        await asyncio.gather(open_loop(t_start), *sess_tasks)
    else:
        await asyncio.gather(*(client(c) for c in range(concurrency)), *sess_tasks)
    report.finish(clock() - t_start, counter["ok_bytes"])
    return report
