"""Closed- and open-loop load generators for the serve path.

Port of ``our_tree_tpu.serve.loadgen`` for the ``ctr`` mode. Closed loop
(the default): ``concurrency`` clients each draw a (tenant, key, size) from
a seeded generator, submit, await, repeat. Open loop (``arrival_rate=R``):
one request every 1/R seconds whatever the service rate, latency measured
from each request's scheduled arrival.

Correctness rides along: one pinned probe per request size (key, nonce and
payload from the seed) is computed before the server starts, and every
``verify_every``-th request replays a probe and checks the bytes. The
expected outputs come from ``AES(key, engine="ttable", device="cpu")``, a
T-table formulation on the host, independent of the bitsliced kernel under
test: it is the check, not a fallback.

Percentiles are nearest-rank over the full sample; goodput counts OK
payload bytes only.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import numpy as np

from ..models.aes import AES, TTABLE_ENGINE
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

    def finish(self, wall_s: float, ok_bytes: int) -> None:
        self.wall_s = wall_s
        self.goodput_gbps = (ok_bytes / 1e9 / wall_s) if wall_s > 0 else 0.0
        lat = sorted(self.latencies_ms)
        self.p50_ms = round(percentile(lat, 50), 3)
        self.p95_ms = round(percentile(lat, 95), 3)
        self.p99_ms = round(percentile(lat, 99), 3)

    def to_json(self) -> dict:
        return {"requests": self.requests, "ok": self.ok,
                "errors": dict(sorted(self.errors.items())), "verified": self.verified,
                "mismatches": self.mismatches, "wall_s": round(self.wall_s, 3),
                "goodput_gbps": round(self.goodput_gbps, 4), "p50_ms": self.p50_ms,
                "p95_ms": self.p95_ms, "p99_ms": self.p99_ms}


def make_probes(sizes, seed: int) -> list[Probe]:
    """One pinned ctr request per size with its expected output from the
    host T-table engine. Call before the server starts."""
    rng = np.random.default_rng(seed ^ 0x9E3779B9)
    probes = []
    for size in sizes:
        key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        payload = rng.integers(0, 256, size, dtype=np.uint8)
        ref = AES(key, engine=TTABLE_ENGINE, device="cpu")
        expected = ref.crypt_ctr(0, np.frombuffer(nonce, np.uint8), np.zeros(16, np.uint8),
                                 payload)[0]
        probes.append(Probe("probe", key, nonce, payload, np.asarray(expected)))
    return probes


async def run(server, n_requests: int, concurrency: int = 32, sizes=MIXED_SIZES,
              tenants: int = 4, keys_per_tenant: int = 2, seed: int = 0,
              verify_every: int = 8, deadline_s: float | None = None,
              probes: list[Probe] | None = None, arrival_rate: float | None = None,
              clock=time.monotonic) -> LoadReport:
    """Drive ``server`` with ``n_requests`` in total; the aggregated report.
    ``arrival_rate=None``: ``concurrency`` closed-loop clients;
    ``arrival_rate=R``: open loop, one request every 1/R seconds."""
    sizes = tuple(sizes)
    if probes is None:
        probes = make_probes(sizes, seed)
    by_size = {p.payload.size: p for p in probes}
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
        """Request i's (tenant, key, nonce, payload, probe); the mix depends
        only on the seed and the request order, not on the loop shape."""
        size = int(rng.choice(sizes))
        probe = by_size.get(size) if (verify_every and i % verify_every == 0) else None
        if probe is not None:
            return probe.tenant, probe.key, probe.nonce, probe.payload, probe
        tenant = f"t{int(rng.integers(tenants))}"
        key = keys[(int(tenant[1:]), int(rng.integers(keys_per_tenant)))]
        nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        return tenant, key, nonce, payloads[size], None

    def account(resp, payload, probe, dt_ms: float):
        report.requests += 1
        report.latencies_ms.append(dt_ms)
        obs_metrics.counter("loadgen_requests", outcome=(resp.error or "ok"))
        obs_metrics.observe("loadgen_latency_us", dt_ms * 1e3, outcome=(resp.error or "ok"))
        if resp.ok:
            report.ok += 1
            counter["ok_bytes"] += int(payload.size)
            obs_metrics.counter("loadgen_ok_bytes", int(payload.size))
            if probe is not None:
                report.verified += 1
                if not np.array_equal(np.asarray(resp.payload), probe.expected):
                    report.mismatches += 1
        else:
            report.errors[resp.error] = report.errors.get(resp.error, 0) + 1

    async def client(cid: int):
        rng = np.random.default_rng((seed << 8) ^ cid)
        while True:
            i = counter["next"]
            if i >= n_requests:
                return
            counter["next"] = i + 1
            tenant, key, nonce, payload, probe = pick(i, rng)
            t0 = clock()
            resp = await server.submit(tenant, key, nonce, payload, deadline_s=deadline_s)
            account(resp, payload, probe, (clock() - t0) * 1e3)

    async def open_request(i: int, scheduled: float, rng):
        tenant, key, nonce, payload, probe = pick(i, rng)
        resp = await server.submit(tenant, key, nonce, payload, deadline_s=deadline_s)
        account(resp, payload, probe, (clock() - scheduled) * 1e3)

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
    if arrival_rate is not None and arrival_rate > 0:
        await open_loop(t_start)
    else:
        await asyncio.gather(*(client(c) for c in range(concurrency)))
    report.finish(clock() - t_start, counter["ok_bytes"])
    return report
