"""The Router: consistent-hash placement, bit-exact failover, gossip.

Port of ``our_tree_tpu.route.proxy``: the lane pool's contract, one fault
domain up (``serve/lanes.py`` holds the per-device version of each rule):

* **Placement is affinity first.** A request's ring key is
  ``ring.affinity_key(tenant, key)``; its clockwise owner is the back end
  whose keycache holds that key's schedule. ``route.bench``'s A/B (affinity
  against seeded-random routing over fresh workers) measures the
  difference as the keycache hit ratio.
* **Failover before error.** A failed, hung or unreachable back end's
  request re-dispatches on the next ring node (CTR with explicit counters
  replays to the same bytes anywhere); only when every back end was tried
  does the rider see an error: ``deadline`` if the last cause was a hang,
  else ``dispatch-failed``.
* **Hangs are bounded and leave evidence.** Each attempt runs under
  ``min(attempt deadline, the request Budget's remainder)``; expiry
  abandons the ``route-dispatch`` span (the orphan is the evidence,
  ``obs.report --check --expected-orphans route-dispatch``) and quarantines
  the back end.
* **Backpressure propagates.** A back end's ``shed`` is not a failure: the
  router retries the replica ring with exponential backoff and sheds at the
  router (``route->shed`` through ``degrade``) only when every placeable
  back end shed.
* **Membership changes are minimal motion and traced** (``ring-rebalance``
  with the moved count of the recently seen keys).
* **Release runs through the data path.** A quarantined back end is
  canaried (on a gossip ``ok``, or as a rescue when nothing is placeable):
  the pinned canary, whose bytes every back end matched at start, must come
  back bit-exact to earn probation; probation is served through traffic.
* **Chunked transfers and sessions.** Oversized payloads split into
  rung-sized chunks sprayed across the key's replica sequence
  (``submit_transfer``); an rc4 session's frames are pinned to the back end
  that opened it (``session_order``, ``open_session``/``submit_session``/
  ``close_session``), and session data with no pin is refused.

This is the only module that contacts a back end: framed requests,
``/healthz`` gossip, federation scrapes and canaries all open their sockets
here, inside the seams with the fault points ``backend_fail``,
``backend_hang`` and ``pool_stale`` (scoped ``@backend=<i>``). Requests go
over a pool of persistent connections per back end; a fresh dial runs the
shared ``RetryPolicy`` off the loop, and a stale pooled socket costs one
redispatch, never an error.
"""

from __future__ import annotations

import asyncio
import json
import socket
import time
from dataclasses import dataclass

import numpy as np

from ..obs import metrics, pulse, trace
from ..resilience import degrade, faults
from ..resilience import journal as journal_mod
from ..resilience.policy import Budget, RetryPolicy
from ..serve import transfer as transfer_mod
from ..serve import wire
from ..serve.queue import (ERR_BAD_REQUEST, ERR_DEADLINE, ERR_DISPATCH,
                           ERR_SHED, ERR_SHUTDOWN, Response)
from . import ring as ring_mod
from .health import QUARANTINED, RELEASED, BackendHealth, backend_unit

#: The pinned canary request: zero key, zero nonce, 4 zero blocks —
#: tiny, ladder-shaped, and identical on every backend (the startup
#: cross-backend comparison pins its expected bytes; no reference
#: implementation is needed router-side, so the router imports no engine).
CANARY_TENANT = "_canary"
CANARY_KEY = b"\x00" * 16
CANARY_NONCE = b"\x00" * 16
CANARY_PAYLOAD = b"\x00" * 64


class BackendsExhausted(RuntimeError):
    """Every backend failed this request (rescue canaries included).
    ``causes`` is [(backend_idx, exc), ...] in attempt order;
    ``timed_out`` reflects the LAST cause — the error code the rider
    sees matches what finally stopped the request (the LanesExhausted
    convention, one fault domain up)."""

    def __init__(self, label: str, causes: list):
        self.causes = causes
        last = causes[-1][1] if causes else None
        self.timed_out = isinstance(last, asyncio.TimeoutError)
        names = ",".join(f"b{i}:{type(e).__name__}" for i, e in causes)
        super().__init__(
            f"request {label}: no backend could serve it "
            f"({names or 'no backends'})")


@dataclass
class BackendSpec:
    """How to reach one ot-serve backend: the framed request port plus
    the /healthz status port (both on ``host``). ``name`` is the ring
    identity — keep it stable across restarts of the same backend slot
    or its keys re-home."""

    name: str
    host: str
    port: int
    status_port: int | None = None
    #: the backend's process id when the deployer knows it (the READY
    #: line carries it) — pre-seeds the clock-skew ledger's pid mapping
    pid: int | None = None


class Backend:
    """Client-side handle: spec + health + counters + the contact seams."""

    def __init__(self, idx: int, spec: BackendSpec,
                 probation_batches: int = 2, journal=None,
                 clock=time.monotonic,
                 max_frame_bytes: int = wire.MAX_PAYLOAD,
                 pool_size: int = 8, reconnect_attempts: int = 3,
                 reconnect_base_s: float = 0.02,
                 connect_timeout_s: float = 2.0):
        self.idx = idx
        self.spec = spec
        self.max_frame_bytes = int(max_frame_bytes)
        #: idle pooled connections to this backend (LIFO: the warmest
        #: socket serves next); 0 disables pooling — dial per exchange
        self.pool_size = int(pool_size)
        self.reconnect_attempts = int(reconnect_attempts)
        self.reconnect_base_s = float(reconnect_base_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self._pool: list = []
        self.pool_hits = 0
        self.pool_dials = 0
        self.pool_stale = 0
        self.health = BackendHealth(idx, spec.name,
                                    probation_batches=probation_batches,
                                    journal=journal, clock=clock)
        self.dispatches = 0
        self.bytes_out = 0
        self.failures = 0
        self.timeouts = 0
        self.redispatches_in = 0
        self.sheds_seen = 0
        self.canaries = 0
        self.last_healthz: dict | None = None
        #: the backend's process id, learned from response frames (the
        #: wire handshake) — keys the clock-skew estimate to the trace
        #: files that pid wrote
        self.pid: int | None = spec.pid
        #: estimated backend-clock minus router-clock offset (µs), from
        #: canary exchanges: skew = reply ts - exchange midpoint
        self.skew_us: int | None = None

    # -- the framed-request seam -------------------------------------------
    async def exchange(self, header: dict, payload: bytes,
                       timeout_s: float):
        """One framed request/response round trip with a hard wall
        deadline over the WHOLE exchange (connect included — a backend
        that stopped accepting is as hung as one that stopped
        answering). Returns (response header, response payload)."""
        return await asyncio.wait_for(
            self._exchange(header, payload), timeout=max(timeout_s, 0.001))

    async def _exchange(self, header: dict, payload: bytes):
        reader, writer = await self._acquire()
        try:
            if faults.fire_backend("pool_stale", self.idx):
                # The injected half-closed pooled socket: the acquire
                # liveness check passed but first use fails — the rider
                # must ride the ring-retry failover, never an error.
                trace.point("fault-pool-stale", backend=self.idx)
                raise ConnectionResetError(
                    "injected stale pooled connection")
            writer.write(wire.encode_frame(header, payload))
            await writer.drain()
            frame = await wire.read_frame(reader, self.max_frame_bytes)
            if frame is None:
                raise ConnectionError(
                    f"backend {self.spec.name} closed mid-exchange")
        except BaseException:
            # Any failure mid-exchange — a stale socket's reset, a torn
            # frame, or the attempt deadline's cancel — leaves the
            # stream untrustworthy (a half-written request or half-read
            # response may be in flight): close it, never pool it back.
            # The raised error flows into the router's existing
            # ring-retry failover, so a stale pooled socket costs one
            # redispatch, not an error.
            self._discard(writer)
            raise
        self._release(reader, writer)
        return frame

    # -- the connection pool -----------------------------------------------
    async def _acquire(self):
        """An idle pooled connection, or a fresh dial. Pooled sockets
        are liveness-checked (EOF/half-close seen by the transport) —
        visibly dead ones are dropped and counted; an INVISIBLY dead
        one (peer vanished without FIN reaching us yet) fails at first
        use, which ``_exchange`` converts into failover."""
        while self._pool:
            reader, writer = self._pool.pop()
            if reader.at_eof() or writer.is_closing():
                self.pool_stale += 1
                metrics.counter("route_pool", backend=self.idx,
                                outcome="stale")
                self._discard(writer)
                continue
            self.pool_hits += 1
            metrics.counter("route_pool", backend=self.idx, outcome="hit")
            return reader, writer
        return await self._dial()

    async def _dial(self):
        """One transport dial. With pooling on, the blocking connect
        runs off-loop under the shared ``RetryPolicy`` (attempts +
        exponential backoff — the reconnect-and-backoff seam): a
        backend mid-restart costs a bounded retry in an executor
        thread, never a stalled event loop; exhaustion raises into the
        ring-retry failover like any other backend failure."""
        self.pool_dials += 1
        metrics.counter("route_pool", backend=self.idx, outcome="dial")
        host, port = self.spec.host, self.spec.port
        if self.pool_size <= 0:
            # Pooling disabled: the pre-pool dial-per-exchange path.
            return await asyncio.open_connection(host, port)
        timeout = self.connect_timeout_s

        def dial_blocking():
            return RetryPolicy(
                attempts=max(self.reconnect_attempts, 1),
                base_delay_s=self.reconnect_base_s,
                retry_on=(OSError,),
                name=f"route-pool:{self.spec.name}",
            ).run(lambda _a: socket.create_connection((host, port),
                                                      timeout=timeout))

        loop = asyncio.get_running_loop()
        sock = await loop.run_in_executor(None, dial_blocking)
        return await asyncio.open_connection(sock=sock)

    def _release(self, reader, writer) -> None:
        if (len(self._pool) < self.pool_size and not writer.is_closing()
                and not reader.at_eof()):
            self._pool.append((reader, writer))
        else:
            self._discard(writer)

    def _discard(self, writer) -> None:
        try:
            writer.close()
        except Exception:  # noqa: BLE001 - peer already gone
            pass

    def close_pool(self) -> None:
        """Drop every idle pooled connection (teardown: the member left
        the ring or the router is stopping)."""
        while self._pool:
            _reader, writer = self._pool.pop()
            self._discard(writer)

    # -- the gossip seam ----------------------------------------------------
    async def poll_healthz(self, timeout_s: float = 2.0) -> dict | None:
        """GET /healthz off the backend's status port; None when the
        backend is unreachable, has no status port, or answers junk —
        gossip treats all three as the same reconnaissance failure."""
        if not self.spec.status_port:
            return None
        try:
            doc = await asyncio.wait_for(self._get_healthz(),
                                         timeout=max(timeout_s, 0.001))
        except Exception:  # noqa: BLE001 - unreachable IS the data point
            return None
        self.last_healthz = doc
        return doc

    async def _get_healthz(self) -> dict | None:
        body = await self._get_status("/healthz")
        if body is None:
            return None
        doc = json.loads(body)
        return doc if isinstance(doc, dict) else None

    async def poll_metrics_text(self, timeout_s: float = 2.0) -> str | None:
        """GET /metrics off the backend's status port — the federation
        scrape (route/status.py folds every backend's registry into one
        fleet /metrics document). None on any failure: a missing
        backend simply contributes no series, flagged by the federator."""
        if not self.spec.status_port:
            return None
        try:
            body = await asyncio.wait_for(self._get_status("/metrics"),
                                          timeout=max(timeout_s, 0.001))
        except Exception:  # noqa: BLE001 - unreachable IS the data point
            return None
        return body.decode("utf-8", "replace") if body is not None else None

    async def poll_alertz(self, timeout_s: float = 2.0) -> dict | None:
        """GET /alertz off the backend's status port — the federated
        alert view (route/status.py folds every backend's pulse rows
        into one fleet document). None when the backend is unreachable,
        runs no pulse engine (404), or answers junk."""
        if not self.spec.status_port:
            return None
        try:
            body = await asyncio.wait_for(self._get_status("/alertz"),
                                          timeout=max(timeout_s, 0.001))
        except Exception:  # noqa: BLE001 - unreachable IS the data point
            return None
        if body is None:
            return None
        try:
            doc = json.loads(body)
        except ValueError:
            return None
        return doc if isinstance(doc, dict) else None

    async def poll_profilez(self, seconds: float,
                            timeout_s: float | None = None) -> dict | None:
        """GET /profilez?seconds=N off the backend's status port — the
        federated capture arm (route/status.py): the backend itself
        enforces the one-window rule (409) and the tracing requirement
        (503); the router just relays. Returns {"code", "doc"} or None
        when the backend is unreachable / has no status port. The
        default relay deadline covers the backend's seconds-scale
        arming cost (the torch profiler's first start) —
        a 5 s gossip-style timeout would misreport an arming backend
        as unreachable while its window opened anyway."""
        if not self.spec.status_port:
            return None
        if timeout_s is None:
            timeout_s = float(seconds) + 60.0
        try:
            code, body = await asyncio.wait_for(
                self._get_status_raw(f"/profilez?seconds={seconds:g}"),
                timeout=max(timeout_s, 0.001))
        except Exception:  # noqa: BLE001 - unreachable IS the data point
            return None
        try:
            doc = json.loads(body) if body else {}
        except ValueError:
            doc = {}
        return {"code": code, "doc": doc if isinstance(doc, dict) else {}}

    async def _get_status(self, path: str) -> bytes | None:
        """One HTTP GET against the backend's status port (the gossip
        and federation scrapes share it); None on a non-200."""
        code, body = await self._get_status_raw(path)
        return body if code == 200 else None

    async def _get_status_raw(self, path: str) -> tuple[int, bytes]:
        """The raw (status code, body) GET behind ``_get_status`` and
        the profilez relay (which must distinguish 409/503 from
        unreachable). The response is read to EOF (the endpoint answers
        Connection: close), NOT with one read() — a /metrics body past
        one TCP segment would otherwise come back truncated mid-line —
        with a hard size cap so a misbehaving peer cannot balloon the
        router."""
        reader, writer = await asyncio.open_connection(
            self.spec.host, self.spec.status_port)
        try:
            writer.write(f"GET {path} HTTP/1.1\r\n".encode("latin-1")
                         + b"Host: backend\r\nConnection: close\r\n\r\n")
            await writer.drain()
            chunks: list[bytes] = []
            total = 0
            while total < (1 << 24):
                chunk = await reader.read(1 << 16)
                if not chunk:
                    break
                chunks.append(chunk)
                total += len(chunk)
            raw = b"".join(chunks)
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - peer already gone
                pass
        head, _, body = raw.partition(b"\r\n\r\n")
        try:
            code = int(head.split(None, 2)[1])
        except (IndexError, ValueError):
            code = 0
        return code, body

    def stats(self) -> dict:
        return {
            "backend": self.idx, "name": self.spec.name,
            "addr": f"{self.spec.host}:{self.spec.port}",
            "dispatches": self.dispatches, "bytes": self.bytes_out,
            "failures": self.failures, "timeouts": self.timeouts,
            "redispatches_in": self.redispatches_in,
            "sheds_seen": self.sheds_seen, "canaries": self.canaries,
            "pid": self.pid, "skew_us": self.skew_us,
            "pool": {"idle": len(self._pool), "hits": self.pool_hits,
                     "dials": self.pool_dials, "stale": self.pool_stale},
            **self.health.stats(),
        }


@dataclass
class RouterConfig:
    #: per-request end-to-end Budget (admission -> answer), seconds
    deadline_s: float = 30.0
    #: wall deadline per backend ATTEMPT (connect + serve + reply);
    #: clamped to the request Budget's remainder — the watchdog bound
    #: that turns a wedged backend into failover instead of a stall
    attempt_timeout_s: float = 5.0
    #: /healthz gossip poll period (0 disables polling; dispatch
    #: outcomes still drive health)
    gossip_every_s: float = 1.0
    #: clean answers a released backend serves before leaving probation
    probation_batches: int = 2
    #: base backoff before retrying a SHED answer on the next replica
    #: (exponential per extra shed in the same request)
    shed_backoff_s: float = 0.02
    #: virtual nodes per ring member
    vnodes: int = 64
    #: affinity routing (the production mode); False = seeded-random
    #: backend order per request (the A/B control arm)
    affinity: bool = True
    #: RNG seed for the random-routing control arm
    seed: int = 0
    #: router journal path (backend quarantine persistence, the shared
    #: --unquarantine edit); None = in-memory health only
    journal: str | None = None
    #: recently-seen affinity keys tracked for rebalance-motion
    #: accounting (bounded; 0 disables tracking)
    track_keys: int = 4096
    #: response-frame payload ceiling per backend exchange — size it to
    #: the fleet's bucket ladder (route.bench derives it from
    #: --bucket-max); a legitimate response above it would read as a
    #: backend failure on every replica
    max_frame_bytes: int = wire.MAX_PAYLOAD
    #: idle pooled connections kept per backend (0 restores the
    #: dial-per-exchange transport): pooling drops the per-request
    #: connect from the wire stage
    pool_size: int = 8
    #: dial retry policy at the pool's reconnect seam
    #: (resilience.policy.RetryPolicy: attempts + exponential backoff)
    pool_reconnect_attempts: int = 3
    pool_reconnect_base_s: float = 0.02
    #: blocking connect() timeout per dial attempt (the attempt wall
    #: deadline still bounds the whole exchange above it)
    pool_connect_timeout_s: float = 2.0
    #: chunked transfers (serve/transfer.py) at the ROUTER: payloads
    #: above this many blocks decompose into rung-sized chunks that
    #: spray across the affinity replica ring (each chunk fails over
    #: bit-exactly like an ordinary request). The router cannot see the
    #: backends' ladder, so the rung is explicit — size it to the
    #: fleet's --bucket-max. None/0 disables (oversized requests flow
    #: to a backend and take its typed refusal).
    transfer_chunk_blocks: int | None = None
    #: concurrent transfers admitted before new ones shed
    max_transfers: int = 8
    #: in-flight chunks per transfer (the pipelining window)
    transfer_window: int = 8
    #: reassembly-buffer byte budget (backpressure, never a wedge)
    transfer_budget_bytes: int = 64 << 20
    #: per-transfer payload ceiling (too-large past it, pre-allocation)
    transfer_max_bytes: int = 1 << 30
    #: default per-transfer Budget, seconds
    transfer_deadline_s: float = 300.0
    #: durable acked-chunk ledger path (the resume contract); None =
    #: in-memory
    transfer_ledger: str | None = None


class Router:
    """The front-end routing tier over N ot-serve backends."""

    def __init__(self, specs: list[BackendSpec],
                 config: RouterConfig | None = None, clock=time.monotonic):
        self.config = config or RouterConfig()
        self._clock = clock
        self.ring = ring_mod.Ring(vnodes=self.config.vnodes)
        self.backends: dict[str, Backend] = {}
        self._journal = None
        self._next_idx = 0
        self._specs = list(specs)
        self._rng = np.random.default_rng(self.config.seed)
        self.accepted = 0
        self.answered = 0
        self.routed_ok = 0
        self.redispatches = 0
        self.shed_retries = 0
        #: pool counters of members that already LEFT the ring (an
        #: elastic fleet retires workers mid-drive; route.bench's pool
        #: aggregate must count their reuse too)
        self.pool_retired = {"hits": 0, "dials": 0, "stale": 0}
        self.router_sheds = 0
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.ring_changes = 0
        self._canary_expected: bytes | None = None
        self._gossip_task: asyncio.Task | None = None
        self._draining = False
        self._inflight = 0
        self._idle = asyncio.Event()
        self._idle.set()
        #: recently-seen affinity keys (insertion-ordered dict as LRU)
        #: — the rebalance-motion sample on membership changes
        self._seen_keys: dict[str, None] = {}
        #: (tenant, sid) -> backend name: where each rc4 session's
        #: server-side state LIVES (the backend whose open succeeded).
        #: Session frames are pinned there — cross-backend failover
        #: would find no state (the in-process lane pool owns the
        #: bit-exact failover story; docs/SERVING.md, sessions section)
        self._session_pins: dict[tuple, str] = {}
        self.sessions_opened = 0
        self.sessions_closed = 0
        self.session_chunks = 0
        self.session_pin_misses = 0
        #: the chunked-transfer engine (serve/transfer.py) — the SAME
        #: engine the server embeds, parameterized here by per-chunk
        #: ring placement instead of queue admission. None when the
        #: deployer set no chunk rung.
        #: the router-tier pulse analytics thread (obs/pulse.py),
        #: started at start(); None when OT_PULSE=0
        self.pulse: pulse.PulseThread | None = None
        self.transfers: transfer_mod.TransferManager | None = None
        if self.config.transfer_chunk_blocks:
            self.transfers = transfer_mod.TransferManager(
                self._transfer_chunk,
                chunk_blocks=self.config.transfer_chunk_blocks,
                max_transfers=self.config.max_transfers,
                window=self.config.transfer_window,
                reassembly_budget_bytes=self.config.transfer_budget_bytes,
                max_payload_bytes=self.config.transfer_max_bytes,
                deadline_s=self.config.transfer_deadline_s,
                ledger=transfer_mod.TransferLedger(
                    self.config.transfer_ledger),
                clock=self._clock)

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        """Open the journal, register the initial backends, adopt
        recorded quarantines, pin the canary across every backend (the
        cross-backend bit-exactness startup check), start gossip."""
        c = self.config
        if c.journal:
            self._journal = journal_mod.SweepJournal(
                c.journal, {"kind": "route-backends",
                            "members": sorted(s.name for s in self._specs)})
        for spec in self._specs:
            self._register(spec)
        if self._journal is not None:
            for b in self.backends.values():
                fails = self._journal.fail_count(backend_unit(b.spec.name))
                if fails > 0:
                    b.health.adopt_journal_quarantine(fails)
        await self._pin_canary()
        if c.gossip_every_s > 0:
            self._gossip_task = asyncio.ensure_future(self._gossip_loop())
        # The router-tier pulse engine (obs/pulse.py): consumes THIS
        # process's registry (route_* series — sheds, backend
        # transitions), so the quarantine-flap and burn-rate rules
        # watch the routing tier too. None when OT_PULSE=0.
        self.pulse = pulse.start_live("route")

    def _register(self, spec: BackendSpec) -> None:
        if spec.name in self.backends:
            raise ValueError(f"backend {spec.name!r} already registered")
        c = self.config
        b = Backend(self._next_idx, spec,
                    probation_batches=c.probation_batches,
                    journal=self._journal, clock=self._clock,
                    max_frame_bytes=c.max_frame_bytes,
                    pool_size=c.pool_size,
                    reconnect_attempts=c.pool_reconnect_attempts,
                    reconnect_base_s=c.pool_reconnect_base_s,
                    connect_timeout_s=c.pool_connect_timeout_s)
        self._next_idx += 1
        self.backends[spec.name] = b
        self.ring.add(spec.name)

    async def _pin_canary(self) -> None:
        """Send the pinned canary request to EVERY backend; the first
        bit-exact-capable answer pins the expectation, every other
        backend is compared against it — cross-backend bit-exactness is
        a startup invariant, not a hope (the serve warmup rule, one
        level up). A backend that fails or mismatches starts
        quarantined; a router with NO canary-able backend cannot serve
        and fails start() loudly."""
        for b in self.backends.values():
            if b.health.state == QUARANTINED:
                continue  # journal-adopted: never let it pin the oracle
            out = await self._canary_once(b)
            if out is None:
                b.health.canary_failed("failed")
            elif self._canary_expected is None:
                self._canary_expected = out
                trace.point("route-canary-pinned", backend=b.idx,
                            n=len(out))
            elif out != self._canary_expected:
                b.health.canary_failed("mismatch")
        if self._canary_expected is None:
            raise RuntimeError(
                f"route startup failed: none of the {len(self.backends)} "
                "backend(s) answered the canary request")

    async def _canary_once(self, b: Backend) -> bytes | None:
        """One canary exchange on ``b`` (startup pinning and quarantine
        probing share it); None on any failure or timeout. Doubles as
        the CLOCK-SKEW handshake: every response frame carries the
        backend's epoch-µs clock, and the canary's request/response
        midpoint estimates the offset between the two processes' clocks
        (traced as ``wire-skew`` — what ``obs.export`` aligns the
        merged Perfetto timeline with)."""
        b.canaries += 1
        with trace.detached_span("backend-probe", backend=b.idx) as _:
            t_send = trace.now_us()
            try:
                header, body = await b.exchange(
                    {"t": CANARY_TENANT, "k": CANARY_KEY.hex(),
                     "n": CANARY_NONCE.hex()},
                    CANARY_PAYLOAD, self.config.attempt_timeout_s)
            except Exception:  # noqa: BLE001 - a sick backend may do anything
                metrics.counter("route_canary", backend=b.idx,
                                outcome="failed")
                return None
            t_recv = trace.now_us()
        self._note_handshake(b, header, t_send, t_recv)
        if not header.get("ok"):
            metrics.counter("route_canary", backend=b.idx, outcome="refused")
            return None
        metrics.counter("route_canary", backend=b.idx, outcome="ok")
        return body

    def _note_handshake(self, b: Backend, header: dict,
                        t_send: int, t_recv: int) -> None:
        """Fold one response frame's clock stamps into the backend's
        skew estimate. With both the receive ("tr") and reply ("ts")
        stamps this is the NTP four-timestamp offset —
        ``((tr - send) + (ts - recv)) / 2`` — which cancels the
        backend's processing time; with only "ts" it degrades to the
        midpoint estimator (biased by half the service time, still
        bounded by the round trip)."""
        ts = header.get("ts")
        if not isinstance(ts, int):
            return
        pid = header.get("pid")
        if isinstance(pid, int):
            b.pid = pid
        tr = header.get("tr")
        if isinstance(tr, int):
            skew = int(((tr - t_send) + (ts - t_recv)) // 2)
        else:
            skew = int(ts - (t_send + t_recv) // 2)
        b.skew_us = skew
        trace.point("wire-skew", backend=b.idx, pid=b.pid,
                    skew_us=skew, rtt_us=int(t_recv - t_send))

    async def stop(self) -> None:
        """Graceful drain: stop gossip, close admission (new submits
        answer ``shutdown``), await every in-flight request, close the
        journal. The ``lost == 0`` gate (accepted == answered) is the
        serve drain contract at router level — route.bench exits 1 on
        violation."""
        self._draining = True
        if self._gossip_task is not None:
            self._gossip_task.cancel()
            try:
                await self._gossip_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._gossip_task = None
        await self._idle.wait()
        for b in self.backends.values():
            b.close_pool()
        trace.point("route-drained", accepted=self.accepted,
                    answered=self.answered,
                    lost=self.accepted - self.answered)
        if self.transfers is not None:
            self.transfers.ledger.close()
        if self.pulse is not None:
            self.pulse.stop()
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    # -- membership --------------------------------------------------------
    def _rebalance_motion(self, action: str, member: str, fn) -> None:
        """Apply the ring mutation ``fn`` and trace how many of the
        recently-seen affinity keys changed owner — the minimal-motion
        evidence (~K/N for one member among N) on the live key sample,
        not a synthetic one."""
        keys = list(self._seen_keys)
        # An empty ring has no placement (teardown removes the last
        # member; the fleet supervisor's close() walks through here):
        # every tracked key counts as moved then.
        before = self.ring.placement(keys) if keys and len(self.ring) else {}
        fn()
        after = self.ring.placement(keys) if keys and len(self.ring) else {}
        moved = ring_mod.moved_keys(before, after)
        self.ring_changes += 1
        metrics.counter("route_ring_changes")
        metrics.counter("route_ring_moved_keys", moved)
        trace.point("ring-rebalance", action=action, member=member,
                    moved=moved, tracked=len(keys),
                    members=len(self.ring))

    async def add_backend(self, spec: BackendSpec) -> None:
        """Join: register, canary against the PINNED expectation (a new
        backend must prove bit-exactness before placement trusts it),
        minimal-motion rebalance."""
        self._rebalance_motion("join", spec.name,
                               lambda: self._register(spec))
        b = self.backends[spec.name]
        if self._journal is not None:
            fails = self._journal.fail_count(backend_unit(spec.name))
            if fails > 0:
                b.health.adopt_journal_quarantine(fails)
                return
        out = await self._canary_once(b)
        if out is None:
            b.health.canary_failed("failed")
        elif self._canary_expected is not None and out != self._canary_expected:
            b.health.canary_failed("mismatch")
        elif self._canary_expected is None:
            self._canary_expected = out

    def remove_backend(self, name: str) -> None:
        """Leave: drop the member; its arcs return to the clockwise
        successors (minimal motion), in-flight requests to it finish or
        fail over like any other outcome. The departing member's pool
        counters fold into ``pool_retired`` — an elastic fleet retires
        members mid-drive, and the reuse evidence must outlive them."""
        if name not in self.backends:
            raise ValueError(f"backend {name!r} not registered")
        self._rebalance_motion("leave", name,
                               lambda: self.ring.remove(name))
        b = self.backends[name]
        self.pool_retired["hits"] += b.pool_hits
        self.pool_retired["dials"] += b.pool_dials
        self.pool_retired["stale"] += b.pool_stale
        b.close_pool()
        del self.backends[name]

    async def canary_check(self, spec: BackendSpec) -> tuple[bool, str]:
        """Probe a PROSPECTIVE backend with the pinned startup canary
        WITHOUT granting membership — the rolling upgrade's bit-exact
        handoff gate (route/fleet.py): a successor must answer the
        fleet's pinned bytes identically before the predecessor may
        begin draining. Returns (ok, why) with why one of
        ok/failed/mismatch/unpinned; the ring, health, and placement
        are untouched either way."""
        b = Backend(-1, spec, clock=self._clock,
                    max_frame_bytes=self.config.max_frame_bytes,
                    pool_size=0)
        try:
            out = await self._canary_once(b)
        finally:
            b.close_pool()
        if self._canary_expected is None:
            return False, "unpinned"
        if out is None:
            return False, "failed"
        if out != self._canary_expected:
            return False, "mismatch"
        return True, "ok"

    # -- gossip ------------------------------------------------------------
    async def _gossip_loop(self) -> None:
        period = max(self.config.gossip_every_s, 0.05)
        while True:
            await asyncio.sleep(period)
            await self.gossip_once()

    async def gossip_once(self) -> None:
        """One poll pass: fold every backend's /healthz into its health
        machine; an ``ok`` answer from a QUARANTINED backend triggers a
        canary (release still requires the bit-exact data-path answer).
        Backends with NO status port are skipped entirely — having no
        reconnaissance channel is a deployment shape, not evidence of
        unreachability, and suspecting them every period would defeat
        the two-strike model for the whole fleet."""
        for b in list(self.backends.values()):
            if not b.spec.status_port:
                continue
            doc = await b.poll_healthz()
            status = doc.get("status") if isinstance(doc, dict) else None
            b.health.note_gossip(status if isinstance(status, str) else None)
            if status == "ok" and b.health.state == QUARANTINED:
                await self._probe_quarantined(b)

    async def _probe_quarantined(self, b: Backend) -> bool:
        """Canary a quarantined backend; bit-exact releases it into
        probation, anything else keeps it quarantined."""
        out = await self._canary_once(b)
        if out is not None and out == self._canary_expected:
            b.health.canary_ok()
            return True
        b.health.canary_failed(
            "mismatch" if out is not None else "failed")
        return False

    # -- placement ---------------------------------------------------------
    def _order_for(self, aff: str) -> list[str]:
        """The request's backend attempt order: the ring's clockwise
        replica sequence under affinity, a seeded-random permutation in
        the control arm (same MEMBERS, no locality — the A/B's only
        difference)."""
        if self.config.affinity:
            return self.ring.nodes_for(aff)
        members = list(self.ring.members())
        return [members[i] for i in self._rng.permutation(len(members))]

    def _track(self, aff: str) -> None:
        cap = self.config.track_keys
        if cap <= 0:
            return
        self._seen_keys.pop(aff, None)
        self._seen_keys[aff] = None
        while len(self._seen_keys) > cap:
            self._seen_keys.pop(next(iter(self._seen_keys)))

    # -- the request path --------------------------------------------------
    async def submit(self, tenant: str, key: bytes, nonce: bytes, payload,
                     deadline_s: float | None = None, mode: str = "ctr",
                     iv: bytes = b"", aad: bytes = b"",
                     tag: bytes = b"", sid: int = -1) -> Response:
        """Route one request; always answers (payload or coded error)
        — the loadgen-compatible submit surface, so the serve load
        generator drives a router exactly as it drives a server.
        ``mode``/``iv``/``aad``/``tag`` are the served-mode fields
        (serve/queue.py MODES): they ride the wire's ``m``/``iv``/
        ``a``/``tg`` fields verbatim, the backend's admission owns the
        per-mode validation, and a ``gcm`` seal's tag rides back on
        the response — AEAD traffic gets the SAME affinity placement
        and bit-exact failover as ctr (every mode's dispatch is a pure
        function of its arrays, so replay on the next ring node is
        byte-identical)."""
        if mode == "rc4":
            # Session data chunk (serve/session.py): pinned-backend
            # routing with its own admission accounting — the loadgen-
            # compatible surface, same as the server's submit.
            return await self.submit_session(tenant, sid, payload,
                                             deadline_s=deadline_s)
        if self._draining:
            return Response(ok=False, error=ERR_SHUTDOWN,
                            detail="router is draining")
        self.accepted += 1
        self._inflight += 1
        self._idle.clear()
        try:
            data = (payload.tobytes() if hasattr(payload, "tobytes")
                    else bytes(payload))
            if (self.transfers is not None and data
                    and len(data) % 16 == 0
                    and len(data) // 16 > self.transfers.chunk_blocks):
                # Oversized: ONE accepted/answered request whose chunks
                # spray across the replica ring (serve/transfer.py) —
                # gcm lands here too, for the engine's typed refusal.
                resp = await self.transfers.run(
                    tenant, bytes(key), bytes(nonce),
                    np.frombuffer(data, np.uint8), mode=str(mode),
                    iv=bytes(iv), deadline_s=deadline_s)
            else:
                resp = await self._route(tenant, bytes(key), bytes(nonce),
                                         payload, deadline_s, str(mode),
                                         bytes(iv), bytes(aad), bytes(tag))
        except Exception as e:  # noqa: BLE001 - a router must always answer
            resp = Response(ok=False, error=ERR_DISPATCH,
                            detail=f"{type(e).__name__}: {e}")
        finally:
            self.answered += 1
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.set()
        return resp

    async def submit_transfer(self, tenant: str, key: bytes, nonce: bytes,
                              payload, deadline_s: float | None = None,
                              mode: str = "ctr", iv: bytes = b"",
                              resume_token: str | None = None,
                              tails: dict | None = None,
                              on_chunk=None) -> Response:
        """The explicit chunked-transfer entry (what ``submit`` takes
        automatically for oversized payloads), with the resumable
        streaming hooks exposed — the serve frontend's ``tx``
        sub-protocol shape, one fault domain up."""
        if self.transfers is None:
            return Response(ok=False, error=ERR_DISPATCH,
                            detail="transfers disabled on this router "
                                   "(no transfer_chunk_blocks)")
        if self._draining:
            return Response(ok=False, error=ERR_SHUTDOWN,
                            detail="router is draining")
        self.accepted += 1
        self._inflight += 1
        self._idle.clear()
        try:
            resp = await self.transfers.run(
                tenant, bytes(key), bytes(nonce), payload, mode=str(mode),
                iv=bytes(iv), deadline_s=deadline_s,
                resume_token=resume_token, tails=tails, on_chunk=on_chunk)
        except Exception as e:  # noqa: BLE001 - a router must always answer
            resp = Response(ok=False, error=ERR_DISPATCH,
                            detail=f"{type(e).__name__}: {e}")
        finally:
            self.answered += 1
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.set()
        return resp

    async def _transfer_chunk(self, tenant: str, key: bytes,
                              spec, piece, *, mode: str,
                              deadline_s: float | None, sampled: bool,
                              parent: str | None) -> Response:
        """The transfer engine's submit seam at router level: one chunk
        = one ordinary ring dispatch. ``rotate=spec.index`` starts each
        chunk's attempt order one replica further around the key's ring
        sequence — chunks keep the key's affinity (same replica SET)
        while spraying across the backends, so a 16-chunk transfer is
        never serialized behind one backend's queue and a single
        backend's death costs only the chunks in flight there."""
        data = (piece.tobytes() if hasattr(piece, "tobytes")
                else bytes(piece))
        return await self._route_attempts(
            tenant, key, spec.nonce or b"", data, deadline_s,
            bool(sampled), parent, mode, spec.iv, b"", b"",
            rotate=spec.index)

    # -- stateful sessions -------------------------------------------------
    def session_order(self, tenant: str, sid: int) -> list[str]:
        """A session's replica sequence: the ring order for the
        session's OWN affinity key (tenant + sid — sessions carry no
        shared placement key, and one tenant's sessions should spread
        across its replica set). UN-rotated, unlike transfer chunk
        spray: session frames need the ONE backend holding the state,
        not load spreading."""
        return self._order_for(
            ring_mod.affinity_key(tenant, f"ss:{int(sid)}".encode()))

    async def _session_exchange(self, name: str, header: dict,
                                payload: bytes,
                                deadline_s: float | None) -> tuple:
        """One ``ss`` frame exchange with one NAMED backend; returns
        (response header, body) or raises like any backend contact."""
        c = self.config
        b = self.backends.get(name)
        if b is None:
            raise ConnectionError(f"backend {name!r} left the fleet")
        attempt_s = min(c.attempt_timeout_s,
                        float(deadline_s) if deadline_s else
                        c.attempt_timeout_s)
        return await b.exchange(header, payload, attempt_s)

    async def open_session(self, tenant: str, sid: int, key: bytes,
                           deadline_s: float | None = None) -> Response:
        """Open an rc4 session on the session's affinity backend and
        PIN it there: every later frame of the session goes to the
        backend that ran the KSA and holds the carry state. A replica
        that sheds or fails at open costs nothing (no state was made) —
        the open walks the replica sequence like an ordinary request."""
        if self._draining:
            return Response(ok=False, error=ERR_SHUTDOWN,
                            detail="router is draining")
        header = {"ss": "open", "t": tenant, "sid": int(sid),
                  "k": bytes(key).hex()}
        causes = []
        for name in self.session_order(tenant, sid):
            b = self.backends[name]
            if b.health.state == QUARANTINED:
                continue
            try:
                rh, _body = await self._session_exchange(
                    name, header, b"", deadline_s)
            except Exception as e:  # noqa: BLE001 - walk the replicas
                causes.append((name, e))
                continue
            if rh.get("ok"):
                self._session_pins[(tenant, int(sid))] = name
                self.sessions_opened += 1
                metrics.counter("route_session", outcome="opened")
                return Response(ok=True, detail=str(rh.get("detail", "")))
            if rh.get("error") in (ERR_SHED, ERR_SHUTDOWN):
                causes.append((name, RuntimeError(rh.get("error"))))
                continue  # busy/draining replica: the next may admit
            return Response(ok=False, error=rh.get("error"),
                            detail=str(rh.get("detail", "")))
        metrics.counter("route_session", outcome="open-failed")
        return Response(ok=False, error=ERR_DISPATCH,
                        detail=f"session open failed on every replica "
                               f"({len(causes)} attempt(s))")

    async def submit_session(self, tenant: str, sid: int, payload,
                             deadline_s: float | None = None) -> Response:
        """One session data chunk to the session's PINNED backend. No
        cross-backend failover: the PRGA carry lives only where open
        landed, so a dead pinned backend is a typed error and the
        client's move is close + reopen (in-PROCESS lane failover on
        that backend is where bit-exact keystream replay happens —
        docs/SERVING.md). Counted in accepted/answered like every
        routed request."""
        pin = self._session_pins.get((tenant, int(sid)))
        if pin is None:
            return Response(ok=False, error=ERR_BAD_REQUEST,
                            detail=f"session {sid} is not open via this "
                                   f"router")
        if self._draining:
            return Response(ok=False, error=ERR_SHUTDOWN,
                            detail="router is draining")
        self.accepted += 1
        self._inflight += 1
        self._idle.clear()
        try:
            data = (payload.tobytes() if hasattr(payload, "tobytes")
                    else bytes(payload))
            header = {"ss": "data", "t": tenant, "sid": int(sid)}
            if deadline_s is not None:
                header["deadline_s"] = round(float(deadline_s), 3)
            try:
                rh, body = await self._session_exchange(
                    pin, header, data, deadline_s)
            except Exception as e:  # noqa: BLE001 - typed, no failover
                self.session_pin_misses += 1
                metrics.counter("route_session", outcome="pin-miss")
                return Response(
                    ok=False, error=ERR_DISPATCH,
                    detail=f"session backend {pin!r} unreachable "
                           f"({type(e).__name__}: {e}); close and "
                           f"reopen the session")
            if rh.get("ok"):
                self.session_chunks += 1
                metrics.counter("route_session", outcome="chunk")
                return Response(ok=True,
                                payload=np.frombuffer(body, np.uint8),
                                batch=rh.get("batch"))
            return Response(ok=False, error=rh.get("error"),
                            detail=str(rh.get("detail", "")),
                            batch=rh.get("batch"))
        finally:
            self.answered += 1
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.set()

    async def close_session(self, tenant: str, sid: int,
                            deadline_s: float | None = None) -> Response:
        """Close an rc4 session on its pinned backend and drop the pin
        (dropped EITHER way — a close that failed because the backend
        died releases the router-side pin too; the backend's own drain
        force-closes its rows)."""
        pin = self._session_pins.pop((tenant, int(sid)), None)
        if pin is None:
            return Response(ok=False, error=ERR_BAD_REQUEST,
                            detail=f"session {sid} is not open via this "
                                   f"router")
        header = {"ss": "close", "t": tenant, "sid": int(sid)}
        try:
            rh, _body = await self._session_exchange(
                pin, header, b"", deadline_s)
        except Exception as e:  # noqa: BLE001 - pin already dropped
            metrics.counter("route_session", outcome="close-failed")
            return Response(ok=False, error=ERR_DISPATCH,
                            detail=f"{type(e).__name__}: {e}")
        self.sessions_closed += 1
        metrics.counter("route_session", outcome="closed")
        if rh.get("ok"):
            return Response(ok=True, detail=str(rh.get("detail", "")))
        return Response(ok=False, error=rh.get("error"),
                        detail=str(rh.get("detail", "")))

    async def _route(self, tenant: str, key: bytes, nonce: bytes, payload,
                     deadline_s: float | None, mode: str = "ctr",
                     iv: bytes = b"", aad: bytes = b"",
                     tag: bytes = b"") -> Response:
        """The per-request wrapper: one head-sampling decision at ROUTER
        admission governs the whole cross-process chain, and the
        ``route-request`` span minted here is the chain's ROOT — its id
        travels over the wire ("ps") so the backend's ``request-queued``
        span chains under it, which is what lets ``obs.report`` join one
        request's story across processes."""
        data = (payload.tobytes() if hasattr(payload, "tobytes")
                else bytes(payload))
        sampled = trace.sample()
        cm = trace.maybe_span(sampled, "route-request", tenant=tenant,
                              blocks=len(data) // 16)
        span = cm.__enter__()
        try:
            resp = await self._route_attempts(
                tenant, key, nonce, data, deadline_s, sampled,
                span.id if span is not None else None,
                mode, iv, aad, tag)
        except BaseException as e:
            cm.__exit__(type(e), e, None)
            raise
        if resp.ledger is not None:
            cm.note(total_us=resp.ledger.get("total_us"),
                    complete=resp.ledger.get("complete"))
        cm.__exit__(None, None, None)
        return resp

    async def _route_attempts(self, tenant: str, key: bytes, nonce: bytes,
                              data: bytes, deadline_s: float | None,
                              sampled: bool, ps: str | None,
                              mode: str = "ctr", iv: bytes = b"",
                              aad: bytes = b"", tag: bytes = b"",
                              rotate: int = 0) -> Response:
        c = self.config
        aff = ring_mod.affinity_key(tenant, key)
        self._track(aff)
        budget = Budget(c.deadline_s if deadline_s is None
                        else float(deadline_s), clock=self._clock)
        header = {"t": tenant, "k": key.hex(), "n": nonce.hex(),
                  "deadline_s": round(budget.total_s, 3) or None}
        if mode != "ctr":
            # The AEAD wire fields (serve/wire.py): absent = ctr, so a
            # ctr-only fleet's frames are byte-identical to pre-AEAD.
            header["m"] = mode
            if iv:
                header["iv"] = iv.hex()
            if aad:
                header["a"] = aad.hex()
            if tag:
                header["tg"] = tag.hex()
        if sampled:
            # Propagate the admission decision + span parentage + the
            # ledger request over the wire (serve/wire.py): the
            # backend's spans and its per-request time-attribution
            # ledger join THIS request's story.
            header["sm"] = True
            header["lg"] = True
            if ps:
                header["ps"] = ps
        else:
            header["sm"] = False
        label = aff[-6:]
        t_admit = self._clock()
        t_first: float | None = None
        order = self._order_for(aff)
        if rotate and order:
            # Chunk spray (serve/transfer.py riders): start this
            # chunk's attempt order ``rotate`` replicas around the
            # key's ring sequence — same affinity replica set, load
            # spread across it; failover still walks every member.
            r = rotate % len(order)
            order = order[r:] + order[:r]
        primary = order[0] if order else None
        causes: list = []
        tried: set[str] = set()
        sheds = 0
        while True:
            name = self._pick(order, tried)
            if name is None:
                b = await self._rescue(order, tried)
                if b is None:
                    if sheds and len(causes) == 0:
                        # Every placeable backend SHED (no failures):
                        # propagate the backpressure — shed at the
                        # router, stamped like every other demotion.
                        self.router_sheds += 1
                        metrics.counter("route_shed")
                        degrade.degrade(
                            "route->shed",
                            "every placeable backend shed; shedding at "
                            "the router")
                        return Response(
                            ok=False, error=ERR_SHED,
                            detail="all backends shedding")
                    e = BackendsExhausted(label, causes)
                    metrics.counter("route_exhausted")
                    return Response(
                        ok=False,
                        error=(ERR_DEADLINE if e.timed_out or
                               budget.exhausted() else ERR_DISPATCH),
                        detail=str(e))
                name = b.spec.name
            b = self.backends[name]
            if budget.exhausted():
                causes.append((b.idx, asyncio.TimeoutError(
                    f"request budget {budget.total_s:.3f}s exhausted")))
                metrics.counter("route_exhausted")
                return Response(ok=False, error=ERR_DEADLINE,
                                detail=f"budget spent after "
                                       f"{len(tried)} attempt(s)")
            attempt_s = min(c.attempt_timeout_s, budget.remaining())
            redispatch = bool(tried)
            # A redispatch is an incident: force-sample it (the serve
            # rule) — first attempts of unsampled requests ride a
            # deferred span, free when they complete clean.
            cm = trace.maybe_span(sampled or redispatch, "route-dispatch",
                                  parent=ps,
                                  backend=b.idx, bucket=len(data) // 16,
                                  redispatch=redispatch)
            cm.__enter__()
            t0 = self._clock()
            if t_first is None:
                # Router-queue stage closes at the FIRST attempt:
                # placement, tracking, and any pre-attempt rescue work
                # are what this request waited on inside the router.
                t_first = t0
                metrics.observe("route_stage_us",
                                (t_first - t_admit) * 1e6,
                                stage="router_queue",
                                exemplar=({"span": ps,
                                           "trace": trace.run_id(),
                                           "backend": b.idx}
                                          if ps else None))
            outcome = "ok"
            try:
                faults.check_backend("backend_fail", b.idx, label)
                if faults.fire_backend("backend_hang", b.idx):
                    # The injected wedged backend: an AWAITABLE sleep
                    # (the router is an event loop — a blocking sleep
                    # would hang every rider, not just this one), cut
                    # down by the attempt deadline exactly like a real
                    # backend that stopped answering.
                    trace.point("fault-hang", backend=b.idx)
                    await asyncio.wait_for(asyncio.sleep(attempt_s + 60.0),
                                           timeout=attempt_s)
                rh, body = await b.exchange(header, data, attempt_s)
            except asyncio.TimeoutError as e:
                # The exchange never ended: the span is ABANDONED, not
                # closed — its orphaned begin is the kill evidence
                # (obs.report --check --expected-orphans route-dispatch).
                cm.force()
                outcome = "timeout"
                b.timeouts += 1
                metrics.counter("route_backend_timeout", backend=b.idx)
                trace.counter("route_backend_timeout", backend=b.idx)
                b.health.note_timeout()
                causes.append((b.idx, e))
                tried.add(name)
                continue
            except Exception as e:  # noqa: BLE001 - fail over, then contain
                cm.__exit__(type(e), e, None)
                outcome = "failed"
                b.failures += 1
                metrics.counter("route_backend_failed", backend=b.idx)
                trace.counter("route_backend_failed", backend=b.idx)
                b.health.note_failure(e)
                causes.append((b.idx, e))
                tried.add(name)
                continue
            finally:
                dt_us = int((self._clock() - t0) * 1e6)
                metrics.observe("route_dispatch_us", dt_us,
                                backend=b.idx, outcome=outcome)
            t_att_end = self._clock()
            cm.__exit__(None, None, None)
            err = rh.get("error")
            if not rh.get("ok") and err == ERR_SHED:
                # Backpressure, not failure: the backend is healthy and
                # full. Back off, then try the next replica; health is
                # untouched (shedding a request is the queue doing its
                # job, and suspecting it would turn overload into
                # flapping).
                b.sheds_seen += 1
                sheds += 1
                self.shed_retries += 1
                metrics.counter("route_shed_retry", backend=b.idx)
                trace.counter("route_shed_retry", backend=b.idx)
                tried.add(name)
                await asyncio.sleep(
                    min(c.shed_backoff_s * (2 ** (sheds - 1)),
                        max(budget.remaining(), 0.0)))
                continue
            if not rh.get("ok") and err == ERR_SHUTDOWN:
                # The backend is draining: non-punitive removal from
                # placement (gossip will confirm), fail over.
                b.health.note_gossip("draining")
                causes.append((b.idx, ConnectionError("backend draining")))
                tried.add(name)
                continue
            # A definitive answer (payload or a request-level error like
            # bad-request/too-large/deadline): the rider gets it as-is —
            # re-dispatching a malformed request elsewhere would only
            # repeat the refusal.
            b.dispatches += 1
            b.health.note_success()
            if redispatch:
                b.redispatches_in += 1
                self.redispatches += 1
                metrics.counter("route_redispatch", backend=b.idx)
                trace.counter("route_redispatch", backend=b.idx,
                              after=len(tried))
            ledger = self._build_ledger(sampled, rh, b.idx, t_admit,
                                        t_first, t0, t_att_end, ps=ps)
            if rh.get("ok"):
                self.routed_ok += 1
                b.bytes_out += len(body)
                if name == primary:
                    self.affinity_hits += 1
                    metrics.counter("route_affinity", outcome="hit")
                else:
                    self.affinity_misses += 1
                    metrics.counter("route_affinity", outcome="miss")
                tg = rh.get("tg")
                try:
                    resp_tag = (bytes.fromhex(str(tg))
                                if isinstance(tg, str) and tg else None)
                except ValueError:
                    resp_tag = None
                return Response(ok=True,
                                payload=np.frombuffer(body, np.uint8),
                                batch=rh.get("batch"), ledger=ledger,
                                tag=resp_tag)
            return Response(ok=False, error=err,
                            detail=str(rh.get("detail", "")),
                            batch=rh.get("batch"), ledger=ledger)

    def _build_ledger(self, sampled: bool, rh: dict, backend: int,
                      t_admit: float, t_first: float,
                      t0: float, t_att_end: float,
                      ps: str | None = None) -> dict | None:
        """The request's cross-process time-attribution ledger (µs),
        assembled at answer time for SAMPLED requests: the router's own
        stages — ``router_queue`` (admission -> first attempt),
        ``retry`` (first attempt -> final attempt: failed walls, shed
        backoffs, rescue probes; 0 on the healthy path), ``wire``
        (final attempt wall minus the backend's measured residency:
        connect + frames both ways) — merged with the backend's stages
        shipped back in the response ("lg": backend_queue, pack,
        worker_wait, dispatch, device, reply). Stages are contiguous
        and disjoint by construction, so their sum tracks the router's
        measured end-to-end latency — ``route.bench`` gates the sum
        within tolerance and the fleet report renders the waterfall.
        ``complete`` says whether the backend half actually arrived."""
        if not sampled:
            return None
        att_wall = int((t_att_end - t0) * 1e6)
        stages = {"router_queue": int((t_first - t_admit) * 1e6),
                  "retry": int((t0 - t_first) * 1e6)}
        lg = rh.get("lg")
        complete = (isinstance(lg, dict)
                    and isinstance(lg.get("stages"), dict))
        if complete:
            backend_total = int(lg.get("total_us", 0))
            stages["wire"] = max(att_wall - backend_total, 0)
            for name, v in lg["stages"].items():
                stages[str(name)] = int(v)
        else:
            stages["wire"] = att_wall
        # The wire/retry stages carry a tail exemplar pointing at this
        # request's route-request root span: the slowest wire crossing
        # in the histogram resolves to one concrete request's full
        # cross-process chain (the exemplar -> trace walk-through,
        # docs/OBSERVABILITY.md).
        ex = ({"span": ps, "trace": trace.run_id(), "backend": backend}
              if ps else None)
        metrics.observe("route_stage_us", stages["wire"], stage="wire",
                        exemplar=ex)
        if stages["retry"]:
            metrics.observe("route_stage_us", stages["retry"],
                            stage="retry", exemplar=ex)
        # total closes at the exchange end — the boundary the stages
        # cover. The router's post-answer bookkeeping (span write,
        # counters) happens after every stage clock stopped; folding it
        # into total but no stage would charge the ledger a phantom
        # residue on every small request.
        return {"stages": stages,
                "total_us": int((t_att_end - t_admit) * 1e6),
                "complete": complete, "backend": backend}

    def _pick(self, order: list[str], tried: set[str]) -> str | None:
        """The next untried PLACEABLE backend in the request's order
        (None when none remain — the rescue/exhaustion path)."""
        for name in order:
            if name in tried:
                continue
            b = self.backends.get(name)
            if b is not None and b.health.placeable():
                return name
        return None

    async def _rescue(self, order: list[str], tried: set[str]):
        """Last resort when no placeable backend remains: canary the
        quarantined ones in ring order rather than fail the request — a
        single-backend deployment recovering from a transient hang
        re-proves itself here instead of answering errors forever."""
        for name in order:
            if name in tried:
                continue
            b = self.backends.get(name)
            if b is None or b.health.state != QUARANTINED:
                continue
            if await self._probe_quarantined(b):
                return b
        return None

    # -- introspection -----------------------------------------------------
    def quarantine_events(self) -> int:
        return sum(1 for b in self.backends.values()
                   for t in b.health.transitions if t["to"] == QUARANTINED)

    def release_events(self) -> int:
        return sum(1 for b in self.backends.values()
                   for t in b.health.transitions if t["to"] == RELEASED)

    def affinity_ratio(self) -> float:
        total = self.affinity_hits + self.affinity_misses
        return round(self.affinity_hits / total, 4) if total else 0.0

    def stats(self) -> dict:
        return {
            "backends": {name: b.stats()
                         for name, b in sorted(self.backends.items())},
            "ring": {"members": list(self.ring.members()),
                     "vnodes": self.config.vnodes,
                     "changes": self.ring_changes},
            "affinity": {"enabled": self.config.affinity,
                         "hits": self.affinity_hits,
                         "misses": self.affinity_misses,
                         "ratio": self.affinity_ratio()},
            "accepted": self.accepted, "answered": self.answered,
            "lost": self.accepted - self.answered,
            "routed_ok": self.routed_ok,
            "redispatches": self.redispatches,
            "shed_retries": self.shed_retries,
            "router_sheds": self.router_sheds,
            "pool_retired": dict(self.pool_retired),
            "quarantine_events": self.quarantine_events(),
            "transfers": (self.transfers.stats()
                          if self.transfers is not None else None),
            "sessions": {"opened": self.sessions_opened,
                         "closed": self.sessions_closed,
                         "chunks": self.session_chunks,
                         "pinned": len(self._session_pins),
                         "pin_misses": self.session_pin_misses},
        }
