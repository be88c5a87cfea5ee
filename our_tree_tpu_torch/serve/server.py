"""The serve dispatch loop: queue -> shape buckets -> in-flight lanes.

Port of ``our_tree_tpu.serve.server`` for every served mode (``ctr``, ``gcm``,
``gcm-open``, ``cbc`` and ``rc4``; ``ServerConfig.modes``, ``ctr`` by
default). One asyncio loop on the main thread owns admission and batch
formation; dispatch is overlapped. Request coroutines ``submit`` into the
bounded queue; the loop drains, rung-packs up to K key groups per batch
(``batcher``) and submits each batch as its own task, so batches keep forming
while up to ``max_inflight`` dispatches (default one per lane) run on the
lanes' worker threads. The engine comes from ``aes.resolve_serve_engine``: the
CUDA kernels on a card; on the CPU the native C tier (``native``: ``ctr`` in
C, each batch's counters made in C from its request layout, the other modes
on the plain versions), or the plain version where the C tier cannot
build.

Failure containment, per batch: a failing dispatch retries on its lane
(``RetryPolicy``); a lane that still fails, or hangs past its watchdog
deadline, degrades (suspect, then quarantined; a timeout quarantines at
once) and the batch is re-dispatched bit-exactly on another lane before any
rider sees an error. Only when every lane was tried (``LanesExhausted``)
do the riders get errors (``deadline`` if the last cause was a hang, else
``dispatch-failed``), and the server keeps serving. With
``ServerConfig.journal`` the lanes' quarantines persist: the server opens a
``resilience.journal.SweepJournal`` (config ``{"kind": "serve-lanes",
...}``) at start, lanes with failure rows start quarantined, each new
quarantine appends a row, and ``serve.bench --unquarantine lane:<i>``
clears them (``clear_failures``, the same release edit as the sweep
harness's).

Shutdown drains: ``stop()`` closes admission, dispatches everything
accepted, awaits every in-flight batch and flushes; ``queue.stats()["lost"]``
(accepted minus answered) stays 0.

Modes: a batch is one mode (the batcher never mixes them). ``ctr`` batches
go to the multi-key CTR seam (the ``ctr_mk`` kernel on the card), ``cbc``
batches, parallel CBC decrypt, to the multi-key CBC seam with the stack's
decrypt schedules (``cbc_mk``), ``gcm`` (seal) and ``gcm-open`` batches to
the GCM seam ``aead.gcm.gcm_crypt_ghash_words`` with each request's last
data row named (``ctr_mk``, then ``ghash_at``). The GCM finisher
(``_gcm_finish``) reads each request's E_K(J0) off its J0 row and its
GHASH state off its named row, folds the length block on the host and, for
an open, compares tags in constant time (``aead.ghash.np_tag_eq``; the
``tag_mismatch`` fault point forces a mismatch). A mismatch fails that
request only, ``auth-failed``, counted in ``serve_auth_failed{mode}``, and
no plaintext leaves the server for it; the batch's other riders are
answered. A seal's ``Response`` carries its tag. Admission refuses a mode
the server did not enable; an unknown mode raises at construction.

``rc4``, the session mode (``serve/session.py``): with ``rc4`` enabled the
server builds a ``SessionManager``. ``open_session`` runs the host KSA and
prefills a window of keystream; a data chunk (``submit(..., mode="rc4",
sid=...)``) reserves its keystream slice, rides the queue and batcher as an
ordinary schedule-free request (the XOR on the lane) and acks its offset on
any final answer; ``close_session`` releases the session. The store's
refills go through ``pool.dispatch(mode="rc4-prep")`` (``_session_prep``),
so a hung lane's refill is replayed from the same carry on another lane,
and the attempts come back as the store's replay count. ``stop`` drains the
store after the batcher.

The zero-recompile contract: the JAX package counts XLA compiles; the port
counts builds and loads of the kernel library (``runtime.cuda_build``) plus
the first call of each serve seam for each (engine, nr, device)
(``aes.seam_first_calls``: on the card, the first launch of a ``ctr_mk`` or
``cbc_mk`` NR instantiation, of ``ghash_at`` or of ``arc4_prga``, which
CUDA loads lazily, or of the rc4 XOR). Warmup runs every
rung once on every lane's worker thread for each key length in
``warmup_key_bits``, the ``ctr`` ladder (the canary's) and then every other
enabled AES mode's (a GCM rung with zero words, every keep 1 and its last row
named, so that ``ghash_at`` launches too), then with ``rc4`` the XOR at
every rung and one ``rc4-prep`` at the prefetch shape (slots x quantum),
which makes the thread's CUDA
context current, loads the library and launches each mode's kernels at each
warmed nr, so the first served batch pays none of that; ``steady_compiles()`` must stay 0 after
it. A key length outside
``warmup_key_bits`` (only 128 bits by default, as in the reference) pays
its instantiation's first launch on its first batch, and the steady count
shows it. ``pool.first_dispatch`` records the first traffic dispatch's
times, so a run can set them beside the steady ones. Lanes warm trusted
first: a lane adopted quarantined from the journal never pins the canary.

Chunked transfers (``serve/transfer.py``): a payload above the top rung is
split into chunks of ``transfer_chunk_blocks`` (the top rung by default),
each one ordinary queue admission (``_transfer_chunk``), so chunks batch,
fail over and meet the zero-build gate like any request; the spliced answer
equals one giant dispatch's. ``submit_transfer`` is the explicit entry with
the wire front end's resume hooks. Only ``ctr`` and ``cbc`` are chunkable:
an oversized GCM request answers ``transfer-unsupported``. With
``transfer_chunk_blocks=0``, or above ``transfer_max_bytes``, an oversized
payload answers ``too-large``.

Cost model: at ``start()`` the server builds the analytic cost records of
its warmed ladder (``obs/costmodel.py``: each enabled mode, every rung, each
key length of ``warmup_key_bits``) into ``cost_records`` and stamps them,
with ``ServerConfig.ceiling_gbps``, into the ``OT_TRACE_DIR`` run layout,
and hands them to the incident recorder (``obs/incident.py``), which also
hears of every auth failure (``incident.note_auth_failure``; a spike dumps a
bundle). ``ServerConfig.status_port`` starts the status endpoint
(``serve/status.py``: ``/metrics``, ``/healthz``, ``/incidentz``,
``/profilez``). ``rc4`` has no cost rows (its XOR is key-oblivious: no
(bits, nr) row exists for it).

Compile cost and pulse: each build or load of the kernel library and each
seam's first call is timed (``runtime/monitoring.py``) into
``serve_compile_us{engine, rung}``, the warmup walk naming the rung it is
on (``compile_context``) and everything outside the walk ``rung=0``, as a
steady recompile is in the reference. After warmup the server starts the
live pulse engine (``obs/pulse.py``: alerts, the capacity model;
``self.pulse``, None with ``OT_PULSE=0``) and ``stop()`` stops and joins
its thread.

Obs spans: ``request-queued`` (queue), ``batch-formed``, ``lane-dispatch``,
``lane-probe``, ``serve-warmup`` / ``lane-warmup``, ``transfer`` /
``transfer-chunk``, ``session-open``, ``keystream-prefetch``.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass

import numpy as np

from ..aead import gcm as aead_gcm
from ..aead import ghash as aead_ghash
from ..models import aes
from ..obs import costmodel, incident, metrics, pulse, trace
from ..ops import gf
from ..resilience import faults, watchdog
from ..resilience import journal as journal_mod
from ..runtime import cuda_build, monitoring
from ..utils import packing
from . import batcher, lanes, transfer
from . import session as session_mod
from .keycache import KeyCache, key_digest
from .queue import (ERR_AUTH, ERR_BAD_REQUEST, ERR_DEADLINE, ERR_DISPATCH, ERR_TOO_LARGE,
                    GCM_MODES, RequestQueue, Response, unknown_modes)
from .status import StatusServer


#: Seconds ``stop()`` waits for the pulse thread to end (a tick is a
#: registry snapshot and some arithmetic).
PULSE_JOIN_S = 10.0

#: What the process is building for: the warmup walk names (engine, rung)
#: before each lane call, so a library load or a seam's first call lands in
#: ``serve_compile_us{engine, rung}``; rung 0 is outside the walk.
_COMPILE_CTX = {"engine": "?", "rung": 0}


def compile_context(engine: str, rung: int) -> None:
    """Label the build events that follow (the warmup walk's seam)."""
    _COMPILE_CTX["engine"] = str(engine)
    _COMPILE_CTX["rung"] = int(rung)


def _on_event(name: str, seconds: float) -> None:
    if name in (monitoring.LIBRARY_LOAD, monitoring.SEAM_FIRST_CALL):
        metrics.observe("serve_compile_us", float(seconds) * 1e6,
                        engine=_COMPILE_CTX["engine"], rung=_COMPILE_CTX["rung"])


monitoring.register_event_duration_listener(_on_event)


def compile_count() -> int:
    """Kernel-library builds and loads plus first seam calls per (engine,
    nr, device) in this process (callers difference two readings): the
    port's counterpart of the JAX compile counter."""
    return cuda_build.load_count() + aes.seam_first_calls()


@dataclass
class ServerConfig:
    #: the device the server runs on: ``"cuda"`` (raises at ``start()``
    #: without a card) or ``"cpu"`` (the plain version)
    device: str = "cuda"
    #: through ``aes.resolve_serve_engine``: "auto" is the CUDA kernels on a
    #: card and the native C tier on the CPU (the plain version where it
    #: cannot build); "native" pins the C tier and raises where it cannot
    #: build; any other name pins that engine
    engine: str = "auto"
    min_bucket_blocks: int = batcher.DEFAULT_MIN_BLOCKS
    max_bucket_blocks: int = batcher.DEFAULT_MAX_BLOCKS
    #: the fixed K dimension: key slots per dispatch
    key_slots: int = batcher.DEFAULT_KEY_SLOTS
    #: native-tier ECB threads a slot run (0 = one per 256 KiB)
    native_threads: int = 0
    max_depth: int = 1024
    #: one tenant's max share of the queue depth (1.0 = no per-tenant cap)
    tenant_depth_frac: float = 1.0
    #: tenants shed first past ``priority_depth_frac * max_depth``
    low_priority_tenants: tuple = ()
    priority_depth_frac: float = 0.5
    #: per-request residency deadline (admission -> response)
    request_deadline_s: float = 30.0
    #: watchdog deadline around each lane's engine call; None = the global
    #: OT_DISPATCH_DEADLINE default (0/unset disarms)
    dispatch_deadline_s: float | None = None
    #: RetryPolicy attempts per batch per lane (1 = no on-lane retry)
    retries: int = 2
    keycache_per_tenant: int = 8
    #: key lengths (bits) warmed per rung
    warmup_key_bits: tuple = (128,)
    #: the enabled served modes, from ``queue.MODES`` (``ctr``, ``gcm``,
    #: ``gcm-open``, ``cbc``, ``rc4``): warmup walks each one's ladder on
    #: every lane and admission refuses the others
    modes: tuple = ("ctr",)
    #: dispatch lanes: None = one per visible card; more share cards
    lanes: int | None = None
    #: canary-probe quarantined lanes every N batches
    probe_every: int = 8
    #: clean batches a released lane serves before leaving probation
    probation_batches: int = 2
    #: the serve journal's path (quarantines persist, ``--unquarantine``
    #: releases them); None = health in memory only
    journal: str | None = None
    #: dispatches in flight at once; None = one per lane
    max_inflight: int | None = None
    #: the measured ceiling (GB/s of modeled traffic, ``chip_smoke.py`` derives
    #: the card's from ``harness/ceiling.py``'s rates) the cost model reports
    #: utilization against; None records traffic without a utilization
    ceiling_gbps: float | None = None
    #: the status endpoint (``serve/status.py``): None = off, 0 = an
    #: ephemeral port (``server.status.port``)
    status_port: int | None = None
    #: chunked transfers (``serve/transfer.py``): payloads above the top rung
    #: split into chunks of this many blocks; None = the top rung, 0 = off
    #: (such payloads answer ``too-large``)
    transfer_chunk_blocks: int | None = None
    #: concurrent transfers admitted before new ones shed
    max_transfers: int = 8
    #: chunks in flight a transfer
    transfer_window: int = 8
    #: reassembly-buffer bytes past which NEW transfers shed
    transfer_budget_bytes: int = 64 << 20
    #: a transfer's payload ceiling (a declared total above it answers
    #: ``too-large`` before any buffer is sized from it)
    transfer_max_bytes: int = 1 << 30
    #: a transfer's wall deadline
    transfer_deadline_s: float = 300.0
    #: the transfer ledger's journal path (resume tokens outlive the
    #: process); None = in memory
    transfer_ledger: str | None = None
    #: rc4 sessions (``serve/session.py``; with ``rc4`` in ``modes``): open
    #: sessions a tenant before the store evicts that tenant's idle rows
    session_per_tenant: int = 16
    #: keystream kept ahead of each session's consumed offset (bytes)
    session_window_bytes: int = 65536
    #: PRGA bytes a session per refill dispatch (a multiple of 4): the fixed
    #: prefetch shape
    session_quantum_bytes: int = 4096
    #: sessions stacked into one refill dispatch (the fixed S axis)
    session_prefetch_slots: int = 8
    #: keystream bytes held across sessions: at the cap non-urgent refills
    #: pause and new opens shed
    session_budget_bytes: int = 8 << 20


class Server:
    """The online crypto service over the port's engines."""

    def __init__(self, config: ServerConfig | None = None):
        self.config = config or ServerConfig()
        c = self.config
        self.rungs = batcher.bucket_ladder(c.min_bucket_blocks, c.max_bucket_blocks)
        why = unknown_modes(tuple(c.modes))
        if why is not None:
            raise ValueError(why)
        self.queue = RequestQueue(max_depth=c.max_depth, max_request_blocks=self.rungs[-1],
                                  default_deadline_s=c.request_deadline_s,
                                  tenant_depth_frac=c.tenant_depth_frac,
                                  low_priority_tenants=c.low_priority_tenants,
                                  priority_depth_frac=c.priority_depth_frac, modes=c.modes)
        self.keycache = KeyCache(per_tenant=c.keycache_per_tenant)
        self.engine: str | None = None
        self.device = None
        self.pool: lanes.LanePool | None = None
        self._deadline_s = (watchdog.default_deadline_s() if c.dispatch_deadline_s is None
                            else max(float(c.dispatch_deadline_s), 0.0))
        self._journal = None
        self._task: asyncio.Task | None = None
        self._running = False
        self.inflight_limit = 0
        self._sem: asyncio.Semaphore | None = None
        self._tasks: set = set()
        self.batches = 0
        self.batches_failed = 0
        self.batches_timed_out = 0
        self._occupancy: dict[int, dict] = {}
        self._payload_blocks = 0
        self._dispatched_blocks = 0
        self._slots_used = 0
        self._slot_capacity = 0
        self.warmup_compiles = 0
        self._compiles_at_ready = 0
        self.cost_records: list[dict] = []
        self.status: StatusServer | None = None
        #: the live pulse thread (``obs/pulse.py``), started after warmup;
        #: None with ``OT_PULSE=0``
        self.pulse: pulse.PulseThread | None = None
        #: the chunked-transfer engine; None when disabled
        self.transfers: transfer.TransferManager | None = None
        if c.transfer_chunk_blocks != 0:
            self.transfers = transfer.TransferManager(
                self._transfer_chunk,
                chunk_blocks=min(c.transfer_chunk_blocks or self.rungs[-1], self.rungs[-1]),
                max_transfers=c.max_transfers, window=c.transfer_window,
                reassembly_budget_bytes=c.transfer_budget_bytes,
                max_payload_bytes=c.transfer_max_bytes, deadline_s=c.transfer_deadline_s,
                ledger=transfer.TransferLedger(c.transfer_ledger))
        #: the rc4 session store; None unless ``rc4`` is enabled
        self.sessions: session_mod.SessionManager | None = None
        if "rc4" in c.modes:
            self.sessions = session_mod.SessionManager(
                self._session_prep, per_tenant=c.session_per_tenant,
                window_bytes=c.session_window_bytes, quantum_bytes=c.session_quantum_bytes,
                prefetch_slots=c.session_prefetch_slots, budget_bytes=c.session_budget_bytes)

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        """Resolve the device and engine, build the lane pool, adopt the
        journal's quarantines, warm every lane x rung on the lanes' worker
        threads, start the batcher loop."""
        c = self.config
        self.device = aes.as_device(c.device)
        before = compile_count()
        self.engine = aes.resolve_serve_engine(c.engine, self.device, c.modes)
        if c.journal:
            self._journal = journal_mod.SweepJournal(
                c.journal, {"kind": "serve-lanes", "lanes": c.lanes, "engine": c.engine})
        self.pool = lanes.LanePool(engine=self.engine, device=self.device,
                                   deadline_s=self._deadline_s, retries=c.retries,
                                   lanes=c.lanes, probe_every=c.probe_every,
                                   probation_batches=c.probation_batches, journal=self._journal,
                                   native_threads=c.native_threads)
        self.pool.adopt_journal_quarantines()
        await self._warmup()
        if not any(ln.warmed for ln in self.pool.lanes):
            raise RuntimeError(f"serve warmup failed on all {len(self.pool.lanes)} lane(s): "
                               f"no lane can dispatch (engine {self.engine})")
        cost_modes = tuple(m for m in c.modes if m != "rc4") or ("ctr",)
        self.cost_records = costmodel.ladder_costs(self.engine, cost_modes, self.rungs,
                                                   key_bits=c.warmup_key_bits,
                                                   key_slots=c.key_slots)
        costmodel.write_run_records(self.cost_records, engine=self.engine,
                                    ceiling_gbps=c.ceiling_gbps)
        incident.set_cost_records(self.cost_records, device=self.device)
        self._compiles_at_ready = compile_count()
        self.warmup_compiles = self._compiles_at_ready - before
        trace.gauge("serve_warmup_compiles", self.warmup_compiles, engine=self.engine,
                    lanes=len(self.pool.lanes))
        self.inflight_limit = (len(self.pool.lanes) if c.max_inflight is None
                               else max(int(c.max_inflight), 1))
        self._sem = asyncio.Semaphore(self.inflight_limit)
        metrics.ensure_flusher()
        # After warmup, so the build ramp lies behind every frame it sees.
        self.pulse = pulse.start_live("serve", cost_records=self.cost_records,
                                      device=self.device)
        if c.status_port is not None:
            self.status = StatusServer(self, c.status_port)
            await self.status.start()
        self._running = True
        self._task = asyncio.ensure_future(self._loop())

    async def _warmup(self) -> None:
        """Run every rung of the ``ctr`` ladder, then of every other enabled
        AES mode's, once on every lane's worker thread; with ``rc4`` also the
        XOR at every rung and one ``rc4-prep`` at the prefetch shape. The
        smallest ``ctr`` rung is the canary (zero key, zero payload,
        zero-nonce counters): the first lane to warm pins the canary
        expectation and every other lane's is compared with it. Trusted
        lanes warm first, so a lane adopted quarantined from the journal is
        never the oracle. A lane whose warmup fails, hangs or mismatches
        starts quarantined and unwarmed."""
        c = self.config
        canary_rung = self.rungs[0]
        canary_words = np.zeros(4 * canary_rung, dtype=np.uint32)
        canary_ctr = packing.np_ctr_le_blocks(
            b"\x00" * 16, np.arange(canary_rung, dtype=np.uint32)).reshape(-1)
        canary_expected = None
        slot_vecs = {rung: np.zeros(rung, dtype=np.uint32) for rung in self.rungs}
        order = sorted(self.pool.lanes, key=lambda ln: (ln.state == lanes.QUARANTINED, ln.idx))
        compile_context(self.engine, 0)
        with trace.span("serve-warmup", engine=self.engine, rungs=len(self.rungs),
                        lanes=len(self.pool.lanes)):
            for lane in order:
                with trace.span("lane-warmup", lane=lane.idx, engine=self.engine):
                    try:
                        mismatch = False
                        for bits in c.warmup_key_bits:
                            sched = self.keycache.stacked([("_warmup", b"\x00" * (bits // 8))],
                                                          c.key_slots)
                            for rung in self.rungs:
                                canary = rung == canary_rung and bits == c.warmup_key_bits[0]
                                words = canary_words if canary else np.zeros(4 * rung, np.uint32)
                                ctr = canary_ctr if canary else words
                                compile_context(self.engine, rung)
                                out = await lane.run_async(
                                    lambda w=words, ct=ctr, s=sched, v=slot_vecs[rung], r=rung:
                                    lane.engine_call(w, ct, s, v, f"warmup:{r}", warmup=True))
                                if not canary:
                                    continue
                                if canary_expected is None:
                                    canary_expected = out
                                    self.pool.set_canary(canary_words, canary_ctr, sched,
                                                         slot_vecs[canary_rung], out,
                                                         canary_rung)
                                elif not np.array_equal(out, canary_expected):
                                    mismatch = True
                                    break
                            if mismatch:
                                break
                            for m in c.modes:
                                if m in ("ctr", "rc4"):
                                    continue
                                sched_m = self.keycache.stacked(
                                    [("_warmup", b"\x00" * (bits // 8))], c.key_slots, mode=m)
                                for rung in self.rungs:
                                    words = np.zeros(4 * rung, np.uint32)
                                    gcm = ({"inject_words": words,
                                            "seg_keep": np.ones(rung, np.uint32),
                                            "rows": np.array([rung - 1], np.int64)}
                                           if m in GCM_MODES else {})
                                    compile_context(self.engine, rung)
                                    await lane.run_async(
                                        lambda w=words, s=sched_m, v=slot_vecs[rung], r=rung,
                                        m=m, g=gcm: lane.engine_call(
                                            w, w, s, v, f"warmup:{r}:{m}", warmup=True, mode=m,
                                            **g))
                        if "rc4" in c.modes and not mismatch:
                            # The rc4 seams are schedule-free (``sched`` None).
                            for rung in self.rungs:
                                words = np.zeros(4 * rung, np.uint32)
                                compile_context(self.engine, rung)
                                await lane.run_async(
                                    lambda w=words, v=slot_vecs[rung], r=rung: lane.engine_call(
                                        w, w, None, v, f"warmup:{r}:rc4", warmup=True,
                                        mode="rc4"))
                            slots, q = c.session_prefetch_slots, c.session_quantum_bytes
                            compile_context(self.engine, q // 16)
                            await lane.run_async(lambda: lane.engine_call(
                                np.zeros(slots * 256, np.uint32), np.zeros(2 * slots, np.uint32),
                                None, slot_vecs[self.rungs[0]], "warmup:rc4-prep", warmup=True,
                                mode="rc4-prep", prep_len=q))
                        if mismatch:
                            lane._quarantine("warmup-mismatch", self._journal)
                        else:
                            lane.warmed = True
                    except Exception as e:  # noqa: BLE001 - contain per lane
                        lane._quarantine(f"warmup-failed:{type(e).__name__}", self._journal)
        # Builds past this point (a steady first call) land at rung 0.
        compile_context(self.engine, 0)

    async def stop(self) -> None:
        """Graceful drain: close admission, let the loop finish everything
        accepted, await in-flight batches, then close."""
        self.queue.close()
        self._running = False
        self.queue.kick()
        if self._task is not None:
            await self._task
            self._task = None
        dropped = self.queue.flush()
        if dropped:
            trace.counter("serve_drain_dropped", n=dropped)
        trace.point("serve-drained", answered=self.queue.answered,
                    lost=self.queue.accepted - self.queue.answered,
                    max_inflight=self.max_inflight_seen)
        if self.status is not None:
            await self.status.stop()
            self.status = None
        if self.pulse is not None:
            # Joined as the lanes' workers are: no thread of ours outlives the
            # server. ``self.pulse`` stays, so its verdict can still be read.
            self.pulse.stop()
            await asyncio.to_thread(self.pulse.join, PULSE_JOIN_S)
        if self.pool is not None:
            # Off the loop: joining a lane's worker can take seconds.
            await asyncio.to_thread(self.pool.close)
        if self._journal is not None:
            self._journal.close()
        if self.sessions is not None:
            # After the batcher's drain no chunk still rides a session's
            # keystream: force-close the open ones (counted).
            await self.sessions.drain()
        if self.transfers is not None:
            self.transfers.ledger.close()
        metrics.flush_now()

    @property
    def max_inflight_seen(self) -> int:
        return self.pool.max_inflight_seen if self.pool is not None else 0

    def steady_compiles(self) -> int:
        """Kernel-library builds and loads, and first seam calls, since
        warmup finished."""
        return compile_count() - self._compiles_at_ready

    # -- request side ------------------------------------------------------
    async def submit(self, tenant: str, key: bytes, nonce: bytes, payload,
                     deadline_s: float | None = None, sampled: bool | None = None,
                     parent: str | None = None, priority: int | None = None,
                     mode: str = "ctr", iv: bytes = b"", aad: bytes = b"",
                     tag: bytes = b"", sid: int = -1):
        """Admit one request (``ctr`` with its nonce; ``gcm`` seal or
        ``gcm-open`` with its IV, AAD and, to open, its tag; ``cbc`` decrypt
        with its IV; ``rc4`` a data chunk of the open session ``sid``) and
        await its Response. A payload whose rows exceed the top rung goes to
        ``submit_transfer`` when transfers are on."""
        data = np.asarray(payload, dtype=np.uint8).reshape(-1)
        if mode == "rc4" and self.sessions is not None:
            # Reserve the chunk's keystream slice (a hit needs no dispatch),
            # ride the queue with it, and ack on any final answer: a failed
            # chunk's answer is final too, and its bytes must not pin the
            # window.
            resv = await self.sessions.reserve(tenant, sid, data.size)
            if isinstance(resv, Response):
                return resv
            ks, off = resv
            try:
                return await self.queue.submit(tenant, key, nonce, data, deadline_s,
                                               sampled=sampled, parent=parent, priority=priority,
                                               mode=mode, sid=sid, ks=ks, ks_offset=off)
            finally:
                self.sessions.ack(tenant, sid, off, data.size)
        span = data.size // 16 + (1 if mode in GCM_MODES else 0)
        if (self.transfers is not None and span > self.rungs[-1] and data.size
                and data.size % 16 == 0):
            return await self.submit_transfer(tenant, key, nonce, data, deadline_s=deadline_s,
                                              sampled=sampled, parent=parent, mode=mode, iv=iv)
        return await self.queue.submit(tenant, key, nonce, payload, deadline_s,
                                       sampled=sampled, parent=parent, priority=priority,
                                       mode=mode, iv=iv, aad=aad, tag=tag, sid=sid)

    async def submit_transfer(self, tenant: str, key: bytes, nonce: bytes, payload,
                              deadline_s: float | None = None, sampled: bool | None = None,
                              parent: str | None = None, mode: str = "ctr", iv: bytes = b"",
                              resume_token: str | None = None, tails: dict | None = None,
                              on_chunk=None):
        """The explicit chunked-transfer entry (``submit`` takes it for an
        oversized payload); ``resume_token``, ``tails`` and ``on_chunk`` are
        the wire front end's resume hooks (``serve/worker.py``)."""
        if self.transfers is None:
            return Response(ok=False, error=ERR_TOO_LARGE,
                            detail="transfers disabled on this server")
        return await self.transfers.run(tenant, key, nonce, payload, mode=mode, iv=iv,
                                        deadline_s=deadline_s, sampled=sampled, parent=parent,
                                        resume_token=resume_token, tails=tails,
                                        on_chunk=on_chunk)

    async def _transfer_chunk(self, tenant: str, key: bytes, spec: transfer.ChunkSpec, piece, *,
                              mode: str, deadline_s: float | None, sampled: bool,
                              parent: str | None):
        """The transfer engine's submit seam: one chunk is one ordinary queue
        admission."""
        return await self.queue.submit(tenant, key, spec.nonce or b"", piece, deadline_s,
                                       sampled=sampled, parent=parent, mode=mode, iv=spec.iv)

    # -- session side ------------------------------------------------------
    async def open_session(self, tenant: str, sid: int, key: bytes):
        """Open one rc4 session: host KSA and a window of keystream."""
        if self.sessions is None:
            return Response(ok=False, error=ERR_BAD_REQUEST,
                            detail="rc4 mode not enabled on this server")
        return await self.sessions.open(tenant, sid, key)

    async def close_session(self, tenant: str, sid: int):
        """Close one rc4 session, releasing its window and state."""
        if self.sessions is None:
            return Response(ok=False, error=ERR_BAD_REQUEST,
                            detail="rc4 mode not enabled on this server")
        return await self.sessions.close(tenant, sid)

    async def _session_prep(self, m_words, xy_words, sampled: bool):
        """The session store's refill seam: one batched PRGA (``rc4-prep``)
        through the same failover pool as traffic. Returns the (S, 258 +
        quantum/4) rows and the failed-over attempts, each a replay of the
        same carries on another lane."""
        q = self.config.session_quantum_bytes
        s = int(xy_words.shape[0]) // 2
        out, _lane, replays = await self.pool.dispatch(
            np.ascontiguousarray(m_words, dtype=np.uint32),
            np.ascontiguousarray(xy_words, dtype=np.uint32), None,
            np.zeros(1, dtype=np.uint32), f"rc4-prep:{s}", bucket=q // 16,
            blocks=s * (q // 16), requests=1, sampled=sampled, mode="rc4-prep", prep_len=q)
        return np.asarray(out), replays

    # -- the batcher loop --------------------------------------------------
    async def _loop(self) -> None:
        while True:
            await self.queue.wait()
            while True:
                requests = self.queue.drain()
                if not requests:
                    break
                for b in batcher.form_batches(requests, self.rungs, key_digest,
                                              self.config.key_slots):
                    await self._sem.acquire()
                    self._spawn(self._run_batch(b))
                    if self.pool.probe_due():
                        self._spawn(self.pool.probe_pass())
                    # Yield between batches so resolved clients resubmit and
                    # the next drain coalesces their follow-ups.
                    await asyncio.sleep(0)
            if not self._running:
                if self._tasks:
                    await asyncio.gather(*list(self._tasks), return_exceptions=True)
                return

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run_batch(self, b: batcher.Batch) -> None:
        """One batch's task: form, dispatch, resolve riders. No exception
        escapes, and the in-flight slot is returned in every outcome."""
        try:
            formed = self._form_batch(b)
            if formed is not None:
                await self._dispatch_batch(b, formed[0])
        finally:
            self._sem.release()

    def _form_batch(self, b: batcher.Batch):
        """Schedule stacking and array building; ``(sched,)`` (``sched``
        None for the schedule-free ``rc4``), or None after answering the
        riders when formation failed."""
        try:
            with trace.maybe_span(b.sampled, "batch-formed", batch=b.label, bucket=b.bucket,
                                  blocks=b.blocks, slots=len(b.slots),
                                  requests=len(b.requests), mode=b.mode):
                # rc4 chunks carry no key: the keycache never sees them.
                sched = (None if b.mode == "rc4"
                         else self.keycache.stacked(b.keys, b.key_slots, mode=b.mode))
                # The native tier's ctr makes each request's counters in C
                # from the batch's runs: no counter array is built for it.
                b.materialise(counters=b.mode != "ctr" or self.engine != aes.NATIVE_ENGINE,
                              sched=sched)
                return (sched,)
        except Exception as e:  # noqa: BLE001 - containment
            self.batches_failed += 1
            metrics.counter("serve_batches", outcome="form-failed")
            trace.counter("serve_batch_failed", batch=b.label)
            for req in b.requests:
                req.fail(ERR_DISPATCH, f"{type(e).__name__}: {e}", batch=b.label)
            return None

    async def _dispatch_batch(self, b: batcher.Batch, sched) -> None:
        t_d0 = time.monotonic()
        try:
            out, _lane, _redispatched = await self.pool.dispatch(
                b.words, b.ctr_words, sched, b.slot_index, b.label, bucket=b.bucket,
                blocks=b.blocks, requests=len(b.requests), sampled=b.sampled, mode=b.mode,
                inject_words=b.inject_words, seg_keep=b.seg_keep, rows=b.rows,
                runs=b.runs)
        except lanes.LanesExhausted as e:
            if e.timed_out:
                self.batches_timed_out += 1
                metrics.counter("serve_batches", outcome="deadline")
                trace.counter("serve_batch_deadline", batch=b.label)
                code = ERR_DEADLINE
            else:
                self.batches_failed += 1
                metrics.counter("serve_batches", outcome="failed")
                trace.counter("serve_batch_failed", batch=b.label)
                code = ERR_DISPATCH
            for req in b.requests:
                req.fail(code, str(e), batch=b.label)
            return
        except Exception as e:  # noqa: BLE001 - containment
            self.batches_failed += 1
            metrics.counter("serve_batches", outcome="failed")
            trace.counter("serve_batch_failed", batch=b.label)
            for req in b.requests:
                req.fail(ERR_DISPATCH, f"{type(e).__name__}: {e}", batch=b.label)
            return
        # Only a served batch enters the coalesce and occupancy accounting.
        self.batches += 1
        metrics.counter("serve_batches", outcome="ok")
        metrics.counter("serve_served_bytes", b.blocks * 16)
        occ = self._occupancy.setdefault(b.bucket, {"batches": 0, "blocks": 0})
        occ["batches"] += 1
        occ["blocks"] += b.blocks
        self._payload_blocks += b.blocks
        self._dispatched_blocks += b.bucket
        self._slots_used += len(b.slots)
        self._slot_capacity += b.key_slots
        t_d1 = time.monotonic()
        if b.requests:
            metrics.observe("serve_stage_us", max(int((t_d0 - b.requests[0].t_drain) * 1e6), 0),
                            stage="pack")
        try:
            tags = auth_ok = None
            if b.mode in GCM_MODES:
                out, ys = out
                tags, auth_ok = self._gcm_finish(b, sched, out, ys)
            for i, (req, data) in enumerate(zip(b.requests, b.split_output(out))):
                if auth_ok is not None and not auth_ok[i]:
                    # A refusal of this request only: no plaintext leaves.
                    metrics.counter("serve_auth_failed", mode=b.mode)
                    trace.counter("serve_auth_failed", batch=b.label)
                    # One mismatch is a data event; a spike is an incident.
                    incident.note_auth_failure()
                    req.fail(ERR_AUTH, "GCM tag mismatch (authentication failed)",
                             batch=b.label)
                    continue
                req.resolve(Response(ok=True, payload=data, batch=b.label,
                                     tag=tags[i] if b.mode == "gcm" else None))
                metrics.observe("serve_stage_us", max(int((time.monotonic() - t_d1) * 1e6), 0),
                                stage="reply")
        except Exception as e:  # noqa: BLE001 - containment
            self.batches_failed += 1
            metrics.counter("serve_batches", outcome="split-failed")
            trace.counter("serve_batch_failed", batch=b.label)
            for req in b.requests:
                req.fail(ERR_DISPATCH, f"{type(e).__name__}: {e}", batch=b.label)

    def _gcm_finish(self, b: batcher.Batch, sched, out_flat, ys) -> tuple[list, list]:
        """Each request's tag and, for ``gcm-open``, whether it verifies, in
        ``b.requests`` order: E_K(J0) from the request's J0 row of the CTR
        output, its GHASH state Y from its named row (``ys`` holds
        ``b.rows``' states in order, one a request), the length block folded
        in with its slot's H on the host. The open's compare is constant
        time; the ``tag_mismatch`` fault point forces a mismatch."""
        slot_of = [si for si, slot in enumerate(b.slots) for _ in slot.requests]
        tags, auth_ok = [], []
        for (off, n), si, req, y in zip(b.req_spans, slot_of, b.requests, ys):
            ek_j0 = packing.np_words_to_bytes(np.ascontiguousarray(out_flat[4 * (off - 1):4 * off]))
            y_int = gf.block_to_int(packing.np_words_to_bytes(np.ascontiguousarray(y)).tobytes())
            tag = aead_gcm._finish_tag(y_int, sched.h_ints[si], b"", len(req.aad), 16 * n, ek_j0)
            tags.append(tag)
            ok = True
            if b.mode == "gcm-open":
                ok = aead_ghash.np_tag_eq(tag, req.tag)
                if faults.fire("tag_mismatch"):
                    ok = False
            auth_ok.append(ok)
        return tags, auth_ok

    # -- introspection -----------------------------------------------------
    def occupancy_histogram(self) -> dict:
        """rung -> {batches, mean occupancy} (the padding price)."""
        return {str(bucket): {"batches": h["batches"],
                              "mean_occupancy": round(h["blocks"] / (h["batches"] * bucket), 4)}
                for bucket, h in sorted(self._occupancy.items())}

    def coalesce_stats(self) -> dict:
        """Payload blocks over dispatched blocks (rung padding priced in),
        and key-slot fill."""
        return {
            "payload_blocks": self._payload_blocks,
            "dispatched_blocks": self._dispatched_blocks,
            "efficiency": (round(self._payload_blocks / self._dispatched_blocks, 4)
                           if self._dispatched_blocks else 0.0),
            "key_slots": self.config.key_slots,
            "slots_used": self._slots_used,
            "slot_fill": (round(self._slots_used / self._slot_capacity, 4)
                          if self._slot_capacity else 0.0),
        }

    def stats(self) -> dict:
        return {
            "engine": self.engine,
            "device": str(self.device),
            "modes": list(self.config.modes),
            "rungs": list(self.rungs),
            "coalesce": self.coalesce_stats(),
            "overlap": {"inflight_limit": self.inflight_limit,
                        "max_inflight": self.max_inflight_seen},
            "batches": self.batches,
            "batches_failed": self.batches_failed,
            "batches_timed_out": self.batches_timed_out,
            "occupancy": self.occupancy_histogram(),
            "queue": self.queue.stats(),
            "keycache": self.keycache.stats(),
            "lanes": self.pool.stats() if self.pool is not None else {"count": 0},
            "compiles": {"warmup": self.warmup_compiles, "steady": self.steady_compiles()},
            "transfers": self.transfers.stats() if self.transfers is not None else None,
            "sessions": self.sessions.stats() if self.sessions is not None else None,
        }
