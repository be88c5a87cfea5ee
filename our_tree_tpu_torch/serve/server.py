"""The serve dispatch loop: queue -> shape buckets -> in-flight lanes.

Port of ``our_tree_tpu.serve.server`` for the ``ctr`` mode. One asyncio
loop on the main thread owns admission and batch formation; dispatch is
overlapped. Request coroutines ``submit`` into the bounded queue; the loop
drains, rung-packs up to K key groups per batch (``batcher``) and submits
each batch as its own task, so batches keep forming while up to
``max_inflight`` dispatches (default one per lane) run on the lanes' worker
threads. The engine comes from ``aes.resolve_serve_engine``: the CUDA
kernels on a card, the plain version on the CPU.

Failure containment, per batch: a failing dispatch retries on its lane
(``RetryPolicy``); a lane that still fails, or hangs past its watchdog
deadline, degrades (suspect, then quarantined; a timeout quarantines at
once) and the batch is re-dispatched bit-exactly on another lane before any
rider sees an error. Only when every lane was tried (``LanesExhausted``)
do the riders get errors (``deadline`` if the last cause was a hang, else
``dispatch-failed``), and the server keeps serving.

Shutdown drains: ``stop()`` closes admission, dispatches everything
accepted, awaits every in-flight batch and flushes; ``queue.stats()["lost"]``
(accepted minus answered) stays 0.

The zero-recompile contract: the JAX package counts XLA compiles; the port
counts builds and loads of the kernel library (``runtime.cuda_build``) plus
the first call of the multi-key seam for each (engine, nr, device)
(``aes.seam_first_calls``: on the card, the first launch of a ``ctr_mk``
NR instantiation, which CUDA loads lazily). Warmup runs every rung once on
every lane's worker thread for each key length in ``warmup_key_bits``,
which makes the thread's CUDA context current, loads the library and
launches the kernel at each warmed nr, so the first served batch pays none
of that; ``steady_compiles()`` must stay 0 after it. A key length outside
``warmup_key_bits`` (only 128 bits by default, as in the reference) pays
its instantiation's first launch on its first batch, and the steady count
shows it. ``pool.first_dispatch`` records the first traffic dispatch's
times, so a run can set them beside the steady ones. A payload above the top rung answers ``too-large``
(the JAX server with transfers disabled).

Cost model: at ``start()`` the server builds the analytic cost records of
its warmed ladder (``obs/costmodel.py``: the ``ctr`` mode, every rung, each
key length of ``warmup_key_bits``) into ``cost_records`` and stamps them,
with ``ServerConfig.ceiling_gbps``, into the ``OT_TRACE_DIR`` run layout;
``serve.bench`` joins them with the per-rung counters. The reference's
chunked transfers, sessions, status endpoint, journal, incident recorder
and pulse analytics are not in the port yet.

Obs spans: ``request-queued`` (queue), ``batch-formed``, ``lane-dispatch``,
``lane-probe``, ``serve-warmup`` / ``lane-warmup``.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass

import numpy as np

from ..models import aes
from ..obs import costmodel, metrics, trace
from ..resilience import watchdog
from ..runtime import cuda_build
from ..utils import packing
from . import batcher, lanes
from .keycache import KeyCache, key_digest
from .queue import ERR_DEADLINE, ERR_DISPATCH, RequestQueue, Response


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
    #: card and the plain version on the CPU; "native" raises
    engine: str = "auto"
    min_bucket_blocks: int = batcher.DEFAULT_MIN_BLOCKS
    max_bucket_blocks: int = batcher.DEFAULT_MAX_BLOCKS
    #: the fixed K dimension: key slots per dispatch
    key_slots: int = batcher.DEFAULT_KEY_SLOTS
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
    #: dispatch lanes: None = one per visible card; more share cards
    lanes: int | None = None
    #: canary-probe quarantined lanes every N batches
    probe_every: int = 8
    #: clean batches a released lane serves before leaving probation
    probation_batches: int = 2
    #: dispatches in flight at once; None = one per lane
    max_inflight: int | None = None
    #: the measured ceiling (GB/s of modeled traffic, ``chip_smoke.py`` derives
    #: the card's from ``harness/ceiling.py``'s rates) the cost model reports
    #: utilization against; None records traffic without a utilization
    ceiling_gbps: float | None = None


class Server:
    """The online crypto service over the port's engines."""

    def __init__(self, config: ServerConfig | None = None):
        self.config = config or ServerConfig()
        c = self.config
        self.rungs = batcher.bucket_ladder(c.min_bucket_blocks, c.max_bucket_blocks)
        self.queue = RequestQueue(max_depth=c.max_depth, max_request_blocks=self.rungs[-1],
                                  default_deadline_s=c.request_deadline_s,
                                  tenant_depth_frac=c.tenant_depth_frac,
                                  low_priority_tenants=c.low_priority_tenants,
                                  priority_depth_frac=c.priority_depth_frac)
        self.keycache = KeyCache(per_tenant=c.keycache_per_tenant)
        self.engine: str | None = None
        self.device = None
        self.pool: lanes.LanePool | None = None
        self._deadline_s = (watchdog.default_deadline_s() if c.dispatch_deadline_s is None
                            else max(float(c.dispatch_deadline_s), 0.0))
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

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        """Resolve the device and engine, build the lane pool, warm every
        lane x rung on the lanes' worker threads, start the batcher loop."""
        c = self.config
        self.device = aes.as_device(c.device)
        before = compile_count()
        self.engine = aes.resolve_serve_engine(c.engine, self.device)
        self.pool = lanes.LanePool(engine=self.engine, device=self.device,
                                   deadline_s=self._deadline_s, retries=c.retries,
                                   lanes=c.lanes, probe_every=c.probe_every,
                                   probation_batches=c.probation_batches)
        await self._warmup()
        if not any(ln.warmed for ln in self.pool.lanes):
            raise RuntimeError(f"serve warmup failed on all {len(self.pool.lanes)} lane(s): "
                               f"no lane can dispatch (engine {self.engine})")
        self.cost_records = costmodel.ladder_costs(self.engine, ("ctr",), self.rungs,
                                                   key_bits=c.warmup_key_bits,
                                                   key_slots=c.key_slots)
        costmodel.write_run_records(self.cost_records, engine=self.engine,
                                    ceiling_gbps=c.ceiling_gbps)
        self._compiles_at_ready = compile_count()
        self.warmup_compiles = self._compiles_at_ready - before
        trace.gauge("serve_warmup_compiles", self.warmup_compiles, engine=self.engine,
                    lanes=len(self.pool.lanes))
        self.inflight_limit = (len(self.pool.lanes) if c.max_inflight is None
                               else max(int(c.max_inflight), 1))
        self._sem = asyncio.Semaphore(self.inflight_limit)
        metrics.ensure_flusher()
        self._running = True
        self._task = asyncio.ensure_future(self._loop())

    async def _warmup(self) -> None:
        """Run every rung once on every lane's worker thread. The smallest
        rung is the canary (zero key, zero payload, zero-nonce counters):
        the first lane's output becomes the canary expectation and every
        other lane's is compared with it. A lane whose warmup fails, hangs
        or mismatches starts quarantined and unwarmed."""
        c = self.config
        canary_rung = self.rungs[0]
        canary_words = np.zeros(4 * canary_rung, dtype=np.uint32)
        canary_ctr = packing.np_ctr_le_blocks(
            b"\x00" * 16, np.arange(canary_rung, dtype=np.uint32)).reshape(-1)
        canary_expected = None
        slot_vecs = {rung: np.zeros(rung, dtype=np.uint32) for rung in self.rungs}
        with trace.span("serve-warmup", engine=self.engine, rungs=len(self.rungs),
                        lanes=len(self.pool.lanes)):
            for lane in self.pool.lanes:
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
                        if mismatch:
                            lane._quarantine("warmup-mismatch")
                        else:
                            lane.warmed = True
                    except Exception as e:  # noqa: BLE001 - contain per lane
                        lane._quarantine(f"warmup-failed:{type(e).__name__}")

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
        if self.pool is not None:
            self.pool.close()
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
                     mode: str = "ctr"):
        """Admit one CTR request and await its Response."""
        return await self.queue.submit(tenant, key, nonce, payload, deadline_s,
                                       sampled=sampled, parent=parent, priority=priority,
                                       mode=mode)

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
            sched = self._form_batch(b)
            if sched is not None:
                await self._dispatch_batch(b, sched)
        finally:
            self._sem.release()

    def _form_batch(self, b: batcher.Batch):
        """Schedule stacking and array building; the stack, or None after
        answering the riders when formation failed."""
        try:
            with trace.maybe_span(b.sampled, "batch-formed", batch=b.label, bucket=b.bucket,
                                  blocks=b.blocks, slots=len(b.slots),
                                  requests=len(b.requests)):
                sched = self.keycache.stacked(b.keys, b.key_slots)
                b.materialise()
                return sched
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
                blocks=b.blocks, requests=len(b.requests), sampled=b.sampled)
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
            for req, data in zip(b.requests, b.split_output(out)):
                req.resolve(Response(ok=True, payload=data, batch=b.label))
                metrics.observe("serve_stage_us", max(int((time.monotonic() - t_d1) * 1e6), 0),
                                stage="reply")
        except Exception as e:  # noqa: BLE001 - containment
            self.batches_failed += 1
            metrics.counter("serve_batches", outcome="split-failed")
            trace.counter("serve_batch_failed", batch=b.label)
            for req in b.requests:
                req.fail(ERR_DISPATCH, f"{type(e).__name__}: {e}", batch=b.label)

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
        }
