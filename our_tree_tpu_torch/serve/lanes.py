"""Per-device dispatch lanes: the serve path's fault domains.

Port of ``our_tree_tpu.serve.lanes``. Every visible card gets one dispatch
lane (an explicit lane count may exceed the card count; such lanes share a
card, each with its own CUDA stream), and a lane is an isolated fault
domain. A failing or hung lane degrades its own health, never the service:
its batch is re-dispatched bit-exactly on another lane before any rider
sees an error. CTR with explicit per-block counters, and CBC decrypt with
its PREV stream laid out by the batcher, make replay free of side effects:
a batch is a pure function of (words, counters or PREV, schedules, slots,
and for GCM its segment arrays and named rows) and can run anywhere, twice,
with identical bytes. The rc4 session seams are pure functions of their
arrays too: the XOR of payload and keystream words, and the batched PRGA
from its carries, so a refill replayed on another lane gives the same
keystream.

This module is the only place in ``serve/`` that touches a device.
``Lane.engine_call`` runs on the lane's worker thread (``serve/dispatch.py``)
under the lane's watchdog deadline: it makes the lane's card and stream
current on that thread, stages the batch arrays there (int32 views of the
batcher's uint32 arrays; copies from pageable host memory), calls the batch's
mode's seam (``ctr``: ``aes.ctr_crypt_words_scattered_multikey``, the
``ctr_mk`` kernel on the CUDA engine; ``cbc``:
``aes.cbc_decrypt_words_scattered_multikey`` with the stack's decrypt
schedules, the ``cbc_mk`` kernel; ``gcm``/``gcm-open``:
``aead.gcm.gcm_crypt_ghash_words`` sealing or opening, with the batch's
``inject_words``, ``seg_keep`` and named ``rows`` and the stack's H words,
``ctr_mk`` and then ``ghash_at``; ``rc4``: ``models.arc4.xor_words``, the
payload words XOR the keystream words the batcher put in ``ctr_words``, a
torch elementwise op; ``rc4-prep``: ``models.arc4.prep_batch_words`` over the
(S*256,) permutation stack in ``words`` and the (2S,) x/y stack in
``ctr_words``, one ``arc4_prga`` launch, returning the (S, 258 + L/4) rows of
carries and keystream; both ignore ``sched``), records CUDA events around it,
fences with a stream synchronize and copies the output back. A GCM engine call
returns the CTR output and the named rows' GHASH states, ``(out, ys)``: the
port's own layout, where the JAX lane returns a (2, 4N) stack of the output
and every row's state. Staging, the ``device`` stage, failover replay and
the (``ctr``-shaped) canary do not depend on the mode; the dispatch metrics
carry it as a label. On a native-tier server (engine ``native``) a ``ctr``
call runs in C on the host (``_call_native``: the batch's request layout,
``runs``, and the stack's cached C contexts), and every other mode runs on
the lane device's ``auto`` engine (``Lane.kernel_engine``), where the
reference runs them on its ``jnp`` engine. Every traffic dispatch enters
the incident recorder's ring (``obs/incident.py``), and a watchdog kill or
a quarantine triggers a bundle.

The fault seams (``resilience/faults.py``), as in the reference, sit inside
the watchdog deadline and fire for traffic and canaries, never at warmup:
``serve_dispatch``, ``dispatch_fail``, ``lane_fail`` (``@lane=<i>`` first,
then the plain point), ``dispatch_hang``, ``lane_hang`` (scoped shot first,
the plain one only if it did not fire: one shot a dispatch at most) and
``dispatch_slow``. A call stopped by a seam never reaches its kernel, so
``engine_calls_by_mode`` counts a call after the seams: each counted call is
one launch of its mode's kernels on the card.

Health state machine (every transition is a ``lane-state`` trace point;
quarantine also stamps ``quarantined:lane:<i>`` through ``degrade`` and
appends a failure row to the serve journal, the same record
``resilience.journal`` keeps for sweep units, so ``clear_failures`` and
``serve.bench --unquarantine lane:<i>`` release it, and a journal written
by either package is read and cleared by the other)::

    healthy ──failure──> suspect ──failure──> quarantined
       ^                    │ clean batch        │  canary ok
       │<───"recovered"─────┘                    v
       │                                     probation
       │<──"released" (probation served)────────┘
           (a probation failure goes straight back to quarantined;
            a timeout quarantines from any state)

Placement is least-loaded (cumulative blocks) over idle placeable lanes; a
lane holds one batch at a time. A quarantined lane is probed every
``probe_every`` batches with the warmup-shaped canary, whose output was
pinned at warmup, and released into probation on a bit-exact answer. With
no placeable lane left, quarantined lanes are probed before a batch fails,
so a one-lane server heals after a transient hang. A pool built with a
journal adopts its rows at start (``adopt_journal_quarantines``): a lane
with a failure row starts quarantined (``journal:<n>``), is warmed after
the trusted lanes, and a canary can release it.

A hung dispatch: a running CUDA kernel cannot be killed. At the deadline
the watchdog fails the dispatch's future and the executor abandons the
wedged worker thread (its ``lane-dispatch`` span stays open, the kill
evidence). The work already queued on the abandoned stream still runs on
the card to its end; the lane is quarantined, and only a canary on a fresh
worker can release it.
"""

from __future__ import annotations

import asyncio
import collections
import time

import numpy as np
import torch

from ..aead import gcm as aead_gcm
from ..models import aes, arc4
from ..obs import incident, metrics, trace
from ..resilience import degrade, faults, watchdog
from ..resilience.policy import RetryPolicy
from .dispatch import LaneExecutor
from .queue import GCM_MODES

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBATION = "probation"
RELEASED = "released"

#: States that may receive traffic.
PLACEABLE = (HEALTHY, SUSPECT, PROBATION)


def _gcm_seam(direction: str):
    """The GCM dispatch in one direction: ``(words, ctr, rks, slots, inject,
    keep, nr, engine, hmats=, rows=)`` -> ``(out, ys)``, the CTR output and
    the GHASH states at ``rows``."""
    def seam(w, c, r, s, inject, keep, nr, engine, hmats, rows):
        return aead_gcm.gcm_crypt_ghash_words(w, c, r, s, hmats, inject, keep, nr, engine,
                                              direction, rows=rows)
    return seam


def _rc4_xor(words, ks_words, nr, engine):
    """The rc4 crypt phase: payload words XOR keystream words."""
    with aes.seam_call("rc4", engine, 0, words.device):
        return arc4.xor_words(words, ks_words)


def _rc4_prep(m_words, xy_words, nr, engine, prep_len):
    """The rc4 keystream refill: the batched PRGA from the carries."""
    with aes.seam_call("rc4-prep", engine, 0, m_words.device):
        return arc4.prep_batch_words(m_words, xy_words, int(prep_len))


#: The seam each served mode dispatches to, and the stack's schedules it reads
#: (None: the rc4 seams take no schedules).
_SEAMS = {"ctr": (aes.ctr_crypt_words_scattered_multikey, "rks"),
          "gcm": (_gcm_seam(aead_gcm.SEAL), "rks"),
          "gcm-open": (_gcm_seam(aead_gcm.OPEN), "rks"),
          "cbc": (aes.cbc_decrypt_words_scattered_multikey, "rks_dec"),
          "rc4": (_rc4_xor, None),
          "rc4-prep": (_rc4_prep, None)}

#: The pinned canary batch: inputs, the expected output and its rung.
_Canary = collections.namedtuple("_Canary", "words ctr_words sched key_slots expected bucket")


def lane_unit(idx: int) -> str:
    """The lane's name in the journal's failure rows, quarantine trace
    points and degrade kinds."""
    return f"lane:{idx}"


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint32 host array as an int32 tensor with the same bits on
    ``device`` (torch.uint32 lacks ``^`` and shifts)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


def _check_rows(rows, n: int) -> np.ndarray:
    """A GCM batch's named rows as (E,) int64, refused unless sorted and in
    [0, n): on the card a bad vector would read wrong states silently."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    if rows.size and (rows[0] < 0 or rows[-1] >= n or bool((rows[1:] < rows[:-1]).any())):
        raise ValueError(f"GCM rows must be sorted and lie in [0, {n})")
    return rows


class LanesExhausted(RuntimeError):
    """Every placeable lane failed this batch, canary rescues included.
    ``causes`` is [(lane_idx, exc), ...] in attempt order; ``timed_out``
    reflects the last cause."""

    def __init__(self, label: str, causes: list):
        self.causes = causes
        last = causes[-1][1] if causes else None
        self.timed_out = isinstance(last, watchdog.DispatchTimeout)
        names = ",".join(f"lane{i}:{type(e).__name__}" for i, e in causes)
        super().__init__(f"batch {label}: no lane could serve it ({names or 'no lanes'})")


class Lane:
    """One dispatch lane: a device and stream, a health state, and the one
    guarded engine-call seam."""

    def __init__(self, idx: int, device: torch.device, engine: str, deadline_s: float,
                 retries: int, clock=time.monotonic, native_threads: int = 0):
        self.idx = idx
        self.device = device
        self.engine = engine
        #: the engine of every seam but the native tier's ``ctr``: on a
        #: native-tier server the lane device's ``auto`` engine (the
        #: kernels on a card, the plain versions on the CPU)
        self.kernel_engine = (aes.resolve_engine("auto", device)
                              if engine == aes.NATIVE_ENGINE else engine)
        self.native_threads = int(native_threads)
        self.stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
        self.deadline_s = deadline_s
        self.state = HEALTHY
        self.warmed = False
        self.policy = RetryPolicy(attempts=max(int(retries), 1), base_delay_s=0.0,
                                  retry_on=(RuntimeError,), name=f"lane{idx}-dispatch")
        self.dispatches = 0
        #: every engine call by mode that passed the fault seams (warmup,
        #: traffic, retries, canaries): on the CUDA engine, one kernel call
        #: each (``ctr_mk`` for ``ctr``, ``cbc_mk`` for ``cbc``,
        #: ``arc4_prga`` for ``rc4-prep``, the torch XOR for ``rc4``), two
        #: for GCM (``ctr_mk``, ``ghash_at``)
        self.engine_calls_by_mode: dict[str, int] = {}
        self.blocks = 0
        self.failures = 0
        self.timeouts = 0
        self.redispatches_in = 0
        self.canaries = 0
        self.probation_left = 0
        self.transitions: list[dict] = []
        self.inflight = 0
        #: cumulative wall time with a batch in flight, and its parts:
        #: host staging (copies in and out), card time of the launch (CUDA
        #: events; the compute window on the CPU) and the fence wait
        self.busy_us = 0
        self.staging_us = 0
        self.device_us = 0
        self.fence_us = 0
        self.executor: LaneExecutor | None = None
        self._clock = clock
        self._t0 = clock()

    @property
    def engine_calls(self) -> int:
        return sum(self.engine_calls_by_mode.values())

    def run_async(self, unit) -> asyncio.Future:
        """Run ``unit`` (a zero-argument callable around ``engine_call``) on
        the lane's worker thread; an awaitable future."""
        if self.executor is None:
            self.executor = LaneExecutor(f"ot-lane{self.idx}", lane=self.idx)
        return asyncio.wrap_future(self.executor.submit(unit))

    # -- state machine -----------------------------------------------------
    def _to(self, new: str, why: str) -> None:
        old = self.state
        if old == new:
            return
        self.state = new
        self.transitions.append({"prev": old, "to": new, "why": why,
                                 "t_s": round(self._clock() - self._t0, 3)})
        metrics.counter("serve_lane_transitions", lane=self.idx, state=new)
        metrics.gauge("serve_lane_placeable", 1 if new in PLACEABLE else 0, lane=self.idx)
        trace.point("lane-state", lane=self.idx, prev=old, to=new, why=why)

    def _quarantine(self, why: str, journal) -> None:
        came_from = self.state
        self._to(QUARANTINED, why)
        if came_from == QUARANTINED:
            return
        trace.point("quarantine", unit=lane_unit(self.idx), lane=self.idx, reason=why)
        degrade.degrade(f"quarantined:{lane_unit(self.idx)}",
                        f"lane {self.idx} ({self.device}): {why}")
        if journal is not None:
            journal.record_failure(lane_unit(self.idx), why)
        # An incident; the trigger's cooldown makes a kill and the
        # quarantine it causes one bundle.
        incident.trigger("quarantine", unit=lane_unit(self.idx), lane=self.idx, why=why)

    def adopt_journal_quarantine(self, fails: int) -> None:
        """Start quarantined from ``fails`` failure rows on the journal (no
        new row: the evidence is on file). The lane is still warmed, so a
        canary can release it."""
        self._to(QUARANTINED, f"journal:{fails}")
        trace.point("quarantine", unit=lane_unit(self.idx), lane=self.idx,
                    reason=f"journal:{fails}")
        degrade.degrade(f"quarantined:{lane_unit(self.idx)}",
                        f"lane {self.idx}: {fails} failure row(s) on the serve journal "
                        f"(release: canary probe or serve.bench --unquarantine "
                        f"{lane_unit(self.idx)})")

    def note_success(self, blocks: int, redispatch: bool, probation_batches: int) -> None:
        self.dispatches += 1
        self.blocks += int(blocks)
        if redispatch:
            self.redispatches_in += 1
        if self.state == SUSPECT:
            self._to(HEALTHY, "recovered")
        elif self.state == PROBATION:
            self.probation_left -= 1
            if self.probation_left <= 0:
                self._to(RELEASED, f"probation-served:{probation_batches}")
                trace.point("quarantine-release", unit=lane_unit(self.idx), lane=self.idx)
                self._to(HEALTHY, "released")

    def note_failure(self, exc: BaseException, journal) -> None:
        self.failures += 1
        if self.state == HEALTHY:
            self._to(SUSPECT, type(exc).__name__)
        else:
            self._quarantine(type(exc).__name__, journal)

    def note_timeout(self, exc: BaseException, journal) -> None:
        # A hang is never transient: quarantined from any state.
        self.timeouts += 1
        self._quarantine("dispatch-timeout", journal)

    # -- the one device-dispatch seam in serve/ ----------------------------
    def engine_call(self, words, ctr_words, sched, key_slots, label: str,
                    warmup: bool = False, timing: dict | None = None,
                    mode: str = "ctr", inject_words=None, seg_keep=None, rows=None,
                    prep_len: int | None = None, runs=None):
        """One multi-key dispatch on this lane's device, on the calling
        (worker) thread, under this lane's watchdog deadline. ``words`` and
        ``ctr_words`` (counters, or ``cbc``'s PREV stream, or ``rc4``'s
        keystream words) are flat (4N,) uint32, ``sched`` the keycache's
        ``StackedSchedules`` (with ``rks_dec`` for ``cbc``, ``hmats`` for
        GCM; None for the rc4 modes), ``key_slots`` the (N,) slot vector;
        ``mode`` picks the seam. A GCM call also takes the batch's (4N,)
        ``inject_words``, (N,) ``seg_keep`` and sorted (E,) ``rows``
        (checked here, on the host); an ``rc4-prep`` call takes the (S*256,)
        permutation stack in ``words``, the (2S,) x/y stack in ``ctr_words``
        and the bytes a session, ``prep_len``. On the native tier a ``ctr``
        call runs in C on the host (``sched.native_ctxs()``); ``runs``, the
        batch's request layout, makes it the per-request C CTR, where
        ``ctr_words`` and ``key_slots`` may be None (warmup and canaries
        pass arrays and no ``runs``). Returns the (4N,) uint32
        output, for GCM ``(out, ys)`` with the (E, 4) uint32 states at
        ``rows``, for ``rc4-prep`` the (S, 258 + prep_len/4) uint32 rows.
        Warmup runs under the global opt-in deadline (a first contact
        legitimately dwarfs a steady dispatch), except on a quarantined
        lane; the fault seams fire for every call but warmup's."""
        seam, rks_name = _SEAMS[mode]
        extra, nr = {}, 0
        if rks_name is None:
            arrays = (words, ctr_words)
            if mode == "rc4-prep":
                extra = {"prep_len": int(prep_len)}
        else:
            arrays = (words, ctr_words, getattr(sched, rks_name), key_slots)
            nr = sched.nr
        if mode in GCM_MODES:
            arrays += (inject_words, seg_keep)
            extra = {"hmats": sched.hmats, "rows": _check_rows(rows, len(key_slots))}
        deadline_s = (self.deadline_s if (not warmup or self.state == QUARANTINED)
                      else watchdog.default_deadline_s())
        with watchdog.deadline(deadline_s, what=f"lane {self.idx} dispatch {label}"):
            if not warmup:
                faults.check("serve_dispatch", label)
                faults.check("dispatch_fail", label)
                faults.check_lane("lane_fail", self.idx, label)
                watchdog.injected_hang("dispatch_hang", label)
                # The scoped shot first, the plain one only if it did not
                # fire: a dispatch takes at most one lane_hang shot.
                if not watchdog.injected_hang(faults.scoped("lane_hang", self.idx), label):
                    watchdog.injected_hang("lane_hang", label)
                faults.injected_slow("dispatch_slow", label)
            self.engine_calls_by_mode[mode] = self.engine_calls_by_mode.get(mode, 0) + 1
            if mode == "ctr" and self.engine == aes.NATIVE_ENGINE:
                return self._call_native(words, ctr_words, sched, key_slots, runs, timing)
            if self.stream is None:
                return self._call_cpu(seam, arrays, extra, nr, timing)
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                return self._call_cuda(seam, arrays, extra, nr, timing)

    @staticmethod
    def _result(out):
        """The seam's result as host uint32 arrays (GCM: a pair)."""
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy().view(np.uint32) for o in out)
        return out.cpu().numpy().view(np.uint32)

    def _call_native(self, words, ctr_words, sched, key_slots, runs, timing):
        """The native tier's ``ctr``: C on the host, the numpy arrays as
        they are; the C window is the ``device`` stage."""
        t0 = self._clock()
        out = aes.ctr_crypt_words_scattered_multikey(
            words, ctr_words, sched.rks, key_slots, sched.nr, aes.NATIVE_ENGINE,
            native_ctxs=sched.native_ctxs(), native_threads=self.native_threads,
            native_runs=runs)
        if timing is not None:
            timing["device_us"] = d_us = int((self._clock() - t0) * 1e6)
            self.device_us += d_us
        return out

    def _call_cpu(self, seam, arrays, extra, nr, timing):
        t0 = self._clock()
        out = seam(*(_tensor(a, self.device) for a in arrays), nr, self.kernel_engine, **extra)
        res = self._result(out)
        if timing is not None:
            timing["device_us"] = d_us = int((self._clock() - t0) * 1e6)
            self.device_us += d_us
        return res

    def _call_cuda(self, seam, arrays, extra, nr, timing):
        t0 = self._clock()
        staged = [_tensor(a, self.device) for a in arrays]
        if "rows" in extra:
            extra = {**extra, "rows": torch.from_numpy(extra["rows"]).to(self.device)}
        t_staged = self._clock()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record(self.stream)
        out = seam(*staged, nr, self.kernel_engine, **extra)
        stop.record(self.stream)
        t_fence = self._clock()
        self.stream.synchronize()
        t_back = self._clock()
        res = self._result(out)
        if timing is not None:
            staging = int((t_staged - t0 + self._clock() - t_back) * 1e6)
            fence = int((t_back - t_fence) * 1e6)
            device = int(start.elapsed_time(stop) * 1e3)
            timing.update(staging_us=staging, device_us=device, fence_us=fence)
            self.staging_us += staging
            self.device_us += device
            self.fence_us += fence
        return res

    def stats(self) -> dict:
        return {
            "lane": self.idx, "device": str(self.device), "state": self.state,
            "warmed": self.warmed, "dispatches": self.dispatches,
            "engine_calls": self.engine_calls,
            "engine_calls_by_mode": dict(self.engine_calls_by_mode), "blocks": self.blocks,
            "bytes": self.blocks * 16, "failures": self.failures, "timeouts": self.timeouts,
            "redispatches_in": self.redispatches_in, "canaries": self.canaries,
            "busy_s": round(self.busy_us / 1e6, 6),
            "staging_s": round(self.staging_us / 1e6, 6),
            "device_s": round(self.device_us / 1e6, 6),
            "fence_s": round(self.fence_us / 1e6, 6),
            "abandoned_workers": self.executor.abandoned if self.executor is not None else 0,
            "transitions": list(self.transitions),
        }


class LanePool:
    """The lane set plus placement, failover and canary probing.

    ``lanes=None`` gives one lane per visible device of ``device``'s type
    (one lane on the CPU); an explicit count may exceed it, and the lanes
    then share devices round-robin, each with its own stream. ``journal``
    (a ``resilience.journal.SweepJournal``) persists quarantines."""

    def __init__(self, engine: str, device: torch.device, deadline_s: float = 0.0,
                 retries: int = 2, lanes: int | None = None, probe_every: int = 8,
                 probation_batches: int = 2, journal=None, clock=time.monotonic,
                 native_threads: int = 0):
        device = torch.device(device)
        if device.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [device]
        n = len(devices) if lanes is None else max(int(lanes), 1)
        self.engine = engine
        self.lanes = [Lane(i, devices[i % len(devices)], engine, deadline_s, retries, clock,
                           native_threads=native_threads)
                      for i in range(n)]
        self.journal = journal
        self.probe_every = max(int(probe_every), 1)
        self.probation_batches = max(int(probation_batches), 1)
        self.redispatches = 0
        self._since_probe = 0
        self._canary: _Canary | None = None
        #: replaced on every completion or state change so an awaiting
        #: dispatch re-evaluates placement (see ``_notify_change``)
        self._change = asyncio.Event()
        #: lanes occupied by traffic right now, and the run's high-water mark
        self.inflight_now = 0
        self.max_inflight_seen = 0
        #: the first served traffic dispatch's window and its parts (µs):
        #: what a first contact left over after warmup would show in
        self.first_dispatch: dict | None = None

    def close(self) -> None:
        """Stop every lane's idle worker."""
        for lane in self.lanes:
            if lane.executor is not None:
                lane.executor.close()

    def _inflight(self, d: int) -> None:
        self.inflight_now += d
        if self.inflight_now > self.max_inflight_seen:
            self.max_inflight_seen = self.inflight_now
            metrics.gauge_max("serve_inflight_peak", self.inflight_now)
        metrics.gauge("serve_inflight", self.inflight_now)
        trace.gauge("serve_inflight", self.inflight_now)

    def _notify_change(self) -> None:
        """Wake every dispatch waiting for a lane (waiters capture
        ``_change`` before re-checking placement, so no pulse is missed)."""
        ev, self._change = self._change, asyncio.Event()
        ev.set()

    # -- journal resume ----------------------------------------------------
    def adopt_journal_quarantines(self) -> list[int]:
        """Quarantine every lane with a failure row on the journal (serve
        journals only quarantine-grade events); the adopted indices."""
        if self.journal is None:
            return []
        adopted = []
        for lane in self.lanes:
            fails = self.journal.fail_count(lane_unit(lane.idx))
            if fails > 0:
                lane.adopt_journal_quarantine(fails)
                adopted.append(lane.idx)
        return adopted

    # -- placement ---------------------------------------------------------
    def placeable(self, exclude=()) -> list[Lane]:
        return [ln for ln in self.lanes
                if ln.idx not in exclude and ln.warmed and ln.state in PLACEABLE]

    def place(self, exclude=()) -> Lane | None:
        """The least-loaded idle placeable lane (index breaks ties)."""
        cands = [ln for ln in self.placeable(exclude) if not ln.inflight]
        if not cands:
            return None
        return min(cands, key=lambda ln: (ln.blocks, ln.idx))

    # -- the canary --------------------------------------------------------
    def set_canary(self, words, ctr_words, sched, key_slots, expected, bucket: int) -> None:
        """Pin the warmup-shaped probe batch and its expected output (from
        the first lane to warm; every other lane's warmup output is compared
        against it)."""
        self._canary = _Canary(words, ctr_words, sched, key_slots, np.asarray(expected),
                               int(bucket))

    def _probe_open(self, lane: Lane):
        if (self._canary is None or not lane.warmed or lane.state != QUARANTINED
                or lane.inflight):
            return None
        lane.canaries += 1
        cm = trace.detached_span("lane-probe", lane=lane.idx, bucket=self._canary.bucket,
                                 engine=self.engine)
        cm.__enter__()
        return cm

    def _probe_settle(self, lane: Lane, cm, c: _Canary, out=None, exc=None) -> bool:
        """Judge the canary captured at probe start: a bit-exact answer
        releases the lane into probation; a failure, a timeout (span left
        open) or a mismatch leaves it quarantined."""
        if exc is not None:
            if not isinstance(exc, watchdog.DispatchTimeout):
                cm.__exit__(type(exc), exc, None)
            metrics.counter("serve_canary", lane=lane.idx, outcome="failed")
            trace.counter("serve_canary_failed", lane=lane.idx)
            return False
        cm.__exit__(None, None, None)
        if not np.array_equal(out, c.expected):
            metrics.counter("serve_canary", lane=lane.idx, outcome="mismatch")
            trace.counter("serve_canary_mismatch", lane=lane.idx)
            return False
        metrics.counter("serve_canary", lane=lane.idx, outcome="ok")
        lane.probation_left = self.probation_batches
        lane._to(PROBATION, "canary-ok")
        trace.point("lane-probe-ok", lane=lane.idx, unit=lane_unit(lane.idx))
        return True

    async def probe_lane_async(self, lane: Lane) -> bool:
        """One canary dispatch on a quarantined lane, on its worker thread."""
        cm = self._probe_open(lane)
        if cm is None:
            return False
        c = self._canary
        lane.inflight += 1
        t0 = lane._clock()
        try:
            out = await lane.run_async(lambda: lane.engine_call(
                c.words, c.ctr_words, c.sched, c.key_slots, f"canary:lane{lane.idx}"))
        except Exception as e:  # noqa: BLE001 - a sick lane may raise anything
            return self._probe_settle(lane, cm, c, exc=e)
        finally:
            lane.inflight -= 1
            lane.busy_us += int((lane._clock() - t0) * 1e6)
            self._notify_change()
        return self._probe_settle(lane, cm, c, out=out)

    def probe_due(self) -> bool:
        """Advance the per-batch probe counter; True when a canary pass is
        due and a warmed quarantined lane exists."""
        self._since_probe += 1
        if self._since_probe < self.probe_every:
            return False
        self._since_probe = 0
        return any(ln.state == QUARANTINED and ln.warmed for ln in self.lanes)

    async def probe_pass(self) -> None:
        """One canary pass over the warmed quarantined lanes."""
        for lane in self.lanes:
            if lane.state == QUARANTINED and lane.warmed:
                await self.probe_lane_async(lane)

    # -- dispatch with failover --------------------------------------------
    async def dispatch(self, words, ctr_words, sched, key_slots, label: str, bucket: int,
                       blocks: int, requests: int, sampled: bool = True, mode: str = "ctr",
                       inject_words=None, seg_keep=None, rows=None,
                       prep_len: int | None = None, runs=None):
        """Place and run one batch of ``mode`` (GCM with its segment arrays and
        named rows, ``rc4-prep`` with its bytes a session, the native tier's
        ``ctr`` with its request layout ``runs``), failing over
        across lanes until it succeeds or every lane has been tried. Returns
        (output, lane, redispatches), the output as ``Lane.engine_call``
        gives it; raises ``LanesExhausted`` only when no lane could serve
        it. The dispatch window's parts (worker wait, staging, card, host
        rest) go to the ``serve_stage_us`` histograms."""
        causes: list = []
        tried: set[int] = set()
        while True:
            change = self._change
            lane = self.place(exclude=tried)
            if lane is None:
                if self.placeable(tried):
                    await change.wait()  # busy lanes exist: one frees up
                    continue
                lane = await self._rescue(tried)
                if lane is None and any(ln.state == QUARANTINED and ln.inflight
                                        and ln.idx not in tried for ln in self.lanes):
                    await change.wait()  # another task's canary may free a lane
                    continue
            if lane is None:
                raise LanesExhausted(label, causes)
            # A redispatch is force-sampled: failover evidence is complete
            # at any sample rate.
            cm = trace.maybe_span(sampled or bool(tried), "lane-dispatch", lane=lane.idx,
                                  batch=label, bucket=bucket, blocks=blocks, requests=requests,
                                  engine=self.engine, mode=mode, redispatch=bool(tried))
            cm.__enter__()
            ex = ({"span": cm.span_id, "trace": trace.run_id(), "lane": lane.idx,
                   "rung": bucket, "engine": self.engine, "mode": mode}
                  if cm.span_id else None)
            lane.inflight += 1
            self._inflight(+1)
            t0 = lane._clock()
            outcome = "ok"
            attempt_timing: dict = {}

            def unit(lane=lane, attempt_timing=attempt_timing, t0=t0):
                attempt_timing["worker_wait_us"] = int((lane._clock() - t0) * 1e6)
                return lane.policy.run(lambda att: lane.engine_call(
                    words, ctr_words, sched, key_slots, label, timing=attempt_timing,
                    mode=mode, inject_words=inject_words, seg_keep=seg_keep, rows=rows,
                    prep_len=prep_len, runs=runs))

            try:
                out = await lane.run_async(unit)
            except watchdog.DispatchTimeout as e:
                # The dispatch never ended: its span is abandoned (the
                # orphan is the kill evidence), forced onto disk even for
                # an unsampled batch.
                cm.force()
                outcome = "timeout"
                metrics.counter("serve_lane_timeout", lane=lane.idx)
                trace.counter("serve_lane_timeout", lane=lane.idx)
                # The killed dispatch enters the ring before the bundle
                # dumps, so the bundle holds the record that caused it.
                incident.record(lane=lane.idx, rung=bucket, engine=self.engine, mode=mode,
                                outcome="timeout", device_us=0,
                                wall_us=int((lane._clock() - t0) * 1e6), batch=label)
                incident.trigger("watchdog-kill", lane=lane.idx, rung=bucket, batch=label)
                lane.note_timeout(e, self.journal)
                causes.append((lane.idx, e))
                tried.add(lane.idx)
                continue
            except Exception as e:  # noqa: BLE001 - failover, then contain
                cm.__exit__(type(e), e, None)
                outcome = "failed"
                metrics.counter("serve_lane_failed", lane=lane.idx)
                trace.counter("serve_lane_failed", lane=lane.idx)
                incident.record(lane=lane.idx, rung=bucket, engine=self.engine, mode=mode,
                                outcome="failed", device_us=0,
                                wall_us=int((lane._clock() - t0) * 1e6), batch=label)
                lane.note_failure(e, self.journal)
                causes.append((lane.idx, e))
                tried.add(lane.idx)
                continue
            finally:
                lane.inflight -= 1
                self._inflight(-1)
                dt_us = int((lane._clock() - t0) * 1e6)
                lane.busy_us += dt_us
                metrics.observe("serve_dispatch_us", dt_us, lane=lane.idx, engine=self.engine,
                                outcome=outcome, mode=mode, exemplar=ex)
                metrics.counter("serve_lane_busy_us", dt_us, lane=lane.idx)
                self._notify_change()
            wait_us = int(attempt_timing.get("worker_wait_us", 0))
            staging_us = int(attempt_timing.get("staging_us", 0))
            device_us = int(attempt_timing.get("device_us", 0))
            host_us = max(dt_us - wait_us - staging_us - device_us, 0)
            cm.note(device_us=device_us, staging_us=staging_us, host_us=host_us,
                    wait_us=wait_us)
            if self.first_dispatch is None:
                self.first_dispatch = {"lane": lane.idx, "rung": bucket, "window_us": dt_us,
                                       "worker_wait_us": wait_us, "staging_us": staging_us,
                                       "device_us": device_us, "host_us": host_us}
            cm.__exit__(None, None, None)
            metrics.counter("serve_device_us", device_us, lane=lane.idx)
            metrics.counter("serve_rung_dispatches", rung=bucket, engine=self.engine,
                            mode=mode, nr=int(getattr(sched, "nr", 0) or 0))
            metrics.counter("serve_rung_device_us", device_us, rung=bucket, engine=self.engine,
                            mode=mode, nr=int(getattr(sched, "nr", 0) or 0))
            incident.record(lane=lane.idx, rung=bucket, engine=self.engine, mode=mode,
                            outcome="ok", device_us=device_us, wall_us=dt_us, batch=label)
            metrics.observe("serve_stage_us", wait_us, stage="worker_wait", exemplar=ex)
            metrics.observe("serve_stage_us", staging_us, stage="staging", exemplar=ex)
            metrics.observe("serve_stage_us", host_us, stage="dispatch", exemplar=ex)
            metrics.observe("serve_stage_us", device_us, stage="device", exemplar=ex)
            if tried:
                self.redispatches += 1
                metrics.counter("serve_redispatch", lane=lane.idx)
                trace.counter("serve_redispatch", lane=lane.idx, after=len(tried))
            lane.note_success(blocks, redispatch=bool(tried),
                              probation_batches=self.probation_batches)
            return out, lane, len(tried)

    async def _rescue(self, tried: set) -> Lane | None:
        """Last resort when no placeable lane remains: canary the
        quarantined lanes now rather than fail the batch."""
        for lane in self.lanes:
            if lane.idx in tried or lane.state != QUARANTINED:
                continue
            if await self.probe_lane_async(lane):
                return lane
        return None

    # -- introspection -----------------------------------------------------
    def quarantine_events(self) -> int:
        return sum(1 for ln in self.lanes for t in ln.transitions if t["to"] == QUARANTINED)

    def stats(self) -> dict:
        return {
            "count": len(self.lanes),
            "placed_across": sum(1 for ln in self.lanes if ln.dispatches),
            "engine_calls": sum(ln.engine_calls for ln in self.lanes),
            "engine_calls_by_mode": {m: sum(ln.engine_calls_by_mode.get(m, 0)
                                            for ln in self.lanes)
                                     for m in sorted({m for ln in self.lanes
                                                      for m in ln.engine_calls_by_mode})},
            "redispatches": self.redispatches,
            "quarantine_events": self.quarantine_events(),
            "abandoned_workers": sum(ln.executor.abandoned for ln in self.lanes
                                     if ln.executor is not None),
            "states": {s: sum(1 for ln in self.lanes if ln.state == s)
                       for s in sorted({ln.state for ln in self.lanes})},
            "first_dispatch": self.first_dispatch,
            "per_lane": [ln.stats() for ln in self.lanes],
        }
