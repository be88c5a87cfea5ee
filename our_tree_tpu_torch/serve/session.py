"""RC4 streaming sessions: per-session cipher state, batched keystream
prefetch, bit-exact failover.

Port of ``our_tree_tpu.serve.session``, with its contract and names. The
reference's one original idea is the ``arc4_prep``/``arc4_crypt`` phase
split: a sequential keystream recurrence apart from a data-parallel XOR.
This module serves that split as stateful sessions:

* **open** runs the 256-swap KSA on the host (``models.arc4.key_schedule``,
  numpy) and registers a per-(tenant, session id) ``{x, y, m[256],
  offset}`` state in a bounded LRU store, one map a tenant, so one tenant's
  churn never evicts another's sessions; the open prefills one window of
  keystream.
* **prep runs ahead of demand.** The prefetcher stacks up to
  ``prefetch_slots`` sessions' PRGA carries into one fixed-shape dispatch
  (the lane seam's ``mode="rc4-prep"``: ``models.arc4.prep_batch_words``,
  one ``arc4_prga`` launch on the card) of ``quantum_bytes`` each, idle
  slots padded. Each session keeps a window of keystream ahead of its
  consumed offset (refilled below the watermark, half a window), and a
  global byte budget sheds typed (``serve_session_shed{reason="keystream"
  |"sessions"}``) when windows would outgrow it.
* **crypt coalesces across sessions.** A data chunk reserves its keystream
  slice and rides the ordinary queue, batcher and lanes as ``mode="rc4"``:
  the XOR is key-oblivious, so chunks of many sessions share a batch.
* **failover is bit-exact.** The PRGA carry is deterministic and is kept at
  every quantum boundary from the acked checkpoint on: a lane that hangs
  mid-refill has the same carry arrays replayed on another lane (the pool's
  redispatch, counted in ``serve_session_replays``), and an injected
  ``keystream_miss`` drops the cached window and regenerates it from the
  checkpoint's carry. Either way every byte a rider sees is the same.

``drain()`` force-closes open sessions at server stop and refuses new opens.
Fault seams (``resilience/faults.py``, each ``@session=<id>``-scopable):
``session_stall`` stalls a refill (backpressure, not a wedge),
``keystream_miss`` discards a session's cached window, ``session_evict``
evicts the LRU idle row (busy rows are never evicted; a full store of busy
sessions sheds new opens instead). Spans ``session-open`` and
``keystream-prefetch``; metrics ``serve_session_*``. asyncio and numpy only:
the device is reached through the server's ``dispatch_prep``.
"""

from __future__ import annotations

import asyncio
import collections
import os
import time

import numpy as np

from ..models import arc4
from ..obs import metrics, trace
from ..resilience import faults
from .queue import ERR_BAD_REQUEST, ERR_SHED, ERR_SHUTDOWN, Response

#: RC4 takes 1..256 key bytes (reference arc4.c:43-67) — NOT the AES
#: 16/24/32 set; queue admission skips its AES key check for mode rc4
#: and the store enforces this instead.
KEY_BYTES_MIN, KEY_BYTES_MAX = 1, 256


def _slow_s() -> float:
    """The injected stall cost (``OT_SLOW_S``, the one knob every
    simulated-latency fault shares — see faults.injected_slow)."""
    try:
        return max(float(os.environ.get("OT_SLOW_S", 0.05)), 0.0)
    except ValueError:
        return 0.05


class _Session:
    """One stream's state: the PRGA carry chain and the keystream window.

    Offsets are absolute byte positions in the session's keystream:
    ``win_start <= acked <= consumed <= gen``, where ``window`` holds
    bytes ``[win_start, gen)``, ``carries`` holds the PRGA state at
    every quantum boundary in ``[win_start, gen]`` (``carries[
    win_start]`` IS the acked checkpoint — the replay base), reserved
    chunks occupy ``[acked, consumed)`` and ``gen`` is the prefetch
    head (always a quantum multiple)."""

    __slots__ = ("tenant", "sid", "key_len", "consumed", "acked",
                 "win_start", "window", "gen", "carries", "pending",
                 "done", "chunks", "refills", "closed")

    def __init__(self, tenant: str, sid: int, key: bytes):
        self.tenant = tenant
        self.sid = int(sid)
        self.key_len = len(key)
        self.consumed = 0
        self.acked = 0
        self.win_start = 0
        self.window = bytearray()
        self.gen = 0
        self.carries: dict[int, tuple[int, int, np.ndarray]] = {
            0: (0, 0, arc4.key_schedule(key))}
        #: offset -> nbytes of reserved-not-yet-acked chunks. reserve()
        #: is strictly sequential per session, so insertion order IS
        #: offset order and the acked prefix advances with a peek.
        self.pending: collections.OrderedDict[int, int] = \
            collections.OrderedDict()
        self.done: set[int] = set()
        self.chunks = 0
        self.refills = 0
        self.closed = False

    @property
    def busy(self) -> bool:
        """Chunks in flight — a busy session is never evicted."""
        return bool(self.pending)

    def ahead(self) -> int:
        """Keystream bytes generated past the consumed offset."""
        return self.gen - self.consumed


class SessionManager:
    """The session store + keystream prefetcher (one per server).

    ``dispatch_prep`` is the server's lane seam: an async callable
    ``(m_words, xy_words, sampled) -> (out, replays)`` wrapping
    ``LanePool.dispatch(mode="rc4-prep")`` — ``out`` is the
    ``arc4.prep_batch_words`` result array, ``replays`` the count of
    failed-over lane attempts (each one a keystream replay from carry).
    Runs entirely on the server's event loop; the only await points are
    the prefetch dispatch and the injected stall.
    """

    def __init__(self, dispatch_prep, *, per_tenant: int = 16,
                 window_bytes: int = 65536, quantum_bytes: int = 4096,
                 prefetch_slots: int = 8, budget_bytes: int = 8 << 20,
                 clock=time.monotonic):
        if quantum_bytes % 4 or quantum_bytes <= 0:
            raise ValueError(f"quantum_bytes must be a positive multiple "
                             f"of 4, got {quantum_bytes}")
        self._dispatch = dispatch_prep
        self.per_tenant = int(per_tenant)
        self.window_bytes = max(int(window_bytes), quantum_bytes)
        self.quantum_bytes = int(quantum_bytes)
        self.prefetch_slots = int(prefetch_slots)
        self.budget_bytes = int(budget_bytes)
        #: refill below this lookahead (half a window: refill overlaps
        #: consumption without thrashing the dispatch seam)
        self.watermark = max(self.window_bytes // 2, self.quantum_bytes)
        self._clock = clock
        #: tenant -> OrderedDict[sid, _Session] (LRU order per tenant —
        #: the keycache isolation discipline: capacity and churn are
        #: per-tenant, cross-tenant eviction is impossible by shape)
        self._stores: dict[str, collections.OrderedDict] = {}
        self._lock = asyncio.Lock()
        self._bg: asyncio.Task | None = None
        self._draining = False
        self.held_bytes = 0
        self.opened = 0
        self.closed = 0
        self.evicted = 0
        self.refused = 0
        self.shed = 0
        self.chunks = 0
        self.hits = 0
        self.misses = 0
        self.replays = 0
        self.prefetches = 0
        self.stalls = 0
        self.injected_misses = 0
        self.drained_open = 0
        # Published once (the transfer-budget idiom): any registry
        # consumer can judge held_bytes against the budget without
        # reaching into this object.
        metrics.gauge("serve_session_budget_bytes", self.budget_bytes)

    # -- admission ----------------------------------------------------------
    def _refuse(self, code: str, why: str) -> Response:
        self.refused += 1
        metrics.counter("serve_session_refused", code=code)
        return Response(ok=False, error=code, detail=why)

    def _shed(self, reason: str, why: str) -> Response:
        self.shed += 1
        metrics.counter("serve_session_shed", reason=reason)
        return Response(ok=False, error=ERR_SHED, detail=why)

    def _get(self, tenant: str, sid) -> _Session | None:
        store = self._stores.get(tenant)
        if store is None:
            return None
        sess = store.get(int(sid))
        if sess is not None:
            store.move_to_end(int(sid))
        return sess

    def _release(self, sess: _Session) -> None:
        self.held_bytes -= len(sess.window)
        sess.window = bytearray()
        sess.closed = True

    def _evict_idle(self, tenant: str,
                    store: collections.OrderedDict) -> bool:
        """Evict the tenant's least-recently-used IDLE session; False
        when every row is busy (the mid-session refusal: a session with
        chunks in flight is never yanked from under its riders)."""
        for osid, osess in store.items():
            if not osess.busy:
                del store[osid]
                self._release(osess)
                self.evicted += 1
                metrics.counter("serve_session_evictions")
                trace.point("session-evict", tenant=tenant, session=osid)
                return True
        return False

    async def open(self, tenant: str, sid, key: bytes) -> Response:
        """Register a session: host KSA, store row, window prefill.

        The prefill (one full window of keystream, in fixed quanta)
        makes the steady state hit-dominated: by the time the first
        data chunk arrives its bytes are cached, and the watermark keeps
        the window ahead of consumption from then on."""
        if self._draining:
            return self._refuse(ERR_SHUTDOWN, "server is draining; "
                                              "no new sessions")
        try:
            sid = int(sid)
        except (TypeError, ValueError):
            return self._refuse(ERR_BAD_REQUEST, f"bad session id {sid!r}")
        if sid < 0:
            return self._refuse(ERR_BAD_REQUEST,
                                f"session id must be >= 0, got {sid}")
        key = bytes(key)
        if not (KEY_BYTES_MIN <= len(key) <= KEY_BYTES_MAX):
            return self._refuse(ERR_BAD_REQUEST, (
                f"rc4 key must be {KEY_BYTES_MIN}..{KEY_BYTES_MAX} bytes, "
                f"got {len(key)}"))
        store = self._stores.setdefault(tenant, collections.OrderedDict())
        if sid in store:
            return self._refuse(ERR_BAD_REQUEST,
                                f"session {sid} already open")
        if faults.fire_session("session_evict", sid):
            # The eviction rehearsal: force the LRU-idle path even
            # below capacity (no-op when every row is busy — busy rows
            # keep their never-evicted guarantee under injection too).
            self._evict_idle(tenant, store)
        if len(store) >= self.per_tenant and not self._evict_idle(
                tenant, store):
            return self._shed("sessions", (
                f"tenant {tenant!r} at capacity ({self.per_tenant} "
                f"sessions, all with chunks in flight); eviction "
                f"mid-session is refused — retry or close a session"))
        sess = _Session(tenant, sid, key)
        store[sid] = sess
        self.opened += 1
        metrics.counter("serve_session_open")
        sampled = trace.sample()
        with trace.maybe_span(sampled, "session-open", tenant=tenant,
                              session=sid):
            r = await self._ensure(sess, self.window_bytes, sampled)
        if isinstance(r, Response):
            # Prefill shed (global keystream budget): the open itself
            # is refused — a session the prefetcher can't feed would
            # miss on every chunk.
            if store.get(sid) is sess:
                del store[sid]
            self._release(sess)
            return r
        return Response(ok=True, detail=f"session {sid} open")

    # -- the keystream window -----------------------------------------------
    async def reserve(self, tenant: str, sid, nbytes: int):
        """Hand a data chunk its keystream slice ``[consumed,
        consumed+nbytes)`` and advance the reserved offset. Returns
        ``(keystream uint8[nbytes], offset)`` or a typed error
        Response. A slice served entirely from the cached window is a
        prefetch HIT; anything that must await a dispatch is a miss —
        the hit rate is what ``serve.bench --min-session-hit-rate`` gates."""
        sess = self._get(tenant, sid)
        if sess is None:
            return self._refuse(ERR_BAD_REQUEST,
                                f"unknown session {sid} (never opened, "
                                f"closed, or evicted)")
        nbytes = int(nbytes)
        if nbytes <= 0:
            return self._refuse(ERR_BAD_REQUEST,
                                f"bad chunk size {nbytes}")
        if faults.fire_session("keystream_miss", sess.sid):
            self._discard_window(sess)
        need = sess.consumed + nbytes
        if sess.gen >= need:
            self.hits += 1
            metrics.counter("serve_session_prefetch", outcome="hit")
        else:
            self.misses += 1
            metrics.counter("serve_session_prefetch", outcome="miss")
            r = await self._ensure(sess, need, trace.sample())
            if isinstance(r, Response):
                return r
        off = sess.consumed
        lo = off - sess.win_start
        ks = np.frombuffer(bytes(sess.window[lo:lo + nbytes]), np.uint8)
        sess.pending[off] = nbytes
        sess.consumed = off + nbytes
        sess.chunks += 1
        self.chunks += 1
        metrics.counter("serve_session_chunks")
        if sess.ahead() < self.watermark and not self._draining:
            self._kick()
        return ks, off

    def ack(self, tenant: str, sid, offset: int, nbytes: int) -> None:
        """Chunk answered: advance the contiguous acked prefix and slide
        the checkpoint forward to the last quantum boundary at or below
        it — bytes and carries behind the checkpoint are released (the
        per-acked-chunk checkpoint the bit-exact failover replays
        from). Failed chunks ack too: their error is final (the wire
        answer is typed, never retried), so their bytes must not pin
        the window forever."""
        sess = self._get(tenant, sid)
        if sess is None or sess.closed:
            return
        sess.done.add(int(offset))
        while sess.pending:
            off0, n0 = next(iter(sess.pending.items()))
            if off0 not in sess.done:
                break
            sess.pending.popitem(last=False)
            sess.done.discard(off0)
            sess.acked = off0 + n0
        base = min((sess.acked // self.quantum_bytes) * self.quantum_bytes,
                   sess.gen)
        if base > sess.win_start:
            cut = base - sess.win_start
            del sess.window[:cut]
            self.held_bytes -= cut
            for b in [b for b in sess.carries if b < base]:
                del sess.carries[b]
            sess.win_start = base

    def _discard_window(self, sess: _Session) -> None:
        """The ``keystream_miss`` injection: the cached window is gone
        (cold cache stand-in); keep only the acked-checkpoint carry.
        The next reserve regenerates forward from it in fixed quanta —
        deterministic PRGA, so the regenerated bytes are byte-identical
        to the discarded ones: one counted replay from carry."""
        self.held_bytes -= len(sess.window)
        sess.window = bytearray()
        sess.carries = {sess.win_start: sess.carries[sess.win_start]}
        sess.gen = sess.win_start
        self.injected_misses += 1
        self.replays += 1
        metrics.counter("serve_session_replays", kind="injected-miss")
        trace.point("keystream-miss", tenant=sess.tenant, session=sess.sid)

    async def _ensure(self, sess: _Session, min_gen: int, sampled: bool):
        """Refill until ``sess.gen >= min_gen`` (absolute offset), in
        fixed quanta. Returns None on success or the typed shed
        Response when the global budget can't cover this session."""
        rounds = 0
        limit = (min_gen - sess.gen) // self.quantum_bytes + 2
        while sess.gen < min_gen:
            if sess.closed:
                return self._refuse(ERR_BAD_REQUEST,
                                    f"session {sess.sid} closed mid-refill")
            rounds += 1
            if rounds > limit:  # pragma: no cover - arithmetic backstop
                return self._shed("keystream", "refill made no progress")
            r = await self._refill_round(sess, sampled)
            if isinstance(r, Response):
                return r
        return None

    def _kick(self) -> None:
        """Arm the background watermark refill (one task at a time —
        the refill lock serializes dispatches anyway, a task herd would
        only churn the loop)."""
        if self._bg is None or self._bg.done():
            self._bg = asyncio.ensure_future(self._bg_refill())

    async def _bg_refill(self) -> None:
        while not self._draining:
            low = any(
                not s.closed and s.ahead() < self.watermark
                for store in self._stores.values() for s in store.values())
            if not low:
                return
            r = await self._refill_round(None, trace.sample())
            if isinstance(r, Response) or r == 0:
                return  # budget-pinned or nothing refillable: stop, the
                #         next reserve re-kicks (no spin at the budget)

    async def _refill_round(self, urgent: _Session | None, sampled: bool):
        """ONE batched prefetch: stack up to ``prefetch_slots`` sessions
        below watermark (``urgent`` first — the session a reserve is
        awaiting), one fixed-shape dispatch, distribute carries and
        windows. Returns the refilled count, or the typed shed Response
        when ``urgent`` itself can't fit the global budget."""
        async with self._lock:
            cands: list[_Session] = []
            if urgent is not None and not urgent.closed:
                cands.append(urgent)
            for store in self._stores.values():
                for s in store.values():
                    if len(cands) >= self.prefetch_slots:
                        break
                    if s is urgent or s.closed:
                        continue
                    if s.ahead() < self.watermark:
                        cands.append(s)
            fit: list[_Session] = []
            projected = self.held_bytes
            for s in cands:
                if projected + self.quantum_bytes > self.budget_bytes:
                    if s is urgent:
                        return self._shed("keystream", (
                            f"keystream budget pinned ({projected} of "
                            f"{self.budget_bytes} bytes held across "
                            f"sessions); chunk sheds until acks release "
                            f"window bytes"))
                    continue
                fit.append(s)
                projected += self.quantum_bytes
            if not fit:
                return 0
            for s in fit:
                if faults.fire_session("session_stall", s.sid):
                    # An awaitable stall, never a wedge: the lock holds
                    # (refills queue behind it) but the server loop and
                    # the XOR dispatch path keep draining under it.
                    self.stalls += 1
                    await asyncio.sleep(_slow_s())
                    break
            S, L = self.prefetch_slots, self.quantum_bytes
            m_words = np.zeros(S * 256, np.uint32)
            xy_words = np.zeros(2 * S, np.uint32)
            for i, s in enumerate(fit):
                x, y, m = s.carries[s.gen]
                m_words[i * 256:(i + 1) * 256] = m.astype(np.uint32)
                xy_words[i] = x
                xy_words[S + i] = y
            with trace.maybe_span(sampled, "keystream-prefetch",
                                  sessions=len(fit), quantum=L):
                out, replays = await self._dispatch(m_words, xy_words,
                                                    sampled)
            self.prefetches += 1
            if replays:
                self.replays += int(replays)
                metrics.counter("serve_session_replays", n=int(replays),
                                kind="redispatch")
            for i, s in enumerate(fit):
                row = out[i]
                s.carries[s.gen + L] = (int(row[0]) & 0xFF,
                                        int(row[1]) & 0xFF,
                                        row[2:258].astype(np.uint8))
                s.window += row[258:].astype("<u4").tobytes()
                s.gen += L
                s.refills += 1
                self.held_bytes += L
            return len(fit)

    # -- close / drain ------------------------------------------------------
    async def close(self, tenant: str, sid) -> Response:
        store = self._stores.get(tenant)
        sess = store.get(int(sid)) if store else None
        if sess is None:
            return self._refuse(ERR_BAD_REQUEST, f"unknown session {sid}")
        if sess.busy:
            return self._refuse(ERR_BAD_REQUEST, (
                f"session {sid} has {len(sess.pending)} chunk(s) in "
                f"flight; close after their answers"))
        del store[int(sid)]
        final = sess.consumed
        self._release(sess)
        self.closed += 1
        metrics.counter("serve_session_close")
        return Response(ok=True, detail=f"session {sid} closed at "
                                        f"offset {final}")

    async def drain(self) -> None:
        """Server stop: refuse new opens, stop the refill task, and
        force-close whatever is still open (counted — the drain story
        for state that would otherwise be orphaned; the quarantine-row
        analogue for sessions)."""
        self._draining = True
        t, self._bg = self._bg, None
        if t is not None:
            t.cancel()
            await asyncio.gather(t, return_exceptions=True)
        for store in self._stores.values():
            for sess in list(store.values()):
                self.drained_open += 1
                self._release(sess)
            store.clear()
        if self.drained_open:
            metrics.counter("serve_session_drained", n=self.drained_open)

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        served = self.hits + self.misses
        return {
            "open": sum(len(s) for s in self._stores.values()),
            "opened": self.opened,
            "closed": self.closed,
            "evicted": self.evicted,
            "refused": self.refused,
            "shed": self.shed,
            "chunks": self.chunks,
            "held_bytes": self.held_bytes,
            "budget_bytes": self.budget_bytes,
            "window_bytes": self.window_bytes,
            "quantum_bytes": self.quantum_bytes,
            "prefetch_slots": self.prefetch_slots,
            "drained_open": self.drained_open,
            "prefetch": {
                "dispatches": self.prefetches,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / served) if served else None,
                "replays": self.replays,
                "stalls": self.stalls,
                "injected_misses": self.injected_misses,
            },
        }
