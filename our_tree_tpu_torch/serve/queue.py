"""Admission control and backpressure for the serve path.

Port of ``our_tree_tpu.serve.queue``, every served mode (``MODES``). The
policy:

* **Bounded depth.** Past ``max_depth`` queued requests new ones are shed
  with an immediate ``"shed"`` answer (degrade kind ``accept->shed``).
* **Per-tenant depth share.** With ``tenant_depth_frac < 1`` one tenant may
  hold at most that fraction of ``max_depth``; past it, that tenant's
  submits shed (``serve_shed{reason=tenant}``) while others are admitted.
* **Two priority tiers.** Tenants in ``low_priority_tenants`` (or a submit
  with ``priority=0``) shed first once depth reaches
  ``priority_depth_frac * max_depth`` (``serve_shed{reason=priority}``).
* **Per-request deadline.** Every accepted request carries a ``Budget``; one
  whose budget is spent when the batcher drains it answers ``"deadline"``.
* **Admission checks up front**, in the JAX queue's order and with its
  codes: a mode outside the reference's vocabulary (``MODES``), or one this
  server did not enable (its ladder was never warmed), is ``"bad-request"``;
  payloads are a nonzero multiple of 16 bytes, keys 16/24/32 bytes (not for
  ``rc4``: its key went to the host KSA at session open, and a data chunk
  carries none), ``ctr`` nonces 16 bytes, an ``rc4`` chunk names its session
  (``sid`` >= 0) and carries its reserved keystream slice (``ks``, as many
  bytes as the payload), GCM IVs non-empty, ``gcm-open`` tags 16 bytes,
  ``cbc`` IVs 16 bytes, and the request's rows (``span_blocks``: a GCM
  request carries its J0 row) must fit the top rung.
* **J0 at admission.** A GCM request's pre-counter block is derived here:
  IV || 0^31 || 1 for a 96-bit IV, otherwise GHASH of the IV under the
  key's H on the host (``aead.ghash.j0_from_iv``), so every IV length rides
  the same dispatch shape.

Every accepted request opens a detached ``request-queued`` span (admission
to drain), head-sampled once at admission (``trace.sample()``); the metrics
registry counts every request, shed, refusal and expiry exactly. asyncio,
numpy and the port's obs/resilience copies only: no device here.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from dataclasses import dataclass, field

import numpy as np

from ..aead import ghash as aead_ghash
from ..obs import metrics, trace
from ..ops.keyschedule import expand_key_enc
from ..resilience import degrade
from ..resilience.policy import Budget

#: Response error codes (the closed set clients dispatch on).
ERR_SHED = "shed"                 #: queue full: back off and retry
ERR_TOO_LARGE = "too-large"       #: payload exceeds the largest bucket
ERR_BAD_REQUEST = "bad-request"   #: malformed payload/key/nonce/IV, or a mode not enabled
ERR_DEADLINE = "deadline"         #: budget exhausted (queued or dispatching)
ERR_DISPATCH = "dispatch-failed"  #: the batch died on every lane
ERR_SHUTDOWN = "shutdown"         #: server stopped with the request queued
#: GCM open: tag mismatch, a refusal of that request only (the batch's other
#: riders are answered)
ERR_AUTH = "auth-failed"
#: a chunked transfer died mid-flight (fault or budget); the response's
#: ``transfer`` dict carries the resume token and the acked count
ERR_TRANSFER_ABORT = "transfer-abort"
#: an oversized payload in a mode the chunk decomposition cannot serve
#: bit-exactly (GCM's tag is a GHASH over the whole message): refused with
#: the reason, never served another way
ERR_TRANSFER_MODE = "transfer-unsupported"

#: The served-mode vocabulary, the JAX package's: ``ctr`` is scattered CTR,
#: ``gcm``/``gcm-open`` AES-GCM seal/open, ``cbc`` parallel CBC decrypt (the
#: only CBC direction that parallelises), ``rc4`` the session stream mode.
#: Batches never mix modes (``serve/batcher.py``).
MODES = ("ctr", "gcm", "gcm-open", "cbc", "rc4")

#: The modes whose batch rows carry each request's J0 row (its CTR output is
#: E_K(J0), the tag's final pad).
GCM_MODES = ("gcm", "gcm-open")


def unknown_modes(modes) -> str | None:
    """Why a server may not enable ``modes`` (none, or one outside the
    vocabulary), or None when it may."""
    bad = [m for m in modes if m not in MODES]
    if bad or not modes:
        return f"unknown serve mode(s) {bad} (known: {MODES})"
    return None


class ServeError(RuntimeError):
    """A request-path failure with a machine-readable ``code``."""

    def __init__(self, code: str, message: str = ""):
        self.code = code
        super().__init__(message or code)


@dataclass
class Response:
    """What a request resolves to: payload bytes or a coded error."""

    ok: bool
    payload: np.ndarray | None = None  #: (len,) u8 output
    error: str | None = None           #: one of the ERR_* codes
    detail: str = ""
    #: GCM seal only: the 16-byte tag (None elsewhere)
    tag: bytes | None = None
    queued_s: float = 0.0              #: admission -> drain residency
    batch: str | None = None           #: label of the batch that served it
    #: a chunked transfer's tallies (``serve/transfer.py``: the resume token,
    #: chunk counts, redispatches and skips); None on a single-rung request
    transfer: dict | None = None
    #: the per-request time ledger (stage -> µs) the router attaches to a
    #: sampled request (``route/proxy.py``); the port's server builds none
    ledger: dict | None = None


@dataclass
class Request:
    """One accepted in-flight request."""

    id: int
    tenant: str
    key: bytes
    nonce: bytes                 #: ctr: 16 big-endian counter bytes
    payload: np.ndarray          #: (16*nblocks,) u8
    future: asyncio.Future
    budget: Budget | None = None
    t_submit: float = 0.0
    mode: str = "ctr"
    #: GCM: the IV (any nonzero length); cbc: the 16-byte IV
    iv: bytes = b""
    #: GCM: the additional authenticated data
    aad: bytes = b""
    #: gcm-open: the 16-byte tag to verify
    tag: bytes = b""
    #: GCM: the 16-byte pre-counter block, derived at admission
    j0: bytes = b""
    #: rc4 only: the chunk's session id, the keystream slice the session
    #: store reserved for it (the batcher packs it where counters go) and
    #: its offset in the session's stream (acked back when answered)
    sid: int = -1
    ks: np.ndarray | None = None
    ks_offset: int = -1
    #: the admission-time head-sampling decision
    sampled: bool = True
    #: an upstream span id this request's spans chain under
    parent: str | None = None
    queued_us: int = 0
    t_drain: float = 0.0
    _span_cm: object | None = field(default=None, repr=False)
    _queue: object | None = field(default=None, repr=False)

    @property
    def nblocks(self) -> int:
        return self.payload.size // 16

    @property
    def span_blocks(self) -> int:
        """Batch rows the request takes: a GCM request carries one more, its
        J0 row."""
        return self.nblocks + (1 if self.mode in GCM_MODES else 0)

    def resolve(self, resp: Response) -> None:
        if not self.future.done():
            self.future.set_result(resp)
            # Every accepted request is answered exactly once: counted at
            # this one seam, so accepted - answered is the lost count.
            if self._queue is not None:
                self._queue.answered += 1

    def fail(self, code: str, detail: str = "", batch: str | None = None) -> None:
        self.resolve(Response(ok=False, error=code, detail=detail, batch=batch))


def _derive_j0(key: bytes, iv: bytes):
    """(J0, None) for a GCM request, or (b"", (code, why)) when it cannot be
    derived: IV || 0^31 || 1 for a 96-bit IV; any other length takes the
    host GHASH path under H = E_K(0^128) (one host key expansion and block,
    paid at admission by the IV shape that needs it)."""
    if len(iv) == 12:
        return iv + b"\x00\x00\x00\x01", None
    try:
        nr, rk = expand_key_enc(key)
        return aead_ghash.j0_from_iv(aead_ghash.derive_h(nr, rk), iv), None
    except Exception as e:  # noqa: BLE001 - refuse, not crash
        return b"", (ERR_BAD_REQUEST, f"J0 derivation failed: {e}")


class RequestQueue:
    """Bounded FIFO of accepted requests with an asyncio wakeup; used from
    one event loop (no lock)."""

    def __init__(self, max_depth: int = 1024, max_request_blocks: int = 4096,
                 default_deadline_s: float = 30.0, tenant_depth_frac: float = 1.0,
                 low_priority_tenants=(), priority_depth_frac: float = 0.5,
                 modes=("ctr",), clock=time.monotonic):
        self.max_depth = int(max_depth)
        #: the modes this server enabled (and warmed)
        self.modes = tuple(modes)
        self.max_request_blocks = int(max_request_blocks)
        self.default_deadline_s = float(default_deadline_s)
        self.low_priority_tenants = frozenset(low_priority_tenants)
        self.priority_depth_frac = min(max(float(priority_depth_frac), 0.0), 1.0)
        self._priority_line = max(int(self.priority_depth_frac * self.max_depth), 1)
        self.tenant_depth_frac = min(max(float(tenant_depth_frac), 0.0), 1.0)
        self._tenant_cap = max(1, int(self.tenant_depth_frac * self.max_depth))
        self._tenant_pending: dict[str, int] = {}
        self._clock = clock
        self._pending: list[Request] = []
        self._event = asyncio.Event()
        self._ids = itertools.count()
        self.closed = False
        self.accepted = 0
        self.answered = 0
        self.shed = 0
        self.shed_tenant = 0
        self.shed_priority = 0
        self.refused = 0
        self.expired = 0
        self.depth_peak = 0

    def depth(self) -> int:
        return len(self._pending)

    def _shed(self, reason: str, kind: str, why: str) -> None:
        self.shed += 1
        metrics.counter("serve_shed", reason=reason)
        trace.counter(f"serve_shed{'' if reason == 'depth' else '_' + reason}")
        degrade.degrade(kind, why)

    def _refusal(self, tenant, key, nonce, iv, tag, data, mode, priority, sid, ks):
        """(code, why) when admission refuses the request, else None."""
        if self.closed:
            return ERR_SHUTDOWN, "server is draining"
        if mode not in MODES:
            return ERR_BAD_REQUEST, f"unknown mode {mode!r} (served modes: {MODES})"
        if mode not in self.modes:
            return ERR_BAD_REQUEST, (f"mode {mode!r} not enabled on this server (enabled: "
                                     f"{self.modes}; its ladder was never warmed)")
        if data.size == 0 or data.size % 16:
            return ERR_BAD_REQUEST, "payload must be a nonzero multiple of 16 bytes"
        if mode != "rc4" and len(key) not in (16, 24, 32):
            return ERR_BAD_REQUEST, f"key must be 16/24/32 bytes, got {len(key)}"
        if mode == "ctr" and len(nonce) != 16:
            return ERR_BAD_REQUEST, "nonce must be 16 bytes"
        if mode == "rc4" and int(sid) < 0:
            return ERR_BAD_REQUEST, "rc4 chunks must name an open session (sid >= 0)"
        if mode == "rc4" and (ks is None or getattr(ks, "size", 0) != data.size):
            # The server reserves the slice before admission: a missing or
            # short one is a broken session handoff.
            return ERR_BAD_REQUEST, (f"rc4 chunk needs a payload-sized keystream slice "
                                     f"(got {getattr(ks, 'size', None)}, want {data.size})")
        if mode in GCM_MODES and not iv:
            return ERR_BAD_REQUEST, "GCM iv must be non-empty"
        if mode == "gcm-open" and len(tag) != 16:
            return ERR_BAD_REQUEST, f"gcm-open tag must be 16 bytes, got {len(tag)}"
        if mode == "cbc" and len(iv) != 16:
            return ERR_BAD_REQUEST, f"cbc iv must be 16 bytes, got {len(iv)}"
        span = data.size // 16 + (1 if mode in GCM_MODES else 0)
        if span > self.max_request_blocks:
            return ERR_TOO_LARGE, f"{span} blocks > bucket ceiling {self.max_request_blocks}"
        depth = len(self._pending)
        if depth >= self.max_depth:
            self._shed("depth", "accept->shed",
                       f"serve queue overloaded (depth {self.max_depth}); shedding new requests")
            return ERR_SHED, f"queue depth {self.max_depth} reached"
        low = priority == 0 or (priority is None and tenant in self.low_priority_tenants)
        if low and self.priority_depth_frac < 1.0 and depth >= self._priority_line:
            self.shed_priority += 1
            self._shed("priority", "priority->shed",
                       f"queue depth crossed the priority line ({self._priority_line}/"
                       f"{self.max_depth}); shedding low-priority requests first")
            return ERR_SHED, (f"low-priority shed under depth pressure "
                              f"({self._priority_line}/{self.max_depth} slots used)")
        if (self.tenant_depth_frac < 1.0
                and self._tenant_pending.get(tenant, 0) >= self._tenant_cap):
            self.shed_tenant += 1
            self._shed("tenant", "tenant->shed",
                       f"a tenant exceeded its queue share ({self._tenant_cap}/"
                       f"{self.max_depth} slots); shedding that tenant's requests only")
            return ERR_SHED, (f"tenant over its queue share ({self._tenant_cap} of "
                              f"{self.max_depth} slots)")
        return None

    # -- admission ---------------------------------------------------------
    def submit(self, tenant: str, key: bytes, nonce: bytes, payload,
               deadline_s: float | None = None, sampled: bool | None = None,
               parent: str | None = None, priority: int | None = None,
               mode: str = "ctr", iv: bytes = b"", aad: bytes = b"",
               tag: bytes = b"", sid: int = -1, ks=None,
               ks_offset: int = -1) -> asyncio.Future:
        """Admit one request; always returns a future (already resolved with
        a coded error Response when admission refuses it). ``priority=0``
        opts one request into the low tier; None defers to
        ``low_priority_tenants``. ``mode``, if enabled: ``ctr`` (``nonce``
        required), ``gcm`` seal or ``gcm-open`` (a non-empty ``iv``, optional
        ``aad``; open carries the 16-byte ``tag``) or ``cbc`` decrypt (the
        16-byte ``iv``) or an ``rc4`` session chunk (``sid``, and the
        keystream slice ``ks`` reserved at ``ks_offset`` of its stream)."""
        fut = asyncio.get_running_loop().create_future()
        data = np.asarray(payload, dtype=np.uint8).reshape(-1)
        mode = str(mode or "ctr")
        key, nonce, iv = bytes(key), bytes(nonce), bytes(iv)
        aad, tag = bytes(aad), bytes(tag)
        refused = self._refusal(tenant, key, nonce, iv, tag, data, mode, priority, sid, ks)
        j0 = b""
        if refused is None and mode in GCM_MODES:
            j0, refused = _derive_j0(key, iv)
        if refused is not None:
            code, why = refused
            if code != ERR_SHED:
                self.refused += 1
                # An unknown mode is client input: collapse it so it cannot
                # mint metric series.
                metrics.counter("serve_refused", code=code,
                                mode=mode if mode in MODES else "invalid")
            fut.set_result(Response(ok=False, error=code, detail=why))
            return fut
        deadline = self.default_deadline_s if deadline_s is None else float(deadline_s)
        req = Request(id=next(self._ids), tenant=tenant, key=key, nonce=nonce, payload=data,
                      future=fut,
                      budget=Budget(deadline, clock=self._clock) if deadline > 0 else None,
                      t_submit=self._clock(), mode=mode, iv=iv, aad=aad, tag=tag, j0=j0,
                      sid=int(sid), ks=ks, ks_offset=int(ks_offset), _queue=self,
                      sampled=trace.sample() if sampled is None else bool(sampled),
                      parent=parent)
        cm = trace.maybe_span(req.sampled, "request-queued", parent=req.parent, req=req.id,
                              tenant=tenant, blocks=req.nblocks, mode=mode)
        cm.__enter__()
        req._span_cm = cm
        self._pending.append(req)
        self._tenant_pending[tenant] = self._tenant_pending.get(tenant, 0) + 1
        self.accepted += 1
        metrics.counter("serve_requests", mode=mode)
        metrics.counter("serve_payload_blocks", req.nblocks)
        depth = len(self._pending)
        if depth > self.depth_peak:
            self.depth_peak = depth
            metrics.gauge_max("serve_queue_depth_peak", depth)
        metrics.gauge("serve_queue_depth", depth)
        self._event.set()
        return fut

    # -- the batcher side --------------------------------------------------
    async def wait(self) -> None:
        """Block until a request may be pending (spurious wakeups are fine)."""
        await self._event.wait()
        self._event.clear()

    def kick(self) -> None:
        """Wake a waiting drain loop (shutdown path)."""
        self._event.set()

    def close(self) -> None:
        """Stop admission; accepted requests are still dispatched."""
        self.closed = True

    def _tenant_done(self, req: Request) -> None:
        left = self._tenant_pending.get(req.tenant, 0) - 1
        if left > 0:
            self._tenant_pending[req.tenant] = left
        else:
            self._tenant_pending.pop(req.tenant, None)

    def drain(self) -> list[Request]:
        """Take everything pending: close each request's queued span and fail
        the ones whose deadline is already spent."""
        taken, self._pending = self._pending, []
        if taken:
            metrics.gauge("serve_queue_depth", 0)
            metrics.observe("serve_drain_requests", len(taken))
        live = []
        for req in taken:
            self._tenant_done(req)
            req.t_drain = self._clock()
            queued_s = req.t_drain - req.t_submit
            req.queued_us = int(queued_s * 1e6)
            metrics.observe("serve_queued_us", queued_s * 1e6)
            sid = req._span_cm.span_id if req._span_cm is not None else None
            metrics.observe("serve_stage_us", req.queued_us, stage="backend_queue",
                            exemplar={"span": sid, "trace": trace.run_id()} if sid else None)
            if req.budget is not None and req.budget.exhausted():
                self.expired += 1
                metrics.counter("serve_deadline_expired")
                trace.counter("serve_deadline_expired", tenant=req.tenant)
                if req._span_cm is not None:
                    req._span_cm.__exit__(TimeoutError, None, None)
                req.resolve(Response(ok=False, error=ERR_DEADLINE,
                                     detail=f"spent {req.budget.spent():.3f}s queued",
                                     queued_s=queued_s))
                continue
            if req._span_cm is not None:
                req._span_cm.__exit__(None, None, None)
            live.append(req)
        return live

    def flush(self, code: str = ERR_SHUTDOWN) -> int:
        """Fail everything still queued (shutdown); every span closes."""
        taken, self._pending = self._pending, []
        for req in taken:
            self._tenant_done(req)
            if req._span_cm is not None:
                req._span_cm.__exit__(RuntimeError, None, None)
            req.fail(code, "server stopped before dispatch")
        return len(taken)

    def stats(self) -> dict:
        return {"accepted": self.accepted, "answered": self.answered,
                "lost": self.accepted - self.answered, "shed": self.shed,
                "shed_tenant": self.shed_tenant, "shed_priority": self.shed_priority,
                "refused": self.refused, "expired": self.expired, "depth": self.depth(),
                "depth_peak": self.depth_peak}
