"""Multi-tenant LRU cache of expanded AES key schedules.

Port of ``our_tree_tpu.serve.keycache`` with the ``gcm``/``gcm-open`` modes'
AEAD memo and the ``cbc`` mode's decrypt schedules, without the native
contexts (the host tier is not in the port). Key expansion is
host-side and per key, so a service where every request names its key makes
rekeying a lookup. Entries hold the host (numpy) schedule; the lane stages
it on its device per dispatch.

Entries are keyed by (tenant, key digest), and tenants are isolated twice:
each tenant has its own LRU of ``per_tenant`` entries (one tenant's key
churn never evicts another's), and the same key under two tenants is two
entries. The digest (truncated SHA-256) is the only key-derived value that
reaches labels or traces.

The dispatch consumes a stacked view (``stacked()``): one (K, 4*(nr+1))
array of every slot's schedule, zero rows in unused slots, memoized per
(slot digests, K) in its own LRU, so a familiar batch shape does no schedule
work. A stack outlives a per-tenant eviction until ``stacked_capacity``
churn pushes it out (eviction is capacity management, not revocation).
``stacked(..., mode="cbc")`` also attaches the stack's decrypt schedules
(``rks_dec``), derived from each slot's encrypt schedule once per key digest
(``_dec``, bounded at four times the stack capacity); ``mode="gcm"`` or
``"gcm-open"`` attaches each slot's GHASH subkey H = E_K(0^128) as an int
(``h_ints``, the host finisher's) and its (128, 128) multiply-by-H matrix
(``hmats``, the JAX package's layout), derived once per key digest
(``_aead``, bounded the same way, counted in ``aead_derives``). The lane
stages only H's words from it (``aead.gcm._h_words`` takes column 7 on the
host), never the matrix stack.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

from ..aead import ghash as aead_ghash
from ..obs import metrics, trace
from ..ops import gf
from ..ops.keyschedule import dec_schedule_from_enc, expand_key_enc


def key_digest(key: bytes) -> str:
    """The cache/trace identity of a key: truncated SHA-256 hex."""
    return hashlib.sha256(bytes(key)).hexdigest()[:16]


class StackedSchedules:
    """A K-slot schedule stack: ``rks`` is (K, 4*(nr+1)) uint32, row i = slot
    i's schedule, all-zero rows in unused slots. ``rks_dec`` is the same
    stack of InvMixColumns-folded decrypt schedules, attached by the first
    ``cbc`` use; ``hmats`` ((K, 128, 128) u32) and ``h_ints`` (K ints) the
    GHASH subkeys, attached by the first GCM use (None until then; unused
    slots zero)."""

    __slots__ = ("nr", "rks", "digests", "rks_dec", "hmats", "h_ints")

    def __init__(self, nr: int, rks: np.ndarray, digests: tuple):
        self.nr = int(nr)
        self.rks = rks
        self.digests = digests
        self.rks_dec = None
        self.hmats = None
        self.h_ints = None


class KeyCache:
    """tenant -> (digest -> (nr, host round keys)) with a per-tenant LRU."""

    def __init__(self, per_tenant: int = 8, stacked_capacity: int = 64):
        if per_tenant < 1:
            raise ValueError("per_tenant must be >= 1")
        self.per_tenant = int(per_tenant)
        self._tenants: dict[str, OrderedDict] = {}
        self._stacked: OrderedDict = OrderedDict()
        self.stacked_capacity = max(int(stacked_capacity), 1)
        #: digest -> decrypt-schedule row, and digest -> (H int, (128, 128)
        #: multiply-by-H matrix), each bounded at 4 x stacked_capacity (the
        #: matrix is 64 KiB a key)
        self._dec: OrderedDict = OrderedDict()
        self._aead: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stacked_hits = 0
        self.stacked_misses = 0
        self.aead_derives = 0

    def get(self, tenant: str, key: bytes):
        """(digest, nr, host round-key words) for ``key`` under ``tenant``,
        expanding on a miss and evicting the tenant's least recently used
        entry past capacity."""
        digest = key_digest(key)
        lru = self._tenants.setdefault(tenant, OrderedDict())
        entry = lru.get(digest)
        if entry is not None:
            lru.move_to_end(digest)
            self.hits += 1
            metrics.counter("keycache", outcome="hit")
            trace.counter("keycache_hit", tenant=tenant)
            return (digest, *entry)
        self.misses += 1
        metrics.counter("keycache", outcome="miss")
        trace.counter("keycache_miss", tenant=tenant)
        nr, rk = expand_key_enc(bytes(key))
        entry = (nr, np.asarray(rk, dtype=np.uint32))
        lru[digest] = entry
        if len(lru) > self.per_tenant:
            lru.popitem(last=False)
            self.evictions += 1
            metrics.counter("keycache", outcome="evict")
            trace.counter("keycache_evict", tenant=tenant)
        return (digest, *entry)

    def stacked(self, slots: list, key_slots: int, mode: str = "ctr") -> StackedSchedules:
        """The memoized (K, 4*(nr+1)) stack for slot-ordered (tenant, key)
        pairs. Every slot still passes through ``get`` (LRU touch, hit
        accounting), but assembling the stack is memoized per (digests, K).
        Mixed key lengths are refused: ``nr`` is uniform per dispatch.
        ``mode="cbc"`` attaches the decrypt-schedule stack on first need,
        ``mode="gcm"``/``"gcm-open"`` the GHASH subkeys."""
        if not slots or len(slots) > key_slots:
            raise ValueError(f"{len(slots)} slot(s) for a {key_slots}-slot stack")
        entries = [self.get(t, k) for t, k in slots]
        nrs = {e[1] for e in entries}
        if len(nrs) > 1:
            raise ValueError(f"mixed key lengths in one stack: nr={nrs}")
        digests = tuple((t, e[0]) for (t, _k), e in zip(slots, entries))
        memo_key = (digests, int(key_slots))
        hit = self._stacked.get(memo_key)
        if hit is not None:
            self._stacked.move_to_end(memo_key)
            self.stacked_hits += 1
            metrics.counter("keycache_stacked", outcome="hit")
            trace.counter("keycache_stacked_hit")
            self._attach_mode(hit, entries, mode)
            return hit
        self.stacked_misses += 1
        metrics.counter("keycache_stacked", outcome="miss")
        trace.counter("keycache_stacked_miss")
        nr = entries[0][1]
        rks = np.zeros((int(key_slots), 4 * (nr + 1)), dtype=np.uint32)
        for i, (_d, _nr, rk) in enumerate(entries):
            rks[i] = rk
        sched = StackedSchedules(nr, rks, digests)
        self._stacked[memo_key] = sched
        if len(self._stacked) > self.stacked_capacity:
            self._stacked.popitem(last=False)
        self._attach_mode(sched, entries, mode)
        return sched

    def _memo_aead(self, digest: str, nr: int, rk) -> tuple:
        """(H int, multiply-by-H matrix) of one key, memoized per digest."""
        hit = self._aead.get(digest)
        if hit is None:
            self.aead_derives += 1
            metrics.counter("keycache", outcome="aead-derive")
            h = aead_ghash.derive_h(nr, rk)
            hit = (h, gf.gf128_mul_matrix_words(h))
            self._aead[digest] = hit
            if len(self._aead) > 4 * self.stacked_capacity:
                self._aead.popitem(last=False)
        return hit

    def _attach_mode(self, sched: StackedSchedules, entries: list, mode: str) -> None:
        """Attach ``mode``'s per-key material to the stack, once: for GCM each
        slot's H and multiply-by-H matrix; for ``cbc`` the decrypt-schedule
        stack, each row derived from the slot's encrypt schedule (reversed,
        InvMixColumns; no key bytes touched again). Both memoized per digest.
        Unused slots stay zero: a GCM batch's padding rows ride slot 0 and
        are never named, so a zero row is never read as key material."""
        if mode in ("gcm", "gcm-open") and sched.hmats is None:
            k = sched.rks.shape[0]
            hmats = np.zeros((k, 128, 128), dtype=np.uint32)
            h_ints = [0] * k
            for i, (digest, nr, rk) in enumerate(entries):
                h_ints[i], hmats[i] = self._memo_aead(digest, nr, rk)
            sched.hmats = hmats
            sched.h_ints = tuple(h_ints)
            return
        if mode != "cbc" or sched.rks_dec is not None:
            return
        rks_dec = np.zeros_like(sched.rks)
        for i, (digest, nr, rk) in enumerate(entries):
            row = self._dec.get(digest)
            if row is None:
                row = dec_schedule_from_enc(nr, rk)
                self._dec[digest] = row
                if len(self._dec) > 4 * self.stacked_capacity:
                    self._dec.popitem(last=False)
            rks_dec[i] = row
        sched.rks_dec = rks_dec

    def holds(self, tenant: str, key: bytes) -> bool:
        """Whether the entry is cached (no LRU touch; introspection only)."""
        return key_digest(key) in self._tenants.get(tenant, {})

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                "stacked_hits": self.stacked_hits, "stacked_misses": self.stacked_misses,
                "stacked_entries": len(self._stacked), "aead_derives": self.aead_derives,
                "tenants": len(self._tenants),
                "entries": sum(len(v) for v in self._tenants.values())}
