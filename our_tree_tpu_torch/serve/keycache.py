"""Multi-tenant LRU cache of expanded AES key schedules.

Port of ``our_tree_tpu.serve.keycache`` without the AEAD memo and the native
contexts (the GCM/CBC serve modes and the host tier are not in the port
yet). Key expansion is host-side and per key, so a service where every
request names its key makes rekeying a lookup. Entries hold the host
(numpy) schedule; the lane stages it on its device per dispatch.

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
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

from ..obs import metrics, trace
from ..ops.keyschedule import expand_key_enc


def key_digest(key: bytes) -> str:
    """The cache/trace identity of a key: truncated SHA-256 hex."""
    return hashlib.sha256(bytes(key)).hexdigest()[:16]


class StackedSchedules:
    """An immutable K-slot schedule stack: ``rks`` is (K, 4*(nr+1)) uint32,
    row i = slot i's schedule, all-zero rows in unused slots."""

    __slots__ = ("nr", "rks", "digests")

    def __init__(self, nr: int, rks: np.ndarray, digests: tuple):
        self.nr = int(nr)
        self.rks = rks
        self.digests = digests


class KeyCache:
    """tenant -> (digest -> (nr, host round keys)) with a per-tenant LRU."""

    def __init__(self, per_tenant: int = 8, stacked_capacity: int = 64):
        if per_tenant < 1:
            raise ValueError("per_tenant must be >= 1")
        self.per_tenant = int(per_tenant)
        self._tenants: dict[str, OrderedDict] = {}
        self._stacked: OrderedDict = OrderedDict()
        self.stacked_capacity = max(int(stacked_capacity), 1)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stacked_hits = 0
        self.stacked_misses = 0

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

    def stacked(self, slots: list, key_slots: int) -> StackedSchedules:
        """The memoized (K, 4*(nr+1)) stack for slot-ordered (tenant, key)
        pairs. Every slot still passes through ``get`` (LRU touch, hit
        accounting), but assembling the stack is memoized per (digests, K).
        Mixed key lengths are refused: ``nr`` is uniform per dispatch."""
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
        return sched

    def holds(self, tenant: str, key: bytes) -> bool:
        """Whether the entry is cached (no LRU touch; introspection only)."""
        return key_digest(key) in self._tenants.get(tenant, {})

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                "stacked_hits": self.stacked_hits, "stacked_misses": self.stacked_misses,
                "stacked_entries": len(self._stacked), "tenants": len(self._tenants),
                "entries": sum(len(v) for v in self._tenants.values())}
