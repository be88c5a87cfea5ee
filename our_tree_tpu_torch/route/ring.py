"""Deterministic consistent-hash ring: key affinity and minimal motion.

Port of ``our_tree_tpu.route.ring``, with the same hashes, so a key lands on
the same member under either package's router. The virtual-node ring gives
three properties at once:

* **Affinity**: the same (tenant, key digest) maps to the same back end
  while membership holds, so that back end's keycache holds the expanded
  schedule: routing is the cache policy.
* **Determinism across processes**: points are SHA-256 of stable strings,
  never Python's salted ``hash()``, so two routers over the same members
  place every key alike (a router restart or a standby pair changes no
  placement).
* **Minimal motion**: a join takes only the arcs its virtual nodes land on
  (about K/N of the keys for N members); a leave hands only the leaver's
  arcs to the clockwise successors.

``nodes_for`` returns the distinct members clockwise from the key's point:
position 0 is the affinity home, positions 1.. the failover replica
sequence, the same on every router. Standard library only.
"""

from __future__ import annotations

import bisect
import hashlib


def stable_hash(s: str) -> int:
    """64-bit point on the ring for ``s`` — SHA-256 based, so identical
    across processes, hosts, and Python hash-seed salts."""
    return int.from_bytes(
        hashlib.sha256(s.encode("utf-8")).digest()[:8], "big")


def affinity_key(tenant: str, key: bytes) -> str:
    """The ring identity of one tenant's key: tenant-scoped truncated
    SHA-256 of the key bytes — the same digest construction as
    ``serve.keycache.key_digest`` (the cache the affinity exists to
    hit), tenant-scoped because the keycache is (two tenants sharing
    key bytes are two cache entries, so they are two ring keys)."""
    digest = hashlib.sha256(bytes(key)).hexdigest()[:16]
    return f"{tenant}/{digest}"


class Ring:
    """A consistent-hash ring over named members with virtual nodes."""

    def __init__(self, members=(), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = int(vnodes)
        self._points: list[int] = []      # sorted vnode positions
        self._owner: dict[int, str] = {}  # position -> member
        self._members: list[str] = []
        for m in members:
            self.add(m)

    def __len__(self) -> int:
        return len(self._members)

    def members(self) -> tuple[str, ...]:
        """Members in join order (the stable display order; placement
        depends only on the SET — join order never changes hashes)."""
        return tuple(self._members)

    def _member_points(self, member: str) -> list[int]:
        return [stable_hash(f"{member}#{v}") for v in range(self.vnodes)]

    def add(self, member: str) -> None:
        if member in self._members:
            raise ValueError(f"member {member!r} already on the ring")
        for pt in self._member_points(member):
            # A 64-bit collision between two members' vnodes is ~never;
            # if it happens, first owner keeps the point (deterministic:
            # membership operations apply in one order per ring).
            if pt not in self._owner:
                self._owner[pt] = member
                bisect.insort(self._points, pt)
        self._members.append(member)

    def remove(self, member: str) -> None:
        if member not in self._members:
            raise ValueError(f"member {member!r} not on the ring")
        for pt in self._member_points(member):
            if self._owner.get(pt) == member:
                del self._owner[pt]
                i = bisect.bisect_left(self._points, pt)
                del self._points[i]
        self._members.remove(member)

    # -- placement ---------------------------------------------------------
    def node_for(self, key: str) -> str:
        """The member owning ``key``'s clockwise-next virtual node — the
        affinity home."""
        if not self._points:
            raise LookupError("empty ring")
        h = stable_hash(key)
        i = bisect.bisect_right(self._points, h) % len(self._points)
        return self._owner[self._points[i]]

    def nodes_for(self, key: str, n: int | None = None) -> list[str]:
        """The first ``n`` DISTINCT members clockwise from ``key``'s
        point (default: all members): ``[0]`` is the affinity home,
        ``[1:]`` the failover replica sequence."""
        if not self._points:
            raise LookupError("empty ring")
        want = len(self._members) if n is None else min(int(n),
                                                        len(self._members))
        h = stable_hash(key)
        start = bisect.bisect_right(self._points, h)
        out: list[str] = []
        seen: set[str] = set()
        for off in range(len(self._points)):
            owner = self._owner[self._points[(start + off)
                                             % len(self._points)]]
            if owner not in seen:
                seen.add(owner)
                out.append(owner)
                if len(out) >= want:
                    break
        return out

    def placement(self, keys) -> dict[str, str]:
        """key -> owning member for an iterable of keys (the motion
        accounting helper: diff two placements across a membership
        change to count moved keys)."""
        return {k: self.node_for(k) for k in keys}

    def digest(self) -> str:
        """A short stable fingerprint of this ring's VIEW — the member
        set plus vnode count, order-independent (placement depends only
        on the set). Two routers agreeing on the digest place every key
        identically; the fleet gossip (route/fleet.py) carries it so a
        replica can detect config skew loudly instead of diverging
        silently."""
        doc = ",".join(sorted(self._members)) + f"#v{self.vnodes}"
        return hashlib.sha256(doc.encode("utf-8")).hexdigest()[:16]


def moved_keys(before: dict[str, str], after: dict[str, str]) -> int:
    """How many keys changed owner between two ``placement`` maps over
    the same key set — the rebalance-motion number the minimal-motion
    test bounds (~K/N per single join/leave) and the router traces on
    every membership change."""
    return sum(1 for k, owner in before.items() if after.get(k) != owner)
