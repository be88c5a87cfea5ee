"""The port's consistent-hash ring (``our_tree_tpu_torch.route.ring``) held
against the JAX package's ``route/ring.py``: the pinned placements and
hashes of ``tests/test_ring.py``, join-order independence, the distinct
clockwise replica sequence, balance, minimal motion on a join and a leave,
the membership errors, and, across both packages, placement, replica
sequence and digest equal for 1,000 random affinity keys over random member
sets and vnode counts (keys, members and counts from a numpy seed).

Hashing and placement are exact: no tolerance.
"""

import numpy as np
import pytest

from our_tree_tpu.route import ring as jring
from our_tree_tpu_torch.route import ring

MEMBERS = ["b0", "b1", "b2"]

#: The JAX package's pinned placements for Ring(MEMBERS, vnodes=64)
#: (``tests/test_ring.py``): a change is a fleet-wide cache flush.
GOLDEN = {
    "t0/deadbeef00000000": "b0",
    "t1/deadbeef00000001": "b1",
    "t2/deadbeef00000002": "b2",
    "t3/deadbeef00000003": "b0",
    "t4/deadbeef00000004": "b0",
    "t5/deadbeef00000005": "b0",
    "t6/deadbeef00000006": "b2",
    "t7/deadbeef00000007": "b2",
}
GOLDEN_HASH_B0_0 = 6206288702425594293
GOLDEN_HASH_PIN = 7274556349502031570


def _keys(n: int, seed: int = 7) -> list[str]:
    rng = np.random.default_rng(seed)
    return [f"t{int(rng.integers(64))}/{rng.integers(1 << 62):016x}" for _ in range(n)]


def test_placement_is_pinned_and_equal_to_the_reference():
    r, jr = ring.Ring(MEMBERS), jring.Ring(MEMBERS)
    assert {k: r.node_for(k) for k in GOLDEN} == GOLDEN
    assert {k: jr.node_for(k) for k in GOLDEN} == GOLDEN
    assert ring.stable_hash("b0#0") == GOLDEN_HASH_B0_0 == jring.stable_hash("b0#0")
    assert ring.stable_hash("pin") == GOLDEN_HASH_PIN
    assert ring.affinity_key("alice", b"\x00" * 16) == "alice/374708fff7719dd5"
    assert r.digest() == jr.digest()


def test_placement_independent_of_join_order():
    a = ring.Ring(["b0", "b1", "b2"])
    b = ring.Ring(["b2", "b0", "b1"])
    for k in _keys(200):
        assert a.node_for(k) == b.node_for(k)
    assert a.digest() == b.digest()
    assert a.members() != b.members()  # the display order is join order


def test_nodes_for_is_distinct_and_covers_members():
    r = ring.Ring(MEMBERS)
    for k in _keys(50):
        seq = r.nodes_for(k)
        assert sorted(seq) == sorted(MEMBERS)
        assert seq[0] == r.node_for(k)
        assert r.nodes_for(k, 2) == seq[:2]


def test_balance_over_members():
    r = ring.Ring([f"b{i}" for i in range(4)])
    keys = _keys(4000)
    counts: dict = {}
    for k in keys:
        counts[r.node_for(k)] = counts.get(r.node_for(k), 0) + 1
    for c in counts.values():
        assert 0.5 < c / (len(keys) / 4) < 2.0, counts


def test_minimal_motion_on_join_and_leave():
    keys = _keys(3000)
    r, jr = ring.Ring(MEMBERS), jring.Ring(MEMBERS)
    before = r.placement(keys)
    r.add("b3")
    jr.add("b3")
    after = r.placement(keys)
    moved = ring.moved_keys(before, after)
    assert 0 < moved < len(keys) / 2, moved
    assert moved == jring.moved_keys(before, jr.placement(keys))
    for k in keys:
        if after[k] != before[k]:
            assert after[k] == "b3"
    r.remove("b3")
    assert r.placement(keys) == before


def test_leave_moves_only_the_leavers_keys():
    keys = _keys(3000)
    r = ring.Ring(MEMBERS)
    before = r.placement(keys)
    r.remove("b1")
    after = r.placement(keys)
    for k in keys:
        if before[k] != "b1":
            assert after[k] == before[k]
        else:
            assert after[k] != "b1"


def test_membership_errors_and_empty_ring():
    r = ring.Ring(["b0"])
    with pytest.raises(ValueError):
        r.add("b0")
    with pytest.raises(ValueError):
        r.remove("b9")
    with pytest.raises(ValueError):
        ring.Ring(vnodes=0)
    r.remove("b0")
    with pytest.raises(LookupError):
        r.node_for("k")
    with pytest.raises(LookupError):
        r.nodes_for("k")


@pytest.mark.parametrize("seed", range(4))
def test_placement_and_digest_equal_across_packages(seed):
    """1,000 random affinity keys over a random member set and vnode count:
    the port's ring places, orders and fingerprints them as the JAX ring."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(1, 9))
    members = [f"w{int(m)}" for m in rng.choice(64, n, replace=False)]
    vnodes = int(rng.choice([1, 7, 64, 160]))
    keys = [ring.affinity_key(f"t{int(rng.integers(32))}", rng.bytes(int(rng.choice([16, 24, 32]))))
            for _ in range(1000)]
    r, jr = ring.Ring(members, vnodes=vnodes), jring.Ring(members, vnodes=vnodes)
    assert r.placement(keys) == jr.placement(keys)
    assert [r.nodes_for(k) for k in keys[:200]] == [jr.nodes_for(k) for k in keys[:200]]
    assert r.digest() == jr.digest()
    # A leave moves the same keys in both packages.
    if n > 1:
        before = r.placement(keys)
        r.remove(members[0])
        jr.remove(members[0])
        assert ring.moved_keys(before, r.placement(keys)) == jring.moved_keys(
            before, jr.placement(keys))
        assert r.digest() == jr.digest()


def test_affinity_key_equal_across_packages():
    rng = np.random.default_rng(5)
    for _ in range(200):
        tenant, key = f"t{int(rng.integers(1000))}", rng.bytes(int(rng.choice([16, 24, 32])))
        assert ring.affinity_key(tenant, key) == jring.affinity_key(tenant, key)
