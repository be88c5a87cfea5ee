"""The failover client's give-up streak, on stub router peers: the port's
``FailoverClient`` (``our_tree_tpu_torch.route.fleet``) against the JAX
package's on the same peers.

The elasticity drive puts the client in front of two router peers: a
replica that the drive SIGKILLs (every later connect is refused at once) and
the owner router. The JAX client counts every transport failure toward a
streak of twice the peers, and all its requests share one peer cursor that
each failover advances. So when the cursor sits on the dead replica, the
requests in flight fail over in turn and send each other back to it: of 8
concurrent requests one meets four refusals in a row and answers
``dispatch-failed`` while the owner answers every request at once. A slow
owner does the same with fewer requests: refused, timeout, refused, timeout.
The port's client counts a known-dead peer's refusal once a request and,
given ``client_attempt_timeout``, leaves the router room for one failover of
its own. Each stub peer is a framed-wire server on the loopback.
"""

import asyncio
import socket

import numpy as np
import pytest

from our_tree_tpu.route import fleet as jfleet
from our_tree_tpu_torch.route import fleet
from our_tree_tpu_torch.serve import wire

#: The router's attempt deadline the stubs stand behind (seconds).
ROUTER_ATTEMPT_S = 0.3
#: How long the live peer's slow answers take: past the router's attempt,
#: inside the port's client attempt deadline.
SLOW_S = 0.5
PAYLOAD = np.random.default_rng(23).integers(0, 256, 64, np.uint8)


def _dead_port() -> int:
    """A loopback port nothing listens on: a connect is refused."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class SlowPeer:
    """A router peer that answers its first ``slow`` exchanges after
    ``SLOW_S`` and the rest at once, each ``ok`` with the payload back."""

    def __init__(self, slow: int):
        self.slow, self.seen = slow, 0
        self.server = None

    async def _handle(self, reader, writer):
        frame = await wire.read_frame(reader, wire.MAX_PAYLOAD)
        if frame is None:
            writer.close()
            return
        _header, body = frame
        self.seen += 1
        if self.seen <= self.slow:
            await asyncio.sleep(SLOW_S)
        try:
            writer.write(wire.encode_frame({"ok": True, "batch": "stub"}, body))
            await writer.drain()
        except ConnectionError:
            pass
        writer.close()

    async def __aenter__(self):
        self.server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        return self.server.sockets[0].getsockname()[1]

    async def __aexit__(self, *exc):
        self.server.close()
        await self.server.wait_closed()


async def _submit(client_cls, slow: int, attempt_s: float):
    """One request through ``client_cls`` over [a refusing peer, a live peer
    whose first ``slow`` answers are slow]: (ok, error, payload back intact,
    attempt outcomes in order)."""
    async with SlowPeer(slow) as live:
        client = client_cls([("127.0.0.1", _dead_port()), ("127.0.0.1", live)],
                            attempt_timeout_s=attempt_s, deadline_s=10.0)
        resp = await client.submit("t0", bytes(16), bytes(16), PAYLOAD)
    intact = resp.ok and bytes(resp.payload) == PAYLOAD.tobytes()
    return resp.ok, resp.error, intact, client


async def _burst(client_cls, k: int):
    """``k`` concurrent requests over [a refusing peer, a live peer that
    answers at once], the shared cursor on the refusing one: (requests that
    failed, failovers)."""
    async with SlowPeer(0) as live:
        client = client_cls([("127.0.0.1", _dead_port()), ("127.0.0.1", live)],
                            attempt_timeout_s=1.0, deadline_s=10.0)
        resps = await asyncio.gather(*(client.submit(f"t{i}", bytes(16), bytes(16), PAYLOAD)
                                       for i in range(k)))
    assert all(bytes(r.payload) == PAYLOAD.tobytes() for r in resps if r.ok)
    return sum(not r.ok for r in resps), client.failovers


@pytest.mark.parametrize("k,ref_failed", [(8, 1), (16, 2)])
def test_concurrent_failovers_past_a_dead_peer(k, ref_failed):
    """The cause, reproduced: the reference client gives up on one request
    in eight behind a dead first peer, every attempt of it refused; the
    port's client serves them all."""
    failed, failovers = asyncio.run(_burst(jfleet.FailoverClient, k))
    assert failed == ref_failed and failovers > k
    failed, _ = asyncio.run(_burst(fleet.FailoverClient, k))
    assert failed == 0


def test_reference_client_gives_up_on_a_live_router_behind_a_dead_one():
    """The cause, reproduced: two slow answers of the live peer, each past
    the client's attempt deadline, with the dead peer's refusals between
    them, use up the JAX client's streak of four."""
    ok, error, _, client = asyncio.run(_submit(jfleet.FailoverClient, 2, ROUTER_ATTEMPT_S))
    assert (ok, error) == (False, "dispatch-failed")
    assert client.failovers == 4


def test_port_client_counts_a_dead_peers_refusal_once():
    """The same peers and the same attempt deadline: the port's client does
    not count the dead peer's second refusal, so the live peer's third
    answer (at once) serves the request."""
    ok, error, intact, client = asyncio.run(_submit(fleet.FailoverClient, 2, ROUTER_ATTEMPT_S))
    assert (ok, error, intact) == (True, None, True)
    assert client.attempt_outcomes == {"ConnectionRefusedError": 3, "TimeoutError": 2, "ok": 1}
    assert client.failures == []
    assert [o for _, _, o, _ in client.slow_attempts] == []


def test_port_client_leaves_the_router_room_for_one_failover():
    """``client_attempt_timeout`` waits out a router's attempt and its
    redispatch: the live peer's slow answer is taken on the first try, where
    the JAX client at the router's own deadline would have abandoned it."""
    attempt = fleet.client_attempt_timeout(ROUTER_ATTEMPT_S)
    assert attempt == 2 * ROUTER_ATTEMPT_S + fleet.ROUTER_MARGIN_S > SLOW_S
    ok, error, intact, client = asyncio.run(_submit(fleet.FailoverClient, 1, attempt))
    assert (ok, error, intact) == (True, None, True)
    assert client.attempt_outcomes == {"ConnectionRefusedError": 1, "ok": 1}
    ok_ref, error_ref, _, _ = asyncio.run(_submit(jfleet.FailoverClient, 2, ROUTER_ATTEMPT_S))
    assert (ok_ref, error_ref) == (False, "dispatch-failed")


def test_port_client_still_ends_at_once_when_every_peer_refuses():
    """The whole tier dead: both peers refuse, and the request ends after
    one refusal each, long before its deadline, with the record kept."""
    async def run():
        dead = [("127.0.0.1", _dead_port()), ("127.0.0.1", _dead_port())]
        client = fleet.FailoverClient(dead, attempt_timeout_s=1.0, deadline_s=30.0)
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        resp = await client.submit("t0", bytes(16), bytes(16), PAYLOAD)
        return resp, loop.time() - t0, client

    resp, took, client = asyncio.run(run())
    assert (resp.ok, resp.error) == (False, "dispatch-failed")
    assert "no router peer answered" in resp.detail
    assert took < 5.0 and client.failovers == 2
    assert [o for _, o, _ in client.failures[0]["attempts"]] == ["ConnectionRefusedError"] * 2
