"""The route tests' shared harness: one script through the JAX package's
router over JAX servers and through the port's router over port servers on
the CPU, or crossed (one package's router in front of the other's
frontends). Each server sits behind its package's ``RequestFrontend`` on a
loopback port, so every request crosses the framed wire, the ``/healthz``
gossip and the canaries as in a deployment, minus the process boundary.

Not a test module: ``tests/test_torch_route.py``, ``test_torch_fleet.py``,
``test_torch_fleet_obs.py``, ``test_torch_session.py``,
``test_torch_transfer.py`` and ``test_torch_pulse.py`` import it.
"""

import asyncio
import types

import numpy as np

from our_tree_tpu.obs import export as jexport
from our_tree_tpu.obs import metrics as jmetrics
from our_tree_tpu.obs import trace as jtrace
from our_tree_tpu.resilience import degrade as jdegrade
from our_tree_tpu.resilience import faults as jfaults
from our_tree_tpu.resilience import journal as jjournal
from our_tree_tpu.route import bench as jroute_bench
from our_tree_tpu.route import fleet as jfleet
from our_tree_tpu.route import health as jhealth
from our_tree_tpu.route import proxy as jproxy
from our_tree_tpu.route import ring as jring
from our_tree_tpu.route import status as jstatus
from our_tree_tpu.serve import wire as jwire
from our_tree_tpu.serve.server import Server as JServer
from our_tree_tpu.serve.server import ServerConfig as JServerConfig
from our_tree_tpu.serve.worker import RequestFrontend as JFrontend
from our_tree_tpu_torch.obs import export, metrics, trace
from our_tree_tpu_torch.resilience import degrade, faults, journal
from our_tree_tpu_torch.route import bench as route_bench
from our_tree_tpu_torch.route import fleet, health, proxy, ring, status
from our_tree_tpu_torch.serve import wire
from our_tree_tpu_torch.serve.server import Server, ServerConfig
from our_tree_tpu_torch.serve.worker import RequestFrontend

JAX = types.SimpleNamespace(
    name="jax", Server=JServer, ServerConfig=JServerConfig, RequestFrontend=JFrontend,
    Router=jproxy.Router, RouterConfig=jproxy.RouterConfig, BackendSpec=jproxy.BackendSpec,
    RouterStatus=jstatus.RouterStatus, proxy=jproxy, health=jhealth, ring=jring,
    status=jstatus, fleet=jfleet, bench=jroute_bench, faults=jfaults, degrade=jdegrade,
    trace=jtrace, metrics=jmetrics, export=jexport, journal=jjournal, wire=jwire,
    server_kw={})
PORT = types.SimpleNamespace(
    name="port", Server=Server, ServerConfig=ServerConfig, RequestFrontend=RequestFrontend,
    Router=proxy.Router, RouterConfig=proxy.RouterConfig, BackendSpec=proxy.BackendSpec,
    RouterStatus=status.RouterStatus, proxy=proxy, health=health, ring=ring, status=status,
    fleet=fleet, bench=route_bench, faults=faults, degrade=degrade, trace=trace,
    metrics=metrics, export=export, journal=journal, wire=wire,
    server_kw={"device": "cpu"})
PKGS = (JAX, PORT)

#: The JAX route tests' small ladder: 4 rungs up to 256 blocks, one lane.
LADDER = dict(min_bucket_blocks=32, max_bucket_blocks=256, lanes=1)

NIST_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
NIST_CTR0 = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
NIST_PT = bytes.fromhex(
    "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
    "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
NIST_CT = bytes.fromhex(
    "874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
    "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee")


def reset_state() -> None:
    """Both packages' fault arms, degrade ledgers and metric registries."""
    for p in PKGS:
        p.faults.reset()
        p.degrade.clear()
        p.metrics.reset_for_tests()


def new_server(pkg, **kw):
    return pkg.Server(pkg.ServerConfig(**{**LADDER, **pkg.server_kw, **kw}))


class Cluster:
    """``n`` servers of package ``servers`` (default: the router's), each
    behind its frontend, with a router of package ``pkg`` over them."""

    def __init__(self, pkg, n=3, router_kw=None, server_kw=None, servers=None, status=True):
        self.pkg = pkg
        self.spkg = servers or pkg
        self.n = n
        self.router_kw = dict(gossip_every_s=0.0, attempt_timeout_s=2.0, **(router_kw or {}))
        self.server_kw = dict(server_kw or {})
        self.status = status
        self.servers, self.fronts, self.specs = [], [], []
        self.router = None

    async def __aenter__(self):
        for i in range(self.n):
            s = new_server(self.spkg, status_port=0 if self.status else None, **self.server_kw)
            await s.start()
            f = self.spkg.RequestFrontend(s, 0)
            await f.start()
            self.servers.append(s)
            self.fronts.append(f)
            self.specs.append(self.pkg.BackendSpec(
                f"b{i}", "127.0.0.1", f.port, s.status.port if self.status else None))
        self.router = self.pkg.Router(self.specs, self.pkg.RouterConfig(**self.router_kw))
        await self.router.start()
        return self

    async def __aexit__(self, *exc):
        await self.router.stop()
        for f in self.fronts:
            await f.stop(grace_s=0.5)
        for s in self.servers:
            await s.stop()


def run_both(script):
    """``asyncio.run(script(pkg))`` for the JAX package, then the port, with
    both packages' process state reset before each; the two results."""
    out = []
    for pkg in PKGS:
        reset_state()
        out.append(asyncio.run(script(pkg)))
    reset_state()
    return out


def dispatches(router) -> dict:
    return {name: b.dispatches for name, b in sorted(router.backends.items())}


async def served(router, coro):
    """Await one routed request; (response, the backend that answered it or
    None)."""
    before = dispatches(router)
    resp = await coro
    after = dispatches(router)
    moved = [n for n in after if after[n] != before.get(n, 0)]
    return resp, (moved[0] if moved else None)


def answer(resp) -> tuple:
    """What a rider sees, as comparable plain values."""
    payload = bytes(np.asarray(resp.payload, np.uint8)) if resp.payload is not None else None
    return (bool(resp.ok), resp.error, payload, resp.tag)


def transitions(router) -> dict:
    """Each back end's health transitions without their clock stamps."""
    return {name: [(t["prev"], t["to"], t["why"]) for t in b.health.transitions]
            for name, b in sorted(router.backends.items())}


def shape(doc):
    """A document's key structure (values dropped), for "same keys"."""
    if isinstance(doc, dict):
        return {k: shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [shape(v) for v in doc[:1]]
    return type(doc).__name__ if doc is not None else None


#: What differs between two routers over different processes' sockets: the
#: addresses, pids, clock skews and timings.
VOLATILE = ("addr", "pid", "skew_us", "t_s")


def masked(doc):
    if isinstance(doc, dict):
        return {k: ("*" if k in VOLATILE else masked(v)) for k, v in doc.items()}
    if isinstance(doc, list):
        return [masked(v) for v in doc]
    return doc


def tenant_for(router, ring_mod, backend_name: str, key: bytes) -> str:
    """A tenant whose affinity home is ``backend_name``."""
    for t in range(128):
        if router.ring.node_for(ring_mod.affinity_key(f"t{t}", key)) == backend_name:
            return f"t{t}"
    raise AssertionError(f"no tenant maps to {backend_name}")


async def fake_backend(pkg, answer_fn):
    """A minimal wire-speaking back end answering every frame with
    ``answer_fn(header, payload)`` -> (header, payload bytes)."""

    async def handle(reader, writer):
        try:
            while True:
                frame = await pkg.wire.read_frame(reader)
                if frame is None:
                    return
                h, p = answer_fn(*frame)
                writer.write(pkg.wire.encode_frame(h, p))
                await writer.drain()
        except pkg.wire.WireError:
            pass
        finally:
            writer.close()

    srv = await asyncio.start_server(handle, "127.0.0.1", 0)
    return srv, srv.sockets[0].getsockname()[1]


async def http_get(port: int, path: str) -> tuple[bytes, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode("latin-1"))
    await writer.drain()
    raw = await reader.read(1 << 22)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return head, body
