"""The router's operator endpoint: ``/metrics`` and ``/healthz`` with the
ring's membership view.

Port of ``our_tree_tpu.route.status``, on the port's shared responder
(``serve.status.HttpStatusEndpoint``). The router's ``/healthz`` answers
what no single back end can: who is on the ring, which member owns what
share of the tracked keys, each back end's health state, and whether the
router is serving (``"ok"``, a placeable back end exists), ``"draining"``
(``Router.stop()`` began) or ``"degraded"`` (nothing placeable), the serve
endpoint's three-valued contract. ``/metrics`` federates every back end's
scrape relabeled ``backend="<name>"`` with ``ot_route_federate_up``;
``/profilez`` and ``/alertz`` are relayed to every back end; ``/fleetz``
is the fleet supervisor's document when the router autoscales.
"""

from __future__ import annotations

import asyncio
import re

from ..serve.status import HttpStatusEndpoint

#: One Prometheus sample line: name, optional {labels}, value tail.
_PROM_LINE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?( .*)$")


def relabel_prometheus(text: str, **labels) -> str:
    """Inject ``labels`` into every sample line of a Prometheus text
    document (comments/TYPE lines pass through) — the federation
    rewrite: a backend's ``serve_requests_total`` becomes
    ``serve_requests_total{backend="b1"}`` in the fleet scrape, so N
    backends' identical series stay distinguishable in one document."""
    extra = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            out.append(line)
            continue
        name, lab, tail = m.groups()
        if lab:
            out.append(f"{name}{{{lab[1:-1]},{extra}}}{tail}")
        else:
            out.append(f"{name}{{{extra}}}{tail}")
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


class RouterStatus(HttpStatusEndpoint):
    """/metrics + /healthz for a ``route.proxy.Router``.

    With ``federate=True`` (the default), ``/metrics`` is the FLEET
    scrape: the router's own registry plus every backend's ``/metrics``
    — fetched concurrently through the proxy seam
    (``Backend.poll_metrics_text``, the one backend-contact module) and
    relabeled with ``backend="<name>"`` so per-backend series stay
    distinguishable. One scrape target observes the whole per-host
    fleet; a backend that fails its scrape contributes a
    ``route_federate_scrape{backend=...,outcome=failed}``-style marker
    line instead of silently vanishing."""

    def __init__(self, router, port: int, host: str = "127.0.0.1",
                 federate: bool = True, fleet=None):
        super().__init__(port, host)
        self._router = router
        self.federate = bool(federate)
        #: The fleet supervisor (route/fleet.py FleetSupervisor) when
        #: this router autoscales — /fleetz then serves its elasticity
        #: document; None keeps the shared endpoint's 404.
        self._fleet = fleet

    def fleetz(self) -> dict | None:
        return self._fleet.fleetz() if self._fleet is not None else None

    async def metrics_text_async(self, exemplars: bool = False) -> str:
        # The router's own registry honors the scraper's OpenMetrics
        # negotiation; backend documents are relayed as scraped (plain
        # 0.0.4 — the proxy's scrape does not negotiate), so the
        # federated body never mixes exemplar tails into lines a
        # classic parser will read.
        own = self.metrics_text(exemplars=exemplars)
        if not self.federate:
            return own
        backends = [(name, b)
                    for name, b in sorted(self._router.backends.items())
                    if b.spec.status_port]
        texts = await asyncio.gather(
            *(b.poll_metrics_text() for _, b in backends),
            return_exceptions=True)
        parts = [own.rstrip("\n")]
        up: list[str] = []
        for (name, _b), text in zip(backends, texts):
            ok = isinstance(text, str) and bool(text)
            up.append(f'ot_route_federate_up{{backend="{name}"}} '
                      f'{1 if ok else 0}')
            if not ok:
                continue
            parts.append(f'# federated from backend="{name}"')
            # Backend COMMENT lines are dropped: N backends' documents
            # each carry '# TYPE serve_*' headers, and a strict
            # Prometheus parser rejects a second TYPE line for a family
            # (and split, non-contiguous family groups). The federated
            # series ride untyped — legal, and unambiguous since every
            # sample line is relabeled backend="<name>".
            parts.append("\n".join(
                ln for ln in relabel_prometheus(text, backend=name)
                .splitlines() if ln and not ln.startswith("#")))
        # One contiguous family for the liveness markers (the text
        # format requires a family's samples in one group).
        parts.append("# TYPE ot_route_federate_up gauge")
        parts.extend(up)
        return "\n".join(parts) + "\n"

    async def profilez_async(self, seconds: float) -> tuple[int, dict]:
        """The FEDERATED /profilez: relay the capture arm to every
        backend with a status port, concurrently through the proxy seam
        (``Backend.poll_profilez``) — one operator request profiles the
        whole per-host fleet, each backend enforcing its own one-window
        rule. The router itself captures nothing (the routing tier is
        device-free; its latency story is the waterfall's wire/retry
        stages). 200 when any backend armed; else 409 if any refused as
        busy; else 503 (no backend could capture)."""
        backends = [(name, b)
                    for name, b in sorted(self._router.backends.items())
                    if b.spec.status_port]
        results = await asyncio.gather(
            *(b.poll_profilez(seconds) for _, b in backends),
            return_exceptions=True)
        doc: dict = {"federated": {}}
        codes: list[int] = []
        for (name, _b), res in zip(backends, results):
            if not isinstance(res, dict):
                doc["federated"][name] = {"error": "unreachable"}
                continue
            codes.append(res["code"])
            doc["federated"][name] = {"code": res["code"], **res["doc"]}
        if 200 in codes:
            code = 200
        elif 409 in codes:
            code = 409
        else:
            code = 503
        doc["armed"] = sum(1 for c in codes if c == 200)
        return code, doc

    async def alertz_async(self) -> dict | None:
        """The FEDERATED /alertz: the router's own pulse document plus
        every backend's, fetched concurrently through the proxy seam
        (``Backend.poll_alertz``) — one operator request reads the
        whole per-host fleet's live alert state, same pattern as the
        /metrics and /profilez federation. A backend without a pulse
        engine (or unreachable) contributes an error marker instead of
        silently vanishing."""
        own = (self._router.pulse.engine.alerts_doc()
               if self._router.pulse is not None else None)
        backends = [(name, b)
                    for name, b in sorted(self._router.backends.items())
                    if b.spec.status_port]
        results = await asyncio.gather(
            *(b.poll_alertz() for _, b in backends),
            return_exceptions=True)
        doc: dict = {"router": own, "federated": {}}
        fired: dict[str, int] = {}
        total = 0
        for rule, n in ((own or {}).get("fired") or {}).items():
            fired[rule] = fired.get(rule, 0) + int(n)
        for (name, _b), res in zip(backends, results):
            if not isinstance(res, dict):
                doc["federated"][name] = {"error": "unreachable"}
                continue
            doc["federated"][name] = res
            for rule, n in (res.get("fired") or {}).items():
                fired[rule] = fired.get(rule, 0) + int(n)
        total = sum(fired.values())
        doc["fired"] = dict(sorted(fired.items()))
        doc["total"] = total
        return doc

    def healthz(self) -> dict:
        r = self._router
        placeable = sum(1 for b in r.backends.values()
                        if b.health.placeable())
        if r._draining:
            status = "draining"
        elif placeable > 0:
            status = "ok"
        else:
            status = "degraded"
        # The placement view: how the TRACKED (recently routed) keys
        # distribute over members right now — affinity made visible.
        # Guarded for the empty ring (every member removed): the scrape
        # must answer the "degraded" document then, not a 500.
        keys = list(r._seen_keys) if len(r.ring) else []
        share: dict[str, int] = {m: 0 for m in r.ring.members()}
        for k in keys:
            owner = r.ring.node_for(k)
            share[owner] = share.get(owner, 0) + 1
        doc = r.stats()
        doc.update({
            "status": status,
            "placeable": placeable,
            "ring": {
                "members": list(r.ring.members()),
                "digest": r.ring.digest(),
                "vnodes": r.config.vnodes,
                "changes": r.ring_changes,
                "tracked_keys": len(keys),
                "placement": share,
            },
        })
        return doc
