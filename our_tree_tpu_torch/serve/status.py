"""The operator status endpoint: ``/metrics``, ``/healthz`` and friends over
HTTP.

Port of ``our_tree_tpu.serve.status``: a small HTTP/1.1 responder on the
server's own asyncio loop (``asyncio.start_server``, stdlib only), so it
shares fate with the service it describes: a wedged loop times ``/healthz``
out, which is itself the signal.

* ``GET /metrics``: the ``obs.metrics`` registry as Prometheus text, with
  the queue depth and in-flight gauges sampled at scrape time; a scraper
  that accepts ``application/openmetrics-text`` gets the exemplars and the
  ``# EOF`` marker.
* ``GET /healthz``: one JSON object, the lanes' health states, the queue's
  ledger, in-flight against its limit, the batches, the keycache, the build
  counts (``compiles``: warmup and steady), the degrade ledger, the
  transfer plane (held bytes against the budget, live ledger rows, sheds)
  and, with ``rc4``, the session plane (open sessions, held keystream bytes
  against the budget, sheds, refusals, evictions, the prefetch hit rate and
  replays) and, while the server runs a pulse engine, ``capacity`` (its
  measured blocks/s by engine and mode, ``obs/pulse.py``). ``status`` is
  ``"ok"`` while a warmed placeable lane exists and
  neither plane is shedding under a pinned budget (sheds grew since the
  previous poll while 90 % of the budget is held), ``"draining"`` once
  admission closed, else ``"degraded"``. Gathered on the loop, which owns the state.
* ``GET /incidentz``: the flight recorder's counts and an index of the run
  directory's bundles (``obs/incident.py``), built off the loop, since it
  reads every bundle file.
* ``GET /profilez?seconds=S``: arms one capture window
  (``obs/profiler.py``) for the server's device, off the loop: 200 armed,
  409 a window is open, 503 none can open.
* ``GET /alertz``: the pulse engine's alert rows and fired-rule counts
  (``alerts_doc``); 404 with the JAX package's body where the server runs
  none (``OT_PULSE=0``).
* ``GET /fleetz``: the fleet supervisor's elasticity document
  (``route/fleet.py``). Only the router's endpoint owns a supervisor; a
  worker's answers 404 with the JAX package's body.

``HttpStatusEndpoint`` is the responder with the documents as hooks;
``StatusServer`` (this server's endpoint) and the router's ``RouterStatus``
(``route/status.py``, which federates ``/metrics``, ``/profilez`` and
``/alertz`` over its back ends) are its two instances. Reads only, and a
handler failure answers 500 to that connection alone. Binds 127.0.0.1 by
default; ``port=0`` binds an ephemeral port published as ``.port``. Enabled
by ``ServerConfig.status_port``.
"""

from __future__ import annotations

import asyncio
import json

from ..obs import incident, metrics, profiler, trace
from ..resilience import degrade


class HttpStatusEndpoint:
    """The HTTP responder: a subclass provides ``healthz()`` and may override
    the other documents' hooks (the ``*_async`` ones let the router await
    its back ends)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._host = host
        self._port = int(port)
        self._srv: asyncio.AbstractServer | None = None
        self.port: int | None = None  #: the bound port
        self.requests = 0

    async def start(self) -> None:
        self._srv = await asyncio.start_server(self._handle, self._host, self._port)
        self.port = self._srv.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._srv is not None:
            self._srv.close()
            await self._srv.wait_closed()
            self._srv = None

    # -- the documents (the subclass surface) -------------------------------
    def healthz(self) -> dict:
        """The ``/healthz`` body."""
        raise NotImplementedError

    def metrics_text(self, exemplars: bool = False) -> str:
        """The ``/metrics`` body: the registry; exemplars only for a scraper
        that asked for OpenMetrics."""
        return metrics.render_prometheus(exemplars=exemplars)

    async def metrics_text_async(self, exemplars: bool = False) -> str:
        return self.metrics_text(exemplars=exemplars)

    def incidentz(self) -> dict:
        """The ``/incidentz`` body: the recorder's counts and the run
        directory's bundles."""
        d = trace.run_dir()
        return {**incident.counts(), "run_dir": d,
                "bundles": incident.bundle_index(d) if d else []}

    def alertz(self) -> dict | None:
        """The ``/alertz`` body; None (404) without a pulse engine."""
        return None

    async def alertz_async(self) -> dict | None:
        return self.alertz()

    def fleetz(self) -> dict | None:
        """The ``/fleetz`` body; None (404) without a fleet supervisor."""
        return None

    def profile_device(self):
        """The device a ``/profilez`` window traces (None: the CPU)."""
        return None

    async def profilez_async(self, seconds: float) -> tuple[int, dict]:
        """Arm one capture window, off the loop: the torch profiler's
        start-up must not stall the requests it observes."""
        return await asyncio.to_thread(profiler.profilez, seconds, self.profile_device())

    # -- the responder ------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = line.decode("latin-1", "replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # Drain the request headers, keeping only Accept (the OpenMetrics
            # exemplar opt-in).
            accept = ""
            while True:
                h = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if not h or h in (b"\r\n", b"\n"):
                    break
                hl = h.decode("latin-1", "replace")
                if hl.lower().startswith("accept:"):
                    accept = hl.partition(":")[2].strip().lower()
            self.requests += 1
            route = path.split("?")[0]
            if route == "/metrics":
                om = "application/openmetrics-text" in accept
                body = await self.metrics_text_async(exemplars=om)
                if om:
                    body += "# EOF\n"  # OpenMetrics requires the marker
                    ctype = "application/openmetrics-text; version=1.0.0; charset=utf-8"
                else:
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                code, reason = 200, "OK"
            elif route == "/healthz":
                body = json.dumps(self.healthz(), indent=1, sort_keys=True) + "\n"
                ctype = "application/json"
                code, reason = 200, "OK"
            elif route == "/incidentz":
                doc = await asyncio.to_thread(self.incidentz)
                body = json.dumps(doc, indent=1, sort_keys=True) + "\n"
                ctype = "application/json"
                code, reason = 200, "OK"
            elif route == "/profilez":
                query = path.partition("?")[2]
                params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
                try:
                    secs = float(params.get("seconds", 1.0))
                except ValueError:
                    secs = 1.0
                code, doc = await self.profilez_async(secs)
                body = json.dumps(doc, indent=1, sort_keys=True) + "\n"
                ctype = "application/json"
                reason = {200: "OK", 409: "Conflict", 503: "Service Unavailable"}.get(code, "OK")
            elif route == "/alertz":
                doc = await self.alertz_async()
                if doc is None:
                    body = "no pulse engine on this endpoint\n"
                    ctype = "text/plain"
                    code, reason = 404, "Not Found"
                else:
                    body = json.dumps(doc, indent=1, sort_keys=True) + "\n"
                    ctype = "application/json"
                    code, reason = 200, "OK"
            elif route == "/fleetz":
                doc = self.fleetz()
                if doc is None:
                    body = "no fleet supervisor on this endpoint\n"
                    ctype = "text/plain"
                    code, reason = 404, "Not Found"
                else:
                    body = json.dumps(doc, indent=1, sort_keys=True) + "\n"
                    ctype = "application/json"
                    code, reason = 200, "OK"
            else:
                body = ("not found: try /metrics, /healthz, /incidentz, "
                        "/profilez, /alertz or /fleetz\n")
                ctype = "text/plain"
                code, reason = 404, "Not Found"
        except Exception:  # noqa: BLE001 - a bad scrape must not matter
            body, ctype, code, reason = ("status endpoint error\n", "text/plain", 500,
                                         "Internal Server Error")
        try:
            raw = body.encode("utf-8")
            writer.write((f"HTTP/1.1 {code} {reason}\r\n"
                          f"Content-Type: {ctype}\r\n"
                          f"Content-Length: {len(raw)}\r\n"
                          "Connection: close\r\n\r\n").encode("latin-1") + raw)
            await writer.drain()
            writer.close()
        except Exception:  # noqa: BLE001 - the peer went away mid-reply
            pass


class StatusServer(HttpStatusEndpoint):
    """The serve-side endpoint on the serve loop."""

    def __init__(self, server, port: int, host: str = "127.0.0.1"):
        super().__init__(port, host)
        self._server = server
        #: transfer sheds at the previous poll: "shedding" means sheds grew
        #: since then while the reassembly buffer is still pinned
        self._transfer_sheds_seen = 0
        #: the same watermark for the session plane's keystream budget
        self._session_sheds_seen = 0

    # -- the documents -----------------------------------------------------
    def healthz(self) -> dict:
        s = self._server
        pool = s.pool
        lanes_doc: dict = {"count": 0, "states": {}, "per_lane": []}
        placeable = 0
        if pool is not None:
            placeable = len(pool.placeable())
            lanes_doc = {
                "count": len(pool.lanes),
                "placeable": placeable,
                "states": {str(ln.idx): ln.state for ln in pool.lanes},
                "inflight": pool.inflight_now,
                "max_inflight_seen": pool.max_inflight_seen,
                "redispatches": pool.redispatches,
                "quarantine_events": pool.quarantine_events(),
            }
        transfers_doc = None
        shedding = False
        if s.transfers is not None:
            t = s.transfers.stats()
            budget = int(s.transfers.reassembly_budget_bytes or 0)
            sheds = int(t["shed"])
            pinned = budget > 0 and int(t["held_bytes"]) >= budget * 0.9
            shedding = pinned and sheds > self._transfer_sheds_seen
            self._transfer_sheds_seen = sheds
            transfers_doc = {
                "held_bytes": int(t["held_bytes"]),
                "held_peak_bytes": int(t["held_peak_bytes"]),
                "budget_bytes": budget,
                "ledger_live": int(t["ledger_live"]),
                "shed": sheds,
                "refused": int(t["refused"]),
                "shedding": shedding,
            }
        sessions_doc = None
        if s.sessions is not None:
            st = s.sessions.stats()
            budget = int(st["budget_bytes"] or 0)
            sheds = int(st["shed"])
            pinned = budget > 0 and int(st["held_bytes"]) >= budget * 0.9
            sess_shedding = pinned and sheds > self._session_sheds_seen
            self._session_sheds_seen = sheds
            shedding = shedding or sess_shedding
            sessions_doc = {
                "open": int(st["open"]),
                "held_bytes": int(st["held_bytes"]),
                "budget_bytes": budget,
                "shed": sheds,
                "refused": int(st["refused"]),
                "evicted": int(st["evicted"]),
                "hit_rate": st["prefetch"]["hit_rate"],
                "replays": int(st["prefetch"]["replays"]),
                "shedding": sess_shedding,
            }
        if s.queue.closed:
            status = "draining"
        elif placeable > 0 and not shedding:
            status = "ok"
        else:
            status = "degraded"
        doc = {
            "status": status,
            "engine": s.engine,
            "lanes": lanes_doc,
            "queue": s.queue.stats(),
            "inflight_limit": s.inflight_limit,
            "batches": {"ok": s.batches, "failed": s.batches_failed,
                        "timed_out": s.batches_timed_out},
            "keycache": s.keycache.stats(),
            "compiles": {"warmup": s.warmup_compiles, "steady": s.steady_compiles()},
            "degraded": degrade.events(),
        }
        if transfers_doc is not None:
            doc["transfers"] = transfers_doc
        if sessions_doc is not None:
            doc["sessions"] = sessions_doc
        if s.pulse is not None:
            doc["capacity"] = s.pulse.engine.capacity()
        return doc

    def alertz(self) -> dict | None:
        """The ``/alertz`` body, None without a pulse engine."""
        return self._server.pulse.engine.alerts_doc() if self._server.pulse is not None else None

    def metrics_text(self, exemplars: bool = False) -> str:
        """The registry with the queue depth and in-flight sampled now, so a
        scrape between requests sees the current pressure."""
        s = self._server
        metrics.gauge("serve_queue_depth", s.queue.depth())
        if s.pool is not None:
            metrics.gauge("serve_inflight", s.pool.inflight_now)
        return metrics.render_prometheus(exemplars=exemplars)

    def profile_device(self):
        return self._server.device
