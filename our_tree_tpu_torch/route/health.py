"""Per-back-end health: the lane state machine one fault domain up.

Port of ``our_tree_tpu.route.health``. Sweep units, serve lanes and router
back ends share one quarantine model::

    healthy --failure--> suspect --failure--> quarantined
       ^                    | clean answer        | canary ok
       |<----"recovered"----+                     v
       |                                      probation
       |<--"released" (probation served)---------+
                  (a probation failure goes back to quarantined;
                   a timeout quarantines from any state)

A quarantine appends a failure row for unit ``backend:<name>`` to the router
journal, the record ``resilience.journal`` keeps for sweep units and lanes,
so ``route.bench --unquarantine backend:<name>`` is the same release edit,
and a restarted router adopts recorded quarantines. The rows are the JAX
package's byte for byte.

Two kinds of evidence feed the machine, ranked differently:

* **Dispatch outcomes** (``route/proxy.py``) are ground truth: a served
  request is a success, a refused or torn one a failure, a hung one a
  timeout. Only they can degrade a placeable back end.
* **Gossip** (``/healthz`` polls) is reconnaissance: an unreachable or
  ``degraded`` poll walks a healthy back end to suspect; ``draining``
  removes it from placement without blame; an ``ok`` poll of a quarantined
  back end triggers its canary. Gossip alone never releases and never
  quarantines.

The state literals are ``serve/lanes.py``'s, redeclared here because the
router imports nothing that imports torch.
"""

from __future__ import annotations

import time

from ..obs import metrics, trace
from ..resilience import degrade

#: The lane-model states (serve/lanes.py literals, one vocabulary).
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBATION = "probation"
RELEASED = "released"

#: States that may receive traffic (draining excluded separately —
#: drain is not a health state, it is intent).
PLACEABLE = (HEALTHY, SUSPECT, PROBATION)


def backend_unit(name: str) -> str:
    """The backend's name in the shared quarantine ledger (journal
    failure rows, quarantine/release trace points, degrade kinds) — the
    router twin of ``lane:<i>`` and a sweep unit name."""
    return f"backend:{name}"


class BackendHealth:
    """One backend's health state, transition log, and ledger hooks."""

    def __init__(self, idx: int, name: str, probation_batches: int = 2,
                 journal=None, clock=time.monotonic):
        self.idx = int(idx)
        self.name = name
        self.state = HEALTHY
        #: drain intent from gossip ("draining" /healthz) — orthogonal
        #: to health: a draining backend is unplaceable but not sick,
        #: and flips back the moment gossip stops saying so.
        self.draining = False
        self.probation_batches = max(int(probation_batches), 1)
        self.probation_left = 0
        self.journal = journal
        self.failures = 0
        self.timeouts = 0
        self.gossip_fails = 0
        self.transitions: list[dict] = []
        self._clock = clock
        self._t0 = clock()

    # -- placement view ----------------------------------------------------
    def placeable(self) -> bool:
        return self.state in PLACEABLE and not self.draining

    # -- transitions -------------------------------------------------------
    def _to(self, new: str, why: str) -> None:
        old = self.state
        if old == new:
            return
        self.state = new
        self.transitions.append({
            "prev": old, "to": new, "why": why,
            "t_s": round(self._clock() - self._t0, 3)})
        metrics.counter("route_backend_transitions", backend=self.idx,
                        state=new)
        metrics.gauge("route_backend_placeable",
                      1 if self.placeable() else 0, backend=self.idx)
        trace.point("backend-state", backend=self.idx, unit=backend_unit(
            self.name), prev=old, to=new, why=why)

    def _quarantine(self, why: str) -> None:
        came_from = self.state
        self._to(QUARANTINED, why)
        if came_from == QUARANTINED:
            return  # already there: one ledger event per episode
        trace.point("quarantine", unit=backend_unit(self.name),
                    backend=self.idx, reason=why)
        degrade.degrade(f"quarantined:{backend_unit(self.name)}",
                        f"backend {self.name}: {why}")
        if self.journal is not None:
            self.journal.record_failure(backend_unit(self.name), why)

    def adopt_journal_quarantine(self, fails: int) -> None:
        """Start quarantined from recorded journal rows (router restart:
        the evidence is already on file — no new row is appended; a
        canary releases it once it proves bit-exact again)."""
        self._to(QUARANTINED, f"journal:{fails}")
        trace.point("quarantine", unit=backend_unit(self.name),
                    backend=self.idx, reason=f"journal:{fails}")
        degrade.degrade(
            f"quarantined:{backend_unit(self.name)}",
            f"backend {self.name}: {fails} failure row(s) on the route "
            f"journal (release: canary probe or route.bench "
            f"--unquarantine {backend_unit(self.name)})")

    # -- dispatch evidence -------------------------------------------------
    def note_success(self) -> None:
        if self.state == SUSPECT:
            self._to(HEALTHY, "recovered")
        elif self.state == PROBATION:
            self.probation_left -= 1
            if self.probation_left <= 0:
                self._to(RELEASED,
                         f"probation-served:{self.probation_batches}")
                trace.point("quarantine-release",
                            unit=backend_unit(self.name),
                            backend=self.idx)
                self._to(HEALTHY, "released")

    def note_failure(self, exc: BaseException) -> None:
        self.failures += 1
        if self.state == HEALTHY:
            self._to(SUSPECT, type(exc).__name__)
        else:  # a suspect or probation backend gets no second failure
            self._quarantine(type(exc).__name__)

    def note_timeout(self) -> None:
        # A hang is never transient (the lane rule): a backend that ate
        # a full attempt deadline cannot be trusted with another rider's
        # budget until a canary proves it.
        self.timeouts += 1
        self._quarantine("dispatch-timeout")

    # -- gossip evidence ---------------------------------------------------
    def note_gossip(self, status: str | None) -> None:
        """Fold one /healthz poll outcome in. ``status`` is the doc's
        ``status`` field, or None when the poll failed entirely."""
        if status == "draining":
            if not self.draining:
                self.draining = True
                trace.point("backend-draining", backend=self.idx,
                            unit=backend_unit(self.name))
            return
        self.draining = False
        if status == "ok":
            # Reconnaissance only: an ok scrape clears SUSPICION raised
            # by gossip, but a quarantined/probation backend's path back
            # runs through the canary + served traffic, not a scrape.
            if self.state == SUSPECT:
                self._to(HEALTHY, "gossip-ok")
            return
        # Unreachable or degraded: evidence against, but never straight
        # to quarantine — gossip cannot tell a dead backend from a
        # dropped scrape, so it walks healthy -> suspect and leaves the
        # verdict to the next dispatch (or keeps a sick state sick).
        self.gossip_fails += 1
        why = "gossip-unreachable" if status is None else f"gossip-{status}"
        if self.state == HEALTHY:
            self._to(SUSPECT, why)

    # -- canary verdicts (proxy runs the probe; health records it) ---------
    def canary_ok(self) -> None:
        self.probation_left = self.probation_batches
        self._to(PROBATION, "canary-ok")
        trace.point("backend-probe-ok", backend=self.idx,
                    unit=backend_unit(self.name))

    def canary_failed(self, why: str) -> None:
        metrics.counter("route_canary", backend=self.idx, outcome=why)
        self._quarantine(f"canary-{why}")

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        return {"state": self.state, "draining": self.draining,
                "failures": self.failures, "timeouts": self.timeouts,
                "gossip_fails": self.gossip_fails,
                "transitions": list(self.transitions)}
