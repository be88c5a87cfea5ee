"""The incident flight recorder: a bounded dispatch ring and evidence bundles.

Port of ``our_tree_tpu.obs.incident``:

* **The ring** (``record``): a bounded in-memory deque of the latest traffic
  dispatch records (lane, rung, engine, mode, outcome, card and wall µs,
  batch label, timestamp), appended by the lanes on every dispatch
  (``serve/lanes.py``), O(1) and never raising; ``OT_INCIDENT_RING``
  entries (default 256, 0 disables). Warmup and canary dispatches are not
  traffic and stay out.
* **Triggers** (``trigger``): an incident (``REASONS``: a watchdog kill, a
  quarantine, an SLO breach, an auth-failure spike, a pulse alert) dumps a
  self-contained bundle into the ``OT_TRACE_DIR`` run layout,
  ``incident-<pid>-<tok>-<n>.json``: the ring, the metrics snapshot, the
  degrade ledger, the process's cost records and the trigger's attributes.
  A trigger within ``OT_INCIDENT_COOLDOWN_S`` (default 30) of the last
  bundle is counted as suppressed (one incident is often several signals at
  once), and ``OT_INCIDENT_MAX`` (default 8) bounds bundles a process. After
  a bundle dumps, ``obs/profiler.py``'s ``on_incident`` may arm one capture
  window (``OT_PROFILE_ON_INCIDENT``).
* **Auth-failure spike** (``note_auth_failure``): one tag mismatch is a data
  event (a per-request refusal); ``OT_INCIDENT_AUTH_SPIKE`` (default 3)
  within ``OT_INCIDENT_AUTH_WINDOW_S`` (default 10) is an incident.

Bundles are read back by ``list_bundles``, ``load_bundle``,
``validate_bundle`` (the schema check) and ``bundle_index`` (the status
endpoint's ``/incidentz``). The bundle format is the JAX package's. Never
raises; with tracing off the ring still records (for ``/incidentz``) and no
bundle is written.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import time
import uuid

from . import metrics, trace

KIND = "ot-incident"
VERSION = 1

#: The keys every bundle carries, and the fields of every ring record.
REQUIRED_KEYS = ("kind", "v", "run", "pid", "ts_us", "reason", "ring", "metrics")
RING_REQUIRED = ("t_us", "outcome")

#: The closed trigger vocabulary.
REASONS = ("watchdog-kill", "quarantine", "slo-breach", "auth-spike", "pulse-alert")

_RING: collections.deque | None = None
_PROC = uuid.uuid4().hex[:8]
_BUNDLES = 0
_SUPPRESSED = 0
_LAST_TRIGGER_US: int | None = None
_AUTH_TS: collections.deque = collections.deque(maxlen=64)
_COST_RECORDS: list = []
#: the serving device, so that an incident's capture window picks the
#: profiler tier the device calls for
_DEVICE = None


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default) or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default) or default)
    except ValueError:
        return default


def ring_capacity() -> int:
    return max(_env_int("OT_INCIDENT_RING", 256), 0)


def _now_us() -> int:
    return time.time_ns() // 1000


def _ring() -> collections.deque | None:
    global _RING
    cap = ring_capacity()
    if cap <= 0:
        return None
    if _RING is None or _RING.maxlen != cap:
        _RING = collections.deque(_RING or (), maxlen=cap)  # ot-san: owner=gil-ref-swap
    return _RING


def record(**fields) -> None:
    """Append one dispatch record to the ring (O(1), no I/O, never raises)."""
    try:
        ring = _ring()
        if ring is None:
            return
        rec = {"t_us": _now_us()}
        rec.update(fields)
        ring.append(rec)
    except Exception:  # noqa: BLE001 - never raises
        pass


def snapshot() -> list[dict]:
    """The ring's records, oldest first."""
    ring = _ring()
    return [dict(r) for r in ring] if ring else []


def set_cost_records(records, device=None) -> None:
    """Attach the process's cost records (``obs/costmodel.py``) so bundles
    stand alone, and the serving device (the server calls this at start)."""
    global _COST_RECORDS, _DEVICE
    try:
        _COST_RECORDS = list(records or [])
    except Exception:  # noqa: BLE001 - never raises
        _COST_RECORDS = []
    _DEVICE = device


def counts() -> dict:
    """{dumped, suppressed, ring}: ``/incidentz``'s live header."""
    ring = _ring()
    return {"dumped": _BUNDLES, "suppressed": _SUPPRESSED, "ring": len(ring) if ring else 0}


# ot-san: absorb=rate-capped-evidence-dump (cooldown + per-process cap)
def trigger(reason: str, **attrs) -> str | None:
    """Dump one bundle and return its path; None when suppressed (tracing
    off, within the cooldown of the last bundle, or past the per-process
    cap). Never raises: a failed dump must not make a second incident."""
    global _BUNDLES, _SUPPRESSED, _LAST_TRIGGER_US
    try:
        now = _now_us()
        if not trace.enabled():
            return None
        cooldown_us = int(max(_env_float("OT_INCIDENT_COOLDOWN_S", 30.0), 0.0) * 1e6)
        if _LAST_TRIGGER_US is not None and now - _LAST_TRIGGER_US < cooldown_us:
            _SUPPRESSED += 1
            metrics.counter("serve_incidents", reason="suppressed")
            return None
        if _BUNDLES >= max(_env_int("OT_INCIDENT_MAX", 8), 1):
            _SUPPRESSED += 1
            metrics.counter("serve_incidents", reason="suppressed")
            return None
        run = trace.ensure_run()
        d = trace.run_dir()
        if d is None:
            return None
        os.makedirs(d, exist_ok=True)
        try:
            from ..resilience import degrade
            degraded = degrade.events()
        except Exception:  # noqa: BLE001 - the ledger is optional evidence
            degraded = []
        doc = {
            "kind": KIND, "v": VERSION, "run": run, "pid": os.getpid(),
            "ts_us": now, "reason": str(reason), "attrs": dict(attrs),
            "ring": snapshot(),
            "metrics": metrics.snapshot(),
            "cost": list(_COST_RECORDS),
            "degraded": degraded,
            "suppressed_before": _SUPPRESSED,
        }
        path = os.path.join(d, f"incident-{os.getpid()}-{_PROC}-{_BUNDLES}.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, separators=(",", ":"), sort_keys=True)
            fh.write("\n")
        _BUNDLES += 1
        _LAST_TRIGGER_US = now
        metrics.counter("serve_incidents", reason=str(reason))
        trace.point("incident", reason=str(reason), bundle=os.path.basename(path))
        # After the bundle and only when it was not suppressed: the trigger's
        # cooldown is also the capture's.
        try:
            from . import profiler

            profiler.on_incident(str(reason), device=_DEVICE)
        except Exception:  # noqa: BLE001 - never a second incident
            pass
        return path
    except Exception:  # noqa: BLE001 - never raises
        return None


def note_auth_failure() -> str | None:
    """One ``auth-failed`` refusal; a spike within the window triggers a
    bundle (its path is returned)."""
    try:
        now = _now_us()
        _AUTH_TS.append(now)
        window_us = int(max(_env_float("OT_INCIDENT_AUTH_WINDOW_S", 10.0), 0.0) * 1e6)
        spike = max(_env_int("OT_INCIDENT_AUTH_SPIKE", 3), 1)
        recent = sum(1 for t in _AUTH_TS if now - t <= window_us)
        if recent >= spike:
            return trigger("auth-spike", failures=recent, window_s=window_us / 1e6)
        return None
    except Exception:  # noqa: BLE001 - never raises
        return None


# ---------------------------------------------------------------------------
# Reading bundles (/incidentz, checks).
# ---------------------------------------------------------------------------


def list_bundles(run_dir: str) -> list[str]:
    """Bundle paths in one run directory, oldest first (mtime, then name)."""
    paths = glob.glob(os.path.join(run_dir, "incident-*.json"))

    def _key(p):
        try:
            return (os.path.getmtime(p), p)
        except OSError:
            return (0.0, p)

    return sorted(paths, key=_key)


def load_bundle(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def validate_bundle(doc: dict | None) -> list[str]:
    """Schema violations as readable strings (empty: valid)."""
    if not isinstance(doc, dict):
        return ["bundle is not a JSON object"]
    out = []
    for k in REQUIRED_KEYS:
        if k not in doc:
            out.append(f"missing required key {k!r}")
    if doc.get("kind") != KIND:
        out.append(f"kind is {doc.get('kind')!r}, want {KIND!r}")
    if not isinstance(doc.get("v"), int):
        out.append("v is not an int")
    if doc.get("reason") not in REASONS:
        out.append(f"reason {doc.get('reason')!r} outside {REASONS}")
    ring = doc.get("ring")
    if not isinstance(ring, list):
        out.append("ring is not a list")
    else:
        for i, rec in enumerate(ring):
            if not isinstance(rec, dict):
                out.append(f"ring[{i}] is not an object")
                continue
            for k in RING_REQUIRED:
                if k not in rec:
                    out.append(f"ring[{i}] missing {k!r}")
    if not isinstance(doc.get("metrics"), dict):
        out.append("metrics is not an object")
    return out


def bundle_index(run_dir: str) -> list[dict]:
    """One light summary a bundle for ``/incidentz``: file, reason, ts_us,
    ring length, valid."""
    out = []
    for path in list_bundles(run_dir):
        doc = load_bundle(path)
        valid = not validate_bundle(doc)
        doc = doc or {}
        ring = doc.get("ring")
        out.append({"file": os.path.basename(path), "reason": doc.get("reason"),
                    "ts_us": doc.get("ts_us"),
                    "ring": len(ring) if isinstance(ring, list) else 0, "valid": valid})
    return out


def reset_for_tests() -> None:
    global _RING, _BUNDLES, _SUPPRESSED, _LAST_TRIGGER_US, _COST_RECORDS, _DEVICE
    _RING = None
    _BUNDLES = 0
    _SUPPRESSED = 0
    _LAST_TRIGGER_US = None
    _AUTH_TS.clear()
    _COST_RECORDS = []
    _DEVICE = None
