"""Pulse: streaming alerts and a capacity model over the metrics registry.

Port of the JAX package's ``obs/pulse.py``, whole. A small streaming engine
consumes cumulative registry snapshots (live frames from
``metrics.snapshot()``, or a run directory's ``metrics-*.jsonl`` offline),
takes windowed rates and EWMA baselines, and evaluates a closed set of alert
rules (``RULES``) and a per-worker capacity model.

* ``burn_rate`` (page): bad events (deadline expiries, failed or deadline
  batches, sheds) over offered events, divided by the error budget, above
  the fast AND the slow window's threshold together.
* ``capacity_collapse`` (page): a (engine, mode)'s block throughput below
  ``collapse_frac`` of its own EWMA baseline while the queue is not empty;
  the baseline freezes while the condition holds.
* ``quarantine_flap`` (warn): more than ``flap_n`` quarantine transitions in
  the flap window.
* ``compile_storm`` (warn): ``serve_compile_us`` observations after traffic
  began (the warmup ramp lies before any window that starts with traffic)
  at least ``storm_n`` in the storm window. In the port an observation is a
  kernel-library build or load or a seam's first call (``serve/server.py``).
* ``reassembly_pressure`` (warn): ``serve_reassembly_held_bytes`` at
  ``pressure_frac`` of ``serve_transfer_budget_bytes`` for
  ``pressure_ticks`` frames in a row.

The router's series (``route_*``: router sheds, back-end state
transitions) are read where present, so a router's own pulse engine
(``route/proxy.py`` starts one with ``source="route"``) watches the routing
tier with the same rules; in a worker they read as zero. A firing is edge-triggered (a held
condition fires once and re-arms only after it clears) and is emitted as a
``pulse_alerts{rule,severity}`` counter, a ``pulse-alert`` trace point, a
row of ``/alertz`` and, for a page, an incident bundle
(``incident.trigger("pulse-alert")``, whose cooldown coalesces a storm) and
an ``OT_PROFILE_ON_ALERT`` capture window (``profiler.on_alert``, on the
server's device). The capacity rows (``/healthz`` ``capacity``) fold
``serve_rung_dispatches``/``serve_rung_device_us`` into blocks/s by engine
and mode, with the cost records' modeled GB/s beside them.

``start_live`` runs one daemon ``PulseThread`` a process, a tick every
``OT_PULSE_EVERY_S`` (default 2 s); ``OT_PULSE=0`` turns it off. Offline,
``python -m our_tree_tpu_torch.obs.pulse <run-dir> [--check]`` replays each
process's snapshot stream through the same engine and ``OT_PULSE_*`` knobs,
and ``--check`` compares the replayed set of fired rules with the
``pulse_alerts`` counters the live engine left in the final snapshots. The
replay orders each process's snapshots by their timestamps, whatever the
names of its rotated segments.

Stdlib only; never raises into its caller (the thread counts its errors);
frames are kept only as far back as the widest window, alert rows at most
``MAX_ALERT_ROWS``; the CLI prints ``#`` lines and one JSON line last.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import threading
import time

from . import metrics, trace

KIND = "ot-pulse"
VERSION = 1

#: The closed rule vocabulary (a rule outside it is a schema bug).
RULES = ("burn_rate", "capacity_collapse", "quarantine_flap",
         "compile_storm", "reassembly_pressure")
SEVERITIES = ("warn", "page")
#: page-severity rules arm the evidence capture (incident bundle +
#: OT_PROFILE_ON_ALERT window); warn-severity rules only count/trace.
PAGE_RULES = ("burn_rate", "capacity_collapse")

#: serve_batches outcomes that spend error budget.
BAD_BATCH_OUTCOMES = ("deadline", "failed", "form-failed", "split-failed")

#: /alertz row retention (per engine instance).
MAX_ALERT_ROWS = 64


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default) or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default) or default)
    except ValueError:
        return default


def enabled() -> bool:
    """``OT_PULSE`` gate for the LIVE engine (default on — the tick is
    a registry snapshot + arithmetic). Offline replay ignores it."""
    return str(os.environ.get("OT_PULSE", "1")).lower() not in (
        "0", "off", "false", "no")


def every_s() -> float:
    """Live evaluation cadence (``OT_PULSE_EVERY_S``, default 2 s —
    the metrics flusher's cadence, so live frames and replayed
    snapshot frames see the same time resolution)."""
    return min(max(_env_float("OT_PULSE_EVERY_S", 2.0), 0.05), 60.0)


class PulseConfig:
    """The rule thresholds, every one an ``OT_PULSE_*`` env knob so a
    CI drive and its offline replay share one configuration by
    construction (``from_env``)."""

    def __init__(self, *,
                 fast_window_s: float = 30.0,
                 slow_window_s: float = 120.0,
                 budget: float = 0.05,
                 fast_burn: float = 8.0,
                 slow_burn: float = 2.0,
                 min_events: int = 20,
                 collapse_frac: float = 0.5,
                 ewma_alpha: float = 0.3,
                 baseline_frames: int = 3,
                 min_dispatches: int = 8,
                 flap_n: int = 3,
                 flap_window_s: float = 60.0,
                 storm_n: int = 5,
                 storm_window_s: float = 60.0,
                 pressure_frac: float = 0.9,
                 pressure_ticks: int = 3):
        self.fast_window_s = max(float(fast_window_s), 0.1)
        self.slow_window_s = max(float(slow_window_s), self.fast_window_s)
        self.budget = min(max(float(budget), 1e-6), 1.0)
        self.fast_burn = max(float(fast_burn), 1.0)
        self.slow_burn = max(float(slow_burn), 1.0)
        self.min_events = max(int(min_events), 1)
        self.collapse_frac = min(max(float(collapse_frac), 0.01), 1.0)
        self.ewma_alpha = min(max(float(ewma_alpha), 0.01), 1.0)
        self.baseline_frames = max(int(baseline_frames), 1)
        self.min_dispatches = max(int(min_dispatches), 1)
        self.flap_n = max(int(flap_n), 1)
        self.flap_window_s = max(float(flap_window_s), 0.1)
        self.storm_n = max(int(storm_n), 1)
        self.storm_window_s = max(float(storm_window_s), 0.1)
        self.pressure_frac = min(max(float(pressure_frac), 0.01), 1.0)
        self.pressure_ticks = max(int(pressure_ticks), 1)

    @classmethod
    def from_env(cls) -> "PulseConfig":
        return cls(
            fast_window_s=_env_float("OT_PULSE_FAST_S", 30.0),
            slow_window_s=_env_float("OT_PULSE_SLOW_S", 120.0),
            budget=_env_float("OT_PULSE_BUDGET", 0.05),
            fast_burn=_env_float("OT_PULSE_FAST_BURN", 8.0),
            slow_burn=_env_float("OT_PULSE_SLOW_BURN", 2.0),
            min_events=_env_int("OT_PULSE_MIN_EVENTS", 20),
            collapse_frac=_env_float("OT_PULSE_COLLAPSE_FRAC", 0.5),
            ewma_alpha=_env_float("OT_PULSE_ALPHA", 0.3),
            baseline_frames=_env_int("OT_PULSE_BASELINE_FRAMES", 3),
            min_dispatches=_env_int("OT_PULSE_MIN_DISPATCHES", 8),
            flap_n=_env_int("OT_PULSE_FLAP_N", 3),
            flap_window_s=_env_float("OT_PULSE_FLAP_S", 60.0),
            storm_n=_env_int("OT_PULSE_STORM_N", 5),
            storm_window_s=_env_float("OT_PULSE_STORM_S", 60.0),
            pressure_frac=_env_float("OT_PULSE_PRESSURE_FRAC", 0.9),
            pressure_ticks=_env_int("OT_PULSE_PRESSURE_TICKS", 3),
        )

    def doc(self) -> dict:
        return {k: v for k, v in sorted(vars(self).items())}


# ---------------------------------------------------------------------------
# Frames: one cumulative registry snapshot, flat-keyed.
# ---------------------------------------------------------------------------


_FLAT_RE = re.compile(r"^([^{]+)(?:\{(.*)\})?$")
_PARSE_CACHE: dict[str, tuple] = {}


def _parse_flat(key: str) -> tuple:
    """``name{k=v,...}`` -> (name, ((k, v), ...)) — the inverse of
    ``metrics.flat_name`` (cached: snapshot keys recur every frame)."""
    hit = _PARSE_CACHE.get(key)
    if hit is not None:
        return hit
    m = _FLAT_RE.match(key)
    if m is None:
        out = (key, ())
    else:
        name, lab = m.groups()
        pairs = []
        for part in (lab or "").split(","):
            if "=" in part:
                k, _, v = part.partition("=")
                pairs.append((k, v))
        out = (name, tuple(pairs))
    if len(_PARSE_CACHE) < 4096:
        _PARSE_CACHE[key] = out
    return out


def frame_from_snapshot(snap: dict, ts_us: int) -> dict:
    """One frame from ``metrics.snapshot()`` (the LIVE source).
    ``pulse_*`` series are excluded — the engine must not consume its
    own output (a fired alert would otherwise perturb later frames)."""
    counters = {k: float(v)
                for k, v in (snap.get("counters") or {}).items()
                if not k.startswith("pulse_")}
    gauges = {k: float(v) for k, v in (snap.get("gauges") or {}).items()}
    hcounts = {k: int((h or {}).get("count", 0))
               for k, h in (snap.get("hists") or {}).items()}
    return {"ts_us": int(ts_us), "counters": counters, "gauges": gauges,
            "hcounts": hcounts}


def frame_from_record(rec: dict) -> dict | None:
    """One frame from a ``metrics-*.jsonl`` snapshot line (the OFFLINE
    source — ``metrics._snapshot_rec``'s list-of-[name, labels, value]
    schema, rebuilt into the same flat keys the live source uses)."""
    if not isinstance(rec, dict) or "ts" not in rec:
        return None

    def _flat(name, labels):
        return metrics.flat_name(str(name),
                                 tuple(sorted((labels or {}).items())))

    counters: dict[str, float] = {}
    for name, labels, v in rec.get("counters") or []:
        if str(name).startswith("pulse_"):
            continue
        counters[_flat(name, labels)] = float(v)
    gauges = {_flat(n, lab): float(v)
              for n, lab, v in rec.get("gauges") or []}
    hcounts = {_flat(n, lab): int((doc or {}).get("count", 0))
               for n, lab, doc in rec.get("hists") or []}
    return {"ts_us": int(rec["ts"]), "counters": counters,
            "gauges": gauges, "hcounts": hcounts}


def _match(labels: tuple, want: dict) -> bool:
    d = dict(labels)
    return all(d.get(k) == v for k, v in want.items())


def _total(part: dict, name: str, **want) -> float:
    """Sum of one metric name across label sets (optionally filtered
    by a label subset) in one frame part."""
    out = 0.0
    for key, v in part.items():
        n, labels = _parse_flat(key)
        if n != name:
            continue
        if want and not _match(labels, want):
            continue
        out += v
    return out


def _by_labels(part: dict, name: str, keys: tuple) -> dict:
    """(label values tuple) -> summed value for one metric name."""
    out: dict[tuple, float] = {}
    for key, v in part.items():
        n, labels = _parse_flat(key)
        if n != name:
            continue
        d = dict(labels)
        k = tuple(d.get(lk, "") for lk in keys)
        out[k] = out.get(k, 0.0) + v
    return out


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------


class PulseEngine:
    """The streaming rule engine: feed cumulative frames in time order
    via ``observe``; read ``alerts_doc`` (the /alertz body),
    ``capacity`` (the /healthz + artifact section), ``fired`` (rule ->
    count). One engine per metrics stream — cumulative counters are
    per-process, so the offline replay runs one engine per snapshot
    file. ``emit=False`` (replay) evaluates identically but emits
    nothing: no counters, no trace points, no bundles."""

    def __init__(self, config: PulseConfig | None = None, *,
                 source: str = "serve", proc: str | None = None,
                 emit: bool = True, device=None):
        self.config = config or PulseConfig.from_env()
        self.source = source
        #: the serving device, so that an alert's capture window takes the
        #: profiler tier the device calls for
        self.device = device
        self.proc = proc or f"{source}:{os.getpid()}"
        self._emit_enabled = bool(emit)
        self.frames: collections.deque = collections.deque()
        self.alerts: collections.deque = collections.deque(
            maxlen=MAX_ALERT_ROWS)
        self.fired: dict[str, int] = {}
        self.frames_seen = 0
        self.errors = 0
        #: edge-trigger state: rule-instance key -> armed?
        self._armed: dict[str, bool] = {}
        #: capacity baselines: (engine, mode) -> {"ewma", "updates"}
        self._baseline: dict[tuple, dict] = {}
        self._pressure_run = 0
        self._cost: dict[tuple, dict] = {}
        self._lock = threading.Lock()

    # -- inputs ------------------------------------------------------------
    def set_cost_records(self, records) -> None:
        """Attach the process's cost-model records (obs/costmodel.py)
        so capacity rows carry the modeled-bytes cross-check."""
        try:
            self._cost = {
                (r.get("engine"), r.get("mode"), int(r.get("rung", 0))): r
                for r in records or ()}
        except Exception:  # noqa: BLE001 - optional evidence only
            self._cost = {}

    def observe(self, frame: dict | None) -> list[dict]:
        """Push one frame and evaluate every rule; returns the alerts
        that fired ON THIS FRAME. Never raises (counted)."""
        try:
            if not isinstance(frame, dict) or "ts_us" not in frame:
                return []
            with self._lock:
                return self._observe_locked(frame)
        except Exception:  # noqa: BLE001 - never-raises contract
            self.errors += 1
            return []

    def _observe_locked(self, frame: dict) -> list[dict]:
        c = self.config
        prev = self.frames[-1] if self.frames else None
        if prev is not None and frame["ts_us"] <= prev["ts_us"]:
            return []  # out-of-order / duplicate snapshot: drop
        self.frames.append(frame)
        self.frames_seen += 1
        keep_us = int(max(c.slow_window_s, c.flap_window_s,
                          c.storm_window_s) * 1e6) + int(60e6)
        while (len(self.frames) > 2
               and frame["ts_us"] - self.frames[1]["ts_us"] > keep_us):
            self.frames.popleft()
        self._update_baselines(frame, prev)
        out: list[dict] = []
        for rule, key, cond, detail in self._conditions(frame):
            armed = self._armed.get(key, True)
            if cond and armed:
                self._armed[key] = False
                out.append(self._fire(rule, frame["ts_us"], detail))
            elif not cond:
                self._armed[key] = True
        return out

    # -- window helpers ----------------------------------------------------
    def _window_start(self, now_us: int, window_s: float) -> dict | None:
        """The newest frame at least ``window_s`` older than ``now_us``
        — None until the retained history covers the window, so a rule
        never judges a half-filled window (the ramp-in guard)."""
        cut = now_us - int(window_s * 1e6)
        start = None
        for f in self.frames:
            if f["ts_us"] <= cut:
                start = f
            else:
                break
        return start

    def _delta(self, frame: dict, start: dict, part: str, name: str,
               **want) -> float:
        return (_total(frame[part], name, **want)
                - _total(start[part], name, **want))

    # -- the rules ---------------------------------------------------------
    def _conditions(self, frame: dict):
        """Yield (rule, instance-key, condition, detail) for every rule
        instance — the one place the closed rule set is evaluated, live
        and replayed alike."""
        yield self._burn_rate(frame)
        yield from self._capacity_collapse(frame)
        yield self._quarantine_flap(frame)
        yield self._compile_storm(frame)
        yield self._reassembly_pressure(frame)

    def _bad_total(self, frame: dict, start: dict) -> tuple[float, float]:
        """(bad events, total offered events) across the window — both
        tiers' budget-spending signals summed (a process is one tier;
        the other tier's series are simply absent)."""
        bad = 0.0
        for outcome in BAD_BATCH_OUTCOMES:
            bad += self._delta(frame, start, "counters", "serve_batches",
                               outcome=outcome)
        bad += self._delta(frame, start, "counters",
                           "serve_deadline_expired")
        bad += self._delta(frame, start, "counters", "serve_shed")
        bad += self._delta(frame, start, "counters", "route_shed")
        bad += self._delta(frame, start, "counters", "route_exhausted")
        total = self._delta(frame, start, "counters", "serve_requests")
        total += self._delta(frame, start, "counters", "serve_shed")
        # The router's per-request admission signal is the router_queue
        # stage observation (one per admitted request).
        total += self._delta(frame, start, "hcounts", "route_stage_us",
                             stage="router_queue")
        total += self._delta(frame, start, "counters", "route_shed")
        total += self._delta(frame, start, "counters", "route_exhausted")
        return bad, total

    def _burn_rate(self, frame: dict):
        c = self.config
        now = frame["ts_us"]
        fast = self._window_start(now, c.fast_window_s)
        slow = self._window_start(now, c.slow_window_s)
        if fast is None or slow is None:
            return "burn_rate", "burn_rate", False, {}
        bad_f, tot_f = self._bad_total(frame, fast)
        bad_s, tot_s = self._bad_total(frame, slow)
        burn_f = (bad_f / tot_f / c.budget) if tot_f > 0 else 0.0
        burn_s = (bad_s / tot_s / c.budget) if tot_s > 0 else 0.0
        cond = (tot_f >= c.min_events and bad_f > 0
                and burn_f >= c.fast_burn and burn_s >= c.slow_burn)
        detail = {"burn_fast": round(burn_f, 3),
                  "burn_slow": round(burn_s, 3),
                  "bad_fast": int(bad_f), "total_fast": int(tot_f),
                  "budget": c.budget}
        return "burn_rate", "burn_rate", cond, detail

    def _rates_by_engine_mode(self, frame: dict,
                              start: dict) -> dict[tuple, dict]:
        """(engine, mode) -> {"blocks_per_s", "dispatches",
        "device_us"} over the window. Blocks are estimated as rung x
        dispatches (the rung label IS the padded block capacity), an
        upper bound the occupancy section refines post-hoc — consistent
        is what a baseline comparison needs, not exact."""
        dt_s = (frame["ts_us"] - start["ts_us"]) / 1e6
        if dt_s <= 0:
            return {}
        disp = {}
        for part, acc in ((frame, 1.0), (start, -1.0)):
            for key, v in part["counters"].items():
                n, labels = _parse_flat(key)
                if n not in ("serve_rung_dispatches",
                             "serve_rung_device_us"):
                    continue
                d = dict(labels)
                k = (d.get("engine", ""), d.get("mode", ""))
                row = disp.setdefault(
                    k, {"blocks": 0.0, "dispatches": 0.0,
                        "device_us": 0.0})
                if n == "serve_rung_dispatches":
                    row["dispatches"] += acc * v
                    try:
                        row["blocks"] += acc * v * float(d.get("rung", 0))
                    except ValueError:
                        pass
                else:
                    row["device_us"] += acc * v
        out = {}
        for k, row in disp.items():
            if row["dispatches"] <= 0:
                if self._baseline.get(k) is None:
                    continue
                row = {"blocks": 0.0, "dispatches": 0.0, "device_us": 0.0}
            out[k] = {"blocks_per_s": row["blocks"] / dt_s,
                      "dispatches": row["dispatches"],
                      "device_us": row["device_us"], "dt_s": dt_s}
        return out

    def _update_baselines(self, frame: dict, prev: dict | None) -> None:
        """Fold the fast-window throughput into the per-(engine, mode)
        EWMA — skipped while the collapse condition holds for that key
        (baseline freeze: an incident must not become its own new
        normal)."""
        c = self.config
        start = self._window_start(frame["ts_us"], c.fast_window_s)
        if start is None:
            return
        for k, row in self._rates_by_engine_mode(frame, start).items():
            if row["dispatches"] < c.min_dispatches:
                continue
            base = self._baseline.get(k)
            rate = row["blocks_per_s"]
            if base is None:
                self._baseline[k] = {"ewma": rate, "updates": 1}
                continue
            if (base["updates"] >= c.baseline_frames
                    and rate < c.collapse_frac * base["ewma"]):
                continue  # collapsing: freeze the reference
            base["ewma"] = (c.ewma_alpha * rate
                            + (1.0 - c.ewma_alpha) * base["ewma"])
            base["updates"] += 1

    def _capacity_collapse(self, frame: dict):
        c = self.config
        start = self._window_start(frame["ts_us"], c.fast_window_s)
        demand = frame["gauges"].get("serve_queue_depth", 0.0) > 0
        rates = (self._rates_by_engine_mode(frame, start)
                 if start is not None else {})
        for k, base in sorted(self._baseline.items()):
            key = f"capacity_collapse:{k[0]}:{k[1]}"
            row = rates.get(k)
            ready = base["updates"] >= c.baseline_frames
            cond = (ready and demand and row is not None
                    and base["ewma"] > 0
                    and row["blocks_per_s"]
                    < c.collapse_frac * base["ewma"])
            detail = {"engine": k[0], "mode": k[1],
                      "blocks_per_s": round(
                          row["blocks_per_s"], 3) if row else None,
                      "baseline_blocks_per_s": round(base["ewma"], 3),
                      "collapse_frac": c.collapse_frac}
            yield "capacity_collapse", key, cond, detail

    def _quarantine_flap(self, frame: dict):
        c = self.config
        start = self._window_start(frame["ts_us"], c.flap_window_s)
        if start is None:
            return "quarantine_flap", "quarantine_flap", False, {}
        n = self._delta(frame, start, "counters", "serve_lane_transitions",
                        state="quarantined")
        n += self._delta(frame, start, "counters",
                         "route_backend_transitions", state="quarantined")
        cond = n >= c.flap_n
        return ("quarantine_flap", "quarantine_flap", cond,
                {"transitions": int(n), "window_s": c.flap_window_s,
                 "flap_n": c.flap_n})

    def _compile_storm(self, frame: dict):
        c = self.config
        start = self._window_start(frame["ts_us"], c.storm_window_s)
        if start is None:
            return "compile_storm", "compile_storm", False, {}
        # Warmup guard: only a window whose START already saw traffic
        # counts — the warmup compile ramp is wholly behind it then.
        traffic = _total(start["counters"], "serve_batches") > 0
        n = self._delta(frame, start, "hcounts", "serve_compile_us")
        cond = traffic and n >= c.storm_n
        return ("compile_storm", "compile_storm", cond,
                {"compiles": int(n), "window_s": c.storm_window_s,
                 "storm_n": c.storm_n})

    def _reassembly_pressure(self, frame: dict):
        c = self.config
        held = frame["gauges"].get("serve_reassembly_held_bytes", 0.0)
        budget = frame["gauges"].get("serve_transfer_budget_bytes", 0.0)
        pinned = budget > 0 and held >= c.pressure_frac * budget
        self._pressure_run = self._pressure_run + 1 if pinned else 0
        cond = self._pressure_run >= c.pressure_ticks
        return ("reassembly_pressure", "reassembly_pressure", cond,
                {"held_bytes": int(held), "budget_bytes": int(budget),
                 "pressure_frac": c.pressure_frac,
                 "run": self._pressure_run})

    # -- emission ----------------------------------------------------------
    def _fire(self, rule: str, ts_us: int, detail: dict) -> dict:
        severity = "page" if rule in PAGE_RULES else "warn"
        alert = {"rule": rule, "severity": severity, "ts_us": ts_us,
                 "proc": self.proc, "detail": detail}
        self.alerts.append(alert)
        self.fired[rule] = self.fired.get(rule, 0) + 1
        if not self._emit_enabled:
            return alert
        try:
            metrics.counter("pulse_alerts", rule=rule, severity=severity)
        except Exception:  # noqa: BLE001 - never-raises contract
            pass
        try:
            trace.point("pulse-alert", rule=rule, severity=severity,
                        proc=self.proc)
        except Exception:  # noqa: BLE001 - never-raises contract
            pass
        if severity == "page":
            try:
                from . import incident

                incident.trigger("pulse-alert", rule=rule, **{
                    k: v for k, v in detail.items() if v is not None})
            except Exception:  # noqa: BLE001 - never a second incident
                pass
        try:
            from . import profiler

            profiler.on_alert(rule, device=self.device)
        except Exception:  # noqa: BLE001 - never-raises contract
            pass
        return alert

    # -- outputs -----------------------------------------------------------
    def capacity(self) -> dict:
        """The live capacity estimate: per-(engine, mode) measured
        blocks/s (fast-window rate + EWMA baseline), with the modeled
        HBM-bytes cross-check when cost records are attached. The
        ``total_blocks_per_s`` scalar is what the fleet supervisor's
        headroom policy reads off /healthz."""
        with self._lock:
            frame = self.frames[-1] if self.frames else None
            rates = {}
            if frame is not None:
                start = self._window_start(frame["ts_us"],
                                           self.config.fast_window_s)
                if start is not None:
                    rates = self._rates_by_engine_mode(frame, start)
            rows = []
            total = 0.0
            for k in sorted(set(self._baseline) | set(rates)):
                base = self._baseline.get(k)
                row = rates.get(k)
                ewma = base["ewma"] if base else 0.0
                cur = row["blocks_per_s"] if row else 0.0
                cap = max(ewma, cur)
                total += cap
                out = {"engine": k[0], "mode": k[1],
                       "blocks_per_s": round(cur, 3),
                       "ewma_blocks_per_s": round(ewma, 3),
                       "updates": base["updates"] if base else 0}
                if row and row["device_us"] > 0:
                    out["device_util"] = round(
                        row["device_us"] / (row["dt_s"] * 1e6), 6)
                rec = None
                if self._cost:
                    cands = [r for (e, m, _), r in self._cost.items()
                             if e == k[0] and m == k[1]]
                    rec = cands[0] if cands else None
                if rec and row and row["dt_s"] > 0:
                    out["modeled_gbps"] = round(
                        float(rec.get("hbm_bytes", 0))
                        * row["dispatches"] / 1e9 / row["dt_s"], 6)
                rows.append(out)
            return {"rows": rows,
                    "total_blocks_per_s": round(total, 3),
                    "measured": bool(rows),
                    "frames": self.frames_seen}

    def alerts_doc(self) -> dict:
        """The /alertz body for this engine."""
        with self._lock:
            return {"kind": KIND, "v": VERSION, "proc": self.proc,
                    "source": self.source, "frames": self.frames_seen,
                    "errors": self.errors,
                    "fired": dict(sorted(self.fired.items())),
                    "total": sum(self.fired.values()),
                    "alerts": list(self.alerts)}


# ---------------------------------------------------------------------------
# The live engine: one daemon thread per process.
# ---------------------------------------------------------------------------


class PulseThread(threading.Thread):
    """The live cadence: snapshot the registry every ``every_s`` and
    feed the engine. Daemon + never-raises — analytics must never take
    the service down."""

    def __init__(self, engine: PulseEngine, period_s: float | None = None):
        super().__init__(daemon=True, name="ot-pulse")
        self.engine = engine
        self._period = period_s if period_s is not None else every_s()
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.wait(self._period):
            self.tick()

    def tick(self) -> list[dict]:
        try:
            frame = frame_from_snapshot(metrics.snapshot(),
                                        time.time_ns() // 1000)
            return self.engine.observe(frame)
        except Exception:  # noqa: BLE001 - never-raises contract
            self.engine.errors += 1
            return []

    def stop(self) -> None:
        self._halt.set()


def start_live(source: str = "serve",
               config: PulseConfig | None = None,
               cost_records=None, device=None) -> PulseThread | None:
    """Start the per-process live engine (None when ``OT_PULSE=0``); the
    server calls this after its warmup, with its device."""
    if not enabled():
        return None
    try:
        # A live engine's verdict must be reproducible offline from the
        # run directory, so any process that runs one also journals its
        # metrics snapshot stream (the replay CLI's input).
        metrics.ensure_flusher()
    except Exception:  # noqa: BLE001 - never-raises contract
        pass
    engine = PulseEngine(config, source=source, device=device)
    if cost_records:
        engine.set_cost_records(cost_records)
    t = PulseThread(engine)
    t.start()
    return t


# ---------------------------------------------------------------------------
# Offline replay (the deterministic half).
# ---------------------------------------------------------------------------


_SEG_RE = re.compile(r"^(metrics-\d+-[0-9a-f]+)(?:-s(\d+))?\.jsonl$")


def _streams(run_dir: str) -> dict[str, list[str]]:
    """Process stream key -> its snapshot segment paths (the replay orders
    their records by timestamp)."""
    out: dict[str, list] = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "metrics-*.jsonl"))):
        m = _SEG_RE.match(os.path.basename(path))
        if m is not None:
            out.setdefault(m.group(1), []).append(path)
    return dict(sorted(out.items()))


def replay_stream(paths: list[str],
                  config: PulseConfig | None = None,
                  proc: str | None = None) -> dict:
    """Replay one process's snapshot stream through a fresh engine
    (emit=False), its snapshots in timestamp order across the segments.
    Returns the engine's verdict plus the live-engine record: the
    ``pulse_alerts`` counters of the stream's last snapshot (what the
    in-process engine actually fired)."""
    engine = PulseEngine(config, proc=proc or "replay", emit=False)
    interval_s = None
    recs = []
    for path in paths:
        try:
            fh = open(path, encoding="utf-8")
        except OSError:
            continue
        with fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                if rec.get("kind") == metrics.KIND:
                    interval_s = rec.get("interval_s", interval_s)
                    continue
                if isinstance(rec.get("ts"), int):
                    recs.append(rec)
    recs.sort(key=lambda r: r["ts"])
    frames = 0
    live: dict[str, int] = {}
    for rec in recs:
        frame = frame_from_record(rec)
        if frame is None:
            continue
        engine.observe(frame)
        frames += 1
        for name, labels, v in rec.get("counters") or []:
            if name == "pulse_alerts":
                rule = (labels or {}).get("rule", "?")
                live[rule] = int(v)
    return {"proc": proc, "frames": frames, "interval_s": interval_s,
            "fired": dict(sorted(engine.fired.items())),
            "alerts": list(engine.alerts),
            "live_fired": dict(sorted(live.items())),
            "errors": engine.errors}


def replay_run(run_dir: str, config: PulseConfig | None = None) -> dict:
    """Replay every process stream in one run dir; merge per-stream
    verdicts into the run-level document the CLI prints (and --check
    gates)."""
    streams = []
    fired: dict[str, int] = {}
    live: dict[str, int] = {}
    alerts: list[dict] = []
    for stem, paths in _streams(run_dir).items():
        res = replay_stream(paths, config, proc=stem)
        streams.append(res)
        for rule, n in res["fired"].items():
            fired[rule] = fired.get(rule, 0) + n
        for rule, n in res["live_fired"].items():
            live[rule] = live.get(rule, 0) + n
        alerts.extend(res["alerts"])
    alerts.sort(key=lambda a: a.get("ts_us", 0))
    return {"kind": f"{KIND}-replay", "v": VERSION, "run_dir": run_dir,
            "streams": streams, "procs": len(streams),
            "frames": sum(s["frames"] for s in streams),
            "fired": dict(sorted(fired.items())),
            "live_fired": dict(sorted(live.items())),
            "alerts": alerts}


def check(doc: dict) -> list[str]:
    """The --check verdict: the replayed fired-rule SET must equal the
    rule set the live engine recorded (``pulse_alerts`` counters in the
    final snapshots). Sets, not counts: the live cadence and the
    flusher cadence sample the same stream at different phases, so
    firing multiplicity may differ by one while the judgment — which
    rules tripped — must not."""
    out = []
    if not doc.get("procs"):
        out.append("no metrics-*.jsonl streams found in run dir")
        return out
    replayed = set(doc.get("fired") or {})
    recorded = set(doc.get("live_fired") or {})
    for rule in sorted(recorded - replayed):
        out.append(f"live engine fired {rule!r} but replay did not")
    for rule in sorted(replayed - recorded):
        out.append(f"replay fired {rule!r} but the live engine did not")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m our_tree_tpu_torch.obs.pulse",
        description="Replay a run dir's metrics snapshots through the "
                    "pulse rule engine (deterministic offline alerts). "
                    "Run with the same OT_PULSE_* env as the live drive "
                    "— thresholds are configuration, not code.")
    ap.add_argument("run_dir", help="one OT_TRACE_DIR run directory")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless the replayed fired-rule set "
                         "matches the live engine's pulse_alerts record")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON document")
    args = ap.parse_args(argv)
    doc = replay_run(args.run_dir, PulseConfig.from_env())
    problems = check(doc) if args.check else []
    doc["check"] = {"ran": bool(args.check), "problems": problems}
    if not args.json:
        print(f"# pulse: {doc['procs']} stream(s), {doc['frames']} "
              f"frame(s) replayed from {args.run_dir}")
        for a in doc["alerts"]:
            print(f"# alert: {a['rule']} [{a['severity']}] "
                  f"proc={a['proc']} detail={json.dumps(a['detail'])}")
        if not doc["alerts"]:
            print("# alert: none fired")
        if args.check:
            for p in problems:
                print(f"# check: FAIL {p}")
            if not problems:
                print(f"# check: ok (replayed rules == live rules: "
                      f"{sorted(set(doc['fired'])) or '[]'})")
    print(json.dumps(doc, sort_keys=True))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
