"""Windowed device profiling: the serve stack's capture seam.

Copy of ``our_tree_tpu.obs.profiler``, trimmed to the windows the port
arms: ``serve.bench --profile-window START:DUR`` (``armed_by="cli"``), a
direct ``start_window`` call (``"api"``) and ``harness.bench --profile DIR``
(``sweep_capture``, ``"sweep"``: one unbounded window over the whole sweep,
its torch trace in the operator's DIR, allowed with tracing off), the status
endpoint's ``/profilez`` (``profilez``, ``"http"``) and the incident recorder
(``on_incident``, ``"incident"``, one window of ``OT_PROFILE_ON_INCIDENT``
seconds after a bundle dumps) and the pulse engine (``on_alert``,
``"alert"``, one window of ``OT_PROFILE_ON_ALERT`` seconds after an alert
fires, on the server's device).

Two capture tiers, chosen per window:

* **torch**, on a server whose device is CUDA: ``torch.profiler.profile``
  with CPU and CUDA activities (CPU only when a CPU caller forces this tier
  with ``OT_PROFILE_TIER=torch``), recording the host operations of every
  thread, as the reference's trace does (the lanes launch from their own
  worker threads; CUPTI records the card's activity from every thread).
  ``torch.profiler`` keeps its state per thread while the window opens on
  the caller's thread and closes on a timer thread, so one capture thread
  owns the profiler from enter to exit and waits on an event for the close;
  the window opens once that thread has entered the profiler. At close the
  thread exports a Chrome trace (``trace.json``) into a directory beside the
  summary, which the summary names ``torch_dir`` (the reference's
  ``jax_dir``). If the profiler fails to start, ``start_window`` raises
  ``CaptureDisabled`` and the window is not armed; it never becomes a stack
  window.
* **stack**, on a CPU server or when ``OT_PROFILE_TIER=stack``: a sampler
  thread walks ``watchdog.current_stacks()`` at ``OT_PROFILE_HZ`` and
  aggregates stack signatures.

Whatever the tier, a window snapshots the metrics registry at open and
close and summarises the delta: per-(engine, mode, rung, nr) dispatches and
card time, per-stage count and time, and the lanes' busy time against their
card time. The summary lands as ``profile-<pid>-<tok>-<n>.json`` in the
``OT_TRACE_DIR`` run layout; ``crosscheck`` joins it with the cost records
(``obs/costmodel.py``), and ``serve.bench`` stamps both into its ``profile``
section. One window at a time (``CaptureBusy``); a window open at drain or
exit still closes (``finish``, atexit) so its summary is not lost.
"""

from __future__ import annotations

import atexit
import contextlib
import glob
import json
import os
import threading
import time
import uuid

from . import costmodel, metrics, trace

KIND = "ot-profile"
VERSION = 1

#: Summary schema (``validate_summary``).
REQUIRED_KEYS = ("kind", "v", "run", "pid", "t0_us", "t1_us", "seconds",
                 "tier", "armed_by", "rungs", "stages")
TIERS = ("torch", "stack")
#: The reference's arming vocabulary (who opened the window).
ARMED_BY = ("cli", "http", "incident", "sweep", "api", "alert")
#: Seconds the torch tier may take to start, and to stop and export.
TORCH_START_S = 60.0
TORCH_STOP_S = 120.0


class CaptureBusy(RuntimeError):
    """A capture window is already open (one at a time)."""


class CaptureDisabled(RuntimeError):
    """No window can open: tracing is off (no run layout for the summary to
    land in), or the torch profiler failed to start."""


_LOCK = threading.Lock()
_ACTIVE: dict | None = None
#: Closes in flight: ``_ACTIVE`` clears when the window closes (so a new one
#: can arm) while the close work (profiler stop and export, summary write)
#: may still run; ``wait_idle``/``finish`` wait it out.
_CLOSING = 0
_SEQ = 0
_PROC = uuid.uuid4().hex[:8]
_LAST: dict | None = None
_DROPPED = 0
_ATEXIT = False


def sample_hz() -> float:
    """Stack-tier sampling rate (``OT_PROFILE_HZ``, default 25)."""
    try:
        return min(max(float(os.environ.get("OT_PROFILE_HZ", 25) or 25), 1.0), 200.0)
    except ValueError:
        return 25.0


def tier_override() -> str | None:
    v = str(os.environ.get("OT_PROFILE_TIER", "") or "").lower()
    return v if v in TIERS else None


def incident_seconds() -> float:
    """``OT_PROFILE_ON_INCIDENT``: the window the incident recorder arms
    (0/unset: off)."""
    try:
        return max(float(os.environ.get("OT_PROFILE_ON_INCIDENT", 0) or 0), 0.0)
    except ValueError:
        return 0.0


def alert_seconds() -> float:
    """``OT_PROFILE_ON_ALERT``: the window a pulse alert arms (0/unset:
    off). A knob apart from the incident one: a warn alert dumps no bundle
    but may still want a window."""
    try:
        return max(float(os.environ.get("OT_PROFILE_ON_ALERT", 0) or 0), 0.0)
    except ValueError:
        return 0.0


class _StackSampler(threading.Thread):
    """The stack tier: periodic all-thread stack signatures, aggregated in
    memory (at most ``_MAX_KEYS`` distinct ones; the rest fold into
    ``"(other)"``)."""

    _MAX_KEYS = 256

    def __init__(self, hz: float):
        super().__init__(daemon=True, name="ot-profile-sampler")
        self._period = 1.0 / hz
        # Not named _stop: threading.Thread has a private _stop method.
        self._halt = threading.Event()
        self.samples = 0
        self.counts: dict[str, int] = {}

    def run(self) -> None:
        from ..resilience import watchdog

        me = threading.get_ident()
        while not self._halt.is_set():
            try:
                for ident, (name, frames) in watchdog.current_stacks(depth=4).items():
                    if ident == me:
                        continue
                    key = f"{name}: " + " < ".join(frames)
                    if key not in self.counts and len(self.counts) >= self._MAX_KEYS:
                        key = "(other)"
                    self.counts[key] = self.counts.get(key, 0) + 1
                self.samples += 1
            except Exception:  # noqa: BLE001 - sampling must never wedge
                pass
            self._halt.wait(self._period)

    def stop(self) -> dict:
        self._halt.set()
        self.join(timeout=2.0)
        return dict(self.counts)


class _TorchCapture(threading.Thread):
    """The torch tier: this thread enters ``torch.profiler.profile``, waits
    for the close, exits it and exports the Chrome trace into ``out_dir``."""

    def __init__(self, out_dir: str, cuda: bool):
        super().__init__(daemon=True, name="ot-profile-torch")
        self.out_dir = out_dir
        self._cuda = cuda
        # Not named _started: threading.Thread sets its own _started before
        # run() begins, which would open the window before the profiler.
        self._entered = threading.Event()
        self._halt = threading.Event()
        self.error: BaseException | None = None
        self.trace_path: str | None = None

    def run(self) -> None:
        try:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if self._cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(
                activities=acts,
                experimental_config=torch.profiler._ExperimentalConfig(profile_all_threads=True))
            prof.__enter__()
        except Exception as e:  # noqa: BLE001 - reported by open()
            self.error = e
            self._entered.set()
            return
        self._entered.set()
        self._halt.wait()
        try:
            prof.__exit__(None, None, None)
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(self.out_dir, "trace.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
        except Exception as e:  # noqa: BLE001 - a failed stop loses the trace,
            self.error = e      # never the summary

    def open(self) -> None:
        """Start the profiler; raises ``CaptureDisabled`` if it does not."""
        self.start()
        if not self._entered.wait(TORCH_START_S):
            self._halt.set()
            raise CaptureDisabled(f"torch.profiler did not start within {TORCH_START_S:g} s")
        if self.error is not None:
            raise CaptureDisabled(f"torch.profiler failed to start: "
                                  f"{type(self.error).__name__}: {self.error}")

    def close(self) -> str | None:
        """Stop, export and return the trace's path (None if that failed)."""
        self._halt.set()
        self.join(timeout=TORCH_STOP_S)
        return None if self.is_alive() else self.trace_path


def active() -> dict | None:
    """The open window's public view, or None."""
    entry = _ACTIVE
    if entry is None:
        return None
    return {"seq": entry["seq"], "tier": entry["tier"], "armed_by": entry["armed_by"],
            "t0_us": entry["t0_us"], "seconds": entry["seconds"]}


def _resolve_tier(device) -> tuple[str, bool]:
    """(tier, CUDA activity) for a window on ``device``."""
    cuda = device is not None and str(device).startswith("cuda")
    return tier_override() or ("torch" if cuda else "stack"), cuda


def start_window(seconds: float | None = None, armed_by: str = "api", device=None,
                 torch_dir: str | None = None) -> dict:
    """Open one capture window on a server whose device is ``device``.

    ``seconds`` set: a closer thread ends the window after that long; None:
    it stays open until ``stop_window``/``finish``. ``torch_dir`` puts the
    torch tier's trace there (``harness.bench --profile DIR``) and picks that
    tier on the CPU too, unless ``OT_PROFILE_TIER=stack``; it is the one
    case allowed with tracing off, where the trace lands and the run-layout
    summary is skipped. Raises ``CaptureBusy`` when a window is open and
    ``CaptureDisabled`` when tracing is off with no ``torch_dir`` or the
    torch profiler does not start. Returns {seq, tier, path, torch_dir?}.
    """
    global _ACTIVE, _SEQ, _ATEXIT
    if not trace.enabled() and torch_dir is None:
        raise CaptureDisabled("profiling needs the run layout: set OT_TRACE_DIR")
    with _LOCK:
        if _ACTIVE is not None:
            raise CaptureBusy(f"capture {_ACTIVE['seq']} ({_ACTIVE['armed_by']}) is "
                              "already in progress")
        d = None
        if trace.enabled():
            trace.ensure_run()
            d = trace.run_dir()
            os.makedirs(d, exist_ok=True)
        _SEQ += 1
        seq = _SEQ
        stem = f"profile-{os.getpid()}-{_PROC}-{seq}"
        tier, cuda = _resolve_tier(device)
        if torch_dir is not None and tier_override() != "stack":
            tier = "torch"
        entry = {"seq": seq, "armed_by": str(armed_by),
                 "seconds": float(seconds) if seconds else None, "run": trace.run_id(),
                 "dir": d, "path": os.path.join(d, stem + ".json") if d else None, "tier": tier,
                 "sampler": None, "capture": None, "torch_dir": None}
        if tier == "torch":
            capture = _TorchCapture(torch_dir or os.path.join(d, stem + ".torchtrace"), cuda)
            capture.open()
            entry["capture"] = capture
            entry["torch_dir"] = capture.out_dir
        else:
            sampler = _StackSampler(sample_hz())
            sampler.start()
            entry["sampler"] = sampler
        # t0 and the opening snapshot are stamped after the capture is live:
        # the profiler's start-up is neither captured time nor traffic.
        entry["t0_us"] = trace.now_us()
        entry["t0_mono"] = time.monotonic()
        entry["before"] = metrics.snapshot()
        _ACTIVE = entry
        if not _ATEXIT:
            _ATEXIT = True
            atexit.register(finish)
    trace.point("profile-window", seq=seq, armed_by=str(armed_by), tier=tier,
                seconds=entry["seconds"])
    if seconds:
        threading.Thread(target=_close_after, args=(seconds, seq), daemon=True,
                         name="ot-profile-close").start()
    out = {"seq": seq, "tier": tier, "path": entry["path"]}
    if entry["torch_dir"]:
        out["torch_dir"] = entry["torch_dir"]
    return out


def _close_after(seconds: float, seq: int) -> None:
    time.sleep(max(seconds, 0.0))
    stop_window(expected_seq=seq)


def stop_window(expected_seq: int | None = None) -> str | None:
    """Close the open window and write its summary; returns the summary's
    path (None when no window is open, or when ``expected_seq`` names
    another window: a closer thread of a window already ended must not close
    its successor)."""
    global _ACTIVE, _CLOSING, _LAST, _DROPPED
    with _LOCK:
        entry = _ACTIVE
        if entry is None or (expected_seq is not None and entry["seq"] != expected_seq):
            return None
        _ACTIVE = None
        _CLOSING += 1
    try:
        # The window closes here: t1 and the closing snapshot come before the
        # capture stops, since stopping and exporting take time that is
        # neither captured time nor traffic.
        entry["t1_us"] = trace.now_us()
        entry["measured_s"] = round(time.monotonic() - entry["t0_mono"], 3)
        after = metrics.snapshot()
        stacks: dict = {}
        samples = 0
        if entry["capture"] is not None:
            if entry["capture"].close() is None:
                entry["torch_dir"] = None
        elif entry["sampler"] is not None:
            stacks = entry["sampler"].stop()
            samples = entry["sampler"].samples
        try:
            doc = _summarise(entry, after, stacks, samples)
            if entry["path"] is None:  # tracing off: the trace is the artifact
                _LAST = doc
                return None
            with open(entry["path"], "w", encoding="utf-8") as fh:
                json.dump(doc, fh, separators=(",", ":"), sort_keys=True)
                fh.write("\n")
            _LAST = doc
            trace.point("profile-captured", seq=entry["seq"], tier=entry["tier"],
                        file=os.path.basename(entry["path"]))
            metrics.counter("profile_captures", kind=entry["tier"])
            return entry["path"]
        except Exception:  # noqa: BLE001 - a lost summary must not take the caller
            _DROPPED += 1
            return None
    finally:
        with _LOCK:
            _CLOSING -= 1


def _hist_deltas(before: dict, after: dict, names: tuple) -> dict:
    """stage -> {count, sum_us} deltas of the stage histograms."""
    out: dict[str, dict] = {}
    for name in names:
        for key, h1 in after.get("hists", {}).items():
            if not key.startswith(name + "{"):
                continue
            stage = None
            for part in key[len(name) + 1:-1].split(","):
                k, _, v = part.partition("=")
                if k == "stage":
                    stage = v
            if stage is None:
                continue
            h0 = before.get("hists", {}).get(key, {})
            dc = int(h1.get("count", 0)) - int(h0.get("count", 0))
            ds = float(h1.get("sum", 0.0)) - float(h0.get("sum", 0.0))
            if dc <= 0:
                continue
            agg = out.setdefault(stage, {"count": 0, "sum_us": 0.0})
            agg["count"] += dc
            agg["sum_us"] = round(agg["sum_us"] + ds, 1)
    return out


def _counter_delta(before: dict, after: dict, name: str) -> float:
    tot = 0.0
    for key, v in after.get("counters", {}).items():
        if key == name or key.startswith(name + "{"):
            tot += v - before.get("counters", {}).get(key, 0.0)
    return tot


def _summarise(entry: dict, after: dict, stacks: dict, samples: int) -> dict:
    before = entry["before"]
    disp0 = costmodel.series_by_key(before.get("counters", {}), "serve_rung_dispatches")
    disp1 = costmodel.series_by_key(after.get("counters", {}), "serve_rung_dispatches")
    dev0 = costmodel.series_by_key(before.get("counters", {}), "serve_rung_device_us")
    dev1 = costmodel.series_by_key(after.get("counters", {}), "serve_rung_device_us")
    rungs = []
    for key in sorted(disp1):
        d = disp1[key] - disp0.get(key, 0.0)
        if d <= 0:
            continue
        rungs.append({"engine": key[0], "mode": key[1], "rung": key[2], "nr": key[3],
                      "dispatches": int(d),
                      "device_us": int(dev1.get(key, 0.0) - dev0.get(key, 0.0))})
    busy_us = _counter_delta(before, after, "serve_lane_busy_us")
    device_us = _counter_delta(before, after, "serve_device_us")
    doc = {
        "kind": KIND, "v": VERSION, "run": entry["run"], "pid": os.getpid(), "proc": _PROC,
        "seq": entry["seq"], "t0_us": entry["t0_us"],
        "t1_us": entry.get("t1_us", trace.now_us()),
        "seconds": entry.get("measured_s", round(time.monotonic() - entry["t0_mono"], 3)),
        "armed_by": entry["armed_by"], "tier": entry["tier"],
        "rungs": rungs,
        "stages": _hist_deltas(before, after, ("serve_stage_us", "route_stage_us")),
        # The lanes' busy wall against the card's share of it over the window.
        "busy_us": int(busy_us),
        "device_us": int(device_us),
        "host_us": int(max(busy_us - device_us, 0.0)),
    }
    if entry["torch_dir"]:
        doc["torch_dir"] = os.path.basename(entry["torch_dir"])
    if stacks:
        top = sorted(stacks.items(), key=lambda kv: -kv[1])[:20]
        doc["samples"] = samples
        doc["stacks"] = [{"frames": k, "count": c} for k, c in top]
    return doc


def finish(timeout_s: float = 5.0) -> str | None:
    """Close any open window now (drain and exit path) and wait up to
    ``timeout_s`` for a close already in flight. Returns the summary's path
    when this call closed the window."""
    path = stop_window()
    deadline = time.monotonic() + timeout_s
    while (_ACTIVE is not None or _CLOSING) and time.monotonic() < deadline:
        time.sleep(0.01)
    return path


def wait_idle(timeout_s: float = 10.0) -> bool:
    """True once no window is open and no close is in flight."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if _ACTIVE is None and not _CLOSING:
            return True
        time.sleep(0.02)
    return _ACTIVE is None and not _CLOSING


def last_summary() -> dict | None:
    return _LAST


def profilez(seconds: float, device=None) -> tuple[int, dict]:
    """The ``/profilez`` body, (HTTP status, JSON doc), for a server on
    ``device``: 200 armed, 409 a window is open, 503 no window can open
    (tracing off, or the torch profiler did not start)."""
    try:
        secs = min(max(float(seconds), 0.05), 120.0)
    except (TypeError, ValueError):
        secs = 1.0
    try:
        out = start_window(secs, armed_by="http", device=device)
    except CaptureBusy as e:
        return 409, {"error": str(e), "active": active()}
    except CaptureDisabled as e:
        return 503, {"error": str(e)}
    return 200, {"armed": True, "seconds": secs, **out}


def on_incident(reason: str, device=None) -> None:
    """The incident recorder's arming hook, called after a bundle dumps (so
    the trigger's cooldown is the capture's): one window of
    ``OT_PROFILE_ON_INCIDENT`` seconds, armed on a short-lived thread so the
    profiler's start-up does not stall the serve loop. A window already
    open, or any failure, is fine: a capture never makes a second
    incident."""
    secs = incident_seconds()
    if not secs:
        return

    def _arm():
        try:
            start_window(secs, armed_by="incident", device=device)
        except Exception:  # noqa: BLE001 - never raises on this path
            pass

    threading.Thread(target=_arm, daemon=True, name="ot-profile-incident").start()


def on_alert(rule: str, device=None) -> None:
    """The pulse engine's arming hook (``obs/pulse.py``, at each alert's
    edge): one window of ``OT_PROFILE_ON_ALERT`` seconds on ``device``,
    armed on a short-lived thread so the profiler's start-up does not stall
    the pulse tick. A window already open, or any failure, is fine."""
    secs = alert_seconds()
    if not secs:
        return

    def _arm():
        try:
            start_window(secs, armed_by="alert", device=device)
        except Exception:  # noqa: BLE001 - never raises on this path
            pass

    threading.Thread(target=_arm, daemon=True, name="ot-profile-alert").start()


# ---------------------------------------------------------------------------
# Reading summaries.
# ---------------------------------------------------------------------------


def list_summaries(run_dir: str) -> list[str]:
    """Summary paths in one run dir, in capture order (mtime, then name)."""
    paths = [p for p in glob.glob(os.path.join(run_dir, "profile-*.json")) if os.path.isfile(p)]

    def _key(p):
        try:
            return (os.path.getmtime(p), p)
        except OSError:
            return (0.0, p)

    return sorted(paths, key=_key)


def load_summary(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def validate_summary(doc: dict | None) -> list[str]:
    """Schema violations as readable strings (empty: valid)."""
    if not isinstance(doc, dict):
        return ["summary is not a JSON object"]
    out = []
    for k in REQUIRED_KEYS:
        if k not in doc:
            out.append(f"missing required key {k!r}")
    if doc.get("kind") != KIND:
        out.append(f"kind is {doc.get('kind')!r}, want {KIND!r}")
    if doc.get("tier") not in TIERS:
        out.append(f"tier {doc.get('tier')!r} outside {TIERS}")
    if doc.get("armed_by") not in ARMED_BY:
        out.append(f"armed_by {doc.get('armed_by')!r} outside {ARMED_BY}")
    rungs = doc.get("rungs")
    if not isinstance(rungs, list):
        out.append("rungs is not a list")
    else:
        for i, r in enumerate(rungs):
            if not isinstance(r, dict) or not {"engine", "mode", "rung", "dispatches",
                                               "device_us"} <= set(r):
                out.append(f"rungs[{i}] malformed")
    if not isinstance(doc.get("stages"), dict):
        out.append("stages is not an object")
    return out


def crosscheck(doc: dict, records, ceiling_gbps: float | None) -> dict:
    """The measured-against-modeled join for one window: per rung, modeled
    bytes (``obs/costmodel.py``) x in-window dispatches over in-window card
    time -> GB/s moved inside the window, and its utilization of the
    ceiling."""
    by_key = {}
    for rec in records or ():
        key = (rec.get("engine"), rec.get("mode"), int(rec.get("rung", 0)), int(rec.get("nr", 0)))
        by_key.setdefault(key, rec)
    rows = []
    for r in doc.get("rungs", []):
        key = (r.get("engine"), r.get("mode"), int(r.get("rung", 0)), int(r.get("nr", 0)))
        rec = by_key.get(key)
        dus = int(r.get("device_us", 0))
        row = {"engine": key[0], "mode": key[1], "rung": key[2], "nr": key[3],
               "dispatches": int(r.get("dispatches", 0)), "device_s": round(dus / 1e6, 6),
               "modeled_dispatch_bytes": int(rec["hbm_bytes"]) if rec else None}
        if rec and dus > 0:
            gbps = float(rec["hbm_bytes"]) * row["dispatches"] / 1e9 / (dus / 1e6)
            row["window_gbps"] = round(gbps, 6)
            row["utilization"] = round(gbps / ceiling_gbps, 6) if ceiling_gbps else None
        else:
            row["window_gbps"] = None
            row["utilization"] = None
        rows.append(row)
    return {"ceiling_gbps": ceiling_gbps, "rows": rows}


@contextlib.contextmanager
def sweep_capture(torch_dir: str, device=None):
    """A whole-run capture (``harness.bench --profile DIR``): an unbounded
    window opened on enter and closed on exit. A window that cannot open
    (busy, or the profiler fails to start) makes this a no-op: a profile
    flag must never fail the sweep it observes."""
    try:
        seq = start_window(None, armed_by="sweep", device=device, torch_dir=torch_dir)["seq"]
    except (CaptureBusy, CaptureDisabled):
        seq = None
    try:
        yield
    finally:
        if seq is not None:
            stop_window(expected_seq=seq)


def dropped() -> int:
    return _DROPPED


def reset_for_tests() -> None:
    """Close any open window without a summary and clear the last one.
    ``_SEQ`` is not reset, so a stale closer thread never matches a later
    window."""
    global _ACTIVE, _LAST, _DROPPED
    entry = _ACTIVE
    if entry is not None:
        if entry["capture"] is not None:
            entry["capture"].close()
        elif entry["sampler"] is not None:
            entry["sampler"].stop()
    _ACTIVE = None
    _LAST = None
    _DROPPED = 0
