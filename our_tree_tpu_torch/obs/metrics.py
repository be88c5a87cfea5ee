"""The process-global metrics registry: exact counters, gauges and log2
histograms, whatever the trace sample rate says.

Copy of ``our_tree_tpu.obs.metrics``, trimmed to what the port's serve path
calls. Every update is one dict write under one lock and never raises; a
metric name holds at most ``_MAX_SERIES`` label sets (updates past it are
dropped and counted). A histogram keeps exact count and sum beside its log2
buckets and, per bucket, the exemplar of its largest observation (on unless
``OT_EXEMPLARS=0``). With ``OT_TRACE_DIR`` set, a daemon thread appends a
cumulative snapshot line every ``OT_METRICS_FLUSH_S`` seconds (default 2) to
``metrics-<pid>-<tok>.jsonl`` in the trace run directory. The reference's
Prometheus rendering, snapshot rotation and ``hist`` export helpers wait for
the rest of ``obs``.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import threading
import time
import uuid

from . import trace

KIND = "ot-metrics"
VERSION = 1
_MAX_SERIES = 64
_EXEMPLAR_MAX = 6

_LOCK = threading.Lock()
_COUNTS: dict[tuple, float] = {}
_GAUGES: dict[tuple, float] = {}
_HISTS: dict[tuple, "_Hist"] = {}
_SERIES: dict[str, int] = {}
_DROPPED = 0
_SINK: dict | None = None
_FLUSHER: threading.Thread | None = None
_ATEXIT_REGISTERED = False


class _Hist:
    """One log2-bucket histogram series with exact count/sum and per-bucket
    max exemplars."""

    __slots__ = ("buckets", "count", "sum", "exemplars")

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.exemplars: dict[int, dict] | None = None


def enabled() -> bool:
    """Snapshot flushing is on iff tracing is (``OT_TRACE_DIR``)."""
    return bool(os.environ.get("OT_TRACE_DIR"))


def flush_interval_s() -> float:
    try:
        return max(float(os.environ.get("OT_METRICS_FLUSH_S", 2.0) or 2.0), 0.05)
    except ValueError:
        return 2.0


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items()))) if labels else (name, ())


def _admit_locked(store: dict, key: tuple) -> bool:
    if key in store:
        return True
    n = _SERIES.get(key[0], 0)
    if n >= _MAX_SERIES:
        return False
    _SERIES[key[0]] = n + 1
    return True


def counter(name: str, n: float = 1, **labels) -> None:
    """Add ``n`` to the named counter series."""
    global _DROPPED
    key = _key(name, labels)
    with _LOCK:
        if not _admit_locked(_COUNTS, key):
            _DROPPED += 1
            return
        _COUNTS[key] = _COUNTS.get(key, 0) + n


def gauge(name: str, value: float, **labels) -> None:
    """Set the named gauge series (last write wins)."""
    global _DROPPED
    key = _key(name, labels)
    with _LOCK:
        if not _admit_locked(_GAUGES, key):
            _DROPPED += 1
            return
        _GAUGES[key] = value


def gauge_max(name: str, value: float, **labels) -> None:
    """Raise the named gauge to ``value`` if higher (high-water marks)."""
    global _DROPPED
    key = _key(name, labels)
    with _LOCK:
        if not _admit_locked(_GAUGES, key):
            _DROPPED += 1
            return
        if value > _GAUGES.get(key, float("-inf")):
            _GAUGES[key] = value


def bucket_of(value: float) -> int:
    """Log2 bucket exponent: bucket b >= 1 spans [2^(b-1), 2^b); 0 holds
    everything below 1."""
    v = int(value)
    return v.bit_length() if v >= 1 else 0


def exemplars_enabled() -> bool:
    return str(os.environ.get("OT_EXEMPLARS", "1")).lower() not in ("0", "off", "false")


def observe(name: str, value: float, exemplar: dict | None = None, **labels) -> None:
    """One histogram observation; ``exemplar`` is kept iff it is the largest
    observation of its bucket."""
    global _DROPPED
    b = bucket_of(value)
    key = _key(name, labels)
    keep_ex = exemplar is not None and exemplars_enabled()
    with _LOCK:
        if not _admit_locked(_HISTS, key):
            _DROPPED += 1
            return
        h = _HISTS.get(key)
        if h is None:
            h = _HISTS[key] = _Hist()
        h.buckets[b] = h.buckets.get(b, 0) + 1
        h.count += 1
        h.sum += float(value)
        if keep_ex:
            ex = h.exemplars if h.exemplars is not None else {}
            h.exemplars = ex
            cur = ex.get(b)
            if cur is None or float(value) >= cur["v"]:
                ex[b] = {"v": float(value), "ts": time.time_ns() // 1000, **exemplar}
                while len(ex) > _EXEMPLAR_MAX:
                    del ex[min(ex)]


def percentile_exact(sorted_vals, p: float) -> float:
    """Nearest-rank percentile over a full sorted sample (0 < p <= 100)."""
    n = len(sorted_vals)
    if not n:
        return 0.0
    rank = max(math.ceil(p / 100.0 * n), 1)
    return sorted_vals[min(rank, n) - 1]


def percentile_from_buckets(buckets: dict, p: float) -> float:
    """Percentile interpolated linearly inside the covering log2 bucket."""
    items = sorted((int(b), int(c)) for b, c in buckets.items() if c)
    total = sum(c for _, c in items)
    if not total:
        return 0.0
    rank = max(math.ceil(p / 100.0 * total), 1)
    seen = 0
    for b, c in items:
        if seen + c >= rank:
            lo = 0.0 if b == 0 else float(1 << (b - 1))
            hi = 1.0 if b == 0 else float(1 << b)
            return lo + (hi - lo) * (rank - seen) / c
        seen += c
    return float(1 << items[-1][0])


def merge_buckets(hists) -> dict:
    """Sum bucket dicts into one {exponent: count} dict."""
    out: dict[int, int] = {}
    for b in hists:
        for k, v in b.items():
            out[int(k)] = out.get(int(k), 0) + int(v)
    return out


def flat_name(name: str, labels: tuple) -> str:
    """``name{k=v,...}``, the series key of the artifact JSON."""
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}" if labels else name


def _hist_doc(h: _Hist) -> dict:
    doc = {"buckets": {str(b): c for b, c in sorted(h.buckets.items())},
           "count": h.count, "sum": round(h.sum, 3)}
    if h.exemplars:
        doc["exemplars"] = {str(b): dict(e) for b, e in sorted(h.exemplars.items())}
    return doc


def snapshot() -> dict:
    """The registry as one JSON-clean dict with flat series keys."""
    with _LOCK:
        counts = {flat_name(n, lb): v for (n, lb), v in _COUNTS.items()}
        gauges = {flat_name(n, lb): v for (n, lb), v in _GAUGES.items()}
        hists = {flat_name(n, lb): _hist_doc(h) for (n, lb), h in _HISTS.items()}
    out: dict = {"counters": dict(sorted(counts.items())),
                 "gauges": dict(sorted(gauges.items())),
                 "hists": dict(sorted(hists.items()))}
    if _DROPPED:
        out["dropped"] = _DROPPED
    return out


def _snapshot_rec(ts_us: int) -> dict:
    with _LOCK:
        rec = {"ts": ts_us,
               "counters": [[n, dict(lb), v] for (n, lb), v in sorted(_COUNTS.items())],
               "gauges": [[n, dict(lb), v] for (n, lb), v in sorted(_GAUGES.items())],
               "hists": [[n, dict(lb), _hist_doc(h)] for (n, lb), h in sorted(_HISTS.items())]}
    if _DROPPED:
        rec["dropped"] = _DROPPED
    return rec


def _sink() -> dict | None:
    """The per-process snapshot file, reopened on a run-id change; None
    while disabled or unwritable."""
    global _SINK, _DROPPED
    if not enabled():
        return None
    run = trace.ensure_run()
    if _SINK is not None and _SINK["run"] == run:
        return _SINK
    if _SINK is not None:
        try:
            _SINK["fh"].close()
        except OSError:
            pass
        _SINK = None
    try:
        d = trace.run_dir()
        os.makedirs(d, exist_ok=True)
        proc = uuid.uuid4().hex[:8]
        fh = open(os.path.join(d, f"metrics-{os.getpid()}-{proc}.jsonl"), "a", encoding="utf-8")
        fh.write(json.dumps({"kind": KIND, "v": VERSION, "run": run, "pid": os.getpid(),
                             "proc": proc, "interval_s": flush_interval_s(),
                             "start_us": time.time_ns() // 1000}, separators=(",", ":")) + "\n")
        fh.flush()
        _SINK = {"run": run, "fh": fh}
        return _SINK
    except OSError:
        _DROPPED += 1
        return None


def flush_now() -> bool:
    """Append one cumulative snapshot line (True on success)."""
    global _DROPPED
    try:
        sink = _sink()
        if sink is None:
            return False
        sink["fh"].write(json.dumps(_snapshot_rec(time.time_ns() // 1000),
                                    separators=(",", ":")) + "\n")
        sink["fh"].flush()
        return True
    except (OSError, TypeError, ValueError):
        _DROPPED += 1
        return False


def _flusher_loop() -> None:
    while True:
        time.sleep(flush_interval_s())
        if enabled() and (_COUNTS or _GAUGES or _HISTS):
            flush_now()


def ensure_flusher() -> None:
    """Start the one daemon flusher thread and the exit-time flush
    (idempotent)."""
    global _FLUSHER, _ATEXIT_REGISTERED
    if not _ATEXIT_REGISTERED:
        _ATEXIT_REGISTERED = True
        atexit.register(lambda: enabled() and (_COUNTS or _GAUGES or _HISTS) and flush_now())
    if _FLUSHER is None or not _FLUSHER.is_alive():
        _FLUSHER = threading.Thread(target=_flusher_loop, daemon=True, name="ot-metrics-flush")
        _FLUSHER.start()


def counter_total(name: str) -> float:
    """One counter name summed across its label sets."""
    with _LOCK:
        return sum(v for (n, _), v in _COUNTS.items() if n == name)




def hist_by_label(name: str, label_key: str) -> dict:
    """label value -> merged buckets for one histogram name."""
    parts: dict[str, list] = {}
    with _LOCK:
        for (n, labels), h in _HISTS.items():
            lv = dict(labels).get(label_key) if n == name else None
            if lv is not None:
                parts.setdefault(str(lv), []).append(dict(h.buckets))
    return {k: merge_buckets(v) for k, v in sorted(parts.items())}


def stage_percentiles(names=("serve_stage_us",)) -> dict:
    """stage -> {p50_us, p95_us, p99_us, count} from the stage histograms
    (the bench artifact's ``stages`` section)."""
    merged: dict[str, dict] = {}
    for name in names:
        for stage, buckets in hist_by_label(name, "stage").items():
            merged[stage] = merge_buckets([merged.get(stage, {}), buckets])
    return {stage: {"p50_us": round(percentile_from_buckets(b, 50), 1),
                    "p95_us": round(percentile_from_buckets(b, 95), 1),
                    "p99_us": round(percentile_from_buckets(b, 99), 1),
                    "count": sum(b.values())}
            for stage, b in sorted(merged.items())}


def reset() -> None:
    """Clear every series: a bench drive counts from zero, as it would in a
    fresh process."""
    global _DROPPED
    with _LOCK:
        _COUNTS.clear()
        _GAUGES.clear()
        _HISTS.clear()
        _SERIES.clear()
    _DROPPED = 0
