"""The process-global metrics registry: exact counters, gauges and log2
histograms, whatever the trace sample rate says.

Copy of ``our_tree_tpu.obs.metrics``, trimmed to what the port's serve path
calls. Every update is one dict write under one lock and never raises; a
metric name holds at most ``_MAX_SERIES`` label sets (updates past it are
dropped and counted). A histogram keeps exact count and sum beside its log2
buckets and, per bucket, the exemplar of its largest observation (on unless
``OT_EXEMPLARS=0``). With ``OT_TRACE_DIR`` set, a daemon thread appends a
cumulative snapshot line every ``OT_METRICS_FLUSH_S`` seconds (default 2) to
``metrics-<pid>-<tok>.jsonl`` in the trace run directory; under
``OT_TRACE_MAX_MB`` that file rotates into ``-s<k>`` segments as the trace
does (``obs/trace.py``), the oldest deleted and their bytes counted
(``evicted_bytes``, in every later snapshot line and on ``/metrics``).
Snapshots are cumulative, so eviction loses the early time axis, never the
totals. ``render_prometheus`` renders the registry as Prometheus text, the
status endpoint's ``/metrics`` body.
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
#: The label keys a metric may carry: the contract the ``metrics-labels``
#: rule of ``python -m our_tree_tpu_torch.analysis`` enforces statically
#: (no request ids, no tenant digests).
ALLOWED_LABEL_KEYS = ("lane", "rung", "engine", "outcome", "bucket",
                      "code", "state", "slots", "point", "kind", "mode",
                      "backend", "reason", "stage", "nr", "rule",
                      "severity")
_MAX_SERIES = 64
_EXEMPLAR_MAX = 6

#: The time-attribution waterfall's stages in request-path order: the
#: router's, then the backend's (``obs.report``'s stage table reads it).
WATERFALL_STAGES = ("router_queue", "retry", "wire", "backend_queue",
                    "pack", "worker_wait", "dispatch", "device", "reply")

_LOCK = threading.Lock()
_COUNTS: dict[tuple, float] = {}
_GAUGES: dict[tuple, float] = {}
_HISTS: dict[tuple, "_Hist"] = {}
_SERIES: dict[str, int] = {}
_DROPPED = 0
_SINK: dict | None = None
#: Serialises snapshot writes and rotation: the flusher thread and an
#: explicit ``flush_now`` (a server's stop, a test) may meet.
_SINK_LOCK = threading.Lock()
_EVICTED_BYTES = 0
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


def _label_str(labels: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in labels)


def flat_name(name: str, labels: tuple) -> str:
    """``name{k=v,...}``, the series key of the artifact JSON."""
    return f"{name}{{{_label_str(labels)}}}" if labels else name


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
    if _EVICTED_BYTES:
        rec["evicted_bytes"] = _EVICTED_BYTES
    return rec


def _max_bytes() -> int:
    """The snapshot file's cap, the trace's ``OT_TRACE_MAX_MB``; 0 (unset)
    is unbounded."""
    try:
        mb = float(os.environ.get("OT_TRACE_MAX_MB", 0) or 0)
    except ValueError:
        return 0
    return max(int(mb * (1 << 20)), 0)


def _segment_path(sink: dict) -> str:
    suffix = f"-s{sink['seg']}" if sink["seg"] else ""
    return os.path.join(sink["dir"], f"metrics-{sink['pid']}-{sink['proc']}{suffix}.jsonl")


def _open_segment(sink: dict) -> None:
    """Open the current segment and write its header (the same proc token in
    every segment); ``sink`` changes only when the whole open succeeded."""
    path = _segment_path(sink)
    fh = open(path, "a", encoding="utf-8")
    try:
        header = {"kind": KIND, "v": VERSION, "run": sink["run"], "pid": sink["pid"],
                  "proc": sink["proc"], "interval_s": flush_interval_s(),
                  "start_us": time.time_ns() // 1000}
        if sink["seg"]:
            header["seg"] = sink["seg"]
        fh.write(json.dumps(header, separators=(",", ":")) + "\n")
        fh.flush()
    except OSError:
        try:
            fh.close()
        except OSError:
            pass
        raise
    sink["fh"], sink["path"] = fh, path


# ot-san: absorb=amortized-cap-rotation (segment-full cadence only)
def _rotate_sink(sink: dict) -> None:
    """Open the next segment, retire the full one, then delete the oldest
    past the cap, counting the bytes deleted. A failed open keeps the
    current segment live (the next flush tries again)."""
    global _EVICTED_BYTES
    old_fh, old_path = sink["fh"], sink["path"]
    sink["seg"] += 1
    try:
        _open_segment(sink)
    except OSError:
        sink["seg"] -= 1
        return
    try:
        old_fh.close()
    except OSError:
        pass
    sink["segments"].append(old_path)
    keep = max(int(sink["cap_bytes"] // sink["seg_bytes"]) - 1, 1)
    while len(sink["segments"]) > keep:
        victim = sink["segments"].pop(0)
        try:
            size = os.path.getsize(victim)
            os.unlink(victim)
            _EVICTED_BYTES += size
        except OSError:
            break


def _close_sink() -> None:
    global _SINK
    if _SINK is not None:
        try:
            _SINK["fh"].close()
        except OSError:
            pass
        _SINK = None


# ot-san: absorb=amortized-snapshot-sink (open once; flusher-cadence writes)
def _sink() -> dict | None:
    """The per-process snapshot file, reopened on a run-id change; None
    while disabled or unwritable."""
    global _SINK, _DROPPED
    if not enabled():
        return None
    run = trace.ensure_run()
    if _SINK is not None and _SINK["run"] == run:
        return _SINK
    _close_sink()
    try:
        d = trace.run_dir()
        os.makedirs(d, exist_ok=True)
        cap = _max_bytes()
        sink = {"run": run, "dir": d, "pid": os.getpid(), "proc": uuid.uuid4().hex[:8],
                "seg": 0, "segments": [], "cap_bytes": cap,
                "seg_bytes": max(cap // 4, 4096) if cap else 0}
        _open_segment(sink)
        _SINK = sink
        return _SINK
    except OSError:
        _DROPPED += 1
        return None


def flush_now() -> bool:
    """Append one cumulative snapshot line (True on success), rotating the
    file past its segment size."""
    global _DROPPED
    try:
        with _SINK_LOCK:
            sink = _sink()
            if sink is None:
                return False
            sink["fh"].write(json.dumps(_snapshot_rec(time.time_ns() // 1000),
                                        separators=(",", ":")) + "\n")
            sink["fh"].flush()
            if sink["seg_bytes"] and sink["fh"].tell() >= sink["seg_bytes"]:
                _rotate_sink(sink)
        return True
    except (OSError, TypeError, ValueError):
        _DROPPED += 1
        return False


def _flusher_loop(stop: threading.Event) -> None:
    while not stop.wait(flush_interval_s()):
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
        stop = threading.Event()
        _FLUSHER = threading.Thread(target=_flusher_loop, args=(stop,), daemon=True,
                                    name="ot-metrics-flush")
        _FLUSHER.stop = stop
        _FLUSHER.start()


def _stop_flusher() -> None:
    """Stop the daemon flusher and wait for it (a flush in progress ends
    first); the next ``ensure_flusher`` starts a new one."""
    global _FLUSHER
    if _FLUSHER is not None:
        _FLUSHER.stop.set()
        _FLUSHER.join()
        _FLUSHER = None


# ---------------------------------------------------------------------------
# Prometheus text (the /metrics body).
# ---------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


#: Exemplar attribute keys -> their OpenMetrics label names.
_EXEMPLAR_LABEL = {"span": "span_id", "trace": "trace_id"}


def _prom_num(v: float) -> str:
    """A sample at full precision (``%g`` would hide a large counter's
    growth between scrapes)."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float) and v.is_integer() and abs(v) < 2 ** 63:
        return str(int(v))
    return repr(float(v))


def _prom_labels(labels, extra: str = "") -> str:
    parts = [f'{_prom_name(str(k))}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(exemplars: bool = False) -> str:
    """The registry as Prometheus exposition text (v0.0.4): counters as
    ``<name>_total``, gauges as they are, histograms as cumulative
    ``_bucket{le=...}`` series over the log2 bounds with ``_sum`` and
    ``_count``. ``exemplars=True`` appends each bucket's exemplar in
    OpenMetrics syntax, legal only in that format: the status endpoint asks
    for it only when the scraper negotiated ``application/openmetrics-text``."""
    lines: list[str] = []
    with _LOCK:
        counts = sorted(_COUNTS.items())
        gauges = sorted(_GAUGES.items())
        hists = sorted((k, {"buckets": dict(h.buckets), "count": h.count, "sum": h.sum,
                            "exemplars": dict(h.exemplars or {})})
                       for k, h in _HISTS.items())
    seen: set[str] = set()
    for (name, labels), v in counts:
        pn = _prom_name(name) + "_total"
        if pn not in seen:
            seen.add(pn)
            lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn}{_prom_labels(labels)} {_prom_num(v)}")
    for (name, labels), v in gauges:
        pn = _prom_name(name)
        if pn not in seen:
            seen.add(pn)
            lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn}{_prom_labels(labels)} {_prom_num(v)}")
    for (name, labels), h in hists:
        pn = _prom_name(name)
        if pn not in seen:
            seen.add(pn)
            lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for b, c in sorted(h["buckets"].items()):
            cum += c
            le = 'le="%d"' % (1 << b if b else 1)
            # The bucket's exemplar: `# {labels} value timestamp-seconds`.
            ex = h["exemplars"].get(b) if exemplars else None
            tail = ""
            if ex:
                exl = ",".join(f'{_prom_name(_EXEMPLAR_LABEL.get(k, k))}="{v}"'
                               for k, v in sorted(ex.items()) if k not in ("v", "ts"))
                tail = f" # {{{exl}}} {_prom_num(ex['v'])} {ex.get('ts', 0) / 1e6:.6f}"
            lines.append(f"{pn}_bucket{_prom_labels(labels, le)} {cum}{tail}")
        inf = _prom_labels(labels, 'le="+Inf"')
        lines.append(f"{pn}_bucket{inf} {h['count']}")
        lines.append(f"{pn}_sum{_prom_labels(labels)} {_prom_num(h['sum'])}")
        lines.append(f"{pn}_count{_prom_labels(labels)} {h['count']}")
    if _DROPPED:
        lines.append("# TYPE ot_metrics_dropped_total counter")
        lines.append(f"ot_metrics_dropped_total {_DROPPED}")
    if _EVICTED_BYTES:
        lines.append("# TYPE ot_metrics_evicted_bytes_total counter")
        lines.append(f"ot_metrics_evicted_bytes_total {_EVICTED_BYTES}")
    return "\n".join(lines) + "\n"


def counter_total(name: str) -> float:
    """One counter name summed across its label sets."""
    with _LOCK:
        return sum(v for (n, _), v in _COUNTS.items() if n == name)


def hist_merged(name: str) -> dict:
    """One histogram name's buckets merged across its label sets."""
    with _LOCK:
        parts = [dict(h.buckets) for (n, _), h in _HISTS.items() if n == name]
    return merge_buckets(parts)


def hist_items(name: str) -> list:
    """[(labels dict, {"buckets", "count", "sum"})] for one histogram name
    (the per-(engine, rung) warmup build-cost table)."""
    with _LOCK:
        return [(dict(labels), {"buckets": dict(h.buckets), "count": h.count, "sum": h.sum})
                for (n, labels), h in _HISTS.items() if n == name]


def counter_by_label(name: str, label_key: str) -> dict:
    """label value -> summed total for one counter name, grouped by one label
    key (``serve_requests`` by ``mode``: the per-workload split)."""
    out: dict[str, float] = {}
    with _LOCK:
        for (n, labels), v in _COUNTS.items():
            lv = dict(labels).get(label_key) if n == name else None
            if lv is not None:
                out[str(lv)] = out.get(str(lv), 0) + v
    return dict(sorted(out.items()))


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


def dropped() -> int:
    return _DROPPED


def evicted_bytes() -> int:
    """Bytes of snapshot history deleted by the ``OT_TRACE_MAX_MB`` cap."""
    return _EVICTED_BYTES


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


def reset_for_tests() -> None:
    """``reset`` plus the daemon flusher stopped, the snapshot file closed and
    the evicted bytes cleared (tests only). A flusher left running by an
    earlier test's server would otherwise flush whenever it wakes: between a
    test's trace reset and this one it opens a snapshot file of its own
    under the new run and writes the old registry into it."""
    global _EVICTED_BYTES
    _stop_flusher()
    with _SINK_LOCK:
        _close_sink()
    reset()
    _EVICTED_BYTES = 0
