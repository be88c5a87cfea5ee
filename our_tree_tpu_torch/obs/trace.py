"""The process-global tracer: spans, counters, gauges, instant points.

Copy of ``our_tree_tpu.obs.trace``, trimmed to what the port's serve path
calls. One process writes one append-only JSONL event file under
``$OT_TRACE_DIR/<run-id>/trace-<pid>-<tok>.jsonl``; with ``OT_TRACE_DIR``
unset every call is one check and ``span()`` returns a shared no-op. Span
begin and end are separate events, flushed as written, so a dispatch that
never ends leaves its begin on disk (an orphan: the kill evidence of a hung
dispatch). Tracing never raises: a failed write is a counted drop.

Per-request spans are head-sampled (``OT_TRACE_SAMPLE``, decided once per
request at admission by ``sample()``): an unsampled span
(``maybe_span(False, ...)``) writes nothing on the happy path and
materialises, with its original timestamp, when it fails or is forced.
``OT_TRACE_RUN`` names the run (minted by ``ensure_run`` when unset) and
``OT_TRACE_PARENT`` gives root spans a parent; ``child_env`` hands both to a
child process, so its root spans nest under the caller's live span (the
sweep's isolated children).

``OT_TRACE_MAX_MB`` caps a process's trace on disk: its event file rotates
into segments of a quarter of the cap (``trace-<pid>-<tok>.jsonl``, then
``-s1``, ``-s2``, ...; each opens with its own header, the later ones naming
their ``seg``) and the oldest closed segments are deleted, so at most the cap
stays on disk. The bytes deleted are counted (``evicted_bytes`` in
``metrics_snapshot``). A rotation opens the next segment before it retires
the full one, so a failed open keeps the current segment live and rotation
tries again on a later write. ``obs.export`` stitches the segments in the
order they were written.

Event schema (the reference's v1)::

    {"kind":"ot-trace","v":1,"run":...,"pid":...,"proc":"a1b2c3d4",...}
    {"ev":"b","id":"a1b2c3d4.1","parent":null,"name":"...","ts":...,"tid":0,"attrs":{}}
    {"ev":"e","id":"a1b2c3d4.1","ts":...,"status":"ok","attrs":{...}}
    {"ev":"c","name":"...","ts":...,"n":1,"attrs":{...}}
    {"ev":"g","name":"...","ts":...,"value":1.5,"attrs":{...}}
    {"ev":"p","name":"...","ts":...,"attrs":{...}}
"""

from __future__ import annotations

import json
import os
import random
import sys
import threading
import time
import uuid

KIND = "ot-trace"
VERSION = 1

_SPANS_STARTED = 0
_DROPPED = 0
#: Bytes of trace history deleted by segment rotation (``OT_TRACE_MAX_MB``).
_EVICTED_BYTES = 0
_COUNTS: dict[str, float] = {}
_GAUGES: dict[str, float] = {}
_TIDS: dict[int, int] = {}
_LOCK = threading.Lock()
_TLS = threading.local()
#: Lazily opened per-process state {"run", "dir", "fh", "path", "proc", "pid",
#: "seq", "seg", "segments", "cap_bytes", "seg_bytes"}.
_STATE: dict | None = None


def enabled() -> bool:
    """Tracing is on iff ``OT_TRACE_DIR`` is set."""
    return bool(os.environ.get("OT_TRACE_DIR"))


_SAMPLE_CACHE: tuple[str, float] = ("", 1.0)


def sample_rate() -> float:
    """The head-sampling rate (``OT_TRACE_SAMPLE``), clamped to [0, 1];
    unset is 1 (every request traced)."""
    global _SAMPLE_CACHE
    raw = os.environ.get("OT_TRACE_SAMPLE", "")
    cached_raw, cached = _SAMPLE_CACHE
    if raw == cached_raw:
        return cached
    try:
        rate = min(max(float(raw), 0.0), 1.0) if raw else 1.0
    except ValueError:
        rate = 1.0
    _SAMPLE_CACHE = (raw, rate)
    return rate


def sample() -> bool:
    """One head-sampling coin flip (the admission-time decision)."""
    rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return random.random() < rate


def now_us() -> int:
    """Epoch microseconds, every event's ``ts`` domain (the profiler stamps
    its windows with it)."""
    return time.time_ns() // 1000


def _tid() -> int:
    ident = threading.get_ident()
    with _LOCK:
        return _TIDS.setdefault(ident, len(_TIDS))


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def run_id() -> str | None:
    """The current run id (None while disabled)."""
    if not enabled():
        return None
    state = _STATE
    if state is not None:
        return state["run"]
    return os.environ.get("OT_TRACE_RUN") or None


def ensure_run() -> str | None:
    """Adopt ``OT_TRACE_RUN`` or mint a run id and publish it there;
    None while disabled."""
    if not enabled():
        return None
    rid = os.environ.get("OT_TRACE_RUN")
    if not rid:
        rid = time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
        os.environ["OT_TRACE_RUN"] = rid
    return rid


def run_dir() -> str | None:
    """``$OT_TRACE_DIR/<run-id>`` (None while disabled)."""
    if not enabled():
        return None
    return os.path.join(os.environ["OT_TRACE_DIR"], ensure_run())


def _max_bytes() -> int:
    """The per-process trace cap (``OT_TRACE_MAX_MB``) in bytes; 0 (unset)
    is unbounded."""
    try:
        mb = float(os.environ.get("OT_TRACE_MAX_MB", 0) or 0)
    except ValueError:
        return 0
    return max(int(mb * (1 << 20)), 0)


def _segment_path(state: dict) -> str:
    suffix = f"-s{state['seg']}" if state["seg"] else ""
    return os.path.join(state["dir"], f"trace-{state['pid']}-{state['proc']}{suffix}.jsonl")


def _open_segment_locked(state: dict) -> None:
    """Open the current segment and write its header; the caller holds
    ``_LOCK``. ``state`` changes only when the whole open succeeded."""
    path = _segment_path(state)
    fh = open(path, "a", encoding="utf-8")
    try:
        header = {"kind": KIND, "v": VERSION, "run": state["run"], "pid": state["pid"],
                  "proc": state["proc"], "argv": " ".join(sys.argv[:6])[:300],
                  "start_us": now_us()}
        if state["seg"]:
            header["seg"] = state["seg"]
        fh.write(json.dumps(header, separators=(",", ":"), default=repr) + "\n")
        fh.flush()
    except OSError:
        try:
            fh.close()
        except OSError:
            pass
        raise
    state["fh"], state["path"] = fh, path


def _rotate_locked(state: dict) -> None:
    """Open the next segment, retire the full one, then delete the oldest
    past the cap; the caller holds ``_LOCK``. A failed open keeps the
    current segment live (the next write tries again)."""
    global _EVICTED_BYTES
    old_fh, old_path = state["fh"], state["path"]
    state["seg"] += 1
    try:
        _open_segment_locked(state)
    except OSError:
        state["seg"] -= 1
        return
    try:
        old_fh.close()
    except OSError:
        pass
    state["segments"].append(old_path)
    # A quarter of the cap a segment: the live one and three closed.
    keep = max(int(state["cap_bytes"] // state["seg_bytes"]) - 1, 1)
    while len(state["segments"]) > keep:
        victim = state["segments"].pop(0)
        try:
            size = os.path.getsize(victim)
            os.unlink(victim)
            _EVICTED_BYTES += size
        except OSError:
            break


def _close_state_locked() -> None:
    global _STATE
    if _STATE is not None:
        try:
            _STATE["fh"].close()
        except OSError:
            pass
        _STATE = None


def _state() -> dict | None:
    """Open this process's event file, header first, on first use."""
    global _STATE, _DROPPED
    with _LOCK:
        if _STATE is not None:
            if _STATE["run"] == os.environ.get("OT_TRACE_RUN", _STATE["run"]):
                return _STATE
            _close_state_locked()
        try:
            d = run_dir()
            os.makedirs(d, exist_ok=True)
            cap = _max_bytes()
            state = {"run": os.environ["OT_TRACE_RUN"], "dir": d,
                     "proc": uuid.uuid4().hex[:8], "pid": os.getpid(), "seq": 0, "seg": 0,
                     "segments": [], "cap_bytes": cap,
                     "seg_bytes": max(cap // 4, 4096) if cap else 0}
            _open_segment_locked(state)
            _STATE = state
            return _STATE
        except OSError:
            _DROPPED += 1
            return None


def _write(rec: dict) -> None:
    """One JSONL line, flushed."""
    global _DROPPED
    state = _STATE
    if state is None:
        return
    try:
        line = json.dumps(rec, separators=(",", ":"), default=repr)
        with _LOCK:
            state["fh"].write(line + "\n")
            state["fh"].flush()
            if state["seg_bytes"] and state["fh"].tell() >= state["seg_bytes"]:
                _rotate_locked(state)
    except (TypeError, ValueError, OSError):
        # ValueError covers a racing reopen ("I/O operation on closed file").
        _DROPPED += 1


class Span:
    """One live span: ``id`` is its handle."""

    __slots__ = ("id", "name")

    def __init__(self, sid: str, name: str):
        self.id, self.name = sid, name


def _begin(name: str, attrs: dict, parent: str | None, ts: int) -> Span | None:
    global _SPANS_STARTED
    st = _state()
    if st is None:
        return None
    with _LOCK:
        st["seq"] += 1
        sid = f"{st['proc']}.{st['seq']}"
    _SPANS_STARTED += 1
    rec = {"ev": "b", "id": sid, "parent": parent, "name": name, "ts": ts, "tid": _tid()}
    if attrs:
        rec["attrs"] = attrs
    _write(rec)
    return Span(sid, name)


def _end(span: Span, exc_type, end_attrs: dict | None) -> None:
    rec = {"ev": "e", "id": span.id, "ts": now_us(),
           "status": "ok" if exc_type is None else f"error:{exc_type.__name__}"}
    if end_attrs:
        rec["attrs"] = end_attrs
    _write(rec)


def current_span_id() -> str | None:
    """The innermost live span's id on this thread."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def child_env(env: dict) -> dict:
    """A copy of ``env`` with the run id and the current span id injected
    (``OT_TRACE_RUN``, ``OT_TRACE_PARENT``); unchanged while disabled."""
    if not enabled():
        return env
    out = dict(env)
    out["OT_TRACE_DIR"] = os.environ["OT_TRACE_DIR"]
    out["OT_TRACE_RUN"] = ensure_run()
    parent = current_span_id()
    if parent:
        out["OT_TRACE_PARENT"] = parent
    else:
        out.pop("OT_TRACE_PARENT", None)
    return out


def _ambient_parent(override: str | None) -> str | None:
    stack = getattr(_TLS, "stack", None)
    return override or (stack[-1] if stack else os.environ.get("OT_TRACE_PARENT") or None)


class _SpanCM:
    """An eager span: begin written at enter, end at exit (idempotent).
    A detached span never joins the per-thread nesting stack."""

    def __init__(self, name: str, attrs: dict, detached: bool = False,
                 parent: str | None = None):
        self._name, self._attrs = name, attrs
        self._detached = detached
        self._parent = parent
        self._end_attrs: dict | None = None
        self._span: Span | None = None

    def __enter__(self) -> Span | None:
        self._span = _begin(self._name, self._attrs, _ambient_parent(self._parent), now_us())
        if self._span is not None and not self._detached:
            _stack().append(self._span.id)
        return self._span

    def note(self, **attrs) -> None:
        """Attrs for the END event (measurements known only at close)."""
        if attrs:
            self._end_attrs = {**(self._end_attrs or {}), **attrs}

    def __exit__(self, exc_type, exc, tb):
        if self._span is None:
            return False
        if not self._detached:
            stack = _stack()
            if stack and stack[-1] == self._span.id:
                stack.pop()
        _end(self._span, exc_type, self._end_attrs)
        self._span = None
        return False

    def force(self):
        """No-op on an eager span (already on disk)."""
        return self._span

    @property
    def span_id(self) -> str | None:
        return self._span.id if self._span is not None else None


class _DeferredSpanCM:
    """An unsampled detached span: the begin is captured, not written. It
    materialises with its original timestamp when the region exits with
    an exception (begin + error end) or when ``force()`` is called (begin
    only, the span left open: the orphan of a hung dispatch); a clean exit
    without ``force()`` writes nothing."""

    __slots__ = ("_name", "_attrs", "_ts", "_parent", "_span", "_done", "_override",
                 "_end_attrs")

    def __init__(self, name: str, attrs: dict, parent: str | None = None):
        self._name, self._attrs = name, attrs
        self._ts: int | None = None
        self._parent = None
        self._override = parent
        self._end_attrs: dict | None = None
        self._span: Span | None = None
        self._done = False

    def __enter__(self):
        self._ts = now_us()
        self._parent = _ambient_parent(self._override)
        return None

    def force(self) -> Span | None:
        if self._span is None and not self._done and self._ts is not None:
            self._span = _begin(self._name, self._attrs, self._parent, self._ts)
        return self._span

    def note(self, **attrs) -> None:
        if attrs:
            self._end_attrs = {**(self._end_attrs or {}), **attrs}

    @property
    def span_id(self) -> str | None:
        return self._span.id if self._span is not None else None

    def __exit__(self, exc_type, exc, tb):
        if self._done:
            return False
        if exc_type is not None:
            self.force()
        if self._span is not None:
            _end(self._span, exc_type, self._end_attrs)
        self._done = True
        self._span = None
        return False


class _NullCM:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def force(self):
        return None

    def note(self, **attrs):
        return None

    @property
    def span_id(self):
        return None


_NULL = _NullCM()


def span(name: str, **attrs):
    """Context manager timing a region, nested per thread."""
    if not enabled():
        return _NULL
    return _SpanCM(name, attrs)


def detached_span(name: str, parent: str | None = None, **attrs):
    """A span outside the per-thread nesting stack, for lifetimes that
    overlap on one thread (enter and exit it explicitly; exit is
    idempotent; one never exited is an orphan)."""
    if not enabled():
        return _NULL
    return _SpanCM(name, attrs, detached=True, parent=parent)


def maybe_span(sampled: bool, name: str, parent: str | None = None, **attrs):
    """A detached span gated by the request's head-sampling decision:
    eager when ``sampled``, deferred (``_DeferredSpanCM``) otherwise."""
    if not enabled():
        return _NULL
    if sampled:
        return _SpanCM(name, attrs, detached=True, parent=parent)
    return _DeferredSpanCM(name, attrs, parent=parent)


def point(name: str, **attrs) -> None:
    """One instant event."""
    if not enabled() or _state() is None:
        return
    rec = {"ev": "p", "name": name, "ts": now_us()}
    if attrs:
        rec["attrs"] = attrs
    _write(rec)


def counter(name: str, n: float = 1, **attrs) -> None:
    """Add ``n`` to the named counter and emit one ``c`` event."""
    if not enabled() or _state() is None:
        return
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n
    rec = {"ev": "c", "name": name, "ts": now_us(), "n": n}
    if attrs:
        rec["attrs"] = attrs
    _write(rec)


def gauge(name: str, value: float, **attrs) -> None:
    """Set the named gauge and emit one ``g`` event."""
    if not enabled() or _state() is None:
        return
    with _LOCK:
        _GAUGES[name] = value
    rec = {"ev": "g", "name": name, "ts": now_us(), "value": value}
    if attrs:
        rec["attrs"] = attrs
    _write(rec)


def metrics_snapshot() -> dict:
    """Run id, span count, counter totals, gauges, drops and evicted bytes,
    for the bench JSON line."""
    snap: dict = {"run": run_id(), "spans": _SPANS_STARTED}
    with _LOCK:
        if _COUNTS:
            snap["counters"] = dict(sorted(_COUNTS.items()))
        if _GAUGES:
            snap["gauges"] = dict(sorted(_GAUGES.items()))
    if _DROPPED:
        snap["dropped"] = _DROPPED
    if _EVICTED_BYTES:
        snap["evicted_bytes"] = _EVICTED_BYTES
    return snap


def reset_for_tests() -> None:
    """Close the event file and clear every aggregate (tests only)."""
    global _SPANS_STARTED, _DROPPED, _EVICTED_BYTES
    with _LOCK:
        _close_state_locked()
        _COUNTS.clear()
        _GAUGES.clear()
        _TIDS.clear()
    _SPANS_STARTED = 0
    _DROPPED = 0
    _EVICTED_BYTES = 0
    _TLS.stack = []
