"""Port of ``our_tree_tpu.analysis.astrules``: layer 1, the AST linter,
every rule by the same id, severity and message shape, aimed at the port's
own seams.

Each rule is a ``Rule`` with an ``id``, a severity, a one-line ``doc`` and
a ``check(ctx)`` generator of ``(node, message)`` pairs over a
``FileContext`` (repo-relative path, source, tree); a rule decides its
scope itself (``wallclock`` skips ``obs/``, ``subprocess-isolate`` skips
``resilience/isolate.py``). The rules are syntactic: who may say what
where. A guarded dispatch is recognised lexically, a call inside a
``with`` whose context expression routes through ``watchdog.deadline``.

Where the reference names JAX's seams, these rules name the port's: the
card's barriers (``torch.cuda.synchronize``, an event's or stream's
``.synchronize()``), its staging (``.cuda()``, ``.to(<device>)``) and the
kernel wrappers of ``ops/cuda_aes.py``, ``ops/cuda_ghash.py`` and
``ops/cuda_arc4.py`` (``dispatch-watchdog``, ``serve-lane-seam``); and
``route-backend-seam`` forbids any ``torch`` import in ``route/`` (the
routing tier makes no CUDA context, which ``chip_smoke.py`` phase 17
checks at run time). ``fault-points`` and ``metrics-labels`` read the
port's own ``resilience.faults.KNOWN_POINTS`` and
``obs.metrics.ALLOWED_LABEL_KEYS``. Stdlib only, apart from those two
registries (stdlib-only modules themselves).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Callable, Iterator

from .findings import Finding, anchored

# The live injection-point registry (resilience/faults.py is stdlib-only
# and import-safe); a frozen copy keeps the linter usable on a tree where
# faults.py itself is being refactored.
try:
    from ..resilience.faults import KNOWN_POINTS
except Exception:  # pragma: no cover - only on a broken tree
    KNOWN_POINTS = ("init_hang", "dispatch_fail", "build_fail", "lock_busy",
                    "dispatch_hang", "unit_crash", "serve_dispatch",
                    "lane_fail", "lane_hang", "dispatch_slow",
                    "backend_fail", "backend_hang", "tag_mismatch",
                    "pool_stale", "worker_slow_start", "scale_stall",
                    "chunk_lost", "reassembly_stall", "transfer_abort",
                    "session_stall", "keystream_miss", "session_evict")

# The live metrics label-key allowlist (obs/metrics.py, also stdlib-only),
# with the same frozen fallback.
try:
    from ..obs.metrics import ALLOWED_LABEL_KEYS
except Exception:  # pragma: no cover - only on a broken tree
    ALLOWED_LABEL_KEYS = ("lane", "rung", "engine", "outcome", "bucket",
                          "code", "state", "slots", "point", "kind", "mode",
                          "backend", "reason", "stage", "nr", "rule",
                          "severity")


@dataclass
class FileContext:
    relpath: str          #: repo-relative, forward slashes
    src: str
    tree: ast.Module
    lines: list[str]

    def line_text(self, node: ast.AST) -> str:
        ln = getattr(node, "lineno", 0)
        if 1 <= ln <= len(self.lines):
            return self.lines[ln - 1].strip()
        return ""

    def in_dir(self, *parts: str) -> bool:
        return self.relpath.startswith(tuple(
            p if p.endswith("/") else p + "/" for p in parts))

    def is_file(self, *names: str) -> bool:
        return any(self.relpath.endswith(n) for n in names)


@dataclass
class Rule:
    id: str
    severity: str
    doc: str
    check: Callable[[FileContext], Iterator[tuple[ast.AST, str]]]
    #: Optional MECHANICAL rewriter (the ``otlint --fix`` seam): yields
    #: (node, replacement source) pairs for violations whose fix is a
    #: pure text substitution — the node's exact source span is
    #: replaced and the fixed file must re-lint clean (the
    #: fixture-pair tests pin that). Rules whose fix needs judgment
    #: (which seam to route through, what deadline to pick) leave this
    #: None: --fix is for rewrites a code review would rubber-stamp.
    fixer: Callable[[FileContext],
                    Iterator[tuple[ast.AST, str]]] | None = None
    #: Semantic version, folded into every fingerprint this rule mints.
    #: Bump when a semantics change should invalidate old baseline
    #: entries (they surface as stale, not as silent suppressions).
    version: int = 1


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted-name string of an expression ("torch",
    "self.stream.synchronize", "_sibling('faults').fire", ...)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    if isinstance(node, ast.Call):
        base = _dotted(node.func)
        args = ",".join(
            repr(a.value) if isinstance(a, ast.Constant) else "?"
            for a in node.args)
        return f"{base}({args})"
    return ""


def _str_prefix(node: ast.AST) -> str:
    """The static string prefix of an expression, if any: a constant, the
    leading constant of an f-string, or of a +-concatenation."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values:
        return _str_prefix(node.values[0])
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _str_prefix(node.left)
    return ""


def _mentions(node: ast.AST, needle: str) -> bool:
    return any(needle in (getattr(n, "id", "") + getattr(n, "attr", ""))
               for n in ast.walk(node))


# ---------------------------------------------------------------------------
# subprocess-isolate: child processes only via resilience.isolate
# ---------------------------------------------------------------------------

_SPAWN_CALLS = {"os.fork", "os.forkpty", "os.system", "os.popen",
                "pty.fork", "os.spawnv", "os.spawnvp", "os.spawnl",
                "os.spawnlp", "os.posix_spawn"}


def _check_subprocess(ctx: FileContext):
    if ctx.is_file("resilience/isolate.py"):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] in ("subprocess",
                                                "multiprocessing"):
                    yield node, (
                        f"bare `import {alias.name}`: child processes go "
                        "through resilience.isolate.run_child (deadline, "
                        "process-group SIGKILL, retry policy, trace "
                        "nesting) — not hand-rolled spawns")
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] in ("subprocess",
                                                     "multiprocessing"):
                yield node, (
                    f"bare `from {node.module} import ...`: route child "
                    "processes through resilience.isolate.run_child")
        elif isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name in _SPAWN_CALLS:
                yield node, (
                    f"`{name}()` spawns outside the isolate chokepoint; "
                    "use resilience.isolate.run_child")


# ---------------------------------------------------------------------------
# dispatch-watchdog: raw device dispatch only under a watchdog guard
# ---------------------------------------------------------------------------

#: The kernel wrappers (``ops/cuda_*.py``, and the ceiling probe's
#: ``chain``), by module: a call of one launches a kernel on the card. Their
#: ``*_plain`` twins and helpers run no kernel.
_KERNEL_WRAPPERS = {
    "cuda_aes": ("ctr_crypt_words_fused", "encrypt_words", "decrypt_words",
                 "ctr_scattered_multikey", "ctr_crypt_words_explicit",
                 "cbc_scattered_multikey", "seq_encrypt", "cbc_encrypt_words_seq",
                 "cfb128_encrypt_words_seq", "cbc_encrypt_words_seq_batch"),
    "cuda_ghash": ("ghash_scan", "ghash_at"),
    "cuda_arc4": ("prga",),
    "ceiling": ("chain",),
}
#: Seam files where the raw call IS the guarded chokepoint: the harness
#: backends' barrier (it carries the fault and injected-hang seams itself),
#: and the lane's card call, which ``Lane.engine_call`` enters only inside
#: its ``watchdog.deadline`` (the staging, launch and stream fence sit in
#: ``Lane._call_cuda``, one call down).
_DISPATCH_SEAM_FILES = ("harness/backends.py", "serve/lanes.py")
#: The engine layer: the modules whose reference counterparts are traced
#: programs (``jit``, ``shard_map``, Pallas), inside which the reference's
#: staging is implicit and its kernels are launched, not awaited. The
#: dispatch is governed where the engine is called (the harness barrier,
#: the lane), so the rule does not look inside.
_ENGINE_DIRS = ("ops", "models", "aead", "parallel", "utils")
#: The lane-executor module: the one place serve/ may run device work
#: off the main thread. Its worker invokes the submitted unit, and the
#: main-thread SIGALRM delivery cannot reach a worker thread, so the
#: invocation is legal ONLY inside the thread-kill-hook guard that gives
#: the watchdog its off-main kill path (fail the future, abandon the
#: worker).
_EXECUTOR_FILES = ("serve/dispatch.py",)


def _card_call(node: ast.Call) -> str | None:
    """What kind of card contact a call is, or None: ``"barrier"``
    (``torch.cuda.synchronize()``, an event's or stream's
    ``.synchronize()``), ``"staging"`` (``.cuda()``, ``.to(<device>)``: a
    keyword ``device=``, a ``"cuda..."`` literal, or a name that says
    ``dev``) or ``"kernel"`` (a kernel wrapper of ``_KERNEL_WRAPPERS``)."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    recv = _dotted(func.value)
    if func.attr == "synchronize":
        return "barrier"
    if func.attr == "cuda" and not node.args:
        return "staging"
    if func.attr == "to":
        if any(kw.arg == "device" for kw in node.keywords):
            return "staging"
        if node.args:
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return "staging" if a.value.startswith("cuda") else None
            name = _dotted(a).rsplit(".", 1)[-1].lower()
            if "dev" in name:
                return "staging"
        return None
    if func.attr in _KERNEL_WRAPPERS.get(recv.rsplit(".", 1)[-1], ()):
        return "kernel"
    return None


def _is_guard_cm(expr: ast.AST) -> bool:
    """A `with` context expression that arms a watchdog deadline: a call
    whose dotted name ends in `.deadline`/`deadline`, or a wrapper whose
    name says alarm/deadline (root bench's `_stage_alarm`)."""
    if not isinstance(expr, ast.Call):
        return False
    name = _dotted(expr.func)
    tail = name.rsplit(".", 1)[-1]
    return (tail == "deadline" or "alarm" in tail or "deadline" in tail)


def _is_kill_hook_cm(expr: ast.AST) -> bool:
    """A `with` context expression registering the worker thread's
    watchdog kill path (``watchdog.thread_kill_hook(...)``)."""
    if not isinstance(expr, ast.Call):
        return False
    tail = _dotted(expr.func).rsplit(".", 1)[-1]
    return "kill_hook" in tail


def _check_dispatch(ctx: FileContext):
    if ctx.is_file(*_DISPATCH_SEAM_FILES):
        return
    if ctx.is_file(*_EXECUTOR_FILES):
        # The worker seam: a device call runs off the main thread here,
        # where SIGALRM delivery cannot interrupt it — the submitted
        # unit may only be invoked under the thread-kill-hook guard
        # (the expiry path that fails the dispatch future and abandons
        # the wedged worker). An unguarded unit() is a hang with no
        # kill path and no evidence.
        def visit_exec(node, hooked):
            if isinstance(node, ast.With):
                if any(_is_kill_hook_cm(item.context_expr)
                       for item in node.items):
                    hooked = True
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "unit" and not hooked):
                yield node, (
                    "worker-thread `unit()` invocation outside the "
                    "`watchdog.thread_kill_hook` guard: a deadline armed "
                    "inside the unit would expire with no delivery path "
                    "— the waiter blocks forever and the hang leaves no "
                    "kill evidence")
            for child in ast.iter_child_nodes(node):
                yield from visit_exec(child, hooked)

        yield from visit_exec(ctx.tree, False)
    if ctx.in_dir(*_ENGINE_DIRS, *(f"our_tree_tpu_torch/{d}" for d in _ENGINE_DIRS)):
        return

    def visit(node, guarded):
        if isinstance(node, ast.With):
            if any(_is_guard_cm(item.context_expr) for item in node.items):
                guarded = True
        if isinstance(node, ast.Call) and not guarded and _card_call(node):
            name = _dotted(node.func)
            yield node, (
                f"raw `{name}()` outside a watchdog guard: wrap the "
                "region in `watchdog.deadline(...)` (or route through "
                "the harness backend barrier seam) so a wedged "
                "transport becomes a DispatchTimeout, not a hang")
        for child in ast.iter_child_nodes(node):
            yield from visit(child, guarded)

    yield from visit(ctx.tree, False)


# ---------------------------------------------------------------------------
# degrade-chokepoint: demotions only through degrade()
# ---------------------------------------------------------------------------

#: Literal degrade kinds that are not "x->y" arrows.
_DEGRADE_KINDS_EXTRA = ("dispatch-timeout",)
_DEGRADE_PREFIXES = ("quarantined:",)

#: Call names that emit text (the `# degraded` format check only looks at
#: these — a string-method call like startswith("# degraded") is not an
#: emission).
_EMITTER_TAILS = ("print", "line", "write", "emit", "note", "log",
                  "info", "warning", "error")


def _kind_ok(kind: str) -> bool:
    if kind in _DEGRADE_KINDS_EXTRA or kind.startswith(_DEGRADE_PREFIXES):
        return True
    left, arrow, right = kind.partition("->")
    return bool(arrow and left and right and " " not in kind)


def _check_degrade(ctx: FileContext):
    in_degrade_mod = ctx.is_file("resilience/degrade.py")
    for node in ast.walk(ctx.tree):
        # (a) nobody reaches into the ledger's private state
        if (not in_degrade_mod and isinstance(node, ast.Attribute)
                and node.attr == "_EVENTS"):
            yield node, ("direct access to the degrade ledger's private "
                         "state; use degrade()/events()/detail()")
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        # (b) a "# degraded" line not fed by the ledger masquerades as it
        if (not in_degrade_mod
                and name.rsplit(".", 1)[-1] in _EMITTER_TAILS):
            for arg in node.args:
                if (_str_prefix(arg).startswith("# degraded")
                        and not _mentions(arg, "degrade")):
                    yield node, (
                        "emits a `# degraded` line not derived from the "
                        "resilience.degrade ledger — record the demotion "
                        "with degrade() and report events()")
        # (c) degrade() called with a malformed kind literal
        if name.rsplit(".", 1)[-1] == "degrade" and node.args:
            first = node.args[0]
            if (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                    and not _kind_ok(first.value)):
                yield node, (
                    f"degrade kind {first.value!r} is not a known form "
                    "(an `from->to` arrow, `dispatch-timeout`, or "
                    "`quarantined:<unit>`) — the ledger's consumers "
                    "parse these")


# ---------------------------------------------------------------------------
# wallclock: no time.time() outside obs/ (timed regions use monotonic
# clocks; epoch time belongs to the tracer and to mtime comparisons)
# ---------------------------------------------------------------------------


def _check_wallclock(ctx: FileContext):
    if ctx.in_dir("obs", "our_tree_tpu_torch/obs"):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name in ("time.time", "time.time_ns"):
                yield node, (
                    f"`{name}()` reads the wall clock: timed regions and "
                    "budgets use time.monotonic()/perf_counter() (NTP "
                    "steps corrupt durations); epoch time belongs to "
                    "obs.trace (trace.now_us) and to file-mtime "
                    "comparisons")


#: The wallclock rule's mechanical rewrite (`--fix`): the monotonic
#: twin of each wall-clock read. Call sites that genuinely need EPOCH
#: time (event timestamps) belong on ``trace.now_us()`` instead —
#: that is a judgment rewrite, left to whoever reads the finding.
_WALLCLOCK_FIX = {"time.time": "time.monotonic()",
                  "time.time_ns": "time.monotonic_ns()"}


def _fix_wallclock(ctx: FileContext):
    if ctx.in_dir("obs", "our_tree_tpu_torch/obs"):
        return
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call) and not node.args
                and not node.keywords):
            new = _WALLCLOCK_FIX.get(_dotted(node.func))
            if new:
                yield node, new


# ---------------------------------------------------------------------------
# trace-attrs: span/detached_span/point/counter/gauge attrs statically
# JSON-serializable
# ---------------------------------------------------------------------------

_TRACE_METHODS = ("span", "detached_span", "point", "counter", "gauge")
_TRACE_RECEIVERS = ("trace", "_trace", "trace_mod", "obstrace",
                    "tr", "t", "tt", "m")


def _json_unsafe(node: ast.AST) -> str | None:
    """The reason an attr value is provably not JSON-clean, or None.
    Names/calls/arithmetic pass (runtime values are the tracer's
    default=repr problem); only structurally-wrong literals flag."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bytes):
            return "bytes literal"
        if isinstance(node.value, complex):
            return "complex literal"
        if node.value is Ellipsis:
            return "Ellipsis"
    if isinstance(node, (ast.Set, ast.SetComp)):
        return "set (JSON has no set type)"
    if isinstance(node, ast.Lambda):
        return "lambda"
    for child in ast.iter_child_nodes(node):
        why = _json_unsafe(child)
        if why:
            return why
    return None


def _check_trace_attrs(ctx: FileContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _TRACE_METHODS):
            continue
        recv = _dotted(func.value)
        if not (recv in _TRACE_RECEIVERS or "trace" in recv):
            continue
        for kw in node.keywords:
            if kw.arg is None or kw.value is None:
                continue
            why = _json_unsafe(kw.value)
            if why:
                yield node, (
                    f"trace attr `{kw.arg}` is not statically "
                    f"JSON-serializable ({why}); the tracer would stringify "
                    "it with repr(), making the event unreadable to "
                    "obs.report")


# ---------------------------------------------------------------------------
# fault-points: OT_FAULTS seam names drawn from faults.KNOWN_POINTS
# ---------------------------------------------------------------------------

_FAULT_METHODS = ("fire", "check", "check_lane", "check_backend",
                  "fire_backend", "scoped", "scoped_backend",
                  "scoped_chunk", "fire_chunk", "consume",
                  "remaining", "injected_hang", "injected_slow")


def _check_fault_points(ctx: FileContext):
    if ctx.is_file("resilience/faults.py"):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _FAULT_METHODS):
            continue
        recv = _dotted(func.value)
        if not ("fault" in recv or "watchdog" in recv):
            continue
        first = node.args[0]
        if (isinstance(first, ast.Constant)
                and isinstance(first.value, str)
                and first.value not in KNOWN_POINTS):
            yield node, (
                f"injection point {first.value!r} is not in "
                f"faults.KNOWN_POINTS {tuple(KNOWN_POINTS)}: an "
                "unregistered seam silently never fires, making fault "
                "CI vacuously green — register it in faults.py first")


# ---------------------------------------------------------------------------
# metrics-labels: registry labels from the fixed allowlist, values
# statically low-cardinality
# ---------------------------------------------------------------------------

_METRIC_METHODS = ("counter", "gauge", "gauge_max", "observe")
#: Keyword args that are the metric's VALUE, not labels ("exemplar" is
#: the bounded tail-exemplar payload, obs/metrics.py — identity-shaped
#: by design, bounded by the per-series exemplar cap, never a series
#: key).
_METRIC_VALUE_KWARGS = ("n", "value", "exemplar")
#: Identifier fragments that statically smell like unbounded
#: cardinality: a label value built from any of these turns the
#: process-global registry into a per-request/per-tenant memory leak
#: (and, for tenant/digest, leaks tenant identity into the /metrics
#: surface). Matched against "_"-split identifier parts, so `lane.idx`
#: passes while `req.id` and `tenant_digest` flag.
_HIGH_CARDINALITY_PARTS = frozenset(
    ("tenant", "digest", "nonce", "uuid", "id", "ids", "req", "request",
     "label", "token", "payload"))


def _high_cardinality_reason(node: ast.AST) -> str | None:
    """Why a label-value expression is provably high-cardinality, or
    None. Constants always pass (a literal is one value); f-strings
    always flag (string-assembly is the request-id idiom); otherwise
    every identifier mentioned is screened against the deny fragments."""
    if isinstance(node, ast.Constant):
        return None
    if isinstance(node, ast.JoinedStr):
        return "f-string label value (per-call string assembly)"
    for n in ast.walk(node):
        for name in (getattr(n, "id", ""), getattr(n, "attr", "")):
            if not name:
                continue
            parts = name.lower().split("_")
            hit = _HIGH_CARDINALITY_PARTS.intersection(parts)
            if hit:
                return f"derived from `{name}` ({sorted(hit)[0]})"
    return None


def _check_metrics_labels(ctx: FileContext):
    if ctx.is_file("obs/metrics.py"):
        return  # the registry's own internals
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _METRIC_METHODS):
            continue
        recv = _dotted(func.value)
        if "metrics" not in recv:
            continue
        for kw in node.keywords:
            if kw.arg is None:
                yield node, (
                    "metrics call with a **splat: label keys must be "
                    "statically visible so the allowlist check means "
                    "something — spell the labels out")
                continue
            if kw.arg in _METRIC_VALUE_KWARGS:
                continue
            if kw.arg not in ALLOWED_LABEL_KEYS:
                yield node, (
                    f"metrics label key `{kw.arg}` is not in "
                    f"obs.metrics.ALLOWED_LABEL_KEYS "
                    f"{tuple(ALLOWED_LABEL_KEYS)}: labels multiply "
                    "series in a process-global registry — extend the "
                    "allowlist deliberately or drop the label")
                continue
            why = _high_cardinality_reason(kw.value)
            if why:
                yield node, (
                    f"metrics label `{kw.arg}` value looks "
                    f"high-cardinality: {why}. Request ids and tenant "
                    "digests as label values grow the registry without "
                    "bound (and leak identity onto /metrics) — label "
                    "with closed enums, count identity-free")


# ---------------------------------------------------------------------------
# serve-lane-seam: device dispatch in serve/ only through serve/lanes.py
# ---------------------------------------------------------------------------

#: Call-name tails that put work on the card (or read it back) through
#: the models-level seams. In serve/, every one of them belongs to the lane
#: seam: a dispatch outside it has no watchdog deadline of its own lane,
#: no health accounting, no failover. The native host tier's ``ctr`` runs
#: through ``ctr_crypt_words_scattered_multikey`` too; it has no card but
#: it IS a dispatch, so it may not bypass the seam either. The card's
#: barriers, its staging and the kernel wrappers (``_card_call``) are lane
#: seam calls as well.
_SERVE_DISPATCH_TAILS = ("ctr_crypt_words_scattered",
                         "ctr_crypt_words_scattered_multikey",
                         "cbc_decrypt_words_scattered_multikey",
                         "gcm_crypt_ghash_words", "xor_words",
                         "prep_batch_words", "ctr_scattered_words",
                         "ctr_requests_words")


def _check_serve_lane(ctx: FileContext):
    if not ctx.in_dir("serve", "our_tree_tpu_torch/serve"):
        return
    in_seam = ctx.is_file("serve/lanes.py")
    in_executor = ctx.is_file(*_EXECUTOR_FILES)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        tail = name.rsplit(".", 1)[-1]
        # Worker threads in serve/ exist ONLY inside the lane executor:
        # a thread spawned anywhere else carries device work (or work
        # that fans into it) outside the guarded entry point — no
        # thread-kill hook, no abandoned-worker accounting, no deadline
        # delivery. This applies to lanes.py too: the seam file owns
        # the DEVICE contact, the executor owns the THREADS.
        if tail == "Thread" and not in_executor:
            yield node, (
                f"`{name}()` spawns a worker thread in serve/ outside "
                "the lane executor (serve/dispatch.py): off-main device "
                "work is legal only on an executor worker, whose "
                "thread-kill hook gives the watchdog a delivery path "
                "(fail the future, abandon the worker)")
            continue
        if in_seam:
            continue
        if tail in _SERVE_DISPATCH_TAILS or _card_call(node):
            yield node, (
                f"`{name}()` dispatches to a device from serve/ outside "
                "the lane seam: route the call through serve/lanes.py "
                "(Lane.engine_call) so it gets the lane's watchdog "
                "deadline, health accounting, and bit-exact failover")


# ---------------------------------------------------------------------------
# route-backend-seam: backend contact in route/ only through route/proxy.py;
# the whole routing tier stays device-free
# ---------------------------------------------------------------------------

#: Call tails that open a socket to (or exchange frames with) a backend.
#: In route/, every one of them belongs to the proxy seam: a backend
#: contact outside it has no attempt deadline, no health accounting, no
#: failover — a fault there degrades the ROUTER, not a backend, which
#: is exactly the failure mode the seam exists to contain.
_ROUTE_CONTACT_TAILS = ("open_connection", "create_connection",
                        "read_frame", "encode_frame")
#: The seam files plus the harness entry (route/bench.py drives workers
#: and references engines the way serve/bench.py does — it is the
#: operator tool, not the routing tier). route/fleet.py is seam tier:
#: the replica server + gossip exchange speak the framed wire directly
#: (they ARE transport endpoints), and all per-request backend contact
#: still flows through the proxy it wraps.
_ROUTE_SEAM_FILES = ("route/proxy.py", "route/fleet.py")
_ROUTE_HARNESS_FILES = ("route/bench.py",)


def _check_route_seam(ctx: FileContext):
    if not ctx.in_dir("route", "our_tree_tpu_torch/route"):
        return
    harness = ctx.is_file(*_ROUTE_HARNESS_FILES)
    in_seam = ctx.is_file(*_ROUTE_SEAM_FILES)
    for node in ast.walk(ctx.tree):
        # The routing tier is DEVICE-FREE by construction: a torch import
        # anywhere in route/ (bench included) couples the front end's
        # availability to the card's toolchain it exists to abstract over
        # (and may make a CUDA context in the router) — the router must
        # start on any box.
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "torch":
                    yield node, (
                        "`import torch` in route/: the routing tier is "
                        "device-free — engines live behind the backends; "
                        "a router that needs torch cannot front a mixed or "
                        "torch-less fleet")
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "torch":
                yield node, (
                    "`from torch import ...` in route/: the routing tier "
                    "is device-free (see route-backend-seam)")
        if harness or in_seam or not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        tail = name.rsplit(".", 1)[-1]
        if tail in _ROUTE_CONTACT_TAILS:
            yield node, (
                f"`{name}()` contacts a backend from route/ outside "
                "the proxy seam: route the exchange through "
                "route/proxy.py (Backend.exchange / poll_healthz) so "
                "it gets the attempt deadline, health accounting, and "
                "bit-exact failover")
        elif tail in _SERVE_DISPATCH_TAILS or _card_call(node):
            yield node, (
                f"`{name}()` dispatches engine work from route/: the "
                "router never touches engines — backends do; submit "
                "through the proxy instead")


RULES: tuple[Rule, ...] = (
    Rule("subprocess-isolate", "error",
         "Child processes only via resilience.isolate.run_child — no bare "
         "subprocess/multiprocessing/os.fork outside resilience/isolate.py.",
         _check_subprocess),
    Rule("dispatch-watchdog", "error",
         "Raw card contact (torch.cuda.synchronize, an event's or stream's "
         ".synchronize(), .cuda()/.to(<device>) staging, the kernel "
         "wrappers of ops/cuda_*.py) only inside a watchdog.deadline guard "
         "or a barrier seam (harness/backends.py, the lane's card call), "
         "outside the engine layer (ops/, models/, aead/, parallel/, "
         "utils/); "
         "the lane executor's worker may invoke its unit only under the "
         "watchdog.thread_kill_hook guard (the off-main delivery path).",
         _check_dispatch),
    Rule("degrade-chokepoint", "error",
         "Demotions only through resilience.degrade(): no private-ledger "
         "access, no hand-rolled `# degraded` lines, kinds well-formed.",
         _check_degrade),
    Rule("wallclock", "warning",
         "No time.time()/time_ns() outside obs/ — durations use monotonic "
         "clocks; epoch time is the tracer's and mtime comparisons'. "
         "--fix rewrites to the monotonic twin.",
         _check_wallclock, fixer=_fix_wallclock),
    Rule("trace-attrs", "error",
         "span/detached_span/point/counter/gauge attrs must be statically "
         "JSON-serializable (no bytes/set/lambda/complex literals).",
         _check_trace_attrs),
    Rule("fault-points", "error",
         "String literals passed to faults.fire/check/check_lane/scoped/"
         "consume/remaining and watchdog.injected_hang must be registered "
         "KNOWN_POINTS.",
         _check_fault_points),
    Rule("metrics-labels", "error",
         "obs.metrics label keys must come from ALLOWED_LABEL_KEYS and "
         "label values must be statically low-cardinality (no request "
         "ids, tenant digests, or f-strings) — the registry must never "
         "become an unbounded-cardinality memory leak.",
         _check_metrics_labels),
    Rule("serve-lane-seam", "error",
         "Dispatch in serve/ (the models-level seams incl. the native host "
         "tier, the card's barriers and staging, the kernel wrappers) "
         "only inside serve/lanes.py — the lane seam owns deadlines, "
         "health, and failover; worker threads in serve/ exist only "
         "inside the lane executor (serve/dispatch.py).",
         _check_serve_lane),
    Rule("route-backend-seam", "error",
         "Backend contact in route/ (socket opens, wire frames) only "
         "inside route/proxy.py — the proxy seam owns attempt "
         "deadlines, health, and failover — and the routing tier is "
         "device-free: no torch import anywhere in route/.",
         _check_route_seam),
)


def lint_file(path: str, relpath: str) -> list[Finding]:
    """Run every rule over one file; unparseable files yield one
    finding (a syntax error in the package is itself a violation)."""
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    try:
        tree = ast.parse(src, filename=relpath)
    except SyntaxError as e:
        return [Finding("parse", "error", f"does not parse: {e.msg}",
                        relpath, e.lineno or 0, anchor="syntax-error")]
    ctx = FileContext(relpath, src, tree, src.splitlines())
    out: list[Finding] = []
    for rule in RULES:
        for node, message in rule.check(ctx):
            out.append(Finding(
                rule.id, rule.severity, message, relpath,
                getattr(node, "lineno", 0), anchor=ctx.line_text(node),
                version=rule.version))
    return out


def _walk_py(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__" and not d.startswith(".")]
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames) if f.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    return sorted(set(files))


def lint_paths(paths: list[str], repo_root: str) -> list[Finding]:
    """Lint every .py under ``paths`` (files or directories), findings
    keyed by repo-root-relative path."""
    out: list[Finding] = []
    for f in _walk_py(paths):
        rel = os.path.relpath(os.path.abspath(f),
                              os.path.abspath(repo_root)).replace(os.sep, "/")
        out.extend(lint_file(f, rel))
    return anchored(out)


# ---------------------------------------------------------------------------
# --fix: apply the rules' mechanical rewrites in place.
# ---------------------------------------------------------------------------


def fix_file(path: str, relpath: str,
             baseline: dict | None = None) -> int:
    """Apply every rule's fixer to one file IN PLACE; returns the
    rewrite count. Replacements splice the flagged node's exact source
    span (``end_lineno``/``end_col_offset``), applied bottom-up so
    earlier edits never shift later spans. Unparseable files are left
    alone (the parse finding stands).

    ``baseline`` (fingerprint -> entry, analysis/baseline.json's
    loaded form) EXEMPTS baselined violations from fixing: a reasoned
    baseline entry is a site where the "violation" is deliberate —
    devlock's epoch-vs-mtime staleness compare, the watchdog report's
    epoch filename — and a mechanical monotonic rewrite there would be
    semantically wrong, not clean. Exemption is per (rule, line): any
    baselined finding of the fixing rule on a line protects that
    line's candidates."""
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    try:
        tree = ast.parse(src, filename=relpath)
    except SyntaxError:
        return 0
    ctx = FileContext(relpath, src, tree, src.splitlines())
    protected: set[tuple[str, int]] = set()
    if baseline:
        for f in anchored(lint_file(path, relpath)):
            if f.fingerprint in baseline:
                protected.add((f.rule, f.line))
    edits: list[tuple] = []
    for rule in RULES:
        if rule.fixer is None:
            continue
        for node, replacement in rule.fixer(ctx):
            if getattr(node, "end_lineno", None) is None:
                continue
            if (rule.id, getattr(node, "lineno", 0)) in protected:
                continue
            edits.append((node.lineno, node.col_offset,
                          node.end_lineno, node.end_col_offset,
                          replacement))
    if not edits:
        return 0
    lines = src.splitlines(keepends=True)
    for l0, c0, l1, c1, new in sorted(edits, reverse=True):
        if l0 == l1:
            line = lines[l0 - 1]
            lines[l0 - 1] = line[:c0] + new + line[c1:]
        else:
            lines[l0 - 1:l1] = [lines[l0 - 1][:c0] + new
                                + lines[l1 - 1][c1:]]
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("".join(lines))
    return len(edits)


def fix_paths(paths: list[str], repo_root: str,
              baseline: dict | None = None) -> dict[str, int]:
    """``otlint --fix`` over files/dirs: {repo-relative path: rewrites}
    for every file actually changed, baselined violations exempted
    (``fix_file``). The contract the fixture-pair tests pin: a fixed
    file re-lints CLEAN for the fixing rule."""
    out: dict[str, int] = {}
    for f in _walk_py(paths):
        rel = os.path.relpath(os.path.abspath(f),
                              os.path.abspath(repo_root)).replace(os.sep, "/")
        n = fix_file(f, rel, baseline=baseline)
        if n:
            out[rel] = n
    return out
