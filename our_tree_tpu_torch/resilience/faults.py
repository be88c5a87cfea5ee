"""Deterministic fault injection (``OT_FAULTS``).

Copy of ``our_tree_tpu.resilience.faults``, whole: the same spec strings
give the same schedules. Named injection points wired into the real
failure sites consult a registry parsed once from ``OT_FAULTS``, so a test
can script exact failure sequences on the CPU while production pays one
dict lookup when the variable is unset.

Grammar::

    OT_FAULTS=init_hang:2,dispatch_fail:1,build_fail,dispatch_hang:1@2,
              lane_hang:1@lane=3

Comma-separated tokens, each ``<point>[:<count>[@<qualifier>]]``. A counted
token arms the point for exactly ``count`` firings (the first ``count``
calls to ``fire(point)`` return True, every later call False); a bare token
arms it forever. Repeated tokens accumulate (``x:2,x:1`` is ``x:3``) and a
bare one absorbs them. The ``@`` qualifier is one of:

* ``@<skip>``: defer a counted point past its first ``skip`` calls
  (``dispatch_hang:1@2`` skips two dispatches, then hangs the third);
* ``@<scope>=<i>`` with a scope of ``SCOPES``: the point is scoped to one
  fault domain (``lane_hang:1@lane=3``); the registry key becomes
  ``<point>@<scope>=<i>`` and only a seam asking for that exact key can
  consume the shot.

Whitespace around tokens is tolerated; unknown point names are armed but
warned about on stderr (a typo that never fires would make a fault test
vacuously green).

The port wires these points: ``dispatch_fail`` and ``dispatch_hang`` at the
sweep backend's completion barrier and chained dispatch
(``harness.backends.GpuBackend``), the serve lanes' dispatch
(``serve.lanes``) and, for ``dispatch_hang``, the sweep's timed region
(``harness.bench._time_us``), the hex CLI's dispatch (``harness.decrypt``)
and each case of the parity fuzzer (``scripts.fuzz_parity``), where a firing
debits the hang from the ``--deadline`` budget without sleeping
(``watchdog.injected_hang(..., budget=)``); ``unit_crash`` at sweep-unit
execution (``harness.bench``); ``build_fail`` at the native C builds
(``runtime.native``); ``lock_busy`` at the card's lock (``utils.devlock``);
``serve_dispatch``, ``lane_fail``, ``lane_hang`` and ``dispatch_slow`` at
the serve lanes; ``tag_mismatch`` at the serve path's GCM finisher
(``serve.server.Server._gcm_finish``: a firing fails one ``gcm-open``
request's tag check, so it answers ``auth-failed``); ``chunk_lost``,
``reassembly_stall`` and ``transfer_abort`` at chunked transfers
(``serve.transfer``); ``session_stall``, ``keystream_miss`` and
``session_evict`` at the rc4 sessions (``serve.session``);
``backend_fail``, ``backend_hang`` and ``pool_stale`` at the router
(``route.proxy``), ``worker_slow_start`` and ``scale_stall`` at the fleet
(``route.fleet``). ``init_hang`` belongs to the root ``bench.py``'s PJRT
probe, which the port does not have; it parses the same.

Determinism: firings consume counts in call order within one process
(subprocesses re-parse the inherited environment and count on their own;
``isolate`` meters shots into its children). ``fire`` never sleeps and never
raises: what a failure looks like is each seam's decision. Stdlib only
apart from the port's tracer.
"""

from __future__ import annotations

import os
import sys
import time

from ..obs import trace

#: The names the reference wires into real seams. Parsing accepts others
#: (forward compatibility, tests), but warns.
KNOWN_POINTS = ("init_hang", "dispatch_fail", "build_fail", "lock_busy",
                "dispatch_hang", "unit_crash", "serve_dispatch",
                "lane_fail", "lane_hang", "dispatch_slow",
                "backend_fail", "backend_hang", "tag_mismatch",
                "pool_stale", "worker_slow_start", "scale_stall",
                "chunk_lost", "reassembly_stall", "transfer_abort",
                "session_stall", "keystream_miss", "session_evict")

#: Scope names the ``@<scope>=<i>`` qualifier accepts.
SCOPES = ("lane", "backend", "chunk", "session")

#: Sentinel count for a bare (uncounted) token: armed forever.
ALWAYS = -1

#: point -> remaining firings (ALWAYS = unbounded); None until the first
#: fire()/reset() parses OT_FAULTS, {} thereafter when unset.
_REGISTRY: dict[str, int] | None = None

#: point -> calls still to skip before the counted shots start firing.
_SKIPS: dict[str, int] = {}


class InjectedFault(RuntimeError):
    """Raised by injection points when their fault fires; a RuntimeError,
    so seams whose real failures are runtime errors retry through the same
    handlers."""


def scoped(point: str, lane) -> str:
    """The registry key of a lane-scoped point."""
    return f"{point}@lane={int(lane)}"


def scoped_backend(point: str, backend) -> str:
    """The registry key of a backend-scoped point."""
    return f"{point}@backend={int(backend)}"


def scoped_chunk(point: str, chunk) -> str:
    """The registry key of a chunk-scoped point."""
    return f"{point}@chunk={int(chunk)}"


def scoped_session(point: str, sid) -> str:
    """The registry key of a session-scoped point."""
    return f"{point}@session={int(sid)}"


def _scope_key(base: str, qual: str) -> str | None:
    """Canonical registry key for a ``<scope>=<i>`` qualifier, or None when
    the scope or index is malformed."""
    scope, sep, idx = qual.partition("=")
    if not sep or scope.strip() not in SCOPES:
        return None
    try:
        return f"{base.strip()}@{scope.strip()}={int(idx.strip())}"
    except ValueError:
        return None


def _parse(spec: str) -> tuple[dict[str, int], dict[str, int]]:
    reg: dict[str, int] = {}
    skips: dict[str, int] = {}
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, sep, count = tok.partition(":")
        name = name.strip()
        if sep:
            count, at, qual = count.partition("@")
            qual = qual.strip()
            try:
                n = int(count.strip())
                if at and "=" in qual:
                    key = _scope_key(name, qual)
                    if key is None:
                        raise ValueError(qual)
                    name = key
                elif at:  # the last token's skip wins (skips do not add up)
                    skips[name] = max(int(qual), 0)
            except ValueError:
                print(f"# OT_FAULTS: malformed token {tok!r} ignored", file=sys.stderr)
                continue
            if n <= 0:
                continue  # a zero count is disarmed
        else:
            n = ALWAYS
            if "@" in name:
                base, _, qual = name.partition("@")
                canon = _scope_key(base, qual)
                if canon is None:
                    print(f"# OT_FAULTS: malformed token {tok!r} ignored", file=sys.stderr)
                    continue
                name = canon
        if name.split("@", 1)[0] not in KNOWN_POINTS:
            print(f"# OT_FAULTS: unknown injection point {name!r} "
                  f"(known: {', '.join(KNOWN_POINTS)}) — armed anyway", file=sys.stderr)
        prev = reg.get(name, 0)
        reg[name] = ALWAYS if ALWAYS in (prev, n) else prev + n
    return reg, {k: v for k, v in skips.items() if k in reg and v > 0}


def reset() -> None:
    """Re-parse OT_FAULTS (tests that set the environment after import)."""
    global _REGISTRY
    _REGISTRY, skips = _parse(os.environ.get("OT_FAULTS", ""))
    _SKIPS.clear()
    _SKIPS.update(skips)


def _registry() -> dict[str, int]:
    if _REGISTRY is None:
        reset()
    return _REGISTRY


def active() -> bool:
    """True when any point is still armed."""
    return bool(_registry())


def _take_shot(reg: dict, point: str, n: int) -> None:
    """The one counted-shot decrement, shared by fire and consume."""
    if n != ALWAYS:
        if n == 1:
            del reg[point]
        else:
            reg[point] = n - 1


def fire(point: str) -> bool:
    """Consume one shot at ``point``; True iff the fault fires now."""
    reg = _registry()
    if not reg:
        return False
    n = reg.get(point, 0)
    if n == 0:
        return False
    skip = _SKIPS.get(point, 0)
    if skip:  # a deferred shot (the @<skip> grammar): not yet
        _SKIPS[point] = skip - 1
        return False
    _take_shot(reg, point, n)
    trace.point("fault-injected", point=point, left=("unbounded" if n == ALWAYS else n - 1))
    print(f"# OT_FAULTS: injecting {point} ({'unbounded' if n == ALWAYS else f'{n - 1} left'})",
          file=sys.stderr)
    return True


def check(point: str, detail: str = "") -> None:
    """Raise InjectedFault iff ``point`` fires: the common seam shape."""
    if fire(point):
        raise InjectedFault(f"injected fault: {point}" + (f" ({detail})" if detail else ""))


def check_lane(point: str, lane, detail: str = "") -> None:
    """Raise InjectedFault iff the lane-scoped or the plain form of
    ``point`` fires; one call consumes at most one shot."""
    if fire(scoped(point, lane)) or fire(point):
        raise InjectedFault(f"injected fault: {scoped(point, lane)}"
                            + (f" ({detail})" if detail else ""))


def check_backend(point: str, backend, detail: str = "") -> None:
    """``check_lane`` for a backend-scoped seam."""
    if fire(scoped_backend(point, backend)) or fire(point):
        raise InjectedFault(f"injected fault: {scoped_backend(point, backend)}"
                            + (f" ({detail})" if detail else ""))


def fire_backend(point: str, backend) -> bool:
    """Consume the backend-scoped or plain shot of ``point`` without
    raising."""
    return fire(scoped_backend(point, backend)) or fire(point)


def fire_chunk(point: str, chunk) -> bool:
    """Consume the chunk-scoped or plain shot of ``point`` without raising."""
    return fire(scoped_chunk(point, chunk)) or fire(point)


def fire_session(point: str, sid) -> bool:
    """Consume the session-scoped or plain shot of ``point`` without
    raising."""
    return fire(scoped_session(point, sid)) or fire(point)


def injected_slow(point: str, detail: str = "") -> bool:
    """When ``point`` fires, sleep ``OT_SLOW_S`` seconds (default 0.05) and
    return True: the call still succeeds, late."""
    if not fire(point):
        return False
    try:
        slow_s = max(float(os.environ.get("OT_SLOW_S", 0.05)), 0.0)
    except ValueError:
        slow_s = 0.05
    time.sleep(slow_s)
    return True


def consume(point: str) -> bool:
    """Take one shot at ``point`` without it counting as an injection (no
    stderr note, no trace event): a supervisor metering shots into its
    children (``isolate._meter_faults``). Skips are not consumed."""
    reg = _registry()
    n = reg.get(point, 0) if reg else 0
    if n == 0:
        return False
    _take_shot(reg, point, n)
    return True


def remaining(point: str) -> int:
    """Shots left at ``point`` (ALWAYS for unbounded, 0 when disarmed)."""
    return _registry().get(point, 0)


def armed() -> tuple[str, ...]:
    """The armed point names, a snapshot."""
    return tuple(_registry())
