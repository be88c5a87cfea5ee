"""Process isolation: the shared child runner and the isolated-sweep
supervisor (``harness.bench --isolate``).

Copy of ``our_tree_tpu.resilience.isolate``, trimmed to what the port
calls. The watchdog can interrupt a hang only while the blocked call
releases the GIL; a dispatch wedged inside native code cannot be killed from
inside its own process. The defence that always works is to run the risky
work in a child process with a deadline and SIGKILL its whole process group
when the deadline expires:

* ``run_child``: run an argv in its own session with a wall deadline,
  SIGKILL the group on expiry, classify the outcome (``ok``, ``timeout``,
  ``crash``) as a ``ChildResult``, and retry through the shared
  ``RetryPolicy`` (the native build's ``cc`` runs through it);
* ``run_isolated_sweep``: the ``--isolate`` supervisor. Each sweep unit
  runs in a child (``python -m our_tree_tpu_torch.harness.bench
  --isolate-child UNIT``) that appends its unit to the shared journal; a
  hung child is SIGKILLed at the unit deadline, each failure is a journal
  failure row, and a unit that fails ``quarantine_after`` times is
  quarantined: skipped now and on every resumed run, with
  ``quarantined:<unit>`` stamped through ``degrade``. The parent re-emits
  completed units' lines from the journal.

The reference's ``spawn_service`` and ``run_streamed`` (long-running
service children and streamed logs) have no caller in the port yet.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from ..obs import trace
from . import degrade, faults, journal, policy


def _meter_faults(base_env: dict) -> dict:
    """Meter this process's armed faults into one child's environment: each
    spawn consumes one shot per armed counted point (``faults.consume``, so
    the metering is not itself an injection) and hands the child exactly
    that shot; a bare (fire-forever) point hands one shot per spawn. So
    ``dispatch_hang:1`` under ``--isolate`` hangs one child in the whole
    sweep, not every child's first dispatch."""
    if not base_env.get("OT_FAULTS"):
        return base_env
    tokens = []
    for point in faults.armed():
        if faults.remaining(point) == faults.ALWAYS or faults.consume(point):
            tokens.append(f"{point}:1")
    env = dict(base_env)
    env["OT_FAULTS"] = ",".join(tokens)
    return env


class ChildResult:
    """One child run's classified outcome: ``kind`` ``"ok"`` (exit 0),
    ``"crash"`` (any other exit; a signal death gives a negative ``rc``) or
    ``"timeout"`` (the deadline expired and the group was SIGKILLed);
    ``out``/``err`` the captured text ("" when not captured), ``wall_s``
    the attempt's wall clock."""

    __slots__ = ("kind", "rc", "out", "err", "wall_s")

    def __init__(self, kind: str, rc, out: str, err: str, wall_s: float):
        self.kind, self.rc = kind, rc
        self.out, self.err, self.wall_s = out, err, wall_s

    @property
    def ok(self) -> bool:
        return self.kind == "ok"

    def __repr__(self):
        return f"ChildResult({self.kind!r}, rc={self.rc}, wall_s={self.wall_s:.1f})"


def _kill_group(proc) -> None:
    """SIGKILL the child's whole session (it leads one); the single process
    if the group is gone."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (OSError, AttributeError):
        try:
            proc.kill()
        except OSError:
            pass


def _attempt(argv, timeout_s, env, cwd, capture) -> ChildResult:
    t0 = time.monotonic()
    pipe = subprocess.PIPE if capture else None
    proc = subprocess.Popen(argv, env=env, cwd=cwd, stdout=pipe, stderr=pipe, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        # Reap and drain what the child wrote before it died: partial stderr
        # is often the only evidence of where it hung.
        out, err = proc.communicate()
        return ChildResult("timeout", proc.returncode, out or "", err or "",
                           time.monotonic() - t0)
    kind = "ok" if proc.returncode == 0 else "crash"
    return ChildResult(kind, proc.returncode, out or "", err or "", time.monotonic() - t0)


def run_child(argv, timeout_s: float | None = None, *, env=None, cwd=None,
              capture: bool = True, attempts: int = 1, base_delay_s: float = 0.0,
              name: str = "", log=None) -> ChildResult:
    """Run ``argv`` in its own session with a wall deadline; retry non-``ok``
    outcomes through ``RetryPolicy``. Returns the last attempt's
    ``ChildResult`` and never raises for a child's failure. ``log(attempt,
    exc)`` observes each failed attempt."""
    last: dict = {}

    class _ChildFailed(Exception):
        pass

    def op(attempt):
        label = name or os.path.basename(str(argv[0]))
        with trace.span("child", label=label, attempt=attempt.index):
            cenv = trace.child_env(dict(env if env is not None else os.environ))
            r = _attempt(argv, timeout_s, cenv, cwd, capture)
            if r.kind == "timeout":
                trace.point("child-killed", label=name, wall_s=round(r.wall_s, 3))
        last["r"] = r
        if not r.ok:
            raise _ChildFailed(f"{r.kind} (rc={r.rc})")
        return r

    return policy.RetryPolicy(
        attempts=max(attempts, 1), base_delay_s=base_delay_s, retry_on=(_ChildFailed,), log=log,
        on_exhausted=lambda e: last["r"],
        name=name or f"run_child:{os.path.basename(str(argv[0]))}").run(op)


def run_isolated_sweep(*, units, child_argv, journal_path: str, config: dict, emit,
                       unit_deadline_s: float, quarantine_after: int, env=None, cwd=None,
                       log=None) -> list[str]:
    """Supervise one sweep, one child process per unit attempt.

    ``units`` is the ordered unit-name list (a pure function of ``config``);
    ``child_argv(unit)`` builds the argv of a child that replays the
    journal, runs exactly that unit, appends it to the journal and exits.
    ``emit(line)`` is the parent's result emitter; completed units' lines
    are re-emitted from the journal. Per unit: spawn, deadline, SIGKILL on
    expiry, a failure row on any non-completion; after ``quarantine_after``
    recorded failures (across runs) the unit is quarantined. Returns the
    quarantined unit names, in sweep order."""
    note = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    jn = journal.SweepJournal(journal_path, config)
    if jn.pending:
        note(f"# journal: {jn.pending} completed unit(s) on file ({journal_path}); resuming")
    quarantined: list[str] = []

    def consume(name: str) -> bool:
        """Take and emit ``name``'s completed record, by name: the
        supervisor restores no RNG state, so replay order is not its
        contract, and a released or retried unit completes after its
        successors."""
        if not jn.is_completed(name):
            return False
        entry = jn.take(name)
        if entry is None:
            return False
        for line in entry.get("lines", []):
            emit(line)
        for kind in entry.get("degraded", []):
            degrade.degrade(kind, "restored from journal")
        trace.point("unit-replayed", unit=name)
        return True

    try:
        for name in units:
            if consume(name):
                continue
            attempt_no = 0
            while jn.fail_count(name) < quarantine_after and not jn.is_completed(name):
                n_prev = jn.fail_count(name)
                attempt_no += 1
                with trace.span("unit-attempt", unit=name, attempt=attempt_no):
                    r = run_child(child_argv(name), unit_deadline_s,
                                  env=_meter_faults(dict(env if env is not None else os.environ)),
                                  cwd=cwd, name=f"isolate:{name}")
                jn.reload_tail()
                if jn.is_completed(name):
                    break
                reason = (f"timeout:{unit_deadline_s:.0f}s" if r.kind == "timeout"
                          else f"crash:rc={r.rc}")
                jn.record_failure(name, reason)
                trace.point("unit-failed", unit=name, reason=reason, attempt=attempt_no)
                tail = r.err.strip().splitlines()[-3:]
                note(f"# isolate: unit {name} failed ({reason}; failure {n_prev + 1}/"
                     f"{quarantine_after})" + (": " + " | ".join(tail) if tail else ""))
            if not consume(name):
                if jn.fail_count(name) >= quarantine_after:
                    quarantined.append(name)
                    trace.point("quarantine", unit=name, fails=jn.fail_count(name))
                    degrade.degrade(f"quarantined:{name}",
                                    f"{jn.fail_count(name)} recorded failure(s); skipping on "
                                    "this and every resumed run")
                else:
                    note(f"# isolate: unit {name} completed but its journal record was "
                         "distrusted; rows not re-emitted")
        if jn.resumed:
            note(f"# journal: skipped {jn.resumed} completed unit(s)")
    finally:
        jn.close()
    return quarantined
