"""Dispatch watchdog: a deadline around a device call, kept by one monitor
thread.

Copy of ``our_tree_tpu.resilience.watchdog``'s deadline machinery. On the
port the guarded call is a lane's engine call, which ends in a CUDA stream
synchronize (the barrier that waits out the card's work). A running CUDA
kernel cannot be interrupted; what the watchdog can do at the deadline is

1. dump every thread's stack to a crash-report file (``OT_CRASH_DIR``,
   default ``ot_crash`` under the process's temporary directory, which
   honours ``TMPDIR``; the reference's default is a fixed ``/tmp/ot_crash``),
   so a hang leaves evidence of where each thread was;
2. deliver ``DispatchTimeout``: on the main thread (the sweep harness) by
   a SIGALRM sent to it, whose handler raises, which interrupts a call that
   releases the GIL (a ``torch.cuda.synchronize``, a sleep, a subprocess
   wait); on a thread that registered a kill hook (``thread_kill_hook``:
   the serve lane workers) by calling the hook, which fails the dispatch's
   future and abandons the wedged worker; on any other thread by raising
   when the guarded block returns late;
3. record the demotion (``degrade``, kind ``dispatch-timeout``), together
   with the raise: a block that completes at the deadline's edge is never
   marked degraded.

``current_stacks`` (every thread's frames, the machinery of the dump) is
shared with the profiler's stack-sampling tier.

``deadline(None or 0)`` disarms entirely; ``default_deadline_s()`` reads the
opt-in global ``OT_DISPATCH_DEADLINE``. Every armed deadline rides one
long-lived scheduler thread, so arming costs a dict insert, not a thread.

``injected_hang(point)`` is the fault side of the same seam: when the named
``OT_FAULTS`` point (``dispatch_hang``) fires it sleeps ``OT_HANG_S``
seconds (default 24 h), a GIL-releasing stand-in for a wedged dispatch that
the watchdog can interrupt and a supervising parent can SIGKILL.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import tempfile
import threading
import time
import traceback

from ..obs import trace
from . import degrade, faults


class DispatchTimeout(TimeoutError):
    """A guarded device call exceeded its watchdog deadline. ``what`` names
    the call; ``report`` is the crash-report path (None when the dump
    failed)."""

    def __init__(self, what: str, seconds: float, report: str | None):
        self.what, self.seconds, self.report = what, seconds, report
        super().__init__(f"{what} exceeded its {seconds:.0f}s watchdog deadline"
                         + (f" (stacks: {report})" if report else ""))


def crash_dir() -> str:
    return os.environ.get("OT_CRASH_DIR") or os.path.join(tempfile.gettempdir(), "ot_crash")


def default_deadline_s() -> float:
    """The opt-in global dispatch deadline (``OT_DISPATCH_DEADLINE``,
    seconds); 0 / unset disarms."""
    try:
        return max(float(os.environ.get("OT_DISPATCH_DEADLINE", 0) or 0), 0.0)
    except ValueError:
        return 0.0


def current_stacks(depth: int | None = None) -> dict:
    """{thread ident: (name, [compact frame strings, leaf first])}: every
    thread's frames, at most ``depth`` each; the profiler's stack-sampling
    tier (``obs/profiler.py``) reads it."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict = {}
    for ident, frame in sys._current_frames().items():
        frames = []
        f = frame
        while f is not None and (depth is None or len(frames) < depth):
            co = f.f_code
            frames.append(f"{co.co_name} ({os.path.basename(co.co_filename)}:{f.f_lineno})")
            f = f.f_back
        out[ident] = (names.get(ident, "?"), frames)
    return out


def dump_stacks(what: str, seconds: float) -> str | None:
    """Write every thread's current stack, with thread names, to a
    crash-report file; the path, or None when nothing could be written."""
    try:
        d = crash_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"watchdog-{os.getpid()}-{int(time.time())}.txt")
        names = {t.ident: t.name for t in threading.enumerate()}
        with open(path, "w") as fh:
            fh.write(f"# watchdog: {what!r} exceeded {seconds:.0f}s (pid {os.getpid()}, "
                     f"{time.strftime('%Y-%m-%dT%H:%M:%S%z')})\n")
            for ident, frame in sorted(sys._current_frames().items()):
                fh.write(f"\n## thread {names.get(ident, '?')} (ident {ident})\n")
                fh.write("".join(traceback.format_stack(frame)))
        return path
    except OSError:
        return None


class _Scheduler:
    """One daemon thread multiplexing every armed deadline: it sleeps until
    the earliest expiry and hands each due entry's ``fire`` to a short-lived
    thread (a dump stuck on a full disk disables only its own deadline).
    An entry disarmed before it is due never fires."""

    def __init__(self):
        self._cv = threading.Condition()
        self._entries: dict = {}  # id -> (monotonic expiry, fire)
        self._seq = 0
        self._thread = None

    def arm(self, seconds: float, fire) -> int:
        with self._cv:
            self._seq += 1
            eid = self._seq
            self._entries[eid] = (time.monotonic() + seconds, fire)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name="ot-watchdog")
                self._thread.start()
            self._cv.notify()
        return eid

    def disarm(self, eid: int) -> None:
        with self._cv:
            self._entries.pop(eid, None)
            self._cv.notify()

    def _run(self):
        while True:
            with self._cv:
                if not self._entries:
                    self._cv.wait()
                    continue
                now = time.monotonic()
                nxt = min(t for t, _ in self._entries.values())
                if nxt > now:
                    self._cv.wait(nxt - now)
                    continue
                due = [eid for eid, (t, _) in self._entries.items() if t <= now]
                fires = [self._entries.pop(eid)[1] for eid in due]
            for fire in fires:
                threading.Thread(target=self._fire_one, args=(fire,), daemon=True,
                                 name="ot-watchdog-fire").start()

    @staticmethod
    def _fire_one(fire):
        try:
            fire()
        except Exception:  # noqa: BLE001 - a fire thread must not die loudly
            pass


_SCHEDULER = _Scheduler()

#: thread ident -> kill hook (``thread_kill_hook``).
_THREAD_KILLS: dict[int, object] = {}


@contextlib.contextmanager
def thread_kill_hook(hook):
    """Register ``hook(exc)`` as this thread's watchdog kill path: a
    deadline armed on this thread that expires calls
    ``hook(DispatchTimeout(...))`` from the expiry thread, after the stack
    dump and the degrade stamp. The hook must be quick and must not raise.
    Nests: the previous hook is restored on exit."""
    ident = threading.get_ident()
    prev = _THREAD_KILLS.get(ident)
    _THREAD_KILLS[ident] = hook
    try:
        yield
    finally:
        if prev is None:
            _THREAD_KILLS.pop(ident, None)
        else:
            _THREAD_KILLS[ident] = prev


@contextlib.contextmanager
def deadline(seconds: float | None, what: str = "device dispatch",
             degrade_kind: str = "dispatch-timeout"):
    """Guard a block with a watchdog deadline. ``seconds`` None or <= 0
    disarms. At expiry the stacks are dumped; on the main thread a SIGALRM
    handler installed for the block raises ``DispatchTimeout`` inside it;
    on a thread with a kill hook the hook gets the ``DispatchTimeout`` at
    once; on any other thread a block that returns after its deadline
    raises it on exit. The previous SIGALRM disposition is restored."""
    if not seconds or seconds <= 0:
        yield
        return
    trace.point("watchdog-arm", what=what, seconds=seconds)
    on_main = (threading.current_thread() is threading.main_thread()
               and hasattr(signal, "SIGALRM"))
    kill_hook = None if on_main else _THREAD_KILLS.get(threading.get_ident())
    fired: dict = {}
    done = threading.Event()
    # Serialises the kill against the handler's restore: the signal is sent
    # only while this block's handler is installed.
    gate = threading.Lock()

    def record_and_build():
        # The degrade stamp rides the delivery, not the monitor: a block
        # that completes at the edge must not leave the run marked degraded.
        degrade.degrade(degrade_kind, f"{what} exceeded {seconds:.0f}s watchdog deadline")
        trace.point("watchdog-expired", what=what, seconds=seconds, report=fired.get("report"))
        return DispatchTimeout(what, seconds, fired.get("report"))

    def fire():
        if done.is_set():
            return
        fired["report"] = dump_stacks(what, seconds)
        with gate:
            if done.is_set():
                return
            if on_main:
                try:
                    signal.pthread_kill(threading.main_thread().ident, signal.SIGALRM)
                except (OSError, RuntimeError):
                    pass
            elif kill_hook is not None:
                fired["delivered"] = True
                try:
                    kill_hook(record_and_build())
                except Exception:  # noqa: BLE001 - the hook is the caller's
                    pass

    old = None
    if on_main:
        def handler(signum, frame):
            raise record_and_build()

        old = signal.signal(signal.SIGALRM, handler)
    eid = _SCHEDULER.arm(seconds, fire)
    try:
        yield
        if "report" in fired and not on_main:
            if fired.get("delivered"):
                raise DispatchTimeout(what, seconds, fired.get("report"))
            raise record_and_build()
    finally:
        try:
            done.set()
            _SCHEDULER.disarm(eid)
            # Wait out a fire() past its done check: once the gate is free a
            # kill in flight has been sent to the still-installed handler,
            # and a later fire stands down.
            with gate:
                pass
        finally:
            if old is not None:
                signal.signal(signal.SIGALRM, old)


#: Injected hangs fired so far in this process (``hangs_injected``).
_INJECTED_HANGS = 0
#: Idents of the threads asleep in an injected hang (``parked``).
_PARKED: set[int] = set()


def parked(thread: threading.Thread) -> bool:
    """Whether ``thread`` sleeps in an injected hang: a stand-in for a
    wedged call that nothing waits out (``LaneExecutor.close``)."""
    return thread.ident in _PARKED


def hangs_injected() -> int:
    return _INJECTED_HANGS


def injected_hang(point: str, detail: str = "", budget=None) -> bool:
    """Simulate a wedged dispatch when the ``point`` fault fires: sleep
    ``OT_HANG_S`` seconds (default 24 h, a GIL-releasing sleep the watchdog
    can interrupt and a parent can SIGKILL), or, given a ``policy.Budget``,
    debit the hang's cost from it without sleeping. Returns whether it
    fired; one dict lookup while the point is unarmed."""
    if not faults.fire(point):
        return False
    global _INJECTED_HANGS
    _INJECTED_HANGS += 1
    hang_s = float(os.environ.get("OT_HANG_S", 24 * 3600))
    if budget is not None:
        budget.debit(hang_s)
        return True
    print(f"# OT_FAULTS: {point} sleeping {hang_s:.0f}s" + (f" ({detail})" if detail else ""),
          file=sys.stderr, flush=True)
    ident = threading.get_ident()
    _PARKED.add(ident)
    try:
        time.sleep(hang_s)
    finally:
        _PARKED.discard(ident)
    return True
