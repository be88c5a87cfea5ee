"""Advisory single-tenant lock for the card.

Copy of ``our_tree_tpu.utils.devlock``. Measurement jobs coordinate through
a marker file (``OT_BENCH_BUSY_FILE``, default ``gpu_busy`` in the
temporary directory, so under ``TMPDIR``): the bench
(``python -m our_tree_tpu_torch.bench``) waits on it, then holds it from
before its first touch of the card to the end of its measurement, so two
measurements never share the card and spoil each other's numbers.

* **Atomic ownership**: acquisition is ``O_CREAT | O_EXCL`` with
  ``pid:starttime`` written into the file (starttime from
  ``/proc/<pid>/stat`` field 22 where available).
* **Staleness self-healing**: a marker is reclaimed when its writer is dead,
  when its PID was recycled (the starttime differs), or, for a PID-less
  marker (``touch`` by an orchestrator), when its mtime is older than
  ``STALE_S``. A bare-PID marker keeps the PID and mtime rules.
* **Deterministic failure rehearsal**: the ``lock_busy`` fault point
  (``resilience/faults.py``). While armed, ``is_held`` reports a live
  holder (a peek, no shot consumed) and each ``acquire`` consumes a shot
  and fails: ``OT_FAULTS=lock_busy:N`` is N failed acquisitions, a bare
  ``OT_FAULTS=lock_busy`` a holder that never leaves.
* **Advisory**: ``wait`` returns when its budget is spent; what a caller
  does then is its own policy (the bench exits non-zero and names the
  holder).

Orchestrator contract: a process that holds ONE marker around several child
jobs points the children at a different path (``OT_BENCH_BUSY_FILE``), or
holds none; otherwise each child would wait out its budget on its parent's
marker.

Stdlib-only, so that it loads as a bare file (``importlib`` by path) without
importing the package; ``_faults`` loads the fault registry the same way.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time

#: Follows ``TMPDIR``: two checkouts run with their own temporary directories
#: never meet in one marker unless ``OT_BENCH_BUSY_FILE`` names a shared one.
DEFAULT_PATH = os.path.join(tempfile.gettempdir(), "gpu_busy")

#: A PID-less marker older than this is abandoned. Exceeds the longest
#: legitimate plan that holds one marker across several jobs.
STALE_S = 4 * 3600.0


def path() -> str:
    return os.environ.get("OT_BENCH_BUSY_FILE", DEFAULT_PATH)


def _faults():
    """``resilience/faults.py``, loaded lazily without importing the package
    and registered under its dotted name, so that its counters are the ones
    every other importer sees."""
    import sys
    canonical = "our_tree_tpu_torch.resilience.faults"
    mod = sys.modules.get(canonical)
    if mod is None:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            canonical, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                                    "resilience", "faults.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[canonical] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            sys.modules.pop(canonical, None)
            raise
    return mod


def _proc_starttime(pid: int) -> str | None:
    """Kernel starttime ticks for ``pid`` (``/proc/<pid>/stat`` field 22), or
    None off Linux or on a failed read. (pid, starttime) names a process
    uniquely for the machine's uptime."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
        # comm (field 2) may hold spaces and parentheses; the fields resume
        # after the last ')', where starttime is index 19.
        return stat.rsplit(b")", 1)[1].split()[19].decode()
    except (OSError, IndexError, ValueError):
        return None


def _writer_alive(pid: int, starttime: str | None = None) -> bool:
    if starttime:
        now = _proc_starttime(pid)
        if now is not None:
            # The same starttime: the writer still runs; another one: it
            # died and its PID was recycled.
            return now == starttime
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except Exception:
        return True  # EPERM and the like: someone's process, assume alive


def _read_marker(p: str) -> tuple[int, str | None]:
    """(pid, starttime) from a marker: ``pid:starttime``, a bare ``pid``, or
    (0, None) for a PID-less touch or an unreadable file."""
    try:
        with open(p) as f:
            body = f.read().strip()
    except OSError:
        return 0, None
    pid_s, _, start = body.partition(":")
    try:
        return int(pid_s or "0"), (start or None)
    except ValueError:
        return 0, None


def holder(p: str | None = None) -> str:
    """The marker's holder for a message: ``pid <n>``, ``pid-less marker``
    or ``injected lock_busy``."""
    p = p or path()
    if _faults().remaining("lock_busy"):
        return "injected lock_busy"
    pid, _ = _read_marker(p)
    return f"pid {pid}" if pid else "pid-less marker"


def is_held(p: str | None = None) -> bool:
    """True if the marker exists and its holder still looks alive."""
    p = p or path()
    if _faults().remaining("lock_busy"):
        # A peek: while lock_busy is armed the simulated holder exists, and
        # only acquire() burns shots.
        return True
    try:
        st = os.stat(p)
    except OSError:
        return False
    pid, start = _read_marker(p)
    fresh = time.time() - st.st_mtime <= STALE_S
    if pid:
        return _writer_alive(pid, start) and fresh
    return fresh


def wait(budget_s: float, p: str | None = None, poll_s: float = 15.0, on_wait=None) -> float:
    """Block while the marker is held, up to ``budget_s`` on the monotonic
    clock; returns the time waited. ``on_wait(path)`` is called once when
    the wait starts."""
    p = p or path()
    t0 = time.monotonic()
    announced = False
    while is_held(p) and time.monotonic() - t0 < budget_s:
        if not announced and on_wait is not None:
            on_wait(p)
            announced = True
        time.sleep(poll_s)
    return time.monotonic() - t0


def acquire(p: str | None = None) -> bool:
    """Atomically claim the marker; True iff this process now owns it. A
    stale marker is reclaimed by a rename aside, of which only one of two
    racing reclaimers succeeds."""
    p = p or path()
    if _faults().fire("lock_busy"):
        return False
    for _ in range(2):  # the second try after reclaiming a stale marker
        try:
            fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            with os.fdopen(fd, "w") as f:
                pid = os.getpid()
                start = _proc_starttime(pid)
                f.write(f"{pid}:{start}" if start else str(pid))
            return True
        except FileExistsError:
            if is_held(p):
                return False
            aside = f"{p}.stale.{os.getpid()}"
            try:
                os.rename(p, aside)
                os.remove(aside)
            except OSError:
                return False
        except OSError:
            return False
    return False


def release(owned: bool, p: str | None = None) -> None:
    if not owned:
        return
    try:
        os.remove(p or path())
    except OSError:
        pass


@contextlib.contextmanager
def hold(p: str | None = None, wait_budget_s: float = 0.0, on_wait=None,
         refresh_s: float = 600.0):
    """Wait for a prior holder (bounded), then claim the marker for the
    block; yields whether it is owned, and only the owner removes it. While
    owned, a daemon thread refreshes the marker's mtime every ``refresh_s``
    so a long holder never ages past ``STALE_S``."""
    p = p or path()
    if wait_budget_s > 0:
        wait(wait_budget_s, p, on_wait=on_wait)
    owned = acquire(p)
    stop = threading.Event()
    refresher = None
    if owned and refresh_s > 0:
        def _refresh():
            while not stop.wait(refresh_s):
                try:
                    os.utime(p)
                except OSError:
                    break

        refresher = threading.Thread(target=_refresh, daemon=True)
        refresher.start()
    try:
        yield owned
    finally:
        stop.set()
        if refresher is not None:
            refresher.join(timeout=2.0)
        release(owned, p)
