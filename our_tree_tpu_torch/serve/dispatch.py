"""Per-lane dispatch executors: one worker thread per lane.

Port of ``our_tree_tpu.serve.dispatch``. Each lane owns one worker thread;
the batcher loop submits engine calls to it and keeps forming batches while
dispatches run, and completions come back to the asyncio loop as futures.
On the port the worker thread is also where the lane's CUDA stream is made
current and its kernels are launched (``Lane.engine_call``).

The watchdog moves with the dispatch. A worker thread cannot be signalled
and a running CUDA kernel cannot be interrupted, so the kill path is: fail
the future, abandon the thread. The executor registers a kill hook
(``watchdog.thread_kill_hook``) around every unit it runs; when the
deadline armed inside the unit expires, the hook fails the unit's future
with ``DispatchTimeout`` (the waiter fails over at once) and marks this
worker abandoned. The wedged thread is left behind; a fresh worker is
spawned on the lane's next use. If the abandoned thread wakes, it sees its
generation is stale, discards its result, fails whatever was still queued
behind it and exits. ``close`` waits for abandoned threads still at work
(not those parked in an injected hang): one that woke while the
interpreter shut down would unwind out of torch and abort the process.

Stdlib only: the device contact stays in ``serve/lanes.py``.
"""

from __future__ import annotations

import concurrent.futures
import queue as _queue
import threading
import time

from ..obs import metrics
from ..resilience import watchdog

#: How long ``LaneExecutor.close`` waits for its worker to end.
CLOSE_JOIN_S = 10.0


def _resolve(fut: concurrent.futures.Future, result=None, exc=None) -> None:
    """Settle ``fut`` from whichever side got there first (the worker or
    the kill path); the loser's write is discarded."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except concurrent.futures.InvalidStateError:
        pass


class LaneExecutor:
    """One worker thread running one lane's engine calls in FIFO order.

    ``submit(unit)`` returns a ``concurrent.futures.Future``. The worker is
    spawned lazily and replaced after a kill (``abandoned`` counts the
    wedged threads left behind). ``close()`` ends an idle worker.
    """

    def __init__(self, name: str, lane: int | None = None):
        self._name = name
        self._lane = lane
        self._lock = threading.Lock()
        self._gen = 0
        self._q: _queue.SimpleQueue | None = None
        self._thread: threading.Thread | None = None
        self._abandoned_threads: list[threading.Thread] = []
        self.abandoned = 0

    def submit(self, unit) -> concurrent.futures.Future:
        """Queue one callable; spawn or replace the worker if none is live."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._gen += 1
                self._q = _queue.SimpleQueue()
                self._thread = threading.Thread(target=self._run, args=(self._gen, self._q),
                                                daemon=True, name=self._name)
                self._thread.start()
            self._q.put((fut, unit, time.monotonic()))
        return fut

    def close(self) -> None:
        """Stop the current worker after its queued work and wait up to
        ``CLOSE_JOIN_S`` in all for it and for the abandoned workers still at
        work to end (idempotent): a worker thread that is still unwinding
        out of torch while the interpreter shuts down can abort the process.
        A worker parked in an injected hang is not waited for."""
        with self._lock:
            thread = self._thread
            if self._q is not None and thread is not None and thread.is_alive():
                self._q.put(None)
            else:
                thread = None
            self._thread = None
            self._q = None
            abandoned, self._abandoned_threads = self._abandoned_threads, []
        end = time.monotonic() + CLOSE_JOIN_S
        for t in [thread, *abandoned]:
            if (t is not None and t is not threading.current_thread()
                    and not watchdog.parked(t)):
                t.join(max(end - time.monotonic(), 0.0))

    def _run(self, gen: int, q: _queue.SimpleQueue) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            fut, unit, t_submit = item
            if not fut.set_running_or_notify_cancel():
                continue
            metrics.observe("serve_worker_wait_us", (time.monotonic() - t_submit) * 1e6,
                            lane=self._lane)

            def kill(exc, fut=fut):
                self._abandon(gen)
                _resolve(fut, exc=exc)

            with watchdog.thread_kill_hook(kill):
                try:
                    result = unit()
                except BaseException as e:  # noqa: BLE001 - the future carries it
                    _resolve(fut, exc=e)
                else:
                    _resolve(fut, result=result)
            with self._lock:
                stale = self._gen != gen
            if stale:
                self._fail_pending(q, "worker retired")
                return

    def _fail_pending(self, q: _queue.SimpleQueue | None, why: str) -> None:
        """Fail every unit still queued on a retired queue (they never ran,
        so no deadline will ever unblock their waiters)."""
        while q is not None:
            try:
                item = q.get_nowait()
            except _queue.Empty:
                return
            if item is not None:
                _resolve(item[0], exc=RuntimeError(f"{self._name}: {why} before this unit ran"))

    def _abandon(self, gen: int) -> None:
        """Retire generation ``gen``'s worker (the kill path): the next
        submit spawns a replacement; units queued behind the wedged one are
        failed here."""
        with self._lock:
            if self._gen != gen:
                return
            self._gen += 1
            if self._thread is not None:
                self._abandoned_threads.append(self._thread)
            self._thread = None
            q, self._q = self._q, None
            self.abandoned += 1
        self._fail_pending(q, "worker abandoned (watchdog kill)")
