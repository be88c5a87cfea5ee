"""Duration events of the port's run-time builds, for whoever listens.

The JAX server times XLA's backend compiles through ``jax.monitoring``'s
duration events. The port compiles nothing while it serves; what stands in
for a compile is a build or load of the kernel library
(``runtime/cuda_build.py``, event ``LIBRARY_LOAD``) and the first call of a
serve seam for an (engine, nr, device) (``models/aes.py:seam_call``, event
``SEAM_FIRST_CALL``: on the card CUDA loads a kernel's code at its first
launch). Each emits its host seconds here, the load's subtracted from the
seam call that triggered it, so no second is counted twice. The serve
server registers the listener that labels them by the warmup walk's rung
(``serve_compile_us{engine, rung}``).

A listener that raises is ignored: a measurement never fails a build.
"""

from __future__ import annotations

LIBRARY_LOAD = "/ot/cuda_build/load"
SEAM_FIRST_CALL = "/ot/serve/seam_first_call"

_LISTENERS: list = []


def register_event_duration_listener(fn) -> None:
    """Call ``fn(event, seconds)`` on every duration event (idempotent)."""
    if fn not in _LISTENERS:
        _LISTENERS.append(fn)


def record_event_duration_secs(event: str, seconds: float) -> None:
    for fn in list(_LISTENERS):
        try:
            fn(event, seconds)
        except Exception:  # noqa: BLE001 - a listener never fails the caller
            pass
