"""The one chokepoint every graceful demotion reports through.

Copy of ``our_tree_tpu.resilience.degrade``. ``degrade(kind, why)`` records
a demotion (``accept->shed``, ``quarantined:lane:0``, ``dispatch-timeout``)
in a process-global ledger, once per kind, as a trace point and one stderr
line; ``events()`` lists the kinds for the bench JSON line, so a degraded
run never looks like a healthy one.
"""

from __future__ import annotations

import sys

from ..obs import trace

#: (kind, why) in record order, duplicates (by kind) dropped.
_EVENTS: list[tuple[str, str]] = []


def degrade(kind: str, why: str = "") -> None:
    """Record a demotion and announce it on stderr (once per kind)."""
    if any(k == kind for k, _ in _EVENTS):
        return
    _EVENTS.append((kind, why))
    trace.point("degrade", kind=kind, why=why)
    print(f"# degraded: {kind}" + (f" ({why})" if why else ""), file=sys.stderr, flush=True)


def events() -> list[str]:
    """Recorded demotion kinds, first-occurrence order. Empty = healthy."""
    return [k for k, _ in _EVENTS]



def clear() -> None:
    """Reset the ledger (tests only)."""
    del _EVENTS[:]
