"""Sweep checkpoint/resume journal (JSONL).

Copy of ``our_tree_tpu.resilience.journal``, with the same file format. The
sweep harness (``harness.bench --journal``) appends one entry per completed
sweep unit; a restarted sweep with the same config hash replays the
recorded units (re-emitting their result lines verbatim and restoring the
shared RNG stream) and resumes at the first unfinished one.

Line 1 is the header; every later line is one completed unit, one recorded
failure of a unit (an isolated child that hung or crashed, or a watchdog
expiry), or one completed worker row inside a still-running unit::

    {"kind": "ot-sweep-journal", "v": 1, "config_hash": "...", "config": {...}}
    {"unit": "ecb:65536", "lines": [...], "rng_state": {...}, "degraded": []}
    {"unit": "ctr:65536", "failed": true, "reason": "timeout:20s"}
    {"unit": "ctr:65536", "row": "2", "lines": [...], "rng_state": {...}}

Failure rows are counted (``fail_count``), never replayed: a unit whose
count reaches the caller's quarantine threshold is skipped with a
``quarantined:<unit>`` demotion. Row records are replayed only from inside
their unit's re-run. ``clear_failures`` is the quarantine-release edit
(``--unquarantine``).

Entries are flushed and fsync'd as they complete, so a SIGKILL tears at
most the line in flight; a torn or unparseable tail is truncated away on
load. A header whose ``config_hash`` differs from the current sweep's
invalidates the journal, which restarts fresh. Resume is correct because
the unit order is a pure function of the config and each entry records the
RNG state after its unit ran. Stdlib only.
"""

from __future__ import annotations

import hashlib
import json
import os

KIND = "ot-sweep-journal"
VERSION = 1


def config_hash(config: dict) -> str:
    """Stable hash of a sweep's identity (JSON-serializable config)."""
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class SweepJournal:
    """One sweep's checkpoint file. See the module docstring for format.

    ``skip(unit)`` returns the recorded entry when `unit` is the next
    replayable one (consume in sweep order), else None — and a unit-order
    mismatch (possible only if the unit sequence stopped being a pure
    function of the hashed config) distrusts and truncates the remaining
    tail rather than replaying rows into the wrong slots.
    """

    def __init__(self, path: str, config: dict):
        self.path = path
        self.config_hash = config_hash(config)
        self._replay: list[dict] = []
        self._fail_counts: dict[str, int] = {}
        self._rows: dict[str, dict[str, dict]] = {}
        self._resumed = 0
        valid_bytes = 0
        header_ok = False
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            raw = b""
        offset = 0
        for line in raw.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break  # torn in-flight write: trust nothing from here on
            try:
                rec = json.loads(line)
            except ValueError:
                break
            if offset == 0:
                if not (isinstance(rec, dict) and rec.get("kind") == KIND
                        and rec.get("v") == VERSION
                        and rec.get("config_hash") == self.config_hash):
                    break  # foreign/changed config: invalidate everything
                header_ok = True
            elif isinstance(rec, dict) and isinstance(rec.get("unit"), str):
                if rec.get("failed"):
                    # A failure row is evidence, not a checkpoint: count
                    # it toward quarantine, never offer it for replay.
                    u = rec["unit"]
                    self._fail_counts[u] = self._fail_counts.get(u, 0) + 1
                elif rec.get("row") is not None:
                    # An intra-unit worker-row checkpoint: replayable
                    # only from INSIDE its unit's re-run, never as a
                    # completed unit.
                    self._rows.setdefault(rec["unit"], {})[
                        str(rec["row"])] = rec
                else:
                    self._replay.append(rec)
            else:
                break
            offset += len(line)
            valid_bytes = offset
        if not header_ok:
            self._replay = []
            valid_bytes = 0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # Truncate away any distrusted tail, then hold the file open in
        # append mode; a fresh/invalidated journal gets its header now so
        # a kill before the first completed row still leaves a valid file.
        self._fh = open(path, "ab")
        if self._fh.tell() != valid_bytes:
            self._fh.truncate(valid_bytes)
            self._fh.seek(valid_bytes)
        if valid_bytes == 0:
            self._append({"kind": KIND, "v": VERSION,
                          "config_hash": self.config_hash, "config": config})

    # -- internals ---------------------------------------------------------
    # The crash-safety contract: a record must be on disk before the
    # next admission decision, so the fsync is deliberately inline —
    # failure/lifecycle cadence only, never the per-request path.
    # ot-san: absorb=journal-fsync-durability
    def _append(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec, separators=(",", ":")).encode()
                       + b"\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    # -- API ---------------------------------------------------------------
    @property
    def pending(self) -> int:
        """Completed units not yet replayed this run."""
        return len(self._replay)

    @property
    def resumed(self) -> int:
        """Units replayed from the journal so far this run."""
        return self._resumed

    def is_completed(self, unit: str) -> bool:
        """Whether `unit` has an unconsumed replayable record — one
        loaded from a previous run or absorbed via ``reload_tail`` (a
        unit this handle ``record()``-ed itself is done, not replayable:
        its lines were already emitted live).

        Callers MUST gate ``skip()`` on this: with failure rows on file a
        unit can be absent from the replay list without any disorder
        (it failed; the next completed unit is a later one), and calling
        ``skip()`` for it would misread the head mismatch as corruption
        and truncate a perfectly good tail.
        """
        return any(e.get("unit") == unit for e in self._replay)

    def fail_count(self, unit: str) -> int:
        """Recorded failures of `unit` (the quarantine ledger's count)."""
        return self._fail_counts.get(unit, 0)

    def record_failure(self, unit: str, reason: str) -> None:
        """Append one failure row (fsync'd) and count it in-memory.

        Written by the SUPERVISOR (isolate.py's parent — the child that
        hung was SIGKILLed and cannot write anything), or by the in-
        process watchdog path when a unit's dispatch times out.
        """
        self._fail_counts[unit] = self._fail_counts.get(unit, 0) + 1
        self._append({"unit": unit, "failed": True, "reason": reason})

    def reload_tail(self) -> int:
        """Re-read rows appended by another process (an isolated child)
        since this handle last looked; returns how many completed-unit
        rows arrived. New completed rows join the replay list (the
        supervisor consumes them via ``skip`` to re-emit their lines);
        new failure rows join the counts.

        A torn trailing fragment — the child was SIGKILLed mid-append,
        which is exactly what the isolate supervisor does to a hung
        child — is TRUNCATED away before returning: this handle is
        about to append its own rows (the failure record for that very
        kill), and appending onto a partial line would glue two records
        into one unparseable line, silently discarding every later row
        at the next load. Only called once the child is dead, so there
        is no live writer to race.
        """
        self._fh.flush()
        seen = self._fh.tell()
        added = 0
        with open(self.path, "rb") as f:
            f.seek(seen)
            raw = f.read()
        consumed = 0
        for line in raw.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break
            try:
                rec = json.loads(line)
            except ValueError:
                break
            if not (isinstance(rec, dict) and isinstance(rec.get("unit"),
                                                         str)):
                break
            if rec.get("failed"):
                u = rec["unit"]
                self._fail_counts[u] = self._fail_counts.get(u, 0) + 1
            elif rec.get("row") is not None:
                self._rows.setdefault(rec["unit"], {})[str(rec["row"])] = rec
            else:
                self._replay.append(rec)
                added += 1
            consumed += len(line)
        seen += consumed
        if consumed < len(raw):  # torn/unparseable tail: cut it off
            self._fh.truncate(seen)
        # Keep our append handle pointed past what we just absorbed, so a
        # later record()/record_failure() lands after the child's rows
        # (O_APPEND writes at EOF regardless — this only keeps tell()
        # honest for the next reload).
        self._fh.seek(seen)
        return added

    def take(self, unit: str) -> dict | None:
        """The recorded entry for `unit` regardless of replay position.

        For EMIT-ONLY consumers — the isolate supervisor re-emits
        entries by name and restores no RNG state, so replay order is
        not a correctness surface for it the way it is for ``skip()``.
        Out-of-order completion is routine there: a quarantine-released
        (or failed-then-retried) unit completes AFTER its successors,
        and the strict-order ``skip()`` would distrust and truncate a
        perfectly attributable tail. In-process resume (harness.bench
        without --isolate) MUST keep using ``skip()``: it restores the
        shared RNG stream, where order is the whole contract.
        """
        for i, entry in enumerate(self._replay):
            if entry.get("unit") == unit:
                self._resumed += 1
                return self._replay.pop(i)
        return None

    def skip(self, unit: str) -> dict | None:
        """The recorded entry for `unit` iff it is next in replay order."""
        if not self._replay:
            return None
        if self._replay[0].get("unit") != unit:
            # Order mismatch: the stored tail cannot be mapped onto this
            # run's remaining units. Re-run them (correctness over thrift)
            # and drop the stale records so re-recorded entries don't
            # duplicate them.
            self._replay = []
            self._truncate_to_consumed()
            return None
        self._resumed += 1
        return self._replay.pop(0)

    def _truncate_to_consumed(self) -> None:
        """Rewrite the file as header + already-consumed entries. Only
        reached on the defensive order-mismatch path; everything still in
        self._replay is stale. Rebuild from scratch: cheapest correct
        move for a path that should never execute."""
        self._fh.close()
        with open(self.path, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        self._fh = open(self.path, "wb")
        consumed = 0
        for i, line in enumerate(lines):
            if i == 0:  # header
                self._fh.write(line)
                continue
            if consumed >= self._resumed:
                break
            self._fh.write(line)
            try:
                rec = json.loads(line)
            except ValueError:
                break
            # Failure and worker-row records ride along, uncounted: only
            # completed-unit records were consumed via skip().
            if not rec.get("failed") and rec.get("row") is None:
                consumed += 1
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def rows(self, unit: str) -> dict[str, dict]:
        """`unit`'s recorded worker-row checkpoints (row-key -> record),
        for replay inside the unit's re-run. Meaningful only while the
        unit is incomplete — a completed unit's replay supersedes them."""
        return dict(self._rows.get(unit, {}))

    def record_row(self, unit: str, row: str, lines: list[str],
                   rng_state=None) -> None:
        """Append one completed worker row of a still-running unit
        (fsync'd — the whole point is surviving the unit's SIGKILL)."""
        self._rows.setdefault(unit, {})[str(row)] = rec = {
            "unit": unit, "row": str(row), "lines": list(lines),
            "rng_state": rng_state}
        self._append(rec)

    def record(self, unit: str, lines: list[str], rng_state=None,
               degraded=()) -> None:
        """Append one completed unit (flushed + fsync'd before return)."""
        self._append({"unit": unit, "lines": list(lines),
                      "rng_state": rng_state, "degraded": list(degraded)})

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass


def clear_failures(path: str, units: list[str]) -> dict[str, int]:
    """Drop the named units' failure rows from the journal at ``path``
    (the quarantine-release edit behind ``harness.bench --unquarantine``).

    Returns unit -> number of failure rows removed (0 entries included,
    so a typo'd unit name is visible to the caller). Works on any
    parseable journal regardless of config hash — releasing a unit is a
    ledger edit, not a replay, so it must not depend on reproducing the
    exact sweep config that quarantined it. Every non-failure line
    (header, completed units, worker rows, OTHER units' failures) is
    preserved byte-for-byte; the rewrite goes through a temp file +
    rename so a kill mid-edit leaves the original intact.
    """
    cleared = {u: 0 for u in units}
    targets = set(units)
    try:
        with open(path, "rb") as f:
            lines = f.read().splitlines(keepends=True)
    except OSError:
        return cleared
    kept = []
    for i, line in enumerate(lines):
        drop = False
        if i > 0 and line.endswith(b"\n"):
            try:
                rec = json.loads(line)
            except ValueError:
                rec = None
            if (isinstance(rec, dict) and rec.get("failed")
                    and rec.get("unit") in targets):
                cleared[rec["unit"]] += 1
                drop = True
        if not drop:
            kept.append(line)
    if any(cleared.values()):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(b"".join(kept))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    return cleared
