"""Static dispatch cost records: modeled HBM traffic and operation counts.

Copy of the analytic half of ``our_tree_tpu.obs.costmodel``. The serve
stack measures time per rung (``serve_rung_dispatches`` and
``serve_rung_device_us``, ``serve/lanes.py``); this module says what one
dispatch at (engine, mode, rung, nr) should move across the HBM boundary,
so that a served number becomes achieved GB/s moved and a utilization of
the measured ceiling (``ServerConfig.ceiling_gbps``; the card's is measured
by ``harness/ceiling.py`` and ``chip_smoke.py``).

Per rung ``N`` (16-byte blocks), ``K`` key slots and ``nr`` rounds, the
port's ``ctr`` dispatch (``cuda_aes.ctr_scattered_multikey``) reads the
payload, the counter words, the (K, 4(nr+1)) schedule stack and the (N,)
slot vector, and writes the payload: 52 bytes per block plus 16 K (nr + 1)
bytes of schedules, what the JAX package's device engines move. The op
count is the reference's order-of-magnitude budget (blocks x rounds x 32
word operations), not the kernel's count. Only ``ctr`` is served by the
port; another mode raises until the slice that serves it.

Not carried: the XLA half (``jit(...).lower().compile()`` cost and memory
analyses; PyTorch has no counterpart) and with it ``OT_COST_XLA``, so every
record's ``source`` is ``"analytic"`` and its ``xla`` is ``None``; the
incident recorder's copy of the records (``obs/incident.py`` is not ported).

Records are memoized per process and stamped into the ``OT_TRACE_DIR`` run
layout as ``cost-<pid>-<tok>.json`` (``write_run_records``), and the bench
joins them with the per-rung counters (``cost_section``). Module-level
imports are stdlib only.
"""

from __future__ import annotations

import glob
import json
import os
import re
import uuid

KIND = "ot-cost"
VERSION = 1

#: Order-of-magnitude word operations per block per AES round (the
#: reference's budget: 16 gathers + 12 combining XORs + 4 round-key XORs).
OPS_PER_BLOCK_ROUND = 32
#: The modes the port serves.
MODES = ("ctr",)

#: (engine, mode, rung, nr, key_slots) -> record, shared by every server of
#: the process.
_CACHE: dict[tuple, dict] = {}


def analytic_cost(engine: str, mode: str, rung: int, nr: int, key_slots: int) -> dict:
    """The per-dispatch record (the module docstring has the formula).
    Bytes are boundary traffic: what one dispatch reads and writes."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not served by the port yet: cbc and gcm come "
                         "with the AEAD serve slice, rc4 with the stream-cipher slice")
    n = int(rung)
    k = int(key_slots)
    blk = 16 * n
    sched = k * 4 * (int(nr) + 1) * 4
    bytes_in = blk + blk + sched + 4 * n
    bytes_out = blk
    return {
        "engine": engine, "exec_engine": engine, "mode": mode,
        "rung": n, "nr": int(nr), "key_slots": k,
        "bytes_in": bytes_in, "bytes_out": bytes_out,
        "hbm_bytes": bytes_in + bytes_out,
        "ops": n * int(nr) * OPS_PER_BLOCK_ROUND,
    }


def cost_record(engine: str, mode: str, rung: int, nr: int, key_slots: int) -> dict:
    """One memoized record."""
    key = (engine, mode, int(rung), int(nr), int(key_slots))
    rec = _CACHE.get(key)
    if rec is None:
        rec = analytic_cost(engine, mode, rung, nr, key_slots)
        rec["xla"] = None
        rec["source"] = "analytic"
        _CACHE[key] = rec
    return rec


def ladder_costs(engine: str, modes, rungs, key_bits=(128,), key_slots: int = 8) -> list[dict]:
    """Every (mode, rung, nr) record of one server's warmed ladder."""
    from ..ops.keyschedule import ROUNDS

    return [cost_record(engine, mode, int(rung), ROUNDS[int(bits)], key_slots)
            for bits in key_bits for mode in modes for rung in rungs]


# ---------------------------------------------------------------------------
# The run-dir stamp.
# ---------------------------------------------------------------------------


def write_run_records(records, engine: str, ceiling_gbps: float | None = None) -> str | None:
    """Stamp the records into the ``OT_TRACE_DIR`` run layout as
    ``cost-<pid>-<tok>.json``. Never raises; None when tracing is off or the
    write fails (the in-memory records still serve the bench)."""
    try:
        from . import trace

        if not trace.enabled():
            return None
        run = trace.ensure_run()
        d = trace.run_dir()
        if d is None:
            return None
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"cost-{os.getpid()}-{uuid.uuid4().hex[:8]}.json")
        doc = {"kind": KIND, "v": VERSION, "run": run, "pid": os.getpid(), "engine": engine,
               "ceiling_gbps": ceiling_gbps, "records": list(records)}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, separators=(",", ":"), sort_keys=True)
            fh.write("\n")
        return path
    except Exception:  # noqa: BLE001 - never-raises discipline
        return None


def load_run_records(run_dir: str) -> tuple[list[dict], float | None]:
    """(deduplicated records, ceiling) from every ``cost-*.json`` in a run
    dir; identical ladders dedupe on (engine, mode, rung, nr), unparseable
    files are skipped."""
    records: list[dict] = []
    seen: set[tuple] = set()
    ceiling = None
    for path in sorted(glob.glob(os.path.join(run_dir, "cost-*.json"))):
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict) or doc.get("kind") != KIND:
            continue
        if ceiling is None and doc.get("ceiling_gbps"):
            ceiling = float(doc["ceiling_gbps"])
        for rec in doc.get("records", []):
            if not isinstance(rec, dict):
                continue
            key = (rec.get("engine"), rec.get("mode"), rec.get("rung"), rec.get("nr"))
            if key in seen:
                continue
            seen.add(key)
            records.append(rec)
    return records, ceiling


# ---------------------------------------------------------------------------
# The roofline join: records x measured per-rung dispatch counters.
# ---------------------------------------------------------------------------


_FLAT_RE = re.compile(r"^([A-Za-z0-9_]+)\{(.*)\}$")


def series_by_key(counters: dict, name: str) -> dict[tuple, float]:
    """{(engine, mode, rung, nr): total} of one flat-keyed counter
    (``name{k=v,...}``, the ``obs/metrics.py`` snapshot's keys); the
    profiler's window deltas parse the same series."""
    out: dict[tuple, float] = {}
    for key, v in counters.items():
        m = _FLAT_RE.match(key)
        if not m or m.group(1) != name:
            continue
        labels = dict(p.split("=", 1) for p in m.group(2).split(",") if "=" in p)
        try:
            k = (labels.get("engine", "?"), labels.get("mode", "ctr"),
                 int(labels.get("rung", 0)), int(labels.get("nr", 0)))
        except ValueError:
            continue
        out[k] = out.get(k, 0.0) + float(v)
    return out


def cost_section(records, counters: dict, ceiling_gbps: float | None = None) -> dict:
    """The bench's ``cost`` join: per (engine, mode, rung, nr), modeled bytes
    per dispatch x measured dispatches over the rung's accumulated card time
    -> achieved GB/s moved, and utilization of ``ceiling_gbps``. Every warmed
    record gets a row; a rung the traffic never reached shows
    ``dispatches=0``. ``per_engine`` aggregates the dispatched rows."""
    disp = series_by_key(counters, "serve_rung_dispatches")
    dev = series_by_key(counters, "serve_rung_device_us")
    rows = []
    seen: set[tuple] = set()
    per_engine: dict[str, dict] = {}
    for rec in records:
        # nr is part of the join: a 128- and a 256-bit ladder at one rung
        # are different records.
        key = (rec.get("engine", "?"), rec.get("mode", "ctr"), int(rec.get("rung", 0)),
               int(rec.get("nr", 0)))
        if key in seen:
            continue
        seen.add(key)
        d = disp.get(key, 0.0)
        if d <= 0:
            rows.append({"engine": key[0], "mode": key[1], "rung": key[2], "nr": key[3],
                         "dispatches": 0, "modeled_dispatch_bytes": int(rec["hbm_bytes"]),
                         "modeled_bytes": 0, "device_s": 0.0, "achieved_gbps": 0.0,
                         "utilization": None})
            continue
        dus = dev.get(key, 0.0)
        moved = float(rec["hbm_bytes"]) * d
        gbps = (moved / 1e9 / (dus / 1e6)) if dus > 0 else 0.0
        rows.append({"engine": key[0], "mode": key[1], "rung": key[2], "nr": key[3],
                     "dispatches": int(d), "modeled_dispatch_bytes": int(rec["hbm_bytes"]),
                     "modeled_bytes": int(moved), "device_s": round(dus / 1e6, 6),
                     "achieved_gbps": round(gbps, 6),
                     "utilization": round(gbps / ceiling_gbps, 6) if ceiling_gbps else None})
        agg = per_engine.setdefault(key[0], {"modeled_bytes": 0, "device_s": 0.0})
        agg["modeled_bytes"] += int(moved)
        agg["device_s"] += dus / 1e6
    for agg in per_engine.values():
        gbps = agg["modeled_bytes"] / 1e9 / agg["device_s"] if agg["device_s"] > 0 else 0.0
        agg["device_s"] = round(agg["device_s"], 6)
        agg["achieved_gbps"] = round(gbps, 6)
        agg["utilization"] = round(gbps / ceiling_gbps, 6) if ceiling_gbps else None
    rows.sort(key=lambda r: (r["engine"], r["mode"], r["rung"], r["nr"]))
    return {"ceiling_gbps": ceiling_gbps, "records": list(records), "rows": rows,
            "per_engine": per_engine}


def reset_for_tests() -> None:
    _CACHE.clear()
