"""The persisted, per-device engine ranking.

Copy of ``our_tree_tpu.utils.ranking`` without the kernel knobs. The bench's
probe stage (``python -m our_tree_tpu_torch.bench`` with
``OT_BENCH_ENGINE=probe``) measures each engine of ``probe_order`` on the
card and stores its GB/s ranking in a small JSON file
(``results/engine_ranking_torch.json``, overridden by ``OT_ENGINE_RANKING``);
every later run reads it back: the next probe's order and
``models.aes.resolve_engine("auto")``. A device with no measurement gets the
static ``DEFAULT_ORDER``.

Schema (one entry per device key, ``device_key()``: ``cuda:<card name>`` or
``cpu``, so a ranking never crosses card models). ``dropped`` lists engines
persisted as broken on this device (``drop_engines()``; excluded from
``probe_order()`` until a later store measures them again)::

    {"cuda:NVIDIA H100 80GB HBM3": {"ranking": [{"engine": "cuda", "gbps": 50.1},
                                                {"engine": "ttable", "gbps": 1.2}],
                                    "source": "bench-probe", "bytes": 268435456,
                                    "dropped": ["..."], "drop_reasons": {"...": "..."},
                                    "recorded_at": "2026-10-18T12:00:00"}}

The reference also stores tuned tile/MC knobs beside the ranking; they
belong to its grouped and dense kernel layouts, which the port does not
have, so this copy has none.

Stdlib-only, so that a caller can load it as a bare file (``importlib`` by
path) without importing the package. Writes are advisory: an unwritable
path stores nothing and the readers fall back to the static order.
"""

from __future__ import annotations

import json
import os
import time

#: Static fallback order: the CUDA kernels, then the T-table oracle. The
#: plain engine ``bitslice`` is never probed (``probe_order``).
DEFAULT_ORDER = ("cuda", "ttable")

#: The engine no probe measures: the kernels' plain version, which the card
#: never runs on the main path.
PLAIN_ENGINE = "bitslice"


def device_key(platform: str, device_kind: str | None = None) -> str:
    """Ranking key for a device: ``"cuda:NVIDIA H100 80GB HBM3"``; the bare
    platform when the kind is unknown or names the platform itself
    (``"cpu"``). Keyed by the card's name, so a ranking measured on one
    model never feeds ``resolve_engine("auto")`` on another."""
    kind = (device_kind or "").strip()
    if not kind or kind == platform:
        return platform
    return f"{platform}:{kind}"


_DEFAULT_PATH = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    "results", "engine_ranking_torch.json"))


def path() -> str:
    return os.environ.get("OT_ENGINE_RANKING", _DEFAULT_PATH)


#: path -> ((mtime_ns, size), parsed dict): ``resolve_engine("auto")`` reads
#: through this on every call, so an unchanged file is parsed once.
_CACHE: dict = {}


def _load_all() -> dict:
    p = path()
    try:
        st = os.stat(p)
    except OSError:
        return {}
    key = (st.st_mtime_ns, st.st_size)
    cached = _CACHE.get(p)
    if cached is not None and cached[0] == key:
        return cached[1]
    try:
        with open(p) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    if not isinstance(data, dict):
        data = {}
    _CACHE[p] = (key, data)
    return data


def load(platform: str) -> dict | None:
    """The stored entry for a device key, or None if absent or malformed
    (a gbps that is not a number, bool excluded, makes the entry malformed:
    a foreign file falls back to the defaults and never crashes a sort)."""
    entry = _load_all().get(platform)
    if not isinstance(entry, dict):
        return None
    rk = entry.get("ranking")
    if not isinstance(rk, list) or not rk or not all(
            isinstance(r, dict) and isinstance(r.get("engine"), str)
            and isinstance(r.get("gbps", 0.0), (int, float))
            and not isinstance(r.get("gbps", 0.0), bool)
            for r in rk):
        return None
    return entry


def order(platform: str) -> list[str] | None:
    """Engine names best-first from the stored ranking, or None."""
    entry = load(platform)
    if entry is None:
        return None
    return [r["engine"] for r in sorted(entry["ranking"], key=lambda r: -float(r.get("gbps", 0.0)))]


def dropped(platform: str) -> set:
    """Engines persisted as broken for this device key, read from the raw
    entry (a drop record beside an empty ranking still counts)."""
    entry = _load_all().get(platform)
    if not isinstance(entry, dict) or not isinstance(entry.get("dropped"), list):
        return set()
    return {e for e in entry["dropped"] if isinstance(e, str)}


def drop_reason(platform: str, engine: str) -> str | None:
    """Why ``engine`` was dropped for this device key, if the file says."""
    entry = _load_all().get(platform)
    reasons = entry.get("drop_reasons") if isinstance(entry, dict) else None
    if isinstance(reasons, dict) and isinstance(reasons.get(engine), str):
        return reasons[engine]
    return None


def probe_order(platform: str, available) -> list[str]:
    """The full probe order: the stored measurement first, the static
    defaults after it, then any other available engine alphabetically.
    ``bitslice``, the plain version, is never in it; names in a stale file
    that are not available are skipped, and dropped engines are excluded
    everywhere, the default backfill included."""
    bad = dropped(platform)
    out = [e for e in (order(platform) or [])
           if e in available and e != PLAIN_ENGINE and e not in bad]
    out += [e for e in DEFAULT_ORDER if e in available and e not in out and e not in bad]
    out += sorted(e for e in available if e != PLAIN_ENGINE and e not in out and e not in bad)
    return out


def store(platform: str, gbps_by_engine: dict, source: str, nbytes: int, drop=()) -> bool:
    """Persist a measured {engine: GB/s} ranking for a device key.

    A ranking of fewer than two engines is not stored (one number is not an
    order, and it would overwrite a real one). The store merges: engines
    ranked before and absent now keep their numbers, re-measured ones
    update, and ``drop`` names engines to remove whatever the merge would
    keep (the reference's probe passes its digest dissenters; the port's
    probe fails on a dissent and passes none). A stored drop record survives,
    less the engines this measurement ran. Atomic (a temporary file and a
    rename). Returns True iff the file was written."""
    real = {e: float(g) for e, g in gbps_by_engine.items() if g > 0.0}
    if len(real) < 2:
        return False
    # A shallow copy: _load_all() returns the cached dict, and a failed write
    # must not leave a never-persisted entry visible to later readers.
    data = dict(_load_all())
    prev = data.get(platform)
    merged = dict(real)
    if isinstance(prev, dict) and isinstance(prev.get("ranking"), list):
        for r in prev["ranking"]:
            if (isinstance(r, dict) and isinstance(r.get("engine"), str)
                    and r["engine"] not in merged):
                try:
                    merged[r["engine"]] = float(r.get("gbps", 0.0))
                except (TypeError, ValueError):
                    pass
    for e in drop:
        merged.pop(e, None)
    entry = {
        "ranking": [{"engine": e, "gbps": round(g, 4)}
                    for e, g in sorted(merged.items(), key=lambda kv: -kv[1])],
        "source": source,
        "bytes": int(nbytes),
        "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    prev_dropped = set()
    if isinstance(prev, dict) and isinstance(prev.get("dropped"), list):
        prev_dropped = {e for e in prev["dropped"] if isinstance(e, str)}
    still_dropped = prev_dropped - set(real)
    if still_dropped:
        entry["dropped"] = sorted(still_dropped)
        if isinstance(prev.get("drop_reasons"), dict):
            reasons = {e: r for e, r in prev["drop_reasons"].items() if e in still_dropped}
            if reasons:
                entry["drop_reasons"] = reasons
    data[platform] = entry
    return _write_all(data)


def drop_engines(platform: str, engines, reason: str | None = None) -> bool:
    """Persist ``engines`` as broken for a device key: removed from the
    stored ranking (below the two-engine floor too) and kept out of
    ``probe_order``, with ``reason`` recorded per engine in
    ``drop_reasons``. Works without a prior entry. A later ``store`` that
    measures the engine clears the drop and its reason. Returns True iff
    the file changed."""
    data = dict(_load_all())
    entry = data.get(platform)
    if not isinstance(entry, dict):
        entry = {"ranking": []}
    ranking_list = entry.get("ranking")
    if not isinstance(ranking_list, list):
        ranking_list = []
    bad = {e for e in engines if isinstance(e, str)}
    kept = [r for r in ranking_list if not (isinstance(r, dict) and r.get("engine") in bad)]
    prev_dropped = ({e for e in entry.get("dropped", []) if isinstance(e, str)}
                    if isinstance(entry.get("dropped"), list) else set())
    new_dropped = prev_dropped | bad
    prev_reasons = (dict(entry["drop_reasons"])
                    if isinstance(entry.get("drop_reasons"), dict) else {})
    reasons = dict(prev_reasons)
    if reason:
        reasons.update({e: str(reason) for e in bad})
    reasons = {e: r for e, r in reasons.items() if e in new_dropped}
    if len(kept) == len(ranking_list) and new_dropped == prev_dropped and reasons == prev_reasons:
        return False
    new_entry = {**entry, "ranking": kept, "dropped": sorted(new_dropped),
                 "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if reasons:
        new_entry["drop_reasons"] = reasons
    else:
        new_entry.pop("drop_reasons", None)
    data[platform] = new_entry
    return _write_all(data)


def _write_all(data: dict) -> bool:
    p = path()
    tmp = f"{p}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, p)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    _CACHE.pop(p, None)
    return True
