"""The port's engine ranking (``our_tree_tpu_torch.utils.ranking``) held
against the JAX package's: the reference's cases that apply to a copy
without knobs, a file written by either module read by the other, the
probe order without the plain engine, the ``auto`` walk on a CUDA device as
a function of the ranking, and the bench's probe stage over a fake
measurement."""

import importlib.util
import json
import os
import pathlib

import pytest
import torch

from our_tree_tpu.utils import ranking as jranking
from our_tree_tpu_torch import bench
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.utils import ranking

ROOT = pathlib.Path(__file__).resolve().parent.parent
CARD = "cuda:NVIDIA H100 80GB HBM3"


@pytest.fixture
def rank_file(tmp_path, monkeypatch):
    p = tmp_path / "engine_ranking.json"
    monkeypatch.setenv("OT_ENGINE_RANKING", str(p))
    return p


def test_store_then_order_round_trip(rank_file):
    assert ranking.store("cuda", {"cuda": 50.0, "ttable": 1.5, "x": 0.2}, "test", 1 << 20)
    assert ranking.order("cuda") == ["cuda", "ttable", "x"]
    entry = ranking.load("cuda")
    assert entry["source"] == "test" and entry["bytes"] == 1 << 20


def test_order_none_when_absent(rank_file):
    assert ranking.order("cuda") is None and ranking.load("cuda") is None


def test_store_rejects_single_engine(rank_file):
    assert ranking.store("cuda", {"cuda": 50.0, "ttable": 0.0}, "test", 1) is False
    assert not rank_file.exists()


def test_store_merges_unmeasured_engines(rank_file):
    ranking.store("cuda", {"a": 5.0, "b": 3.0, "c": 1.0}, "full", 1)
    ranking.store("cuda", {"a": 4.0, "b": 6.0}, "truncated", 1)
    entry = ranking.load("cuda")
    assert {r["engine"]: r["gbps"] for r in entry["ranking"]} == {"a": 4.0, "b": 6.0, "c": 1.0}
    assert ranking.order("cuda") == ["b", "a", "c"] and entry["source"] == "truncated"


def test_store_drop_removes_previous_entries(rank_file):
    ranking.store("cuda", {"a": 5.0, "b": 3.0, "c": 1.0}, "full", 1)
    ranking.store("cuda", {"b": 2.0, "d": 4.0}, "probe", 1, drop=["a"])
    assert ranking.order("cuda") == ["d", "b", "c"]


def test_malformed_gbps_degrades_not_crashes(rank_file):
    rank_file.write_text(json.dumps({"cuda": {"ranking": [
        {"engine": "x", "gbps": None}, {"engine": "y", "gbps": 1.0}]}}))
    assert ranking.order("cuda") is None
    assert ranking.probe_order("cuda", {"cuda", "bitslice"}) == ["cuda"]
    rank_file.write_text(json.dumps({"cuda": {"ranking": [{"engine": "x", "gbps": True}]}}))
    assert ranking.load("cuda") is None


def test_store_is_per_device_key(rank_file):
    ranking.store(CARD, {"a": 2.0, "b": 1.0}, "t1", 1)
    ranking.store("cpu", {"b": 2.0, "a": 1.0}, "t2", 1)
    assert ranking.order(CARD) == ["a", "b"] and ranking.order("cpu") == ["b", "a"]
    assert ranking.load(CARD)["source"] == "t1"


def test_corrupt_file_degrades_to_defaults(rank_file):
    rank_file.write_text("{not json")
    assert ranking.order("cuda") is None
    assert ranking.probe_order("cuda", set(aes.CORES)) == ["cuda", "ttable"]


def test_probe_order_measurement_leads_defaults_follow(rank_file):
    ranking.store("cuda", {"ttable": 9.0, "zz": 1.0}, "test", 1)
    avail = {"cuda", "ttable", "bitslice", "zz", "aa-new"}
    assert ranking.probe_order("cuda", avail) == ["ttable", "zz", "cuda", "aa-new"]


def test_probe_order_drops_stale_engine_names(rank_file):
    ranking.store("cuda", {"renamed-away": 9.0, "ttable": 1.0}, "test", 1)
    assert ranking.probe_order("cuda", {"ttable", "bitslice"}) == ["ttable"]


@pytest.mark.parametrize("stored", [None, {"bitslice": 99.0, "ttable": 1.0},
                                    {"bitslice": 99.0, "cuda": 1.0}])
def test_probe_order_never_yields_the_plain_engine(rank_file, stored):
    if stored:
        ranking.store(CARD, stored, "test", 1)
    order = ranking.probe_order(CARD, aes.CORES)
    assert "bitslice" not in order and order[0] in ("cuda", "ttable")
    assert set(order) == {"cuda", "ttable"}
    assert jranking.probe_order(CARD, {"jnp", "bitslice"}) == ["bitslice"]  # the reference's rule


def test_store_writes_valid_json_atomically(rank_file):
    ranking.store("cuda", {"a": 2.0, "b": 1.0}, "test", 64)
    data = json.loads(rank_file.read_text())
    assert data["cuda"]["ranking"][0] == {"engine": "a", "gbps": 2.0}
    assert [f for f in os.listdir(rank_file.parent)
            if f.startswith("engine_ranking.json.tmp")] == []


def test_unwritable_path_is_advisory(tmp_path, monkeypatch):
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    monkeypatch.setenv("OT_ENGINE_RANKING", str(blocker / "x.json"))
    assert ranking.store("cuda", {"a": 2.0, "b": 1.0}, "test", 1) is False


def test_failed_store_leaves_no_phantom_entry(rank_file, monkeypatch):
    ranking.store("cuda", {"a": 2.0, "b": 1.0}, "seed", 1)
    blocker = rank_file.parent / "blocker"
    blocker.write_text("")
    monkeypatch.setenv("OT_ENGINE_RANKING", str(blocker / "x.json"))
    ranking.load("cuda")
    assert ranking.store("cuda", {"x": 9.0, "y": 8.0}, "fail", 1) is False
    assert ranking.order("cuda") is None
    monkeypatch.setenv("OT_ENGINE_RANKING", str(rank_file))
    assert ranking.order("cuda") == ["a", "b"]


def test_device_key_separates_card_models(monkeypatch):
    for mod in (ranking, jranking):
        assert mod.device_key("cpu", "cpu") == "cpu"
        assert mod.device_key("cuda", None) == "cuda"
        assert mod.device_key("cuda", "NVIDIA H100 80GB HBM3") == CARD
    assert aes.rank_key("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert aes.rank_key("cuda") == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(aes, "_CARD_NAMES", {0: "NVIDIA H100 80GB HBM3", 1: "NVIDIA A100"})
    assert aes.rank_key("cuda") == CARD and aes.rank_key("cuda:1") == "cuda:NVIDIA A100"


def test_drop_engines_removes_and_records(rank_file):
    ranking.store("cuda", {"a": 5.0, "b": 3.0}, "probe", 1)
    assert ranking.drop_engines("cuda", ["a"])
    assert ranking.order("cuda") == ["b"] and ranking.load("cuda")["dropped"] == ["a"]
    assert "a" not in ranking.probe_order("cuda", {"a", "b"})
    assert not ranking.drop_engines("cuda", ["a"])


def test_drop_engines_sticks_on_fresh_host(rank_file):
    eng = ranking.DEFAULT_ORDER[0]
    assert ranking.drop_engines("cuda:fresh", [eng])
    assert eng not in ranking.probe_order("cuda:fresh", set(ranking.DEFAULT_ORDER))
    assert not ranking.drop_engines("cuda:fresh", [eng])


def test_drop_reason_persists_and_clears_on_recovery(rank_file):
    ranking.store("cuda", {"a": 5.0, "b": 3.0}, "probe", 1)
    assert ranking.drop_engines("cuda", ["c"], reason="launch failed")
    assert ranking.load("cuda")["drop_reasons"] == {"c": "launch failed"}
    assert ranking.drop_reason("cuda", "c") == "launch failed"
    assert not ranking.drop_engines("cuda", ["c"], reason="launch failed")
    assert ranking.drop_engines("cuda", ["c"], reason="still failing")
    ranking.store("cuda", {"a": 6.0, "c": 2.0}, "probe", 1)
    entry = ranking.load("cuda")
    assert "drop_reasons" not in entry and "dropped" not in entry


def test_drop_reason_kept_for_still_dropped(rank_file):
    ranking.store("cuda", {"a": 5.0, "b": 3.0}, "probe", 1)
    ranking.drop_engines("cuda", ["c"], reason="r-c")
    ranking.drop_engines("cuda", ["d"], reason="r-d")
    ranking.store("cuda", {"a": 6.0, "c": 2.0}, "probe", 1)
    entry = ranking.load("cuda")
    assert entry["dropped"] == ["d"] and entry["drop_reasons"] == {"d": "r-d"}


def test_store_clears_remeasured_drops_keeps_others(rank_file):
    ranking.store("cuda", {"a": 5.0, "b": 3.0}, "probe", 1)
    ranking.drop_engines("cuda", ["c", "d"])
    ranking.store("cuda", {"a": 6.0, "c": 2.0}, "probe", 1)
    assert ranking.dropped("cuda") == {"d"} and "c" in ranking.order("cuda")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_file_written_by_either_package_reads_in_the_other(rank_file, writer):
    w, r = (jranking, ranking) if writer == "jax" else (ranking, jranking)
    assert w.store(CARD, {"cuda": 48.5, "ttable": 0.9}, "probe", 256 << 20)
    assert w.store("cpu", {"b": 2.0, "a": 1.0}, "other", 1)
    assert w.drop_engines(CARD, ["gone"], reason="why")
    for key in (CARD, "cpu"):
        assert r.load(key) == w.load(key)
        assert r.order(key) == w.order(key)
        assert r.dropped(key) == w.dropped(key)
    assert r.probe_order(CARD, {"cuda", "ttable", "gone"}) == ["cuda", "ttable"]
    # The reader's store keeps the writer's other keys as written.
    assert r.store(CARD, {"cuda": 50.0, "ttable": 1.0}, "probe", 1)
    assert w.load("cpu")["source"] == "other" and w.order(CARD) == ["cuda", "ttable"]


def test_module_loads_as_a_bare_file(rank_file):
    spec = importlib.util.spec_from_file_location(
        "bare_ranking", ROOT / "our_tree_tpu_torch" / "utils" / "ranking.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.store("cuda", {"cuda": 2.0, "ttable": 1.0}, "bare", 1)
    assert ranking.order("cuda") == ["cuda", "ttable"]


# -- the auto walk on a CUDA device, a function of the ranking ----------------


def test_auto_is_cuda_on_a_fresh_file(rank_file):
    assert aes.auto_engine(CARD) == aes.CUDA_ENGINE == "cuda"
    assert aes.KERNEL_BACKED == {"cuda"}


def test_auto_is_cuda_even_when_ttable_ranks_first(rank_file):
    ranking.store(CARD, {"ttable": 90.0, "cuda": 1.0}, "probe", 1)
    assert ranking.probe_order(CARD, aes.CORES)[0] == "ttable"
    assert aes.auto_engine(CARD) == "cuda"


def test_auto_raises_when_cuda_is_dropped(rank_file, monkeypatch):
    ranking.store(CARD, {"cuda": 50.0, "ttable": 1.0}, "probe", 1)
    ranking.drop_engines(CARD, ["cuda"], reason="ctr_gen failed to launch")
    with pytest.raises(RuntimeError, match="ctr_gen failed to launch"):
        aes.auto_engine(CARD)
    # resolve_engine on a CUDA device reads the same walk; the CPU keeps the
    # plain version.
    monkeypatch.setattr(aes, "rank_key", lambda dev: CARD)
    with pytest.raises(RuntimeError, match="drops every kernel engine"):
        aes.resolve_engine("auto", "cuda")
    assert aes.resolve_engine("auto", "cpu") == aes.PLAIN_ENGINE
    assert aes.resolve_engine("ttable", "cuda") == "ttable"


# -- the bench's probe stage over a fake measure -------------------------------


def _fake(table, calls=None):
    def measure(eng):
        if calls is not None:
            calls.append(eng)
        v = table[eng]
        if isinstance(v, Exception):
            raise v
        return [v[0] / 2, v[0]], v[1]
    return measure


def test_probe_stage_measures_both_engines_and_stores(rank_file, capsys):
    calls = []
    eng, probes = bench.probe_stage(CARD, _fake({"cuda": (50.0, 7), "ttable": (1.0, 7)}, calls),
                                    "ctr", 256 << 20)
    assert calls == ["cuda", "ttable"] and eng == "cuda"
    assert probes == {"cuda": 50.0, "ttable": 1.0}
    entry = ranking.load(CARD)
    assert [r["engine"] for r in entry["ranking"]] == ["cuda", "ttable"]
    assert entry["bytes"] == 256 << 20 and entry["source"] == "bench-probe"
    assert "ranking persisted" in capsys.readouterr().err


def test_probe_stage_merges_and_keeps_order(rank_file):
    ranking.store(CARD, {"cuda": 40.0, "ttable": 2.0, "old": 0.5}, "probe", 1)
    bench.probe_stage(CARD, _fake({"cuda": (55.0, 1), "ttable": (1.0, 1)}), "ctr", 1)
    assert ranking.order(CARD) == ["cuda", "ttable", "old"]
    # ecb-dec measures but stores nothing: the file feeds encrypt selection.
    bench.probe_stage(CARD, _fake({"cuda": (1.0, 1), "ttable": (9.0, 1)}), "ecb-dec", 1)
    assert ranking.order(CARD) == ["cuda", "ttable", "old"]


def test_probe_stage_kernel_dissent_fails_the_run(rank_file):
    with pytest.raises(RuntimeError, match="digests disagree"):
        bench.probe_stage(CARD, _fake({"cuda": (50.0, 1), "ttable": (1.0, 2)}), "ctr", 1)
    assert not rank_file.exists()


def test_probe_stage_any_dissent_from_the_kernel_engine_fails(rank_file, monkeypatch):
    """A third engine that disagrees with ``cuda`` fails the run too, even
    where it is outvoted: no majority decides for a kernel engine. Where
    ``cuda`` was dropped from the ranking, a dissent among the other
    engines fails the run as well, and an agreeing probe is stored and the
    headline's ``auto`` raises."""
    monkeypatch.setitem(aes.CORES, "zz", aes.CORES["ttable"])
    table = {"cuda": (50.0, 1), "ttable": (1.0, 1), "zz": (90.0, 2)}
    with pytest.raises(RuntimeError, match="zz=0x00000002"):
        bench.probe_stage(CARD, _fake(table), "ctr", 1)
    ranking.drop_engines(CARD, ["cuda"], reason="test")
    table["yy"] = (2.0, 1)
    monkeypatch.setitem(aes.CORES, "yy", aes.CORES["ttable"])
    with pytest.raises(RuntimeError, match="digests disagree"):
        bench.probe_stage(CARD, _fake(table), "ctr", 1)
    assert ranking.order(CARD) is None
    table["zz"] = (90.0, 1)
    with pytest.raises(RuntimeError, match="drops every kernel engine"):
        bench.probe_stage(CARD, _fake(table), "ctr", 1)
    assert ranking.order(CARD) == ["zz", "yy", "ttable"]


def test_probe_stage_cuda_failure_propagates_ttable_failure_is_data(rank_file, capsys):
    with pytest.raises(ValueError, match="launch"):
        bench.probe_stage(CARD, _fake({"cuda": ValueError("launch"), "ttable": (1.0, 1)}),
                          "ctr", 1)
    eng, probes = bench.probe_stage(
        CARD, _fake({"cuda": (50.0, 1), "ttable": MemoryError("gather")}), "ctr", 1)
    assert eng == "cuda" and probes == {"cuda": 50.0}
    assert "probe ttable: failed (MemoryError" in capsys.readouterr().err
    assert not rank_file.exists()  # one engine is not an order


@pytest.mark.parametrize("split", [(1, 2), (2, 1)])
def test_probe_stage_split_never_picks_an_engine(rank_file, split):
    """Whichever digest ``cuda`` holds in a 1-1 split, the run fails and
    stores nothing."""
    table = {"cuda": (50.0, split[0]), "ttable": (1.0, split[1])}
    with pytest.raises(RuntimeError, match="digests disagree"):
        bench.probe_stage(CARD, _fake(table), "ctr", 1)
    assert ranking.order(CARD) is None
