"""The port's cost model (``our_tree_tpu_torch.obs.costmodel``, the analytic
half) against the JAX package's (``our_tree_tpu.obs.costmodel``): the same
bytes and operations per dispatch as the JAX device engines, and the same
``cost`` join over the same counters. Integer counts: the tolerance is
zero."""

import pytest

from our_tree_tpu.obs import costmodel as jcost
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.obs import costmodel, trace
from our_tree_tpu_torch.serve import batcher

LADDER = batcher.bucket_ladder(batcher.DEFAULT_MIN_BLOCKS, batcher.DEFAULT_MAX_BLOCKS)
FIELDS = ("mode", "rung", "nr", "key_slots", "bytes_in", "bytes_out", "hbm_bytes", "ops")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("OT_COST_XLA", "0")
    costmodel.reset_for_tests()
    jcost.reset_for_tests()
    yield
    costmodel.reset_for_tests()
    jcost.reset_for_tests()


@pytest.mark.parametrize("key_slots", [1, 8])
@pytest.mark.parametrize("nr", [10, 12, 14])
def test_analytic_cost_matches_jax_device_engine(nr, key_slots):
    for rung in LADDER:
        got = costmodel.analytic_cost(aes.CUDA_ENGINE, "ctr", rung, nr, key_slots)
        want = jcost.analytic_cost("pallas-dense-bp", "ctr", rung, nr, key_slots)
        assert {f: got[f] for f in FIELDS} == {f: want[f] for f in FIELDS}
        assert got["engine"] == got["exec_engine"] == aes.CUDA_ENGINE
        # 52 bytes per block plus the schedule stack.
        assert got["hbm_bytes"] == 52 * rung + key_slots * 4 * (nr + 1) * 4


def test_other_modes_raise():
    for mode in ("cbc", "gcm", "gcm-open", "rc4"):
        with pytest.raises(ValueError, match="not served by the port"):
            costmodel.analytic_cost(aes.CUDA_ENGINE, mode, 32, 10, 8)


def test_ladder_costs_match_jax_ladder():
    got = costmodel.ladder_costs(aes.CUDA_ENGINE, ("ctr",), LADDER, key_bits=(128, 256),
                                 key_slots=8)
    want = jcost.ladder_costs("pallas-dense-bp", ("ctr",), LADDER, key_bits=(128, 256),
                              key_slots=8)
    assert [{f: r[f] for f in FIELDS} for r in got] == [{f: r[f] for f in FIELDS} for r in want]
    assert all(r["source"] == "analytic" and r["xla"] is None for r in got)
    # Memoized: a second ladder returns the same record objects.
    again = costmodel.ladder_costs(aes.CUDA_ENGINE, ("ctr",), LADDER, key_bits=(128, 256))
    assert all(a is b for a, b in zip(got, again))


def _counters(engine):
    """Synthetic registry counters: three dispatched rungs at nr 10, one at
    nr 14, one dispatched rung without card time, noise series."""
    c = {}
    for rung, disp, dev_us, nr in ((32, 5, 250, 10), (256, 3, 900, 10), (4096, 2, 4000, 10),
                                   (4096, 1, 2100, 14), (64, 4, 0, 10)):
        labels = f"engine={engine},mode=ctr,nr={nr},rung={rung}"
        c[f"serve_rung_dispatches{{{labels}}}"] = float(disp)
        c[f"serve_rung_device_us{{{labels}}}"] = float(dev_us)
    c["serve_device_us{lane=0}"] = 7250.0
    c["serve_rung_dispatches{engine=x,mode=ctr,nr=bad,rung=32}"] = 9.0
    c["serve_requests"] = 100.0
    return c


@pytest.mark.parametrize("ceiling", [None, 123.5])
def test_cost_section_and_series_match_jax(ceiling):
    engine = aes.CUDA_ENGINE
    counters = _counters(engine)
    for name in ("serve_rung_dispatches", "serve_rung_device_us"):
        assert costmodel.series_by_key(counters, name) == jcost.series_by_key(counters, name)
    recs = costmodel.ladder_costs(engine, ("ctr",), LADDER, key_bits=(128, 256), key_slots=8)
    jrecs = [dict(r, engine=engine, exec_engine=engine) for r in jcost.ladder_costs(
        "pallas-dense-bp", ("ctr",), LADDER, key_bits=(128, 256), key_slots=8)]
    got = costmodel.cost_section(recs, counters, ceiling_gbps=ceiling)
    want = jcost.cost_section(jrecs, counters, ceiling_gbps=ceiling)
    assert got["rows"] == want["rows"]
    assert got["per_engine"] == want["per_engine"]
    assert got["ceiling_gbps"] == ceiling
    # Every warmed record has a row; idle rungs show zero dispatches.
    assert len(got["rows"]) == 2 * len(LADDER)
    assert sum(r["dispatches"] for r in got["rows"]) == 15
    assert any(r["dispatches"] == 0 and r["utilization"] is None for r in got["rows"])


def test_run_records_round_trip(monkeypatch, tmp_path):
    monkeypatch.setenv("OT_TRACE_DIR", str(tmp_path))
    monkeypatch.delenv("OT_TRACE_RUN", raising=False)
    recs = costmodel.ladder_costs(aes.CUDA_ENGINE, ("ctr",), LADDER)
    path = costmodel.write_run_records(recs, aes.CUDA_ENGINE, ceiling_gbps=42.0)
    assert path is not None and path.startswith(trace.run_dir())
    # A second process's identical ladder deduplicates.
    costmodel.write_run_records(recs, aes.CUDA_ENGINE, ceiling_gbps=42.0)
    loaded, ceiling = costmodel.load_run_records(trace.run_dir())
    assert ceiling == 42.0
    assert [r["hbm_bytes"] for r in loaded] == [r["hbm_bytes"] for r in recs]
    jloaded, jceiling = jcost.load_run_records(trace.run_dir())
    assert jloaded == loaded and jceiling == ceiling
    monkeypatch.delenv("OT_TRACE_DIR")
    assert costmodel.write_run_records(recs, aes.CUDA_ENGINE) is None
