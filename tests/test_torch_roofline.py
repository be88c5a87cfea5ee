"""The serve bench's roofline sections on the CPU (``--ceiling-gbps``,
``--profile-window``): a ``# cost:`` row for every warmed rung whose modeled
bytes equal the JAX server's records for the same ladder, the ``device``
section's utilization, and a ``profile`` section whose stack-tier summary
validates and whose cross-check covers the window's dispatches."""

import json

import pytest

from our_tree_tpu.obs import costmodel as jcost
from our_tree_tpu_torch.obs import costmodel, metrics, profiler
from our_tree_tpu_torch.serve import batcher
from our_tree_tpu_torch.serve import bench as serve_bench

ARGS = ["--device", "cpu", "--requests", "60", "--concurrency", "8",
        "--sizes", "16,256,1024,4096", "--bucket-max", "256"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("OT_COST_XLA", "0")
    monkeypatch.delenv("OT_TRACE_DIR", raising=False)
    monkeypatch.delenv("OT_TRACE_RUN", raising=False)
    monkeypatch.delenv("OT_PROFILE_TIER", raising=False)
    monkeypatch.delenv("OT_DISPATCH_DEADLINE", raising=False)
    profiler.reset_for_tests()
    costmodel.reset_for_tests()
    jcost.reset_for_tests()
    yield
    profiler.reset_for_tests()
    metrics.reset()


def test_bench_roofline_sections_on_cpu(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("OT_TRACE_DIR", str(tmp_path / "trace"))
    art = tmp_path / "serve.json"
    rc = serve_bench.main(ARGS + ["--ceiling-gbps", "1.0", "--profile-window", "0:0.5",
                                  "--artifact", str(art)])
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    assert rc == 0, captured.err
    assert "# profile-window: armed 0.5s (tier=stack)" in captured.err
    line = json.loads(out[-1])
    rungs = list(batcher.bucket_ladder(32, 256))
    # One cost row per warmed rung, printed and in the line.
    cost_lines = [o for o in out if o.startswith("# cost: ")]
    assert [int(o.split(" r", 1)[1].split()[0]) for o in cost_lines] == rungs
    rows = line["cost"]["rows"]
    assert [r["rung"] for r in rows] == rungs and line["cost"]["ceiling_gbps"] == 1.0
    want = jcost.ladder_costs("jnp", ("ctr",), rungs, key_bits=(128,), key_slots=8)
    assert [r["modeled_dispatch_bytes"] for r in rows] == [w["hbm_bytes"] for w in want]
    assert sum(r["dispatches"] for r in rows) == line["batches"]["batches"]
    assert all(r["utilization"] == pytest.approx(r["achieved_gbps"], abs=1e-6)
               for r in rows if r["dispatches"])
    # The device section's ceiling and utilization.
    dev = line["device"]
    assert dev["ceiling_gbps"] == 1.0 and dev["utilization"] == round(dev["device_gbps"], 4)
    # The profile section: a valid stack-tier summary and its cross-check.
    prof = line["profile"]
    cap = prof["capture"]
    assert profiler.validate_summary(cap) == []
    assert cap["tier"] == "stack" and cap["armed_by"] == "cli"
    assert [(r["rung"], r["dispatches"]) for r in prof["crosscheck"]["rows"]] == \
        [(r["rung"], r["dispatches"]) for r in cap["rungs"]]
    assert all(r["modeled_dispatch_bytes"] == 52 * r["rung"] + 8 * 44 * 4
               for r in prof["crosscheck"]["rows"])
    assert any(o.startswith("# profile: tier=stack") for o in out)
    doc = json.loads(art.read_text())
    assert doc["cost"]["rows"] == rows and doc["profile"]["capture"]["seq"] == cap["seq"]
    assert doc["config"]["ceiling_gbps"] == 1.0 and doc["config"]["profile_window"] == [0.0, 0.5]
    # The run layout holds the records and the summary.
    recs, ceiling = costmodel.load_run_records(str(tmp_path / "trace" / cap["run"]))
    assert ceiling == 1.0 and [r["rung"] for r in recs] == rungs


def test_bench_without_trace_dir_reports_window_not_armed(capsys):
    rc = serve_bench.main(ARGS + ["--profile-window", "0:0.2"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "# profile-window: not armed: profiling needs the run layout" in captured.err
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["profile"] is None
    assert line["device"]["ceiling_gbps"] is None and line["device"]["utilization"] is None
    assert all(r["utilization"] is None for r in line["cost"]["rows"])


def test_bench_rejects_a_malformed_window():
    with pytest.raises(SystemExit):
        serve_bench.parse_args(["--device", "cpu", "--profile-window", "soon"])
    assert serve_bench.parse_args(["--profile-window", "1:2"]).profile_window == (1.0, 2.0)
