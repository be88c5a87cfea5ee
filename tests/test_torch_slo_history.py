"""The port's SLO gate and perf-history ledger (``our_tree_tpu_torch.obs.slo``,
``obs.history``) against the JAX package's on the same documents: extraction,
tolerance parsing, the comparison's verdict and rendered table, green and
red; the ledger's records, best-ever check and trajectory tables over
artifacts written in ``tmp_path``. Then the port's serve bench with ``--slo``
and the other flags it shares with the JAX bench: a baseline that differs
from the run by orders of magnitude either way gives exit 0 or 1 whatever
the host's speed, and a count the baseline never had is red at any
tolerance."""

import io
import json
import os

import numpy as np
import pytest

from our_tree_tpu.obs import history as jhistory
from our_tree_tpu.obs import slo as jslo
from our_tree_tpu_torch.obs import history, incident, slo
from our_tree_tpu_torch.resilience import degrade
from our_tree_tpu_torch.serve import bench as serve_bench


def _doc(rng, *, p50=10.0, goodput=1.0, errors=None, lost=0, steady=0, alerts=None,
         stages=True, cost=True, modes=("ctr",), sizes=(4096,), engine="cuda", lanes=1):
    doc = {"config": {"modes": list(modes), "sizes": list(sizes), "engine": engine,
                      "lanes": lanes},
           "load": {"p50_ms": p50, "p95_ms": p50 * 2, "p99_ms": p50 * 3,
                    "goodput_gbps": goodput, "errors": errors or {}, "mismatches": 0,
                    "requests": 100},
           "queue": {"lost": lost}, "compiles": {"steady": steady},
           "device": {"utilization": 0.5}}
    if alerts is not None:
        doc["alerts"] = {"total": alerts, "fired": {}}
    if stages:
        doc["stages"] = {s: {"p50_us": float(rng.integers(1, 500)),
                             "p95_us": float(rng.integers(500, 900)), "count": 10}
                         for s in ("backend_queue", "pack", "device")}
    if cost:
        doc["cost"] = {"rows": [{"engine": engine, "mode": "ctr", "rung": r, "nr": 10,
                                 "achieved_gbps": float(rng.random() * 10), "dispatches": d}
                                for r, d in ((32, 4), (64, 0), (128, 9))]}
    return doc


def _slower_stages_and_cost(doc):
    """One stage's p95 tripled and one cost row's GB/s cut to a tenth: each
    gate names its stage and its rung."""
    doc["stages"]["pack"]["p95_us"] *= 3
    doc["cost"]["rows"][2]["achieved_gbps"] /= 10
    return doc


def _cases():
    rng = np.random.default_rng(23)
    base = _doc(rng, alerts=0)
    rng2 = np.random.default_rng(23)
    same = _doc(rng2, alerts=0)
    return {
        "same": (base, same, None),
        "inside_bands": (base, _doc(np.random.default_rng(23), p50=13.0, goodput=0.9, alerts=0),
                         None),
        "latency_and_goodput": (base, _doc(np.random.default_rng(23), p50=200.0, goodput=0.1,
                                           alerts=0), None),
        "counts": (base, _doc(np.random.default_rng(23), errors={"deadline": 2}, lost=1,
                              steady=3, alerts=1), None),
        "stages_and_cost": (base, _slower_stages_and_cost(_doc(np.random.default_rng(23),
                                                               alerts=0)), None),
        "widened": (base, _doc(np.random.default_rng(23), p50=200.0, goodput=0.1, alerts=0),
                    "p50_ms=50,p95_ms=50,p99_ms=50,goodput_gbps=0.99"),
        "pre_pulse_baseline": (_doc(np.random.default_rng(23)),
                               _doc(np.random.default_rng(23), alerts=4), None),
        "bench_line": ({"p50_ms": 1.0, "p95_ms": 2.0, "p99_ms": 3.0, "goodput_gbps": 0.5,
                        "errors": {"shed": 2}, "lost": 1, "recompiles": 4, "mismatches": 0,
                        "requests": 10},
                       {"p50_ms": 1.2, "p95_ms": 9.0, "p99_ms": 3.0, "goodput_gbps": 0.5,
                        "errors": {"shed": 3}, "lost": 1, "recompiles": 4, "mismatches": 0,
                        "requests": 10}, None),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_compare_and_render_equal_reference(case):
    base_doc, cand_doc, spec = _cases()[case]
    base, cand = slo.extract(base_doc), slo.extract(cand_doc)
    assert (base, cand) == (jslo.extract(base_doc), jslo.extract(cand_doc))
    tol = slo.parse_tolerances(spec)
    assert tol == jslo.parse_tolerances(spec)
    fails = slo.compare(base, cand, tol)
    assert fails == jslo.compare(base, cand, tol)
    out, jout = io.StringIO(), io.StringIO()
    slo.render(base, cand, fails, out=out)
    jslo.render(base, cand, fails, out=jout)
    assert out.getvalue() == jout.getvalue()
    red = {"latency_and_goodput", "counts", "stages_and_cost", "bench_line"}
    assert bool(fails) == (case in red)
    if case == "counts":
        assert {f.split(":")[0] for f in fails} >= {"errors_total", "lost", "recompiles",
                                                   "alerts_total"}
    if case == "stages_and_cost":
        assert [f.split(":")[:2] for f in fails] == [["stage", "pack"],
                                                     ["cost", "cuda|ctr|r128|nr10"]]


def test_tolerance_parsing_and_cli_equal_reference(tmp_path, capsys):
    for spec in ("nope=1", "p95_ms", "stage_p95_us=x"):
        with pytest.raises(ValueError):
            slo.parse_tolerances(spec)
        with pytest.raises(ValueError):
            jslo.parse_tolerances(spec)
    assert slo.DEFAULT_TOLERANCES == jslo.DEFAULT_TOLERANCES
    assert slo.COUNT_METRICS == jslo.COUNT_METRICS
    base_doc, bad_doc, _ = _cases()["latency_and_goodput"]
    base, bad = tmp_path / "base.json", tmp_path / "bad.json"
    base.write_text(json.dumps(base_doc))
    bad.write_text(json.dumps(bad_doc))
    for args, want in (([str(base), str(base)], 0), ([str(base), str(bad)], 1),
                       ([str(base), str(bad), "--tolerance",
                         "p50_ms=50,p95_ms=50,p99_ms=50,goodput_gbps=0.99,"
                         "stage_p95_us=50,cost_gbps=1"], 0)):
        rc = slo.main(args)
        out = capsys.readouterr().out
        assert (rc, out) == (jslo.main(args), capsys.readouterr().out)
        assert rc == want


def _write(root, name, doc):
    with open(os.path.join(root, name), "w") as fh:
        json.dump(doc, fh)


@pytest.mark.parametrize("variant", ["green", "goodput_red", "count_red", "mixed_families"])
def test_history_collect_check_render_equal_reference(tmp_path, variant, capsys):
    rng = np.random.default_rng(31)
    root = str(tmp_path)
    _write(root, "SERVE_r01.json", _doc(rng, goodput=1.0, alerts=0))
    second = {"green": dict(goodput=0.8), "goodput_red": dict(goodput=0.3),
              "count_red": dict(goodput=1.2, lost=2), "mixed_families": dict(goodput=0.9)}
    _write(root, "SERVE_r02.json", _doc(rng, alerts=0, **second[variant]))
    if variant == "mixed_families":
        _write(root, "SERVE_r03.json", _doc(rng, goodput=0.01, modes=("ctr", "gcm")))
        _write(root, "SERVE_r02_control.json", _doc(rng, goodput=0.5))
        _write(root, "BENCH_r01.json", {"rc": 0, "parsed": {"value": 35.4, "unit": "GB/s"}})
        _write(root, "SESSION_r01.json", {**_doc(rng), "sessions": {"prefetch": {
            "hit_rate": 0.97}}})
        _write(root, "MULTICHIP_r01.json", {"n_devices": 1, "ok": True})
        with open(os.path.join(root, "ROUTE_r01.json"), "w") as fh:
            fh.write("{not json")
        _write(root, "notes.json", {"x": 1})
    recs = history.collect(root)
    assert recs == jhistory.collect(root)
    fails = history.check(recs)
    assert fails == jhistory.check(recs)
    out, jout = io.StringIO(), io.StringIO()
    history.render(recs, out=out)
    jhistory.render(recs, out=jout)
    assert out.getvalue() == jout.getvalue()
    want_red = variant != "green"
    assert bool(fails) == want_red
    for args in (["--root", root, "--check"], ["--root", root, "--json"]):
        rc = history.main(args)
        cap = capsys.readouterr()
        assert (rc, cap.out, cap.err) == (jhistory.main(args), *capsys.readouterr())
    assert history.parse_tolerances("goodput_gbps=0.5") == jhistory.parse_tolerances(
        "goodput_gbps=0.5")
    with pytest.raises(ValueError):
        history.parse_tolerances("nope=1")


def test_history_repo_root_is_this_repo():
    assert history.repo_root() == jhistory.repo_root()
    assert os.path.isdir(os.path.join(history.repo_root(), "our_tree_tpu_torch"))


# ---------------------------------------------------------------------------
# The bench's --slo gate and the flags shared with the JAX bench.
# ---------------------------------------------------------------------------


BENCH = ["--device", "cpu", "--engine", "bitslice", "--requests", "16", "--concurrency", "4",
         "--sizes", "16,256", "--bucket-max", "64", "--lanes", "1"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("OT_TRACE_DIR", "OT_FAULTS", "OT_PULSE"):
        monkeypatch.delenv(k, raising=False)
    degrade.clear()
    incident.reset_for_tests()
    yield
    degrade.clear()
    incident.reset_for_tests()


def _baseline(tmp_path, name, **load):
    rng = np.random.default_rng(1)
    doc = _doc(rng, stages=False, cost=False, alerts=0)
    doc["load"].update(load)
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("which,want", [("slow", 0), ("fast", 1), ("errors", 1)])
def test_bench_slo_exit_codes(tmp_path, capsys, which, want):
    # A baseline goodput of 0 promises none (the run's rounds to 0 here).
    if which == "slow":  # a baseline 10^6 times slower: any run passes
        base = _baseline(tmp_path, "b.json", p50_ms=1e7, p95_ms=1e7, p99_ms=1e7,
                         goodput_gbps=0.0)
    elif which == "fast":  # 10^6 times faster: any run is a regression
        base = _baseline(tmp_path, "b.json", p50_ms=1e-6, p95_ms=1e-6, p99_ms=1e-6,
                         goodput_gbps=1e6)
    else:  # slow, but the baseline had no errors: a count never tolerates
        base = _baseline(tmp_path, "b.json", p50_ms=1e7, p95_ms=1e7, p99_ms=1e7,
                         goodput_gbps=0.0)
        doc = json.loads(open(base).read())
        doc["load"]["errors"] = {}
        doc["queue"]["lost"] = 0
        doc["alerts"]["total"] = -1  # the run's 0 alerts exceed it
        open(base, "w").write(json.dumps(doc))
    rc = serve_bench.main([*BENCH, "--slo", base, "--slo-tolerance", "p95_ms=0.5"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert rc == want
    assert line["slo"] == ("pass" if want == 0 else "fail")
    table = [ln for ln in out if ln.startswith("# slo:")]
    assert table and table[-1].startswith("# slo: gate passed" if want == 0
                                          else "# slo: GATE FAILED")
    assert line["alerts"]["total"] == 0 and line["lost"] == 0


def test_bench_slo_unusable_baseline_fails(tmp_path, capsys):
    rc = serve_bench.main([*BENCH, "--slo", str(tmp_path / "missing.json")])
    assert rc == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["slo"] == "fail"


def test_bench_takes_the_reference_flags_with_its_defaults():
    args = serve_bench.parse_args(["--device", "cpu"])
    assert (args.slo, args.slo_tolerance, args.status_port, args.min_inflight,
            args.allow_recompiles, args.tenant_depth_frac, args.low_priority_tenant,
            args.priority_depth_frac) == (None, None, None, None, False, 1.0, None, 0.5)
    args = serve_bench.parse_args(["--device", "cpu", "--slo", "b.json", "--slo-tolerance",
                                   "p95_ms=2", "--status-port", "0", "--min-inflight", "2",
                                   "--allow-recompiles", "--tenant-depth-frac", "0.25",
                                   "--low-priority-tenant", "t1", "--low-priority-tenant",
                                   "t2", "--priority-depth-frac", "0.75"])
    assert (args.slo, args.slo_tolerance, args.status_port, args.min_inflight,
            args.allow_recompiles, args.tenant_depth_frac, args.low_priority_tenant,
            args.priority_depth_frac) == ("b.json", "p95_ms=2", 0, 2, True, 0.25,
                                          ["t1", "t2"], 0.75)


def test_bench_min_inflight_and_admission_flags_reach_the_run(capsys):
    rc = serve_bench.main([*BENCH, "--min-inflight", "2", "--tenant-depth-frac", "0.5",
                           "--low-priority-tenant", "t0", "--priority-depth-frac", "0.9",
                           "--status-port", "0"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1  # one lane: at most one dispatch in flight
    assert line["max_inflight"] == 1
    cfg = line["config"]
    assert (cfg["tenant_depth_frac"], cfg["low_priority_tenants"],
            cfg["priority_depth_frac"]) == (0.5, ["t0"], 0.9)
    rc = serve_bench.main([*BENCH, "--min-inflight", "1"])
    capsys.readouterr()
    assert rc == 0


def test_bench_prints_pulse_and_compile_lines(capsys, monkeypatch):
    from our_tree_tpu_torch.models import aes

    monkeypatch.setattr(aes, "_SEAM_CALLS", set())
    rc = serve_bench.main(BENCH)
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert rc == 0
    assert any(ln.startswith("# pulse: 0 alert(s) over ") for ln in out)
    comp = [ln for ln in out if ln.startswith("# compile: ")]
    assert comp and comp[0].startswith(f"# compile: {line['compiles']['warmup']} compile(s)")
    assert sum(v["count"] for v in line["compiles_by_rung"].values()) == \
        line["compiles"]["warmup"] == 1
    assert set(line["compiles_by_rung"]) == {"32"}
    assert line["alerts"] == {"total": 0, "fired": {}, "rows": [],
                              "frames": line["alerts"]["frames"]}
    assert set(line["capacity"]) == {"rows", "total_blocks_per_s", "measured", "frames"}
    monkeypatch.setenv("OT_PULSE", "0")
    rc = serve_bench.main(BENCH)
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert rc == 0 and line["alerts"] is None and line["capacity"] is None
    assert not any(ln.startswith("# pulse:") for ln in out)
