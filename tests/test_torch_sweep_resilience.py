"""The sweep's resilience on the port's own copies
(``our_tree_tpu_torch.resilience``: faults, journal, isolate, watchdog),
after the JAX package's ``test_journal_resume.py``, ``test_isolate.py`` and
``test_bench_faults.py``: ``OT_FAULTS`` specs parse to the same schedules as
the JAX package's; a journaled sweep killed by ``unit_crash`` resumes with
the same rows; the watchdog fails a hung unit on the main thread and the
sweep moves on; ``--isolate`` quarantines a ``dispatch_hang`` unit after
``--quarantine-after`` failures and ``--unquarantine`` releases it. Sweeps
run in process where they can; the isolated ones spawn two children in all,
on the native C tier, which never imports torch. ``OT_FAKE_TIME_US`` pins
every timed region so corpora compare byte for byte."""

import contextlib
import io
import json

import pytest

from our_tree_tpu.resilience import faults as jfaults
from our_tree_tpu_torch.harness import bench
from our_tree_tpu_torch.resilience import degrade, faults, watchdog

SPECS = [
    "", "dispatch_fail:1", "init_hang:2,dispatch_fail:1,build_fail,dispatch_hang:1@2",
    "lane_hang:1@lane=3", " lane_fail:2@lane=1 , lane_fail:1@lane=1,lane_fail:1",
    "x:2,x:1", "unit_crash,unit_crash:3", "dispatch_hang:0", "bogus:1", "bad:abc",
    "lane_hang:1@lane=x", "backend_hang@backend=2", "chunk_lost:1@chunk=3,session_stall",
    "dispatch_hang:2@1,dispatch_hang:1@3", "a@nope=1",
]
SWEEP = ["--backend", "gpu", "--device", "cpu", "--engine", "ttable", "--modes", "ecb,ctr,rc4",
         "--sizes-mb", "0.0625", "--workers", "1", "--iters", "2"]
ISOLATED = ["--backend", "c", "--device", "cpu", "--modes", "ecb", "--sizes-mb", "0.0625",
            "--workers", "1", "--iters", "2"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("OT_FAKE_TIME_US", "7")
    monkeypatch.setenv("OT_ARC4_PREP", "native")
    monkeypatch.setenv("OT_CRASH_DIR", str(tmp_path / "crash"))
    monkeypatch.delenv("OT_FAULTS", raising=False)
    monkeypatch.delenv("OT_SWEEP_JOURNAL", raising=False)
    faults.reset()
    degrade.clear()
    yield
    monkeypatch.delenv("OT_FAULTS", raising=False)
    faults.reset()
    degrade.clear()


def _run(argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv)
    return rc, buf.getvalue()


def _records(path):
    return [json.loads(line) for line in open(path)][1:]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_specs_parse_to_the_reference_schedule(spec, monkeypatch, capsys):
    assert faults._parse(spec) == jfaults._parse(spec)
    monkeypatch.setenv("OT_FAULTS", spec)
    faults.reset()
    jfaults.reset()
    points = sorted({k for k in faults.armed()} | {"dispatch_hang", "lane_fail@lane=1"})
    # The same firing sequence, shot by shot.
    for _ in range(5):
        for point in points:
            assert faults.fire(point) == jfaults.fire(point), (spec, point)
    assert faults.armed() == jfaults.armed()
    jfaults.reset()


def test_journaled_sweep_killed_by_unit_crash_resumes_with_the_same_rows(tmp_path, monkeypatch):
    rc, ref = _run(SWEEP + ["--journal", str(tmp_path / "ref.jsonl")])
    assert rc == 0
    units = [e["unit"] for e in _records(tmp_path / "ref.jsonl")]
    assert units == ["ecb:65536", "ctr:65536", "rc4:65536", "arc4-self-test"]
    # The second unit crashes mid-sweep; the raise escapes main().
    monkeypatch.setenv("OT_FAULTS", "unit_crash:1@1")
    faults.reset()
    jpath = tmp_path / "j.jsonl"
    with pytest.raises(faults.InjectedFault), contextlib.redirect_stdout(io.StringIO()):
        bench.main(SWEEP + ["--journal", str(jpath)])
    assert [e["unit"] for e in _records(jpath)] == ["ecb:65536"]
    monkeypatch.delenv("OT_FAULTS")
    faults.reset()
    rc, resumed = _run(SWEEP + ["--journal", str(jpath)])
    assert rc == 0 and resumed == ref
    assert [e["unit"] for e in _records(jpath)] == units
    # A changed config invalidates the journal instead of replaying it.
    rc, _ = _run(SWEEP + ["--journal", str(jpath), "--seed", "2"])
    header = json.loads(open(jpath).readline())
    assert header["config"]["seed"] == 2 and len(_records(jpath)) == 4


def test_watchdog_fails_a_hung_unit_and_the_sweep_moves_on(tmp_path, monkeypatch, capsys):
    """In process: the injected hang sleeps on the main thread, the
    watchdog's SIGALRM ends it at the deadline, the unit is journaled as
    failed and the next one runs."""
    monkeypatch.setenv("OT_FAULTS", "dispatch_hang:1")
    monkeypatch.setenv("OT_HANG_S", "120")
    faults.reset()
    jpath = tmp_path / "j.jsonl"
    rc, out = _run(ISOLATED + ["--modes", "ecb,ctr", "--journal", str(jpath),
                               "--dispatch-deadline", "2"])
    assert rc == 0
    recs = _records(jpath)
    assert [(e["unit"], e.get("reason")) for e in recs] == [
        ("ecb:65536", "watchdog:2s"), ("ctr:65536", None)]
    assert "# watchdog:" in capsys.readouterr().err
    assert out.strip().splitlines()[-1] == "# degraded: dispatch-timeout"
    assert watchdog.hangs_injected() >= 1
    assert list((tmp_path / "crash").glob("watchdog-*.txt"))


def test_isolate_quarantines_a_hung_unit_and_unquarantine_releases_it(tmp_path, monkeypatch,
                                                                     capsys):
    rc, ref = _run(ISOLATED + ["--journal", str(tmp_path / "ref.jsonl")])
    assert rc == 0
    # 1. One child hangs in its timed region; the supervisor kills it at the
    # unit deadline and, after one failure, quarantines the unit.
    monkeypatch.setenv("OT_FAULTS", "dispatch_hang:1")
    faults.reset()
    jpath = tmp_path / "j.jsonl"
    rc, out = _run(ISOLATED + ["--isolate", "--journal", str(jpath), "--unit-deadline", "4",
                               "--quarantine-after", "1"])
    assert rc == 0
    recs = _records(jpath)
    assert [(e["unit"], e["reason"]) for e in recs] == [("ecb:65536", "timeout:4s")]
    assert out.strip().splitlines() == ["# degraded: quarantined:ecb:65536"]
    assert "quarantined unit(s): ecb:65536" in capsys.readouterr().err
    # A resumed run skips the quarantined unit without a child.
    degrade.clear()
    rc, out = _run(ISOLATED + ["--isolate", "--journal", str(jpath), "--unit-deadline", "4",
                               "--quarantine-after", "1"])
    assert rc == 0 and out.strip().splitlines() == ["# degraded: quarantined:ecb:65536"]
    assert len(_records(jpath)) == 1
    # 2. The release: the failure row goes, nothing else.
    monkeypatch.delenv("OT_FAULTS")
    faults.reset()
    degrade.clear()
    assert bench.main(["--unquarantine", "ecb:65536", "--journal", str(jpath)]) == 0
    assert "cleared 1 failure row(s)" in capsys.readouterr().err
    assert _records(jpath) == []
    # 3. The unit runs again, in its child, with the reference's rows.
    rc, out = _run(ISOLATED + ["--isolate", "--journal", str(jpath), "--unit-deadline", "60",
                               "--quarantine-after", "1"])
    assert rc == 0 and out == ref
    assert [e["unit"] for e in _records(jpath)] == ["ecb:65536"]


def test_isolate_and_unquarantine_refuse_without_a_journal(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(ISOLATED + ["--isolate"])
    assert e.value.code == 2 and "--journal" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        bench.main(["--unquarantine", "ecb:65536"])
    assert e.value.code == 2
