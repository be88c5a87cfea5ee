"""The port's device lock (``our_tree_tpu_torch.utils.devlock``): the JAX
package's twelve cases, the marker read by either package's module, the
bare-file load, and the bench's hold logic (``bench.claim_card`` and
``bench.main``) under the ``lock_busy`` fault point."""

import contextlib
import importlib.util
import io
import os
import pathlib
import tempfile
import time

import pytest
import torch

from our_tree_tpu.utils import devlock as jdevlock
from our_tree_tpu_torch import bench
from our_tree_tpu_torch.resilience import faults
from our_tree_tpu_torch.utils import devlock

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _marker_pid(p: str) -> int:
    return int(open(p).read().split(":")[0])


def test_acquire_release_roundtrip(tmp_path):
    p = str(tmp_path / "busy")
    assert not devlock.is_held(p)
    assert devlock.acquire(p)
    assert devlock.is_held(p) and _marker_pid(p) == os.getpid()
    assert not devlock.acquire(p)
    devlock.release(True, p)
    assert not devlock.is_held(p)


def test_stale_dead_pid_is_reclaimed(tmp_path):
    p = str(tmp_path / "busy")
    with open(p, "w") as f:
        f.write("999999999")
    assert not devlock.is_held(p)
    assert devlock.acquire(p) and _marker_pid(p) == os.getpid()
    devlock.release(True, p)


def test_marker_records_starttime(tmp_path):
    p = str(tmp_path / "busy")
    assert devlock.acquire(p)
    pid_s, sep, start = open(p).read().partition(":")
    assert int(pid_s) == os.getpid()
    if devlock._proc_starttime(os.getpid()) is not None:
        assert sep == ":" and start == devlock._proc_starttime(os.getpid())
    devlock.release(True, p)


def test_recycled_pid_marker_is_stale(tmp_path):
    if devlock._proc_starttime(os.getpid()) is None:
        return
    p = str(tmp_path / "busy")
    with open(p, "w") as f:
        f.write(f"{os.getpid()}:1")
    assert not devlock.is_held(p)
    assert devlock.acquire(p) and devlock.is_held(p)
    devlock.release(True, p)


def test_bare_pid_marker_back_compat(tmp_path):
    p = str(tmp_path / "busy")
    with open(p, "w") as f:
        f.write(str(os.getpid()))
    assert devlock.is_held(p) and not devlock.acquire(p)
    os.remove(p)


@pytest.fixture
def armed(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("OT_FAULTS", spec)
        faults.reset()
    yield arm
    monkeypatch.delenv("OT_FAULTS", raising=False)
    faults.reset()


def test_injected_lock_busy(tmp_path, armed):
    p = str(tmp_path / "busy")
    armed("lock_busy:2")
    assert devlock.is_held(p)
    assert not devlock.acquire(p)
    assert devlock.is_held(p)
    assert not devlock.acquire(p)
    assert not devlock.is_held(p)
    assert devlock.acquire(p)
    devlock.release(True, p)


def test_pidless_marker_ages_out(tmp_path, monkeypatch):
    p = str(tmp_path / "busy")
    open(p, "w").close()
    assert devlock.is_held(p)
    monkeypatch.setattr(devlock, "STALE_S", 0.0)
    time.sleep(0.05)
    assert not devlock.is_held(p)
    assert devlock.acquire(p)
    devlock.release(True, p)


def test_hold_is_advisory_and_owner_cleans_up(tmp_path):
    p = str(tmp_path / "busy")
    with devlock.hold(p) as owned:
        assert owned
        with devlock.hold(p) as inner:
            assert not inner
        assert devlock.is_held(p)
    assert not devlock.is_held(p)


def test_pid_marker_also_ages_out(tmp_path, monkeypatch):
    p = str(tmp_path / "busy")
    with open(p, "w") as f:
        f.write(str(os.getpid()))
    assert devlock.is_held(p)
    monkeypatch.setattr(devlock, "STALE_S", 0.0)
    time.sleep(0.05)
    assert not devlock.is_held(p)


def test_stale_reclaim_is_single_winner(tmp_path):
    p = str(tmp_path / "busy")
    with open(p, "w") as f:
        f.write("999999999")
    assert devlock.acquire(p)
    assert not devlock.acquire(p)
    assert devlock.is_held(p) and _marker_pid(p) == os.getpid()
    devlock.release(True, p)


def test_hold_refreshes_mtime_for_long_holders(tmp_path):
    p = str(tmp_path / "busy")
    with devlock.hold(p, refresh_s=0.05) as owned:
        assert owned
        m0 = os.stat(p).st_mtime
        time.sleep(0.3)
        assert os.stat(p).st_mtime > m0
    assert not os.path.exists(p)


def test_wait_returns_when_released(tmp_path):
    p = str(tmp_path / "busy")
    assert devlock.wait(5.0, p) < 0.5
    assert devlock.acquire(p)
    t0 = time.time()
    waited = devlock.wait(0.3, p, poll_s=0.05)
    assert 0.25 <= time.time() - t0 < 2.0 and waited >= 0.25
    devlock.release(True, p)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_marker_of_either_package_holds_the_other(tmp_path, writer):
    w, r = (jdevlock, devlock) if writer == "jax" else (devlock, jdevlock)
    p = str(tmp_path / "busy")
    assert w.acquire(p)
    assert r.is_held(p) and not r.acquire(p)
    w.release(True, p)
    assert not r.is_held(p)
    assert devlock.DEFAULT_PATH == os.path.join(tempfile.gettempdir(), "gpu_busy")


def test_module_loads_as_a_bare_file(tmp_path, armed):
    spec = importlib.util.spec_from_file_location(
        "bare_devlock", ROOT / "our_tree_tpu_torch" / "utils" / "devlock.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    p = str(tmp_path / "busy")
    with mod.hold(p) as owned:
        assert owned and devlock.is_held(p)
    # Its fault registry is the package's own.
    armed("lock_busy:1")
    assert mod.is_held(p) and not mod.acquire(p) and not devlock.is_held(p)


# -- the bench's hold logic ------------------------------------------------------


@pytest.fixture
def busy_file(tmp_path, monkeypatch):
    p = tmp_path / "gpu_busy"
    monkeypatch.setenv("OT_BENCH_BUSY_FILE", str(p))
    monkeypatch.setenv("OT_BENCH_DEADLINE", "1")
    return p


def _main(monkeypatch, ran):
    """``bench.main`` with a card reported and the measurement stubbed:
    (rc, stdout, stderr)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "run", lambda engine: ran.append(
        (engine, os.path.exists(os.environ["OT_BENCH_BUSY_FILE"]))) or {"value": 1})
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main()
    return rc, out.getvalue(), err.getvalue()


def test_bench_holds_the_marker_through_the_measurement(busy_file, monkeypatch):
    ran = []
    rc, out, _ = _main(monkeypatch, ran)
    assert rc == 0 and ran == [("probe", True)] and out.strip() == '{"value": 1}'
    assert not busy_file.exists()  # released


def test_bench_busy_card_exits_nonzero_naming_the_holder(busy_file, monkeypatch, armed):
    armed("lock_busy")
    ran = []
    t0 = time.monotonic()
    rc, out, err = _main(monkeypatch, ran)
    assert rc == 3 and ran == [] and out == ""
    assert "held by injected lock_busy" in err and "not measuring" in err
    assert 0.25 <= time.monotonic() - t0 < 5  # waited 0.3 x OT_BENCH_DEADLINE
    # A live holder of another process: named by its pid.
    armed("")
    busy_file.write_text(f"{os.getppid()}")
    rc, out, err = _main(monkeypatch, ran)
    assert rc == 3 and ran == [] and f"held by pid {os.getppid()}" in err
    assert busy_file.read_text() == f"{os.getppid()}"  # never removed by a non-owner


def test_bench_counted_lock_busy_retries_then_owns(busy_file, monkeypatch, armed):
    armed("lock_busy:1")
    assert bench.claim_card() is True  # one failed acquire, then the real state
    devlock.release(True)
    armed("lock_busy:1")
    ran = []
    rc, _, _ = _main(monkeypatch, ran)
    assert rc == 0 and ran == [("probe", True)] and not busy_file.exists()


def test_bench_stale_marker_is_reclaimed(busy_file, monkeypatch):
    busy_file.write_text("999999999")
    ran = []
    rc, _, _ = _main(monkeypatch, ran)
    assert rc == 0 and ran == [("probe", True)] and not busy_file.exists()
