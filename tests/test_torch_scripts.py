"""The port's operator tools on the CPU: ``arc4_device_keygen``,
``batch_streams_scaling`` and ``profile_ctr`` (``our_tree_tpu_torch/scripts``).

Each tool's lines carry their keys; without a card each one's default
``--device cuda`` raises instead of measuring the CPU; ``profile_ctr``'s
components that time the card (a kernel alone, the copies to it) refuse on
the CPU rather than time a plain version under a kernel's name, and its
parent turns a child that overruns or fails into a TIMEOUT or CRASHED row.
"""

import json

import numpy as np
import pytest
import torch

from our_tree_tpu.models import arc4 as jarc4
from our_tree_tpu_torch.scripts import arc4_device_keygen, batch_streams_scaling, profile_ctr


def lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


@pytest.fixture(autouse=True)
def private_lock(tmp_path, monkeypatch):
    """Each test's tools hold their own card lock."""
    monkeypatch.setenv("OT_BENCH_BUSY_FILE", str(tmp_path / "busy"))


@pytest.mark.parametrize("tool,args", [
    (arc4_device_keygen, []),
    (batch_streams_scaling, []),
])
def test_tools_raise_without_a_card(tool, args, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(args)


def test_profile_ctr_child_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_ctr.main(["--component", "digest"])


def test_arc4_device_keygen_lines(capsys):
    assert arc4_device_keygen.main(["--device", "cpu", "--sizes-kb", "1,2", "--iters", "1"]) == 0
    rows = lines(capsys.readouterr().out)
    assert [(r["what"], r["bytes"]) for r in rows] == [
        ("arc4-keygen-device", 1024), ("arc4-keygen-device", 2048),
        ("arc4-keygen-native-c", 1024), ("arc4-keygen-native-c", 2048)]
    for r in rows:
        assert r["best_s"] > 0 and r["mb_per_s"] > 0
        assert r["s_per_gib_extrapolated"] == pytest.approx(r["best_s"] * (1 << 30) / r["bytes"])
    assert {(r["platform"], r["launches"]) for r in rows[:2]} == {("cpu", 0)}


def test_arc4_device_keygen_holds_the_card_to_the_reference_keystream():
    """The keystream the tool times is the JAX package's for the tool's key."""
    from our_tree_tpu_torch.models.arc4 import ARC4

    want = jarc4.ARC4(arc4_device_keygen.KEY).prep(1024, backend="np")
    assert np.array_equal(ARC4(arc4_device_keygen.KEY, device="cpu").prep(1024), want)


def test_batch_streams_scaling_lines(capsys):
    assert batch_streams_scaling.main(["--device", "cpu", "--total-mb", str(4096 / (1 << 20)),
                                       "--streams", "2,8", "--iters", "1"]) == 0
    rows = lines(capsys.readouterr().out)
    assert [(r["what"], r["streams"]) for r in rows] == [
        ("cbc-batch", 2), ("rc4-batch", 2), ("cbc-batch", 8), ("rc4-batch", 8)]
    for r in rows:
        assert r["bytes"] == 4096 and r["gb_per_s"] == pytest.approx(4096 / r["best_s"] / 1e9)
        assert r["platform"] == "cpu" and r["launches_per_call"] == {}
    assert {r["form"] for r in rows if r["what"] == "cbc-batch"} == {"plain"}
    assert all(r["keystream_s"] > 0 for r in rows if r["what"] == "rc4-batch")


@pytest.mark.parametrize("component", sorted(profile_ctr.CARD_ONLY))
def test_profile_ctr_card_components_refuse_on_the_cpu(component, capsys):
    assert profile_ctr.main(["--component", component, "--device", "cpu"]) == 2
    (row,) = lines(capsys.readouterr().out)
    assert row["component"] == component and row["error"].startswith("refused on the CPU")


@pytest.mark.parametrize("component", ["digest", "pack", "counter-mat", "ctr-flat-auto"])
def test_profile_ctr_component_line(component, capsys, monkeypatch):
    monkeypatch.setattr(profile_ctr, "NBYTES", 4096)
    monkeypatch.setattr(profile_ctr, "ITERS", 2)
    assert profile_ctr.main(["--component", component, "--device", "cpu"]) == 0
    (row,) = lines(capsys.readouterr().out)
    assert row["component"] == component and row["label"] == profile_ctr.LABELS[component]
    assert row["sec"] > 0 and row["ms"] == pytest.approx(row["sec"] * 1e3)
    assert row["bytes"] == 4096 and row["iters"] == 2 and row["platform"] == "cpu"
    assert (row["gb_per_s"] is None) == (component in profile_ctr.NOT_STREAMING)
    assert row["launches_per_step"] == {}


def test_profile_ctr_parent_rows(capsys, monkeypatch):
    """One child a component: a measured row, a refused one; then the
    children overrun a tiny timeout, and a size that is not whole blocks
    crashes them."""
    monkeypatch.setenv("OT_PROF_BYTES", "4096")
    monkeypatch.setenv("OT_PROF_ITERS", "1")
    monkeypatch.setattr(profile_ctr, "COMPONENTS", [("digest", "d"), ("ctr-kernel", "k")])
    assert profile_ctr.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    summary = lines(out)[-1]["profile_ctr"]
    assert [(r["component"], r["status"]) for r in summary["rows"]] == [
        ("digest", "ok"), ("ctr-kernel", "refused")]
    assert "REFUSED" in out
    assert profile_ctr.main(["--device", "cpu", "--timeout", "0.05"]) == 1
    rows = lines(capsys.readouterr().out)[-1]["profile_ctr"]["rows"]
    assert [r["status"] for r in rows] == ["timeout", "timeout"]
    monkeypatch.setenv("OT_PROF_BYTES", "17")
    assert profile_ctr.main(["--device", "cpu"]) == 1
    rows = lines(capsys.readouterr().out)[-1]["profile_ctr"]["rows"]
    assert [r["status"] for r in rows] == ["crashed", "refused"]
    assert "multiple of 16" in rows[0]["error"]


def test_profile_ctr_capture_needs_the_run_layout(monkeypatch, capsys):
    monkeypatch.delenv("OT_TRACE_DIR", raising=False)
    assert profile_ctr.main(["--device", "cpu", "--capture"]) == 2
    assert "OT_TRACE_DIR" in capsys.readouterr().err


def test_profile_ctr_capture_writes_a_window_per_child(tmp_path, monkeypatch, capsys):
    """``--capture``: each child measures inside the profiler's window, whose
    summary lands in the run layout and validates."""
    from our_tree_tpu_torch.obs import profiler

    monkeypatch.setenv("OT_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("OT_TRACE_RUN", "cap")
    monkeypatch.setenv("OT_PROF_BYTES", "4096")
    monkeypatch.setenv("OT_PROF_ITERS", "1")
    monkeypatch.delenv("OT_PROF_CAPTURE", raising=False)
    monkeypatch.setattr(profile_ctr, "COMPONENTS", [("digest", "d"), ("pack", "p")])
    try:
        assert profile_ctr.main(["--device", "cpu", "--capture"]) == 0
    finally:
        monkeypatch.delenv("OT_PROF_CAPTURE", raising=False)
    summaries = sorted((tmp_path / "cap").glob("profile-*.json"))
    assert len(summaries) == 2
    for path in summaries:
        doc = json.loads(path.read_text())
        assert profiler.validate_summary(doc) == [] and doc["armed_by"] == "cli"
