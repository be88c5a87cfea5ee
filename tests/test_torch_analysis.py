"""The port's static analysis (``our_tree_tpu_torch/analysis/``), as
``tests/test_analysis.py`` holds the JAX package's:

* every AST rule on a fixture with its planted violation and on its
  compliant twin, the seams named by the port (the card's barriers and
  staging, the kernel wrappers, ``torch`` in ``route/``, the port's fault
  points and label keys);
* the rules that name no seam (``subprocess-isolate``,
  ``degrade-chokepoint``, ``wallclock``, ``trace-attrs``,
  ``fault-points``, ``metrics-labels``, the executor ``unit()`` guard,
  serve's threads, and ot-san's ``loop-stall``, ``lock-await``,
  ``lock-order``, ``thread-ownership``) give the JAX linter's findings on
  the same fixtures: rule, line, message and fingerprint;
* the graph audit: a planted secret-indexed gather found, a constant-index
  permutation not flagged, taint carried by a loop, the bitsliced plain
  versions and the ARC4 XOR phase clean, ``ttable`` and the PRGA flagged,
  widening flagged, a batch-sized loop flagged, the audited entries against
  the committed baseline;
* the baseline's round trip, the CLI's exit codes against the committed
  baseline and on a planted finding, ``--fix`` and its exemptions.

No case goes through the JAX package's ``jaxpr_audit.py``.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import textwrap

import numpy as np
import pytest
import torch

from our_tree_tpu.analysis import astrules as jastrules
from our_tree_tpu.analysis import sanrules as jsanrules
from our_tree_tpu_torch.analysis import (astrules, baseline, driver, graph_audit,
                                         sanrules)
from our_tree_tpu_torch.analysis.findings import Finding

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASELINE = ROOT / "our_tree_tpu_torch" / "analysis" / "baseline.json"


def _write(tmp_path, src: str, name: str) -> pathlib.Path:
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return p


def _lint(tmp_path, src: str, name: str = "fixture.py", mod=astrules):
    p = _write(tmp_path, src, name)
    return mod.lint_paths([str(p)], str(tmp_path))


def _rules(findings):
    return sorted({f.rule for f in findings})


def _by_rule(findings, rule):
    return [f for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# Layer 1 against the JAX linter: the rules that name no seam.
# ---------------------------------------------------------------------------

#: (fixture name, relative path, source, rules compared, findings expected)
SHARED_FIXTURES = [
    ("subprocess", "fixture.py", """
        import subprocess
        import os

        def boom():
            os.fork()
            subprocess.run(["ls"])  # the import already flagged
    """, ("subprocess-isolate",), 2),
    ("subprocess-chokepoint", "resilience/isolate.py", """
        import subprocess
    """, ("subprocess-isolate",), 0),
    ("degrade", "fixture.py", """
        from pkg.resilience import degrade

        def bad_report():
            print("# degraded: cuda->cpu")  # not fed by the ledger

        def bad_kind():
            degrade.degrade("went sideways somehow", "why")

        def good_report():
            print("# degraded: " + ",".join(degrade.events()))

        def good_kind():
            degrade.degrade("cuda->cpu", "why")
            degrade.degrade("quarantined:ecb:65536", "why")
            degrade.degrade("dispatch-timeout", "why")
    """, ("degrade-chokepoint",), 2),
    ("wallclock", "fixture.py", """
        import time

        def bad():
            return time.time()

        def good():
            return time.monotonic() + time.perf_counter()
    """, ("wallclock",), 1),
    ("wallclock-obs", "obs/clock.py", """
        import time
        x = time.time_ns()
    """, ("wallclock",), 0),
    ("trace-attrs", "fixture.py", """
        from pkg.obs import trace

        def bad():
            trace.point("x", blob=b"raw-bytes")
            trace.counter("c", 1, tags={"a", "b"})

        def good():
            trace.point("x", unit="ecb:65536", n=3, ok=True, f=1.5)
            with trace.span("s", mode="ctr"):
                pass
    """, ("trace-attrs",), 2),
    ("fault-points", "fixture.py", """
        from pkg.resilience import faults, watchdog

        def bad(i):
            faults.check("dispach_hang")  # a typo never fires
            faults.check_lane("lane_fial", i)

        def good(i):
            faults.check("dispatch_fail")
            faults.fire("init_hang")
            watchdog.injected_hang("dispatch_hang")
            faults.check_lane("lane_fail", i)
            faults.fire(faults.scoped("lane_hang", i))
            faults.fire_backend("pool_stale", i)
    """, ("fault-points",), 2),
    ("metrics-labels", "fixture.py", """
        from pkg.obs import metrics

        def bad(req, tenant, extra):
            metrics.counter("serve_requests", tenant=tenant)
            metrics.observe("lat_us", 5, outcome=f"req-{req.kind}")
            metrics.counter("x", code=req.id)
            metrics.gauge("g", 1, **extra)

        def good(lane, rung, engine_name):
            metrics.counter("serve_redispatch", lane=lane)
            metrics.observe("serve_dispatch_us", 12, rung=rung,
                            engine=engine_name, outcome="ok")
            metrics.gauge_max("serve_queue_depth_peak", 3)
            metrics.counter("serve_refused", code="bad-request")
    """, ("metrics-labels",), 4),
    ("executor-unit", "serve/dispatch.py", """
        from pkg.resilience import watchdog

        def _run(q):
            while True:
                fut, unit = q.get()
                result = unit()
                fut.set_result(result)

        def _run_guarded(q):
            while True:
                fut, unit = q.get()

                def kill(exc, fut=fut):
                    fut.set_exception(exc)

                with watchdog.thread_kill_hook(kill):
                    fut.set_result(unit())
    """, ("dispatch-watchdog",), 1),
    ("serve-threads", "serve/batcher.py", """
        import threading

        def spawn(work):
            t = threading.Thread(target=work, daemon=True)
            t.start()
            return t
    """, ("serve-lane-seam",), 1),
    ("serve-threads-executor", "serve/dispatch.py", """
        import threading

        def spawn(work):
            return threading.Thread(target=work, daemon=True)
    """, ("serve-lane-seam",), 0),
]


@pytest.mark.parametrize("name,rel,src,rules,expected", SHARED_FIXTURES,
                         ids=[f[0] for f in SHARED_FIXTURES])
def test_seamless_rules_match_the_reference_linter(tmp_path, name, rel, src, rules, expected):
    def shape(findings):
        return sorted((f.rule, f.severity, f.line, f.anchor, f.message, f.fingerprint)
                      for f in findings if f.rule in rules)

    port = shape(_lint(tmp_path / "port", src, rel))
    ref = shape(_lint(tmp_path / "port", src, rel, mod=jastrules))
    assert port == ref
    assert len(port) == expected


def test_fingerprints_survive_line_moves(tmp_path):
    a = _lint(tmp_path, "import time\nx = time.time()\n", name="a.py")
    b = _lint(tmp_path, "import time\n\n\ny = 1\nx = time.time()\n", name="a.py")
    assert a[0].fingerprint == b[0].fingerprint


# ---------------------------------------------------------------------------
# Layer 1: the rules aimed at the port's seams.
# ---------------------------------------------------------------------------


def test_dispatch_rule_flags_the_cards_waits_staging_and_kernels(tmp_path):
    fs = _lint(tmp_path, """
        import torch
        from our_tree_tpu_torch.ops import cuda_aes
        from our_tree_tpu_torch.resilience import watchdog

        def bad(x, dev, ev, stream, rks, slots):
            torch.cuda.synchronize()
            ev.synchronize()
            stream.synchronize()
            y = x.cuda()
            z = x.to(dev)
            w = x.to(device="cuda")
            v = x.to("cuda:0")
            return cuda_aes.ctr_scattered_multikey(y, z, rks, slots, 10)

        def not_card_contact(x):
            a = x.to(torch.int64)
            return cuda_aes.ctr_scattered_multikey_plain(a, a, a, a, 10)

        def good(x, dev):
            with watchdog.deadline(30, what="guarded dispatch"):
                torch.cuda.synchronize()
                return x.to(dev)
    """, name="our_tree_tpu_torch/harness/foo.py")
    flagged = _by_rule(fs, "dispatch-watchdog")
    assert len(flagged) == 8
    assert all("watchdog" in f.message for f in flagged)
    assert any("cuda_aes.ctr_scattered_multikey()" in f.message for f in flagged)


def test_dispatch_rule_exempts_the_seams_and_the_engine_layer(tmp_path):
    src = """
        import torch

        def stage(x, dev, stream):
            out = x.to(dev)
            stream.synchronize()
            return out
    """
    for rel in ("our_tree_tpu_torch/harness/backends.py", "our_tree_tpu_torch/serve/lanes.py",
                "our_tree_tpu_torch/ops/cuda_aes.py", "our_tree_tpu_torch/models/aes.py",
                "our_tree_tpu_torch/aead/gcm.py", "our_tree_tpu_torch/parallel/dist.py",
                "our_tree_tpu_torch/utils/packing.py"):
        assert "dispatch-watchdog" not in _rules(_lint(tmp_path, src, name=rel)), rel
    assert len(_by_rule(_lint(tmp_path, src, name="our_tree_tpu_torch/bench.py"),
                        "dispatch-watchdog")) == 2


def test_serve_lane_seam_rule(tmp_path):
    """Dispatch in serve/ only through serve/lanes.py: a models-level seam
    call or a stream fence anywhere else under serve/ flags; the same code
    inside lanes.py is the seam; the rule scopes serve/ only."""
    src = """
        from our_tree_tpu_torch.models import aes

        def dispatch(words, ctr, rks, slots, nr, stream):
            out = aes.ctr_crypt_words_scattered_multikey(words, ctr, rks, slots, nr, "cuda")
            stream.synchronize()
            return out
    """
    flagged = _by_rule(_lint(tmp_path, src, name="our_tree_tpu_torch/serve/server.py"),
                       "serve-lane-seam")
    assert len(flagged) == 2
    assert "serve/lanes.py" in flagged[0].message
    assert "serve-lane-seam" not in _rules(
        _lint(tmp_path, src, name="our_tree_tpu_torch/serve/lanes.py"))
    assert "serve-lane-seam" not in _rules(
        _lint(tmp_path, src, name="our_tree_tpu_torch/harness/foo.py"))


def test_serve_lane_seam_rule_covers_every_mode_and_the_kernel_wrappers(tmp_path):
    violating = """
        from our_tree_tpu_torch.aead import gcm
        from our_tree_tpu_torch.models import aes, arc4
        from our_tree_tpu_torch.ops import cuda_aes, cuda_ghash

        def fast_path(w, p, rks, slots, nr, hk, keep, y0, rows, ks, m, xy):
            a = aes.cbc_decrypt_words_scattered_multikey(w, p, rks, slots, nr, "cuda")
            b = gcm.gcm_crypt_ghash_words(w, p, rks, slots, hk, None, keep, nr, "cuda")
            c = arc4.xor_words(w, ks)
            d = arc4.prep_batch_words(m, xy, 64)
            e = cuda_aes.cbc_scattered_multikey(w, p, rks, slots, nr)
            f = cuda_ghash.ghash_at(w, hk, slots, keep, y0, rows)
            g = w.cuda()
            return a, b, c, d, e, f, g
    """
    flagged = _by_rule(_lint(tmp_path, violating, name="our_tree_tpu_torch/serve/batcher.py"),
                       "serve-lane-seam")
    assert len(flagged) == 7
    assert "serve-lane-seam" not in _rules(
        _lint(tmp_path, violating, name="our_tree_tpu_torch/serve/lanes.py"))


def test_route_seam_rule_forbids_torch_and_backend_contact(tmp_path):
    src = """
        import asyncio
        import torch
        from torch import cuda

        async def poke(host, port, x):
            r, w = await asyncio.open_connection(host, port)
            return x.cuda()
    """
    flagged = _by_rule(_lint(tmp_path, src, name="our_tree_tpu_torch/route/health.py"),
                       "route-backend-seam")
    assert len(flagged) == 4
    assert sum("torch" in f.message for f in flagged) == 2
    # The seam files may speak the wire, never import torch.
    flagged = _by_rule(_lint(tmp_path, src, name="our_tree_tpu_torch/route/proxy.py"),
                       "route-backend-seam")
    assert len(flagged) == 2 and all("torch" in f.message for f in flagged)
    assert not _by_rule(_lint(tmp_path, "import asyncio\nimport json\n",
                              name="our_tree_tpu_torch/route/bench.py"), "route-backend-seam")


def test_fault_points_and_labels_read_the_ports_registries():
    from our_tree_tpu_torch.obs import metrics
    from our_tree_tpu_torch.resilience import faults

    assert astrules.KNOWN_POINTS is faults.KNOWN_POINTS
    assert astrules.ALLOWED_LABEL_KEYS is metrics.ALLOWED_LABEL_KEYS


def test_the_port_lints_clean_of_new_findings_under_every_seam_rule():
    """The invariants the reference keeps clean hold in the port with no
    baseline entry: its child processes go through resilience.isolate, its
    card contact through a guard or a seam, route/ imports no torch."""
    fs = astrules.lint_paths([str(ROOT / "our_tree_tpu_torch")], str(ROOT))
    assert {f.rule for f in fs} == {"wallclock"}
    assert {f.path for f in fs} == {"our_tree_tpu_torch/resilience/watchdog.py",
                                    "our_tree_tpu_torch/utils/devlock.py"}


# ---------------------------------------------------------------------------
# Layer 2: the graph audit.
# ---------------------------------------------------------------------------


def _i32(*shape, seed=0, hi=1 << 31):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, hi, shape, dtype=np.int64).astype(np.int32))


def test_planted_secret_indexed_gather_is_detected():
    table = torch.arange(256, dtype=torch.int32)

    def leaky(key, data):
        return table[((data ^ key) & 0xFF).long()]

    fs = graph_audit.audit_fn("planted", leaky, (_i32(64), _i32(64, seed=1)), {0})
    assert "constant-time" in _rules(fs)
    assert "index" in _by_rule(fs, "constant-time")[0].message
    # The same lookup through gather and index_select.
    for fn in (lambda k, d: table.gather(0, ((d ^ k) & 0xFF).long()),
               lambda k, d: table.index_select(0, ((d ^ k) & 0xFF).long())):
        assert "constant-time" in _rules(graph_audit.audit_fn("planted", fn,
                                                              (_i32(64), _i32(64, seed=1)), {0}))


def test_constant_index_permutation_does_not_false_positive():
    perm = torch.tensor([2, 0, 3, 1])

    def shuffled(secret):
        return secret[perm] ^ secret.index_select(0, perm)

    assert graph_audit.audit_fn("perm", shuffled, (_i32(4, 8),), {0}) == []


def test_loop_carried_taint_reaches_the_lookup():
    """A secret that enters the loop state only after the first step must
    still taint a state-indexed lookup; a public state with the secret used
    only elementwise stays clean."""
    table = torch.arange(256, dtype=torch.int32)

    def leaky_via_carry(secret_xs):
        # A one-element state: a 0-d index would leave the graph as a
        # Python int (``.item()``), where the taint stops.
        c = torch.zeros(1, dtype=torch.int32)
        outs = []
        for x in secret_xs:
            outs.append(table[c.long()])
            c = (c + x) & 0xFF
        return torch.stack(outs)

    fs = graph_audit.audit_fn("carry-leak", leaky_via_carry, (_i32(8, hi=256),), {0})
    assert "constant-time" in _rules(fs), [f.render() for f in fs]

    def clean_loop(secret, public_xs):
        c = torch.zeros((), dtype=torch.int32)
        outs = []
        for x in public_xs:
            c = c + x
            outs.append(x ^ secret[0])
        return torch.stack(outs), c

    assert graph_audit.audit_fn("carry-clean", clean_loop,
                                (_i32(4), _i32(8, seed=2, hi=256)), {0}) == []


@pytest.mark.parametrize("entry", [
    "bitslice-enc[kernel]", "bitslice-dec[kernel]", "aes-ctr[bitslice]",
    "ctr-fused-plain[cuda_aes]", "ctr-mk-plain[cuda_aes]", "cbc-mk-plain[cuda_aes]",
    "seq-encrypt-plain[cuda_aes]", "rc4-xor[words]", "rc4-crypt[xor]"])
def test_bitsliced_plain_versions_and_the_xor_phase_audit_clean(entry):
    """The acceptance bar: no secret-indexed lookup, no widening, no graph
    that grows with the batch, both directions, the serve seams' plain
    versions included (the key-slot gather is public)."""
    (name, fn, makers, secrets), = [e for e in graph_audit._entries() if e[0] == entry]
    for n in (graph_audit._N_BASE, graph_audit._N_ALT):
        fs = graph_audit.audit_fn(name, fn, tuple(b(n) for b in makers), secrets)
        assert fs == [], [f.render() for f in fs]
    base = tuple(b(graph_audit._N_BASE) for b in makers)
    alt = tuple(b(graph_audit._N_ALT) for b in makers)
    assert graph_audit.op_count(fn, base) == graph_audit.op_count(fn, alt)


@pytest.mark.parametrize("entry,ops", [
    ("aes-ecb-enc[ttable]", {"index"}), ("aes-ecb-dec[ttable]", {"index"}),
    ("rc4-prga-plain[cuda_arc4]", {"gather", "scatter_"}),
    ("rc4-prep-batched[words]", {"gather", "scatter_"})])
def test_ttable_and_the_prga_are_flagged(entry, ops):
    (name, fn, makers, secrets), = [e for e in graph_audit._entries() if e[0] == entry]
    fs = graph_audit.audit_fn(name, fn, tuple(b(graph_audit._N_BASE) for b in makers),
                              secrets)
    assert {f.anchor.rsplit(":", 1)[1] for f in _by_rule(fs, "constant-time")} == ops


def test_dtype_widening_is_flagged():
    def widens(x):
        return (x.to(torch.int64) * 3) & 0xFFFFFFFF

    fs = graph_audit.audit_fn("widen", widens, (_i32(8),), {0})
    assert _rules(fs) == ["dtype-widening"] and len(fs) == 1
    # A public value widened is not a finding.
    assert graph_audit.audit_fn("widen-public", widens, (_i32(8),), set()) == []


def test_a_batch_sized_loop_is_shape_unrolled():
    def per_row(x):
        return torch.stack([row ^ 1 for row in x])

    assert graph_audit.op_count(per_row, (_i32(4, 4),)) != \
        graph_audit.op_count(per_row, (_i32(8, 4),))


def test_audited_entries_carry_no_new_graph_findings():
    """Every entry runs (no audit-error), the bitsliced entries are clean,
    and the findings are exactly the committed baseline's graph entries."""
    fs = graph_audit.audit()
    assert not _by_rule(fs, "audit-error"), [f.render() for f in fs]
    assert not [f for f in fs if "bitslice" in f.anchor or "cuda_aes" in f.anchor]
    base = baseline.load(str(BASELINE))
    stale = baseline.apply(fs, base)
    assert [f.render() for f in fs if not f.baselined] == []
    assert not [fp for fp in stale if fp.startswith("graph:")]


# ---------------------------------------------------------------------------
# The baseline and the CLI.
# ---------------------------------------------------------------------------


def test_baseline_round_trip_and_staleness(tmp_path):
    f1 = Finding("wallclock", "warning", "m1", "a.py", 3, anchor="x = 1")
    f2 = Finding("wallclock", "warning", "m2", "b.py", 7, anchor="y = 2")
    path = tmp_path / "base.json"
    baseline.write(str(path), [f1, f2])
    with pytest.raises(baseline.BaselineError):
        baseline.load(str(path))
    data = json.loads(path.read_text())
    for e in data["findings"]:
        e["reason"] = "a real reason"
    path.write_text(json.dumps(data))
    loaded = baseline.load(str(path))
    assert set(loaded) == {f1.fingerprint, f2.fingerprint}
    fs = [Finding("wallclock", "warning", "m1", "a.py", 3, anchor="x = 1")]
    assert baseline.apply(fs, loaded) == sorted([f2.fingerprint])
    assert fs[0].baselined and fs[0].baseline_reason == "a real reason"
    baseline.write(str(path), fs, loaded)
    assert baseline.load(str(path))[f1.fingerprint]["reason"] == "a real reason"


def test_committed_baseline_gives_every_entry_a_reason():
    entries = json.loads(BASELINE.read_text())["findings"]
    assert entries and all(e["reason"].strip() and not e["reason"].startswith("TODO")
                           for e in entries)
    assert len(baseline.load(str(BASELINE))) == len(entries)


def test_cli_runs_clean_against_committed_baseline():
    assert driver.main(["--baseline", str(BASELINE), "--fail-on-new", "--no-graph"]) == 0


def test_cli_fails_on_a_planted_new_finding(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import subprocess\n")
    assert driver.main([str(bad), "--no-graph", "--fail-on-new"]) == 1
    assert driver.main([str(bad), "--no-graph", "--baseline", str(BASELINE),
                        "--fail-on-new"]) == 1
    assert driver.main([str(bad), "--no-graph"]) == 0
    # A planted file inside a copy of the package fails the default scan.
    pkg = tmp_path / "our_tree_tpu_torch"
    shutil.copytree(ROOT / "our_tree_tpu_torch" / "route", pkg / "route")
    (pkg / "route" / "leak.py").write_text("import subprocess\n")
    assert driver.main([str(pkg), "--no-graph", "--fail-on-new"]) == 1


def test_cli_lists_every_rule(capsys):
    assert driver.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in [r.id for r in astrules.RULES] + [r.id for r in sanrules.RULES] + list(
            graph_audit.RULE_DOCS):
        assert rule in out


# ---------------------------------------------------------------------------
# --fix.
# ---------------------------------------------------------------------------


def test_fix_wallclock_fixture_pair_relints_clean(tmp_path):
    before = textwrap.dedent("""\
        import time


        def took():
            t0 = time.time()
            work()
            ns = time.time_ns()
            return time.time() - t0, ns
    """)
    after = before.replace("time.time_ns()", "time.monotonic_ns()").replace(
        "time.time()", "time.monotonic()")
    f = tmp_path / "wall.py"
    f.write_text(before)
    assert len(_by_rule(astrules.lint_paths([str(f)], str(tmp_path)), "wallclock")) == 3
    assert astrules.fix_paths([str(f)], str(tmp_path)) == {"wall.py": 3}
    assert f.read_text() == after
    assert not _by_rule(astrules.lint_paths([str(f)], str(tmp_path)), "wallclock")
    assert astrules.fix_paths([str(f)], str(tmp_path)) == {}


def test_fix_leaves_judgment_sites_alone(tmp_path):
    f = tmp_path / "odd.py"
    f.write_text("import time\nt = time.time\nbad = time.time(*a)\n")
    assert astrules.fix_paths([str(f)], str(tmp_path)) == {}
    g = tmp_path / "broken.py"
    g.write_text("def (:\n")
    assert astrules.fix_paths([str(g)], str(tmp_path)) == {}


def test_fix_cli_applies_then_reports_postfix_state(tmp_path, capsys):
    f = tmp_path / "wall.py"
    f.write_text("import time\nt0 = time.time()\n")
    assert driver.main([str(f), "--no-graph", "--fix", "--fail-on-new"]) == 0
    assert "time.monotonic()" in f.read_text()
    err = capsys.readouterr().err
    assert "--fix" in err and "1 rewrite(s)" in err


def test_fix_exempts_baselined_violations(tmp_path):
    f = tmp_path / "wall.py"
    f.write_text("import time\nfresh = time.time() - mtime <= 60\nt0 = time.time()\n")
    wall = _by_rule(astrules.lint_paths([str(f)], str(tmp_path)), "wallclock")
    keep = [x for x in wall if "fresh" in x.anchor]
    fixed = astrules.fix_paths([str(f)], str(tmp_path),
                               baseline={keep[0].fingerprint: {"reason": "epoch vs mtime"}})
    assert fixed == {"wall.py": 1}
    src = f.read_text()
    assert "fresh = time.time() - mtime <= 60" in src and "t0 = time.monotonic()" in src
    committed = baseline.load(str(BASELINE))
    for rel in ("our_tree_tpu_torch/utils/devlock.py", "our_tree_tpu_torch/resilience/watchdog.py"):
        dst = tmp_path / pathlib.Path(rel).name
        shutil.copy(ROOT / rel, dst)
        before = dst.read_text()
        astrules.fix_file(str(dst), rel, baseline=committed)
        assert dst.read_text() == before, f"--fix touched baselined {rel}"


# ---------------------------------------------------------------------------
# ot-san, against the JAX package's on the same fixtures.
# ---------------------------------------------------------------------------


def _san(tmp_path, files, mod=sanrules):
    for rel, src in files.items():
        _write(tmp_path, src, rel)
    return mod.analyze_paths([str(tmp_path)], str(tmp_path))


SAN_FIXTURES = {
    "loop-stall": ({"pkg/stall.py": """
        import asyncio
        import time


        def slow():
            time.sleep(1.0)


        async def handler():
            slow()
    """}, "loop-stall", 1),
    "loop-stall-hopped": ({"pkg/stall.py": """
        import asyncio
        import time


        def slow():
            time.sleep(1.0)


        async def handler():
            await asyncio.to_thread(slow)
    """}, "loop-stall", 0),
    "executor-hop": ({"pkg/hop.py": """
        import asyncio
        import time


        def slow():
            time.sleep(1.0)


        async def handler():
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(None, slow)
    """}, "loop-stall", 0),
    "top-frame": ({"pkg/chain.py": """
        import asyncio


        def leaf():
            open("/tmp/x").read()


        def mid():
            leaf()


        async def handler():
            mid()
    """}, "loop-stall", 1),
    "card-wait": ({"pkg/card.py": """
        import torch


        async def handler(ev):
            torch.cuda.synchronize()
            ev.synchronize()
    """}, "loop-stall", 2),
    "lock-await": ({"pkg/la.py": """
        import asyncio
        import threading


        class S:
            def __init__(self):
                self._lock = threading.Lock()

            async def step(self):
                with self._lock:
                    await asyncio.sleep(0)
    """}, "lock-await", 1),
    "lock-await-asyncio": ({"pkg/la.py": """
        import asyncio


        class S:
            def __init__(self):
                self._lock = asyncio.Lock()

            async def step(self):
                async with self._lock:
                    await asyncio.sleep(0)
    """}, "lock-await", 0),
    "sync-with-asyncio-lock": ({"pkg/sw.py": """
        import asyncio


        class S:
            def __init__(self):
                self._lock = asyncio.Lock()

            def step(self):
                with self._lock:
                    return 1
    """}, "lock-await", 1),
    "lock-order": ({"pkg/a.py": """
        import threading

        from . import b

        LOCK_A = threading.Lock()


        def fwd():
            with LOCK_A:
                b.take_b()


        def take_a():
            with LOCK_A:
                pass
    """, "pkg/b.py": """
        import threading

        from . import a

        LOCK_B = threading.Lock()


        def rev():
            with LOCK_B:
                a.take_a()


        def take_b():
            with LOCK_B:
                pass
    """}, "lock-order", 1),
    "lock-order-consistent": ({"pkg/a.py": """
        import threading

        from . import b

        LOCK_A = threading.Lock()


        def fwd():
            with LOCK_A:
                b.take_b()


        def take_a():
            with LOCK_A:
                pass
    """, "pkg/b.py": """
        import threading

        from . import a

        LOCK_B = threading.Lock()


        def rev():
            with LOCK_B:
                pass


        def take_b():
            with LOCK_B:
                pass
    """}, "lock-order", 0),
    "thread-ownership-locked": ({"pkg/own.py": """
        import asyncio
        import threading

        COUNT = 0
        LOCK = threading.Lock()


        def worker():
            global COUNT
            with LOCK:
                COUNT += 1


        async def main():
            global COUNT
            threading.Thread(target=worker).start()
            with LOCK:
                COUNT = 0
    """}, "thread-ownership", 0),
    "thread-ownership": ({"pkg/own.py": """
        import asyncio
        import threading

        COUNT = 0


        def worker():
            global COUNT
            COUNT += 1


        async def main():
            global COUNT
            threading.Thread(target=worker).start()
            COUNT = 0
    """}, "thread-ownership", 1),
    "thread-ownership-annotated": ({"pkg/own.py": """
        import asyncio
        import threading

        COUNT = 0


        def worker():
            global COUNT
            COUNT += 1  # ot-san: owner=test-seam


        async def main():
            global COUNT
            threading.Thread(target=worker).start()
            COUNT = 0
    """}, "thread-ownership", 0),
    "thread-ownership-malformed": ({"pkg/bad.py": """
        import asyncio
        import threading

        COUNT = 0


        def worker():
            global COUNT
            COUNT += 1  # ot-san: onwer=test-seam


        async def main():
            global COUNT
            threading.Thread(target=worker).start()
            COUNT = 0
    """}, "thread-ownership", 2),
}


@pytest.mark.parametrize("case", sorted(SAN_FIXTURES))
def test_san_rules_match_the_reference(tmp_path, case):
    files, rule, expected = SAN_FIXTURES[case]

    def shape(findings):
        return sorted((f.rule, f.severity, f.path, f.line, f.anchor, f.message, f.fingerprint)
                      for f in _by_rule(findings, rule))

    port = shape(_san(tmp_path, files))
    assert len(port) == expected, port
    if case != "card-wait":  # the card's waits are the port's blocking seeds
        assert port == shape(_san(tmp_path, files, mod=jsanrules))


def test_san_fingerprints_stable_across_line_shift(tmp_path):
    files = {rel: src for case in ("loop-stall", "lock-await", "thread-ownership")
             for rel, src in SAN_FIXTURES[case][0].items()}
    before = _san(tmp_path, files)
    assert len(before) == 3
    after = _san(tmp_path, {rel: "# a comment\n# another\n\n" + textwrap.dedent(src)
                            for rel, src in files.items()})
    assert {f.fingerprint for f in before} == {f.fingerprint for f in after}
    assert all(f.fingerprint.startswith("san:") for f in after)


def test_san_rule_version_changes_the_fingerprint_and_reasons_migrate(tmp_path):
    old = Finding("loop-stall", "error", "m", "a.py", 3, anchor="x()", layer="san", version=1)
    new = Finding("loop-stall", "error", "m", "a.py", 3, anchor="x()", layer="san", version=2)
    assert old.fingerprint != new.fingerprint and old.fingerprint.startswith("san:loop-stall:")
    path = tmp_path / "base.json"
    baseline.write(str(path), [old])
    data = json.loads(path.read_text())
    data["findings"][0]["reason"] = "a migrated reason"
    path.write_text(json.dumps(data))
    baseline.write(str(path), [new], baseline.load(str(path)))
    assert baseline.load(str(path))[new.fingerprint]["reason"] == "a migrated reason"


def test_san_cli_runs_clean_against_committed_baseline():
    assert driver.main(["--san", "--no-graph", "--baseline", str(BASELINE),
                        "--fail-on-new"]) == 0


def test_san_keeps_the_status_surfaces_and_fleet_spawn_loop_stall_free():
    fs = sanrules.analyze_paths([str(ROOT / "our_tree_tpu_torch")], str(ROOT))
    stalls = _by_rule(fs, "loop-stall")
    assert not [f for f in stalls if f.path in ("our_tree_tpu_torch/serve/status.py",
                                                "our_tree_tpu_torch/route/status.py")]
    assert not [f for f in stalls if f.path == "our_tree_tpu_torch/route/fleet.py"
                and "ProcessWorkerHandle.start" in f.message]
    assert not _by_rule(fs, "lock-await") and not _by_rule(fs, "thread-ownership")


def test_no_module_of_the_analysis_imports_jax_or_the_reference():
    import ast

    for p in (ROOT / "our_tree_tpu_torch" / "analysis").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "our_tree_tpu"), (p.name, n)
