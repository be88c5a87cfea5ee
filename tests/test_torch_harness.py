"""The port's sweep harness (``our_tree_tpu_torch.harness.bench``) on the CPU
against the JAX package's (``our_tree_tpu.harness.bench``, engine ``jnp``)
run with the same flags and seed: every output line equal once the times and
rates are masked (row names, byte and worker counts, the number of times a
row, the keygen, self-test, parity and XOR-check lines), under all three
``--timing`` values; each ``GpuBackend`` method bit-exact against
``TpuBackend``'s on the same inputs; the ``--backend c`` rows; the port
bench's ``OT_BENCH_OP=ecb|ecb-dec`` digests against the root ``bench.py``'s.

The port runs ``--engine ttable``, the counterpart of the reference's ``jnp``
T-table engine, whose chained encrypt runs on the CPU as a host loop. A
``# derived:`` line is masked whole: whether a row's best time clears the
chained timing's 1 µs floor (and so whether it prints a rate or ``n/a``)
depends on the clock."""

import contextlib
import importlib.util
import io
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from our_tree_tpu.harness import backends as jbackends
from our_tree_tpu.harness import bench as jbench
from our_tree_tpu.resilience import degrade as jdegrade
from our_tree_tpu_torch import bench as port_bench
from our_tree_tpu_torch.harness import backends, bench
from our_tree_tpu_torch.resilience import degrade
from our_tree_tpu_torch.runtime import native

ROOT = pathlib.Path(__file__).resolve().parent.parent
COMMON = ["--sizes-mb", "0.0625", "--workers", "1", "--iters", "2"]
MODE_SETS = {"modes": ["--modes", "ecb,ecb-dec,ctr,cbc,cbc-dec,cfb128,rc4"],
             "batch": ["--modes", "cbc-batch,rc4-batch", "--streams", "4"]}
_RUNS: dict = {}


#: A number as the harness prints a time: an integer, a decimal or an
#: exponent form.
_NUM = re.compile(r"\d+(?:\.\d+)?(?:e[-+]?\d+)?")
#: A CSV row: its name, bytes and workers (compared as printed), then its
#: times.
_ROW = re.compile(r"^([^,]*[A-Za-z][^,]*, \d+, \d+,)(.*)$")
#: A keygen line: its text and key count as printed, then its time.
_KEYGEN = re.compile(r"^(Generated [^,]* in )(.*)$")


def _masked(text: str, jax_side: bool) -> list[str]:
    """The lines with only the timing fields masked: a row's times after its
    worker count, a keygen line's time, a line of times alone and the whole
    of a ``# derived:`` line. Row names, key bits, byte, worker and stream
    counts and every check line are compared as printed."""
    out = []
    for line in text.strip().splitlines():
        if jax_side and line.startswith("TPU "):
            line = "GPU " + line[4:]
        if line.startswith("# derived:"):
            line = "# derived:"
        elif m := _ROW.match(line) or _KEYGEN.match(line):
            line = m.group(1) + _NUM.sub("N", m.group(2))
        elif re.fullmatch(r"[\d.e+\-, ]+", line):
            line = _NUM.sub("N", line)
        out.append(line)
    return out


def _main(fn, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


@pytest.fixture(autouse=True)
def _native_prep(monkeypatch):
    monkeypatch.setenv("OT_ARC4_PREP", "native")
    monkeypatch.delenv("OT_FAULTS", raising=False)
    monkeypatch.delenv("OT_SWEEP_JOURNAL", raising=False)
    # Both demotion ledgers are process-global: an earlier test in the same
    # worker (tests/test_ranking.py demotes a fake engine) would otherwise
    # add its "# degraded:" line to this sweep's output.
    degrade.clear()
    jdegrade.clear()


def _run_both(modes: str, timing: str):
    key = (modes, timing)
    if key not in _RUNS:
        argv = COMMON + MODE_SETS[modes] + ["--timing", timing]
        jrc, jout = _main(jbench.main, argv + ["--backend", "tpu", "--engine", "jnp"])
        prc, pout = _main(bench.main, argv + ["--device", "cpu", "--engine", "ttable"])
        _RUNS[key] = (jrc, jout, prc, pout)
    return _RUNS[key]


@pytest.mark.parametrize("timing", ["e2e", "device", "device-sync"])
@pytest.mark.parametrize("modes", sorted(MODE_SETS))
def test_sweep_lines_match_reference(modes, timing):
    jrc, jout, prc, pout = _run_both(modes, timing)
    assert jrc == prc == 0
    assert _masked(pout, False) == _masked(jout, True)
    rows = [ln for ln in pout.splitlines() if ln.startswith(("GPU ", "RC4"))]
    assert rows, pout
    if modes == "modes":
        assert pout.strip().splitlines()[-3:] == [f"ARC4 test #{i}: passed" for i in (1, 2, 3)]
    else:
        assert "RC4-batch parity vs single-stream: passed" in pout


def test_c_backend_rows_match_reference(monkeypatch):
    monkeypatch.setenv("OT_C_FORCE_PORTABLE", "1")
    argv = COMMON + ["--modes", "ecb,ctr,rc4", "--backend", "c"]
    jrc, jout = _main(jbench.main, argv)
    prc, pout = _main(bench.main, argv + ["--device", "cpu"])
    assert jrc == prc == 0
    assert _masked(pout, False) == _masked(jout, False)
    assert pout.splitlines()[0].startswith("C AES-256 ECB, 65536, 1, ")


def _inputs(nbytes=65536, seed=3):
    """The sweeps' shapes (64 KiB), so the reference reuses their compiles."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, 32, dtype=np.uint8).tobytes(),
            rng.integers(0, 256, nbytes, dtype=np.uint8),
            rng.integers(0, 256, 16, dtype=np.uint8))


def test_backend_methods_match_reference():
    key, msg, iv = _inputs()
    nonce = np.frombuffer(bytes.fromhex("fffffffffffffffffffffffffffffff0"), np.uint8)
    gb = backends.GpuBackend("ttable", "cpu")
    tb = jbackends.TpuBackend("jnp")
    gctx, tctx = gb.make_key(key), tb.make_key(key)
    gw, tw = gb.stage_words(msg), tb.stage_words(msg)
    np.testing.assert_array_equal(gw.numpy().view(np.uint32), np.asarray(tw))

    def eq(g, t):
        got = bench._host(gb.block_until_ready(g))
        if got.dtype == np.int32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, np.asarray(tb.block_until_ready(t)))

    eq(gb.ecb(gctx, gw, 1), tb.ecb(tctx, tw, 1))
    eq(gb.ecb_dec(gctx, gw, 1), tb.ecb_dec(tctx, tw, 1))
    eq(gb.ctr(gctx, gw, gb.ctr_be_words(nonce), 1), tb.ctr(tctx, tw, tb.ctr_be_words(nonce), 1))
    for name in ("cbc", "cfb128", "cbc_dec"):
        eq(getattr(gb, name)(gctx, gw, gb.iv_words(iv), 1),
           getattr(tb, name)(tctx, tw, tb.iv_words(iv), 1))
    batch = msg.reshape(4, -1)
    ivs = np.random.default_rng(4).integers(0, 256, (4, 16), dtype=np.uint8)
    eq(gb.cbc_batch(gctx, gb.stage_batch_words(batch), gb.stage_batch_words(ivs), 1),
       tb.cbc_batch(tctx, tb.stage_batch_words(batch), tb.stage_batch_words(ivs), 1))
    odd = msg[:16 * 37 + 9]
    np.testing.assert_array_equal(gb.ctr_stream(gctx, odd, nonce, 160, 1),
                                  tb.ctr_stream(tctx, odd, nonce, 160, 1))
    keys = [b"a" * 16, b"bb", bytes(range(16))]
    eq(gb.arc4_prep_batch(gb.arc4_batch_states(keys), 300, 1),
       tb.arc4_prep_batch(tb.arc4_batch_states(keys), 300, 1))
    ks = gb.arc4_setup_prep(key[:16], msg.size)
    np.testing.assert_array_equal(ks, tb.arc4_setup_prep(key[:16], msg.size))
    eq(gb.arc4_crypt(gb.to_device(msg), gb.to_device(ks), 1),
       tb.arc4_crypt(tb.to_device(msg), tb.to_device(ks), 1))
    # The chained difference on the CPU: iters whole µs, each at least the floor.
    small = gb.stage_words(msg[:4096])
    times = gb.chained_device_times_us(lambda w, acc: gb.ecb(gctx, w ^ acc, 1), small, 3, 512)
    assert len(times) == 3 and all(isinstance(t, int) and t >= gb.FLOOR_US for t in times)
    assert gb.launch_counts() == {name: 0 for name in gb.launch_counts()}


def test_arc4_prep_device_and_demotion(monkeypatch, capsys):
    """OT_ARC4_PREP=device takes the ARC4 kernel's path; under auto a failed
    native build is the announced demotion, never silent; native raises."""
    key, msg, _ = _inputs()
    monkeypatch.setenv("OT_ARC4_PREP", "device")
    dev = backends.GpuBackend("auto", "cpu")
    np.testing.assert_array_equal(dev.arc4_setup_prep(key[:16], 100),
                                  native.NativeARC4(key[:16]).prep(100))

    def broken():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(native, "load", broken)
    monkeypatch.setenv("OT_ARC4_PREP", "native")
    with pytest.raises(RuntimeError, match="no compiler"):
        backends.GpuBackend("auto", "cpu")
    monkeypatch.setenv("OT_ARC4_PREP", "auto")
    rc, out = _main(bench.main, COMMON + ["--modes", "rc4", "--device", "cpu"])
    assert rc == 0 and out.strip().splitlines()[-1] == "# degraded: native->device"
    assert "keygen rows will time the ARC4 kernel" in capsys.readouterr().err
    monkeypatch.setenv("OT_ARC4_PREP", "jax")
    with pytest.raises(ValueError, match="OT_ARC4_PREP"):
        backends.GpuBackend("auto", "cpu")


def test_refusals(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="torch.distributed.run --nproc-per-node 2 .*Multi-device"):
        bench.main(COMMON[:2] + ["--workers", "2", "--iters", "1", "--modes", "ecb",
                                 "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown backend"):
        backends.make_backend("tpu")
    with pytest.raises(ValueError):
        bench._mode_crypt(None, "xts", None, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(COMMON + ["--modes", "ecb"])
    # --profile DIR captures the sweep with torch.profiler into DIR.
    rc, _ = _main(bench.main, COMMON + ["--modes", "ecb", "--device", "cpu",
                                        "--iters", "1", "--profile", str(tmp_path / "prof")])
    assert rc == 0 and (tmp_path / "prof" / "trace.json").exists()


def _load_root_bench(monkeypatch, op):
    monkeypatch.setenv("OT_BENCH_OP", op)
    spec = importlib.util.spec_from_file_location(f"rootbench_{op}", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("op", ["ecb", "ecb-dec"])
def test_bench_op_digest_matches_root_bench(monkeypatch, op):
    for k, v in {"OT_BENCH_ENGINE": "jnp", "OT_BENCH_BYTES": "65536",
                 "OT_BENCH_ITERS": "2", "OT_BENCH_REPS": "1"}.items():
        monkeypatch.setenv(k, v)
    root = _load_root_bench(monkeypatch, op)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        root._measure_and_report()
    want = json.loads(buf.getvalue().strip().splitlines()[-1])
    got = port_bench.run(device="cpu")
    digest = re.search(r"digest=(0x[0-9a-f]+)", want["metric"]).group(1)
    assert f"digest={digest}" in got["metric"]
    assert got["metric"].startswith(f"AES-128-{op.upper()} throughput, 0 MiB buffer, 1 cpu")
    assert got["vs_baseline"] == round(got["value"] / 0.551, 3)
    # The digest is the chain's: the reference's jnp chain, step by step.
    ctx = port_bench.Chain(65536, "cpu", op)
    assert int(ctx.run(3)) & 0xFFFFFFFF == int(digest, 16)
