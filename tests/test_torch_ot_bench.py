"""The port's C sweep (``runtime/csrc/ot_bench_main.c``, built by
``runtime.native.ot_bench_path``): the ``--backend=c`` rows in the JAX
package's ``ot_bench`` format, with the same exact mode matching, and the
``--backend=gpu --device=cpu`` dispatch through the embedded interpreter at
toy scale against a direct ``python -m our_tree_tpu_torch.harness.bench``
run on the same arguments."""

import os
import pathlib
import re
import shutil
import subprocess
import sys
import sysconfig

import pytest

import our_tree_tpu.runtime as jrt
from our_tree_tpu_torch.runtime import native

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROW = re.compile(r"^((?:C AES-\d+ [A-Z-]+|RC4), \d+, \d+, )((?:\d+, )*)$")


def _rows(out: str) -> list[tuple[str, int]]:
    """(row head, number of times) of each CSV row; other lines as they are
    with their numbers masked."""
    rows = []
    for line in out.splitlines():
        if m := ROW.match(line):
            rows.append((m.group(1), m.group(2).count(",")))
        elif line.strip():
            rows.append((re.sub(r"\d+", "N", line), 0))
    return rows


@pytest.mark.parametrize("modes", ["ecb-dec,cbc-dec", "ecb,ctr,rc4"])
def test_c_rows_match_the_jax_ot_bench(modes):
    csrc = pathlib.Path(jrt.__file__).parent / "csrc"
    subprocess.run(["make", "-C", str(csrc), "ot_bench"], check=True, capture_output=True)
    argv = ["--backend=c", "--sizes=1", "--threads=1,2", "--iters=2", f"--modes={modes}"]
    want = subprocess.run([str(csrc / "ot_bench"), *argv], check=True, capture_output=True,
                          text=True).stdout
    exe = native.ot_bench_path()
    got = subprocess.run([str(exe), *argv], check=True, capture_output=True, text=True).stdout
    assert _rows(got) == _rows(want)
    heads = [h for h, _ in _rows(got)]
    if modes == "ecb-dec,cbc-dec":
        assert "C AES-256 ECB-DEC, 1048576, 1, " in heads and not any(
            h.startswith(("C AES-256 ECB, ", "C AES-256 CTR, ")) for h in heads)
    else:
        assert "RC4, 1048576, 2, " in heads


def test_ot_bench_refuses_an_unknown_backend():
    exe = native.ot_bench_path()
    r = subprocess.run([str(exe), "--backend=tpu", "--sizes=1"], capture_output=True, text=True)
    assert r.returncode == 1 and "unknown --backend=tpu" in r.stderr and r.stdout == ""


def _masked(out: str) -> list[str]:
    """The lines with the times masked: a row's fields after its worker
    count, a keygen line's time, a line of times alone, a ``# derived:``
    line whole."""
    lines = []
    for line in out.strip().splitlines():
        if line.startswith("# derived:"):
            line = "# derived:"
        elif m := re.match(r"^([^,]*[A-Za-z][^,]*, \d+, \d+,|Generated [^,]* in )(.*)$", line):
            line = m.group(1) + re.sub(r"[\d.e+-]+", "N", m.group(2))
        elif re.fullmatch(r"[\d.e+\-, ]+", line):
            line = re.sub(r"[\d.e+-]+", "N", line)
        lines.append(line)
    return lines


@pytest.mark.slow
def test_ot_bench_gpu_dispatch_on_the_cpu():
    """``ot_bench --backend=gpu --device=cpu`` hands the sweep to the port's
    harness through the embedded interpreter: the same lines as a direct
    harness run, but for the times."""
    if not shutil.which("python3-config"):
        pytest.skip("no python3-config: ot_bench builds without embedding")
    exe = native.ot_bench_path()
    assert native.ot_bench_embeds(exe)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), sysconfig.get_paths()["purelib"]]
        + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))}
    r = subprocess.run([str(exe), "--backend=gpu", "--device=cpu", "--sizes=0.0625",
                        "--threads=1", "--iters=1", "--keybits=128", "--modes=ctr,rc4"],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, (r.stdout, r.stderr)
    direct = subprocess.run(
        [sys.executable, "-m", "our_tree_tpu_torch.harness.bench", "--backend", "gpu",
         "--device", "cpu", "--sizes-mb", "0.0625", "--workers", "1", "--iters", "1",
         "--keybits", "128", "--modes", "ctr,rc4"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert direct.returncode == 0, direct.stderr
    assert _masked(r.stdout) == _masked(direct.stdout)
    assert any(ln.startswith("GPU AES-128 CTR, 65536, 1, ") for ln in r.stdout.splitlines())
