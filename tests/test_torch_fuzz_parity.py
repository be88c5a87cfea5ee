"""The port's parity fuzzer (``our_tree_tpu_torch/scripts/fuzz_parity.py``)
against the JAX package and the reference's own fuzzer, on the CPU.

* The port's fuzzer passes with the plain and T-table engines and the native
  tier against an oracle over the JAX package (``JaxOracle``: the JAX
  ``AES(engine="jnp")`` at one padded shape a mode, so a case costs no XLA
  compile of its own).
* The same seed draws the same cases in both fuzzers: the reference's
  ``scripts/fuzz_parity.main`` runs with ``gen_golden.Oracle`` and
  ``build_oracle`` replaced by the same adapter and the JAX ``AES`` wrapped
  by a recorder; the port's runs with its ``AES`` wrapped by one; the
  oracle calls and the engine calls must be equal, call for call.
* Planted faults in the engine under test exit 1 with the case's tag; an
  armed ``dispatch_hang`` debits the deadline without sleeping.
* The native oracle's derived CTR resume state equals the JAX ``crypt_ctr``'s
  over chunked calls, a quarter near the 2^128 wrap.
* ``--sharded`` in a two-rank gloo world on the CPU
  (``tests/torch_dist_ranks.py``).

Nothing of the JAX package or ``scripts/`` is edited: the adapters live
here, and the reference's fuzzer is only monkeypatched for the run.
"""

import os
import pathlib
import re
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from our_tree_tpu.models import aes as jaes
from our_tree_tpu.models import arc4 as jarc4
from our_tree_tpu_torch.models import aes as paes
from our_tree_tpu_torch.resilience import faults, watchdog
from our_tree_tpu_torch.scripts import fuzz_parity, oracle as poracle

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "torch_dist_ranks.py"
#: The adapter's one shape a mode: every case of these tests fits in it.
BUCKET = 4096
SMALL = ["--iters", "30", "--max-bytes", str(BUCKET)]
#: The JAX context class, held before any test wraps the module's name.
JAX_AES = jaes.AES


def _u8(b) -> np.ndarray:
    return np.frombuffer(bytes(b), dtype=np.uint8)


class JaxOracle:
    """``Oracle``'s surface over the JAX package: the bytes from
    ``our_tree_tpu.models.aes.AES(key, engine="jnp")`` (and ``ARC4``), each
    mode's stream padded to ``BUCKET`` bytes so that one compiled shape
    serves every case. A chained stream's bytes do not depend on what comes
    after them, so the padding only adds bytes that are cut off; the final
    states are read from the padded stream: CBC's last ciphertext block,
    CFB128's ciphertext of the partial block and the keystream beyond it,
    CTR's offset, advanced counter and last keystream block."""

    name = "the JAX package (AES engine=jnp, ARC4)"

    def __init__(self):
        self._ctx = {}

    def _aes(self, key):
        if key not in self._ctx:
            self._ctx[key] = JAX_AES(key, engine="jnp")
        return self._ctx[key]

    @staticmethod
    def _pad(data: bytes) -> np.ndarray:
        if len(data) > BUCKET:
            raise ValueError(f"the adapter takes at most {BUCKET} bytes, got {len(data)}")
        out = np.zeros(BUCKET, np.uint8)
        out[:len(data)] = _u8(data)
        return out

    def ecb(self, key, data, encrypt):
        mode = jaes.AES_ENCRYPT if encrypt else jaes.AES_DECRYPT
        return self._aes(key).crypt_ecb(mode, self._pad(data)).tobytes()[:len(data)]

    def cbc(self, key, iv, data, encrypt):
        mode = jaes.AES_ENCRYPT if encrypt else jaes.AES_DECRYPT
        out, _ = self._aes(key).crypt_cbc(mode, _u8(iv).copy(), self._pad(data))
        out = out.tobytes()[:len(data)]
        last = (out if encrypt else bytes(data))[-16:] if data else bytes(iv)
        return out, last

    def cfb128(self, key, iv, chunks, encrypt):
        data = b"".join(bytes(c) for c in chunks)
        n, r = len(data), len(data) % 16
        inp = self._pad(data)
        mode = jaes.AES_ENCRYPT if encrypt else jaes.AES_DECRYPT
        out, _, _ = self._aes(key).crypt_cfb128(mode, 0, _u8(iv).copy(), inp)
        ct = (out if encrypt else inp).tobytes()
        if n == 0:
            reg = bytes(iv)
        elif r == 0:
            reg = ct[n - 16:n]
        else:
            b = n - r
            reg = ct[b:n] + (out[b + r:b + 16] ^ inp[b + r:b + 16]).tobytes()
        flat, outs, pos = out.tobytes(), [], 0
        for c in chunks:
            outs.append(flat[pos:pos + len(c)])
            pos += len(c)
        return outs, r, reg

    def ctr(self, key, nonce, chunks):
        data = b"".join(bytes(c) for c in chunks)
        n = len(data)
        ks, _, _, _ = self._aes(key).crypt_ctr(0, _u8(nonce).copy(), np.zeros(16, np.uint8),
                                               np.zeros(BUCKET, np.uint8))
        flat = (_u8(data) ^ ks[:n]).tobytes()
        outs, pos = [], 0
        for c in chunks:
            outs.append(flat[pos:pos + len(c)])
            pos += len(c)
        if n == 0:
            return outs, 0, bytes(nonce), bytes(16)
        used = -(-n // 16)
        nc = ((int.from_bytes(bytes(nonce), "big") + used) % (1 << 128)).to_bytes(16, "big")
        return outs, n % 16, nc, ks[16 * (used - 1):16 * used].tobytes()

    def arc4_keystream(self, key, chunks):
        ctx = jarc4.ARC4(bytes(key))
        outs = [ctx.prep(n).tobytes() for n in chunks]
        return outs, (ctx.x, ctx.y, bytes(ctx.m))


@pytest.fixture(scope="module")
def jax_oracle():
    return JaxOracle()


def _drop(a):
    return bytes(np.asarray(a, np.uint8).tobytes()) if not isinstance(a, (int, bytes)) else a


class Recorder:
    """Wraps an oracle: every call and its arguments, in order."""

    def __init__(self, inner, log):
        self.inner, self.log, self.name = inner, log, inner.name

    def __getattr__(self, method):
        fn = getattr(self.inner, method)

        def call(*args):
            self.log.append((method,) + tuple(
                [_drop(x) for x in a] if isinstance(a, list) else _drop(a) for a in args))
            return fn(*args)

        return call


def recording_aes(log, answer):
    """A stand-in for an ``AES`` class: each construction and call goes into
    ``log`` as (method, key, arguments), and ``answer(key)``'s context
    answers it."""
    class RecordingAES:
        def __init__(self, key, engine="auto", device=None):
            self._key = bytes(key)
            self._ctx = answer(self._key)
            log.append(("init", self._key))

        def __getattr__(self, method):
            fn = getattr(self._ctx, method)

            def call(*args):
                log.append((method, self._key) + tuple(_drop(a) for a in args))
                return fn(*args)

            return call

    return RecordingAES


def test_raises_without_a_card(monkeypatch):
    """The default ``--device cuda`` raises without a card, never falls back."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz_parity.main(["--iters", "1"])


def test_native_refused_when_the_native_tier_is_the_oracle(capsys):
    rc = fuzz_parity.main(["--device", "cpu", "--native", "--iters", "1"])
    assert rc == 2
    assert "IS the oracle" in capsys.readouterr().err


@pytest.mark.parametrize("seed", [1, 7])
def test_port_fuzzer_passes_against_the_jax_package(seed, jax_oracle, capsys):
    rc = fuzz_parity.main(["--device", "cpu", "--engines", "bitslice,ttable", "--native",
                           "--seed", str(seed), *SMALL], oracle=jax_oracle)
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = out.splitlines()
    assert lines[0] == f"# oracle: {JaxOracle.name}"
    assert "FUZZ PASS: 30 randomized configs" in out
    assert '"cases": 30' in lines[-1] and '"native": true' in lines[-1]


@pytest.mark.parametrize("seed", [3, 11])
def test_same_seed_draws_the_same_cases_in_both_fuzzers(seed, jax_oracle, monkeypatch):
    """40 cases: the oracle calls (each case's key, mode, direction, data,
    IV and chunks) and the engine calls of both fuzzers, call for call."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import fuzz_parity as ref_fuzz
        import gen_golden
    finally:
        sys.path.remove(str(ROOT / "scripts"))

    argv = ["--iters", "40", "--seed", str(seed), "--max-bytes", str(BUCKET)]
    # The T-table engine answers for both sides: the recorders compare the
    # calls, (a) compares the answers.
    real_aes = paes.AES

    def answer(key):
        return real_aes(key, engine="ttable", device="cpu")

    ref_oracle, ref_calls = [], []
    monkeypatch.setattr(gen_golden, "build_oracle", lambda reference: None)
    monkeypatch.setattr(gen_golden, "Oracle", lambda lib: Recorder(jax_oracle, ref_oracle))
    monkeypatch.setattr(jaes, "AES", recording_aes(ref_calls, answer))
    # The reference clears XLA's caches every 25 cases; keep the adapter's one
    # compiled shape a mode across it.
    monkeypatch.setattr(jax, "clear_caches", lambda: None)
    monkeypatch.setattr(sys, "argv", ["fuzz_parity.py", *argv])
    assert ref_fuzz.main() == 0
    monkeypatch.undo()

    port_oracle, port_calls = [], []
    monkeypatch.setattr(paes, "AES", recording_aes(port_calls, answer))
    rc = fuzz_parity.main(["--device", "cpu", "--engines", "ttable", *argv],
                          oracle=Recorder(jax_oracle, port_oracle))
    assert rc == 0
    assert len(ref_oracle) >= 40 and port_oracle == ref_oracle
    assert len(ref_calls) > 40 and port_calls == ref_calls


def _planted(kind):
    """A port ``AES`` whose answers carry one planted fault."""
    class Faulty(paes.AES):
        def crypt_ecb(self, mode, data):
            out = super().crypt_ecb(mode, data)
            if kind == "output byte":
                out[0] ^= 1
            return out

        def crypt_cfb128(self, mode, iv_off, iv, data):
            out, off, reg = super().crypt_cfb128(mode, iv_off, iv, data)
            return out, ((off + 1) % 16 if kind == "cfb iv_off" else off), reg

        def crypt_ctr(self, nc_off, nonce_counter, stream_block, data):
            out, off, nc, sb = super().crypt_ctr(nc_off, nonce_counter, stream_block, data)
            if kind == "ctr stream block" and off:  # the call ends mid-block: a seam
                sb = sb.copy()
                sb[0] ^= 0x80
            return out, off, nc, sb

    return Faulty


@pytest.mark.parametrize("kind,pattern", [
    ("output byte", r"PARITY FAIL \(output\) \[ttable\] case \d+: ecb (enc|dec) k\d+ n=\d+ "
                    r"seed=5$"),
    ("cfb iv_off", r"PARITY FAIL \((output|resume state)\) \[ttable\] case \d+: cfb128 "
                   r"(enc|dec) k\d+ n=\d+ chunks=\[[\d, ]+\] seed=5"),
    ("ctr stream block", r"PARITY FAIL \((output|resume state)\) \[ttable\] case \d+: ctr "
                         r"(enc|dec) k\d+ n=\d+ chunks=\[[\d, ]+\] seed=5"),
])
def test_planted_faults_fail_with_the_case_tag(kind, pattern, monkeypatch, capsys):
    monkeypatch.setattr(paes, "AES", _planted(kind))
    rc = fuzz_parity.main(["--device", "cpu", "--engines", "ttable", "--seed", "5", *SMALL])
    err = capsys.readouterr().err
    assert rc == 1
    assert re.search(pattern, err, re.M), err


def test_dispatch_hang_debits_the_deadline_without_sleeping(monkeypatch, capsys):
    monkeypatch.setenv("OT_FAULTS", "dispatch_hang:1")
    monkeypatch.delenv("OT_HANG_S", raising=False)
    faults.reset()
    hangs = watchdog.hangs_injected()
    try:
        t0 = time.monotonic()
        rc = fuzz_parity.main(["--device", "cpu", "--engines", "ttable", "--deadline", "1",
                               "--iters", "1000"])
        took = time.monotonic() - t0
    finally:
        monkeypatch.delenv("OT_FAULTS")
        faults.reset()
    out = capsys.readouterr().out
    assert rc == 0 and took < 5, (took, out)
    assert "# deadline reached after 0 cases" in out and "FUZZ PASS: 0 " in out
    assert watchdog.hangs_injected() == hangs + 1


def test_native_ctr_resume_state_equals_the_jax_crypt_ctr():
    """50 random chunked CTR runs (lengths up to 40 bytes, so the JAX side
    compiles few shapes), a quarter from nonces near the 2^128 wrap."""
    native = poracle.NativeOracle()
    rng = np.random.default_rng(2025)
    for case in range(50):
        key = rng.integers(0, 256, int(rng.choice([16, 24, 32])), np.uint8).tobytes()
        if case % 4 == 0:
            nonce = np.full(16, 0xFF, np.uint8)
            nonce[-1] = rng.integers(0xFC, 0x100)
            cut = int(rng.integers(0, 16))
            nonce[:cut] = rng.integers(0, 256, cut, np.uint8)
        else:
            nonce = rng.integers(0, 256, 16, np.uint8)
        n = int(rng.integers(1, 41))
        data = rng.integers(0, 256, n, np.uint8)
        cuts = sorted(set(int(c) for c in rng.integers(1, n, int(rng.integers(0, 3)))))
        parts = np.split(data, cuts) if n > 1 else [data]
        a = jaes.AES(key, engine="jnp")
        outs, off, nc, sb = [], 0, nonce.copy(), np.zeros(16, np.uint8)
        for p in parts:
            o, off, nc, sb = a.crypt_ctr(off, nc, sb, p)
            outs.append(o.tobytes())
        want = (outs, int(off), bytes(nc), bytes(sb))
        got = native.ctr(key, nonce.tobytes(), [p.tobytes() for p in parts])
        assert (got[0], got[1], got[2], got[3]) == want, (case, nonce.tobytes().hex(), n, cuts)


def test_sharded_fuzz_in_a_two_rank_gloo_world(tmp_path):
    world = 2
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    args = ["--device", "cpu", "--sharded", "--engines", "ttable", "--iters", "8",
            "--max-bytes", "2048", "--seed", "11"]
    procs = [subprocess.Popen([sys.executable, str(RANKS), "fuzz", str(r), str(world),
                               str(tmp_path / "store"), str(tmp_path), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=180)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, [e[-3000:] for e in errs]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    outs = [str(r["fuzz.stdout"]) for r in ranks]
    assert [int(r["fuzz.rc"]) for r in ranks] == [0] * world, outs
    assert "FUZZ PASS: 8 randomized configs" in outs[0]
    import json
    lines = [json.loads(o.strip().splitlines()[-1])["fuzz"] for o in outs]
    assert [f["rank"] for f in lines] == [0, 1] and all(f["world"] == 2 for f in lines)
    assert lines[0]["cases"] == lines[0]["sharded_cases"] == 8
