"""The port's ceiling probe (``our_tree_tpu_torch.harness.ceiling``) against
the reference ``scripts/vpu_ceiling.py``: ``chain_plain`` bit-exact against
``_chain_kernel`` in interpret mode, the chained carry against the
reference's ``chainrun``, and the probe's CLI line against the reference's
keys and op-count formula. Integer logic: the tolerance is zero."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu_torch.harness import ceiling
from our_tree_tpu_torch.ops import cuda_aes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "vpu_ceiling_reference", os.path.join(ROOT, "scripts", "vpu_ceiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VPU = _reference()
LANES = 512  # one (8, 512) tile


def _x(seed):
    return np.random.default_rng(seed).integers(0, 2**32, (8, LANES), dtype=np.uint64).astype(
        np.uint32)


def _plain(x, chain, ilp):
    return ceiling.chain_plain(torch.from_numpy(x.view(np.int32)), chain, ilp).numpy().view(
        np.uint32)


@pytest.mark.parametrize("chain,ilp", [(c, i) for _n, c, i in ceiling.REGIMES]
                         + [(2, 2), (3, 2), (17, 2)])
def test_chain_plain_matches_reference_kernel(chain, ilp):
    x = _x(100 * chain + ilp)
    ref = np.asarray(VPU._build(chain, LANES, VPU.TILE, True, ilp)(jnp.asarray(x)))
    np.testing.assert_array_equal(_plain(x, chain, ilp), ref)


@pytest.mark.parametrize("chain,ilp", [(1, 1), (128, 4)])
def test_chained_carry_matches_reference_chainrun(monkeypatch, chain, ilp):
    """k = 1 + 3 passes: the port's carry (``x ^ acc``, u32 sum mod 2^32)
    ends on the digest of the reference's own ``chainrun``, captured from
    its ``chained_time`` as that function jits it."""
    x = _x(7 + chain)
    fn = VPU._build(chain, LANES, VPU.TILE, True, ilp)
    jitted = []
    real_jit = jax.jit

    def spy(f, *a, **kw):
        out = real_jit(f, *a, **kw)
        jitted.append(out)
        return out

    monkeypatch.setattr(jax, "jit", spy)
    VPU.chained_time(fn, jnp.asarray(x), iters=3)
    monkeypatch.setattr(jax, "jit", real_jit)
    assert len(jitted) == 1
    want = int(jitted[0](jnp.asarray(x), jnp.uint32(4)))
    got = ceiling.chainrun(lambda v: ceiling.chain_plain(v, chain, ilp),
                           torch.from_numpy(x.view(np.int32).reshape(-1)), 4)
    assert int(got) & 0xFFFFFFFF == want
    # chained_time runs the same carry and returns a positive per-call time.
    t = ceiling.chained_time(lambda v: ceiling.chain_plain(v, chain, ilp),
                             torch.from_numpy(x.view(np.int32)), 3)
    assert t > 0


def _probe(*args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update({"PYTHONPATH": ROOT, "OT_VPU_BYTES": "65536", "OT_VPU_ITERS": "1",
                **(env_extra or {})})
    return subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.harness.ceiling", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_probe_cli_on_cpu_prints_reference_keys():
    res = _probe("--device", "cpu")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["platform"] == "cpu" and out["device_kind"] == "cpu"
    n = ceiling.words(65536)
    assert out["bytes"] == n * 4 == 65536
    for name, chain, ilp in ceiling.REGIMES:
        r = out[name]
        assert set(r) == {"chain", "ilp", "sec", "t_ops_per_s", "mem_gb_per_s"}
        assert (r["chain"], r["ilp"]) == (chain, ilp)
        # The reference's count (scripts/vpu_ceiling.py:142) and traffic.
        ops = n * (ilp * 2 * chain + 2 * ilp + 2 * ilp - 1)
        assert r["t_ops_per_s"] == pytest.approx(ops / r["sec"] / 1e12, rel=1e-12)
        assert r["mem_gb_per_s"] == pytest.approx(n * 8 / r["sec"] / 1e9, rel=1e-12)
        assert any(line.startswith(f"{name} ") for line in lines)
    assert lines[0].startswith("# 0 MiB u32, 16384 words, device=cpu/cpu")


def test_probe_without_card_exits_nonzero_and_prints_no_result():
    res = _probe()
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_words_follow_reference_rounding():
    for nbytes in (4, 65536, 65536 + 100, 64 << 20, (64 << 20) + 12345):
        lanes = max(nbytes // 4 // 8, VPU.TILE)
        lanes -= lanes % VPU.TILE
        assert ceiling.words(nbytes) == lanes * 8


def test_wrapper_checks_and_cpu_route(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel build")

    monkeypatch.setattr(ceiling.cuda_build, "load", no_build)
    monkeypatch.setattr(ceiling.chain, "launches", 0)
    x = torch.arange(40, dtype=torch.int32)
    for _name, c, i in ceiling.REGIMES:
        assert torch.equal(ceiling.chain(x, c, i), ceiling.chain_plain(x, c, i))
    assert ceiling.chain.launches == 0
    with pytest.raises(ValueError, match="regimes"):
        ceiling.chain(x, 2, 2)
    with pytest.raises(TypeError):
        ceiling.chain(x.long(), 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ceiling.chain(x.reshape(8, 5).t(), 1, 1)
    with pytest.raises(ValueError, match="no kernel"):
        ceiling.chain(torch.empty(8, dtype=torch.int32, device="meta"), 1, 1)
    # The launch counter shares the kernels' lock.
    cuda_aes.count_launch(ceiling.chain)
    assert ceiling.chain.launches == 1
