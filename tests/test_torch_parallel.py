"""The port's multi-device layer (``our_tree_tpu_torch.parallel``) in gloo
worlds of 1, 2 and 4 CPU ranks against the JAX package's
(``our_tree_tpu.parallel``) on a virtual mesh of the same size.

Each world is one launch of ``tests/torch_dist_ranks.py`` a rank, spawned
once for the module; its ranks import the port only. Every case is
bit-exact (integer ciphers, no tolerance) four ways: the gathered sharded
output on every rank, that rank's unsharded port call, the JAX package's
sharded function on ``make_mesh(n)`` over the 8 virtual CPU devices
(``engine="jnp"``), and the unsharded JAX function. Each sharded function
meets the JAX package's at every mesh size through one case (``CASES``); its
other shapes and directions (``VARIANTS``: the padding paths, flat streams,
decrypt direction) meet the unsharded JAX function, which
``tests/test_parallel.py`` holds equal to the JAX sharded one. The refusals are the
JAX package's: each is raised exactly where the JAX function raises on the
same global input. Last, the sweep under two ranks prints the JAX harness's
lines at ``--workers 1,2`` but the times.
"""

import contextlib
import io
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu import parallel as jpar
from our_tree_tpu.harness import bench as jbench
from our_tree_tpu.models import aes as jaes
from our_tree_tpu.models import arc4 as jarc4
from our_tree_tpu.resilience import degrade as jdegrade
from our_tree_tpu.utils import packing as jpacking
from our_tree_tpu_torch.models import arc4 as parc4

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "torch_dist_ranks.py"
WORLDS = (1, 2, 4)
#: Seconds a world may take; its ranks are killed past it.
LAUNCH_TIMEOUT = 180
KEY = bytes(range(16))
#: The JAX package's results by (case, mesh size): a case's two outputs come
#: from one call.
_JAX: dict = {}


def launch(mode: str, world: int, tmp: pathlib.Path):
    """Start ``world`` rank processes of ``torch_dist_ranks.py``; returns a
    function that waits for them (killing them all past the timeout) and
    returns each rank's npz as a dict."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(RANKS), mode, str(r), str(world),
                               str(tmp / "store"), str(tmp)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]

    def wait():
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=LAUNCH_TIMEOUT)
                errs.append(err)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, e[-3000:]) for r, (p, e) in enumerate(zip(procs, errs))
               if p.returncode]
        assert not bad, bad
        return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]

    return wait


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("worlds")
    waits = {n: launch("suite", n, base / f"w{n}") for n in WORLDS}
    return {n: w() for n, w in waits.items()}


def ctr_be(nonce) -> jnp.ndarray:
    return jnp.asarray(jpacking.np_bytes_to_words(np.asarray(nonce, np.uint8)).byteswap())


def _u32(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32) if np.asarray(a).dtype == np.int32 else np.asarray(a)


def _jax_case(case: str, z: dict, n: int, sharded: bool):
    """The JAX package's output for ``case`` on the inputs the ranks
    recorded: its sharded function on make_mesh(n), or its unsharded one."""
    key = (case, n, sharded)
    if key not in _JAX:
        _JAX[key] = tuple(np.asarray(v) for v in _jax_call(case, z, n, sharded))
    return _JAX[key]


def _jax_call(case: str, z: dict, n: int, sharded: bool):
    mesh = jpar.make_mesh(n)
    get = lambda k: _u32(z[f"{case.removesuffix('_iv')}.in.{k}"])  # noqa: E731
    a = jaes.AES(KEY, engine="jnp")
    if case in ("ecb", "ecb_dec", "flat_ecb"):
        w = jnp.asarray(get("words"))
        enc = case != "ecb_dec"
        rk = a.rk_enc if enc else a.rk_dec
        if sharded:
            return (jpar.ecb_crypt_sharded(w, rk, a.nr, mesh, encrypt=enc, engine="jnp"),)
        return ((jaes.ecb_encrypt_words if enc else jaes.ecb_decrypt_words)(w, rk, a.nr, "jnp"),)
    if case in ("ctr64", "ctr61", "seam_wrap", "seam_ones64", "flat_ctr"):
        w = jnp.asarray(get("words"))
        c = ctr_be(get("nonce") if case != "flat_ctr" else bytearray(range(16, 32)))
        if sharded:
            return (jpar.ctr_crypt_sharded(w, c, a.rk_enc, a.nr, mesh, engine="jnp"),)
        return (jaes.ctr_crypt_words(w, c, a.rk_enc, a.nr, "jnp"),)
    if case.startswith("xor"):
        d, k = jnp.asarray(get("data")), jnp.asarray(get("ks"))
        return (jpar.xor_sharded(d, k, mesh) if sharded else d ^ k,)
    if case == "gather":
        w = jnp.asarray(_u32(z["gather.ref"]))
        return (jpar.gather_for_verification(w, mesh) if sharded else w,)
    if case in ("cbc", "cbc_flat", "cfb128"):
        w, iv = jnp.asarray(get("words")), jnp.asarray(get("iv"))
        if case == "cfb128":
            if sharded:
                return (jpar.cfb128_decrypt_sharded(w, iv, a.rk_enc, a.nr, mesh, engine="jnp"),)
            return (jaes.cfb128_decrypt_words(w, iv, a.rk_enc, a.nr, "jnp")[0],)
        k = jaes.AES(get("key").tobytes(), engine="jnp")
        if sharded:
            return (jpar.cbc_decrypt_sharded(w, iv, k.rk_dec, k.nr, mesh, engine="jnp"),)
        return (jaes.cbc_decrypt_words(w, iv, k.rk_dec, k.nr, "jnp")[0],)
    if case.startswith("cbc_batch"):
        w, ivs = jnp.asarray(get("words")), jnp.asarray(get("ivs"))
        if sharded:
            return jpar.cbc_encrypt_batch_sharded(w, ivs, a.rk_enc, a.nr, mesh, engine="jnp")
        return jaes.cbc_encrypt_words_batch(w, ivs, a.rk_enc, a.nr, "jnp")
    if case == "all_to_all":
        g = get("table")
        if not sharded:
            return (g,)
        cyclic = np.concatenate([g[s::n] for s in range(n)])
        return (jpar.block_cyclic_to_contiguous(jnp.asarray(cyclic), mesh),)
    if case.startswith("arc4_batch"):
        states = parc4.state_to_numpy(torch.from_numpy(z["arc4_batch.in.states"]))
        states = tuple(jnp.asarray(s) for s in states)
        (x, y, m), ks = (jpar.arc4_prep_batch_sharded(states, 96, mesh) if sharded
                         else jarc4.keystream_scan_batch(states, 96))
        rows = np.concatenate([np.asarray(x)[:, None], np.asarray(y)[:, None], np.asarray(m)],
                              axis=1)
        return ks, rows
    raise KeyError(case)


#: One case a sharded function, held against the JAX package's sharded
#: function at every mesh size; a case's second output (final IVs, states)
#: is the ``_iv``/``_state`` case.
CASES = ("ecb", "ctr64", "seam_wrap", "seam_ones64", "xor4096", "gather", "cbc", "cfb128",
         "cbc_batch", "cbc_batch_iv", "all_to_all", "arc4_batch", "arc4_batch_state")
#: The other shapes and directions, held against the unsharded JAX function.
VARIANTS = ("ecb_dec", "ctr61", "flat_ctr", "flat_ecb", "xor4100", "cbc_flat",
            "cbc_batch_flat", "cbc_batch_flat_iv")


def _output(case: str, outs: tuple):
    return outs[1 if case.endswith(("_iv", "_state")) else 0]


@pytest.mark.parametrize("case", CASES + VARIANTS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_matches_unsharded_and_jax(worlds, n, case):
    ranks = worlds[n]
    got = ranks[0][f"{case}.got"]
    for r, z in enumerate(ranks):
        # Every rank gathers the same whole, equal to its unsharded call.
        np.testing.assert_array_equal(z[f"{case}.got"], got, err_msg=f"rank {r}")
        np.testing.assert_array_equal(z[f"{case}.got"], z[f"{case}.ref"], err_msg=f"rank {r}")
    base = case.removesuffix("_iv").removesuffix("_state")
    np.testing.assert_array_equal(_u32(got), _output(case, _jax_case(base, ranks[0], n, False)))
    if case in CASES:
        np.testing.assert_array_equal(_u32(got),
                                      _output(case, _jax_case(base, ranks[0], n, True)))


def _jax_refusal(case: str, z: dict, n: int) -> str:
    """The JAX package's message on the same global input, or ''."""
    mesh = jpar.make_mesh(n)
    a = jaes.AES(KEY[:16], engine="jnp")
    w = jnp.zeros((13, 4), jnp.uint32)
    calls = {
        "flat_odd": lambda: jpar.ctr_crypt_sharded(jnp.zeros(7, jnp.uint32), ctr_be(bytearray(16)),
                                                   a.rk_enc, a.nr, mesh, engine="jnp"),
        "xor_short": lambda: jpar.xor_sharded(jnp.zeros(4096, jnp.uint8),
                                              jnp.zeros(4095, jnp.uint8), mesh),
        "chained_13": lambda: jpar.cbc_decrypt_sharded(w, jnp.zeros(4, jnp.uint32), a.rk_dec,
                                                       a.nr, mesh, engine="jnp"),
        "chained_flat77": lambda: jpar.cbc_decrypt_sharded(
            jnp.zeros(77 * 4, jnp.uint32), jnp.zeros(4, jnp.uint32), a.rk_dec, a.nr, mesh,
            engine="jnp"),
        "all_to_all_odd": lambda: jpar.block_cyclic_to_contiguous(
            jnp.zeros((n * (n + 1), 4), jnp.uint32), mesh),
    }
    try:
        calls[case]()
    except ValueError as e:
        return str(e)
    return ""


#: Each refusal's words, shared by both packages.
REFUSALS = {"flat_odd": "multiple of 4", "xor_short": "shape mismatch",
            "chained_13": "divide evenly", "chained_flat77": "divide evenly",
            "all_to_all_odd": "divisible by shards^2"}


@pytest.mark.parametrize("n,case", [(n, c) for n in WORLDS for c in sorted(REFUSALS)
                                    if not (n == 1 and c == "all_to_all_odd")])
def test_refusals_match_jax(worlds, n, case):
    want = _jax_refusal(case, worlds[n][0], n)
    for z in worlds[n]:
        got = str(z[f"{case}.refused"])
        assert bool(got) == bool(want), (got, want)
        if want:
            assert REFUSALS[case] in got and REFUSALS[case] in want


@pytest.mark.parametrize("n", WORLDS)
def test_dryrun_multichip_in_the_world(worlds, n):
    for z in worlds[n]:
        assert bool(z["dryrun.ok"])
        beyond = str(z["dryrun_beyond.refused"])
        assert f"dryrun_multichip({n + 1}) exceeds the world of {n}" in beyond
        assert f"torch.distributed.run --nproc-per-node {n + 1}" in beyond
        # Without a world a mesh of one joins its own; a larger one raises.
        no_world = str(z["dryrun_no_world.refused"])
        if n == 1:
            assert no_world == ""
        else:
            assert f"--nproc-per-node {n} -m our_tree_tpu_torch.entry" in no_world


#: The JAX harness test's flags (tests/test_harness.py).
SWEEP = ["--sizes-mb", "0.0625", "--workers", "1,2", "--iters", "2", "--modes", "ecb,ctr,rc4"]


def test_sweep_under_two_ranks_matches_reference(monkeypatch, tmp_path):
    from test_torch_harness import _masked

    monkeypatch.setenv("OT_ARC4_PREP", "native")
    monkeypatch.delenv("OT_FAULTS", raising=False)
    monkeypatch.delenv("OT_SWEEP_JOURNAL", raising=False)
    jdegrade.clear()
    port = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "our_tree_tpu_torch.harness.bench", "--device", "cpu", "--engine", "ttable",
         *SWEEP], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jrc = jbench.main(SWEEP + ["--backend", "tpu", "--engine", "jnp"])
    try:
        pout, perr = port.communicate(timeout=LAUNCH_TIMEOUT)
    finally:
        if port.poll() is None:
            port.kill()
            port.wait()
    assert jrc == 0 and port.returncode == 0, perr[-3000:]
    assert _masked(pout, False) == _masked(buf.getvalue(), True)
    assert "Shard invariance [1, 2]: passed" in pout.splitlines()
    # Rank 0 alone prints; both ranks count their units' launches.
    assert pout.count("ARC4 test #3: passed") == 1
    assert "# launches rank 1: shard-invariance" in perr
