"""The port's process bootstrap (``our_tree_tpu_torch.parallel.multihost``)
and its entry on the CPU, against the JAX package's multi-host rehearsal
(``tests/test_multihost.py``): two processes join one gloo world, each
places its contiguous part of the data with ``host_local_to_global``, and
the gathered sharded CTR and ARC4 keystreams equal the JAX package's
unsharded results. Also: the package imports neither JAX nor the JAX
package, the coordinator forms, the refusals before any world exists, and
``python -m our_tree_tpu_torch.entry`` alone and under two ranks.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from our_tree_tpu.models import aes as jaes
from our_tree_tpu.models import arc4 as jarc4
from our_tree_tpu.utils import packing as jpacking
from our_tree_tpu_torch import entry
from our_tree_tpu_torch.parallel import dist, multihost
from test_torch_parallel import LAUNCH_TIMEOUT, launch

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    return launch("multihost", 2, tmp_path_factory.mktemp("multihost"))()


def test_two_process_ctr_matches_reference(two_processes):
    want = None
    for z in two_processes:
        assert int(z["mesh.size"]) == 2
        np.testing.assert_array_equal(z["ctr.got"], z["ctr.ref"])
        if want is None:
            a = jaes.AES(bytes(range(16)), engine="jnp")
            ctr = jnp.asarray(jpacking.np_bytes_to_words(
                np.frombuffer(bytes(range(16)), np.uint8)).byteswap())
            want = np.asarray(jaes.ctr_crypt_words(jnp.asarray(z["ctr.in.words"]), ctr,
                                                   a.rk_enc, a.nr, "jnp"))
        np.testing.assert_array_equal(z["ctr.got"].view(np.uint32), want)


def test_two_process_arc4_batch_matches_reference(two_processes):
    keys = [bytes([3 + i]) * 7 for i in range(4)]
    for z in two_processes:
        np.testing.assert_array_equal(z["arc4.got"], z["arc4.ref"])
        for i, k in enumerate(keys):
            want, _ = jarc4.keystream_np((0, 0, jarc4.key_schedule(k)), 48)
            np.testing.assert_array_equal(z["arc4.got"][i], want)


def test_two_process_refusals(two_processes):
    for z in two_processes:
        assert "ranks passed different local shapes [(1, 4), (2, 4)]" in str(z["shapes.refused"])
        assert "already initialized" in str(z["twice.refused"])


def test_import_loads_no_jax():
    code = ("import sys; import our_tree_tpu_torch.parallel, "
            "our_tree_tpu_torch.parallel.multihost, our_tree_tpu_torch.entry; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'our_tree_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("coordinator,want", [
    ("host0:8476", "tcp://host0:8476"), ("10.0.0.1:1", "tcp://10.0.0.1:1"),
    ("file:///tmp/store", "file:///tmp/store"), ("tcp://h:2", "tcp://h:2")])
def test_coordinator_forms(coordinator, want):
    assert multihost._init_method(coordinator) == want


@pytest.mark.parametrize("coordinator", ["host0", ":80", "host:port"])
def test_coordinator_refused(coordinator):
    with pytest.raises(ValueError, match="host:port"):
        multihost._init_method(coordinator)


def test_refusals_without_a_world(monkeypatch):
    assert not multihost.tdist.is_initialized()
    with pytest.raises(ValueError, match="NCCL carries card tensors only"):
        multihost.initialize("localhost:1", 1, 0, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        multihost.initialize("localhost:1", 1, 0, device="cpu", backend="mpi")
    monkeypatch.setattr(multihost.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:1", 1, 0)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        multihost.initialize_from_env(device="cpu")
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        dist.make_mesh(1)
    with pytest.raises(RuntimeError, match="--nproc-per-node 2 -m our_tree_tpu_torch.entry"):
        entry.dryrun_multichip(2, device="cpu")
    assert not multihost.tdist.is_initialized()


@pytest.mark.parametrize("nproc", [1, 2])
def test_entry_main_on_cpu(nproc):
    """``python -m our_tree_tpu_torch.entry --device cpu``: alone it runs
    ``dryrun_multichip(1)`` in a world of its own; under two ranks
    ``dryrun_multichip(2)``, rank 0 printing."""
    launcher = ([] if nproc == 1 else
                ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(nproc)])
    res = subprocess.run([sys.executable, *launcher, "-m", "our_tree_tpu_torch.entry", "--device",
                          "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=LAUNCH_TIMEOUT,
                         env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.splitlines() == ["entry() ok: (256, 4) torch.int32",
                                       f"dryrun_multichip({nproc}) ok"]
