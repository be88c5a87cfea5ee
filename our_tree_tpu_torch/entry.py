"""The port's entry points, the counterpart of the root ``__graft_entry__.py``.

``entry(device=None)`` returns the flagship forward step, AES-128-CTR bulk
encryption over 256 blocks, as ``(fn, example_args)``: the data from
``default_rng(1337)``, the key and the nonce ``bytes(range(16))``, and
``fn(words, ctr_be, rk) = models.aes.ctr_crypt_words(words, ctr_be, rk,
10)``. On the card ``fn(*example_args)`` is one ``ctr_gen`` launch (the
ranking's ``auto`` engine); with ``device="cpu"`` it runs the plain version.

``dryrun_multichip(n_devices, device=None)`` runs the sharded steps of the
root ``__graft_entry__.py`` over a mesh of n ranks (``parallel/``): CTR
through every engine, the chunk-streamed CTR of the sweep's gpu backend at a
near-wrap nonce, the XOR phase, the CBC, ECB and CFB128 decrypts,
``cbc_encrypt_batch`` over n + 1 streams, the all-to-all, ARC4 over n + 1
keys and the gather; each step's gathered output must equal this rank's
unsharded port call. Where no world exists and n is 1 it joins a world of
one on the entry's device (NCCL on the card, gloo on the CPU) for the call,
so the collectives run on the real transport; a larger n needs a world
(``python -m torch.distributed.run --nproc-per-node N -m
our_tree_tpu_torch.entry``, ``--device cpu`` for CPU ranks, ``--dist-backend
gloo`` for ranks that share a card).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from .models import aes as aes_mod
from .resilience import watchdog
from .utils import packing

KEY = bytes(range(16))
NONCE = bytes(range(16))
SEED = 1337


def _example_inputs(nblocks: int, device):
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 256, nblocks * 16, dtype=np.uint8)
    words = packing.words_tensor(packing.np_bytes_to_words(data).reshape(-1, 4), device)
    nonce = np.frombuffer(NONCE, dtype=np.uint8)
    ctr_be = packing.words_tensor(packing.np_bytes_to_words(nonce).byteswap(), device)
    return words, ctr_be


def entry(device=None):
    """(fn, example_args) for one forward step on ``device`` (default the
    card; without one it raises unless ``device="cpu"``)."""
    a = aes_mod.AES(KEY, device=device)
    words, ctr_be = _example_inputs(256, a.device)

    def fn(words, ctr_be, rk):
        return aes_mod.ctr_crypt_words(words, ctr_be, rk, 10)

    return fn, (words, ctr_be, a.rk_enc)


#: The near-wrap nonce of the streamed step: every chunk seam a multi-word carry.
WRAP_NONCE = bytes.fromhex("00000000ffffffffffffffffffffff" "f9")


def _launch_hint(n: int) -> str:
    return (f"python -m torch.distributed.run --nproc-per-node {n} -m our_tree_tpu_torch.entry "
            "(add --device cpu for CPU ranks, --dist-backend gloo for ranks sharing one card; "
            "ROADMAP.md, \"Multi-device\")")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The sharded step over a mesh of ``n_devices`` ranks on tiny shapes;
    every rank of the world calls it (ranks outside the mesh return)."""
    import torch.distributed as tdist

    from .parallel import multihost

    own = None
    if not tdist.is_initialized():
        if n_devices != 1:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs a world of {n_devices} "
                               f"ranks; launch it with {_launch_hint(n_devices)}")
        own = tempfile.mkdtemp(prefix="ot_dryrun_")
        multihost.initialize(f"file://{os.path.join(own, 'store')}", 1, 0,
                             device=aes_mod.as_device(device))
    try:
        world = tdist.get_world_size()
        if n_devices > world:
            raise RuntimeError(f"dryrun_multichip({n_devices}) exceeds the world of {world} "
                               f"ranks; launch it with {_launch_hint(n_devices)}")
        _dryrun_steps(n_devices)
    finally:
        if own is not None:
            multihost.shutdown()
            shutil.rmtree(own, ignore_errors=True)


def _dryrun_steps(n: int) -> None:
    from .harness.backends import GpuBackend
    from .models import arc4
    from .parallel import dist, multihost

    mesh = dist.make_mesh(n)
    if not mesh.member:
        return
    dev = mesh.device

    def check(name, local, want, rows):
        got = dist.gather_for_verification(local, mesh, rows)
        if not torch.equal(got, want):
            raise AssertionError(f"dryrun_multichip({n}): {name}: the gathered output differs "
                                 "from the unsharded port call")

    def rand_words(seed, shape):
        w = np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint64)
        return packing.words_tensor(w.astype(np.uint32), dev)

    # CTR over the mesh, each shard's counter offset from its rank, through
    # every engine.
    a = aes_mod.AES(KEY, device=dev)
    words, ctr_be = _example_inputs(8 * n, dev)
    ref = aes_mod.ctr_crypt_words(words, ctr_be, a.rk_enc, a.nr)
    local = dist.shard_rows(words, mesh, words=True)
    for engine in ("auto", aes_mod.PLAIN_ENGINE, aes_mod.TTABLE_ENGINE):
        check(f"CTR ({engine})",
              dist.ctr_crypt_sharded(local, ctr_be, a.rk_enc, a.nr, mesh, engine=engine), ref,
              words.shape[0])

    # Chunk-streamed sharded CTR through the sweep's gpu backend: chunks
    # sharded n ways, the 128-bit counter carried across chunk seams from a
    # near-wrap nonce, a ragged tail.
    os.environ.setdefault("OT_ARC4_PREP", "device")  # no native build here
    backend = GpuBackend(engine="auto", device=dev)
    nonce = np.frombuffer(WRAP_NONCE, np.uint8)
    msg = np.random.default_rng(13).integers(0, 256, 16 * (6 * n) + 5, np.uint8)
    streamed = backend.ctr_stream(backend.make_key(KEY), msg, nonce, 16 * 2 * n, n)
    one_shot, *_ = a.crypt_ctr(0, nonce.copy(), np.zeros(16, np.uint8), msg)
    if not np.array_equal(streamed, one_shot):
        raise AssertionError(f"dryrun_multichip({n}): the streamed CTR differs from crypt_ctr")

    # The XOR phase over a keystream from the ARC4 path.
    nbytes = 64 * n
    with watchdog.deadline(watchdog.default_deadline_s(), what="dryrun staging"):
        ks = torch.from_numpy(arc4.ARC4(b"dryrun-key", device=dev).prep(nbytes)).to(dev)
        data = torch.from_numpy(np.random.default_rng(7).integers(0, 256, nbytes,
                                                                  np.uint8)).to(dev)
    check("XOR", dist.xor_sharded(dist.shard_rows(data, mesh), dist.shard_rows(ks, mesh), mesh),
          data ^ ks, nbytes)

    # The halo decrypts and ECB decrypt.
    iv = packing.words_tensor(packing.np_bytes_to_words(np.frombuffer(bytes(range(16, 32)),
                                                                      np.uint8)), dev)
    chained = dist.shard_rows(words, mesh, words=True, chained=True)
    check("CBC decrypt", dist.cbc_decrypt_sharded(chained, iv, a.rk_dec, a.nr, mesh),
          aes_mod.cbc_decrypt_words(words, iv, a.rk_dec, a.nr)[0], words.shape[0])
    check("ECB decrypt", dist.ecb_crypt_sharded(local, a.rk_dec, a.nr, mesh, encrypt=False),
          aes_mod.ecb_decrypt_words(words, a.rk_dec, a.nr), words.shape[0])
    check("CFB128 decrypt", dist.cfb128_decrypt_sharded(chained, iv, a.rk_enc, a.nr, mesh),
          aes_mod.cfb128_decrypt_words(words, iv, a.rk_enc, a.nr)[0], words.shape[0])

    # Independent CBC streams, n + 1 of them (the stream axis padded).
    s = n + 1
    bw, ivs = rand_words(9, (s, 6, 4)), rand_words(10, (s, 4))
    bout, biv = dist.cbc_encrypt_batch_sharded(dist.shard_rows(bw, mesh),
                                               dist.shard_rows(ivs, mesh), a.rk_enc, a.nr, mesh)
    want, want_iv = aes_mod.cbc_encrypt_words_batch(bw, ivs, a.rk_enc, a.nr)
    check("CBC batch", bout, want, s)
    check("CBC batch IVs", biv, want_iv, s)

    # The all-to-all: round-robin rows to this rank's contiguous range.
    g = rand_words(11, (2 * n * n, 4))
    check("all-to-all", dist.block_cyclic_to_contiguous(g[mesh.rank::n].contiguous(), mesh), g,
          g.shape[0])

    # ARC4 keystreams of n + 1 streams.
    keys = [bytes([17 + i]) * 5 for i in range(n + 1)]
    states = arc4.ARC4.batch_states(keys, dev)
    new, ksb = dist.arc4_prep_batch_sharded(dist.shard_rows(states, mesh), 32, mesh)
    want_state, want_ks = arc4.keystream_scan_batch(states, 32)
    check("ARC4 batch", ksb, want_ks, len(keys))
    check("ARC4 batch states", new, want_state, len(keys))

    # The verification collective round trip, and the shards placed through
    # multihost.
    check("gather", multihost.host_local_to_global(local, mesh), words, words.shape[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's entry() and dryrun_multichip(world size)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="under python -m torch.distributed.run: the transport (default nccl "
                         "on a card, gloo on the CPU)")
    args = ap.parse_args(argv)
    import torch.distributed as tdist

    from .parallel import multihost

    launched = "WORLD_SIZE" in os.environ
    if launched:
        multihost.initialize_from_env(device=args.device, backend=args.dist_backend)
    try:
        lead = not launched or tdist.get_rank() == 0
        device = multihost.rank_device() if launched else args.device
        fn, example = entry(device)
        out = fn(*example)
        if lead:
            print("entry() ok:", tuple(out.shape), out.dtype, flush=True)
        n = tdist.get_world_size() if launched else 1
        dryrun_multichip(n, device=device)
        if lead:
            print(f"dryrun_multichip({n}) ok", flush=True)
    finally:
        if launched:
            multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
