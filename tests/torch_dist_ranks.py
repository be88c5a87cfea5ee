"""One rank of a gloo world on the CPU for the port's multi-device tests.

Not a test module: ``tests/test_torch_parallel.py`` and
``tests/test_torch_multihost.py`` launch it, one process a rank:

    python tests/torch_dist_ranks.py MODE RANK WORLD STORE OUT

It joins the world through ``multihost.initialize`` over the ``file://``
store STORE, runs MODE's cases through ``our_tree_tpu_torch.parallel`` and
writes ``OUT/rank<RANK>.npz``: per case the gathered sharded output
(``<case>.got``) and this rank's unsharded port call (``<case>.ref``), the
inputs (``<case>.in.*``), and each expected refusal's message
(``<case>.refused``). It imports the port only, and checks at exit that
neither JAX nor the JAX package was loaded. MODE ``suite`` runs every
sharded function, ``dryrun_multichip`` and the refusals; ``multihost`` the
bootstrap: ``global_mesh``, ``host_local_to_global`` and a second
``initialize``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from our_tree_tpu_torch import entry  # noqa: E402
from our_tree_tpu_torch.models import aes, arc4  # noqa: E402
from our_tree_tpu_torch.parallel import dist, multihost  # noqa: E402
from our_tree_tpu_torch.utils import packing  # noqa: E402

#: AES-128 throughout, so that the JAX side's compiles are shared by cases.
KEY = bytes(range(16))
#: The seam-carry nonces: near the 2^128 wrap with a 64-bit ripple, and the
#: low 64 bits all ones.
NONCE_WRAP = "00000000ffffffffffffffffffffff" "f9"
NONCE_ONES64 = "0011223344556677ffffffffffffffff"


def u32(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def t32(a):
    return packing.words_tensor(a, "cpu")


def ctr_words(hexnonce):
    return t32(packing.np_bytes_to_words(np.frombuffer(bytes.fromhex(hexnonce), np.uint8))
               .byteswap())


class Record:
    def __init__(self, mesh):
        self.mesh, self.out = mesh, {}

    def case(self, name, local, ref, rows, **inputs):
        got = dist.gather_for_verification(local, self.mesh, rows)
        self.out[f"{name}.got"] = got.numpy()
        self.out[f"{name}.ref"] = ref.numpy()
        for k, v in inputs.items():
            self.out[f"{name}.in.{k}"] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    def refused(self, name, fn):
        try:
            fn()
        except (ValueError, RuntimeError) as e:
            self.out[f"{name}.refused"] = np.asarray(str(e))
        else:
            self.out[f"{name}.refused"] = np.asarray("")


def suite(rec, world):
    mesh = rec.mesh
    s = mesh.size
    a128 = aes.AES(KEY, device="cpu")
    w64 = t32(packing.np_bytes_to_words(
        np.random.default_rng(1337).integers(0, 256, 16 * 64, np.uint8)).reshape(-1, 4))
    loc64 = dist.shard_rows(w64, mesh, words=True)

    # ECB both ways.
    rec.case("ecb", dist.ecb_crypt_sharded(loc64, a128.rk_enc, a128.nr, mesh),
             aes.ecb_encrypt_words(w64, a128.rk_enc, a128.nr), 64, words=w64)
    rec.case("ecb_dec", dist.ecb_crypt_sharded(loc64, a128.rk_dec, a128.nr, mesh, encrypt=False),
             aes.ecb_decrypt_words(w64, a128.rk_dec, a128.nr), 64, words=w64)

    # CTR at 64 and 61 blocks (the padding path), a flat stream, the seams.
    nonce = bytes(range(240, 256)).hex()
    for name, words, hexnonce in (("ctr64", w64, nonce), ("ctr61", w64[:61], nonce),
                                  ("seam_wrap", w64, NONCE_WRAP),
                                  ("seam_ones64", w64, NONCE_ONES64)):
        ctr = ctr_words(hexnonce)
        loc = dist.shard_rows(words, mesh, words=True)
        rec.case(name, dist.ctr_crypt_sharded(loc, ctr, a128.rk_enc, a128.nr, mesh),
                 aes.ctr_crypt_words(words, ctr, a128.rk_enc, a128.nr), words.shape[0],
                 words=words, nonce=np.frombuffer(bytes.fromhex(hexnonce), np.uint8))
    flat = t32(u32(77, 77 * 4))
    ctr = ctr_words(bytes(range(16, 32)).hex())
    locf = dist.shard_rows(flat, mesh, words=True)
    rec.case("flat_ctr", dist.ctr_crypt_sharded(locf, ctr, a128.rk_enc, a128.nr, mesh),
             aes.ctr_crypt_words(flat, ctr, a128.rk_enc, a128.nr), flat.shape[0], words=flat)
    rec.case("flat_ecb", dist.ecb_crypt_sharded(locf, a128.rk_enc, a128.nr, mesh),
             aes.ecb_encrypt_words(flat, a128.rk_enc, a128.nr), flat.shape[0], words=flat)
    rec.refused("flat_odd", lambda: dist.shard_rows(flat[:7], mesh, words=True))

    # The XOR phase, and its refusal of a short keystream.
    for n in (4096, 4100):
        rng = np.random.default_rng(n)
        d = torch.from_numpy(rng.integers(0, 256, n, np.uint8))
        k = torch.from_numpy(rng.integers(0, 256, n, np.uint8))
        rec.case(f"xor{n}", dist.xor_sharded(dist.shard_rows(d, mesh), dist.shard_rows(k, mesh),
                                             mesh), d ^ k, n, data=d, ks=k)
    d = torch.zeros(4096, dtype=torch.uint8)
    rec.refused("xor_short", lambda: dist.xor_sharded(d, d[:-1], mesh))

    # The gather round trip.
    rec.case("gather", loc64, w64, 64)

    # The halo decrypts, over blocks and a flat stream, and the refusal of
    # an indivisible block count.
    rng = np.random.default_rng(31)
    key = rng.integers(0, 256, 16, np.uint8).tobytes()
    ac = aes.AES(key, device="cpu")
    words, iv = t32(u32(310, (64, 4))), t32(u32(311, 4))
    for name, w in (("cbc", words), ("cbc_flat", words.reshape(-1))):
        loc = dist.shard_rows(w, mesh, words=True, chained=True)
        rec.case(name, dist.cbc_decrypt_sharded(loc, iv, ac.rk_dec, ac.nr, mesh),
                 aes.cbc_decrypt_words(w, iv, ac.rk_dec, ac.nr)[0], w.shape[0], words=w, iv=iv,
                 key=np.frombuffer(key, np.uint8))
    words_c = t32(u32(320, (64, 4)))
    loc = dist.shard_rows(words_c, mesh, words=True, chained=True)
    rec.case("cfb128", dist.cfb128_decrypt_sharded(loc, iv, a128.rk_enc, a128.nr, mesh),
             aes.cfb128_decrypt_words(words_c, iv, a128.rk_enc, a128.nr)[0], 64, words=words_c,
             iv=iv)
    rec.refused("chained_13", lambda: dist.shard_rows(words[:13], mesh, words=True, chained=True))
    rec.refused("chained_flat77", lambda: dist.shard_rows(flat, mesh, words=True, chained=True))

    # n + 1 independent CBC streams of 9 blocks, as blocks and flat.
    bw, ivs = t32(u32(41, (s + 1, 9, 4))), t32(u32(42, (s + 1, 4)))
    for name, w in (("cbc_batch", bw), ("cbc_batch_flat", bw.reshape(s + 1, -1))):
        out, iv_out = dist.cbc_encrypt_batch_sharded(
            dist.shard_rows(w, mesh), dist.shard_rows(ivs, mesh), a128.rk_enc, a128.nr, mesh)
        want, want_iv = aes.cbc_encrypt_words_batch(w, ivs, a128.rk_enc, a128.nr)
        rec.case(name, out, want, s + 1, words=w, ivs=ivs)
        rec.case(f"{name}_iv", iv_out, want_iv, s + 1)

    # The all-to-all, and its refusal of a row count off S^2.
    g = t32(u32(53, (s * s * 3, 4)))
    rec.case("all_to_all", dist.block_cyclic_to_contiguous(g[mesh.rank::s].contiguous(), mesh),
             g, g.shape[0], table=g)
    if s > 1:
        rec.refused("all_to_all_odd",
                    lambda: dist.block_cyclic_to_contiguous(g[:s + 1].contiguous(), mesh))

    # ARC4 keystreams of 5 streams, the stream axis padded.
    keys = [bytes([i]) * (i + 3) for i in range(5)]
    states = arc4.ARC4.batch_states(keys, "cpu")
    new, ks = dist.arc4_prep_batch_sharded(dist.shard_rows(states, mesh), 96, mesh)
    want_state, want_ks = arc4.keystream_scan_batch(states, 96)
    rec.case("arc4_batch", ks, want_ks, 5, states=states)
    rec.case("arc4_batch_state", new, want_state, 5)

    # dryrun_multichip inside the world, and beyond it.
    entry.dryrun_multichip(s, device="cpu")
    rec.out["dryrun.ok"] = np.asarray(True)
    rec.refused("dryrun_beyond", lambda: entry.dryrun_multichip(world + 1, device="cpu"))


def multihost_cases(rec, world):
    mesh = rec.mesh
    rec.out["mesh.size"] = np.asarray(mesh.size)
    a = aes.AES(bytes(range(16)), device="cpu")
    data = np.random.default_rng(1337).integers(0, 256, 64 * 16, dtype=np.uint8)
    words = packing.np_bytes_to_words(data).reshape(-1, 4)
    ctr = ctr_words(bytes(range(16)).hex())
    # Each process contributes its contiguous part: the multi-host scatter.
    local = multihost.host_local_to_global(words.reshape(world, -1, 4)[mesh.rank], mesh)
    rec.case("ctr", dist.ctr_crypt_sharded(local, ctr, a.rk_enc, a.nr, mesh),
             aes.ctr_crypt_words(t32(words), ctr, a.rk_enc, a.nr), 64, words=words)
    # Independent ARC4 streams across the processes, two a rank.
    keys = [bytes([3 + i]) * 7 for i in range(2 * world)]
    states = arc4.ARC4.batch_states(keys, "cpu")
    loc = multihost.host_local_to_global(states[2 * mesh.rank:2 * mesh.rank + 2], mesh)
    _, ks = dist.arc4_prep_batch_sharded(loc, 48, mesh)
    rec.case("arc4", ks, arc4.keystream_scan_batch(states, 48)[1], 2 * world, states=states)
    rec.refused("shapes", lambda: multihost.host_local_to_global(
        np.zeros((mesh.rank + 1, 4), np.uint32), mesh))
    rec.refused("twice", lambda: multihost.initialize("localhost:1", world, mesh.rank,
                                                      device="cpu"))


def main():
    mode, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    pre = {}
    if mode == "suite":
        # Without a world: a mesh of one joins a world of its own for the
        # call, a larger one names the launch.
        try:
            entry.dryrun_multichip(world, device="cpu")
            pre["dryrun_no_world.refused"] = np.asarray("")
        except RuntimeError as e:
            pre["dryrun_no_world.refused"] = np.asarray(str(e))
    multihost.initialize(f"file://{store}", world, rank, device="cpu")
    rec = Record(multihost.global_mesh())
    rec.out.update(pre)
    try:
        (suite if mode == "suite" else multihost_cases)(rec, world)
    finally:
        multihost.shutdown()
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "our_tree_tpu"
                    or m.startswith("our_tree_tpu."))
    assert not loaded, f"the port's ranks loaded {loaded[:5]}"
    np.savez(os.path.join(out, f"rank{rank}.npz"), **rec.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
