"""Multi-device distribution over ``torch.distributed`` (``our_tree_tpu.parallel.dist``).

The reference's only parallelism is a message cut into contiguous chunks,
one thread each; its workloads need no cross-worker reduction. The JAX
package runs that scheme as one controller over a 1-D device mesh with
``shard_map`` bodies that read ``axis_index``. PyTorch's idiom is SPMD: one
process per device (``parallel/multihost.py`` joins it to the world), each
holding its own shard, so this module states the same scheme per rank.

**The SPMD contract.** A ``Mesh`` is the first S ranks of the world (rank
r of the mesh is rank r of the world). Each sharded function takes this
rank's contiguous shard and returns this rank's output shard; every rank of
the mesh calls it with a shard of the same shape. ``shard_rows(x, mesh)``
cuts a rank's shard from a global tensor by the JAX package's padding rules:
the leading axis zero-padded at its end to a multiple of S (so every real
row keeps its global index), flat ``(4N,)`` word streams padded by whole
16-byte blocks, and no padding for the chained decrypts, which refuse a
block count that does not divide. ``gather_for_verification(local, mesh,
n)`` all-gathers the shards in rank order and cuts the padding off.

The sharded functions, and the kernels they reach on the card:
``ecb_crypt_sharded`` (``ecb_encrypt``/``ecb_decrypt``), ``ctr_crypt_sharded``
(one ``ctr_gen`` launch a call: the shard's counter is counter0 + rank x
local blocks, an int64 offset through the 128-bit add, then the engine's
fused CTR), ``xor_sharded``, ``cbc_decrypt_sharded`` and
``cfb128_decrypt_sharded`` (one 16-byte block from the left neighbour by
``batch_isend_irecv``, the IV on rank 0; ``ecb_decrypt`` or ``ecb_encrypt``),
``block_cyclic_to_contiguous`` (``all_to_all_single``),
``cbc_encrypt_batch_sharded`` (one ``seq_encrypt`` launch a rank) and
``arc4_prep_batch_sharded`` (one ``arc4_prga`` launch a rank). On the CPU
the engines run the kernels' plain versions.

**Transport.** NCCL keeps card tensors on the card. A gloo group carries
host tensors only, so on a gloo mesh over card tensors each collective
helper copies its operands to host memory, runs, and copies back: keyed on
the mesh's backend, never on a failure. ``COLLECTIVES`` counts the calls,
bytes and host seconds of every collective (on gloo the whole exchange, on
NCCL the enqueue).

No counterparts: the ``shard_map`` shim, ``_vma_drop_bug``,
``_shard_check_vma`` and the engine-knob cache keys answer questions about
JAX's tracer and compile cache, not about the cipher.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.distributed as tdist

from ..models import aes as aes_mod
from ..models import arc4 as arc4_mod
from ..utils.packing import add_counter_be

AXIS = "shards"

#: Collectives since the last ``reset_collectives``: calls, bytes sent by
#: this rank, host seconds; by name under ``"by_name"``.
COLLECTIVES: dict = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()
    COLLECTIVES.update(calls=0, bytes=0, seconds=0.0, by_name={})


reset_collectives()

#: The groups of ``make_mesh``, by (world group, size): ``new_group`` is a
#: collective of the whole world, so each size is made once, in the same
#: order on every rank.
_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first ``size`` ranks of the world. ``rank`` is this process's
    rank in it, -1 outside it; ``device`` its rank device; ``backend``
    ``"nccl"`` or ``"gloo"``."""

    group: object
    size: int
    rank: int
    device: torch.device
    backend: str
    axis: str = AXIS

    @property
    def member(self) -> bool:
        return self.rank >= 0


def forget_meshes() -> None:
    """Drop the cached groups (``multihost.shutdown`` calls it)."""
    _GROUPS.clear()


def make_mesh(n_devices: int | None = None, axis: str = AXIS) -> Mesh:
    """The mesh over the first ``n_devices`` ranks of the world (all, if
    None). Every rank of the world calls it, members or not. It never starts
    a world: without one it raises, and it raises when fewer ranks exist."""
    from . import multihost

    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError("no torch.distributed world: join one with multihost.initialize(...) "
                           "or launch under python -m torch.distributed.run and call "
                           "multihost.initialize_from_env()")
    world = tdist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    if world < n:
        raise ValueError(f"requested a {n}-device mesh but only {world} ranks exist — a silently "
                         "smaller mesh would let shard-count assumptions go unvalidated")
    key = (id(tdist.group.WORLD), n)
    group = _GROUPS.get(key)
    if group is None:
        group = _GROUPS[key] = (tdist.group.WORLD if n == world
                                else tdist.new_group(ranks=list(range(n))))
    rank = tdist.get_rank()
    return Mesh(group, n, rank if rank < n else -1, multihost.rank_device(),
                tdist.get_backend(), axis)


def _member(mesh: Mesh) -> None:
    if not mesh.member:
        raise ValueError(f"this rank is outside the {mesh.size}-rank mesh")


# ---------------------------------------------------------------------------
# Shards and collectives
# ---------------------------------------------------------------------------


def shard_rows(x: torch.Tensor, mesh: Mesh, words: bool = False,
               chained: bool = False) -> torch.Tensor:
    """This rank's contiguous shard of the global tensor ``x`` along its
    leading axis, zero-padded at the end to a multiple of the mesh size.
    ``words``: ``x`` is AES block words, (N, 4) or a flat (4N,) stream, which
    is padded by whole 16-byte blocks (a flat length not a multiple of 4
    raises). ``chained`` (the CBC/CFB128 decrypts): no padding; a block count
    that does not divide raises."""
    _member(mesh)
    s = mesh.size
    flat = words and x.dim() == 1
    if flat and x.shape[0] % 4:
        raise ValueError(f"flat word stream length must be a multiple of 4 u32 words (one "
                         f"16-byte block), got {x.shape[0]} words — pad the byte stream to "
                         "16-byte blocks before sharding")
    unit = 4 if flat else 1
    n = x.shape[0] // unit
    if chained:
        if n % s:
            raise ValueError(f"block count {n} must divide evenly over {s} shards (chained "
                             "modes cannot be zero-padded)")
        per = n // s
        return x[mesh.rank * per * unit:(mesh.rank + 1) * per * unit]
    per = -(-n // s)
    lo, hi = min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)
    local = x[lo * unit:hi * unit]
    if hi - lo < per:
        pad = torch.zeros(((per - (hi - lo)) * unit,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        local = torch.cat([local, pad])
    return local


def _carried(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the mesh's transport carries it: host memory for gloo,
    the rank's card for NCCL (a copy only where it lies elsewhere)."""
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    return t if t.device == dev else t.to(dev)


@contextlib.contextmanager
def _collective(name: str, nbytes: int):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += int(nbytes)
        COLLECTIVES["seconds"] += dt
        rec = COLLECTIVES["by_name"].setdefault(name, {"calls": 0, "seconds": 0.0})
        rec["calls"] += 1
        rec["seconds"] += dt


def gather_for_verification(local: torch.Tensor, mesh: Mesh, n: int | None = None,
                            axis: str = AXIS) -> torch.Tensor:
    """All-gather the mesh's shards in rank order (every rank gets the whole)
    and keep the first ``n`` rows: the global tensor, its padding cut off.
    The verification collective."""
    del axis
    _member(mesh)
    t = local.contiguous()
    with _collective("all_gather", t.numel() * t.element_size()):
        src = _carried(mesh, t)
        parts = [torch.empty_like(src) for _ in range(mesh.size)]
        tdist.all_gather(parts, src, group=mesh.group)
        out = torch.cat(parts).to(local.device)
    return out if n is None else out[:n]


def all_reduce_max(values: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise maximum over the mesh's ranks (a sharded row's time is
    its slowest rank's)."""
    _member(mesh)
    with _collective("all_reduce", values.numel() * values.element_size()):
        t = _carried(mesh, values).clone()
        tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=mesh.group)
    return t.to(values.device)


def _halo_prev_stream(w2: torch.Tensor, iv: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The previous-ciphertext stream of a chained-mode shard: the local
    blocks shifted by one, the seam block from the left neighbour (one
    16-byte send to the right), the IV on rank 0. A mesh of one exchanges
    nothing."""
    first = iv.reshape(1, 4)
    if mesh.size > 1:
        last = w2[-1].contiguous()
        with _collective("halo", last.numel() * last.element_size()):
            send = _carried(mesh, last)
            recv = torch.empty_like(send)
            ops = []
            if mesh.rank + 1 < mesh.size:
                ops.append(tdist.P2POp(tdist.isend, send, mesh.rank + 1, group=mesh.group))
            if mesh.rank > 0:
                ops.append(tdist.P2POp(tdist.irecv, recv, mesh.rank - 1, group=mesh.group))
            for req in tdist.batch_isend_irecv(ops):
                req.wait()
        if mesh.rank > 0:
            first = recv.to(w2.device).reshape(1, 4)
    return torch.cat([first.to(w2.dtype), w2[:-1]])


# ---------------------------------------------------------------------------
# Sharded modes
# ---------------------------------------------------------------------------


def ecb_crypt_sharded(words: torch.Tensor, rk: torch.Tensor, nr: int, mesh: Mesh,
                      encrypt: bool = True, axis: str = AXIS, engine: str = "auto"):
    """ECB over this rank's shard of block words ((N, 4) or flat (4N,)): the
    reference's headline parallel mode, each worker its own chunk."""
    del axis
    _member(mesh)
    fn = aes_mod.ecb_encrypt_words if encrypt else aes_mod.ecb_decrypt_words
    return fn(words, rk, nr, engine)


def ctr_crypt_sharded(words: torch.Tensor, ctr_be: torch.Tensor, rk: torch.Tensor, nr: int,
                      mesh: Mesh, axis: str = AXIS, engine: str = "auto"):
    """CTR over this rank's shard ((N, 4) block words or a flat (4N,)
    stream) of a global stream whose block i uses counter0 + i. Every shard
    holds the same block count (``shard_rows``), so this rank's first block
    is global block rank x N: the shard counter is ``ctr_be`` plus that
    offset, added as an int64 through the 128-bit big-endian add (carries
    cross every word), and the engine's fused CTR runs from it (on the card
    one ``ctr_gen`` launch). ``ctr_be``: (4,) int32 big-endian words."""
    del axis
    _member(mesh)
    n_local = words.reshape(-1, 4).shape[0]
    # A fill on the device, not a host copy: the call never waits on the card.
    base = torch.full((1,), mesh.rank * n_local, dtype=torch.int64, device=ctr_be.device)
    shard_ctr = add_counter_be(ctr_be, base).reshape(4)
    return aes_mod.ctr_crypt_words(words, shard_ctr, rk, nr, engine)


def xor_sharded(data: torch.Tensor, keystream: torch.Tensor, mesh: Mesh, axis: str = AXIS):
    """ARC4's data-parallel XOR over this rank's shards of data and
    keystream (any dtype and shape). A shape mismatch raises before any
    padding: XOR against padding would pass tail plaintext through."""
    del axis
    if data.shape != keystream.shape:
        raise ValueError(f"data/keystream shape mismatch: {tuple(data.shape)} vs "
                         f"{tuple(keystream.shape)}")
    _member(mesh)
    return torch.bitwise_xor(data, keystream)


def _chained_dec_sharded(words, iv_words, rk, nr, mesh, engine, mode):
    _member(mesh)
    w2 = words.reshape(-1, 4)
    if w2.shape[0] == 0:  # a no-op, as the unsharded path
        return words
    prev = _halo_prev_stream(w2, iv_words, mesh)
    if mode == "cbc":
        out = aes_mod.ecb_decrypt_words(w2, rk, nr, engine) ^ prev
    else:
        out = w2 ^ aes_mod.ecb_encrypt_words(prev, rk, nr, engine)
    return out.reshape(words.shape)


def cbc_decrypt_sharded(words, iv_words, rk_dec, nr, mesh: Mesh, axis: str = AXIS,
                        engine: str = "auto"):
    """CBC decrypt of this rank's shard of blocks, P_i = D(C_i) ^ C_(i-1),
    with the one-block halo from the left neighbour. Equal to the unsharded
    ``cbc_decrypt_words`` for every mesh size; the shard comes from
    ``shard_rows(..., chained=True)``, which refuses a block count that does
    not divide (padding would corrupt the recurrence)."""
    del axis
    return _chained_dec_sharded(words, iv_words, rk_dec, nr, mesh, engine, "cbc")


def cfb128_decrypt_sharded(words, iv_words, rk_enc, nr, mesh: Mesh, axis: str = AXIS,
                           engine: str = "auto"):
    """CFB128 decrypt of this rank's shard (keystream_i = E(C_(i-1)), so the
    same one-block halo makes it fully parallel)."""
    del axis
    return _chained_dec_sharded(words, iv_words, rk_enc, nr, mesh, engine, "cfb128")


def block_cyclic_to_contiguous(x: torch.Tensor, mesh: Mesh, axis: str = AXIS) -> torch.Tensor:
    """All-to-all layout exchange: this rank's round-robin rows (global rows
    r, r + S, r + 2S, ...) in, its contiguous range of the global rows out,
    by one ``all_to_all_single``: the rank cuts its rows into S groups by
    destination and receives its range's rows from everyone. The global row
    count must divide by S^2 (cyclic layouts have no padding rows)."""
    del axis
    _member(mesh)
    s = mesh.size
    n_local = x.shape[0]
    n = n_local * s
    if n % (s * s):
        raise ValueError(f"row count {n} must be divisible by shards^2 ({s * s}) for an even "
                         "all-to-all exchange")
    # Local row k is global row rank + k*S and goes to rank k // (n/S/S);
    # recv[src, k] is global row rank*n/S + k*S + src, so the (k, src)
    # order restores the contiguous range.
    g = x.reshape((s, n_local // s) + tuple(x.shape[1:])).contiguous()
    with _collective("all_to_all", g.numel() * g.element_size()):
        src = _carried(mesh, g)
        recv = torch.empty_like(src)
        tdist.all_to_all_single(recv, src, group=mesh.group)
        recv = recv.to(x.device)
    return recv.transpose(0, 1).reshape((n_local,) + tuple(x.shape[1:]))


def cbc_encrypt_batch_sharded(words, ivs, rk, nr, mesh: Mesh, axis: str = AXIS,
                              engine: str = "auto"):
    """This rank's independent CBC streams ((S_local, N, 4) or (S_local,
    4N) words, (S_local, 4) IVs): each rank runs its streams' recurrences at
    once (on the card one ``seq_encrypt`` launch), no communication. Returns
    (outputs, final IVs). ``shard_rows`` pads the stream axis with zero
    streams, which leave the real ones as they are."""
    del axis
    _member(mesh)
    return aes_mod.cbc_encrypt_words_batch(words, ivs, rk, nr, engine)


def arc4_prep_batch_sharded(states: torch.Tensor, length: int, mesh: Mesh, axis: str = AXIS):
    """Keystreams of this rank's independent ARC4 streams: ``states`` the
    (S_local, 258) int32 state rows (``models/arc4.py``; ``state_from_numpy``
    takes the JAX package's ``(x, y, m)``). Each rank scans its own streams
    (on the card one ``arc4_prga`` launch), no communication. Returns
    (states', keystream (S_local, length) uint8)."""
    del axis
    _member(mesh)
    return arc4_mod.keystream_scan_batch(states, length)
