"""Sweep backends: one protocol, two execution tiers (``our_tree_tpu.harness.backends``).

A backend is an object with a small protocol (``ecb`` / ``ctr`` / ``cbc`` /
``cfb128`` / ``arc4_setup_prep`` / ``arc4_crypt`` ...) and one sweep loop
(``harness/bench.py``) serves them all:

* ``"gpu"``: ``GpuBackend``, the port's paths on one device (the card by
  default, the CPU when asked), through the engine registry of
  ``models/aes.py``: on the card ECB is ``ecb_encrypt_kernel``, ECB and CBC
  decrypt ``ecb_decrypt_kernel``, CTR ``ctr_gen``, the CBC/CFB128 encrypts
  and the CBC batch ``seq_encrypt_kernel``, the ARC4 keystreams
  ``arc4_prga_kernel``. Workers map to ranks of a ``torch.distributed``
  world, one device each (ROADMAP.md, "Multi-device"): a row of W > 1
  workers shards over the first W ranks through ``parallel/dist.py``, as
  the JAX backend shards over W devices; without a world it raises and
  names the launch (``python -m torch.distributed.run --nproc-per-node W -m
  our_tree_tpu_torch.harness.bench ...``).
* ``"c"``: the native C tier (``runtime/native.py``), pthread workers.

Under a world every rank runs each row on the same global data (the same
seed), and a sharded call takes its rank's shard of it (``shard_rows``) and
returns its rank's output shard; ``gather`` assembles the whole for the
checks, outside the timed calls. A rank outside a row's first W ranks runs
that row unsharded. A sharded row's times are its slowest rank's
(``row_times``, an all-reduce MAX). By ``--timing``: ``e2e`` stages the
whole message on every rank's device, then takes the shard; ``device-sync``
times each rank's call to its synchronize; ``device`` takes each rank's
chained difference, its carry XORed into the whole message on every rank.
On a gloo world over card tensors (ranks sharing one card) the collectives
run through host memory, which a CUDA graph cannot capture, so there the
chained passes run eagerly.

Nothing here imports torch until a ``GpuBackend`` is made, so a ``--backend
c`` sweep (and the ``--isolate`` supervisor) never loads it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np

from ..obs import trace
from ..resilience import degrade, faults, watchdog

#: ``--engine`` names of the gpu backend -> the port's engine registry
#: (``models/aes.py``): ``cuda`` the hand-written kernels, ``bitslice``
#: their plain versions, ``ttable`` the T-table oracle.
ENGINES = {"auto": "auto", "cuda": "cuda", "bitslice": "bitslice",
           "ttable": "ttable"}
#: ``OT_ARC4_PREP`` values: where a single stream's keystream is made.
ARC4_PREP = ("auto", "native", "device")


class GpuBackend:
    """The port on one device: the card (``device="cuda"``, the default,
    raising without one) or the CPU (``device="cpu"``, the plain versions)."""

    name = "gpu"

    #: Chained-difference timings below this are jitter artifacts, emitted
    #: as exactly this sentinel (``bench._derived`` leaves them out).
    FLOOR_US = 1

    def __init__(self, engine: str = "auto", device=None):
        import torch

        from ..models import aes, arc4
        from ..ops import cuda_aes, cuda_arc4
        from ..parallel import dist
        from ..utils import packing

        self._torch, self._aes, self._arc4, self._packing = torch, aes, arc4, packing
        self._dist = dist
        self.device = aes.as_device(device)
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; the gpu backend takes "
                             f"{sorted(ENGINES)}")
        self.engine = aes.resolve_engine(ENGINES[engine], self.device)
        import torch.distributed as tdist

        self._world = tdist.is_available() and tdist.is_initialized()
        # The world's ranks are the workers: 1 without a world.
        self.max_workers = tdist.get_world_size() if self._world else 1
        self._meshes: dict = {}
        self._graphs = not (self._world and tdist.get_backend() == "gloo")
        self._wrappers = {"ctr_gen": cuda_aes.ctr_crypt_words_fused,
                          "ecb_encrypt": cuda_aes.encrypt_words,
                          "ecb_decrypt": cuda_aes.decrypt_words,
                          "seq_encrypt": cuda_aes.seq_encrypt,
                          "arc4_prga": cuda_arc4.prga}

        # Where a single stream's keystream is made, resolved once here so a
        # native build never lands inside a timed region, and so a demotion
        # is visible: auto, the native C tier when it builds, else the card
        # (a degrade() event and a stderr line); native, the C tier or
        # raise; device, the ARC4 kernel.
        mode = os.environ.get("OT_ARC4_PREP", "auto")
        if mode not in ARC4_PREP:
            raise ValueError(f"OT_ARC4_PREP must be {'|'.join(ARC4_PREP)}, got {mode!r}")
        self._arc4_native = None
        if mode != "device":
            try:
                from ..runtime import native

                native.load()
                self._arc4_native = native.NativeARC4
            except Exception as e:
                if mode == "native":
                    raise
                degrade.degrade("native->device",
                                f"native runtime unavailable ({type(e).__name__})")
                print(f"# arc4 prep: native runtime unavailable ({type(e).__name__}); keygen "
                      "rows will time the ARC4 kernel", file=sys.stderr)

    # -- helpers -----------------------------------------------------------
    def _mesh(self, workers: int):
        """The mesh a row of ``workers`` shards over (``make_mesh``, cached),
        or None where it runs unsharded: one worker, or this rank outside the
        first ``workers`` ranks. Without a world of that many ranks it raises
        and names the launch."""
        if workers == 1:
            return None
        launch = (f"launch python -m torch.distributed.run --nproc-per-node {workers} -m "
                  "our_tree_tpu_torch.harness.bench ... (ROADMAP.md, \"Multi-device\")")
        if not self._world:
            raise ValueError(f"{workers} workers need a torch.distributed world of {workers} "
                             f"ranks, one a device: {launch}")
        if workers > self.max_workers:
            raise ValueError(f"{workers} workers exceed the world of {self.max_workers} "
                             f"ranks: {launch}")
        mesh = self._meshes.get(workers)
        if mesh is None:
                mesh = self._meshes[workers] = self._dist.make_mesh(workers)
        return mesh if mesh.member else None

    def gather(self, out, workers: int, n: int):
        """A call's whole output from this rank's output shard (the first
        ``n`` rows of the all-gather); an unsharded output as it is."""
        mesh = self._mesh(workers)
        if mesh is None:
            return out
        return self._dist.gather_for_verification(out, mesh, n)

    def row_times(self, times: list, workers: int) -> list:
        """A sharded row's times, each its slowest rank's."""
        mesh = self._mesh(workers)
        if mesh is None:
            return times
        t = self._torch.tensor(times, dtype=self._torch.int64)
        return [int(v) for v in self._dist.all_reduce_max(t, mesh)]

    def launch_counts(self) -> dict[str, int]:
        """Kernel launches so far, by kernel (the sweep's proof of route)."""
        return {name: fn.launches for name, fn in self._wrappers.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)

    def stage_words(self, data: np.ndarray):
        """Byte buffer -> flat int32 LE words on the device (the H2D step)."""
        p = self._packing
        return p.words_tensor(p.np_bytes_to_words(np.ascontiguousarray(data)), self.device)

    def block_until_ready(self, x):
        """Completion barrier for timed regions: a device synchronize. Carries
        the ``dispatch_fail`` and ``dispatch_hang`` injection points."""
        with trace.span("barrier", seam="GpuBackend.block_until_ready"):
            faults.check("dispatch_fail", "GpuBackend.block_until_ready")
            watchdog.injected_hang("dispatch_hang", "GpuBackend.block_until_ready")
            self._sync()
        return x

    def chained_device_times_us(self, crypt, words, iters: int, k: int):
        """Per-pass device µs by the chained difference: ``crypt(words, acc)``
        1 + k times, each pass's carry (the int32 sum of its output, whose
        low 32 bits equal the reference's uint32 sum) threaded into an input
        the work depends on, then one scalar readback; each reported time is
        (T(1+k) - T(1)) / k. On the card each chain is captured once as a CUDA
        graph and replayed, the counterpart of the reference's one compiled
        dispatch, so the host's launch time is outside the difference. On the
        CPU the chain runs eagerly and k is clamped to 4, as the reference
        clamps its CPU rows."""
        torch = self._torch
        if self.device.type != "cuda":
            k = min(k, 4)
        cuda = self.device.type == "cuda" and self._graphs

        def chain(kk):
            acc = torch.zeros((), dtype=torch.int32, device=self.device)
            for _ in range(kk):
                acc = crypt(words, acc).sum(dtype=torch.int32)
            return acc

        if cuda:
            chain(1)  # builds and loads the kernels before any capture
            graphs = {}
            for kk in (1, 1 + k):
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    chain(1)
                torch.cuda.current_stream(self.device).wait_stream(side)
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    acc = chain(kk)
                graphs[kk] = (g, acc)

            def dispatch(kk):
                g, acc = graphs[kk]
                g.replay()
                return int(acc)
        else:
            def dispatch(kk):
                return int(chain(kk))

        def run(kk):
            with trace.span("chained-dispatch", k=int(kk),
                            seam="GpuBackend.chained_device_times_us"):
                faults.check("dispatch_fail", "GpuBackend.chained_device_times_us")
                watchdog.injected_hang("dispatch_hang", "GpuBackend.chained_device_times_us")
                t0 = time.perf_counter()
                dispatch(kk)
                return time.perf_counter() - t0

        run(1)  # warm
        t1 = min(run(1) for _ in range(2))
        return [max(int((run(1 + k) - t1) / k * 1e6), self.FLOOR_US) for _ in range(iters)]

    # -- AES ---------------------------------------------------------------
    def make_key(self, key: bytes):
        return self._aes.AES(key, engine=self.engine, device=self.device)

    def ecb(self, ctx, words, workers: int):
        mesh = self._mesh(workers)
        if mesh is None:
            return self._aes.ecb_encrypt_words(words, ctx.rk_enc, ctx.nr, self.engine)
        return self._dist.ecb_crypt_sharded(self._dist.shard_rows(words, mesh, words=True),
                                            ctx.rk_enc, ctx.nr, mesh, engine=self.engine)

    def ecb_dec(self, ctx, words, workers: int):
        mesh = self._mesh(workers)
        if mesh is None:
            return self._aes.ecb_decrypt_words(words, ctx.rk_dec, ctx.nr, self.engine)
        return self._dist.ecb_crypt_sharded(self._dist.shard_rows(words, mesh, words=True),
                                            ctx.rk_dec, ctx.nr, mesh, encrypt=False,
                                            engine=self.engine)

    def cbc_dec(self, ctx, words, iv_words, workers: int):
        """CBC decrypt: one batched inverse cipher and a shifted XOR; sharded,
        the one-block halo from the left neighbour (``cbc_decrypt_sharded``)."""
        mesh = self._mesh(workers)
        if mesh is None:
            out, _ = self._aes.cbc_decrypt_words(words, iv_words, ctx.rk_dec, ctx.nr,
                                                 self.engine)
            return out
        local = self._dist.shard_rows(words, mesh, words=True, chained=True)
        return self._dist.cbc_decrypt_sharded(local, iv_words, ctx.rk_dec, ctx.nr, mesh,
                                              engine=self.engine)

    def ctr(self, ctx, words, ctr_be, workers: int):
        mesh = self._mesh(workers)
        if mesh is None:
            return self._aes.ctr_crypt_words(words, ctr_be, ctx.rk_enc, ctx.nr, self.engine)
        return self._dist.ctr_crypt_sharded(self._dist.shard_rows(words, mesh, words=True),
                                            ctr_be, ctx.rk_enc, ctx.nr, mesh, engine=self.engine)

    def ctr_stream(self, ctx, msg: np.ndarray, nonce: np.ndarray, chunk_bytes: int,
                   workers: int) -> np.ndarray:
        """CTR over a message larger than the device holds: stage, encrypt and
        read back chunk by chunk, carrying the 128-bit counter across the
        seams on the host. Double-buffered over two CUDA streams: chunk i's
        copy in, kernel and copy out run on one stream while chunk i - 1's
        readback drains on the other. Sharded, each chunk is cut over the
        ranks and gathered at its readback."""
        torch = self._torch
        self._mesh(workers)
        chunk_bytes -= chunk_bytes % 16
        if chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be at least one 16-byte block")
        out = np.empty_like(msg)
        nonce = np.array(nonce, dtype=np.uint8, copy=True)
        cuda = self.device.type == "cuda"
        streams = ([torch.cuda.Stream(self.device) for _ in range(2)] if cuda else [None, None])

        def on(stream):
            return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

        pending = None  # (dst offset, blocks, output words, stream)

        def drain(p):
            off_p, nfull_p, o, stream = p
            with on(stream):
                words = self._packing.words_numpy(self.gather(o, workers, nfull_p * 4)).reshape(-1)
            out[off_p: off_p + nfull_p * 16] = self._packing.np_words_to_bytes(words).reshape(-1)

        for i, off in enumerate(range(0, msg.size, chunk_bytes)):
            part = msg[off: off + chunk_bytes]
            nfull = part.size // 16
            if nfull:
                stream = streams[i % 2]
                if stream is not None:
                    stream.wait_stream(torch.cuda.current_stream(self.device))
                with on(stream):
                    words = self.stage_words(part[: nfull * 16])
                    o = self.ctr(ctx, words, self.ctr_be_words(nonce), workers)
                if pending is not None:
                    drain(pending)
                pending = (off, nfull, o, stream)
                nonce = self._aes._inc_counter_bytes(nonce, nfull)
            if part.size % 16:  # the trailing partial block (last chunk only)
                tail_out, _, nonce, _ = ctx.crypt_ctr(0, nonce, np.zeros(16, np.uint8),
                                                      part[nfull * 16:])
                out[off + nfull * 16: off + part.size] = tail_out
        if pending is not None:
            drain(pending)
        return out

    def cbc(self, ctx, words, iv_words, workers: int):
        if workers != 1:
            raise ValueError("single-stream CBC encrypt is a sequential recurrence and cannot "
                             "shard over workers; use cbc-batch (independent streams) for "
                             "multi-worker scaling")
        out, _ = self._aes.cbc_encrypt_words(words, iv_words, ctx.rk_enc, ctx.nr, self.engine)
        return out

    def cfb128(self, ctx, words, iv_words, workers: int):
        if workers != 1:
            raise ValueError("single-stream CFB128 encrypt is a sequential recurrence and "
                             "cannot shard over workers; batch independent streams instead")
        out, _ = self._aes.cfb128_encrypt_words(words, iv_words, ctx.rk_enc, ctx.nr,
                                                self.engine)
        return out

    # -- independent streams ----------------------------------------------
    def stage_batch_words(self, data2d: np.ndarray):
        """(S, bytes a stream) byte matrix -> (S, 4N) int32 words on the device."""
        p = self._packing
        w = p.np_bytes_to_words(np.ascontiguousarray(data2d).reshape(-1))
        return p.words_tensor(w.reshape(data2d.shape[0], -1), self.device)

    def cbc_batch(self, ctx, words_2d, ivs_2d, workers: int):
        """S independent CBC-encrypt streams in one chained-encrypt call;
        sharded, each rank its streams (``cbc_encrypt_batch_sharded``)."""
        mesh = self._mesh(workers)
        if mesh is None:
            out, _ = self._aes.cbc_encrypt_words_batch(words_2d, ivs_2d, ctx.rk_enc, ctx.nr,
                                                       self.engine)
            return out
        out, _ = self._dist.cbc_encrypt_batch_sharded(
            self._dist.shard_rows(words_2d, mesh), self._dist.shard_rows(ivs_2d, mesh),
            ctx.rk_enc, ctx.nr, mesh, engine=self.engine)
        return out

    def arc4_batch_states(self, keys: list[bytes]):
        """Host KSA for S streams -> their (S, 258) state stack on the device."""
        return self._arc4.ARC4.batch_states(keys, self.device)

    def arc4_prep_batch(self, states, length: int, workers: int):
        """S independent keystreams, (S, length) uint8 on the device: one
        ARC4 kernel launch on the card (a rank, sharded)."""
        mesh = self._mesh(workers)
        if mesh is None:
            _, ks = self._arc4.keystream_scan_batch(states, length)
            return ks
        _, ks = self._dist.arc4_prep_batch_sharded(self._dist.shard_rows(states, mesh), length,
                                                   mesh)
        return ks

    def ctr_be_words(self, nonce: np.ndarray):
        p = self._packing
        return p.words_tensor(p.np_bytes_to_words(nonce).byteswap(), self.device)

    def iv_words(self, iv: np.ndarray):
        p = self._packing
        return p.words_tensor(p.np_bytes_to_words(iv), self.device)

    # -- ARC4 --------------------------------------------------------------
    def arc4_setup_prep(self, key: bytes, length: int):
        """Key schedule and keystream of one stream, as host bytes: on the
        native C tier, or on the card (``OT_ARC4_PREP``, resolved at
        construction)."""
        if self._arc4_native is not None:
            return self._arc4_native(key).prep(length)
        return self._arc4.ARC4(key, device=self.device).prep(length)

    def arc4_crypt(self, data_dev, ks_dev, workers: int):
        mesh = self._mesh(workers)
        if mesh is None:
            return self._arc4.crypt(data_dev, ks_dev)
        if data_dev.shape != ks_dev.shape:  # refused before any padding
            return self._dist.xor_sharded(data_dev, ks_dev, mesh)
        return self._dist.xor_sharded(self._dist.shard_rows(data_dev, mesh),
                                      self._dist.shard_rows(ks_dev, mesh), mesh)

    def to_device(self, arr):
        if isinstance(arr, self._torch.Tensor):
            return arr.to(self.device)
        return self._torch.from_numpy(np.require(arr, None, ["C", "W"])).to(self.device)


def make_backend(name: str, engine: str = "auto", device=None):
    if name == "gpu":
        return GpuBackend(engine, device)
    if name == "c":
        from ..runtime.native import CBackend

        return CBackend()
    raise ValueError(f"unknown backend {name!r} (expected 'gpu' or 'c')")
