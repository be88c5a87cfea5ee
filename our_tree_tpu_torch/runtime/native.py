"""ctypes bindings for the native C tier and the ``--backend c`` sweep backend.

Copy of ``our_tree_tpu.runtime.native``, over the port's own copy of the C
sources (``runtime/csrc``: ``ot_aes.c``, ``ot_aesni.c``, ``ot_arc4.c``,
``ot_parallel.c``, ``ot_crypt.h``). ``load()`` builds ``libotcrypt.so`` with
the system C compiler (``$CC``, else ``cc``) at first use into
``_build/native/`` beside the package (listed in ``.gitignore``), under a
name keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the build. An ``fcntl`` lock keeps concurrent
processes from racing on one build; each compiler run goes through
``isolate.run_child`` (a wall deadline, ``OT_BUILD_DEADLINE`` seconds,
default 600, and a group kill), two attempts through ``RetryPolicy``, and
carries the ``build_fail`` injection point. A failed build raises.

Buffers cross the boundary as numpy arrays, zero-copy. Bulk calls are
pthread-parallel with the reference harnesses' contiguous-chunk split, and
use AES-NI when the CPU has it (``OT_C_FORCE_PORTABLE`` pins the portable
core).

``ot_bench_path()`` builds the C sweep (``csrc/ot_bench_main.c``: ``ot_bench
--backend=c`` sweeps the C tier, ``--backend=gpu`` embeds CPython and hands
the same arguments to ``our_tree_tpu_torch.harness.bench``) into the same
directory, under the same hash key, lock and deadline. It links libpython,
with ``-DOT_WITH_PYTHON``, only where ``python3-config --embed`` answers;
without it the ``c`` sweep still builds and ``--backend=gpu`` exits 1 with a
message.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil

import numpy as np

from ..obs import trace
from ..resilience import faults, isolate, policy

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build" / "native"
SOURCES = ("ot_aes.c", "ot_arc4.c", "ot_parallel.c", "ot_aesni.c")
CFLAGS = ["-O2", "-Wall", "-Wextra", "-fPIC", "-std=c11", "-pthread"]
_lib = None


class AesCtx(ctypes.Structure):
    _fields_ = [("nr", ctypes.c_int), ("rk", ctypes.c_uint8 * (15 * 16))]


class Arc4Ctx(ctypes.Structure):
    _fields_ = [("x", ctypes.c_int), ("y", ctypes.c_int), ("m", ctypes.c_uint8 * 256)]


def _cc() -> str:
    return os.environ.get("CC") or "cc"


def library_path(build_dir: pathlib.Path | None = None) -> pathlib.Path:
    h = hashlib.sha256(" ".join([_cc(), *CFLAGS]).encode())
    for name in sorted(p.name for p in CSRC.iterdir() if p.suffix in (".c", ".h")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return (build_dir or BUILD_DIR) / f"libotcrypt_{h.hexdigest()[:16]}.so"


def _run(argv: list[str], what: str) -> None:
    r = isolate.run_child(argv, float(os.environ.get("OT_BUILD_DEADLINE", 600)),
                          name=f"native-build-{what}")
    if not r.ok:
        raise RuntimeError(f"native runtime build failed ({r.kind}, {what}):\n{r.out}\n{r.err}")


def build(so: pathlib.Path) -> None:
    """Compile each source (``ot_aesni.c`` alone with ``-maes``: the AES-NI
    path is gated on cpuid at run time) and link the shared library into
    ``so``, through a temporary directory and an atomic rename."""
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)

    def attempt(_attempt):
        faults.check("build_fail", "native runtime build")
        objs = []
        for src in SOURCES:
            obj = tmp / (pathlib.Path(src).stem + ".o")
            extra = ["-maes"] if src == "ot_aesni.c" else []
            _run([_cc(), *CFLAGS, *extra, "-c", "-o", str(obj), str(CSRC / src)], src)
            objs.append(str(obj))
        _run([_cc(), "-shared", "-pthread", "-o", str(tmp / "lib.so"), *objs], "link")

    try:
        with trace.span("native-build", target=so.name):
            policy.RetryPolicy(attempts=2, base_delay_s=0.5, retry_on=(RuntimeError,),
                               name="native-build").run(attempt)
        os.replace(tmp / "lib.so", so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _python_embed_flags() -> tuple[list[str], list[str]] | None:
    """(compile flags, link flags) for embedding CPython, from
    ``python3-config --includes`` and ``--ldflags --embed``; None where it
    does not answer."""
    cfg = shutil.which("python3-config")
    if cfg is None:
        return None
    try:
        inc = isolate.run_child([cfg, "--includes"], 60, name="python3-config")
        ld = isolate.run_child([cfg, "--ldflags", "--embed"], 60, name="python3-config")
    except OSError:
        return None
    if not (inc.ok and ld.ok and inc.out.strip()):
        return None
    return ["-DOT_WITH_PYTHON", *inc.out.split()], ld.out.split()


def ot_bench_path(build_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Build (if needed) the C sweep ``ot_bench`` beside the library and
    return its path. Its name carries the library's hash and the embedding
    flags' (or ``noembed``), so another Python rebuilds it;
    ``ot_bench_embeds(path)`` says whether it takes ``--backend=gpu``."""
    embed = _python_embed_flags()
    tag = hashlib.sha256(repr(embed).encode()).hexdigest()[:8] if embed else "noembed"
    lib = library_path(build_dir)
    exe = lib.with_name(f"{lib.stem.replace('libotcrypt_', 'ot_bench_')}_{tag}")
    exe.parent.mkdir(parents=True, exist_ok=True)
    with open(exe.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not exe.exists():
                _build_ot_bench(exe, embed)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return exe


def ot_bench_embeds(exe: pathlib.Path) -> bool:
    """Whether the built ``ot_bench`` carries the embedded interpreter."""
    return not exe.name.endswith("_noembed")


def _build_ot_bench(exe: pathlib.Path, embed) -> None:
    tmp = exe.with_name(f"{exe.name}.tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)

    def attempt(_attempt):
        faults.check("build_fail", "native ot_bench build")
        objs = []
        for src in SOURCES:
            obj = tmp / (pathlib.Path(src).stem + ".o")
            extra = ["-maes"] if src == "ot_aesni.c" else []
            _run([_cc(), *CFLAGS, *extra, "-c", "-o", str(obj), str(CSRC / src)], src)
            objs.append(str(obj))
        cflags, ldflags = embed or ([], [])
        _run([_cc(), *CFLAGS, *cflags, "-o", str(tmp / "ot_bench"), str(CSRC / "ot_bench_main.c"),
              *objs, *ldflags, "-lpthread"], "ot_bench")

    try:
        with trace.span("native-build", target=exe.name):
            policy.RetryPolicy(attempts=2, base_delay_s=0.5, retry_on=(RuntimeError,),
                               name="native-build").run(attempt)
        os.replace(tmp / "ot_bench", exe)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load(build_dir: pathlib.Path | None = None):
    """Build (if needed) and load the native library, with typed signatures.
    ``build_dir`` builds and loads a library there instead of the package's
    cached one (tests)."""
    global _lib
    if _lib is not None and build_dir is None:
        return _lib
    so = library_path(build_dir)
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so.exists():
                build(so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = _bind(ctypes.CDLL(str(so)))
    if build_dir is None:
        _lib = lib
    return lib


_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _bind(lib):
    aes_p = ctypes.POINTER(AesCtx)
    lib.ot_aes_setkey.argtypes = [aes_p, _u8p, ctypes.c_int]
    lib.ot_aes_setkey.restype = ctypes.c_int
    lib.ot_aes_ecb.argtypes = [aes_p, ctypes.c_int, _u8p, _u8p, ctypes.c_size_t, ctypes.c_int]
    lib.ot_aes_ctr.argtypes = [aes_p, _u8p, _u8p, _u8p, ctypes.c_size_t, ctypes.c_int]
    lib.ot_aes_cbc_encrypt.argtypes = [aes_p, _u8p, _u8p, _u8p, ctypes.c_size_t]
    lib.ot_aes_cbc_decrypt.argtypes = [aes_p, _u8p, _u8p, _u8p, ctypes.c_size_t, ctypes.c_int]
    lib.ot_aes_cfb128.argtypes = [aes_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int), _u8p, _u8p,
                                  _u8p, ctypes.c_size_t]
    lib.ot_arc4_setup.argtypes = [ctypes.POINTER(Arc4Ctx), _u8p, ctypes.c_size_t]
    lib.ot_arc4_prep.argtypes = [ctypes.POINTER(Arc4Ctx), _u8p, ctypes.c_size_t]
    lib.ot_xor.argtypes = [_u8p, _u8p, _u8p, ctypes.c_size_t, ctypes.c_int]
    lib.ot_aesni_available.argtypes = []
    lib.ot_aesni_available.restype = ctypes.c_int
    return lib


def aesni_available() -> bool:
    """True when the CPU's AES-NI path is usable (cpuid; the library also
    honours ``OT_C_FORCE_PORTABLE``)."""
    return bool(load().ot_aesni_available())


#: Blocks per ECB thread before another thread pays for itself (the
#: reference's threshold, 16 K blocks = 256 KiB).
_THREAD_BLOCKS = 16384


def _default_threads(nblocks: int) -> int:
    """One thread per ``_THREAD_BLOCKS`` chunk, at most the core count, at
    least one."""
    return max(1, min(os.cpu_count() or 1, nblocks // _THREAD_BLOCKS))


def aes_ctx_from_schedule(nr: int, rk_words: np.ndarray) -> AesCtx:
    """An ``AesCtx`` primed from an expanded schedule, no setkey.
    ``rk_words``: (4*(nr+1),) u32 LE round-key words (the
    ``ops.keyschedule.expand_key_enc`` layout), whose bytes are the C
    context's ``rk[15][16]`` blocks."""
    load()
    nr = int(nr)
    if not 0 < nr <= 14:
        raise ValueError(f"nr={nr} out of range for the C context "
                         "(AES-128/192/256 = 10/12/14 rounds)")
    ctx = AesCtx()
    ctx.nr = nr
    b = np.ascontiguousarray(rk_words, dtype="<u4").view(np.uint8)
    if b.size != 16 * (nr + 1):
        raise ValueError(f"schedule has {b.size} bytes, expected {16 * (nr + 1)}")
    ctypes.memmove(ctx.rk, b.ctypes.data, b.size)
    return ctx


def ctr_scattered_words(ctxs, words: np.ndarray, ctr_words: np.ndarray,
                        key_slots: np.ndarray | None = None, nthreads: int = 0) -> np.ndarray:
    """Scattered CTR on the native tier: out = ECB(counters) ^ data, the
    host twin of ``models.aes.ctr_crypt_words_scattered_multikey``.
    ``words``/``ctr_words``: flat (4N,) u32 LE arrays; ``ctxs``: one
    ``AesCtx`` per key slot; ``key_slots``: (N,) slot indices (None: all
    slot 0). Blocks of one slot in a run are one threaded ECB call; one
    vectorised XOR follows. ``nthreads`` 0 picks one thread per 256 KiB."""
    lib = load()
    words = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1)
    ctr_b = np.ascontiguousarray(ctr_words, dtype="<u4").reshape(-1).view(np.uint8)
    n = words.size // 4
    if ctr_b.size != 16 * n:
        raise ValueError(f"ctr_words holds {ctr_b.size // 16} blocks for a {n}-block batch")
    ks = np.empty_like(ctr_b)
    if key_slots is None:
        runs = [(0, 0, n)]
    else:
        key_slots = np.asarray(key_slots).reshape(-1)
        if key_slots.size != n:
            raise ValueError(f"key_slots has {key_slots.size} entries for a {n}-block batch")
        if not key_slots.any():
            runs = [(0, 0, n)]
        else:
            edges = np.flatnonzero(np.diff(key_slots)) + 1
            bounds = np.concatenate(([0], edges, [n]))
            runs = [(int(key_slots[int(a)]), int(a), int(b))
                    for a, b in zip(bounds[:-1], bounds[1:])]
    for slot, start, stop in runs:
        nb = stop - start
        if nb <= 0:
            continue
        t = nthreads or _default_threads(nb)
        lib.ot_aes_ecb(ctypes.byref(ctxs[slot]), 1, ctr_b[16 * start:16 * stop],
                       ks[16 * start:16 * stop], nb, t)
    ks_w = ks.view("<u4")
    np.bitwise_xor(ks_w, words, out=ks_w)
    return ks_w


def ctr_requests_words(ctxs, words: np.ndarray, runs, nthreads: int = 0) -> np.ndarray:
    """Per-request CTR on the native tier, the counters kept in C: ``runs``
    is ``[(slot, start_block, nblocks, nonce16), ...]`` (disjoint ranges of
    the batch), each one ``ot_aes_ctr`` call. Blocks no run covers are
    zeroed."""
    lib = load()
    words = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1)
    data = words.view(np.uint8)
    out = np.empty_like(data)
    n = words.size // 4
    nonce = np.empty(16, dtype=np.uint8)
    for slot, start, nb, nonce_bytes in runs:
        if nb <= 0:
            continue
        if start < 0 or start + nb > n:
            raise ValueError(f"run ({start}, {nb}) exceeds the {n}-block buffer")
        if not 0 <= slot < len(ctxs):
            raise ValueError(f"run slot {slot} outside {len(ctxs)} ctxs")
        t = nthreads or _default_threads(nb)
        nonce[:] = np.frombuffer(bytes(nonce_bytes), dtype=np.uint8)
        lib.ot_aes_ctr(ctypes.byref(ctxs[slot]), nonce, data[16 * start:16 * (start + nb)],
                       out[16 * start:16 * (start + nb)], 16 * nb, t)
    pos = 0
    for start, nb in sorted((s, k) for _, s, k, _ in runs if k > 0):
        if start > pos:
            out[16 * pos:16 * start] = 0
        pos = max(pos, start + nb)
    out[16 * pos:] = 0
    return out.view("<u4")


class NativeAES:
    """C-tier AES context; the surface of ``models.aes.AES`` over bytes."""

    def __init__(self, key: bytes):
        self._lib = load()
        self.key = bytes(key)
        self.ctx = AesCtx()
        kb = np.frombuffer(self.key, dtype=np.uint8)
        if self._lib.ot_aes_setkey(ctypes.byref(self.ctx), kb, len(key) * 8):
            raise ValueError(f"invalid AES key size {len(key)}")
        self.nr = self.ctx.nr

    def ecb(self, data: np.ndarray, encrypt: bool = True, nthreads: int = 1) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.size % 16:
            raise ValueError("ECB data must be a multiple of 16 bytes")
        out = np.empty_like(data)
        self._lib.ot_aes_ecb(ctypes.byref(self.ctx), int(encrypt), data, out, data.size // 16,
                             nthreads)
        return out

    def ctr(self, nonce: np.ndarray, data: np.ndarray,
            nthreads: int = 1) -> tuple[np.ndarray, np.ndarray]:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        nonce = np.ascontiguousarray(nonce, dtype=np.uint8).copy()
        out = np.empty_like(data)
        self._lib.ot_aes_ctr(ctypes.byref(self.ctx), nonce, data, out, data.size, nthreads)
        return out, nonce

    def cbc(self, iv: np.ndarray, data: np.ndarray, encrypt: bool = True,
            nthreads: int = 1) -> tuple[np.ndarray, np.ndarray]:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.size % 16:
            raise ValueError("CBC data must be a multiple of 16 bytes")
        iv = np.ascontiguousarray(iv, dtype=np.uint8).copy()
        out = np.empty_like(data)
        if encrypt:
            self._lib.ot_aes_cbc_encrypt(ctypes.byref(self.ctx), iv, data, out, data.size // 16)
        else:
            self._lib.ot_aes_cbc_decrypt(ctypes.byref(self.ctx), iv, data, out, data.size // 16,
                                         nthreads)
        return out, iv

    def cfb128(self, iv_off: int, iv: np.ndarray, data: np.ndarray,
               encrypt: bool = True) -> tuple[np.ndarray, int, np.ndarray]:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        iv = np.ascontiguousarray(iv, dtype=np.uint8).copy()
        out = np.empty_like(data)
        off = ctypes.c_int(iv_off)
        self._lib.ot_aes_cfb128(ctypes.byref(self.ctx), int(encrypt), ctypes.byref(off), iv,
                                data, out, data.size)
        return out, off.value, iv


def xor_parallel(data: np.ndarray, keystream: np.ndarray, nthreads: int = 1) -> np.ndarray:
    """Thread-parallel XOR; refuses a keystream of another shape (C would
    read past a short one)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    keystream = np.ascontiguousarray(keystream, dtype=np.uint8)
    if data.shape != keystream.shape:
        raise ValueError(f"data/keystream shape mismatch: {data.shape} vs {keystream.shape}")
    out = np.empty_like(data)
    load().ot_xor(data, keystream, out, data.size, nthreads)
    return out


class NativeARC4:
    """C-tier ARC4 context: setup, then ``prep`` keystream that resumes
    across calls."""

    def __init__(self, key: bytes):
        if len(key) == 0:
            raise ValueError("ARC4 key must be non-empty")
        self._lib = load()
        self.ctx = Arc4Ctx()
        kb = np.frombuffer(bytes(key), dtype=np.uint8)
        self._lib.ot_arc4_setup(ctypes.byref(self.ctx), kb, len(key))

    def prep(self, length: int) -> np.ndarray:
        ks = np.empty(length, dtype=np.uint8)
        self._lib.ot_arc4_prep(ctypes.byref(self.ctx), ks, length)
        return ks

    def crypt(self, data: np.ndarray, keystream: np.ndarray, nthreads: int = 1) -> np.ndarray:
        return xor_parallel(data, keystream, nthreads)


class CBackend:
    """The sweep backend protocol over the native tier (``--backend c``):
    workers are pthreads, the reference's sweep axis; staging is a no-op and
    ``block_until_ready`` the identity (C calls are synchronous)."""

    name = "c"

    def __init__(self):
        load()
        self.max_workers = os.cpu_count() or 8

    def stage_words(self, data: np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8)

    def to_device(self, arr: np.ndarray):
        return np.ascontiguousarray(arr)

    def block_until_ready(self, x):
        return x

    def make_key(self, key: bytes):
        return NativeAES(key)

    def ecb(self, ctx: NativeAES, data, workers: int):
        return ctx.ecb(data, encrypt=True, nthreads=workers)

    def ecb_dec(self, ctx: NativeAES, data, workers: int):
        return ctx.ecb(data, encrypt=False, nthreads=workers)

    def cbc_dec(self, ctx: NativeAES, data, iv, workers: int):
        out, _ = ctx.cbc(iv, data, encrypt=False, nthreads=workers)
        return out

    def ctr(self, ctx: NativeAES, data, nonce, workers: int):
        out, _ = ctx.ctr(nonce, data, nthreads=workers)
        return out

    def cbc(self, ctx: NativeAES, data, iv, workers: int):
        if workers != 1:
            raise ValueError("single-stream CBC encrypt is a sequential recurrence and cannot "
                             "split over workers (same contract as GpuBackend.cbc)")
        out, _ = ctx.cbc(iv, data, encrypt=True)
        return out

    def cfb128(self, ctx: NativeAES, data, iv, workers: int):
        if workers != 1:
            raise ValueError("single-stream CFB128 encrypt is a sequential recurrence and "
                             "cannot split over workers (same contract as GpuBackend.cfb128)")
        out, _, _ = ctx.cfb128(0, iv, data, encrypt=True)
        return out

    def ctr_be_words(self, nonce: np.ndarray):
        return np.ascontiguousarray(nonce, dtype=np.uint8)

    def iv_words(self, iv: np.ndarray):
        return np.ascontiguousarray(iv, dtype=np.uint8)

    def arc4_setup_prep(self, key: bytes, length: int):
        return NativeARC4(key).prep(length)

    def arc4_crypt(self, data, ks, workers: int):
        return xor_parallel(data, ks, workers)
