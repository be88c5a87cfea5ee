"""AES context and block modes on the card (``our_tree_tpu.models.aes``).

Words are (N, 4) or flat (4N,) ``torch.int32`` tensors holding u32 LE
block words. The counter is 4 big-endian u32 words (word 3 least
significant), and block i of a call uses counter0 + i, wrapping mod 2^128,
as the reference C ``aes_crypt_ctr`` does.

Engines (``CORES[name] = (encrypt, decrypt)`` over (N, 4) words):
``"cuda"`` is the hand-written CUDA kernels (``ops/cuda_aes.py``: ECB
encrypt and decrypt, fused CTR, multi-key scattered CTR and its single-key
explicit-counter entry, the chained CBC/CFB128 encrypt); ``"bitslice"`` is
their plain torch version; ``"ttable"`` is the T-table core
(``ops/block.py``), the reference's ``"jnp"`` engine, an oracle-only engine
(a gather path, not constant time). ``"auto"`` is the plain version on the
CPU; on a CUDA device it walks the persisted engine ranking
(``utils/ranking.py``, written by the bench's probe stage) and returns the
first engine in ``KERNEL_BACKED``, and raises when the ranking dropped them
all: nothing falls back to a plain version on a card. ``MULTIKEY_CTR`` holds each
engine's multi-key scattered-CTR core, the serve path's ``ctr`` dispatch
(``ctr_crypt_words_scattered_multikey``, engines by ``resolve_serve_engine``),
and ``MULTIKEY_CBC`` its multi-key CBC-decrypt core, the ``cbc`` dispatch
(``cbc_decrypt_words_scattered_multikey``; on the card the ``cbc_mk``
kernel).

Modes: ECB, CTR and the CBC/CFB128 decrypts are one batched engine call.
CBC and CFB128 encryption are recurrences: the reference runs them as a
``lax.scan`` over a T-table gather. ``SEQ_ENCRYPT`` holds each engine's
chained encrypt over S streams of N blocks: on the card one ``seq_encrypt``
launch per call runs the whole recurrence (``csrc/seq.cu``), every stream
and block; ``"ttable"`` runs it on the CPU as a host loop over Python
integers (``block.seq_encrypt_host``); otherwise the per-block loop, one
(S, 4) ECB call per step, with the IV on the device (for ``"bitslice"`` that
loop is the kernel's plain version, ``cuda_aes.seq_encrypt_plain``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..ops import bitslice, block, cuda_aes
from ..ops.keyschedule import dec_schedule_from_enc, expand_key_enc
from ..runtime import cuda_build, monitoring
from ..utils import packing, ranking
# The reference keeps the counter add here; the port keeps it in utils so
# that ops/cuda_aes.py's plain version can use it without an import cycle.
from ..utils.packing import add_counter_be, ctr_le_blocks  # noqa: F401

AES_ENCRYPT = 1
AES_DECRYPT = 0

CUDA_ENGINE = "cuda"
PLAIN_ENGINE = "bitslice"
TTABLE_ENGINE = "ttable"

#: (encrypt, decrypt) block cores, (words, rk, nr) -> words over (N, 4)
#: int32 words, by engine name.
CORES: dict[str, tuple] = {}
#: (words, ctr_be_words, rk, nr) -> words fused CTR entries, by engine name;
#: engines without one run CTR as keystream then XOR.
CTR_FUSED: dict[str, object] = {}
#: (words, ctr_le, rk, nr) -> words single-key CTR over given LE counters,
#: by engine name; engines without one run it as ECB of the counters, then
#: XOR.
CTR_EXPLICIT: dict[str, object] = {}
#: Multi-key scattered-CTR cores, (words, ctr_le, rks, key_slots, nr) ->
#: words over (N, 4) int32 words, where ``rks`` is a (K, 4*(nr+1)) stack of
#: schedules and ``key_slots`` the (N,) int32 public per-block slot vector:
#: one call carrying K tenants' keys (the serve rung-packer's dispatch).
MULTIKEY_CTR: dict[str, object] = {}
#: Multi-key CBC-decrypt cores, (words, prev, rks_dec, key_slots, nr) ->
#: words over (N, 4) int32 words: block i is D(words[i]) ^ prev[i] under the
#: InvMixColumns-folded schedule ``rks_dec[key_slots[i]]``, where ``prev`` is
#: the PREV stream the serve batcher lays out (each request's IV at its first
#: block, then its own ciphertext shifted by one block). P_i = D(C_i) ^
#: C_(i-1) reads only ciphertext, so decrypt batches across requests and keys
#: where CBC encrypt, a recurrence, does not.
MULTIKEY_CBC: dict[str, object] = {}
#: Chained CBC/CFB128 encrypts, (words, ivs, rk, nr, cfb) -> (out, ivs_out)
#: over (S, N, 4) int32 words and (S, 4) IVs, by engine name; engines
#: without one run the per-block loop over their ECB core.
SEQ_ENCRYPT: dict[str, object] = {}
#: The native C host tier (``runtime/native.py``): the serve path's ``ctr``
#: dispatch on the CPU through ``ctr_crypt_words_scattered_multikey``
#: (``resolve_serve_engine``).
NATIVE_ENGINE = "native"
#: The engines ``"auto"`` may pick on a card: the hand-written kernels (the
#: reference's ``PALLAS_BACKED``). ``"bitslice"`` and ``"ttable"`` are
#: not in it: the first is the kernels' plain version, the second an
#: oracle the probe measures so that the ranking has two engines.
KERNEL_BACKED = frozenset({CUDA_ENGINE})
#: (seam, engine, nr, device) of every call of the serve seams in this
#: process, seam ``"ctr"``, ``"cbc"``, ``"ghash_at"``/``"ghash_scan"`` (the
#: GCM seam's GHASH half, nr 0: its kernel has no NR instantiation),
#: ``"rc4"`` or ``"rc4-prep"``. A known key is read without the lock; a
#: first call adds its key under ``_SEAM_LOCK``.
_SEAM_CALLS: set = set()
_SEAM_LOCK = threading.Lock()


@contextlib.contextmanager
def seam_call(seam: str, engine: str, nr: int, device):
    """Wrap one call of a serve seam. The first call of each (seam, engine,
    nr, device) counts (``seam_first_calls``) and emits its host seconds, less
    any kernel-library load it triggered, as a ``SEAM_FIRST_CALL`` duration
    event; a call that raises counts too."""
    key = (seam, engine, int(nr), str(device))
    if key in _SEAM_CALLS:
        yield
        return
    t0, load0 = time.perf_counter(), cuda_build.load_seconds()
    try:
        yield
    finally:
        with _SEAM_LOCK:
            first = key not in _SEAM_CALLS
            _SEAM_CALLS.add(key)
        if first:
            monitoring.record_event_duration_secs(
                monitoring.SEAM_FIRST_CALL,
                time.perf_counter() - t0 - (cuda_build.load_seconds() - load0))


def seam_first_calls() -> int:
    """How many distinct (seam, engine, nr, device) the serve seams
    (``ctr_crypt_words_scattered_multikey``, ``cbc_decrypt_words_scattered_multikey``
    and the GHASH half of ``aead.gcm.gcm_crypt_ghash_words``) have been
    called with in this process. On the card the first launch of a kernel
    (of each NR instantiation) is when CUDA loads its code into the context
    (lazy module loading), so each first call stands for the one cost the
    JAX package's compile counter would see; the CPU counts the same first
    calls, so the serve contract reads the same on both."""
    return len(_SEAM_CALLS)


def register_core(name: str, encrypt_fn, decrypt_fn, ctr_fused_fn=None,
                  multikey_fn=None, ctr_explicit_fn=None, seq_encrypt_fn=None,
                  multikey_cbc_fn=None) -> None:
    CORES[name] = (encrypt_fn, decrypt_fn)
    if multikey_cbc_fn is not None:
        MULTIKEY_CBC[name] = multikey_cbc_fn
    if seq_encrypt_fn is not None:
        SEQ_ENCRYPT[name] = seq_encrypt_fn
    if ctr_fused_fn is not None:
        CTR_FUSED[name] = ctr_fused_fn
    if ctr_explicit_fn is not None:
        CTR_EXPLICIT[name] = ctr_explicit_fn
    if multikey_fn is not None:
        MULTIKEY_CTR[name] = multikey_fn


def _multikey_ttable(words, ctr_le, rks, key_slots, nr):
    """T-table multi-key core: gather each block's schedule by its public
    slot index and run the T-table core with the schedule as a batch
    dimension (the reference's vmapped ``_multikey_jnp``)."""
    return words ^ block.encrypt_words(ctr_le, rks[key_slots.long()].t(), nr)


def _multikey_cbc_ttable(words, prev, rks_dec, key_slots, nr):
    """T-table multi-key CBC decrypt: the public schedule gather, the T-table
    decrypt core with the schedule as a batch dimension, XOR the PREV stream
    (the reference's ``_multikey_cbc_jnp``)."""
    return block.decrypt_words(words, rks_dec[key_slots.long()].t(), nr) ^ prev


def _seq_ttable(words, ivs, rk, nr, cfb):
    """The T-table engine's chained encrypt: the host loop for CPU tensors,
    the per-block loop over its core on another device."""
    if words.device.type == "cpu":
        return block.seq_encrypt_host(words, ivs, rk, nr, cfb)
    return cuda_aes.seq_encrypt_plain(words, ivs, rk, nr, cfb, encrypt=block.encrypt_words)


register_core(CUDA_ENGINE, cuda_aes.encrypt_words, cuda_aes.decrypt_words,
              cuda_aes.ctr_crypt_words_fused, cuda_aes.ctr_scattered_multikey,
              cuda_aes.ctr_crypt_words_explicit, cuda_aes.seq_encrypt,
              cuda_aes.cbc_scattered_multikey)
register_core(PLAIN_ENGINE, bitslice.encrypt_words, bitslice.decrypt_words,
              cuda_aes.ctr_crypt_words_fused_plain, cuda_aes.ctr_scattered_multikey_plain,
              cuda_aes.ctr_crypt_words_explicit_plain,
              multikey_cbc_fn=cuda_aes.cbc_scattered_multikey_plain)
register_core(TTABLE_ENGINE, block.encrypt_words, block.decrypt_words,
              multikey_fn=_multikey_ttable, seq_encrypt_fn=_seq_ttable,
              multikey_cbc_fn=_multikey_cbc_ttable)


def as_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller asks
    for another. Raises when CUDA is asked for and no card is present; a
    caller that wants the CPU says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain torch version on the CPU")
    return dev


def rank_key(device) -> str:
    """The engine ranking's key for a device (``utils/ranking.device_key``):
    ``cuda:<card name>``, the bare ``cuda`` where no card answers, or
    ``cpu``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return ranking.device_key(dev.type)
    if not torch.cuda.is_available():
        return ranking.device_key("cuda")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return ranking.device_key("cuda", _card_name(index))


_CARD_NAMES: dict[int, str] = {}


def _card_name(index: int) -> str:
    name = _CARD_NAMES.get(index)
    if name is None:
        name = _CARD_NAMES[index] = torch.cuda.get_device_name(index)
    return name


def auto_engine(key: str) -> str:
    """``"auto"`` on a CUDA device whose ranking key is ``key``: the first
    engine of ``ranking.probe_order`` in ``KERNEL_BACKED``. Where the ranking
    dropped every kernel engine this raises ``RuntimeError`` naming the drop
    reasons: the reference demotes to its next ranked Pallas engine there
    (``_engine_compile_ok``), and on a card the next engine would be a plain
    version, which the main path never runs."""
    for eng in ranking.probe_order(key, CORES):
        if eng in KERNEL_BACKED:
            return eng
    why = "; ".join(f"{e}: {ranking.drop_reason(key, e) or 'no reason recorded'}"
                    for e in sorted(KERNEL_BACKED))
    raise RuntimeError(f"engine ranking {ranking.path()} drops every kernel engine for {key} "
                       f"({why}); the card runs no plain version in their place: re-run the "
                       f"bench's probe stage or remove the drop")


def resolve_engine(engine: str | None, device) -> str:
    """Engine name for a device: ``"auto"`` (or None) is the plain version on
    the CPU and ``auto_engine(rank_key(device))`` on a CUDA device."""
    if engine in (None, "auto"):
        dev = torch.device(device)
        return auto_engine(rank_key(dev)) if dev.type == "cuda" else PLAIN_ENGINE
    if engine not in CORES:
        raise ValueError(f"unknown engine {engine!r}; available: {sorted(CORES)}")
    return engine


_NATIVE_OK: bool | None = None


def native_runtime_available() -> bool:
    """Does the native C runtime load (building it at first use)? Memoized:
    a failed build is reported once on stderr."""
    global _NATIVE_OK
    if _NATIVE_OK is None:
        try:
            from ..runtime import native as _native

            _native.load()
            _NATIVE_OK = True
        except Exception as e:  # noqa: BLE001 - the probe is the question
            import sys

            print(f"# native runtime unavailable ({type(e).__name__}: {str(e)[:160]})",
                  file=sys.stderr)
            _NATIVE_OK = False
    return _NATIVE_OK


def resolve_serve_engine(name: str | None = "auto", device=None, modes=("ctr",)) -> str:
    """Engine for the serve dispatch path (the multi-key seams of ``modes``:
    ``"ctr"``, ``"gcm"`` and ``"gcm-open"`` on the multi-key CTR core, the
    GCM modes' GHASH on the engine's own, ``"cbc"`` on the multi-key CBC
    core).

    ``"native"`` is the native C host tier (``NATIVE_ENGINE``) and raises
    when the C runtime cannot build. ``"auto"`` on the CPU prefers it and
    demotes to the plain version through ``resilience.degrade`` when it
    cannot build; on a CUDA device ``"auto"`` is ``resolve_engine``. On a
    native-tier server only ``ctr`` runs in C: the other modes run on the
    lane's ``resolve_engine("auto", device)``. Any other name must have the
    multi-key core of every mode."""
    dev = as_device(device)
    if name == NATIVE_ENGINE:
        if not native_runtime_available():
            raise RuntimeError("engine 'native' requested but the native C runtime failed to "
                               "build or load (see stderr for the build error)")
        return NATIVE_ENGINE
    if name in (None, "auto") and dev.type == "cpu":
        if native_runtime_available():
            return NATIVE_ENGINE
        from ..resilience import degrade

        degrade.degrade(f"{NATIVE_ENGINE}->{PLAIN_ENGINE}",
                        "the native C runtime failed to build or load")
        return PLAIN_ENGINE
    engine = resolve_engine(name, dev)
    for core, cores, users in (("CTR", MULTIKEY_CTR, ("ctr", "gcm", "gcm-open")),
                               ("CBC", MULTIKEY_CBC, ("cbc",))):
        if any(m in modes for m in users) and engine not in cores:
            raise ValueError(f"engine {engine!r} has no multi-key {core} core; "
                             f"available: {sorted(cores)}")
    return engine


def _blocks(words: torch.Tensor) -> torch.Tensor:
    """(N, 4) block view of (N, 4) or flat (4N,) words."""
    return words.reshape(-1, 4)


def ecb_encrypt_words(words: torch.Tensor, rk: torch.Tensor, nr: int,
                      engine: str = "auto") -> torch.Tensor:
    """Batch ECB encrypt over (N, 4) block words or a flat (4N,) stream."""
    engine = resolve_engine(engine, words.device)
    return CORES[engine][0](_blocks(words), rk, nr).reshape(words.shape)


def ecb_decrypt_words(words: torch.Tensor, rk_dec: torch.Tensor, nr: int,
                      engine: str = "auto") -> torch.Tensor:
    """Batch ECB decrypt (InvMixColumns-folded schedule); the word forms of
    ``ecb_encrypt_words``."""
    engine = resolve_engine(engine, words.device)
    return CORES[engine][1](_blocks(words), rk_dec, nr).reshape(words.shape)


def ctr_keystream_words(ctr_be_words: torch.Tensor, rk: torch.Tensor, nr: int,
                        nblocks_idx: torch.Tensor, engine: str = "auto") -> torch.Tensor:
    """Keystream blocks E_K(counter0 + idx) as (N, 4) words; ``nblocks_idx``
    holds the (N,) block offsets, 0 <= idx < 2^63."""
    engine = resolve_engine(engine, ctr_be_words.device)
    idx = nblocks_idx.to(device=ctr_be_words.device, dtype=torch.int64)
    return CORES[engine][0](ctr_le_blocks(ctr_be_words, idx), rk, nr)


def ctr_crypt_words(words: torch.Tensor, ctr_be_words: torch.Tensor,
                    rk: torch.Tensor, nr: int, engine: str = "auto") -> torch.Tensor:
    """CTR over (N, 4) int32 block words or a flat (4N,) stream."""
    engine = resolve_engine(engine, words.device)
    w2 = _blocks(words)
    fused = CTR_FUSED.get(engine)
    if fused is not None:
        out = fused(w2, ctr_be_words, rk, nr)
    else:
        idx = torch.arange(w2.shape[0], dtype=torch.int64, device=w2.device)
        out = w2 ^ ctr_keystream_words(ctr_be_words, rk, nr, idx, engine)
    return out.reshape(words.shape)


def ctr_crypt_words_scattered(words: torch.Tensor, ctr_le_words: torch.Tensor,
                              rk: torch.Tensor, nr: int, engine: str = "auto") -> torch.Tensor:
    """CTR where every block's counter is given: (N, 4) LE counter words
    (or a flat (4N,) stream) beside the (N, 4)/(4N,) data words (the
    serving seam: a batch of requests under one key, each with its own
    nonce). The engine's explicit-counter CTR entry (on the card the
    ``ctr_mk`` kernel with one schedule, one launch), else one ECB call over
    the counters XORed into the data."""
    engine = resolve_engine(engine, words.device)
    explicit = CTR_EXPLICIT.get(engine)
    if explicit is not None:
        return explicit(_blocks(words), _blocks(ctr_le_words), rk, nr).reshape(words.shape)
    ks = CORES[engine][0](_blocks(ctr_le_words), rk, nr)
    return (words.reshape(-1) ^ ks.reshape(-1)).reshape(words.shape)


def ctr_crypt_words_scattered_multikey(words, ctr_le_words, rks, key_slots, nr: int,
                                       engine: str = "auto", *, native_ctxs=None,
                                       native_threads: int = 0, native_runs=None):
    """Scattered CTR where one call carries K independent keys.

    The multi-key serve seam: ``rks`` is a (K, 4*(nr+1)) int32 stack of
    schedules (unused slots hold the all-zero schedule, so the call's shape
    is closed over K) and ``key_slots`` a (N,) int32 vector mapping each
    block to its slot. The slot vector is public: it comes from batch
    layout, never from key or payload bytes. ``words``/``ctr_le_words``
    are (N, 4) or flat (4N,) int32 words; the result has ``words``' shape.

    ``engine="native"`` runs the host tier on CPU tensors or uint32 numpy
    arrays (the result is of the same kind): per-slot threaded ECB runs over
    the contiguous key segments, then one XOR
    (``runtime.native.ctr_scattered_words``). ``native_ctxs`` hands in
    contexts built beforehand (the serve key cache's), so a steady dispatch
    does no key setup, ``native_threads`` overrides the size-based thread
    count, and ``native_runs``, the batch's request layout ``[(slot,
    start_block, nblocks, nonce16), ...]``, switches to the per-request C
    CTR (``runtime.native.ctr_requests_words``): the counters are made in C
    and ``ctr_le_words`` may be None. The other engines ignore them."""
    if engine == NATIVE_ENGINE:
        return _ctr_native(words, ctr_le_words, rks, key_slots, nr, native_ctxs,
                           native_threads, native_runs)
    engine = resolve_engine(engine, words.device)
    with seam_call("ctr", engine, nr, words.device):
        out = MULTIKEY_CTR[engine](_blocks(words), _blocks(ctr_le_words), rks, key_slots, nr)
    return out.reshape(words.shape)


def _host_u32(a) -> np.ndarray | None:
    """A CPU tensor or an array as host uint32 (the same bits); None stays
    None."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"the native engine runs on host arrays, got a tensor on {a.device}")
        return a.contiguous().numpy().view(np.uint32)
    return np.asarray(a).astype(np.uint32, copy=False)


def _ctr_native(words, ctr_le_words, rks, key_slots, nr, ctxs, nthreads, runs):
    from ..runtime import native

    w = _host_u32(words)
    if ctxs is None:
        ctxs = [native.aes_ctx_from_schedule(int(nr), r) for r in _host_u32(rks)]
    if runs is not None:
        out = native.ctr_requests_words(ctxs, w.reshape(-1), runs, nthreads=nthreads)
    else:
        out = native.ctr_scattered_words(ctxs, w.reshape(-1), _host_u32(ctr_le_words).reshape(-1),
                                         _host_u32(key_slots), nthreads=nthreads)
    out = out.reshape(w.shape)
    return torch.from_numpy(out.view(np.int32)) if isinstance(words, torch.Tensor) else out


def cbc_decrypt_words_scattered_multikey(words: torch.Tensor, prev_words: torch.Tensor,
                                         rks_dec: torch.Tensor, key_slots: torch.Tensor,
                                         nr: int, engine: str = "auto") -> torch.Tensor:
    """Parallel CBC decrypt across many requests and K keys in one call (on
    the card, one ``cbc_mk`` launch).

    ``words`` are the concatenated ciphertext blocks and ``prev_words`` the
    per-block XOR stream: each request's IV at its first block, then its own
    ciphertext shifted by one block (the serve batcher lays it out as it
    lays out CTR's counters, so CBC rides the rung-packer with the same
    shapes). ``rks_dec`` is the (K, 4*(nr+1)) int32 stack of
    InvMixColumns-folded decrypt schedules (unused slots all zero),
    ``key_slots`` the (N,) int32 public per-block slot vector. Any N, not
    only the rungs; (N, 4) or flat (4N,) words, the result in ``words``'
    shape. CBC encrypt is a recurrence and is not servable."""
    engine = resolve_engine(engine, words.device)
    with seam_call("cbc", engine, nr, words.device):
        out = MULTIKEY_CBC[engine](_blocks(words), _blocks(prev_words), rks_dec, key_slots, nr)
    return out.reshape(words.shape)


def _seq_encrypt(words: torch.Tensor, ivs: torch.Tensor, rk: torch.Tensor, nr: int,
                 cfb: bool, engine: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The engine's chained encrypt of (S, N, 4) words under (S, 4) IVs, or
    the per-block loop over its ECB core."""
    fn = SEQ_ENCRYPT.get(engine)
    if fn is not None:
        return fn(words.contiguous(), ivs.contiguous(), rk, nr, cfb)
    return cuda_aes.seq_encrypt_plain(words, ivs, rk, nr, cfb, encrypt=CORES[engine][0])


def cbc_encrypt_words(words: torch.Tensor, iv_words: torch.Tensor, rk: torch.Tensor,
                      nr: int, engine: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """CBC encrypt, C_i = E(P_i ^ C_(i-1)), C_(-1) = IV; returns (output,
    new IV). A recurrence: one chained-encrypt call (on the card, one
    launch)."""
    engine = resolve_engine(engine, words.device)
    w2 = _blocks(words)
    if w2.shape[0] == 0:
        return words, iv_words
    out, iv = _seq_encrypt(w2.reshape(1, -1, 4), iv_words.reshape(1, 4), rk, nr, False, engine)
    return out.reshape(words.shape), iv.reshape(4)


def cbc_encrypt_words_batch(words: torch.Tensor, iv_words: torch.Tensor, rk: torch.Tensor,
                            nr: int, engine: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """S independent CBC streams at once, as one chained-encrypt call (on
    the card, one launch). ``words``: (S, N, 4) block words or (S, 4N) flat
    streams; ``iv_words``: (S, 4). Returns (outputs, final IVs) per
    stream."""
    engine = resolve_engine(engine, words.device)
    iv = iv_words.reshape(-1, 4)
    w3 = words.reshape(iv.shape[0], -1, 4)
    if w3.shape[1] == 0:
        return words, iv_words
    out, iv = _seq_encrypt(w3, iv, rk, nr, False, engine)
    return out.reshape(words.shape), iv


def cbc_decrypt_words(words: torch.Tensor, iv_words: torch.Tensor, rk_dec: torch.Tensor,
                      nr: int, engine: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """CBC decrypt, P_i = D(C_i) ^ C_(i-1): the chain reads only ciphertext,
    so it is one batched decrypt and a shifted XOR. Length 0 is a no-op."""
    if words.shape[0] == 0:
        return words, iv_words
    flat = words.reshape(-1)
    prev = torch.cat([iv_words.reshape(-1), flat[:-4]])
    out = ecb_decrypt_words(flat, rk_dec, nr, engine) ^ prev
    return out.reshape(words.shape), flat[-4:]


def cfb128_encrypt_words(words: torch.Tensor, iv_words: torch.Tensor, rk: torch.Tensor,
                         nr: int, engine: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """CFB128 encrypt over whole blocks, C_i = P_i ^ E(C_(i-1)); returns
    (output, new IV). A recurrence: one chained-encrypt call (on the card,
    one launch)."""
    engine = resolve_engine(engine, words.device)
    w2 = _blocks(words)
    if w2.shape[0] == 0:
        return words, iv_words
    out, iv = _seq_encrypt(w2.reshape(1, -1, 4), iv_words.reshape(1, 4), rk, nr, True, engine)
    return out.reshape(words.shape), iv.reshape(4)


def cfb128_decrypt_words(words: torch.Tensor, iv_words: torch.Tensor, rk: torch.Tensor,
                         nr: int, engine: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """CFB128 decrypt over whole blocks: keystream block i = E(C_(i-1)) is
    known up front, so one batched encrypt and an XOR."""
    if words.shape[0] == 0:
        return words, iv_words
    flat = words.reshape(-1)
    prev = torch.cat([iv_words.reshape(-1), flat[:-4]])
    out = flat ^ ecb_encrypt_words(prev, rk, nr, engine)
    return out.reshape(words.shape), flat[-4:]


def ctr_crypt_fn(nr: int, engine: str = "auto"):
    """A (words, ctr_be_words, rk) -> words CTR function; ``"auto"`` picks
    the engine from the words' device at each call."""
    return lambda words, ctr_be, rk: ctr_crypt_words(words, ctr_be, rk, nr, engine)


# ---------------------------------------------------------------------------
# Host-facing context with byte-granular streaming (the aes.h API shape).
# ---------------------------------------------------------------------------


def _to_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def _bytes_np(w: torch.Tensor) -> np.ndarray:
    return np.array(packing.np_words_to_bytes(packing.words_numpy(w).reshape(-1)))


def _inc_counter_bytes(ctr: np.ndarray, k: int = 1) -> np.ndarray:
    """Add k to a 16-byte big-endian counter (host-side bookkeeping)."""
    val = (int.from_bytes(ctr.tobytes(), "big") + k) % (1 << 128)
    return np.frombuffer(val.to_bytes(16, "big"), dtype=np.uint8).copy()


class AES:
    """An AES key context (``aes_context``) whose round keys live on one device.

    ``device`` defaults to ``"cuda"``; without a card, construction raises
    unless ``device="cpu"`` is passed.
    """

    def __init__(self, key: bytes, engine: str = "auto", device=None):
        nr, rk_enc = expand_key_enc(bytes(key))
        self._setup(bytes(key), nr, rk_enc, dec_schedule_from_enc(nr, rk_enc),
                    engine, device)

    @classmethod
    def from_schedule(cls, nr: int, rk_enc: np.ndarray, rk_dec: np.ndarray,
                      device=None, engine: str = "auto") -> "AES":
        """A context from expanded schedules (uint32 numpy arrays), e.g. the
        ``rk_enc``/``rk_dec`` of another implementation's context."""
        self = cls.__new__(cls)
        self._setup(None, nr, rk_enc, rk_dec, engine, device)
        return self

    def _setup(self, key, nr, rk_enc, rk_dec, engine, device) -> None:
        if nr not in cuda_aes.NR_VALUES:
            raise ValueError(f"nr must be one of {cuda_aes.NR_VALUES}, got {nr}")
        for name, rk in (("rk_enc", rk_enc), ("rk_dec", rk_dec)):
            if np.shape(rk) != (4 * (nr + 1),):
                raise ValueError(f"{name} must have {4 * (nr + 1)} words")
        self.key, self.nr = key, nr
        self.device = as_device(device)
        self.engine = resolve_engine(engine, self.device)
        self.rk_enc = packing.words_tensor(np.asarray(rk_enc), self.device)
        self.rk_dec = packing.words_tensor(np.asarray(rk_dec), self.device)

    def _words(self, b: np.ndarray) -> torch.Tensor:
        """uint8 bytes (length % 16 == 0) -> int32 words on the context's device."""
        return packing.words_tensor(packing.np_bytes_to_words(b), self.device)

    # -- ECB ---------------------------------------------------------------
    def crypt_ecb(self, mode: int, data) -> np.ndarray:
        """Bulk ECB over any multiple of 16 bytes (reference aes.c:650-752
        handles one block; the batch dimension replaces the caller's loop)."""
        b = _to_u8(data)
        if b.size % 16:
            raise ValueError("ECB data must be a multiple of 16 bytes")
        w = self._words(b)
        if mode == AES_ENCRYPT:
            out = ecb_encrypt_words(w, self.rk_enc, self.nr, self.engine)
        else:
            out = ecb_decrypt_words(w, self.rk_dec, self.nr, self.engine)
        return _bytes_np(out)

    # -- CBC ---------------------------------------------------------------
    def crypt_cbc(self, mode: int, iv, data) -> tuple[np.ndarray, np.ndarray]:
        """CBC with explicit IV state; returns (output, new_iv). Semantics of
        reference aes.c:757-816 (IV updated to the last ciphertext block)."""
        b = _to_u8(data)
        if b.size % 16:
            raise ValueError("CBC data must be a multiple of 16 bytes")
        ivw = self._words(_to_u8(iv)[:16])
        w = self._words(b)
        if mode == AES_ENCRYPT:
            out, newiv = cbc_encrypt_words(w, ivw, self.rk_enc, self.nr, self.engine)
        else:
            out, newiv = cbc_decrypt_words(w, ivw, self.rk_dec, self.nr, self.engine)
        return _bytes_np(out), _bytes_np(newiv)

    # -- CFB128 ------------------------------------------------------------
    def crypt_cfb128(self, mode: int, iv_off: int, iv, data):
        """Byte-granular CFB128 (reference aes.c:822-863): returns
        (output, new_iv_off, new_iv). ``iv`` carries the feedback register,
        partially overwritten with ciphertext when iv_off != 0."""
        b = _to_u8(data)
        iv = _to_u8(iv).copy()
        return self._cfb_impl(mode, int(iv_off), iv, b)

    def _ecb1(self, block16: np.ndarray) -> np.ndarray:
        """E_K of one 16-byte block through the context's engine (one kernel
        launch on the card)."""
        w = self._words(_to_u8(block16)).reshape(1, 4)
        return _bytes_np(ecb_encrypt_words(w, self.rk_enc, self.nr, self.engine))

    def _cfb_impl(self, mode, iv_off, iv, b):
        out = np.empty_like(b)
        pos = 0
        n = int(iv_off)
        # As in the reference, when n != 0 the iv buffer holds ciphertext in
        # [0, n) and not-yet-used keystream bytes E(prev_iv) in [n, 16).
        while pos < b.size:
            if n == 0 and b.size - pos >= 16:
                # Aligned bulk: all full blocks in one entry call.
                nfull = (b.size - pos) // 16
                w = self._words(b[pos: pos + nfull * 16])
                ivw = self._words(iv)
                if mode == AES_ENCRYPT:
                    o, newiv = cfb128_encrypt_words(w, ivw, self.rk_enc, self.nr, self.engine)
                else:
                    o, newiv = cfb128_decrypt_words(w, ivw, self.rk_enc, self.nr, self.engine)
                out[pos: pos + nfull * 16] = _bytes_np(o)
                iv = _bytes_np(newiv)
                pos += nfull * 16
                continue
            if n == 0:
                iv = self._ecb1(iv)
            take = min(16 - n, b.size - pos)
            chunk = b[pos: pos + take]
            c = chunk ^ iv[n: n + take]
            iv[n: n + take] = c if mode == AES_ENCRYPT else chunk
            out[pos: pos + take] = c
            pos += take
            n = (n + take) & 0x0F
        return out, n, iv

    # -- CTR ---------------------------------------------------------------
    def _ctr_words(self, words_np: np.ndarray, nonce_counter: np.ndarray) -> np.ndarray:
        w = packing.words_tensor(words_np, self.device)
        ctr_be = packing.words_tensor(
            packing.np_bytes_to_words(nonce_counter).byteswap(), self.device)
        return _bytes_np(ctr_crypt_words(w, ctr_be, self.rk_enc, self.nr, self.engine))

    def crypt_ctr(self, nc_off: int, nonce_counter: np.ndarray,
                  stream_block: np.ndarray, data):
        """Byte-granular CTR (reference aes.c:869-901): returns
        (output, new_nc_off, new_nonce_counter, new_stream_block).

        As in the reference, ``stream_block = E(counter)`` is computed and
        then the counter is post-incremented, so after a call that ends
        mid-block the stored counter is one ahead of the block in use.
        """
        b = _to_u8(data)
        nonce_counter = _to_u8(nonce_counter).copy()
        stream_block = _to_u8(stream_block).copy()
        out = np.empty_like(b)
        pos = 0
        n = int(nc_off)

        if n != 0:  # drain a partial stream block left by the previous call
            take = min(16 - n, b.size)
            out[:take] = b[:take] ^ stream_block[n: n + take]
            pos = take
            n = (n + take) & 0x0F

        nfull = (b.size - pos) // 16
        if nfull:
            words = packing.np_bytes_to_words(b[pos: pos + nfull * 16])
            out[pos: pos + nfull * 16] = self._ctr_words(words, nonce_counter)
            pos += nfull * 16
            nonce_counter = _inc_counter_bytes(nonce_counter, nfull)

        if pos < b.size:
            # Tail: the keystream block is the fused CTR entry over one zero
            # block at the current counter; then post-increment.
            stream_block = self._ctr_words(np.zeros(4, np.uint32), nonce_counter)
            nonce_counter = _inc_counter_bytes(nonce_counter, 1)
            take = b.size - pos
            out[pos:] = b[pos:] ^ stream_block[:take]
            n = take
        elif nfull:
            # The reference regenerates stream_block for every block, so a
            # call ending on a block boundary leaves E(last counter) there:
            # in CTR that is the input XOR output of the final block.
            stream_block = b[pos - 16: pos] ^ out[pos - 16: pos]
        return out, n, nonce_counter, stream_block
