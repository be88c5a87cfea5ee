"""AES context and CTR mode on the card (the CTR half of
``our_tree_tpu.models.aes``).

Words are (N, 4) or flat (4N,) ``torch.int32`` tensors holding u32 LE
block words. The counter is 4 big-endian u32 words (word 3 least
significant), and block i of a call uses counter0 + i, wrapping mod 2^128,
as the reference C ``aes_crypt_ctr`` does.

Engines: ``"cuda-ctr-gen-bp"`` is the hand-written CUDA kernel
(``ops/cuda_aes.py``); ``"bitslice"`` is its plain torch version.
``"auto"`` resolves to the kernel for a CUDA device and to the plain version
for the CPU. ECB, CBC and CFB128 come in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitslice, cuda_aes
from ..ops.keyschedule import dec_schedule_from_enc, expand_key_enc
from ..utils import packing
# The reference keeps the counter add here; the port keeps it in utils so
# that ops/cuda_aes.py's plain version can use it without an import cycle.
from ..utils.packing import add_counter_be, ctr_le_blocks  # noqa: F401

AES_ENCRYPT = 1
AES_DECRYPT = 0

CUDA_ENGINE = "cuda-ctr-gen-bp"
PLAIN_ENGINE = "bitslice"

#: (words, rk, nr) -> words block encrypt cores, by engine name (None: the
#: engine has no ECB core yet).
CORES: dict[str, object] = {}
#: (words, ctr_be_words, rk, nr) -> words fused CTR entries, by engine name.
CTR_FUSED: dict[str, object] = {}


def register_core(name: str, encrypt_fn, ctr_fused_fn) -> None:
    CORES[name] = encrypt_fn
    CTR_FUSED[name] = ctr_fused_fn


register_core(PLAIN_ENGINE, bitslice.encrypt_words,
              cuda_aes.ctr_crypt_words_fused_plain)
register_core(CUDA_ENGINE, None, cuda_aes.ctr_crypt_words_fused)


def as_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller asks
    for another. Raises when CUDA is asked for and no card is present; a
    caller that wants the CPU says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain torch version on the CPU")
    return dev


def resolve_engine(engine: str, device) -> str:
    """Engine name for a device: ``"auto"`` is the CUDA kernel on a CUDA
    device and the plain version on the CPU."""
    if engine == "auto":
        return CUDA_ENGINE if torch.device(device).type == "cuda" else PLAIN_ENGINE
    if engine not in CTR_FUSED:
        raise ValueError(f"unknown engine {engine!r}; available: {sorted(CTR_FUSED)}")
    return engine


def ctr_crypt_words(words: torch.Tensor, ctr_be_words: torch.Tensor,
                    rk: torch.Tensor, nr: int, engine: str = "auto") -> torch.Tensor:
    """CTR over (N, 4) int32 block words or a flat (4N,) stream."""
    engine = resolve_engine(engine, words.device)
    w2 = words.reshape(-1, 4)
    return CTR_FUSED[engine](w2, ctr_be_words, rk, nr).reshape(words.shape)


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

    def crypt_ecb(self, mode: int, data):
        raise NotImplementedError("ported in a later slice")

    def crypt_cbc(self, mode: int, iv, data):
        raise NotImplementedError("ported in a later slice")

    def crypt_cfb128(self, mode: int, iv_off: int, iv, data):
        raise NotImplementedError("ported in a later slice")

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
