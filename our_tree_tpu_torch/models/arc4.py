"""ARC4 with the reference's three-phase split (``our_tree_tpu.models.arc4``).

The reference's one original design idea is splitting RC4 into a sequential
keystream phase and a data-parallel XOR phase (``arc4_prep`` /
``arc4_crypt``); the port keeps the three phases:

* ``key_schedule``: the KSA, 256 sequential swaps, on the host (numpy);
* ``keystream_scan`` / ``keystream_scan_batch`` / ``prep_batch_words``: the
  PRGA of one or S streams, resumable from a state; on the card one
  ``arc4_prga_kernel`` launch (``ops/cuda_arc4.py``), on the CPU its plain
  version. ``keystream_np`` is the host numpy oracle;
* ``crypt`` / ``xor_words``: the XOR, a plain ``^`` on tensors (the
  reference computes it outside any Pallas kernel too).

A state is an (S, 258) int32 tensor, one row a stream, ``[x, y, m[256]]``
(the reference carries ``(x, y, m)`` as separate uint32 arrays);
``state_from_numpy`` turns the reference's ``(x, y, m)`` into it and
``state_to_numpy`` back, so both packages run from the same states.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_arc4
from . import aes as aes_mod


def key_schedule(key: bytes | np.ndarray) -> np.ndarray:
    """KSA: the initial 256-byte permutation (uint8)."""
    key = (np.frombuffer(bytes(key), dtype=np.uint8) if isinstance(key, (bytes, bytearray))
           else np.asarray(key, np.uint8))
    m = np.arange(256, dtype=np.int64)
    j = 0
    for i in range(256):
        j = (j + int(m[i]) + int(key[i % len(key)])) & 0xFF
        m[i], m[j] = m[j], m[i]
    return m.astype(np.uint8)


def keystream_np(state: tuple[int, int, np.ndarray], length: int):
    """Host PRGA: (keystream, new_state); the oracle of the device path."""
    x, y, m = state
    m = m.astype(np.int64).copy()
    ks = np.empty(length, dtype=np.uint8)
    for i in range(length):
        x = (x + 1) & 0xFF
        a = m[x]
        y = (y + a) & 0xFF
        b = m[y]
        m[x] = b
        m[y] = a
        ks[i] = m[(a + b) & 0xFF]
    return ks, (x, y, m.astype(np.uint8))


def state_from_numpy(state, device=None) -> torch.Tensor:
    """The reference's ARC4 state ``(x, y, m)`` (numpy or scalars: x and y
    of shape () or (S,), m of shape (256,) or (S, 256)) as the port's
    (S, 258) int32 state tensor on ``device``."""
    x, y, m = (np.asarray(v, dtype=np.int64) for v in state)
    m = m.reshape(-1, 256)
    rows = np.concatenate([x.reshape(-1, 1), y.reshape(-1, 1), m], axis=1)
    return torch.from_numpy(rows.astype(np.int32)).to(aes_mod.as_device(device))


def state_to_numpy(state: torch.Tensor) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """An (S, 258) state tensor as the reference's ``(x, y, m)`` uint32
    arrays of shapes (S,), (S,), (S, 256)."""
    rows = state.cpu().numpy().astype(np.uint32)
    return rows[:, 0], rows[:, 1], rows[:, 2:]


def keystream_scan(state: torch.Tensor, length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """PRGA of one stream: ``state`` (258,) or (1, 258) int32; returns
    (state', keystream (length,) uint8), state' shaped as ``state``."""
    new, ks = cuda_arc4.prga(state.reshape(1, cuda_arc4.STATE_WORDS).contiguous(), length)
    return new.reshape(state.shape), ks.reshape(length)


def keystream_scan_batch(states: torch.Tensor, length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """S independent keystreams at once (the reference's vmapped scan):
    ``states`` (S, 258) int32; returns (states', keystream (S, length) uint8)."""
    return cuda_arc4.prga(states.contiguous(), length)


def crypt(data: torch.Tensor, keystream: torch.Tensor) -> torch.Tensor:
    """Phase 3: XOR."""
    return torch.bitwise_xor(data, keystream)


def xor_words(words: torch.Tensor, ks_words: torch.Tensor) -> torch.Tensor:
    """The served XOR phase on the packed u32 word layout: payload words XOR
    keystream words. Key-oblivious and constant time."""
    return torch.bitwise_xor(words, ks_words)


def prep_batch_words(m_words: torch.Tensor, xy_words: torch.Tensor, length: int) -> torch.Tensor:
    """The served batched-PRGA entry on the flat word layout: ``m_words``
    the (S*256,) int32 permutation stack, ``xy_words`` the (2S,) x/y stack
    ``[x0..x(S-1), y0..y(S-1)]``, ``length`` bytes a session (a multiple of
    4). Returns (S, 258 + length/4) int32: per session ``[x', y', m'[256],
    keystream packed little-endian 4 bytes a word]``."""
    if length % 4:
        raise ValueError(f"length must be a multiple of 4, got {length}")
    s = xy_words.shape[0] // 2
    states = torch.cat([xy_words[:s, None], xy_words[s:, None], m_words.reshape(s, 256)], dim=1)
    new, ks = cuda_arc4.prga(states.to(torch.int32).contiguous(), length)
    return torch.cat([new, ks.reshape(-1).view(torch.int32).reshape(s, length // 4)], dim=1)


class ARC4:
    """``arc4_context``: holds the stream's state across calls, as a (1, 258)
    tensor on ``device`` (``"cuda"`` unless the caller asks for another)."""

    def __init__(self, key: bytes, device=None):
        self.key = bytes(key)
        self.device = aes_mod.as_device(device)
        self.state = state_from_numpy((0, 0, key_schedule(self.key)), self.device)

    @property
    def x(self) -> int:
        return int(self.state[0, 0])

    @property
    def y(self) -> int:
        return int(self.state[0, 1])

    @property
    def m(self) -> np.ndarray:
        return self.state[0, 2:].cpu().numpy().astype(np.uint8)

    def prep(self, length: int, backend: str = "device") -> np.ndarray:
        """Generate ``length`` keystream bytes, advancing the state
        (``backend="np"``: the host oracle)."""
        if backend == "np":
            ks, (x, y, m) = keystream_np((self.x, self.y, self.m), length)
            self.state = state_from_numpy((x, y, m), self.device)
            return ks
        self.state, ks = cuda_arc4.prga(self.state, length)
        return ks.reshape(length).cpu().numpy()

    @staticmethod
    def batch_states(keys: list[bytes], device=None) -> torch.Tensor:
        """KSA for many keys: the (S, 258) state stack the batch scan takes."""
        ms = np.stack([key_schedule(k) for k in keys])
        z = np.zeros(len(keys), np.int64)
        return state_from_numpy((z, z, ms), device)

    @staticmethod
    def prep_batch(keys: list[bytes], length: int, device=None) -> np.ndarray:
        """Keystreams for many independent keys in one call: (len(keys),
        length) uint8."""
        _, ks = keystream_scan_batch(ARC4.batch_states(keys, device), length)
        return ks.cpu().numpy()

    def crypt(self, data, keystream=None) -> np.ndarray:
        """XOR ``data`` with ``keystream`` (generated here if not given)."""
        d = (np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray))
             else np.asarray(data, np.uint8))
        if keystream is None:
            keystream = self.prep(d.size)
        dt = torch.from_numpy(np.require(d, np.uint8, ["C", "W"])).to(self.device)
        kt = torch.from_numpy(np.require(keystream, np.uint8, ["C", "W"])).to(self.device)
        return crypt(dt, kt).cpu().numpy()
