"""Abstract block-cipher interface (``our_tree_tpu.models.base``), the
Python form of the reference's C++ ``BlockCipher`` (BlockCipher.h:48-107),
with ``AESCipher`` over the port's ``AES`` context on one device."""

from __future__ import annotations

import abc

import numpy as np

#: Direction flags, values as in the reference (BlockCipher.h:31-46).
DIR_ENCRYPT = 1
DIR_DECRYPT = 2
DIR_BOTH = DIR_ENCRYPT | DIR_DECRYPT


class BlockCipher(abc.ABC):
    """A keyed block cipher over n-block byte buffers."""

    @property
    @abc.abstractmethod
    def block_bits(self) -> int: ...

    @property
    def block_size(self) -> int:
        return self.block_bits // 8

    @property
    @abc.abstractmethod
    def key_bits(self) -> int: ...

    @property
    def key_size(self) -> int:
        return self.key_bits // 8

    @abc.abstractmethod
    def make_key(self, key: bytes, direction: int = DIR_BOTH) -> None:
        """Install a key for the given direction(s) (makeKey,
        BlockCipher.h:74-83)."""

    @abc.abstractmethod
    def encrypt(self, data) -> np.ndarray:
        """Bulk-encrypt a multiple of block_size bytes."""

    @abc.abstractmethod
    def decrypt(self, data) -> np.ndarray:
        """Bulk-decrypt a multiple of block_size bytes."""


class AESCipher(BlockCipher):
    """AES behind the BlockCipher interface: ECB through the ``AES``
    context. ``engine`` and ``device`` are the context's (``device``
    defaults to ``"cuda"`` and raises without a card unless ``"cpu"``)."""

    def __init__(self, key: bytes | None = None, engine: str = "auto", device=None):
        self._engine = engine
        self._device = device
        self._ctx = None
        self._direction = 0
        if key is not None:
            self.make_key(key)

    @property
    def block_bits(self) -> int:
        return 128

    @property
    def key_bits(self) -> int:
        if self._ctx is None:
            raise ValueError("no key installed")
        return len(self._ctx.key) * 8

    def make_key(self, key: bytes, direction: int = DIR_BOTH) -> None:
        from .aes import AES

        self._ctx = AES(bytes(key), engine=self._engine, device=self._device)
        self._direction = direction

    def _require(self, direction: int) -> None:
        if self._ctx is None:
            raise ValueError("no key installed")
        if not (self._direction & direction):
            raise ValueError("key not installed for this direction")

    def encrypt(self, data) -> np.ndarray:
        from .aes import AES_ENCRYPT

        self._require(DIR_ENCRYPT)
        return self._ctx.crypt_ecb(AES_ENCRYPT, data)

    def decrypt(self, data) -> np.ndarray:
        from .aes import AES_DECRYPT

        self._require(DIR_DECRYPT)
        return self._ctx.crypt_ecb(AES_DECRYPT, data)
