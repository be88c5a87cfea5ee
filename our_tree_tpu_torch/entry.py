"""The port's entry points, the counterpart of the root ``__graft_entry__.py``.

``entry(device=None)`` returns the flagship forward step, AES-128-CTR bulk
encryption over 256 blocks, as ``(fn, example_args)``: the data from
``default_rng(1337)``, the key and the nonce ``bytes(range(16))``, and
``fn(words, ctr_be, rk) = models.aes.ctr_crypt_words(words, ctr_be, rk,
10)``. On the card ``fn(*example_args)`` is one ``ctr_gen`` launch (the
ranking's ``auto`` engine); with ``device="cpu"`` it runs the plain version.

``dryrun_multichip`` raises: the port drives one card, and the sharded step
waits for ROADMAP queue 1's "Multi-device" item.
"""

from __future__ import annotations

import numpy as np

from .models import aes as aes_mod
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


def dryrun_multichip(n_devices: int) -> None:
    """The sharded step over ``n_devices`` cards: not in the port yet."""
    raise NotImplementedError(
        f"dryrun_multichip({n_devices}): the sharded step waits for ROADMAP queue 1's "
        f"\"Multi-device\" item (parallel/dist.py and parallel/multihost.py); the port drives "
        f"one card")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry() ok:", tuple(out.shape), out.dtype)
