"""Fused RC4: the single-pass keystream-and-XOR API (``our_tree_tpu.models.rc4``).

The reference keeps the classic ``rc4_crypt(buf)`` API beside the phase
split of ``models/arc4.py``, as one scan whose step emits the XORed byte.
The port runs it as the ARC4 kernel's fused form: one ``arc4_prga_kernel``
launch with a data pointer (``ops/cuda_arc4.prga``), the state carried
across calls. For throughput prefer ``models/arc4.py``, whose XOR phase is
data-parallel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_arc4
from .arc4 import key_schedule, state_from_numpy


class RC4:
    """Fused-API RC4 context: ``crypt`` consumes data and advances the state,
    a (1, 258) tensor on ``device`` (``"cuda"`` unless asked otherwise)."""

    def __init__(self, key: bytes, device=None):
        if len(key) == 0:
            raise ValueError("RC4 key must be non-empty")
        self.key = bytes(key)
        self.state = state_from_numpy((0, 0, key_schedule(self.key)), device)
        self.device = self.state.device

    @property
    def x(self) -> int:
        return int(self.state[0, 0])

    @property
    def y(self) -> int:
        return int(self.state[0, 1])

    @property
    def m(self) -> np.ndarray:
        return self.state[0, 2:].cpu().numpy().astype(np.uint8)

    def crypt(self, data) -> np.ndarray:
        """Encrypt or decrypt ``data`` in one fused pass."""
        d = (np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray))
             else np.asarray(data, dtype=np.uint8))
        dt = torch.from_numpy(np.require(d, np.uint8, ["C", "W"]).reshape(1, -1)).to(self.device)
        self.state, out = cuda_arc4.prga(self.state, d.size, dt)
        return out.reshape(-1).cpu().numpy()
