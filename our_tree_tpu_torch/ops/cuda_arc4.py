"""The ARC4 keystream kernel's wrapper and its plain torch version.

``prga`` launches ``csrc/arc4.cu`` (``arc4_prga_kernel``): S independent
ARC4 streams, each continued from its state for ``length`` bytes, with the
state written back so a stream resumes across calls, and with ``data`` the
keystream XORed into it in the same pass. It is the counterpart of the JAX
package's compiled scans (``our_tree_tpu/models/arc4.py:59-94``
``keystream_scan``/``keystream_scan_batch``, ``:113-137``
``prep_batch_words``, ``our_tree_tpu/models/rc4.py:29-43`` the fused scan),
which are XLA loops, not Pallas kernels.

A state is an (S, 258) int32 tensor, one row a stream: ``[x, y, m[0..255]]``,
each a byte, the first 258 words of the reference's ``prep_batch_words``
rows. ``prga_plain`` is the plain version: vectorised over the streams, a
Python loop over the bytes (several small ops a byte). The CPU tests use
it; nothing on the card's path does.

The wrapper launches the kernel for CUDA tensors and raises on anything it
cannot launch; only CPU tensors go to the plain version. It counts its
launches in ``prga.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import cuda_build
from .cuda_aes import count_launch

STATE_WORDS = 258
#: Steps of ``prga_plain`` whose x indices are made at once.
_X_CHUNK = 4096


def prga_plain(state: torch.Tensor, length: int, data: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``prga``: (new state (S, 258) int32, (S, length)
    uint8 keystream, or ``data ^ keystream`` when ``data`` is given)."""
    s, dev = state.shape[0], state.device
    # The permutation and the keystream as bytes: a + b wraps mod 256 in
    # uint8, and the keystream of many long streams fits in memory.
    m = (state[:, 2:] & 255).to(torch.uint8).contiguous()
    y = (state[:, 1:2].to(torch.int64) & 255).clone()
    x0 = state[:, 0:1].to(torch.int64).t()
    ks = torch.empty((length, s, 1), dtype=torch.uint8, device=dev)
    for c0 in range(0, length, _X_CHUNK):
        # x only counts: every step's x is known up front, (steps, S, 1) a
        # chunk, so that each step's index is contiguous.
        steps = torch.arange(c0 + 1, min(c0 + _X_CHUNK, length) + 1, device=dev)
        xs = ((steps[:, None] + x0) & 255).unsqueeze(-1)
        for i, x in enumerate(xs, start=c0):
            a = m.gather(1, x)
            y = (y + a) & 255
            b = m.gather(1, y)
            m.scatter_(1, x, b)
            m.scatter_(1, y, a)
            torch.gather(m, 1, (a + b).long(), out=ks[i])
    out = ks.reshape(length, s).t()
    if data is not None:
        out = out ^ data
    x_end = (state[:, 0:1].to(torch.int64) + length) & 255
    return torch.cat([x_end, y, m.long()], dim=1).to(torch.int32), out.contiguous()


def _check(state: torch.Tensor, length: int, data: torch.Tensor | None) -> None:
    if state.dtype != torch.int32:
        raise TypeError(f"state must be int32, got {state.dtype}")
    if state.dim() != 2 or state.shape[1] != STATE_WORDS or not state.is_contiguous():
        raise ValueError(f"state must be a contiguous (S, {STATE_WORDS}) tensor, "
                         f"got {tuple(state.shape)}")
    if length < 0:
        raise ValueError(f"length must be >= 0, got {length}")
    if data is not None:
        if data.dtype != torch.uint8:
            raise TypeError(f"data must be uint8, got {data.dtype}")
        if tuple(data.shape) != (state.shape[0], length) or not data.is_contiguous():
            raise ValueError(f"data must be a contiguous ({state.shape[0]}, {length}) tensor, "
                             f"got {tuple(data.shape)}")
        if data.device != state.device:
            raise ValueError(f"data is on {data.device}, state on {state.device}")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {state.device}")


def prga(state: torch.Tensor, length: int, data: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``length`` bytes of S ARC4 streams from ``state`` ((S, 258) int32):
    returns (the state after them, (S, length) uint8 keystream, or ``data ^
    keystream`` when ``data`` ((S, length) uint8) is given). One launch on
    the card; S = 0 or length 0 launches nothing."""
    _check(state, length, data)
    if state.device.type == "cpu":
        return prga_plain(state, length, data)
    s = state.shape[0]
    out = torch.empty((s, length), dtype=torch.uint8, device=state.device)
    if s == 0 or length == 0:
        return state.clone(), out
    new_state = torch.empty_like(state)
    lib = cuda_build.load()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = lib.ot_arc4_prga(state.data_ptr(), new_state.data_ptr(),
                              None if data is None else data.data_ptr(), out.data_ptr(), s,
                              ctypes.c_longlong(length), stream)
    if rc:
        raise RuntimeError(f"ot_arc4_prga launch failed: cudaError {rc}")
    count_launch(prga)
    return new_state, out


#: Kernel launches since the last reset (the main path's proof of route).
prga.launches = 0
