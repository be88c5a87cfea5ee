"""The CUDA kernels' wrappers and their plain torch versions.

``ctr_crypt_words_fused`` launches ``csrc/ctr_gen.cu``, which replaces the
TPU kernel ``_ctr_gen_kernel`` (``our_tree_tpu/ops/pallas_aes.py:601-612``,
launched at ``:626``): ``out[j] = data[j] ^ E_K(base + j)`` with ``base`` a
128-bit big-endian counter given as 4 BE u32 words and the add wrapping mod
2^128. It has two forms, as ECB encrypt has: the group form (32 blocks a
thread) for bulk CTR and the block form (one block a thread) for few
blocks, such as ``AES.crypt_ctr``'s one-block tail; the C entry picks one by
block count unless a form is asked for, and each launch is counted under
its form in ``ctr_crypt_words_fused.form_launches``.

``encrypt_words`` and ``decrypt_words`` launch ``csrc/ecb.cu``, which
replaces the TPU kernel ``_aes_kernel`` (``pallas_aes.py:259-273``, launched
at ``:358``): ECB of (N, 4) words, decrypt with the InvMixColumns-folded
schedule. Their plain versions are ``bitslice.encrypt_words`` (the same
Boyar-Peralta circuit) and ``bitslice.decrypt_words`` (the tower inverse
S-box, a formulation independent of the kernel's). Encrypt has two forms,
as ``ctr_mk`` has: the group form (32 blocks a thread) for bulk ECB and the
block form (one block a thread, ``csrc/aes_block.cuh``) for few blocks,
such as the one-block launches of byte-granular CFB128; the C entry picks
one by block count unless a form is asked for, and each launch is counted
under its form in ``encrypt_words.form_launches``.

``ctr_scattered_multikey`` launches ``csrc/ctr_mk.cu``, which replaces the
TPU kernel ``_ctr_scat_mk_kernel`` (``pallas_aes.py:767-781``, launched at
``:800``; entries ``ctr_scattered_multikey_dense(_bp)``, ``:838-858``):
``out[i] = data[i] ^ E_{rks[slot[i]]}(ctr_le[i])``, up to ``MK_MAX_SLOTS``
schedules per launch, the serve path's dispatch. ``ctr_crypt_words_explicit``
launches the same kernel with one schedule and no slot vector; it replaces
``_ctr_kernel`` (``pallas_aes.py:476-482``, launched at ``:491``; entry
``ctr_crypt_words``, ``:505-533``), single-key CTR over materialised
counters. Their plain versions gather each block's schedule by the public
slot index and run ``bitslice.encrypt_words_multikey``, or run
``bitslice.encrypt_words`` on the counters. The kernel has two forms: the
group form (32 blocks per thread) and the block form (one block per thread,
``csrc/aes_block.cuh``); the C entry picks one by block count unless a form
is asked for, and each launch is counted under its form in
``.form_launches``.

``cbc_scattered_multikey`` launches ``csrc/cbc_mk.cu``: ``out[i] =
D_{rks_dec[slot[i]]}(c[i]) ^ prev[i]``, the serve path's ``cbc`` (parallel
multi-key CBC decrypt) dispatch, one block a thread (``csrc/aes_block_inv.cuh``).
It is the counterpart of no TPU kernel: the reference runs the same function
as the bitsliced jnp circuit ``_multikey_cbc_bitslice``
(``our_tree_tpu/models/aes.py:595-606``) inside one XLA program. Its plain
version ``cbc_scattered_multikey_plain`` is that circuit in torch
(``bitslice.decrypt_words_multikey`` on the gathered schedules, then XOR).

``seq_encrypt`` launches ``csrc/seq.cu``: S streams of N blocks of CBC or
CFB128 encryption chained inside one launch (the recurrences the reference
runs as a ``lax.scan``, ``our_tree_tpu/models/aes.py:704-716`` and
``:800-807``, and that the port used to run as one ``_aes_kernel``
counterpart launch per block step). ``cbc_encrypt_words_seq``,
``cfb128_encrypt_words_seq`` and ``cbc_encrypt_words_seq_batch`` are its
entries; its plain version ``seq_encrypt_plain`` is the per-block loop of
batched ``bitslice.encrypt_words`` calls. The kernel has forms by the lanes
a stream takes (``SEQ_FORMS``): the thread form (one thread a stream,
``csrc/aes_block.cuh``) and the lane forms (4, 8 or 16 lanes a stream,
``csrc/aes_lanes.cuh``); the C entry picks one by stream count unless a form
is asked for, and each launch is counted under its form in
``seq_encrypt.form_launches``.

One kernel per function serves every layout and engine name of the
reference (planes, grouped, dense; the layouts only existed for TPU tile
padding).

What bounds them on an H100 and what the design does about it: about 40
integer logic instructions per byte against 2 bytes of HBM traffic, so they
are bound by integer issue slots, not memory. They are bitsliced (32 blocks
per thread, state in 128 registers) so each logic instruction does 32 blocks
of work; the CTR kernel synthesises its counters in registers so that only
the data is read and only the output is written. See the sources' headers.

Each wrapper launches its kernel for CUDA tensors and raises on anything it
cannot launch; only CPU tensors go to the plain version. Each counts its
launches in ``.launches``, a plain integer a reader may reset; the serve
path launches from one worker thread per lane, so every count goes through
``count_launch`` under one lock.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import bitslice
from ..runtime import cuda_build
from ..utils.packing import ctr_le_blocks

NR_VALUES = (10, 12, 14)
#: The most schedules one ``ctr_scattered_multikey`` launch takes
#: (``kMaxSlots`` in ``csrc/ctr_mk.cu``).
MK_MAX_SLOTS = 64

_COUNT_LOCK = threading.Lock()


#: ``ctr_mk`` forms by C code (``ot_ctr_mk_form``): ``"auto"`` lets the C
#: entry choose by block count.
MK_FORMS = ("auto", "group", "block")
#: ECB encrypt and ``ctr_gen`` forms by C code (``ot_ecb_encrypt_form``,
#: ``ot_ctr_gen_form``), the same codes.
ECB_FORMS = MK_FORMS
CTR_GEN_FORMS = MK_FORMS
#: ``seq_encrypt`` forms by C code (``csrc/seq_form.cuh``): ``"auto"`` lets
#: the C entry choose by stream count; ``"thread"`` is one thread a stream,
#: ``"lanesL"`` L lanes a stream.
SEQ_FORMS = ("auto", "thread", "lanes4", "lanes8", "lanes16")


def count_launch(wrapper, form: str | None = None) -> None:
    """Add one to ``wrapper.launches`` and, for a kernel with forms, to
    ``wrapper.form_launches[form]``; safe across threads (a bare ``+= 1``
    can lose counts when lane workers launch at once)."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if form is not None:
            wrapper.form_launches[form] += 1


def ctr_crypt_words_fused_plain(words: torch.Tensor, ctr_be: torch.Tensor,
                                rk: torch.Tensor, nr: int) -> torch.Tensor:
    """Plain version: materialise counters, bitsliced encrypt, XOR."""
    idx = torch.arange(words.shape[0], dtype=torch.int64, device=words.device)
    return words ^ bitslice.encrypt_words(ctr_le_blocks(ctr_be, idx), rk, nr)


def _check(words: torch.Tensor, nr: int, **others) -> None:
    """The checks every wrapper makes: int32, contiguous, one device,
    (N, 4) words, and the given shapes of the other tensors."""
    if nr not in NR_VALUES:
        raise ValueError(f"nr must be one of {NR_VALUES}, got {nr}")
    for name, (t, shape) in {"words": (words, None), **others}.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on {words.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if words.dim() != 2 or words.shape[1] != 4:
        raise ValueError(f"words must be (N, 4), got {tuple(words.shape)}")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {words.device}")


def _launch(wrapper, fn: str, words: torch.Tensor, tensors: tuple, nr: int,
            ints: tuple = (), aligned: tuple = (), form: str | None = None) -> torch.Tensor:
    """Launch C entry ``fn`` on (N, 4) CUDA words into a new tensor,
    ``fn(words, out, *tensors, n, *ints, nr, stream)`` (a ``None`` tensor
    passes NULL), and count the launch on ``wrapper`` (under ``form`` if
    given); raises if the launch failed. ``aligned`` tensors are read as
    uint4, like ``words``. N = 0 launches nothing."""
    out = torch.empty_like(words)
    n = words.shape[0]
    if n == 0:
        return out
    if any(t.data_ptr() % 16 for t in (words, out, *aligned)):
        raise ValueError("block words must be 16-byte aligned")
    lib = cuda_build.load()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        ptrs = [None if t is None else t.data_ptr() for t in (words, out, *tensors)]
        rc = getattr(lib, fn)(*ptrs, ctypes.c_longlong(n), *ints, nr, stream)
    if rc:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")
    count_launch(wrapper, form)
    return out


def _form_code(entry: str, form: str, n: int) -> int:
    """The C code of the form a launch of ``n`` blocks takes, as C entry
    ``entry`` (``ot_ctr_mk_form``, ``ot_ecb_encrypt_form``,
    ``ot_ctr_gen_form``) decides it
    (``form`` one of ``MK_FORMS``)."""
    code = getattr(cuda_build.load(), entry)(ctypes.c_longlong(n), MK_FORMS.index(form))
    if code not in (1, 2):
        raise RuntimeError(f"{entry}({n}, {form!r}) returned {code}")
    return code


def ctr_crypt_words_fused(words: torch.Tensor, ctr_be: torch.Tensor,
                          rk: torch.Tensor, nr: int, form: str = "auto") -> torch.Tensor:
    """CTR over (N, 4) int32 LE block words: block j is XORed with
    E_K(ctr_be + j). ``ctr_be``: (4,) int32 BE counter words, read by the
    kernel through a device pointer (so a chain can carry it on the card);
    ``rk``: (4*(nr+1),) int32 encrypt schedule. Symmetric in direction.
    ``form``: one of ``CTR_GEN_FORMS``, the kernel's form on the card
    (``"auto"``: by block count); the CPU checks it and runs the plain
    version."""
    _check(words, nr, ctr_be=(ctr_be, (4,)), rk=(rk, (4 * (nr + 1),)))
    if form not in CTR_GEN_FORMS:
        raise ValueError(f"form must be one of {CTR_GEN_FORMS}, got {form!r}")
    if words.device.type == "cpu":
        return ctr_crypt_words_fused_plain(words, ctr_be, rk, nr)
    n = words.shape[0]
    code = _form_code("ot_ctr_gen_form", form, n) if n else 0
    return _launch(ctr_crypt_words_fused, "ot_ctr_gen", words, (ctr_be, rk), nr, ints=(code,),
                   form=CTR_GEN_FORMS[code])


def encrypt_words(words: torch.Tensor, rk: torch.Tensor, nr: int,
                  form: str = "auto") -> torch.Tensor:
    """ECB encrypt of (N, 4) int32 LE block words with the (4*(nr+1),)
    int32 encrypt schedule ``rk``. ``form``: one of ``ECB_FORMS``, the
    kernel's form on the card (``"auto"``: by block count); the CPU checks
    it and runs the plain version."""
    _check(words, nr, rk=(rk, (4 * (nr + 1),)))
    if form not in ECB_FORMS:
        raise ValueError(f"form must be one of {ECB_FORMS}, got {form!r}")
    if words.device.type == "cpu":
        return bitslice.encrypt_words(words, rk, nr)
    n = words.shape[0]
    code = _form_code("ot_ecb_encrypt_form", form, n) if n else 0
    return _launch(encrypt_words, "ot_ecb_encrypt", words, (rk,), nr, ints=(code,),
                   form=ECB_FORMS[code])


def decrypt_words(words: torch.Tensor, rk_dec: torch.Tensor, nr: int) -> torch.Tensor:
    """ECB decrypt of (N, 4) int32 LE block words with the (4*(nr+1),)
    int32 InvMixColumns-folded decrypt schedule ``rk_dec``."""
    _check(words, nr, rk_dec=(rk_dec, (4 * (nr + 1),)))
    if words.device.type == "cpu":
        return bitslice.decrypt_words(words, rk_dec, nr)
    return _launch(decrypt_words, "ot_ecb_decrypt", words, (rk_dec,), nr)


def ctr_scattered_multikey_plain(words: torch.Tensor, ctr_le: torch.Tensor, rks: torch.Tensor,
                                 key_slots: torch.Tensor, nr: int) -> torch.Tensor:
    """Plain version: gather each block's schedule by its public slot index,
    bitsliced per-block-key encrypt of the counters, XOR."""
    return words ^ bitslice.encrypt_words_multikey(ctr_le, rks[key_slots.long()], nr)


def ctr_crypt_words_explicit_plain(words: torch.Tensor, ctr_le: torch.Tensor, rk: torch.Tensor,
                                   nr: int) -> torch.Tensor:
    """Plain version: bitsliced encrypt of the given counters, XOR."""
    return words ^ bitslice.encrypt_words(ctr_le, rk, nr)


def ctr_scattered_multikey(words: torch.Tensor, ctr_le: torch.Tensor, rks: torch.Tensor,
                           key_slots: torch.Tensor, nr: int, form: str = "auto") -> torch.Tensor:
    """Multi-key CTR over (N, 4) int32 LE block words with every block's
    counter given: block i is XORed with E_{rks[key_slots[i]]}(ctr_le[i]).
    ``ctr_le``: (N, 4) int32 LE counter words; ``rks``: (K, 4*(nr+1)) int32
    encrypt schedules, 1 <= K <= ``MK_MAX_SLOTS``; ``key_slots``: (N,) int32
    public slot indices, each below K (checked on the CPU; the kernel clamps
    a bad one into range rather than read outside ``rks``). ``form``: one of
    ``MK_FORMS``, the kernel's form on the card (``"auto"``: by block
    count); the CPU checks it and runs the plain version."""
    n = words.shape[0] if words.dim() == 2 else -1
    _check(words, nr, ctr_le=(ctr_le, (n, 4)), key_slots=(key_slots, (n,)), rks=(rks, None))
    if rks.dim() != 2 or rks.shape[1] != 4 * (nr + 1):
        raise ValueError(f"rks must be (K, {4 * (nr + 1)}), got {tuple(rks.shape)}")
    k = rks.shape[0]
    if not 1 <= k <= MK_MAX_SLOTS:
        raise ValueError(f"rks must hold 1..{MK_MAX_SLOTS} schedules, got {k}")
    if form not in MK_FORMS:
        raise ValueError(f"form must be one of {MK_FORMS}, got {form!r}")
    if words.device.type == "cpu":
        if n and (int(key_slots.min()) < 0 or int(key_slots.max()) >= k):
            raise ValueError(f"key_slots must lie in [0, {k})")
        return ctr_scattered_multikey_plain(words, ctr_le, rks, key_slots, nr)
    code = _form_code("ot_ctr_mk_form", form, n) if n else 0
    return _launch(ctr_scattered_multikey, "ot_ctr_mk", words, (ctr_le, key_slots, rks), nr,
                   ints=(k, code), aligned=(ctr_le,), form=MK_FORMS[code])


def cbc_scattered_multikey_plain(words: torch.Tensor, prev: torch.Tensor, rks_dec: torch.Tensor,
                                 key_slots: torch.Tensor, nr: int) -> torch.Tensor:
    """Plain version: gather each block's decrypt schedule by its public slot
    index, bitsliced per-block-key decrypt, XOR the PREV stream (the
    reference's ``_multikey_cbc_bitslice``)."""
    return bitslice.decrypt_words_multikey(words, rks_dec[key_slots.long()], nr) ^ prev


def cbc_scattered_multikey(words: torch.Tensor, prev: torch.Tensor, rks_dec: torch.Tensor,
                           key_slots: torch.Tensor, nr: int) -> torch.Tensor:
    """Multi-key CBC decrypt over (N, 4) int32 LE ciphertext words: block i
    becomes D_{rks_dec[key_slots[i]]}(words[i]) ^ prev[i]. ``prev``: (N, 4)
    int32 words, each request's IV at its first block, then its own
    ciphertext shifted by one block; ``rks_dec``: (K, 4*(nr+1)) int32
    InvMixColumns-folded decrypt schedules, 1 <= K <= ``MK_MAX_SLOTS``;
    ``key_slots``: (N,) int32 public slot indices, each below K (checked on
    the CPU; the kernel clamps a bad one into range rather than read outside
    ``rks_dec``)."""
    n = words.shape[0] if words.dim() == 2 else -1
    _check(words, nr, prev=(prev, (n, 4)), key_slots=(key_slots, (n,)), rks_dec=(rks_dec, None))
    if rks_dec.dim() != 2 or rks_dec.shape[1] != 4 * (nr + 1):
        raise ValueError(f"rks_dec must be (K, {4 * (nr + 1)}), got {tuple(rks_dec.shape)}")
    k = rks_dec.shape[0]
    if not 1 <= k <= MK_MAX_SLOTS:
        raise ValueError(f"rks_dec must hold 1..{MK_MAX_SLOTS} schedules, got {k}")
    if words.device.type == "cpu":
        if n and (int(key_slots.min()) < 0 or int(key_slots.max()) >= k):
            raise ValueError(f"key_slots must lie in [0, {k})")
        return cbc_scattered_multikey_plain(words, prev, rks_dec, key_slots, nr)
    return _launch(cbc_scattered_multikey, "ot_cbc_mk", words, (prev, key_slots, rks_dec), nr,
                   ints=(k,), aligned=(prev,))


def ctr_crypt_words_explicit(words: torch.Tensor, ctr_le: torch.Tensor, rk: torch.Tensor,
                             nr: int, form: str = "auto") -> torch.Tensor:
    """Single-key CTR over (N, 4) int32 LE block words and their (N, 4) LE
    counter words: ``words ^ E_K(ctr_le)``. The ``ctr_mk`` kernel with one
    schedule and no slot vector; ``form`` as for ``ctr_scattered_multikey``."""
    n = words.shape[0] if words.dim() == 2 else -1
    _check(words, nr, ctr_le=(ctr_le, (n, 4)), rk=(rk, (4 * (nr + 1),)))
    if form not in MK_FORMS:
        raise ValueError(f"form must be one of {MK_FORMS}, got {form!r}")
    if words.device.type == "cpu":
        return ctr_crypt_words_explicit_plain(words, ctr_le, rk, nr)
    code = _form_code("ot_ctr_mk_form", form, n) if n else 0
    return _launch(ctr_crypt_words_explicit, "ot_ctr_mk", words, (ctr_le, None, rk), nr,
                   ints=(1, code), aligned=(ctr_le,), form=MK_FORMS[code])


def seq_encrypt_plain(words: torch.Tensor, ivs: torch.Tensor, rk: torch.Tensor, nr: int,
                      cfb: bool, encrypt=bitslice.encrypt_words
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``seq_encrypt``: per block step, one ``encrypt``
    call on every stream's block, (S, 4) words. ``encrypt``: an engine's
    (words, rk, nr) ECB core, the bitsliced one by default."""
    iv = ivs
    outs = []
    for i in range(words.shape[1]):
        if cfb:
            iv = words[:, i] ^ encrypt(iv.contiguous(), rk, nr)
        else:
            iv = encrypt((words[:, i] ^ iv).contiguous(), rk, nr)
        outs.append(iv)
    if not outs:
        return words.clone(), ivs.clone()
    return torch.stack(outs, dim=1), iv


def seq_encrypt_form(s: int, form: str = "auto") -> str:
    """The form a ``seq_encrypt`` launch of ``s`` streams takes on the card,
    as the C entry decides it (``form`` one of ``SEQ_FORMS``)."""
    code = cuda_build.load().ot_seq_encrypt_form(s, SEQ_FORMS.index(form))
    if not 0 < code < len(SEQ_FORMS):
        raise RuntimeError(f"ot_seq_encrypt_form({s}, {form!r}) returned {code}")
    return SEQ_FORMS[code]


def seq_encrypt(words: torch.Tensor, ivs: torch.Tensor, rk: torch.Tensor, nr: int,
                cfb: bool, form: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """S independent chained encrypts of N blocks each, in one launch:
    CBC, C_i = E(P_i ^ C_(i-1)), or with ``cfb`` CFB128, C_i = P_i ^
    E(C_(i-1)); C_(-1) is the stream's IV. ``words``: (S, N, 4) int32 LE
    block words; ``ivs``: (S, 4); ``rk``: (4*(nr+1),) encrypt schedule.
    ``form``: one of ``SEQ_FORMS``, the kernel's form on the card
    (``"auto"``: by stream count); the CPU checks it and runs the plain
    version. Returns (ciphertext (S, N, 4), last ciphertext block per stream
    (S, 4)); N = 0 launches nothing and returns the IVs."""
    if form not in SEQ_FORMS:
        raise ValueError(f"form must be one of {SEQ_FORMS}, got {form!r}")
    if words.dim() != 3 or words.shape[2] != 4:
        raise ValueError(f"words must be (S, N, 4), got {tuple(words.shape)}")
    s, n = words.shape[0], words.shape[1]
    _check(words.reshape(-1, 4), nr, ivs=(ivs, (s, 4)), rk=(rk, (4 * (nr + 1),)))
    if words.device.type == "cpu":
        return seq_encrypt_plain(words, ivs, rk, nr, cfb)
    out, iv_out = torch.empty_like(words), ivs.clone()
    if s == 0 or n == 0:
        return out, iv_out
    if any(t.data_ptr() % 16 for t in (words, out, ivs, iv_out)):
        raise ValueError("block words must be 16-byte aligned")
    lib = cuda_build.load()
    ran = seq_encrypt_form(s, form)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.ot_seq_encrypt(words.data_ptr(), out.data_ptr(), ivs.data_ptr(),
                                iv_out.data_ptr(), rk.data_ptr(), s, ctypes.c_longlong(n),
                                int(bool(cfb)), nr, SEQ_FORMS.index(ran), stream)
    if rc:
        raise RuntimeError(f"ot_seq_encrypt launch failed: cudaError {rc}")
    count_launch(seq_encrypt, ran)
    return out, iv_out


def cbc_encrypt_words_seq(words: torch.Tensor, iv: torch.Tensor, rk: torch.Tensor,
                          nr: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CBC encrypt of one stream of (N, 4) words under the (4,) IV:
    (ciphertext, new IV), one ``seq_encrypt`` launch."""
    out, iv_out = seq_encrypt(words.reshape(1, -1, 4), iv.reshape(1, 4), rk, nr, cfb=False)
    return out.reshape(words.shape), iv_out.reshape(4)


def cfb128_encrypt_words_seq(words: torch.Tensor, iv: torch.Tensor, rk: torch.Tensor,
                             nr: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CFB128 encrypt of one stream of (N, 4) whole blocks: (ciphertext,
    new IV), one ``seq_encrypt`` launch."""
    out, iv_out = seq_encrypt(words.reshape(1, -1, 4), iv.reshape(1, 4), rk, nr, cfb=True)
    return out.reshape(words.shape), iv_out.reshape(4)


def cbc_encrypt_words_seq_batch(words: torch.Tensor, ivs: torch.Tensor, rk: torch.Tensor,
                                nr: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CBC encrypt of S streams, (S, N, 4) words and (S, 4) IVs: (ciphertext,
    final IVs), one ``seq_encrypt`` launch."""
    return seq_encrypt(words, ivs, rk, nr, cfb=False)


#: Kernel launches since the last reset (the main path's proof of route).
ctr_crypt_words_fused.launches = 0
encrypt_words.launches = 0
decrypt_words.launches = 0
ctr_scattered_multikey.launches = 0
ctr_crypt_words_explicit.launches = 0
cbc_scattered_multikey.launches = 0
seq_encrypt.launches = 0
#: ``ctr_mk``, ECB encrypt, ``ctr_gen`` and ``seq_encrypt`` launches by the form that ran (a
#: reader may reset them).
ctr_crypt_words_fused.form_launches = {"group": 0, "block": 0}
ctr_scattered_multikey.form_launches = {"group": 0, "block": 0}
ctr_crypt_words_explicit.form_launches = {"group": 0, "block": 0}
encrypt_words.form_launches = {"group": 0, "block": 0}
seq_encrypt.form_launches = {f: 0 for f in SEQ_FORMS[1:]}
