"""Shape-bucketed continuous batching: requests -> fixed-shape dispatches.

Port of ``our_tree_tpu.serve.batcher`` for every served mode, host numpy
as in the reference. Every batch
is padded to a rung of a fixed power-of-two ladder, so after warmup over the
ladder the card only ever sees the warmed shapes (the JAX package needs that
to avoid recompiles; the port keeps the same shapes, so its warmup covers
every dispatch shape too).

Coalescing is a rung-packer over key groups: requests group by (tenant, key
digest) in arrival order, each group becomes one key slot with its own
schedule, and up to ``key_slots`` groups pack into one batch, filled to the
ladder ceiling. The dispatch (``models.aes.ctr_crypt_words_scattered_multikey``)
takes the K stacked schedules plus a per-block slot vector, so one kernel
launch serves many tenants' keys; each request keeps its own counter
stream, built here (``utils.packing.np_ctr_le_blocks``). K is fixed per
server (unused slots carry the all-zero schedule). Groups of different key
lengths never share a batch. Padding blocks ride slot 0 with zero counters
and zero payload; their keystream is computed and dropped.

Batches never mix modes (each mode has its own dispatch). A ``cbc`` batch
is laid out like a ``ctr`` one, with ``ctr_words`` carrying the PREV stream
in place of counters: each request's IV at its first block, then its own
ciphertext shifted by one block (P_i = D(C_i) ^ C_(i-1) reads only
ciphertext, which is why the decrypt direction batches at all).

A ``gcm``/``gcm-open`` batch is laid out as the JAX package's, word for word
(the ``aead/gcm.py`` module docstring has the layout): each request takes
its J0 row (a zero data word under counter J0, whose CTR output is E_K(J0))
and then its payload rows under inc32 counters; ``seg_keep`` is 0 at each J0
row and each first data row, ``inject_words`` holds each request's AAD state
Y_aad (GHASH of its padded AAD under its slot's H, on the host) at its first
data row, and ``req_spans`` skip the J0 rows. The port adds ``rows``, the
sorted (E,) int64 vector of each request's last data row: the only GHASH
states the finisher reads, and the rows the dispatch names to ``ghash_at``.
Capacity counts ``span_blocks``, the J0 row included.

An ``rc4`` batch carries session chunks: ``ctr_words`` holds each chunk's
reserved keystream slice, and the dispatch is one key-oblivious XOR, so the
chunks of many sessions share a batch. They group by session (``s<sid>``
slots: data chunks carry no key) and take the round-count sentinel 0, so rc4
and AES work never share a batch; padding keystream is zero.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..aead import ghash as aead_ghash
from ..obs import metrics
from ..ops import gf
from ..ops.keyschedule import ROUNDS
from ..utils import packing
from .queue import GCM_MODES, Request

#: Default ladder bounds, in 16-byte blocks: floor 32 (one bitsliced group),
#: ceiling 4096 (64 KiB).
DEFAULT_MIN_BLOCKS = 32
DEFAULT_MAX_BLOCKS = 4096

#: Default key slots per dispatch (the fixed K dimension).
DEFAULT_KEY_SLOTS = 8

#: Shared block-offset vector for counter building, grown on demand.
_ARANGE = np.arange(DEFAULT_MAX_BLOCKS, dtype=np.uint32)


def _block_idx(n: int) -> np.ndarray:
    global _ARANGE
    if n > _ARANGE.size:
        _ARANGE = np.arange(n, dtype=np.uint32)
    return _ARANGE[:n]


def bucket_ladder(min_blocks: int = DEFAULT_MIN_BLOCKS,
                  max_blocks: int = DEFAULT_MAX_BLOCKS) -> tuple[int, ...]:
    """The fixed rung set: powers of two from min to max, the ceiling always
    present."""
    if min_blocks < 1 or max_blocks < min_blocks:
        raise ValueError(f"bad ladder bounds [{min_blocks}, {max_blocks}]")
    rungs = []
    r = 1
    while r < min_blocks:
        r *= 2
    while r < max_blocks:
        rungs.append(r)
        r *= 2
    rungs.append(max_blocks)
    return tuple(rungs)


def bucket_for(nblocks: int, rungs: tuple[int, ...]) -> int:
    """Smallest rung >= nblocks."""
    for r in rungs:
        if nblocks <= r:
            return r
    raise ValueError(f"{nblocks} blocks exceeds ladder ceiling {rungs[-1]}")


@dataclass
class Slot:
    """One key group inside a batch: a (tenant, key) and its riders."""

    tenant: str
    digest: str
    key: bytes
    requests: list[Request]
    blocks: int

    @property
    def label(self) -> str:
        return f"{self.tenant}/{self.digest[:8]}"


@dataclass
class Batch:
    """One formed dispatch: up to K key slots padded to a ladder rung."""

    slots: list[Slot]
    bucket: int                  #: padded block count (the rung)
    blocks: int                  #: real payload block count
    nr: int                      #: round count (uniform across slots)
    key_slots: int               #: the fixed K dimension
    mode: str = "ctr"
    words: np.ndarray | None = field(default=None, repr=False)
    ctr_words: np.ndarray | None = field(default=None, repr=False)
    slot_index: np.ndarray | None = field(default=None, repr=False)
    #: GCM only: the (4N,) AAD states, the (N,) carry keep vector and the
    #: sorted (E,) int64 last data row of each request
    inject_words: np.ndarray | None = field(default=None, repr=False)
    seg_keep: np.ndarray | None = field(default=None, repr=False)
    rows: np.ndarray | None = field(default=None, repr=False)
    #: per-request (start_block, nblocks) in ``requests`` order (GCM spans
    #: skip each request's J0 row)
    req_spans: list | None = field(default=None, repr=False)
    #: ``ctr`` only: the request layout [(slot, start_block, nblocks,
    #: nonce16)], which the native tier's per-request C CTR reads in place
    #: of the counter array (``models.aes`` ``native_runs``)
    runs: list | None = field(default=None, repr=False)

    @property
    def label(self) -> str:
        first = self.slots[0].label if self.slots else "?"
        suffix = "" if self.mode == "ctr" else f":{self.mode}"
        return f"{first}+{len(self.slots) - 1}k:{self.bucket}{suffix}"

    @property
    def requests(self) -> list[Request]:
        return [r for s in self.slots for r in s.requests]

    @property
    def sampled(self) -> bool:
        """Whether a rider was head-sampled (the batch's spans are emitted
        iff one was; abnormal outcomes force-sample regardless)."""
        return any(r.sampled for s in self.slots for r in s.requests)

    @property
    def keys(self) -> list[tuple[str, bytes]]:
        """Slot-ordered (tenant, key) pairs: the keycache.stacked input."""
        return [(s.tenant, s.key) for s in self.slots]

    def materialise(self, counters: bool = True, sched=None) -> None:
        """Build the flat uint32 dispatch arrays: (4N,) payload words, (4N,)
        LE counter words (``cbc``: the PREV stream; ``rc4``: the keystream)
        and the (N,) slot
        vector, plus ``req_spans``. Requests pack contiguously, so only the
        padding tail is zeroed; a ``ctr`` request that exactly fills its rung
        is viewed in place. ``counters=False`` (the native tier's ``ctr``)
        builds neither the counter array nor the slot vector but the request
        layout ``runs``, from which the C tier makes each request's counters
        (the reference builds ``runs`` for every ``ctr`` batch; only the
        native tier reads it). A GCM batch needs
        ``sched``, the keycache's
        stack with its ``h_ints`` (each request's AAD state is hashed here
        under its slot's H)."""
        if self.mode in GCM_MODES:
            self._materialise_gcm(sched)
            return
        if self.mode == "cbc":
            self._materialise_cbc()
            return
        if self.mode == "rc4":
            self._materialise_rc4()
            return
        runs, spans, off = [], [], 0
        for si, slot in enumerate(self.slots):
            for req in slot.requests:
                if not counters:
                    runs.append((si, off, req.nblocks, req.nonce))
                spans.append((off, req.nblocks))
                off += req.nblocks
        self.runs = None if counters else runs
        self.req_spans = spans
        reqs = self.requests
        if len(reqs) == 1 and reqs[0].nblocks == self.bucket:
            req = reqs[0]
            self.words = packing.np_bytes_to_words(np.ascontiguousarray(req.payload, np.uint8))
            if counters:
                ctr = np.empty((self.bucket, 4), dtype=np.uint32)
                packing.np_ctr_le_blocks(req.nonce, _block_idx(self.bucket), out=ctr)
                self.ctr_words = ctr.reshape(-1)
                self.slot_index = np.zeros(self.bucket, dtype=np.uint32)
            return
        words = np.empty(4 * self.bucket, dtype=np.uint32)
        ctr = np.empty((self.bucket, 4), dtype=np.uint32) if counters else None
        slot_index = np.zeros(self.bucket, dtype=np.uint32) if counters else None
        off = 0
        for si, slot in enumerate(self.slots):
            for req in slot.requests:
                n = req.nblocks
                words[4 * off:4 * (off + n)] = packing.np_bytes_to_words(req.payload)
                if counters:
                    packing.np_ctr_le_blocks(req.nonce, _block_idx(n), out=ctr[off:off + n])
                    slot_index[off:off + n] = si
                off += n
        if off < self.bucket:  # the padding tail
            words[4 * off:] = 0
            if counters:
                ctr[off:] = 0
        self.words = words
        if counters:
            self.ctr_words = ctr.reshape(-1)
            self.slot_index = slot_index

    def _materialise_gcm(self, sched) -> None:
        """The GCM layout (the module docstring): per request the J0 row, then
        its payload rows; ``seg_keep``, ``inject_words``, ``req_spans`` and
        ``rows``."""
        if sched is None or sched.h_ints is None:
            raise ValueError("a GCM batch needs the stack's H "
                             "(keycache.stacked(..., mode=\"gcm\"))")
        words = np.zeros(4 * self.bucket, dtype=np.uint32)
        ctr = np.zeros((self.bucket, 4), dtype=np.uint32)
        slot_index = np.zeros(self.bucket, dtype=np.uint32)
        inject = np.zeros((self.bucket, 4), dtype=np.uint32)
        keep = np.ones(self.bucket, dtype=np.uint32)
        spans, rows, off = [], [], 0
        for si, slot in enumerate(self.slots):
            h = sched.h_ints[si]
            for req in slot.requests:
                n = req.nblocks
                j0 = bytes(req.j0) if req.j0 else bytes(req.iv) + b"\x00\x00\x00\x01"
                aead_ghash.np_gcm_ctr_blocks(j0, _block_idx(n + 1), out=ctr[off:off + n + 1])
                words[4 * (off + 1):4 * (off + 1 + n)] = packing.np_bytes_to_words(req.payload)
                slot_index[off:off + n + 1] = si
                keep[off] = 0      # the J0 row: its GHASH lane is never read
                keep[off + 1] = 0  # the first data row starts a fresh chain
                y_aad = aead_ghash.ghash_int(h, aead_ghash.pad16(req.aad)) if req.aad else 0
                if y_aad:
                    inject[off + 1] = packing.np_bytes_to_words(
                        np.frombuffer(gf.int_to_block(y_aad), np.uint8))
                spans.append((off + 1, n))
                rows.append(off + n)
                off += n + 1
        self.words = words
        self.ctr_words = ctr.reshape(-1)
        self.slot_index = slot_index
        self.inject_words = inject.reshape(-1)
        self.seg_keep = keep
        self.req_spans = spans
        self.rows = np.asarray(rows, dtype=np.int64)

    def _materialise_cbc(self) -> None:
        """The CBC-decrypt layout: ``ctr_words`` carries the PREV stream, each
        request's IV at its first block, then its own ciphertext shifted by
        one block."""
        words = np.zeros(4 * self.bucket, dtype=np.uint32)
        prev = np.zeros(4 * self.bucket, dtype=np.uint32)
        slot_index = np.zeros(self.bucket, dtype=np.uint32)
        spans, off = [], 0
        for si, slot in enumerate(self.slots):
            for req in slot.requests:
                n = req.nblocks
                w = packing.np_bytes_to_words(req.payload)
                words[4 * off:4 * (off + n)] = w
                prev[4 * off:4 * off + 4] = packing.np_bytes_to_words(
                    np.frombuffer(req.iv, np.uint8))
                prev[4 * (off + 1):4 * (off + n)] = w[:4 * (n - 1)]
                slot_index[off:off + n] = si
                spans.append((off, n))
                off += n
        self.words = words
        self.ctr_words = prev
        self.slot_index = slot_index
        self.req_spans = spans

    def _materialise_rc4(self) -> None:
        """The rc4 layout: ``ctr_words`` carries each chunk's keystream
        slice, reserved from its session's window; no schedules, and the
        padding keystream is zero."""
        words = np.zeros(4 * self.bucket, dtype=np.uint32)
        ks = np.zeros(4 * self.bucket, dtype=np.uint32)
        slot_index = np.zeros(self.bucket, dtype=np.uint32)
        spans, off = [], 0
        for si, slot in enumerate(self.slots):
            for req in slot.requests:
                n = req.nblocks
                words[4 * off:4 * (off + n)] = packing.np_bytes_to_words(req.payload)
                ks[4 * off:4 * (off + n)] = packing.np_bytes_to_words(
                    np.ascontiguousarray(req.ks, dtype=np.uint8))
                slot_index[off:off + n] = si
                spans.append((off, n))
                off += n
        self.words = words
        self.ctr_words = ks
        self.slot_index = slot_index
        self.req_spans = spans

    def split_output(self, out_words: np.ndarray) -> list[np.ndarray]:
        """Per-request output bytes, in ``requests`` order (after
        ``materialise``). Each response is
        a copy, except a request that spans the whole (writable) buffer: a
        partial view would pin the batch buffer and show one tenant the
        others' output."""
        flat = np.asarray(out_words, dtype=np.uint32).reshape(-1)
        outs = []
        for off, n in self.req_spans:
            w = flat[4 * off:4 * (off + n)]
            if 4 * n != flat.size or off != 0 or not flat.flags.writeable:
                w = w.copy()
            outs.append(packing.np_words_to_bytes(w))
        return outs


def form_batches(requests: list[Request], rungs: tuple[int, ...], key_digest,
                 key_slots: int = DEFAULT_KEY_SLOTS) -> list[Batch]:
    """The rung-packer: group by (mode, tenant, key digest; an ``rc4`` chunk by
    its session, ``s<sid>``) in arrival order, then pack up to ``key_slots``
    groups per batch, filling to the ladder ceiling and padding to the
    smallest rung that holds what was packed. A batch is flushed when it
    runs out of row capacity (``span_blocks``: a GCM request's J0 row
    counts), when a new group finds all K slots taken, or when the next
    group's key length (round count; 0 for ``rc4``) or mode differs."""
    if key_slots < 1:
        raise ValueError("key_slots must be >= 1")
    ceiling = rungs[-1]
    groups: dict[tuple, list[Request]] = {}
    order: list[tuple] = []
    for req in requests:
        ident = f"s{req.sid}" if req.mode == "rc4" else key_digest(req.key)
        k = (req.mode, req.tenant, ident)
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(req)

    batches: list[Batch] = []
    cur_slots: list[Slot] = []
    cur_blocks = 0  # payload blocks packed (the occupancy numerator)
    cur_span = 0    # batch rows used (payload and GCM J0 rows)
    cur_nr = None
    cur_mode = None

    def flush():
        nonlocal cur_slots, cur_blocks, cur_span, cur_nr, cur_mode
        if cur_slots:
            bucket = bucket_for(cur_span, rungs)
            batches.append(Batch(cur_slots, bucket, cur_blocks, cur_nr, key_slots,
                                 mode=cur_mode))
            metrics.observe("serve_batch_blocks", cur_blocks, rung=bucket, mode=cur_mode)
            metrics.observe("serve_batch_slots", len(cur_slots))
        cur_slots, cur_blocks, cur_span = [], 0, 0
        cur_nr = cur_mode = None

    for mode, tenant, digest in order:
        pending = groups[(mode, tenant, digest)]
        nr = 0 if mode == "rc4" else ROUNDS[len(pending[0].key) * 8]
        if cur_nr is not None and (nr != cur_nr or mode != cur_mode):
            flush()
        if len(cur_slots) >= key_slots:
            flush()
        slot = None
        for req in pending:
            if cur_slots and cur_span + req.span_blocks > ceiling:
                flush()
                slot = None
            if slot is None:
                slot = Slot(tenant, digest, req.key, [], 0)
                cur_slots.append(slot)
                cur_nr = nr
                cur_mode = mode
            slot.requests.append(req)
            slot.blocks += req.nblocks
            cur_blocks += req.nblocks
            cur_span += req.span_blocks
    flush()
    return batches
