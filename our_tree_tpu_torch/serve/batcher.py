"""Shape-bucketed continuous batching: requests -> fixed-shape dispatches.

Port of ``our_tree_tpu.serve.batcher`` for the ``ctr`` mode, host numpy as
in the reference. Every batch is padded to a rung of a fixed power-of-two
ladder, so after warmup over the ladder the card only ever sees the warmed
shapes (the JAX package needs that to avoid recompiles; the port keeps the
same shapes, so its warmup covers every dispatch shape too).

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
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..obs import metrics
from ..ops.keyschedule import ROUNDS
from ..utils import packing
from .queue import Request

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
    #: per-request (start_block, nblocks) in ``requests`` order
    req_spans: list | None = field(default=None, repr=False)

    @property
    def label(self) -> str:
        first = self.slots[0].label if self.slots else "?"
        return f"{first}+{len(self.slots) - 1}k:{self.bucket}"

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

    def materialise(self) -> None:
        """Build the flat uint32 dispatch arrays: (4N,) payload words, (4N,)
        LE counter words and the (N,) slot vector, plus ``req_spans``.
        Requests pack contiguously, so only the padding tail is zeroed; a
        request that exactly fills its rung is viewed in place."""
        spans, off = [], 0
        for req in self.requests:
            spans.append((off, req.nblocks))
            off += req.nblocks
        self.req_spans = spans
        reqs = self.requests
        if len(reqs) == 1 and reqs[0].nblocks == self.bucket:
            req = reqs[0]
            self.words = packing.np_bytes_to_words(np.ascontiguousarray(req.payload, np.uint8))
            ctr = np.empty((self.bucket, 4), dtype=np.uint32)
            packing.np_ctr_le_blocks(req.nonce, _block_idx(self.bucket), out=ctr)
            self.ctr_words = ctr.reshape(-1)
            self.slot_index = np.zeros(self.bucket, dtype=np.uint32)
            return
        words = np.empty(4 * self.bucket, dtype=np.uint32)
        ctr = np.empty((self.bucket, 4), dtype=np.uint32)
        slot_index = np.zeros(self.bucket, dtype=np.uint32)
        off = 0
        for si, slot in enumerate(self.slots):
            for req in slot.requests:
                n = req.nblocks
                words[4 * off:4 * (off + n)] = packing.np_bytes_to_words(req.payload)
                packing.np_ctr_le_blocks(req.nonce, _block_idx(n), out=ctr[off:off + n])
                slot_index[off:off + n] = si
                off += n
        if off < self.bucket:  # the padding tail
            words[4 * off:] = 0
            ctr[off:] = 0
        self.words = words
        self.ctr_words = ctr.reshape(-1)
        self.slot_index = slot_index

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
    """The rung-packer: group by (mode, tenant, key digest) in arrival order,
    then pack up to ``key_slots`` groups per batch, filling to the ladder
    ceiling and padding to the smallest rung that holds what was packed. A
    batch is flushed when it runs out of block capacity, when a new group
    finds all K slots taken, or when the next group's key length (round
    count) differs."""
    if key_slots < 1:
        raise ValueError("key_slots must be >= 1")
    ceiling = rungs[-1]
    groups: dict[tuple, list[Request]] = {}
    order: list[tuple] = []
    for req in requests:
        k = (req.mode, req.tenant, key_digest(req.key))
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(req)

    batches: list[Batch] = []
    cur_slots: list[Slot] = []
    cur_blocks = 0
    cur_nr = None
    cur_mode = None

    def flush():
        nonlocal cur_slots, cur_blocks, cur_nr, cur_mode
        if cur_slots:
            bucket = bucket_for(cur_blocks, rungs)
            batches.append(Batch(cur_slots, bucket, cur_blocks, cur_nr, key_slots,
                                 mode=cur_mode))
            metrics.observe("serve_batch_blocks", cur_blocks, rung=bucket, mode=cur_mode)
            metrics.observe("serve_batch_slots", len(cur_slots))
        cur_slots, cur_blocks = [], 0
        cur_nr = cur_mode = None

    for mode, tenant, digest in order:
        pending = groups[(mode, tenant, digest)]
        nr = ROUNDS[len(pending[0].key) * 8]
        if cur_nr is not None and (nr != cur_nr or mode != cur_mode):
            flush()
        if len(cur_slots) >= key_slots:
            flush()
        slot = None
        for req in pending:
            if cur_slots and cur_blocks + req.nblocks > ceiling:
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
    flush()
    return batches
