"""Resumable chunked transfers: oversized payloads as ladder riders.

Port of ``our_tree_tpu.serve.transfer``. The serve ladder tops out at
``max_bucket_blocks`` (4,096 blocks by default) and admission refuses
anything larger (``too-large``). CTR is recomposable chunk by chunk: block
``offset + j`` of the whole payload and block ``j`` of a chunk whose counter
starts at ``nonce + offset`` have the same keystream. This module turns that
identity into an admission path:

* **Decomposition** (``plan``): an oversized payload becomes rung-sized
  chunks. CTR chunks carry per-chunk counter starts (the full 128-bit
  big-endian add, the counter semantics of ``utils.packing.np_ctr_le_blocks``,
  so a counter wrap that lands on a chunk boundary splices exactly). CBC
  *decrypt* chunks chain IVs from the previous chunk's last ciphertext block,
  known up front from the input, so every chunk dispatches on its own. GCM is
  refused with a typed reason (``transfer-unsupported``): its tag is a GHASH
  over the whole message, and there is no host-side GHASH continuation across
  chunk tags.
* **Streaming**: each chunk is an ordinary rider of the queue, batcher and
  lanes (the server's ``_transfer_chunk``), with the lanes' bit-exact
  redispatch, so a lane failure mid-transfer costs only the chunks in flight.
* **Reassembly**: strictly in order under a bounded buffer. Chunks that land
  out of order are held (``held_bytes``); past the byte budget NEW transfers
  shed with a typed error (``serve_transfer_shed{reason=reassembly}``) while
  admitted chunks keep draining.
* **Resumability**: a journal-backed ledger (JSONL, fsync'd appends, a torn
  tail truncated on load) records each transfer's id, parameter fingerprint
  and acked chunks. A client that reconnects with its resume token has its
  acked chunks skipped, never recomputed or re-emitted, and the spliced
  output equals an uninterrupted run's. The file format is the JAX
  package's: a ledger written by either package loads in the other.

Fault points (``resilience/faults.py``, scoped ``@chunk=<i>``): ``chunk_lost``
discards one completed chunk before reassembly (a redispatch),
``reassembly_stall`` stalls the in-order emit (the slow consumer),
``transfer_abort`` ends the exchange with the resume token in the typed
error.

Observability: a root ``transfer`` span chains every ``transfer-chunk`` span
(and, through ``parent=``, each chunk's queue and dispatch spans);
``serve_transfer_*`` counters and the ``serve_stage_us{stage="reassembly"}``
histogram hold the exact counts; ``serve_reassembly_held_bytes`` gauges the
buffer. asyncio, numpy and the port's obs/resilience copies only: no device
here.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import time
import uuid
from dataclasses import dataclass

import numpy as np

from ..obs import metrics, trace
from ..resilience import faults
from ..resilience.policy import Budget
from .queue import (ERR_BAD_REQUEST, ERR_DEADLINE, ERR_SHED, ERR_TOO_LARGE, ERR_TRANSFER_ABORT,
                    ERR_TRANSFER_MODE, Response)

#: The modes the chunk decomposition serves bit-exactly; an oversized GCM
#: payload is a typed refusal.
TRANSFER_MODES = ("ctr", "cbc")

LEDGER_KIND = "ot-transfer-ledger"
LEDGER_VERSION = 1


def _slow_s() -> float:
    """The injected stall (``OT_SLOW_S``, the knob of every simulated-latency
    fault)."""
    try:
        return max(float(os.environ.get("OT_SLOW_S", 0.05)), 0.0)
    except ValueError:
        return 0.05


def chunk_nonce(nonce: bytes, start_block: int) -> bytes:
    """The CTR counter start of the chunk whose first block is block
    ``start_block`` of the whole payload: the 128-bit big-endian add mod
    2^128, so chunked and whole keystreams agree across a counter wrap."""
    if len(nonce) != 16:
        raise ValueError(f"nonce must be 16 bytes, got {len(nonce)}")
    n = (int.from_bytes(nonce, "big") + int(start_block)) % (1 << 128)
    return n.to_bytes(16, "big")


@dataclass(frozen=True)
class ChunkSpec:
    """One planned chunk: where it lies in the transfer and its cipher
    parameters."""

    index: int
    offset: int          #: byte offset into the transfer payload
    nbytes: int
    nonce: bytes = b""   #: ctr: the chunk's 16-byte counter start
    iv: bytes = b""      #: cbc: the chunk's IV (the previous ciphertext block)


def plan(mode: str, chunk_blocks: int, total_bytes: int, nonce: bytes = b"", iv: bytes = b"",
         payload=None, tails: dict | None = None) -> list[ChunkSpec]:
    """Split a transfer into chunks of ``chunk_blocks`` blocks (the last one
    ragged). ``payload`` (cbc: the ciphertext, for the IV chain) may be
    sparse on a resume: ``tails`` maps a chunk index to that chunk's last 16
    input bytes (the ledger keeps them at ack time), so a chunk whose
    predecessor was acked on an earlier connection still has its IV."""
    if total_bytes <= 0 or total_bytes % 16:
        raise ValueError("payload must be a nonzero multiple of 16 bytes")
    if chunk_blocks <= 0:
        raise ValueError(f"chunk_blocks must be positive, got {chunk_blocks}")
    step = int(chunk_blocks) * 16
    specs = []
    tails = tails or {}
    for i, off in enumerate(range(0, total_bytes, step)):
        n = min(step, total_bytes - off)
        if mode == "ctr":
            specs.append(ChunkSpec(i, off, n, nonce=chunk_nonce(nonce, off // 16)))
        elif mode == "cbc":
            if off == 0:
                civ = bytes(iv)
            elif i - 1 in tails:
                civ = bytes(tails[i - 1])
            elif payload is not None:
                civ = bytes(bytearray(np.asarray(payload, dtype=np.uint8)[off - 16:off]))
            else:
                raise ValueError(f"cbc chunk {i} needs the previous chunk's tail "
                                 "(payload slice or ledger tail)")
            if len(civ) != 16:
                raise ValueError(f"cbc chunk {i} derived a {len(civ)}-byte IV")
            specs.append(ChunkSpec(i, off, n, iv=civ))
        else:
            raise ValueError(f"mode {mode!r} is not chunkable (transfer modes: {TRANSFER_MODES})")
    return specs


def fingerprint(mode: str, key: bytes, nonce: bytes, iv: bytes, total_bytes: int,
                chunk_blocks: int) -> str:
    """The parameter fingerprint a resume token is pinned to: the same token
    with other parameters would not splice byte-identically, so it starts a
    fresh transfer. The key enters as a digest (the ledger holds no key
    bytes); the payload is not fingerprinted (a resuming client presents
    only its unacked chunks)."""
    h = hashlib.sha256()
    h.update(mode.encode())
    h.update(hashlib.sha256(bytes(key)).digest())
    h.update(bytes(nonce))
    h.update(bytes(iv))
    h.update(int(total_bytes).to_bytes(8, "big"))
    h.update(int(chunk_blocks).to_bytes(8, "big"))
    return h.hexdigest()[:32]


class TransferLedger:
    """The acked-chunk ledger (transfer id -> fingerprint, acked chunks, CBC
    tails): a JSONL header and rows, every append flushed and fsync'd (an ack
    is the resume contract and must outlive the process), a torn tail
    truncated on load, compacted once dead rows dominate. ``path=None`` keeps
    it in memory (same API, no durability)."""

    def __init__(self, path: str | None = None, max_live: int = 4096,
                 compact_min_rows: int = 1024):
        self.path = path
        self.max_live = int(max_live)
        self.compact_min_rows = int(compact_min_rows)
        self._fh = None
        #: op rows on disk (begin/ack/done), the compaction trigger's count
        self._rows = 0
        self.compactions = 0
        #: tid -> {"fp", "chunks", "acked": set[int], "tails": {i: bytes}}
        self._live: dict[str, dict] = {}
        if path is not None:
            self._load()
            fresh = not os.path.exists(path) or os.path.getsize(path) == 0
            self._fh = open(path, "a", encoding="utf-8")
            if fresh:
                self._append({"kind": LEDGER_KIND, "v": LEDGER_VERSION,
                              "created_us": trace.now_us()})

    # -- persistence -------------------------------------------------------
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        good = []
        torn = False
        with open(self.path, encoding="utf-8") as fh:
            for line in fh:
                try:
                    row = json.loads(line)
                except ValueError:
                    torn = True  # a torn tail (or garbage): drop from here
                    break
                good.append(line)
                if "op" in row:
                    self._rows += 1
                self._replay(row)
        if torn:
            # Appending after a partial line would weld two rows together.
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.writelines(good)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)

    def _replay(self, row: dict) -> None:
        op = row.get("op")
        tid = row.get("tid")
        if op == "begin":
            st = self._live.get(tid)
            if st is None or st["fp"] != row.get("fp"):
                self._live[tid] = {"fp": row.get("fp"), "chunks": int(row.get("chunks", 0)),
                                   "acked": set(), "tails": {}}
            # The live bound holds across restarts too.
            while len(self._live) > self.max_live:
                self._live.pop(next(iter(self._live)))
        elif op == "ack" and tid in self._live:
            st = self._live[tid]
            st["acked"].add(int(row["i"]))
            tail = row.get("tail")
            if tail:
                st["tails"][int(row["i"])] = bytes.fromhex(tail)
        elif op == "done":
            self._live.pop(tid, None)

    def _append(self, row: dict) -> None:
        """One durable row: on disk before the chunk is acknowledged to the
        client, hence the inline fsync."""
        if self._fh is None:
            return
        self._fh.write(json.dumps(row, separators=(",", ":")) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())
        if "op" in row:
            self._rows += 1
            self._maybe_compact()

    def _state_rows(self) -> int:
        """Rows a compacted journal holds: a begin and one ack per acked
        chunk, per live transfer."""
        return sum(1 + len(st["acked"]) for st in self._live.values())

    def _maybe_compact(self) -> None:
        """Rewrite the journal from the live set once dead rows (done or
        evicted transfers, superseded begins) dominate; small journals stay
        append-only."""
        if self._fh is None:
            return
        if self._rows <= max(self.compact_min_rows, 4 * (self._state_rows() + 1)):
            return
        rows = [{"kind": LEDGER_KIND, "v": LEDGER_VERSION, "created_us": trace.now_us()}]
        for tid, st in self._live.items():
            rows.append({"op": "begin", "tid": tid, "fp": st["fp"], "chunks": int(st["chunks"])})
            for i in sorted(st["acked"]):
                r = {"op": "ack", "tid": tid, "i": int(i)}
                tail = st["tails"].get(i)
                if tail:
                    r["tail"] = bytes(tail).hex()
                rows.append(r)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for r in rows:
                fh.write(json.dumps(r, separators=(",", ":")) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._rows = len(rows) - 1  # the header is not an op row
        self.compactions += 1

    # -- the transfer engine's API -----------------------------------------
    def begin(self, tid: str, fp: str, chunks: int) -> set[int]:
        """Open (or reopen) a transfer; the chunks already acked, empty for a
        fresh transfer or when the fingerprint differs (other parameters
        restart rather than splice incompatible outputs)."""
        st = self._live.get(tid)
        if st is not None and st["fp"] == fp:
            return set(st["acked"])
        if len(self._live) >= self.max_live:
            # Evict the oldest live transfer, journaled as a done row so a
            # restart does not replay it.
            old = next(iter(self._live))
            self._live.pop(old)
            self._append({"op": "done", "tid": old, "ok": False, "evicted": True})
        self._live[tid] = {"fp": fp, "chunks": int(chunks), "acked": set(), "tails": {}}
        self._append({"op": "begin", "tid": tid, "fp": fp, "chunks": int(chunks)})
        return set()

    def ack(self, tid: str, i: int, tail: bytes = b"") -> None:
        st = self._live.get(tid)
        if st is None:
            return
        st["acked"].add(int(i))
        if tail:
            st["tails"][int(i)] = bytes(tail)
        row = {"op": "ack", "tid": tid, "i": int(i)}
        if tail:
            row["tail"] = bytes(tail).hex()
        self._append(row)

    def acked(self, tid: str) -> set[int]:
        st = self._live.get(tid)
        return set(st["acked"]) if st is not None else set()

    def tails(self, tid: str) -> dict:
        st = self._live.get(tid)
        return dict(st["tails"]) if st is not None else {}

    def done(self, tid: str, ok: bool = True) -> None:
        if tid in self._live:
            self._live.pop(tid, None)
            self._append({"op": "done", "tid": tid, "ok": bool(ok)})

    def live(self) -> int:
        return len(self._live)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None


class TransferManager:
    """Plans, streams, reassembles and resumes transfers.

    ``submit_chunk`` is ``async (tenant, key, spec, payload_slice, *, mode,
    deadline_s, sampled, parent) -> Response`` (the server's queue
    admission). Everything about robustness lives here: the in-flight
    window, the per-transfer ``Budget``, the bounded reassembly buffer, the
    fault seams, the ledger and the spans."""

    def __init__(self, submit_chunk, *, chunk_blocks: int, max_transfers: int = 8,
                 window: int = 8, reassembly_budget_bytes: int = 64 << 20,
                 max_payload_bytes: int = 1 << 30, deadline_s: float = 300.0,
                 retry_backoff_s: float = 0.05, ledger: TransferLedger | None = None,
                 clock=time.monotonic):
        self._submit = submit_chunk
        self.chunk_blocks = int(chunk_blocks)
        self.max_transfers = int(max_transfers)
        self.window = int(window)
        self.reassembly_budget_bytes = int(reassembly_budget_bytes)
        #: the per-transfer size ceiling, checked against a client's declared
        #: total before anything is allocated for it
        self.max_payload_bytes = int(max_payload_bytes)
        self.deadline_s = float(deadline_s)
        self.retry_backoff_s = float(retry_backoff_s)
        self.ledger = ledger if ledger is not None else TransferLedger()
        self._clock = clock
        self.active = 0
        self.held_bytes = 0
        self.held_peak = 0
        self.started = 0
        self.completed = 0
        self.resumed = 0
        self.aborted = 0
        self.shed = 0
        self.refused = 0
        self.chunks_sent = 0
        self.chunks_skipped = 0
        self.chunk_redispatches = 0
        self.bytes_out = 0
        metrics.gauge("serve_transfer_budget_bytes", self.reassembly_budget_bytes)

    # -- admission ----------------------------------------------------------
    def _refuse(self, code: str, why: str, mode: str) -> Response:
        self.refused += 1
        metrics.counter("serve_transfer_refused", code=code)
        return Response(ok=False, error=code, detail=why)

    def _shed(self, reason: str, why: str) -> Response:
        self.shed += 1
        metrics.counter("serve_transfer_shed", reason=reason)
        return Response(ok=False, error=ERR_SHED, detail=why)

    async def run(self, tenant: str, key: bytes, nonce: bytes, payload, *, mode: str = "ctr",
                  iv: bytes = b"", deadline_s: float | None = None, sampled: bool | None = None,
                  parent: str | None = None, resume_token: str | None = None,
                  tails: dict | None = None, on_chunk=None) -> Response:
        """Serve one oversized payload as a chunked transfer.

        ``on_chunk`` (optional, sync or async ``(spec, response)``) is the
        streaming consumer, called in chunk order as the contiguous prefix
        completes (the wire front end streams out-frames from it); with it,
        chunks acked on an earlier connection are skipped and
        ``Response.payload`` is None. Without it the chunks splice into one
        payload on the ``Response``. Every answer carries
        ``Response.transfer`` (the token and the chunk tallies)."""
        data = np.asarray(payload, dtype=np.uint8).reshape(-1)
        mode = str(mode or "ctr")
        if mode not in TRANSFER_MODES:
            return self._refuse(ERR_TRANSFER_MODE, (
                f"mode {mode!r} cannot be served as a chunked transfer "
                f"(chunkable: {TRANSFER_MODES}); GCM's tag is a GHASH "
                "over the whole message and host-side GHASH continuation "
                "across chunk tags is not implemented — submit at or "
                "below the ladder cap, or use ctr/cbc"), mode)
        if data.size == 0 or data.size % 16:
            return self._refuse(ERR_BAD_REQUEST,
                                "payload must be a nonzero multiple of 16 bytes", mode)
        if data.size > self.max_payload_bytes:
            return self._refuse(ERR_TOO_LARGE, (
                f"payload {data.size} bytes exceeds the transfer cap "
                f"({self.max_payload_bytes} bytes)"), mode)
        try:
            specs = plan(mode, self.chunk_blocks, data.size, nonce=nonce, iv=iv, payload=data,
                         tails=tails)
        except ValueError as e:
            return self._refuse(ERR_BAD_REQUEST, f"transfer plan: {e}", mode)
        # Backpressure before any work: a full transfer table or a
        # reassembly buffer over budget sheds new transfers; admitted ones
        # keep flowing.
        if self.active >= self.max_transfers:
            return self._shed("transfers", (
                f"{self.active} transfers in flight (max "
                f"{self.max_transfers}); retry with backoff"))
        if self.held_bytes > self.reassembly_budget_bytes:
            return self._shed("reassembly", (
                f"reassembly buffer over budget ({self.held_bytes} > "
                f"{self.reassembly_budget_bytes} bytes held); the "
                "consumer is slow — retry with backoff"))

        tid = resume_token or uuid.uuid4().hex
        fp = fingerprint(mode, key, nonce, iv, data.size, self.chunk_blocks)
        acked = self.ledger.begin(tid, fp, len(specs))
        # Resuming needs a consumer: without one the response carries every
        # byte, so acked chunks are computed again.
        skip = acked if on_chunk is not None else set()
        resumed = bool(resume_token) and bool(skip)
        if sampled is None:
            sampled = trace.sample()
        if deadline_s is None:
            deadline_s = self.deadline_s
        budget = Budget(deadline_s, clock=self._clock)
        self.started += 1
        if resumed:
            self.resumed += 1
            metrics.counter("serve_transfer_resumed", mode=mode)
        metrics.counter("serve_transfer_requests", mode=mode)
        self.chunks_skipped += len(skip)
        if skip:
            metrics.counter("serve_transfer_chunks", len(skip), outcome="skipped", mode=mode)

        cm = trace.maybe_span(sampled, "transfer", parent=parent, tenant=tenant, mode=mode,
                              chunks=len(specs), blocks=data.size // 16, resumed=resumed)
        cm.__enter__()
        root = cm.span_id
        self.active += 1
        t0 = self._clock()
        out = np.empty(data.size, dtype=np.uint8) if on_chunk is None else None
        results: dict[int, Response] = {}
        landed = asyncio.Event()
        abort: list = []  # [code, detail]: the first failure wins
        sem = asyncio.Semaphore(max(self.window, 1))
        sent = 0
        redispatched = 0

        def _fail(code: str, detail: str) -> None:
            if not abort:
                abort.extend((code, detail))
            landed.set()

        async def run_chunk(spec: ChunkSpec) -> None:
            nonlocal sent, redispatched
            async with sem:
                while True:
                    if abort:
                        return
                    if budget.exhausted():
                        _fail(ERR_DEADLINE, (
                            f"transfer budget spent ({budget.spent():.3f}s of {deadline_s}s) "
                            f"before chunk {spec.index} dispatched"))
                        return
                    # The per-chunk admission seam: transfer_abort ends the
                    # whole exchange here.
                    if faults.fire_chunk("transfer_abort", spec.index):
                        _fail(ERR_TRANSFER_ABORT, (
                            f"injected transfer_abort at chunk {spec.index}; present the "
                            "resume token to finish"))
                        return
                    piece = data[spec.offset:spec.offset + spec.nbytes]
                    ccm = trace.maybe_span(sampled, "transfer-chunk", parent=root,
                                           chunk=spec.index, blocks=spec.nbytes // 16)
                    ccm.__enter__()
                    try:
                        sent += 1
                        remaining = budget.remaining()
                        resp = await self._submit(
                            tenant, key, spec, piece, mode=mode,
                            deadline_s=(None if remaining == float("inf")
                                        else max(remaining, 0.001)),
                            sampled=sampled, parent=root)
                    except Exception as e:  # noqa: BLE001 - a typed answer
                        ccm.__exit__(type(e), e, None)
                        _fail(ERR_TRANSFER_ABORT, f"chunk {spec.index} dispatch raised: {e}")
                        return
                    if resp.ok and faults.fire_chunk("chunk_lost", spec.index):
                        # The injected loss: the chunk was served and its
                        # answer lost; dispatch exactly this chunk again.
                        ccm.__exit__(RuntimeError, None, None)
                        redispatched += 1
                        self.chunk_redispatches += 1
                        metrics.counter("serve_transfer_chunks", outcome="redispatch", mode=mode)
                        continue
                    if not resp.ok and resp.error == ERR_SHED and not budget.exhausted():
                        # A shed chunk is backpressure: back off within the
                        # budget and dispatch it again.
                        ccm.__exit__(RuntimeError, None, None)
                        redispatched += 1
                        self.chunk_redispatches += 1
                        metrics.counter("serve_transfer_chunks", outcome="redispatch", mode=mode)
                        await asyncio.sleep(self.retry_backoff_s)
                        continue
                    if not resp.ok:
                        ccm.__exit__(RuntimeError, None, None)
                        _fail(resp.error or ERR_TRANSFER_ABORT,
                              f"chunk {spec.index}: {resp.detail}")
                        return
                    ccm.__exit__(None, None, None)
                    metrics.counter("serve_transfer_chunks", outcome="ok", mode=mode)
                    results[spec.index] = resp
                    self.held_bytes += spec.nbytes
                    if self.held_bytes > self.held_peak:
                        self.held_peak = self.held_bytes
                    metrics.gauge("serve_reassembly_held_bytes", self.held_bytes)
                    landed.set()
                    return

        tasks = [asyncio.ensure_future(run_chunk(s)) for s in specs if s.index not in skip]
        try:
            try:
                # The in-order emit loop, the one consumer-facing seam.
                for spec in specs:
                    if spec.index in skip:
                        continue  # acked on an earlier connection
                    t_wait = self._clock()
                    while spec.index not in results and not abort:
                        landed.clear()
                        if spec.index in results or abort:
                            break
                        try:
                            await asyncio.wait_for(landed.wait(), timeout=0.25)
                        except asyncio.TimeoutError:
                            if budget.exhausted():
                                _fail(ERR_DEADLINE, (
                                    f"transfer budget spent waiting to reassemble chunk "
                                    f"{spec.index}"))
                    if abort:
                        break
                    resp = results.pop(spec.index)
                    metrics.observe("serve_stage_us", (self._clock() - t_wait) * 1e6,
                                    stage="reassembly")
                    try:
                        if faults.fire_chunk("reassembly_stall", spec.index):
                            # The slow consumer, as an awaitable stall: the
                            # manager shares the dispatch loop's thread.
                            await asyncio.sleep(_slow_s())
                        if on_chunk is not None:
                            r = on_chunk(spec, resp)
                            if asyncio.iscoroutine(r):
                                await r
                        else:
                            out[spec.offset:spec.offset + spec.nbytes] = resp.payload
                    except Exception as e:  # noqa: BLE001 - a typed abort
                        # A raising consumer (a writer into a closed
                        # socket) aborts like a failed chunk, so the token
                        # stays presentable.
                        _fail(ERR_TRANSFER_ABORT,
                              f"consumer failed emitting chunk {spec.index}: {e}")
                        break
                    finally:
                        # The popped chunk's hold is released on every path:
                        # held_bytes is manager-wide admission state.
                        self.held_bytes -= spec.nbytes
                        metrics.gauge("serve_reassembly_held_bytes", self.held_bytes)
                    tail = b""
                    if mode == "cbc":
                        # A resumed cbc transfer plans chunk i+1's IV from
                        # this tail without chunk i's bytes.
                        end = spec.offset + spec.nbytes
                        tail = bytes(bytearray(data[end - 16:end]))
                    self.ledger.ack(tid, spec.index, tail=tail)
                    self.bytes_out += spec.nbytes
            finally:
                # In-flight chunks never outlive the exchange.
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                # Chunks that landed but were never emitted release their
                # hold.
                for spec in specs:
                    if results.pop(spec.index, None) is not None:
                        self.held_bytes -= spec.nbytes
                metrics.gauge("serve_reassembly_held_bytes", self.held_bytes)
        except BaseException as e:
            cm.__exit__(type(e), e, e.__traceback__)
            raise
        finally:
            self.active -= 1

        self.chunks_sent += sent
        tx = {"token": tid, "chunks": len(specs), "sent": sent, "skipped": len(skip),
              "redispatched": redispatched, "acked": len(self.ledger.acked(tid)),
              "resumed": resumed}
        if abort:
            self.aborted += 1
            metrics.counter("serve_transfer_aborts", code=abort[0])
            cm.__exit__(RuntimeError, None, None)  # a failure's span is kept
            return Response(ok=False, error=abort[0], detail=abort[1], transfer=tx)
        self.ledger.done(tid, ok=True)
        self.completed += 1
        metrics.counter("serve_transfer_completed", mode=mode)
        metrics.counter("serve_transfer_bytes", data.size, mode=mode)
        metrics.observe("serve_transfer_us", (self._clock() - t0) * 1e6)
        cm.__exit__(None, None, None)
        return Response(ok=True, payload=out if on_chunk is None else None, queued_s=0.0,
                        transfer=tx)

    def stats(self) -> dict:
        """The ``transfers`` section of the server's stats and ``/healthz``."""
        return {"chunk_blocks": self.chunk_blocks, "started": self.started,
                "completed": self.completed, "resumed": self.resumed, "aborted": self.aborted,
                "shed": self.shed, "refused": self.refused, "active": self.active,
                "chunks_sent": self.chunks_sent, "chunks_skipped": self.chunks_skipped,
                "chunk_redispatches": self.chunk_redispatches, "bytes_out": self.bytes_out,
                "held_bytes": self.held_bytes, "held_peak_bytes": self.held_peak,
                "budget_bytes": self.reassembly_budget_bytes, "ledger_live": self.ledger.live()}
