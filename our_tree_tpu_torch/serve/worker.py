"""``python -m our_tree_tpu_torch.serve.worker``: one serve back-end process.

Port of ``our_tree_tpu.serve.worker``: a whole ``serve.Server`` (lanes,
batcher, keycache, transfers, status endpoint) behind a TCP front end that
speaks the framed wire protocol (``serve/wire.py``). The worker adds no
policy of its own: admission, batching, dispatch, health and drain are the
server's; this module moves frames. ``--device`` (default ``cuda``, which
raises without a card; ``cpu`` serves on the plain version) is the port's
one flag beyond the JAX package's.

Lifecycle:

* **READY line.** After warmup, one JSON line on stdout,
  ``{"kind": "ot-serve-worker", "port": P, "status_port": S, "engine": ...,
  "lanes": N, "pid": ...}``, with the bound ports (``--port 0`` and
  ``--status-port 0`` bind ephemeral ones).
* **Graceful drain on SIGTERM/SIGINT.** Admission closes first (``/healthz``
  answers ``draining``), the listener closes, open connections finish their
  exchanges (a submit after the close answers ``shutdown``) for up to 30 s,
  then ``Server.stop()`` drains every accepted request.
* **EXIT line and rc.** One last JSON line, ``{"kind":
  "ot-serve-worker-exit", "lost": L, ...}``, and exit 0 only if ``lost ==
  0``. Two diagnostic keys the JAX worker's line lacks:
  ``diag_engine_calls`` (the lanes' engine calls by mode) and
  ``diag_launches`` (each kernel wrapper's launches in this process, 0 on
  the CPU), so a router drive can hold each worker's launches against its
  engine calls.

Per-connection containment: a ``FrameTooLarge`` whose payload can be drained
answers a typed ``too-large`` frame and the connection goes on; a torn or
unparseable frame answers ``bad-request`` and closes that connection only.
A request frame is one exchange in any enabled mode (``m``: ``ctr``,
``gcm``, ``gcm-open``, ``cbc``); a ``tx`` frame opens the chunked-transfer
exchange (``_serve_transfer``); an ``ss`` frame is one exchange of the rc4
session sub-protocol (``_serve_session``: ``open``, ``data``, ``close``;
a server without ``rc4`` answers each with ``bad-request``). The
per-request time ledger (``lg``) is not in the port, so no answer carries
one. ``--journal`` persists the lanes' quarantines; the five
``--session-*`` options shape the session store; ``--native-threads`` sets
the native tier's ECB threads a slot run (``--engine native``, or ``auto``
on the CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys

import numpy as np

from ..obs import trace
from ..resilience import watchdog
from ..resilience.policy import Budget
from . import batcher, transfer, wire
from .queue import ERR_BAD_REQUEST, ERR_DEADLINE, ERR_TOO_LARGE, ERR_TRANSFER_MODE
from .server import Server, ServerConfig

class RequestFrontend:
    """The TCP listener that feeds ``Server.submit`` from wire frames;
    importable for in-process use."""

    def __init__(self, server: Server, port: int, host: str = "127.0.0.1"):
        self._server = server
        self._host = host
        self._port = int(port)
        self._srv: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.Task] = set()
        self.port: int | None = None
        self.connections = 0
        self.frames = 0
        self.protocol_errors = 0

    async def start(self) -> None:
        self._max_len = max(self._server.rungs[-1] * 16, wire.MAX_PAYLOAD)
        self._srv = await asyncio.start_server(self._on_conn, self._host, self._port)
        self.port = self._srv.sockets[0].getsockname()[1]

    async def stop(self, grace_s: float = 5.0) -> None:
        """Close the listener, let open connections finish their exchanges,
        then cancel those still open after ``grace_s`` (an idle client holds
        no request in flight). The listener's ``wait_closed`` comes last: on
        Python 3.12 it waits for every open connection, so awaited first it
        would wait forever on an idle client (a router's pooled socket)."""
        if self._srv is not None:
            self._srv.close()
        if self._conns:
            _done, pending = await asyncio.wait(list(self._conns), timeout=max(grace_s, 0.0))
            for task in pending:
                task.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        if self._srv is not None:
            await self._srv.wait_closed()
            self._srv = None

    def _on_conn(self, reader, writer) -> None:
        self.connections += 1
        task = asyncio.ensure_future(self._serve_conn(reader, writer))
        self._conns.add(task)
        task.add_done_callback(self._conns.discard)

    async def _serve_conn(self, reader, writer) -> None:
        """One connection's frames in order: the protocol is strict request
        and response."""
        try:
            while True:
                try:
                    frame = await wire.read_frame(reader, self._max_len)
                except wire.FrameTooLarge as e:
                    # The header parsed, so the stream is still framed: a
                    # typed answer, and the connection stays when the
                    # declared payload is small enough to drain.
                    self.protocol_errors += 1
                    try:
                        writer.write(wire.encode_frame({"ok": False, "error": ERR_TOO_LARGE,
                                                        "detail": f"wire: {e}"}))
                        await writer.drain()
                    except Exception:  # noqa: BLE001 - the peer is gone
                        return
                    if 0 <= e.declared <= 4 * self._max_len and \
                            await wire.skip_payload(reader, e.declared):
                        continue
                    return
                except wire.WireError as e:
                    self.protocol_errors += 1
                    try:
                        writer.write(wire.encode_frame({"ok": False, "error": ERR_BAD_REQUEST,
                                                        "detail": f"wire: {e}"}))
                        await writer.drain()
                    except Exception:  # noqa: BLE001 - the peer is gone
                        pass
                    return
                if frame is None:
                    return  # a clean EOF between frames
                header, payload = frame
                self.frames += 1
                if header.get("tx"):
                    await self._serve_transfer(reader, writer, header)
                    continue
                if header.get("ss"):
                    await self._serve_session(writer, header, payload)
                    continue
                await self._answer(writer, header, payload)
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - the peer is gone
                pass

    async def _answer(self, writer, header: dict, payload: bytes) -> None:
        t_rx = trace.now_us()
        try:
            key = bytes.fromhex(str(header.get("k", "")))
            nonce = bytes.fromhex(str(header.get("n", "")))
            # A malformed hex field becomes b"", which admission answers
            # with its coded error.
            iv = bytes.fromhex(str(header.get("iv", "")))
            aad = bytes.fromhex(str(header.get("a", "")))
            tag = bytes.fromhex(str(header.get("tg", "")))
        except ValueError:
            key, nonce = b"", b""
            iv = aad = tag = b""
        mode = str(header.get("m") or "ctr")
        try:
            deadline = header.get("deadline_s")
            deadline = float(deadline) if deadline is not None else None
        except (TypeError, ValueError):
            writer.write(wire.encode_frame({"ok": False, "error": ERR_BAD_REQUEST,
                                            "detail": "deadline_s is not a number"}))
            await writer.drain()
            return
        sampled = header.get("sm")
        sampled = bool(sampled) if sampled is not None else None
        parent = header.get("ps")
        parent = str(parent) if parent else None
        priority = 0 if header.get("pr") == 0 else None
        resp = await self._server.submit(str(header.get("t", "")), key, nonce,
                                         memoryview(payload), deadline_s=deadline,
                                         sampled=sampled, parent=parent, priority=priority,
                                         mode=mode, iv=iv, aad=aad, tag=tag)
        if resp.ok:
            out = {"ok": True, "batch": resp.batch}
            if resp.tag is not None:  # a gcm seal's tag
                out["tg"] = resp.tag.hex()
            body = resp.payload.tobytes()
        else:
            out = {"ok": False, "error": resp.error, "detail": resp.detail, "batch": resp.batch}
            body = b""
        # The server's clock at receipt and at reply, and its pid.
        out["tr"] = t_rx
        out["ts"] = trace.now_us()
        out["pid"] = os.getpid()
        writer.write(wire.encode_frame(out, body))
        await writer.drain()

    async def _serve_session(self, writer, header: dict, payload: bytes) -> None:
        """The ``ss`` session sub-protocol (mode ``rc4``). Each frame is its
        own exchange, so one connection interleaves many sessions' frames
        and ordinary requests, and the batcher coalesces concurrent
        sessions' chunks:

        * ``{"ss": "open", t, sid, k}``: host KSA and the window prefill;
          answers ``ok`` or a typed shed or refusal;
        * ``{"ss": "data", t, sid}`` with the chunk as payload: XOR against
          the session's next keystream bytes, the output as the answer's
          payload. The stream does not rewind: after a failed chunk, close
          the session and open it again;
        * ``{"ss": "close", t, sid}``: release the session."""
        t_rx = trace.now_us()
        op = str(header.get("ss") or "")
        tenant = str(header.get("t", ""))
        try:
            sid = int(header.get("sid"))
        except (TypeError, ValueError):
            writer.write(wire.encode_frame({"ss": op, "ok": False, "error": ERR_BAD_REQUEST,
                                            "detail": "ss frames need an integer sid"}))
            await writer.drain()
            return
        sampled = header.get("sm")
        sampled = bool(sampled) if sampled is not None else None
        parent = header.get("ps")
        parent = str(parent) if parent else None
        body = b""
        if op == "open":
            try:
                key = bytes.fromhex(str(header.get("k", "")))
            except ValueError:
                key = b""
            resp = await self._server.open_session(tenant, sid, key)
        elif op == "data":
            try:
                deadline = header.get("deadline_s")
                deadline = float(deadline) if deadline is not None else None
            except (TypeError, ValueError):
                writer.write(wire.encode_frame({"ss": op, "ok": False, "error": ERR_BAD_REQUEST,
                                                "detail": "deadline_s is not a number"}))
                await writer.drain()
                return
            resp = await self._server.submit(tenant, b"", b"", memoryview(payload),
                                             deadline_s=deadline, sampled=sampled, parent=parent,
                                             mode="rc4", sid=sid)
            if resp.ok:
                body = resp.payload.tobytes()
        elif op == "close":
            resp = await self._server.close_session(tenant, sid)
        else:
            writer.write(wire.encode_frame({"ss": op, "ok": False, "error": ERR_BAD_REQUEST,
                                            "detail": f"unknown ss op {op!r} "
                                                      "(known: open, data, close)"}))
            await writer.drain()
            return
        out = {"ss": op, "ok": resp.ok, "sid": sid, "tr": t_rx, "ts": trace.now_us(),
               "pid": os.getpid()}
        if resp.ok:
            if resp.batch:
                out["batch"] = resp.batch
            if resp.detail:
                out["detail"] = resp.detail
        else:
            out["error"] = resp.error
            out["detail"] = resp.detail
        writer.write(wire.encode_frame(out, body))
        await writer.drain()

    async def _serve_transfer(self, reader, writer, header: dict) -> None:
        """The ``tx`` resumable-transfer sub-protocol, one exchange:

        1. client: ``{"tx": "begin", "tid"?, t, k, n|iv, m, total}``;
        2. worker: ``{"tx": "begin-ack", tid, chunks, chunk_blocks, acked:
           [...]}``, the acked chunks from the transfer ledger (a fresh tid
           acks none);
        3. client: one ``{"tx": "chunk", "i"}`` frame with its payload per
           unacked chunk, in any order;
        4. worker: ``{"tx": "out", "i"}`` frames in chunk order as the
           contiguous prefix completes (each after its ledger ack), then
           ``{"tx": "done", ...}`` with the transfer's tallies.

        After a failure mid-exchange (a cut connection, ``transfer_abort``)
        the acks remain: the client reconnects with its tid, and steps 3-4
        cover only what was not acked. The upload runs under the transfer's
        deadline."""
        async def refuse(code: str, why: str) -> None:
            writer.write(wire.encode_frame({"tx": "done", "ok": False, "error": code,
                                            "detail": why}))
            await writer.drain()

        if header.get("tx") != "begin":
            await refuse(ERR_BAD_REQUEST,
                         f"tx exchange must open with begin, got {header.get('tx')!r}")
            return
        tm = self._server.transfers
        if tm is None:
            await refuse(ERR_TOO_LARGE, "transfers disabled on this server")
            return
        try:
            key = bytes.fromhex(str(header.get("k", "")))
            nonce = bytes.fromhex(str(header.get("n", "")))
            iv = bytes.fromhex(str(header.get("iv", "")))
        except ValueError:
            key, nonce, iv = b"", b"", b""
        mode = str(header.get("m") or "ctr")
        try:
            total = int(header.get("total", 0))
            deadline = header.get("deadline_s")
            deadline = float(deadline) if deadline is not None else None
        except (TypeError, ValueError):
            await refuse(ERR_BAD_REQUEST, "total/deadline_s malformed")
            return
        # Refuse an unservable exchange at begin, before any upload.
        if mode not in transfer.TRANSFER_MODES:
            await refuse(ERR_TRANSFER_MODE, (f"mode {mode!r} is not chunkable "
                                             f"(transfer modes: {transfer.TRANSFER_MODES})"))
            return
        if total <= 0 or total % 16:
            await refuse(ERR_BAD_REQUEST, "total must be a nonzero multiple of 16 bytes")
            return
        if total > tm.max_payload_bytes:
            # The declared total is the client's input: bounded before a
            # buffer is sized from it.
            await refuse(ERR_TOO_LARGE, (f"total {total} bytes exceeds this server's transfer "
                                         f"cap ({tm.max_payload_bytes} bytes)"))
            return
        step = tm.chunk_blocks * 16
        chunks = (total + step - 1) // step
        tid = str(header.get("tid") or "") or os.urandom(16).hex()
        fp = transfer.fingerprint(mode, key, nonce, iv, total, tm.chunk_blocks)
        acked = tm.ledger.begin(tid, fp, chunks)
        writer.write(wire.encode_frame({"tx": "begin-ack", "tid": tid, "chunks": chunks,
                                        "chunk_blocks": tm.chunk_blocks,
                                        "acked": sorted(acked)}))
        await writer.drain()

        # The unacked chunks land in a sparse buffer; acked regions stay
        # zero and are never read (cbc IVs after them come from the ledger's
        # tails).
        buf = np.zeros(total, dtype=np.uint8)
        needed = set(range(chunks)) - set(acked)
        upload = Budget(deadline if deadline is not None else tm.deadline_s)
        while needed:
            try:
                left = upload.remaining()
                frame = await asyncio.wait_for(
                    wire.read_frame(reader, self._max_len),
                    timeout=None if left == float("inf") else max(left, 0.001))
            except asyncio.TimeoutError:
                await refuse(ERR_DEADLINE, (f"upload stalled: {len(needed)} chunks still "
                                            f"unsent after {upload.spent():.3f}s"))
                return
            except wire.WireError as e:
                self.protocol_errors += 1
                await refuse(ERR_BAD_REQUEST, f"wire: {e}")
                return
            if frame is None:
                return  # the client left mid-upload; the acks remain
            h, body = frame
            self.frames += 1
            if h.get("tx") != "chunk":
                await refuse(ERR_BAD_REQUEST, f"expected a chunk frame, got {h.get('tx')!r}")
                return
            try:
                i = int(h.get("i"))
            except (TypeError, ValueError):
                await refuse(ERR_BAD_REQUEST, "chunk index malformed")
                return
            want = min(step, total - i * step) if 0 <= i < chunks else -1
            if want != len(body):
                await refuse(ERR_BAD_REQUEST, f"chunk {i}: {len(body)} bytes, expected {want}")
                return
            buf[i * step:i * step + want] = np.frombuffer(body, np.uint8)
            needed.discard(i)

        sampled = header.get("sm")
        sampled = bool(sampled) if sampled is not None else None
        parent = header.get("ps")
        parent = str(parent) if parent else None

        async def on_chunk(spec, resp) -> None:
            body = np.asarray(resp.payload, dtype=np.uint8).tobytes()
            writer.write(wire.encode_frame({"tx": "out", "i": spec.index}, body))
            await writer.drain()

        resp = await self._server.submit_transfer(
            str(header.get("t", "")), key, nonce, buf, deadline_s=deadline, sampled=sampled,
            parent=parent, mode=mode, iv=iv, resume_token=tid, tails=tm.ledger.tails(tid),
            on_chunk=on_chunk)
        out = {"tx": "done", "ok": resp.ok, "tid": tid, "transfer": resp.transfer,
               "ts": trace.now_us(), "pid": os.getpid()}
        if not resp.ok:
            out["error"] = resp.error
            out["detail"] = resp.detail
        writer.write(wire.encode_frame(out))
        await writer.drain()


def server_config(args) -> ServerConfig:
    """The ``ServerConfig`` the worker's options describe."""
    return ServerConfig(
        device=args.device,
        engine=args.engine,
        min_bucket_blocks=args.bucket_min,
        max_bucket_blocks=args.bucket_max,
        key_slots=args.key_slots,
        native_threads=args.native_threads,
        max_depth=args.queue_depth,
        tenant_depth_frac=args.tenant_depth_frac,
        low_priority_tenants=tuple(args.low_priority_tenant or ()),
        priority_depth_frac=args.priority_depth_frac,
        request_deadline_s=args.deadline,
        dispatch_deadline_s=args.dispatch_deadline,
        retries=args.retries,
        lanes=args.lanes,
        probe_every=args.probe_every,
        journal=args.journal,
        max_inflight=args.max_inflight,
        status_port=args.status_port,
        modes=tuple((args.modes or "ctr").split(",")),
        ceiling_gbps=args.ceiling_gbps,
        transfer_chunk_blocks=args.transfer_chunk_blocks,
        max_transfers=args.max_transfers,
        transfer_window=args.transfer_window,
        transfer_budget_bytes=args.transfer_budget_bytes,
        transfer_max_bytes=args.transfer_max_bytes,
        transfer_deadline_s=args.transfer_deadline,
        transfer_ledger=args.transfer_ledger,
        session_per_tenant=args.session_per_tenant,
        session_window_bytes=args.session_window_bytes,
        session_quantum_bytes=args.session_quantum_bytes,
        session_prefetch_slots=args.session_prefetch_slots,
        session_budget_bytes=args.session_budget_bytes)


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count in this process, by kernel name
    (the serve bench's table of wrappers)."""
    from .bench import MODE_KERNELS, OTHER_KERNELS
    return {name: int(fn.launches) for name, fn in {**MODE_KERNELS, **OTHER_KERNELS}.items()}


async def _amain(args) -> int:
    server = Server(server_config(args))
    await server.start()
    frontend = RequestFrontend(server, args.port, host=args.host)
    await frontend.start()
    ready = {"kind": "ot-serve-worker", "port": frontend.port,
             "status_port": server.status.port if server.status is not None else None,
             "engine": server.engine, "lanes": len(server.pool.lanes), "pid": os.getpid()}
    print(json.dumps(ready), flush=True)
    trace.point("worker-ready", port=frontend.port, engine=server.engine)

    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop_ev.set)
    await stop_ev.wait()

    # Admission closes first, so /healthz says "draining" for the whole
    # drain and a late submit answers `shutdown`.
    server.queue.close()
    await frontend.stop(grace_s=30.0)
    await server.stop()
    stats = server.stats()
    lost = stats["queue"]["lost"]
    line = {"kind": "ot-serve-worker-exit", "lost": lost,
            "answered": stats["queue"]["answered"], "accepted": stats["queue"]["accepted"],
            "batches": stats["batches"], "quarantines": stats["lanes"]["quarantine_events"],
            "recompiles": stats["compiles"]["steady"], "keycache": stats["keycache"],
            "frames": frontend.frames, "protocol_errors": frontend.protocol_errors,
            "transfers": stats["transfers"], "sessions": stats["sessions"],
            "diag_engine_calls": stats["lanes"]["engine_calls_by_mode"],
            "diag_launches": kernel_launches()}
    print(json.dumps(line), flush=True)
    trace.point("worker-drained", lost=lost, frames=frontend.frames)
    return 1 if lost else 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m our_tree_tpu_torch.serve.worker",
        description="one serve back-end process: a Server behind the framed TCP protocol")
    ap.add_argument("--port", type=int, default=0,
                    help="request port (0 = ephemeral; the bound port rides the READY line)")
    ap.add_argument("--host", default="127.0.0.1", help="bind address")
    ap.add_argument("--status-port", type=int, default=0, metavar="PORT",
                    help="/metrics + /healthz port (0 = ephemeral, on the READY line)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu (the plain version)")
    ap.add_argument("--engine", default="auto",
                    help="serve engine: auto (the kernels on a card, the native C tier on the "
                         "CPU), native (ctr in C on the host, the other modes on the device's "
                         "auto engine), or a registered engine (ttable: a gather path, not "
                         "constant time)")
    ap.add_argument("--modes", default="ctr", metavar="M1,M2",
                    help="served modes to enable and warm (ctr, gcm, gcm-open, cbc, rc4; "
                         "default ctr)")
    ap.add_argument("--lanes", type=int, default=None, metavar="N")
    ap.add_argument("--bucket-min", type=int, default=32, metavar="BLOCKS")
    ap.add_argument("--bucket-max", type=int, default=4096, metavar="BLOCKS")
    ap.add_argument("--key-slots", type=int, default=None, metavar="K")
    ap.add_argument("--native-threads", type=int, default=0, metavar="N",
                    help="native-tier ECB threads a slot run (0 = one per 256 KiB)")
    ap.add_argument("--queue-depth", type=int, default=1024)
    ap.add_argument("--tenant-depth-frac", type=float, default=1.0, metavar="FRAC")
    ap.add_argument("--low-priority-tenant", action="append", default=None, metavar="TENANT",
                    help="mark TENANT low priority (repeatable): its submits shed first under "
                         "depth pressure")
    ap.add_argument("--priority-depth-frac", type=float, default=0.5, metavar="FRAC",
                    help="queue-depth fraction past which low-priority requests shed")
    ap.add_argument("--deadline", type=float, default=30.0)
    ap.add_argument("--dispatch-deadline", type=float,
                    default=watchdog.default_deadline_s() or 10.0)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--probe-every", type=int, default=8, metavar="BATCHES")
    ap.add_argument("--max-inflight", type=int, default=None, metavar="N")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="serve journal: lane quarantines persist there (serve.bench "
                         "--unquarantine lane:<i> releases them)")
    ap.add_argument("--transfer-chunk-blocks", type=int, default=None, metavar="BLOCKS",
                    help="chunk size of oversized payloads (default the top rung; 0 refuses "
                         "them too-large)")
    ap.add_argument("--max-transfers", type=int, default=8, metavar="N",
                    help="concurrent transfers before new ones shed")
    ap.add_argument("--transfer-window", type=int, default=8, metavar="N",
                    help="chunks in flight a transfer")
    ap.add_argument("--transfer-budget-bytes", type=int, default=64 << 20, metavar="BYTES",
                    help="reassembly bytes past which new transfers shed")
    ap.add_argument("--transfer-max-bytes", type=int, default=1 << 30, metavar="BYTES",
                    help="a transfer's payload ceiling (a larger declared total answers "
                         "too-large)")
    ap.add_argument("--transfer-deadline", type=float, default=300.0, metavar="S",
                    help="a transfer's wall deadline")
    ap.add_argument("--transfer-ledger", default=None, metavar="PATH",
                    help="the acked-chunk ledger's journal (JSONL, fsync'd): resume tokens "
                         "outlive the process")
    ap.add_argument("--session-per-tenant", type=int, default=16, metavar="N",
                    help="open rc4 sessions a tenant before the store evicts its idle rows")
    ap.add_argument("--session-window-bytes", type=int, default=65536, metavar="BYTES",
                    help="keystream kept ahead of each session's consumed offset")
    ap.add_argument("--session-quantum-bytes", type=int, default=4096, metavar="BYTES",
                    help="PRGA bytes a session per refill dispatch (the fixed prefetch shape)")
    ap.add_argument("--session-prefetch-slots", type=int, default=8, metavar="S",
                    help="sessions stacked into one refill dispatch")
    ap.add_argument("--session-budget-bytes", type=int, default=8 << 20, metavar="BYTES",
                    help="keystream bytes held across sessions: at the cap new opens shed")
    ap.add_argument("--ceiling-gbps", type=float, default=None, metavar="GBPS",
                    help="the measured ceiling the cost model reports utilization against")
    args = ap.parse_args(argv)
    if args.key_slots is None:
        args.key_slots = batcher.DEFAULT_KEY_SLOTS
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    trace.ensure_run()
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    sys.exit(main())
