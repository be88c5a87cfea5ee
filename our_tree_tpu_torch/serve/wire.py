"""The serve wire protocol: framed requests over a byte stream.

Port of ``our_tree_tpu.serve.wire``, byte for byte the same framing. One
frame is one JSON header line (UTF-8, ``\\n``-terminated) followed by
``header["len"]`` raw payload bytes; the header carries the small typed
fields (tenant, hex key/nonce/IV/AAD/tag, mode, error codes), the payload
rides raw. Both directions have that shape:

request::

    {"t": "<tenant>", "k": "<key hex>", "n": "<nonce hex>",
     "len": <payload bytes>, "deadline_s": <float|null>,
     "sm": <bool|absent>, "ps": "<parent span id|absent>",
     "pr": <0|absent>, "m": "<mode|absent>", "iv": "<iv hex|absent>",
     "a": "<aad hex|absent>", "tg": "<tag hex|absent>"}\\n
    <len raw bytes>

response::

    {"ok": true, "len": <n>, "batch": "<label|null>", "tr": <epoch µs>,
     "ts": <epoch µs>, "pid": <int>, "tg": "<tag hex|absent>"}\\n<raw>
    {"ok": false, "len": 0, "error": "<code>", "detail": "..."}\\n

The codes are ``serve.queue``'s closed ``ERR_*`` set; ``m`` selects the mode
(``ctr`` when absent), ``iv`` the GCM or CBC IV, ``a`` the GCM AAD and
``tg`` the tag (to verify on ``gcm-open``, produced by ``gcm``). ``sm`` and
``ps`` carry an upstream sampling decision and span id, ``pr`` a
low-priority marker; ``tr``/``ts`` are the server's clock at receipt and at
reply. Frames with a ``tx`` field belong to the chunked-transfer
sub-protocol (``serve/worker.py``), frames with ``ss`` to the session
sub-protocol.

Bounded on both sides: a header line over ``MAX_HEADER`` bytes or a payload
over the caller's ``max_len`` is a protocol error, refused before any
allocation trusts the peer. Stdlib and asyncio only.
"""

from __future__ import annotations

import json

#: Header line ceiling: the typed fields fit well under 1 KiB.
MAX_HEADER = 4096

#: Default payload ceiling (bytes): the top default rung (4,096 blocks) is
#: 64 KiB, and one frame never needs more than a small multiple of it.
MAX_PAYLOAD = 1 << 22


class WireError(RuntimeError):
    """A malformed or oversized frame: the connection is not trustworthy
    past it."""


class FrameTooLarge(WireError):
    """A frame whose parseable header declares a payload over the max,
    refused before any allocation. The stream is still framed, so a front
    end can answer a typed ``too-large`` frame and, when the declared length
    can be drained (``skip_payload``), keep serving the connection."""

    def __init__(self, header: dict, declared: int, max_len: int):
        self.header = header
        self.declared = int(declared)
        self.max_len = int(max_len)
        super().__init__(f"frame payload {declared} bytes outside [0, {max_len}]")


async def skip_payload(reader, n: int, chunk: int = 1 << 16) -> bool:
    """Drain ``n`` declared payload bytes in bounded slices (never one
    ``n``-sized allocation). True when the stream is back at a frame
    boundary; False on EOF."""
    left = int(n)
    while left > 0:
        piece = await reader.read(min(left, chunk))
        if not piece:
            return False
        left -= len(piece)
    return True


def encode_frame(header: dict, payload: bytes = b"") -> bytes:
    """One frame as bytes; ``len`` is stamped from the payload."""
    h = dict(header)
    h["len"] = len(payload)
    return json.dumps(h, separators=(",", ":")).encode("utf-8") + b"\n" + payload


async def read_frame(reader, max_len: int = MAX_PAYLOAD):
    """(header dict, payload bytes) from an asyncio StreamReader, or None on
    a clean EOF at a frame boundary. Raises ``WireError`` on a torn,
    oversized or unparseable frame (``FrameTooLarge`` when only the declared
    length is out of bounds)."""
    try:
        line = await reader.readuntil(b"\n")
    except EOFError:
        return None
    except Exception as e:  # IncompleteReadError (EOF mid-line), overflow
        # An empty partial is a clean close between frames.
        partial = getattr(e, "partial", None)
        if partial == b"":
            return None
        raise WireError(f"torn frame header: {type(e).__name__}") from e
    if len(line) > MAX_HEADER:
        raise WireError(f"header line {len(line)} bytes > {MAX_HEADER}")
    try:
        header = json.loads(line)
    except ValueError as e:
        raise WireError(f"unparseable frame header: {e}") from e
    if not isinstance(header, dict):
        raise WireError("frame header is not a JSON object")
    try:
        n = int(header.get("len", 0))
    except (TypeError, ValueError) as e:
        raise WireError("frame len is not an integer") from e
    if n < 0 or n > max_len:
        # The declared length is the peer's input: checked before any
        # allocation.
        raise FrameTooLarge(header, n, max_len)
    payload = b""
    if n:
        try:
            payload = await reader.readexactly(n)
        except Exception as e:
            raise WireError("torn frame payload") from e
    return header, payload
