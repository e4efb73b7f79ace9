"""Transport shim: wire framing + the executor-transport registry
(port of ``repro.core.transport``).

The plan/executor split keeps the planner ignorant of HOW bytes move;
this module is the one place that knowledge lives for the real
multi-process backend (``repro_torch.checkpoint.mp_exec``). It owns

* the **wire framing** of the inter-node slow hop: length-prefixed
  frames over localhost TCP sockets, so every slow-hop message pays
  real serialization + kernel round trips and the frame sizes ARE the
  measured slow-hop byte counts (``IOTimings.slow_hop_slow_bytes`` on
  the mp backend is a sum of ``len(frame)`` values, not a model);
* the **transport registry**: the legal values of the
  ``IOConfig.transport`` knob, resolved by the planner pass
  ``core.passes.resolve_transport`` into ``IOPlan.transport``.

Frame layout (all integers big-endian):

``[u32 length][body]`` where ``body`` starts with a 28-byte header
``(kind, sender, g, round, n_req, raw_len, enc_len)`` (:data:`HDR`).

* ``KIND_BLOCK`` — one sender's (domain g, round r) write block: the
  header, then ``n_req`` interleaved ``(offset, length)`` int64 pairs
  (the request metadata that the alpha-beta model charges at
  ``PAIR_BYTES`` per request moves for real here), then ``enc_len``
  payload bytes (codec-encoded when the plan has a slow-hop codec —
  encode once, on the wire).
* ``KIND_COMBINED`` — a node-combined frame (the TAM path): one header
  per (g, round, sender NODE) with ``n_req`` reused as the subrecord
  count, then per co-located sender a 16-byte :data:`SUB` subheader
  ``(sender, n_req, raw_len, enc_len)`` + its pairs + payload. Flat
  two-phase pays a full frame per sender; the combined frame pays one
  frame plus 16 bytes per extra sender — the message-count collapse of
  intra-node aggregation, measurable on the wire.
* ``KIND_WINDOW`` — read direction: one cb window shipped from the
  serving side; ``sender`` is the destination rank, ``enc_len != 0``
  with ``enc_len != raw_len`` or the ``FLAG_ENCODED`` bit in ``kind``'s
  high byte marks a codec-encoded window the receiver must decode.

Adding a transport: implement ``execute_write``/``execute_read`` with
the :mod:`repro_torch.checkpoint.host_exec` signatures (byte-identical
output is the contract — tests/test_torch_transport.py holds every
backend to the host executor), register its name in :data:`TRANSPORTS`,
and dispatch on ``plan.transport`` in ``checkpoint.host_io``.

The frames are byte-identical to the reference's, so the two packages'
executors speak one wire format. Frames are host bytes: the workers of
the mp executor touch no device memory.
"""
from __future__ import annotations

import socket
import struct

import numpy as np

# ---- registry --------------------------------------------------------

#: legal non-None values of the ``transport`` knob. ``None`` means the
#: in-process executor pair (SPMD or host) — no real transport.
TRANSPORTS: tuple[str, ...] = ("mp",)


def resolve_transport(name):
    """Validate a requested transport name (the planner-pass hook).

    ``None`` (in-process executors) passes through; anything else must
    be registered in :data:`TRANSPORTS`.
    """
    if name is not None and name not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {name!r}; known: {(None,) + TRANSPORTS}")
    return name


# ---- wire framing ----------------------------------------------------

KIND_BLOCK = 1      # one sender's (g, round) block        (write, flat)
KIND_COMBINED = 2   # node-combined blocks for (g, round)  (write, TAM)
KIND_WINDOW = 3     # one cb window                        (read)

FLAG_ENCODED = 1 << 8   # OR'd into kind: payload is codec-encoded

#: per-frame header: (kind, sender, g, round, n_req, raw_len, enc_len)
HDR = struct.Struct("!IIIIIII")
#: per-subrecord header inside KIND_COMBINED:
#: (sender, n_req, raw_len, enc_len)
SUB = struct.Struct("!IIII")
_LEN = struct.Struct("!I")

#: bytes of frame overhead a flat slow block pays (length prefix +
#: header) and a combined subrecord pays; combined saves
#: ``(FRAME_OVERHEAD - SUB_OVERHEAD)`` per co-located sender beyond the
#: frame's first.
FRAME_OVERHEAD = _LEN.size + HDR.size
SUB_OVERHEAD = SUB.size


def pack_pairs(po: np.ndarray, pl: np.ndarray) -> bytes:
    """Interleave (offset, length) request metadata as big-endian i64."""
    meta = np.empty(2 * int(po.size), dtype=">i8")
    meta[0::2] = po
    meta[1::2] = pl
    return meta.tobytes()


def unpack_pairs(buf: bytes, n_req: int) -> tuple[np.ndarray, np.ndarray]:
    meta = np.frombuffer(buf, dtype=">i8", count=2 * n_req)
    return meta[0::2].astype(np.int64), meta[1::2].astype(np.int64)


def pack_block(kind: int, sender: int, g: int, rnd: int,
               po: np.ndarray, pl: np.ndarray, payload,
               raw_len: int) -> bytes:
    """One KIND_BLOCK / KIND_WINDOW body (header + pairs + payload)."""
    payload = bytes(payload)
    return (HDR.pack(kind, sender, g, rnd, int(po.size), int(raw_len),
                     len(payload))
            + pack_pairs(po, pl) + payload)


def unpack_block(body: bytes):
    """Inverse of :func:`pack_block`; returns
    ``(kind, sender, g, rnd, po, pl, payload, raw_len)``."""
    kind, sender, g, rnd, n_req, raw_len, enc_len = \
        HDR.unpack_from(body, 0)
    pos = HDR.size
    po, pl = unpack_pairs(body[pos:pos + 16 * n_req], n_req)
    pos += 16 * n_req
    return kind, sender, g, rnd, po, pl, body[pos:pos + enc_len], raw_len


def send_msg(sock: socket.socket, body: bytes) -> int:
    """Send one length-prefixed frame; returns the wire bytes moved
    (prefix included) — the unit the mp backend's slow-hop byte
    accounting sums."""
    sock.sendall(_LEN.pack(len(body)) + body)
    return _LEN.size + len(body)


def recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly n bytes; None on a clean EOF at a frame boundary."""
    chunks: list[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise ConnectionError(
                f"socket EOF mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> bytes | None:
    """Receive one frame body (None on orderly EOF between frames)."""
    raw = recv_exact(sock, _LEN.size)
    if raw is None:
        return None
    (n,) = _LEN.unpack(raw)
    body = recv_exact(sock, n)
    if body is None:
        raise ConnectionError("socket EOF after frame length prefix")
    return body
