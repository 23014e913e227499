"""Length-prefixed socket framing — THE wire idiom, defined once.

Every in-house socket protocol (the pserver taskqueue RPC in
`native/pserver.py`, the trainer-side shard client in
`parallel/pserver_client.py`, and the serving fleet's replica
transport in `serve/transport.py`) frames messages the same way: a
4-byte little-endian length prefix followed by the payload. This
module is the single definition of that framing, hardened on both
ends:

- **Bounded before allocation.** `recv_frame` rejects a length prefix
  over `max_frame` BEFORE allocating anything — a corrupted header (or
  hostile bytes: garbage on the port parses as a length up to ~4 GiB)
  costs a closed connection, never an OOM-sized allocation.
- **Short-read/EINTR safe.** Kernels hand back partial reads at any
  byte boundary and a signal (SIGCHLD from the fleet's reaped
  children, a profiler's SIGPROF) can interrupt `recv` with EINTR.
  `recv_full` loops until the exact byte count arrives, retrying
  EINTR; Python 3.5+ retries EINTR internally (PEP 475) UNLESS a
  signal handler raises or the socket has a timeout on some
  platforms, so the explicit retry keeps the framing correct under
  both.
- **Oversized sends refused.** `send_frame` refuses a payload the
  peer's `recv_frame` is guaranteed to reject — the error surfaces at
  the sender, where the stack trace names the oversized object.

A frame boundary failure anywhere raises `ConnectionError`: the
stream is desynced and the only safe recovery is a fresh socket
(which is exactly what every client here does — see
`parallel.pserver_client.ShardConn.call`).

**Multi-part frames.** `send_frames`/`recv_frames` extend the idiom
for zero-copy payloads (pickle protocol-5 out-of-band buffers, arena
tickets + raw pages): one logical message carried as N parts, each a
separate buffer, written with `sendall(memoryview)` so large parts
never concatenate sender-side. The wire stays backward compatible —
a multi-part frame leads with the sentinel length `0xFFFFFFFF`
(invalid as a legacy length: it exceeds the 1 GiB cap), so a legacy
`recv_frame` peer rejects it cleanly and `recv_frames` transparently
accepts BOTH encodings, returning a single-part list for legacy
frames. The cap is enforced across the SUM of all parts before any
payload allocation, same as the single-frame path.

Host-side only: no jax, no numpy — importable from any layer.
"""

from __future__ import annotations

import errno
import socket
import struct

__all__ = ["MAX_FRAME", "MAX_PARTS", "recv_frame", "recv_frames",
           "recv_full", "send_frame", "send_frames"]

#: Default frame cap. Row traffic and fleet RPCs move in small bounded
#: chunks, but pserver SYNC / resync frames carry a whole shard's
#: state — size shards below this (1 GiB ≈ 4M rows × 64 f32 dims);
#: anything larger is a protocol error, not a workload.
MAX_FRAME = 1 << 30

#: Part-count bound for multi-part frames: a corrupted count must not
#: drive an unbounded header read (65536 × 8-byte sizes = 512 KiB max
#: header, and no real payload approaches it — the KV export is a few
#: hundred parts at most).
MAX_PARTS = 1 << 16

#: Sentinel length prefix marking a multi-part frame. Chosen ABOVE
#: any legal legacy length (> MAX_FRAME), so legacy receivers reject
#: it as oversized instead of misparsing the stream.
_MULTI_SENTINEL = 0xFFFFFFFF


def send_frame(sock: socket.socket, payload: bytes, *,
               max_frame: int = MAX_FRAME) -> None:
    """Write one length-prefixed frame. Refuses oversized payloads at
    the sender (the receiver would reject them anyway — failing here
    names the object that grew past the protocol bound)."""
    n = len(payload)
    if n > max_frame:
        raise ValueError(
            f"refusing to send a {n}-byte frame over the "
            f"{max_frame}-byte cap")
    sock.sendall(struct.pack("<I", n) + payload)


def recv_frame(sock: socket.socket, *,
               max_frame: int = MAX_FRAME) -> bytes:
    """Read one frame. The length prefix is validated BEFORE any
    payload allocation: garbage bytes on the socket decode as an
    arbitrary 32-bit length, and honoring it would let one corrupt
    header allocate gigabytes."""
    hdr = recv_full(sock, 4)
    (n,) = struct.unpack("<I", hdr)
    if n > max_frame:
        raise ConnectionError(f"frame of {n} bytes exceeds the "
                              f"{max_frame}-byte cap")
    return recv_full(sock, n)


def send_frames(sock: socket.socket, parts, *,
                max_frame: int = MAX_FRAME) -> None:
    """Write one MULTI-PART frame: sentinel, part count, per-part
    sizes, then each part's bytes via `sendall(memoryview)` — no
    sender-side concatenation, so a multi-megabyte KV page buffer
    crosses the socket without an extra copy. The cap applies to the
    sum of all parts, refused before any byte moves."""
    views = [memoryview(p).cast("B") for p in parts]
    if len(views) > MAX_PARTS:
        raise ValueError(f"refusing to send {len(views)} parts over "
                         f"the {MAX_PARTS}-part cap")
    total = sum(v.nbytes for v in views)
    if total > max_frame:
        raise ValueError(
            f"refusing to send a {total}-byte multi-part frame over "
            f"the {max_frame}-byte cap")
    hdr = struct.pack("<II", _MULTI_SENTINEL, len(views))
    hdr += struct.pack(f"<{len(views)}Q", *(v.nbytes for v in views))
    sock.sendall(hdr)
    for v in views:
        if v.nbytes:
            sock.sendall(v)


def recv_frames(sock: socket.socket, *,
                max_frame: int = MAX_FRAME) -> list:
    """Read one frame of EITHER encoding, as a list of parts: a
    legacy single frame arrives as a one-element list, a multi-part
    frame as its parts in order. The cap is enforced across the sum
    of the advertised part sizes BEFORE any payload allocation — a
    corrupted multi-part header costs a closed connection, exactly
    like the single-frame path."""
    hdr = recv_full(sock, 4)
    (n,) = struct.unpack("<I", hdr)
    if n != _MULTI_SENTINEL:
        if n > max_frame:
            raise ConnectionError(f"frame of {n} bytes exceeds the "
                                  f"{max_frame}-byte cap")
        return [recv_full(sock, n)]
    (count,) = struct.unpack("<I", recv_full(sock, 4))
    if count > MAX_PARTS:
        raise ConnectionError(f"multi-part frame advertises {count} "
                              f"parts over the {MAX_PARTS}-part cap")
    sizes = struct.unpack(f"<{count}Q", recv_full(sock, 8 * count))
    if sum(sizes) > max_frame:
        raise ConnectionError(
            f"multi-part frame of {sum(sizes)} bytes exceeds the "
            f"{max_frame}-byte cap")
    return [recv_full(sock, s) for s in sizes]


def recv_full(sock: socket.socket, n: int) -> bytes:
    """Read exactly `n` bytes: short reads loop, EINTR retries, and a
    peer close mid-frame raises `ConnectionError` (a truncated frame
    is a dead stream, not a short message)."""
    chunks = []
    got = 0
    while got < n:
        try:
            b = sock.recv(n - got)
        except InterruptedError:
            continue                    # EINTR: retry the same read
        except OSError as e:
            if e.errno == errno.EINTR:
                continue
            raise
        if not b:
            raise ConnectionError(
                "peer closed mid-frame" if chunks else "peer closed")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)
