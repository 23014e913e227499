"""Shared-memory KV arena: the zero-copy data plane for migrations.

A prefill->decode KV migration used to pickle the whole payload
through the replica socket (`transport._op_export_request`): two
serializations and four copies for megabytes of page data, per
migration. This module splits control from data the way the pserver
heritage did with raw tensor sockets — the control frame stays a
small tag-idempotent pickle RPC, while the page BYTES move through a
`multiprocessing.shared_memory` arena both replica processes map:

- **Layout.** One shared segment pool: an 8-byte-word header
  (magic, version, seg_size, n_segs), then one 5-word ledger record
  per segment (state, owner_pid, ticket tag, bytes filled, adopter
  pid), then the segment data itself. The ledger lives ON the arena —
  crash-safety demands the ownership facts survive any process.
- **Free-list allocator.** `scatter()` claims FREE segments under a
  cross-process `flock` (kernel-released on owner death, so a crash
  mid-allocation can never wedge the allocator), writes the payload
  bytes across them, and returns a picklable *ticket* (tag + segment
  ids + part sizes) — the only thing the control frame carries.
- **Ownership states.** FREE -> SCATTER (source claimed, writing) ->
  INFLIGHT (source finished, offered) -> ADOPTED (destination read
  it). The SOURCE owns the segments through all three live states and
  frees them only on the router's ACK (`handoff_complete` /
  `cancel_handoff`) — the exact pins-release-on-ACK contract of
  `PagePool.export_blocks`, extended across process memory. A
  destination dying mid-adopt therefore costs nothing: the segments
  are still whole and the next destination gathers the same ticket.
- **Orphan reclamation.** Shared memory has no kernel-mediated
  cleanup: a SIGKILL mid-transfer leaves segments in SCATTER or
  INFLIGHT with a dead owner pid. `reclaim_orphans()` (driven by the
  fleet supervisor's sweep and the chaos harness) frees every
  non-FREE segment whose owner pid no longer exists. `gather()`
  re-validates tag + state per segment, so a ticket whose segments
  were reclaimed (and possibly reallocated) is detected as stale
  instead of delivering another request's bytes — the exactly-once
  story never depends on the orphan sweep's timing.
- **Leak checks.** `reconcile(expected_tags)` asserts the on-arena
  ledger matches the callers' ledgers exactly: every expected ticket
  live, nothing else live. The chaos suite calls it after every kill.

Graceful degrade is the caller's half of the contract: any
`ArenaError` out of `scatter()` (no /dev/shm, size cap, version
mismatch) sends the payload down the legacy pickle path with a
`data_plane_fallbacks` counter + flight event — never a wrong answer
(`ServingServer.export_request`).

Host-side only — numpy for the ledger view, no jax. The fault seam
(`fault_hook`) mirrors `PagePool.fault_hook`: `testing.faults` wires
SIGKILL/error injection through it (`FaultPlan.wrap_arena`).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

try:                            # linux/mac; the arena degrades to
    import fcntl                # unavailable where flock is missing
except ImportError:             # pragma: no cover
    fcntl = None

__all__ = ["ArenaError", "ArenaFull", "ArenaUnavailable", "ShmArena",
           "attach_cached"]


class ArenaError(RuntimeError):
    """Any data-plane failure the control plane must degrade around
    (the pickle fallback path) — never a wrong answer."""


class ArenaUnavailable(ArenaError):
    """The arena cannot be created/attached here: no shared-memory
    filesystem, the named arena is gone, or a version mismatch."""


class ArenaFull(ArenaError):
    """Not enough FREE segments for this payload (the size cap):
    transient — the caller falls back to the inline path."""


#: per-process ticket-tag counter (module level so every arena handle
#: in one process mints from the same sequence)
_TAG_COUNTER = itertools.count(1)

#: attach-by-name cache: one mapped handle per arena per process
_ATTACHED: Dict[str, "ShmArena"] = {}


def _pid_alive(pid: int) -> bool:
    """Liveness of a segment owner. Signal 0 probes without
    delivering; EPERM means it exists under another uid (alive)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:     # pragma: no cover
        return True
    return True


def attach_cached(name: str) -> "ShmArena":
    """Attach (once per process) to an existing arena by name — the
    destination-side entry point: `import_request` resolves the
    ticket's arena lazily, so a decode replica needs no pre-wiring."""
    arena = _ATTACHED.get(name)
    if arena is None:
        arena = ShmArena(name, create=False)
        _ATTACHED[name] = arena
    return arena


class ShmArena:
    """A crash-safe shared-memory segment pool (module docstring)."""

    MAGIC = 0x41444150          # "PADA"
    VERSION = 1

    FREE, SCATTER, INFLIGHT, ADOPTED = 0, 1, 2, 3

    _HDR = 4                    # header words (u64)
    _REC = 5                    # ledger words per segment (u64)
    # record word offsets
    _ST, _OWNER, _TAG, _NBYTES, _ADOPTER = range(5)

    def __init__(self, name: Optional[str] = None, *,
                 seg_size: int = 256 * 1024, n_segs: int = 64,
                 create: bool = True):
        self.fault_hook: Optional[Callable[[str, dict], None]] = None
        self._lock = threading.Lock()
        self._closed = False
        # local monotone counters (per-process; safe to sum fleetwide)
        self.scatters = 0
        self.adoptions = 0
        self.frees = 0
        self.reclaimed = 0
        self.bytes_scattered = 0
        self.bytes_gathered = 0
        self.bytes_gather_copied = 0
        if create:
            if name is None:
                name = f"pt-arena-{os.getpid()}-{os.urandom(4).hex()}"
            if seg_size < 1 or n_segs < 1:
                raise ValueError(
                    f"need seg_size >= 1 and n_segs >= 1, got "
                    f"{seg_size}/{n_segs}")
            size = 8 * (self._HDR + self._REC * n_segs) \
                + seg_size * n_segs
            try:
                self._shm = shared_memory.SharedMemory(
                    name=name, create=True, size=size)
            except OSError as e:
                raise ArenaUnavailable(
                    f"cannot create shared-memory arena {name!r}: "
                    f"{e}") from e
            self.seg_size, self.n_segs = int(seg_size), int(n_segs)
            self._led = np.ndarray(
                (self._HDR + self._REC * n_segs,), dtype=np.uint64,
                buffer=self._shm.buf)
            self._led[:] = 0
            self._led[0] = self.MAGIC
            self._led[1] = self.VERSION
            self._led[2] = self.seg_size
            self._led[3] = self.n_segs
        else:
            try:
                self._shm = shared_memory.SharedMemory(name=name)
            except (OSError, ValueError) as e:
                raise ArenaUnavailable(
                    f"cannot attach arena {name!r}: {e}") from e
            # the resource tracker would unlink the arena when THIS
            # process exits — only the creator owns the name
            self._untrack()
            hdr = np.ndarray((self._HDR,), dtype=np.uint64,
                             buffer=self._shm.buf)
            if int(hdr[0]) != self.MAGIC or int(hdr[1]) != self.VERSION:
                magic, ver = int(hdr[0]), int(hdr[1])
                del hdr
                self._close_shm_quietly()
                raise ArenaUnavailable(
                    f"arena {name!r} version mismatch: magic="
                    f"{magic:#x} version={ver} (want "
                    f"{self.MAGIC:#x}/{self.VERSION})")
            self.seg_size, self.n_segs = int(hdr[2]), int(hdr[3])
            self._led = np.ndarray(
                (self._HDR + self._REC * self.n_segs,),
                dtype=np.uint64, buffer=self._shm.buf)
        self.name = self._shm.name
        self._data_off = 8 * (self._HDR + self._REC * self.n_segs)
        # cross-process allocator lock: flock releases on owner death,
        # so a crash inside the critical section never wedges anyone
        self._lockpath = os.path.join(
            tempfile.gettempdir(), f"{self.name}.lock")
        self._lockfd = os.open(self._lockpath,
                               os.O_CREAT | os.O_RDWR, 0o600)

    def _close_shm_quietly(self) -> None:
        """Unmap, tolerating live exports: a zero-copy gather view
        still alive somewhere keeps the mapping until the process
        exits (the kernel drops it then). The SharedMemory object's
        own `__del__` would retry close() and raise the same
        BufferError unraisably at GC — neuter it."""
        try:
            self._shm.close()
        except BufferError:
            self._shm.close = lambda: None

    def _untrack(self) -> None:
        try:                    # pragma: no cover - platform detail
            from multiprocessing import resource_tracker
            resource_tracker.unregister(self._shm._name,
                                        "shared_memory")
        except Exception:
            pass

    # -- ledger plumbing ---------------------------------------------------

    def _rec(self, seg: int, word: int) -> int:
        return int(self._led[self._HDR + self._REC * seg + word])

    def _set(self, seg: int, word: int, value: int) -> None:
        self._led[self._HDR + self._REC * seg + word] = value

    def _zero(self, seg: int) -> None:
        base = self._HDR + self._REC * seg
        self._led[base:base + self._REC] = 0

    @contextlib.contextmanager
    def _alloc_lock(self):
        with self._lock:
            if fcntl is not None:
                fcntl.flock(self._lockfd, fcntl.LOCK_EX)
            try:
                yield
            finally:
                if fcntl is not None:
                    fcntl.flock(self._lockfd, fcntl.LOCK_UN)

    def _hook(self, event: str, ctx: dict) -> None:
        if self.fault_hook is not None:
            self.fault_hook(event, ctx)

    def _check_ticket(self, ticket: dict) -> List[int]:
        """Validate a ticket against the LIVE ledger: every segment
        must still carry this ticket's tag in a live state. A
        reclaimed (and possibly reallocated) segment fails here —
        stale data is an error, never a delivery."""
        tag, segs = int(ticket["tag"]), list(ticket["segs"])
        for s in segs:
            if not (0 <= s < self.n_segs):
                raise ArenaError(
                    f"ticket names segment {s} outside the arena "
                    f"({self.n_segs} segments)")
            st = self._rec(s, self._ST)
            if st == self.FREE or self._rec(s, self._TAG) != tag:
                raise ArenaError(
                    f"stale ticket tag={tag}: segment {s} is "
                    f"{'free' if st == self.FREE else 'reowned'} "
                    f"(owner died and was reclaimed?)")
        return segs

    # -- data path ---------------------------------------------------------

    def scatter(self, parts: Sequence) -> dict:
        """Write `parts` (contiguous buffers) into freshly claimed
        segments and return the picklable ticket the control frame
        carries. Segments go FREE -> SCATTER (claimed, under the
        allocator lock) -> INFLIGHT (all bytes written); the fault
        hook fires per segment written, so a SIGKILL mid-scatter
        leaves observable SCATTER-state orphans."""
        if self._closed:
            raise ArenaUnavailable("arena is closed")
        self._hook("scatter_begin", {"parts": len(parts)})
        views = [memoryview(p).cast("B") for p in parts]
        sizes = [v.nbytes for v in views]
        total = sum(sizes)
        need = max(1, -(-total // self.seg_size))
        tag = (os.getpid() << 24) | (next(_TAG_COUNTER) & 0xFFFFFF)
        pid = os.getpid()
        with self._alloc_lock():
            segs: List[int] = []
            for s in range(self.n_segs):
                if self._rec(s, self._ST) == self.FREE:
                    segs.append(s)
                    if len(segs) == need:
                        break
            if len(segs) < need:
                raise ArenaFull(
                    f"payload of {total} bytes needs {need} segments "
                    f"({self.seg_size}B each), only {len(segs)} free")
            for s in segs:
                self._set(s, self._ST, self.SCATTER)
                self._set(s, self._OWNER, pid)
                self._set(s, self._TAG, tag)
                self._set(s, self._NBYTES, 0)
                self._set(s, self._ADOPTER, 0)
        # the segments are ours now: bytes move OUTSIDE the lock
        buf = self._shm.buf
        seg_i, seg_off = 0, 0
        for v in views:
            off = 0
            while off < v.nbytes:
                take = min(self.seg_size - seg_off, v.nbytes - off)
                at = (self._data_off + segs[seg_i] * self.seg_size
                      + seg_off)
                buf[at:at + take] = v[off:off + take]
                off += take
                seg_off += take
                if seg_off == self.seg_size:
                    self._set(segs[seg_i], self._NBYTES, seg_off)
                    self._hook("scatter", {"tag": tag,
                                           "seg": segs[seg_i],
                                           "index": seg_i,
                                           "of": len(segs)})
                    seg_i += 1
                    seg_off = 0
        if seg_off or total == 0:
            self._set(segs[seg_i], self._NBYTES, seg_off)
            self._hook("scatter", {"tag": tag, "seg": segs[seg_i],
                                   "index": seg_i, "of": len(segs)})
        for s in segs:
            self._set(s, self._ST, self.INFLIGHT)
        self.scatters += 1
        self.bytes_scattered += total
        return {"arena": self.name, "tag": tag, "segs": list(segs),
                "sizes": list(sizes), "nbytes": total}

    def gather(self, ticket: dict) -> List[memoryview]:
        """Read a ticket's parts back. A part that lies inside one
        segment returns a zero-copy view of the arena; only parts
        spanning a segment boundary are assembled (counted in
        `bytes_gather_copied`). Validates tag + state per segment
        first — a reclaimed ticket raises instead of aliasing."""
        segs = self._check_ticket(ticket)
        out: List[memoryview] = []
        pos = 0
        for size in ticket["sizes"]:
            out.append(self._read(segs, pos, size))
            pos += size
        self.bytes_gathered += pos
        return out

    def _read(self, segs: List[int], pos: int,
              size: int) -> memoryview:
        i, off = divmod(pos, self.seg_size)
        if off + size <= self.seg_size:
            at = self._data_off + segs[i] * self.seg_size + off
            return self._shm.buf[at:at + size]
        assembled = bytearray(size)
        got = 0
        while got < size:
            take = min(self.seg_size - off, size - got)
            at = self._data_off + segs[i] * self.seg_size + off
            assembled[got:got + take] = self._shm.buf[at:at + take]
            got += take
            i += 1
            off = 0
        self.bytes_gather_copied += size
        return memoryview(assembled)

    def adopt(self, ticket: dict) -> None:
        """Destination stamp: mark the ticket's segments ADOPTED with
        this pid. Pure bookkeeping — the SOURCE still owns the
        segments and frees them on ACK; the stamp is what the orphan
        sweep and reconcile read to tell 'died before anyone read it'
        from 'died after delivery'. The fault hook fires per segment
        BEFORE its stamp (kill mid-adopt leaves a mixed ledger the
        reclaim path must handle)."""
        segs = self._check_ticket(ticket)
        pid = os.getpid()
        for s in segs:
            self._hook("adopt", {"tag": int(ticket["tag"]), "seg": s})
            self._set(s, self._ADOPTER, pid)
            self._set(s, self._ST, self.ADOPTED)
        self.adoptions += 1

    def free(self, ticket: dict) -> int:
        """Release a ticket's segments back to FREE (the ACK/abandon
        path). Idempotent: segments already freed — or reclaimed and
        reallocated under a different tag — are skipped, so an ACK
        replay releases nothing twice. Returns segments freed."""
        tag = int(ticket["tag"])
        n = 0
        with self._alloc_lock():
            for s in ticket["segs"]:
                if (0 <= s < self.n_segs
                        and self._rec(s, self._ST) != self.FREE
                        and self._rec(s, self._TAG) == tag):
                    self._zero(s)
                    n += 1
        if n:
            self.frees += 1
        return n

    # -- robustness surface ------------------------------------------------

    def reclaim_orphans(self) -> int:
        """Free every non-FREE segment whose owner pid is dead — the
        sweep the FaultPlan/SIGKILL machinery leans on. Safe against
        live traffic: a live owner's segments are never touched, and
        `gather`'s tag check catches any ticket whose segments this
        sweep already recycled."""
        n = 0
        with self._alloc_lock():
            for s in range(self.n_segs):
                if (self._rec(s, self._ST) != self.FREE
                        and not _pid_alive(self._rec(s, self._OWNER))):
                    self._zero(s)
                    n += 1
        self.reclaimed += n
        return n

    def segments_live(self) -> int:
        return sum(1 for s in range(self.n_segs)
                   if self._rec(s, self._ST) != self.FREE)

    def live_tags(self, owner_pid: Optional[int] = None) -> set:
        """Tags with at least one live segment (optionally filtered
        to one owner) — the cross-ledger join `reconcile` uses."""
        tags = set()
        for s in range(self.n_segs):
            if self._rec(s, self._ST) == self.FREE:
                continue
            if (owner_pid is not None
                    and self._rec(s, self._OWNER) != owner_pid):
                continue
            tags.add(self._rec(s, self._TAG))
        return tags

    def counters(self) -> Dict[str, int]:
        live = leaked = 0
        for s in range(self.n_segs):
            if self._rec(s, self._ST) == self.FREE:
                continue
            live += 1
            if not _pid_alive(self._rec(s, self._OWNER)):
                leaked += 1
        return {
            "arena_segments_live": live,
            "arena_segments_leaked": leaked,
            "arena_segments_reclaimed": self.reclaimed,
            "arena_scatters": self.scatters,
            "arena_adoptions": self.adoptions,
            "arena_frees": self.frees,
            "arena_bytes_scattered": self.bytes_scattered,
            "arena_bytes_gathered": self.bytes_gathered,
            "arena_bytes_gather_copied": self.bytes_gather_copied,
        }

    def bind_metrics(self, registry, *, prefix: str = "data") -> None:
        """Attach to an `obs.MetricsRegistry` as a read-through
        source — exported gauges and `reconcile()` read the SAME
        on-arena ledger."""
        registry.register_source(prefix, self.counters)

    def reconcile(self, expected_tags: Sequence[int] = ()) -> None:
        """Assert the arena's books against the callers' ledgers: the
        set of live ticket tags equals `expected_tags` exactly — no
        leaked segment (a kill that slipped every release path), no
        phantom expectation (a ledger entry whose segments vanished).
        The chaos harness calls this after every burst/kill."""
        exp = {int(t) for t in expected_tags}
        live: Dict[int, List[int]] = {}
        for s in range(self.n_segs):
            st = self._rec(s, self._ST)
            if st == self.FREE:
                continue
            assert st in (self.SCATTER, self.INFLIGHT,
                          self.ADOPTED), (s, st)
            assert self._rec(s, self._NBYTES) <= self.seg_size, s
            live.setdefault(self._rec(s, self._TAG), []).append(s)
        leaked = set(live) - exp
        assert not leaked, (
            f"arena leak: {sum(len(live[t]) for t in leaked)} "
            f"segment(s) under unexpected ticket tags {sorted(leaked)}")
        missing = exp - set(live)
        assert not missing, (
            f"arena lost live tickets {sorted(missing)} (reclaimed "
            f"under a live owner?)")

    # -- lifecycle ---------------------------------------------------------

    def close(self, *, destroy: bool = False) -> None:
        """Unmap (and with `destroy`, unlink) the arena. Destroy is
        the creator's job at fleet shutdown; attachers just close."""
        if self._closed:
            return
        self._closed = True
        self._led = None
        _ATTACHED.pop(self.name, None)
        self._close_shm_quietly()
        try:
            os.close(self._lockfd)
        except OSError:         # pragma: no cover
            pass
        if destroy:
            try:
                self._shm.unlink()
            except FileNotFoundError:   # pragma: no cover
                pass
            try:
                os.unlink(self._lockpath)
            except OSError:             # pragma: no cover
                pass
