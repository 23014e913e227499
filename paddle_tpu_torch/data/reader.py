"""Reader composition combinators.

Full parity with the reference's v2 reader contract and decorators
(reference: python/paddle/v2/reader/decorator.py:15 — map_readers,
buffered, compose, chain, shuffle, firstn, xmap_readers): a *reader* is a
zero-arg callable returning an iterator over samples. These are host-side
(pure Python) by design — the device never sees Python iterators; batches
are assembled and shipped by data.feeder.
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import random as random_mod
import threading
from typing import Any, Callable, Iterable, Iterator, List

Reader = Callable[[], Iterator[Any]]


def map_readers(func: Callable, *readers: Reader) -> Reader:
    """Apply func to the zipped output of several readers."""

    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return reader


def shuffle(reader: Reader, buf_size: int, seed=None) -> Reader:
    """Shuffle within a sliding buffer (reference: decorator.py shuffle)."""

    def new_reader():
        rng = random_mod.Random(seed)
        buf: List[Any] = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            rng.shuffle(buf)
            for b in buf:
                yield b

    return new_reader


def chain(*readers: Reader) -> Reader:
    """Concatenate readers end-to-end (reference: decorator.py chain_readers)."""

    def reader():
        for r in readers:
            for item in r():
                yield item

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers: Reader, check_alignment: bool = True) -> Reader:
    """Zip readers into tuple samples (reference: decorator.py compose)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        its = [r() for r in readers]
        for items in itertools.zip_longest(*its, fillvalue=_SENTINEL):
            if check_alignment and any(i is _SENTINEL for i in items):
                raise ComposeNotAligned("readers have different lengths")
            yield sum((make_tuple(i) for i in items if i is not _SENTINEL), ())

    return reader


_SENTINEL = object()


def buffered(reader: Reader, size: int) -> Reader:
    """Prefetch into a bounded queue on a worker thread — the DoubleBuffer
    equivalent (reference: decorator.py buffered; DataProvider.h:249)."""

    class _End:
        pass

    def new_reader():
        q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
        err: List[BaseException] = []

        def worker():
            try:
                for item in reader():
                    q.put(item)
            except BaseException as e:  # surfaced in consumer
                err.append(e)
            finally:
                q.put(_End)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _End:
                if err:
                    raise err[0]
                return
            yield item

    return new_reader


def firstn(reader: Reader, n: int) -> Reader:
    def new_reader():
        return itertools.islice(reader(), n)

    return new_reader


def xmap_readers(mapper: Callable, reader: Reader, process_num: int,
                 buffer_size: int, order: bool = False) -> Reader:
    """Parallel map over samples with worker threads
    (reference: decorator.py xmap_readers)."""

    end = object()

    def new_reader():
        in_q: queue_mod.Queue = queue_mod.Queue(buffer_size)
        out_q: queue_mod.Queue = queue_mod.Queue(buffer_size)
        errors: List[BaseException] = []

        def feeder():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def worker():
            try:
                while True:
                    item = in_q.get()
                    if item is end:
                        break
                    i, sample = item
                    out_q.put((i, mapper(sample)))
            except BaseException as e:
                errors.append(e)
            finally:
                out_q.put(end)

        threading.Thread(target=feeder, daemon=True).start()
        workers = [threading.Thread(target=worker, daemon=True) for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        if order:
            pending = {}
            next_idx = 0
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                i, mapped = item
                pending[i] = mapped
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                yield item[1]
        if errors:
            raise errors[0]

    return new_reader


def retrying(reader: Reader, *, max_retries: int = 3,
             backoff_base: float = 0.05, backoff_max: float = 2.0,
             seed=None, retryable=(Exception,),
             on_retry: Callable[[int, BaseException], None] = None
             ) -> Reader:
    """Restart the stream on failure instead of killing the pass, with
    exponential backoff + seeded jitter between attempts.

    Designed for master-backed readers (MasterClient.record_reader):
    there a restart RE-PULLS only unfinished task leases — finished
    tasks are never re-served and the failed task had yielded nothing
    (buffer-then-finish), so the retried pass sees no lost or
    duplicated records. For a plain in-memory reader a restart replays
    from the start — compose with the master reader (or something
    equally resumable) when exactly-once matters.

    The retry budget is per-stream and CONSECUTIVE-failure based: any
    successfully yielded sample resets it, so a long pass with
    scattered transient faults is not capped at `max_retries` total.
    `on_retry(attempt, exc)` observes each recovery (tests, metrics).
    """

    def new_reader():
        import time as _time

        rng = random_mod.Random(seed)
        attempt = 0
        while True:
            try:
                for item in reader():
                    attempt = 0
                    yield item
                return
            except retryable as e:
                attempt += 1
                if attempt > max_retries:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                ceiling = min(backoff_base * (2 ** (attempt - 1)),
                              backoff_max)
                _time.sleep(rng.uniform(0, ceiling))

    return new_reader


def cache(reader: Reader) -> Reader:
    """Materialize once, then replay from memory."""
    data: List[Any] = []
    loaded = [False]

    def new_reader():
        if not loaded[0]:
            data.extend(reader())
            loaded[0] = True
        return iter(data)

    return new_reader
