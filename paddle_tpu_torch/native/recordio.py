"""ctypes bindings for the native recordio chunk format (reference:
go/master's recordio task partitioning, go/master/service.go:106)."""

from __future__ import annotations

import ctypes
from typing import Iterable, Iterator, List, Optional

from paddle_tpu_torch.native.build import ensure_built


def _lib():
    lib = ctypes.CDLL(ensure_built())
    lib.rio_writer_open.restype = ctypes.c_void_p
    lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rio_write.restype = ctypes.c_int
    lib.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint64]
    lib.rio_writer_close.restype = ctypes.c_int
    lib.rio_writer_close.argtypes = [ctypes.c_void_p]
    lib.rio_reader_open.restype = ctypes.c_void_p
    lib.rio_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64]
    lib.rio_next.restype = ctypes.c_int64
    lib.rio_next.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.POINTER(ctypes.c_char))]
    lib.rio_reader_close.argtypes = [ctypes.c_void_p]
    lib.rio_count_chunks.restype = ctypes.c_int64
    lib.rio_count_chunks.argtypes = [ctypes.c_char_p]
    return lib


_cached = None


def get_lib():
    global _cached
    if _cached is None:
        _cached = _lib()
    return _cached


class RecordWriter:
    def __init__(self, path: str, records_per_chunk: int = 1000):
        self._lib = get_lib()
        self._h = self._lib.rio_writer_open(path.encode(), records_per_chunk)
        if not self._h:
            raise OSError(f"cannot open {path} for writing")

    def write(self, record: bytes):
        if self._lib.rio_write(self._h, record, len(record)) != 0:
            raise OSError("recordio write failed")

    def close(self):
        if self._h:
            rc = self._lib.rio_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError("recordio close/flush failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Iterates records; optionally restricted to [chunk_begin, chunk_end)
    — the unit the task queue partitions over."""

    def __init__(self, path: str, chunk_begin: int = 0,
                 chunk_end: Optional[int] = None):
        self._lib = get_lib()
        self._h = self._lib.rio_reader_open(
            path.encode(), chunk_begin,
            -1 if chunk_end is None else chunk_end)
        if not self._h:
            raise OSError(f"cannot open {path}")

    def __iter__(self) -> Iterator[bytes]:
        ptr = ctypes.POINTER(ctypes.c_char)()
        while True:
            n = self._lib.rio_next(self._h, ctypes.byref(ptr))
            if n == -1:
                return
            if n < 0:
                raise OSError("corrupt recordio file")
            yield ctypes.string_at(ptr, n)

    def close(self):
        if self._h:
            self._lib.rio_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def count_chunks(path: str) -> int:
    n = get_lib().rio_count_chunks(path.encode())
    if n < 0:
        raise OSError(f"cannot count chunks in {path} (rc={n})")
    return n


def write_records(path: str, records: Iterable[bytes],
                  records_per_chunk: int = 1000):
    with RecordWriter(path, records_per_chunk) as w:
        for r in records:
            w.write(r)


def read_records(path: str, chunk_begin: int = 0,
                 chunk_end: Optional[int] = None) -> List[bytes]:
    with RecordReader(path, chunk_begin, chunk_end) as r:
        return list(r)
