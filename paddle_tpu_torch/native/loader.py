"""ctypes bindings for the native threaded record loader (the
reference's async DoubleBuffer DataProvider, reference:
gserver/dataproviders/DataProvider.h:249 — N C++ worker threads
read+CRC-check recordio chunks while Python consumes from a bounded
queue)."""

from __future__ import annotations

import ctypes
from typing import Sequence

from paddle_tpu_torch.native.recordio import get_lib as _rio_lib


_cached = None


def get_lib():
    global _cached
    if _cached is None:
        # one shared binding object for libpaddle_tpu_native.so: reuse
        # recordio's (it already ran ensure_built) and declare the ldr_*
        # prototypes on it
        lib = _rio_lib()
        lib.ldr_open.restype = ctypes.c_void_p
        lib.ldr_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ldr_next.restype = ctypes.c_int64
        lib.ldr_next.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.POINTER(ctypes.c_char))]
        lib.ldr_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        lib.ldr_close.argtypes = [ctypes.c_void_p]
        _cached = lib
    return _cached


def native_reader(paths: Sequence[str], *, n_threads: int = 2,
                  capacity: int = 1024):
    """Reader-combinator-contract factory: returns a callable producing
    an iterator of record bytes, prefetched by C++ threads. Order is
    file order with n_threads=1, interleaved otherwise."""
    paths = [str(p) for p in paths]

    def reader():
        if not paths:  # a shard may legitimately own zero files
            return
        lib = get_lib()
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        h = lib.ldr_open(arr, len(paths), n_threads, capacity)
        if not h:
            raise OSError(f"native loader failed to open {paths!r}")
        try:
            out = ctypes.POINTER(ctypes.c_char)()
            while True:
                n = lib.ldr_next(h, ctypes.byref(out))
                if n == -1:
                    return
                if n < 0:
                    raise OSError(
                        "native loader: unreadable or corrupt recordio "
                        f"input among {paths!r}")
                try:
                    yield ctypes.string_at(out, n)
                finally:
                    lib.ldr_free(out)
        finally:
            lib.ldr_close(h)

    return reader
