"""Build the native runtime library (g++ -> libpaddle_tpu_torch_native).

The recordio chunk format, the task-queue master with its TCP service
and the threaded record loader are C++ (`native/src/recordio.cc`,
`taskqueue.cc`, `loader.cc`), bound through `ctypes`. They compile at
first use with

    g++ -O2 -std=c++17 -fPIC -shared -pthread -Wall src/*.cc

into `paddle_tpu_torch/_build/libpaddle_tpu_torch_native-<hash>.so`,
named by a hash of the sources and the flags, so an edited source
rebuilds and an unchanged one loads at once. Importing this module
builds nothing. Builds are multi-process safe: the compiler writes a
temporary file that is `os.replace()`d into place under an fcntl file
lock, so concurrent processes never dlopen a half-written library.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_SOURCES = ["recordio.cc", "taskqueue.cc", "loader.cc"]
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall"]
_NAME = "libpaddle_tpu_torch_native"
_lock = threading.Lock()


def sources() -> list:
    return [os.path.join(_SRC, s) for s in _SOURCES]


def lib_path() -> str:
    """The library's path, named by a hash of the sources and flags."""
    h = hashlib.sha256()
    for src in sources():
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{_NAME}-{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _file_lock(path: str):
    """Advisory cross-process lock (several processes may race the
    first build; an in-process threading.Lock alone is not enough)."""
    with open(path, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _compile(cmd_prefix: list, lib: str) -> None:
    tmp = f"{lib}.tmp.{os.getpid()}"
    try:
        subprocess.run(cmd_prefix + ["-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, lib)  # atomic publish
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def ensure_built(force: bool = False) -> str:
    """Compile the shared library if it is not built yet; returns its
    path."""
    lib = lib_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock, _file_lock(os.path.join(BUILD_DIR, f"{_NAME}.lock")):
        if not force and os.path.exists(lib):
            return lib
        _compile(["g++", *FLAGS, *sources()], lib)
        return lib
