"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

Libraries are built at first use into `paddle_tpu_torch/_build/`, named
by a hash of the source, the shared headers `csrc/*.cuh` and the flags,
so an edited source or header rebuilds and
an unchanged one loads at once. `build_all()` starts one `nvcc` per
source, all together, and waits for them. Nothing is built or imported
when this module is imported; a build failure raises, it never falls
back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: kernel library name -> its source under csrc/
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "ragged_paged_attention": "ragged_paged_attention.cu",
    "fused_lstm": "fused_lstm.cu",
    "fused_gru": "fused_gru.cu",
    "fused_rnn": "fused_rnn.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then /usr/local/cuda,
    then PATH. Raises when none exists."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers (`csrc/*.cuh`) and the flags."""
    h = hashlib.sha256((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, float]:
    """Build every library in `names` (default: all) that is not built
    yet, one nvcc process per source, all started together. Returns
    {name: seconds} for the builds that ran; the compiler's output
    (with `-Xptxas -v` register and shared-memory counts) is kept next
    to each library as `<name>.log`. Raises RuntimeError naming every
    source that failed."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    times, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Load (building first if needed) the kernel library `name` and
    declare each C entry's argtypes; every entry returns the
    `cudaError_t` of its launch as an int."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def skip_dynamo_guard(op) -> None:
    """Let a `torch.library.custom_op`'s registered kernels run without
    the dynamo guard torch wraps around each of them. The guard imports
    torch._dynamo at a process's first call of a kernel (with sympy and
    the distributed packages: seconds on an H100's host), and a replica
    process or a CLI child pays that in its boot. The guard only matters
    under torch.compile, which the port does not use: its operators run
    eagerly, or under torch.export, which calls their fakes. Where a
    torch release wraps its kernels otherwise, this changes nothing."""
    for fn in getattr(op, "_backend_fns", {}).values():
        inner = getattr(fn, "__wrapped__", None)
        if inner is not None:
            setattr(inner, "__dynamo_disable", inner)


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA "
                           f"error {err}")
