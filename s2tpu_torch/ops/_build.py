"""Build the port's CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each library is compiled from sources under ``ops/csrc/`` into a shared
object with a plain C interface, for ``sm_90a`` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC ...

The object lands in ``ops/build/`` under a name keyed by a hash of the
sources, the headers of ``csrc/`` and the flags, so an edited source or
header rebuilds and an unchanged one is reused. ``-Xptxas -v`` output (registers, shared memory, spills) is kept
beside it in a ``.log`` file. Nothing here runs at import time. Libraries
build independently: :func:`load_libraries` runs one nvcc per library, all
at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from s2tpu_torch import profiling

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()  # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}
_libraries: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


HEADER_SUFFIXES = (".cuh", ".h")


def library_path(name: str, sources: list[str]) -> Path:
    """Build output for ``name``: ``build/lib<name>_<hash>.so``, the hash
    over the flags, the sources and every header in ``csrc/`` (a source may
    include any of them, so an edited header rebuilds every library)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC_DIR.iterdir() if p.suffix in HEADER_SUFFIXES)
    for src in [*sources, *headers]:
        digest.update(src.encode())
        digest.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_log(name: str, sources: list[str]) -> str:
    """The compiler's ``-Xptxas -v`` report of the last build of ``name``."""
    log = library_path(name, sources).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile ``sources`` (relative to ``csrc/``) if needed, then load them once."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libraries.get(name)
        if lib is not None:
            return lib
        so = library_path(name, sources)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC_DIR / s) for s in sources)]
            with profiling.span("s2tpu.ops.build"):
                proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            profiling.count("kernel_builds")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
        lib = ctypes.CDLL(str(so))
        _libraries[name] = lib
        return lib


def load_libraries(libraries: dict[str, list[str]]) -> dict[str, ctypes.CDLL]:
    """:func:`load_library` for every ``name -> sources`` entry, the builds
    running concurrently (one nvcc process each); any failure raises."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        futures = {name: pool.submit(load_library, name, srcs) for name, srcs in libraries.items()}
        return {name: f.result() for name, f in futures.items()}
