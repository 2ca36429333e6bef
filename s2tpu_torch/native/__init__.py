"""Native (C++) host-runtime components, loaded with ctypes (the port of ``s2tpu/native/__init__.py``).

``gather.cc`` is host code, not a device kernel: the multithreaded crop
gather of the packed corpus. It is built with g++ at first use, never at
import:

    g++ -O3 -shared -fPIC -std=c++17 gather.cc -o build/libs2tpu_native_<hash>.so -lpthread

into ``native/build/`` (git ignores it), under a name keyed by a hash of the
source and the flags, so an edited source builds a new library and a stale
one is never loaded. The build writes a temporary file and renames it into
place, so processes that build at the same moment never load a partial
file. Everything here has a numpy fallback: :func:`load` returns None (with
a warning) when the build or the load fails, and :func:`gather_crops`
returns None when its preconditions fail; the caller then takes the numpy
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)

SRC = Path(__file__).resolve().parent / "gather.cc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# Without -march=native: the library may travel between hosts, and a SIGILL
# mid-gather is worse than a few % of memcpy throughput.
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()  # one build and load per process, whichever thread asks first
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    """``build/libs2tpu_native_<hash>.so``, the hash over the flags and the source."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libs2tpu_native_{digest.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)  # atomic: a concurrent builder never loads a partial file
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning(f"native build failed ({e}); using numpy fallback")
        tmp.unlink(missing_ok=True)
        return False


def _bind(lib: ctypes.CDLL) -> None:
    lib.gather_crops_flips_i16_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # images, labels
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # h, w, c
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # indices, ys, xs
        ctypes.c_void_p, ctypes.c_void_p,  # flip_h, flip_v (NULL: no flips)
        ctypes.c_int64, ctypes.c_int64,  # b, crop
        ctypes.c_void_p, ctypes.c_void_p,  # out, lout
        ctypes.c_int64,  # num_threads
    ]
    lib.gather_crops_flips_i16_u8.restype = None


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None on failure, with a
    warning. Tried once per process."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
            _bind(lib)
        except (OSError, AttributeError) as e:
            logger.warning(f"native load failed ({e}); using numpy fallback")
            return None
        _lib = lib
        return _lib


def gather_crops(
    images: np.ndarray,
    labels: np.ndarray,
    indices: np.ndarray,
    ys: np.ndarray,
    xs: np.ndarray,
    crop: int,
    num_threads: int = 0,
    flip_h: np.ndarray | None = None,
    flip_v: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native (B, crop, crop, C) int16 + (B, crop, crop) int32 batch gather,
    with optional per-sample horizontal and vertical flips applied during
    the copy (the host's augmentation, so the train step does not flip).

    Returns None when preconditions fail (the caller falls back to numpy):
    contiguous int16 (N, H, W, C) images and uint8 (N, H, W) labels. Labels
    of another shape, flips of another length or a crop window outside the
    corpus raise ValueError (the copy would read past the arrays).
    """
    lib = load()
    if (
        lib is None
        or images.dtype != np.int16
        or labels.dtype != np.uint8
        or images.ndim != 4
        or not images.flags.c_contiguous
        or not labels.flags.c_contiguous
    ):
        return None
    n, h, w, c = images.shape
    b = len(indices)
    out = np.empty((b, crop, crop, c), np.int16)
    lout = np.empty((b, crop, crop), np.int32)
    idx = np.ascontiguousarray(indices, np.int64)
    ys64 = np.ascontiguousarray(ys, np.int64)
    xs64 = np.ascontiguousarray(xs, np.int64)
    fh = None if flip_h is None else np.ascontiguousarray(flip_h, np.uint8)
    fv = None if flip_v is None else np.ascontiguousarray(flip_v, np.uint8)
    if labels.shape != (n, h, w) or (fh is not None and len(fh) != b) or (fv is not None and len(fv) != b):
        raise ValueError(f"labels {labels.shape} or flips do not match images {images.shape} and {b} crops")
    if b and (idx.min() < 0 or idx.max() >= n or min(ys64.min(), xs64.min()) < 0
              or ys64.max() + crop > h or xs64.max() + crop > w):
        raise ValueError(f"crop windows of {crop} outside the ({n}, {h}, {w}) corpus")
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    lib.gather_crops_flips_i16_u8(
        images.ctypes.data, labels.ctypes.data,
        h, w, c,
        idx.ctypes.data, ys64.ctypes.data, xs64.ctypes.data,
        None if fh is None else fh.ctypes.data,
        None if fv is None else fv.ctypes.data,
        b, crop,
        out.ctypes.data, lout.ctypes.data,
        num_threads,
    )
    return out, lout
