"""Native (C++) data-pipeline core, bound via ctypes.

``decode_batch(paths, size)`` decodes + (optionally crops) + resizes a whole
batch with an OpenCV-backed C++ thread pool, writing float32 BGR straight
into one preallocated buffer — no Python work per sample.  Builds lazily with
the in-image toolchain (``make``) and degrades gracefully: ``available()``
is False when OpenCV dev libraries are absent, and callers fall back to the
Python/cv2 path.

A copy of ``unipose_tpu/native/__init__.py`` that builds the port's own
copy of ``decode.cpp`` into this directory at first use (never at import).
One departure: the library is built under a name of this process's own and
moved into place with ``os.replace``, so that two processes building at
once (test workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libunipose_data.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> bool:
    out = f"libunipose_data.{os.getpid()}.so"
    try:
        subprocess.run(
            ["make", "-C", _DIR, f"OUT={out}", out],
            check=True,
            capture_output=True,
        )
        os.replace(os.path.join(_DIR, out), _LIB_PATH)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        if os.path.exists(os.path.join(_DIR, out)):
            os.remove(os.path.join(_DIR, out))


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.unipose_decode_batch.restype = ctypes.c_int
        lib.unipose_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.unipose_decode_batch_mem.restype = ctypes.c_int
        lib.unipose_decode_batch_mem.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # byte buffers
            ctypes.POINTER(ctypes.c_int),     # lengths
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_batch(
    paths: Sequence[str],
    size: int = 368,
    *,
    crops: Optional[np.ndarray] = None,
    bottom_right: int = 0,
    out: Optional[np.ndarray] = None,
    n_threads: int = 0,
    return_dims: bool = False,
    test_resized: bool = False,
):
    """Decode ``paths`` into (N, size, size, 3) f32 BGR (0..255).

    crops: optional (N, 4) int32 (x0, y0, w, h) pre-resize crops.
    bottom_right: >0 applies the BBC bottom-right square crop
      (bbc_data.py:169) before resizing.
    out: optional preallocated output (reused across batches).
    return_dims: also return the original (rows, cols) per image as
      (N, 2) int32 — what keypoint rescaling needs (0 on failure).
    test_resized: resize via the Python TestResized float chain instead of
      the u8 linear resize — float32 convert, INTER_CUBIC to the
      reference's h/w-derived truncating dsize, INTER_LINEAR fixup to
      (size, size) when the truncation fired (decode.cpp Job doc; the
      Penn Action per-frame semantics).
    Returns (batch, statuses[, dims]) where statuses[i] != 0 marks an
    unreadable file (its slot is zero-filled — callers may apply
    previous-frame fallback).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable (OpenCV dev libs missing)")
    n = len(paths)
    if out is None:
        out = np.empty((n, size, size, 3), np.float32)
    assert out.shape == (n, size, size, 3) and out.dtype == np.float32
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    statuses = np.zeros(n, np.int32)
    crops_ptr = None
    if crops is not None:
        crops = np.ascontiguousarray(crops, np.int32)
        crops_ptr = crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 4, 16)
    dims = np.zeros((n, 2), np.int32) if return_dims else None
    lib.unipose_decode_batch(
        c_paths,
        n,
        size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        crops_ptr,
        bottom_right,
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)) if dims is not None else None,
        n_threads,
        1 if test_resized else 0,
    )
    if return_dims:
        return out, statuses, dims
    return out, statuses


def decode_batch_mem(
    bufs: Sequence[bytes],
    size: int = 368,
    *,
    out: Optional[np.ndarray] = None,
    n_threads: int = 0,
    return_dims: bool = False,
    test_resized: bool = False,
):
    """``decode_batch`` for in-memory encoded images (the serving path:
    HTTP bodies carry JPEG bytes, there are no files).  Same output
    contract; statuses[i] != 0 marks an undecodable buffer."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable (OpenCV dev libs missing)")
    n = len(bufs)
    if out is None:
        out = np.empty((n, size, size, 3), np.float32)
    assert out.shape == (n, size, size, 3) and out.dtype == np.float32
    # c_char_p carries the raw pointer; explicit lens make embedded NULs safe.
    c_bufs = (ctypes.c_char_p * n)(*bufs)
    c_lens = (ctypes.c_int * n)(*[len(b) for b in bufs])
    statuses = np.zeros(n, np.int32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 4, 16)
    dims = np.zeros((n, 2), np.int32) if return_dims else None
    lib.unipose_decode_batch_mem(
        c_bufs,
        c_lens,
        n,
        size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        None,
        0,
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)) if dims is not None else None,
        n_threads,
        1 if test_resized else 0,
    )
    if return_dims:
        return out, statuses, dims
    return out, statuses
