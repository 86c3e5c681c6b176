"""ctypes binding for the native C++ image loader (``loader.cpp``), the
port's own copy of the JAX package's ``native/``.

Builds on first use with the host toolchain (g++ -O2 -shared -fPIC -lz)
into ``matchinglib_poselib_torch/_build/`` (ignored by git), under a file
name that carries a hash of the source and flags, so an edited source never
loads a stale build; nothing is written beside the source. Every entry
point degrades gracefully: if the toolchain or zlib is missing, or a file
uses an encoding the loader does not decode (e.g. interlaced PNG), callers
fall back to the PIL path in ``utils/io.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = _SRC.parents[1] / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_build_failed = False
# compiler output of a failed build (why ``available`` is False)
BUILD_ERROR = ""


def library_path() -> pathlib.Path:
    digest = hashlib.sha1(
        _SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmlploader-{digest[:12]}.so"


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed, BUILD_ERROR
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        so = library_path()
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", *GXX_FLAGS, str(_SRC), "-lz", "-o", str(tmp)],
                    check=True, capture_output=True, text=True, timeout=120,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.mlp_load_gray.restype = ctypes.c_void_p
            lib.mlp_load_gray.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.mlp_data.restype = ctypes.POINTER(ctypes.c_float)
            lib.mlp_data.argtypes = [ctypes.c_void_p]
            lib.mlp_release.argtypes = [ctypes.c_void_p]
            lib.mlp_load_batch_gray.restype = ctypes.c_int
            lib.mlp_load_batch_gray.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
            ]
            _lib = lib
            return _lib
        except Exception as exc:  # no toolchain, no zlib.h, no libz
            BUILD_ERROR = getattr(exc, "stderr", None) or repr(exc)
            _build_failed = True
            return None


def available() -> bool:
    return _load() is not None


def load_image_gray(path) -> np.ndarray | None:
    """(H, W) float32 grayscale in [0, 1], or None if undecodable here."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    handle = lib.mlp_load_gray(
        str(path).encode(), ctypes.byref(h), ctypes.byref(w)
    )
    if not handle:
        return None
    try:
        buf = np.ctypeslib.as_array(
            lib.mlp_data(handle), shape=(h.value, w.value)
        )
        return np.array(buf, dtype=np.float32)  # own copy before release
    finally:
        lib.mlp_release(handle)


def load_batch_gray(paths, h: int, w: int, n_threads: int = 0):
    """Threaded batch decode into one (N, H, W) float32 array.

    Returns (array, n_decoded); slots that failed to decode (or whose
    size differs from (h, w)) are zero-filled — callers treat n_decoded
    < N as a signal to fall back per-file.
    """
    lib = _load()
    if lib is None:
        return None, 0
    n = len(paths)
    out = np.empty((n, h, w), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    good = lib.mlp_load_batch_gray(
        arr, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, n_threads,
    )
    return out, int(good)
