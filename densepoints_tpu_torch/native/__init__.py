"""ctypes bindings to the native C++ runtime (`native/densepoints_native.cpp`
at the repository root): union-find track assembly and a binary PLY writer.

The library is built at first use with g++ (`-O3 -fPIC -std=c++17 -Wall
-shared`, the flags of `native/Makefile`) into this package's `_build/`,
under a name that carries a hash of the source and the flags. The build
writes a temporary file and renames it, so concurrent processes never load
a half-written library, and nothing is written under `native/`. Every
binding has a pure-Python fallback with identical results; if the build or
the load fails, one warning says so and the fallbacks are used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["available", "library_path"]

_SOURCE = (
    pathlib.Path(__file__).resolve().parents[2]
    / "native" / "densepoints_native.cpp"
)
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> pathlib.Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    digest.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"libdensepoints_native_{digest.hexdigest()[:16]}.so"


def _build() -> pathlib.Path:
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) found")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            [cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True, text=True, timeout=120, check=True,
        )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _bind(lib):
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    p_i32, p_i64 = ctypes.POINTER(i32), ctypes.POINTER(i64)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    lib.dp_union_matches.argtypes = [i32, i32, i32, p_i32, p_i32, p_i64]
    lib.dp_union_matches.restype = None
    lib.dp_compress_roots.argtypes = [i64, p_i64, p_i64]
    lib.dp_compress_roots.restype = None
    lib.dp_write_ply.argtypes = [
        ctypes.c_char_p, i64, p_f32, p_f32, ctypes.POINTER(ctypes.c_uint8)
    ]
    lib.dp_write_ply.restype = ctypes.c_int
    return lib


def _load():
    """The bound library, built at first use; None (after one warning) if
    it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _lib = _bind(ctypes.CDLL(str(_build())))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            from densepoints_tpu_torch.utils import log

            detail = getattr(e, "stderr", "") or ""
            log.warning(
                "native runtime unavailable (%s%s); track assembly and PLY "
                "export fall back to pure Python, which costs minutes of "
                "host time at scan scale",
                e, f": {detail.strip()}" if detail else "",
            )
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None
