"""Build at first use, and load, the native host library (ctypes): the
CSV parser (csv_parser.cpp) and the streaming trainer's row gather
(batch_gather.cpp)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRCS = [_HERE / "csv_parser.cpp", _HERE / "batch_gather.cpp"]
BUILD_DIR = _HERE.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_lock = threading.Lock()
_lib = None
_tried = False
_load_error: str | None = None


def native_load_error() -> str | None:
    """Why the native library is unavailable (None while it is loaded or
    untried). Callers that fall back to a Python path use this to make
    the degradation loud: a failed build or a bad library must not
    silently cost the native parse."""
    return _load_error


def _lib_path() -> Path:
    """The library's name carries a hash of sources and flags, so an
    edit rebuilds and an unchanged tree reuses the build."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libarcweld_native_{digest.hexdigest()[:16]}.so"


def build_native_lib(force: bool = False) -> str | None:
    """Compile the shared library if needed. Returns its path or None."""
    global _load_error
    lib = _lib_path()
    if lib.exists() and not force:
        return str(lib)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(exist_ok=True)
        subprocess.run(["g++", *_FLAGS, *map(str, _SRCS), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return str(lib)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        if isinstance(detail, bytes):
            detail = detail.decode(errors="replace")
        _load_error = (f"build failed ({type(e).__name__}: {e})"
                       + (f": {detail.strip()[:200]}" if detail else ""))
        return None


def load_native_lib():
    """The loaded ctypes library, or None (cached either way)."""
    global _lib, _tried, _load_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_native_lib()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            _load_error = f"dlopen failed ({e})"
            return None
        lib.asimow_count_rows.argtypes = [ctypes.c_char_p]
        lib.asimow_count_rows.restype = ctypes.c_int64
        lib.asimow_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.asimow_parse.restype = ctypes.c_int64
        lib.gather_rows_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.gather_rows_f32.restype = ctypes.c_int64
        _lib = lib
        return _lib
