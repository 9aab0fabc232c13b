"""Build and load the host bit packer, ``native/bitpack.cpp``.

It is compiled with the host C++ compiler at first use into
``academicodec_tpu_torch/csrc/build/`` (which .gitignore lists), under a
name that hashes the source, and bound with ctypes. Without a compiler
:func:`get_bitpack_lib` returns None and ``codec/binary.py`` packs with
numpy: the same bytes. This is host code; no device kernel
has a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).with_name("bitpack.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    return BUILD_DIR / f"libbitpack_{hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    try:
        subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)
    return True


def get_bitpack_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on first use; None if it cannot be
    built or loaded (callers then pack with numpy)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.bitpack.restype = ctypes.c_int64
        lib.bitpack.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
                                ctypes.POINTER(ctypes.c_uint8)]
        lib.bitunpack.restype = ctypes.c_int64
        lib.bitunpack.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        _LIB = lib
        return _LIB
