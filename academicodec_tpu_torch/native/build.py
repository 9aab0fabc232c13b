"""Build and load the port's host libraries: ``native/bitpack.cpp`` (the ECDC
bit packer) and ``native/wavloader.cpp`` (the threaded wav-crop loader).

Each is compiled with the host C++ compiler at first use into
``academicodec_tpu_torch/csrc/build/`` (which .gitignore lists), under a
name that hashes its source, to a temporary name first and then
``os.replace``d onto that name, so that processes building at once never
load a half-written file; it is bound with ctypes. Without a compiler
:func:`get_bitpack_lib` returns None and ``codec/binary.py`` packs with
numpy (the same bytes), while :func:`get_wavloader_lib` raises: the loader
has no quiet substitute. This is host code; no device kernel has a
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

SRC = Path(__file__).with_name("bitpack.cpp")
WAVLOADER_SRC = Path(__file__).with_name("wavloader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_BITPACK_TRIED = False


def library_path(src: Path = SRC) -> Path:
    stem = src.stem
    return BUILD_DIR / f"lib{stem}_{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"


def _build(src: Path, path: Path, libs=()) -> None:
    """Compile ``src`` to ``path`` by way of a temporary name; raises
    RuntimeError with the compiler's message when it cannot."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or c++) on PATH to build {src.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    try:
        subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(src), *libs],
                       check=True, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        detail = e.stderr if isinstance(e, subprocess.CalledProcessError) else e
        raise RuntimeError(f"building {src.name} failed: {detail}") from e
    os.replace(tmp, path)


def _load(src: Path, libs=()) -> ctypes.CDLL:
    """The library of ``src``, built unless its hashed name exists; under _LOCK."""
    path = library_path(src)
    if not path.exists():
        _build(src, path, libs)
    return ctypes.CDLL(str(path))


def get_bitpack_lib() -> Optional[ctypes.CDLL]:
    """The loaded bit packer, built on first use; None if it cannot be built
    or loaded (callers then pack with numpy)."""
    global _BITPACK_TRIED
    with _LOCK:
        if "bitpack" in _LIBS or _BITPACK_TRIED:
            return _LIBS.get("bitpack")
        _BITPACK_TRIED = True
        try:
            lib = _load(SRC)
        except (RuntimeError, OSError):
            return None
        lib.bitpack.restype = ctypes.c_int64
        lib.bitpack.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
                                ctypes.POINTER(ctypes.c_uint8)]
        lib.bitunpack.restype = ctypes.c_int64
        lib.bitunpack.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        _LIBS["bitpack"] = lib
        return lib


def get_wavloader_lib() -> ctypes.CDLL:
    """The loaded wav-crop loader, built on first use, with the JAX package's
    bindings (academicodec_tpu/native/build.py:86-106); raises RuntimeError
    (or OSError from the loader) when it cannot be built or loaded."""
    with _LOCK:
        if "wavloader" in _LIBS:
            return _LIBS["wavloader"]
        lib = _load(WAVLOADER_SRC, libs=("-lpthread",))
        lib.wavloader_create.restype = ctypes.c_void_p
        lib.wavloader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_longlong,
            ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_ulonglong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong,
        ]
        lib.wavloader_next.restype = ctypes.c_longlong
        lib.wavloader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.wavloader_batches_per_epoch.restype = ctypes.c_longlong
        lib.wavloader_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.wavloader_fallbacks.restype = ctypes.c_longlong
        lib.wavloader_fallbacks.argtypes = [ctypes.c_void_p]
        lib.wavloader_destroy.restype = None
        lib.wavloader_destroy.argtypes = [ctypes.c_void_p]
        _LIBS["wavloader"] = lib
        return lib
