"""Build the port's CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper), then linked into one shared
library with a plain C interface. Nothing includes PyTorch's headers, so a
cold build takes seconds. The library lands in ``csrc/build/`` under a name
that hashes the sources and flags, and is built at first use. A failed
build raises: there is no fallback. Loading the library is the span
``kernels.load``, and the build inside it, where one runs, the span
``kernels.builds`` (``utils/profiling.py``): its count is the builds, its
seconds their host time.

Each C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

from academicodec_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
# dynamic shared memory one block may opt into on sm_90 (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_LL = ctypes.c_longlong
# name -> (restype, argtypes) of every C entry point in csrc/
_ENTRIES = {
    # x, embed, tiles scratch, enorm scratch, codes, n, d, n_q, k, stream
    "acad_rvq_encode": (_I, [_P] * 5 + [_I] * 4 + [_P]),
    # x_proj, w_hh1, w_ih2, w_hh2, b2, carry_in, carry_out, hbuf, barrier, y, T, B, H, jb,
    # blocks, smem, w_bf16, y_bf16, stream
    "acad_lstm2": (_I, [_P] * 10 + [_I] * 8 + [_P]),
    # barrier, iters, blocks, smem, stream
    "acad_grid_barrier": (_I, [_P, _I, _I, _I, _P]),
    # x, w, bias, wpost, bpost, wpre, bpre, y, spec, B, C, T, T_in, TT, H, Hc, buf, smem,
    # C_post, kp, post_tanh, bf16, stream
    "acad_resblock_tower": (_I, [_P] * 8 + [_IP] + [_I] * 13 + [_P]),
    # x, w, bias, outs, part, mom, lengths, spec, B, C, T, TT, H, buf, smem, bf16, stream
    "acad_resblock_tower_gn": (_I, [_P] * 7 + [_IP] + [_I] * 8 + [_P]),
    # part, mom, B, nT, CM, stream
    "acad_moments_reduce": (_I, [_P, _P, _I, _I, _I, _P]),
    # mom, scales, biases, lengths, A, K, B, C, G, num_groups, T, eps, stream
    "acad_gn_affine": (_I, [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P]),
    # rs, A, K, lengths, y, B, C, T, G, bf16, stream
    "acad_gn_apply": (_I, [_P] * 5 + [_I] * 5 + [_P]),
    # x, w, bias, y, B, C, T, P, TT, NW, stream
    "acad_conv_chain_bf16": (_I, [_P] * 4 + [_I] * 6 + [_P]),
    # x, wq, ws, bias, s_act, tau, y, B, C, T, P, TT, NW, stream
    "acad_conv_chain_i8": (_I, [_P] * 7 + [_I] * 6 + [_P]),
    # int8, C, NW, out[3]
    "acad_conv_chain_geometry": (_I, [_I] * 3 + [_IP]),
    # x, res, bias, alpha, y, s, B, C, T, Ty, xb, rb, yb, sb, channels_last, dtype, vec, stream
    "acad_snake": (_I, [_P] * 6 + [_I] * 4 + [_LL] * 4 + [_I] * 3 + [_P]),
    "acad_error_string": (ctypes.c_char_p, [_I]),
}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libacademicodec_kernels_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile and link the kernels if needed; returns the library path and
    the compiler's ``-Xptxas -v`` report (kept beside the library)."""
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists() and log_path.exists():
        return lib, log_path.read_text()
    log = _compile(lib)
    log_path.write_text(log)
    return lib, log


@profiling.span("kernels.builds")
def _compile(lib: Path) -> str:
    """Compile every source with ``nvcc`` and link them into ``lib``; returns the compiler's report."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    try:
        for src in _sources():
            obj = BUILD_DIR / f"{src.stem}_{lib.stem[-16:]}.o"
            objs.append(obj)
            procs.append(
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
            )
        logs = []
        for src, proc in zip(_sources(), procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} (rc {proc.returncode}):\n{out}")
            logs.append(f"== {src.name}\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking {lib.name} failed (rc {link.returncode}):\n{link.stdout}")
    os.replace(tmp, lib)
    return "".join(logs)


@functools.cache
@profiling.span("kernels.load")
def load_library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's signature declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load_library().acad_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")
