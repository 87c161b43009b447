"""Build and load the package's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into an object file,
one process per source, all started together, and links them into one
shared library with a plain C interface, which is loaded with
:mod:`ctypes`.
The library's file name carries a hash of the sources and the flags, so
an edited source is rebuilt and an unchanged one is loaded from
``build/``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of the C entry points (see csrc/*.cu)
SIGNATURES = {
    "mt_flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               ctypes.c_float, _I, _I, _P, _P],
    "mt_flash_attention_bwd": [_P] * 11 + [_I, _I, _I, _I, ctypes.c_float, _I,
                                           _I, _P, _P],
    "mt_flash_attention_family": [_I, _I, _I, _I],
    "mt_dilated_attention_fwd": [_P] * 8 + [_I, _I, _I, _I, _P, _P, _I,
                                            ctypes.c_float, _I, _I, _I, _P],
    "mt_dilated_attention_bwd": [_P] * 13 + [_I, _I, _I, _I, _P, _P, _I,
                                             ctypes.c_float, _I, _I, _I, _P],
    "mt_dilated_attention_bwd_part": [_P] * 11 + [_I, _I, _I, _I, _P, _P, _I,
                                                  ctypes.c_float, _I, _I, _I,
                                                  _I, _P],
    "mt_dilated_family": [_I, _I],
    "mt_alibi_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               ctypes.c_float, _I, _P, _P, _P, _P],
    "mt_alibi_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, ctypes.c_float, _I, _P, _P, _P,
                               _P, _P, _P, _P, _P],
    "mt_alibi_family": [_I, _I],
    "mt_dilated_fused_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _P, _P, _I, ctypes.c_float, _I, _P],
    "mt_dilated_fused_fwd_part": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _P, _P, _I, ctypes.c_float, _I,
                                  _P],
    "mt_dilated_fused_bwd": [_P] * 16 + [_I, _I, _I, _I, _P, _P, _I,
                                         ctypes.c_float, _I, _P],
    "mt_gelu_ln_fwd": [_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _I,
                       _P],
    "mt_gelu_ln_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I,
                       _I, _I, _P],
    "mt_gelu_ln_bwd_blocks": [_I] * 6,
    "mt_gelu_ln_route": [_I, _I, _I],
    "mt_gelu_ln_row_frame": [_I],
}


def find_nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit at $CUDA_HOME."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmodaltune_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> dict:
    """Compile the kernels unless a library for these sources exists.

    Returns ``{"path", "seconds", "log"}``; ``seconds`` is 0.0 and ``log``
    empty when the library was already built. Raises ``RuntimeError``
    with nvcc's output when a compile or the link fails."""
    lib = _library_path()
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = lib.with_name(f"{tag}.tmp")
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)
    seconds = time.perf_counter() - t0
    log = "".join(log)
    lib.with_suffix(".log").write_text(log)
    return {"path": str(lib), "seconds": seconds, "log": log}


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call, with every entry point's
    argument types declared (pointers and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(build_library()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mt_error_name.argtypes = [ctypes.c_int]
    lib.mt_error_name.restype = ctypes.c_char_p
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        what = load_library().mt_error_name(err).decode()
        raise RuntimeError(f"{name} failed to launch: {what} ({err})")
