"""Packed feature-bag cache: writer (numpy) + native mmap reader.

The port's copy of the JAX package's ``data/bagcache.py``, the same
file format. Replacement for the reference's per-slide pickle caches
(``torch.load`` per step at ``data_utils/datasets.py:218,234``): all
bags live contiguously in one memory-mapped container read by a small
C++ library (``modaltune_tpu_torch/native/bagcache.cpp``, built on first
use with g++ into ``modaltune_tpu_torch/build/`` and loaded via ctypes).
Falls back to a pure-numpy mmap reader if no compiler is available, as
the JAX package's copy does; :attr:`BagCacheReader.native` says which
reader a file got.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_MAGIC = b"MTBC1\x00\x00\x00"
_HEADER = struct.Struct("<8sQQ")
_ENTRY = struct.Struct("<QQ")


def write_bagcache(path: str, bags: Sequence[Tuple[np.ndarray, np.ndarray]]
                   ) -> None:
    """bags: iterable of (features (L, D) fp32, coords (L, 2) fp32)."""
    bags = [(np.ascontiguousarray(f, np.float32),
             np.ascontiguousarray(c, np.float32)) for f, c in bags]
    dim = bags[0][0].shape[1] if bags else 0
    n = len(bags)
    offset = _HEADER.size + n * _ENTRY.size
    entries = []
    for f, c in bags:
        assert f.shape[1] == dim and c.shape == (f.shape[0], 2)
        entries.append((offset, f.shape[0]))
        offset += f.nbytes + c.nbytes
    with open(path, "wb") as out:
        out.write(_HEADER.pack(_MAGIC, n, dim))
        for off, ln in entries:
            out.write(_ENTRY.pack(off, ln))
        for f, c in bags:
            out.write(f.tobytes())
            out.write(c.tobytes())


_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def _load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    pkg = Path(__file__).resolve().parent.parent
    src = pkg / "native" / "bagcache.cpp"
    so = pkg / "build" / "bagcache.so"
    try:
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            so.parent.mkdir(parents=True, exist_ok=True)
            # build under a name of this process's own, then rename: two
            # processes building at once never load a half-written library
            tmp = so.with_name(f"bagcache.{os.getpid()}.so")
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 str(src), "-o", str(tmp)],
                check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.bc_open.restype = ctypes.c_void_p
        lib.bc_open.argtypes = [ctypes.c_char_p]
        lib.bc_close.argtypes = [ctypes.c_void_p]
        lib.bc_count.restype = ctypes.c_long
        lib.bc_count.argtypes = [ctypes.c_void_p]
        lib.bc_dim.restype = ctypes.c_long
        lib.bc_dim.argtypes = [ctypes.c_void_p]
        lib.bc_len.restype = ctypes.c_long
        lib.bc_len.argtypes = [ctypes.c_void_p, ctypes.c_long]
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.bc_read.restype = ctypes.c_int
        lib.bc_read.argtypes = [ctypes.c_void_p, ctypes.c_long, fptr, fptr]
        lib.bc_read_subsample.restype = ctypes.c_int
        lib.bc_read_subsample.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_uint64, fptr, fptr,
            ctypes.POINTER(ctypes.c_long)]
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
    return _LIB


class BagCacheReader:
    """Random-access reader over a packed bag container."""

    def __init__(self, path: str, use_native: bool = True):
        self.path = str(path)
        self._lib = _load_library() if use_native else None
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.bc_open(self.path.encode())
            if not self._handle:
                self._lib = None
        if self._lib is None:
            # numpy mmap fallback
            self._mm = np.memmap(self.path, np.uint8, mode="r")
            magic, self._n, self._dim = _HEADER.unpack(
                bytes(self._mm[:_HEADER.size]))
            assert magic == _MAGIC, "not a bagcache file"
            raw = bytes(self._mm[_HEADER.size:
                                 _HEADER.size + self._n * _ENTRY.size])
            self._entries = [
                _ENTRY.unpack_from(raw, i * _ENTRY.size)
                for i in range(self._n)]
        else:
            self._n = self._lib.bc_count(self._handle)
            self._dim = self._lib.bc_dim(self._handle)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __len__(self) -> int:
        return int(self._n)

    @property
    def feat_dim(self) -> int:
        return int(self._dim)

    def bag_len(self, i: int) -> int:
        if self._handle is not None:
            return int(self._lib.bc_len(self._handle, i))
        return int(self._entries[i][1])

    def read(self, i: int, threshold: int = 0, seed: int = 0
             ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (features (n, D), coords (n, 2)); if threshold > 0 and the
        bag is longer, a sorted random subsample of `threshold` rows."""
        n = self.bag_len(i)
        if self._handle is not None:
            out_n = min(n, threshold) if threshold > 0 else n
            feats = np.empty((out_n, self._dim), np.float32)
            coords = np.empty((out_n, 2), np.float32)
            if threshold > 0:
                got = ctypes.c_long(0)
                rc = self._lib.bc_read_subsample(
                    self._handle, i, threshold, seed,
                    feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    ctypes.byref(got))
                assert rc == 0 and got.value == out_n
            else:
                rc = self._lib.bc_read(
                    self._handle, i,
                    feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                assert rc == 0
            return feats, coords
        # numpy fallback
        off, ln = self._entries[i]
        nbytes_f = ln * self._dim * 4
        feats = np.frombuffer(self._mm[off:off + nbytes_f].tobytes(),
                              np.float32).reshape(ln, self._dim)
        coords = np.frombuffer(
            self._mm[off + nbytes_f:off + nbytes_f + ln * 8].tobytes(),
            np.float32).reshape(ln, 2)
        if threshold > 0 and ln > threshold:
            rng = np.random.RandomState(seed & 0x7fffffff)
            idx = np.sort(rng.permutation(ln)[:threshold])
            feats, coords = feats[idx], coords[idx]
        return feats.copy(), coords.copy()

    def close(self):
        if self._handle is not None:
            self._lib.bc_close(self._handle)
            self._handle = None


def pack_feature_files(paths: Sequence[str], output: str) -> None:
    """Convert per-slide .npz/.pt caches into one packed container."""
    from .datasets import load_feature_bag
    bags = [load_feature_bag(p) for p in paths]
    write_bagcache(output, bags)
