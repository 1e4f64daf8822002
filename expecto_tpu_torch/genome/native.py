"""ctypes bindings for the repository's host C sequence helpers
(native/etseq.cc).

Loads the repo-level ``native/libetseq.so`` if present (built via
``make -C native``); callers use :func:`available` to pick between the
native path and the numpy fallback. The two paths are contract-identical
(tests/test_torch_host.py runs both).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_LIB = None
_SEARCH = [Path(__file__).resolve().parents[2] / "native" / "libetseq.so"]


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    for p in _SEARCH:
        if p.exists():
            lib = ctypes.CDLL(str(p))
            i64, i8p, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.etseq_gather_windows.argtypes = [u8p, i64, i64p, i64, i64, i8p]
            lib.etseq_build_flat.argtypes = [u8p, i64, u8p, i64p, i64p, i64p, i64p, i64]
            lib.etseq_build_flat.restype = i64
            _LIB = lib
            return lib
    return None


def available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def gather_windows(flat: np.ndarray, starts: np.ndarray, window_len: int) -> np.ndarray:
    """(n, window_len) int8 codes gathered from a flat contig byte buffer;
    out-of-range positions encode as N."""
    lib = _load()
    flat = np.ascontiguousarray(flat, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    out = np.empty((starts.shape[0], window_len), dtype=np.int8)
    lib.etseq_gather_windows(_u8(flat), flat.shape[0], _i64(starts), starts.shape[0], window_len, _i8(out))
    return out


def build_flat(fasta_bytes, max_contigs: int = 4096):
    """FASTA bytes (or any buffer, e.g. an mmap) -> (flat uint8 array view,
    {name: (flat_offset, length)}). The returned array is a slice of the
    builder's output buffer — write it with ``.tofile()`` rather than
    ``bytes()`` to avoid an extra whole-genome copy."""
    lib = _load()
    src = np.frombuffer(fasta_bytes, dtype=np.uint8)
    dst = np.empty(src.shape[0], dtype=np.uint8)
    flat_len = np.zeros(1, dtype=np.int64)
    name_off = np.zeros(max_contigs, dtype=np.int64)
    name_len = np.zeros(max_contigs, dtype=np.int64)
    flat_off = np.zeros(max_contigs, dtype=np.int64)
    n = lib.etseq_build_flat(_u8(src), src.shape[0], _u8(dst), _i64(flat_len), _i64(name_off), _i64(name_len), _i64(flat_off), max_contigs)
    if n < 0:
        raise RuntimeError("too many contigs for native flat builder")
    index = {}
    for k in range(n):
        name = src[name_off[k] : name_off[k] + name_len[k]].tobytes().decode()
        end = flat_off[k + 1] if k + 1 < n else flat_len[0]
        index[name] = (int(flat_off[k]), int(end - flat_off[k]))
    return dst[: flat_len[0]], index
