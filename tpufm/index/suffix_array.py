"""Suffix array construction (host side).

Two implementations behind one function:
  * native C++ SA-IS (native/sais.cpp, loaded via ctypes) — O(n), used for
    large references; tpufm's equivalent of the reference's vendored
    libdivsufsort (reference resources/divsufsort.c:308-370, called from
    src/genFMindex.c:482).
  * pure NumPy prefix-doubling — O(n log^2 n) with vectorized lexsort rounds;
    dependency-free fallback and cross-check oracle for tests.

Convention: for a 2-bit-encoded text `codes` of length n we return the suffix
array of T = codes + '$' where '$' is the unique smallest symbol. The result
has n+1 entries, result[0] == n. This matches the reference's layout after it
inserts '$' into the divsufsort BWT at the primary index
(reference src/genFMindex.c:487-494).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_NAME = "libtpufm_sais.so"


def _load_native():
    lib_path = _NATIVE_DIR / _LIB_NAME
    if not lib_path.exists():
        # Try to build it on first use; tolerate failure (fallback exists).
        try:
            subprocess.run(
                ["make", "-s", _LIB_NAME],
                cwd=_NATIVE_DIR,
                check=True,
                capture_output=True,
                timeout=300,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        lib.tpufm_sais_u8.restype = ctypes.c_int
        lib.tpufm_sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        return lib
    except OSError:
        return None


_native_lib = None
_native_tried = False


def _get_native():
    global _native_lib, _native_tried
    if not _native_tried:
        _native_tried = True
        if os.environ.get("TPUFM_DISABLE_NATIVE", "0") != "1":
            _native_lib = _load_native()
    return _native_lib


def suffix_array_native(codes: np.ndarray) -> np.ndarray | None:
    """SA via the C++ SA-IS library, or None if the library is unavailable."""
    lib = _get_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    sa = np.empty(n + 1, dtype=np.int64)
    rc = lib.tpufm_sais_u8(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise RuntimeError(f"tpufm_sais_u8 failed with code {rc}")
    return sa


def suffix_array_doubling(codes: np.ndarray) -> np.ndarray:
    """SA via prefix doubling (Manber-Myers) with NumPy lexsort rounds."""
    codes = np.asarray(codes)
    n = codes.shape[0]
    big = n + 1
    # T with sentinel 0 (codes shifted +1 so sentinel is strictly smallest).
    rank = np.empty(big, dtype=np.int64)
    rank[:n] = codes.astype(np.int64) + 1
    rank[n] = 0

    # Compress initial single-character ranks.
    order = np.argsort(rank, kind="stable")
    sorted_r = rank[order]
    comp = np.empty(big, dtype=np.int64)
    comp[order] = np.concatenate(([0], np.cumsum(sorted_r[1:] != sorted_r[:-1])))
    rank = comp

    h = 1
    while rank[order[-1]] < big - 1:
        second = np.full(big, -1, dtype=np.int64)
        second[: big - h] = rank[h:]
        order = np.lexsort((second, rank))
        r1 = rank[order]
        r2 = second[order]
        changed = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        comp = np.empty(big, dtype=np.int64)
        comp[order] = np.concatenate(([0], np.cumsum(changed)))
        rank = comp
        h *= 2

    sa = np.empty(big, dtype=np.int64)
    sa[rank] = np.arange(big, dtype=np.int64)
    return sa


def suffix_array_naive(codes: np.ndarray) -> np.ndarray:
    """Brute-force sorted-suffix SA for tiny inputs (test oracle only)."""
    n = len(codes)
    t = bytes(np.asarray(codes, dtype=np.uint8) + 1) + b"\x00"
    return np.array(sorted(range(n + 1), key=lambda i: t[i:]), dtype=np.int64)


def suffix_array(codes: np.ndarray, method: str = "auto") -> np.ndarray:
    """Suffix array of codes + sentinel. codes: uint8 values in [0, 254].

    method: "auto" (native if available, else doubling), "native",
    "doubling", "naive", "device" (parallel prefix doubling ON the
    accelerator — tpufm/index/sa_device.py, the device counterpart of
    the reference's OpenMP-parallel suffix sort), or "sharded" (the same
    doubling sharded over every local device's memory —
    tpufm/index/sa_sharded.py, for texts past one device's capacity).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    if method == "auto":
        sa = suffix_array_native(codes)
        return sa if sa is not None else suffix_array_doubling(codes)
    if method == "native":
        sa = suffix_array_native(codes)
        if sa is None:
            raise RuntimeError("native SA-IS library unavailable")
        return sa
    if method == "doubling":
        return suffix_array_doubling(codes)
    if method == "device":
        from tpufm.index.sa_device import suffix_array_device

        return suffix_array_device(codes)
    if method == "sharded":
        from tpufm.index.sa_sharded import suffix_array_sharded

        return suffix_array_sharded(codes)
    if method == "naive":
        return suffix_array_naive(codes)
    raise ValueError(f"unknown method {method!r}")
