"""ctypes bindings for the native host structure engine (native/qrkit_host.cpp).

Loaded lazily: the first use compiles ``native/qrkit_host.cpp`` into
``native/build/libqrkit_host.so`` (a directory ``.gitignore`` lists) with the
host C++ compiler (``$CXX``, default ``g++``).  Every caller falls back to the
NumPy reference implementation when the library cannot be built or when
``QRKIT_TPU_NATIVE=0``.  Behavioral parity between the two paths is enforced
by tests/test_native.py.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_SRC = os.path.join(_NATIVE_DIR, "qrkit_host.cpp")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_SO = os.path.join(_BUILD_DIR, "libqrkit_host.so")
_CXXFLAGS = ["-O3", "-DNDEBUG", "-fPIC", "-std=c++17", "-shared"]


def _build() -> Optional[str]:
    """Compile the engine if the library is missing or older than its
    source.  Concurrent builders (``pytest -n``) each compile to their own
    temp file and publish it with an atomic ``os.replace``, so a reader
    never sees a partial library."""
    if not os.path.exists(_SRC):
        return None
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [cxx, *_CXXFLAGS, "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, _SO)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _SO


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("QRKIT_TPU_NATIVE", "1") == "0":
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.qrkit_abap_order.restype = ctypes.c_int
        lib.qrkit_block_detect.restype = ctypes.c_int64
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _lib() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_I64)


def _pf64(a: np.ndarray):
    return a.ctypes.data_as(_F64)


def row_ranges(nrows, ncols, indptr, indices):
    lib = _lib()
    starts = np.empty(nrows, dtype=np.int64)
    ends = np.empty(nrows, dtype=np.int64)
    lib.qrkit_row_ranges(
        ctypes.c_int64(nrows), ctypes.c_int64(ncols), _p64(indptr), _p64(indices),
        _p64(starts), _p64(ends),
    )
    return starts, ends


def abap_order(starts):
    lib = _lib()
    n = starts.shape[0]
    out = np.empty(n, dtype=np.int64)
    has_perm = lib.qrkit_abap_order(ctypes.c_int64(n), _p64(starts), _p64(out))
    return out, bool(has_perm)


def col_nnz(indices, ncols):
    lib = _lib()
    counts = np.empty(ncols, dtype=np.int64)
    lib.qrkit_col_nnz(
        ctypes.c_int64(indices.shape[0]), _p64(indices), ctypes.c_int64(ncols),
        _p64(counts),
    )
    return counts


def block_detect(nrows, ncols, starts, ends, suggested_cols):
    lib = _lib()
    max_blocks = nrows + 1
    out = np.empty((max_blocks, 4), dtype=np.int64)
    nnz_q = np.zeros(1, dtype=np.int64)
    count = lib.qrkit_block_detect(
        ctypes.c_int64(nrows), ctypes.c_int64(ncols), _p64(starts), _p64(ends),
        ctypes.c_int64(suggested_cols), _p64(out), ctypes.c_int64(max_blocks),
        _p64(nnz_q),
    )
    assert count >= 0
    return out[:count], int(nnz_q[0])


def extract_panels(nrows, ncols, indptr, indices, data, blocks, pad_rows, pad_cols):
    lib = _lib()
    nb = blocks.shape[0]
    data = np.ascontiguousarray(data, dtype=np.float64)
    blocks = np.ascontiguousarray(blocks, dtype=np.int64)
    out = np.empty((nb, pad_rows, pad_cols), dtype=np.float64)
    lib.qrkit_extract_panels(
        ctypes.c_int64(nrows), ctypes.c_int64(ncols), _p64(indptr), _p64(indices),
        _pf64(data), _p64(blocks), ctypes.c_int64(nb), ctypes.c_int64(pad_rows),
        ctypes.c_int64(pad_cols), _pf64(out),
    )
    return out


def permute_rows_csr(nrows, indptr, indices, data, gather):
    lib = _lib()
    data = np.ascontiguousarray(data, dtype=np.float64)
    gather = np.ascontiguousarray(gather, dtype=np.int64)
    out_indptr = np.empty(nrows + 1, dtype=np.int64)
    out_indices = np.empty_like(indices)
    out_data = np.empty_like(data)
    lib.qrkit_permute_rows_csr(
        ctypes.c_int64(nrows), _p64(indptr), _p64(indices), _pf64(data),
        _p64(gather), _p64(out_indptr), _p64(out_indices), _pf64(out_data),
    )
    return out_indptr, out_indices, out_data
