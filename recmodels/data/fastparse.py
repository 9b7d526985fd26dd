"""ctypes loader for the native Criteo parser (_fastparse.cpp).

Compiled on demand with g++ (no pybind11 in this image; plain C ABI +
ctypes). Falls back silently to the Python parser if no compiler — the two
are bit-identical (tests/test_fastparse.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from recmodels.data.schema import N_CATEGORICAL, N_DENSE, Schema

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_fastparse.cpp")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build_dir() -> str:
    d = os.environ.get("RECMODELS_BUILD_DIR") or os.path.join(_HERE, "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = os.path.join(_build_dir(), "libfastparse.so")
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", so, _SRC],
                    check=True,
                    capture_output=True,
                )
            lib = ctypes.CDLL(so)
            lib.rm_parse_criteo.restype = ctypes.c_long
            lib.rm_parse_criteo.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_long),
            ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def parse_buffer(buf: bytes, schema: Schema, max_rows: int):
    """Parse complete lines from ``buf``. Returns (labels, dense, ids,
    consumed_bytes). dense already log1p-transformed, ids already hashed."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    labels = np.zeros((max_rows,), np.float32)
    dense = np.zeros((max_rows, N_DENSE), np.float32)
    ids = np.zeros((max_rows, N_CATEGORICAL), np.int32)
    vocab = np.asarray(schema.vocab_sizes, np.int64)
    consumed = ctypes.c_long(0)
    n = lib.rm_parse_criteo(
        buf,
        len(buf),
        max_rows,
        vocab.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(consumed),
    )
    return labels[:n], dense[:n], ids[:n], consumed.value
