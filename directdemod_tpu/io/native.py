"""ctypes bindings for the native C++ IO runtime (native/iqio.cpp).

The shared library provides a multithreaded uint8->complex64 IQ unpacker (the
host-side bottleneck when feeding the device at GB/s). Built lazily via
`make -C native`; everything degrades to NumPy when the library is absent.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "native", "libiqio.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.iq_u8_to_c64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
        lib.iq_u8_to_c64.restype = None
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def iq_u8_to_c64(raw: np.ndarray, threads: int = 0) -> np.ndarray:
    """Interleaved uint8 IQ bytes -> complex64 with the -127.5 offset."""
    lib = _load()
    n = len(raw) // 2
    out = np.empty(n, dtype=np.complex64)
    src = np.ascontiguousarray(raw[: 2 * n])
    lib.iq_u8_to_c64(src.ctypes.data, out.ctypes.data,
                     ctypes.c_longlong(n), ctypes.c_int(threads))
    return out
