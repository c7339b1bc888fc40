"""ctypes binding of the native MultiSlot parser (``datafeed.cpp``): the
port's copy of ``paddle_tpu/native/datafeed.py``.

The shared library is built with ``g++ -O2`` at first use into
``native/build/`` (plain C ABI, no Python headers) and again whenever
the source is newer. A machine without a compiler reports
``available()`` False, and ``dataset.py`` parses in Python (its plain
version). A malformed line is dropped whole; the Python parser raises
on it instead, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Iterator, List, Optional

import numpy as np

__all__ = ["available", "parse_file", "library_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "build", "libpt_torch_feed.so")
_SRC = os.path.join(_HERE, "datafeed.cpp")

_lib = None
_lock = threading.Lock()
_build_failed = False


def library_path() -> str:
    return _SO


def _build() -> None:
    """Compile into a temporary file and rename it into place: a second
    process building at the same time never loads a half-written
    library."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        "-o", tmp, _SRC], check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
        lib.pt_parse_file.restype = ctypes.c_void_p
        lib.pt_parse_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte)]
        lib.pt_samples.restype = ctypes.c_int64
        lib.pt_samples.argtypes = [ctypes.c_void_p]
        lib.pt_slot_total.restype = ctypes.c_int64
        lib.pt_slot_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for name, ptr in (("pt_slot_lengths", ctypes.c_int64),
                          ("pt_slot_values_f", ctypes.c_float),
                          ("pt_slot_values_i", ctypes.c_int64)):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int,
                           ctypes.POINTER(ptr)]
        lib.pt_release.restype = None
        lib.pt_release.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_file(path: str, num_slots: int,
               dtypes: List[str]) -> Iterator[List[np.ndarray]]:
    """Parse a MultiSlot file natively; yield each sample's slot arrays
    (float32 for a slot whose dtype names a float, else int64)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native datafeed parser is not available "
                           "(g++ failed or is missing)")
    is_float = (ctypes.c_ubyte * num_slots)(
        *[1 if "float" in dt else 0 for dt in dtypes])
    h = lib.pt_parse_file(path.encode(), num_slots, is_float)
    if not h:
        raise IOError(f"native datafeed failed to open {path}")
    try:
        n = lib.pt_samples(h)
        slots = []
        for s in range(num_slots):
            total = lib.pt_slot_total(h, s)
            lengths = np.empty(n, np.int64)
            lib.pt_slot_lengths(h, s, lengths.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)))
            if is_float[s]:
                vals = np.empty(total, np.float32)
                lib.pt_slot_values_f(h, s, vals.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)))
            else:
                vals = np.empty(total, np.int64)
                lib.pt_slot_values_i(h, s, vals.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)))
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum(lengths, out=offsets[1:])
            slots.append((offsets, vals))
    finally:
        lib.pt_release(h)
    for i in range(n):
        yield [vals[offs[i]:offs[i + 1]] for offs, vals in slots]
