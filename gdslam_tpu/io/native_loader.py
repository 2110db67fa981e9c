"""ctypes bindings for the native prefetching TUM loader.

The native library (native/tum_loader.cpp) decodes PNGs on a background
thread into a bounded ring buffer so IO overlaps device compute — the
runtime role the reference fills with its C++ driver thread. It is built
from the committed sources by native/build.sh at first use; a failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "libtumloader.so")


def _load_lib():
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path):
        build = os.path.join(os.path.dirname(path), "build.sh")
        proc = subprocess.run(["sh", build], capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native TUM loader failed ({build}, exit "
                f"{proc.returncode}):\n{proc.stderr.strip()}")
    lib = ctypes.CDLL(path)
    lib.tum_loader_open.restype = ctypes.c_void_p
    lib.tum_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_double]
    lib.tum_loader_len.restype = ctypes.c_long
    lib.tum_loader_len.argtypes = [ctypes.c_void_p]
    lib.tum_loader_next.restype = ctypes.c_int
    lib.tum_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long]
    lib.tum_loader_next_raw.restype = ctypes.c_int
    lib.tum_loader_next_raw.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long]
    lib.tum_loader_close.restype = None
    lib.tum_loader_close.argtypes = [ctypes.c_void_p]
    return lib


_LIB = None


def _lib():
    """The loaded library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = _load_lib()
    return _LIB


class NativeTumSequence:
    """Sequential iterator over a TUM sequence with native async prefetch."""

    def __init__(self, sequence_dir: str, associations_path: str,
                 depth_map_factor: float = 5000.0,
                 width: int = 640, height: int = 480, raw: bool = False):
        """raw=True yields (uint8 rgb, uint16 depth-in-sensor-units, ts):
        a 4x-smaller host->device upload; the System converts to float
        meters ON DEVICE (the reference's DepthMapFactor contract,
        Tracking.cc:GrabImageRGBD imDepth convertTo)."""
        self._h = _lib().tum_loader_open(sequence_dir.encode(),
                                       associations_path.encode(),
                                       depth_map_factor)
        if not self._h:
            raise FileNotFoundError(associations_path)
        self._n = int(_LIB.tum_loader_len(self._h))
        self.width, self.height = width, height
        self.raw = raw
        if raw:
            self._rgb = np.empty((height, width, 3), np.uint8)
            self._depth = np.empty((height, width), np.uint16)
        else:
            self._rgb = np.empty((height, width, 3), np.float32)
            self._depth = np.empty((height, width), np.float32)

    def __len__(self):
        return self._n

    def __iter__(self):
        ts = ctypes.c_double()
        while True:
            if self.raw:
                rc = _LIB.tum_loader_next_raw(
                    self._h,
                    self._rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    self._depth.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint16)),
                    ctypes.byref(ts), self._rgb.size, self._depth.size)
            else:
                rc = _LIB.tum_loader_next(
                    self._h,
                    self._rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    self._depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    ctypes.byref(ts), self._rgb.size, self._depth.size)
            if rc == 1:
                return
            if rc == 2:
                continue   # decode failure: skip the frame
            yield self._rgb.copy(), self._depth.copy(), float(ts.value)

    def close(self):
        if self._h:
            _LIB.tum_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
