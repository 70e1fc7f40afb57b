"""ctypes bindings for the native async stereo prefetcher (native/loader.cpp).

The replacement for the reference's AsyncImageLoader producer
thread + SPSC queue (reference: include/async_image_loader.h:18-80): N C++
decoder threads keep a bounded ordered ring of decoded grayscale frames ahead
of the consumer, so the host's Python loop only ever memcpy's ready frames
while the device computes.

Falls back to the synchronous Python reader if the shared library has not
been built (``make -C native``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libsvoloader.so")
_lib = None


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.svo_loader_create.restype = ctypes.c_void_p
        lib.svo_loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.svo_loader_next.restype = ctypes.c_int
        lib.svo_loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.svo_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return os.path.exists(_LIB_PATH)


class AsyncStereoLoader:
    """Iterate (idx, left, right) uint8 frames decoded ahead by C++ threads.

    Layout: <root>/image_2/%06d.png + <root>/image_3/%06d.png (KITTI,
    reference async_image_loader.h:55-66), or explicit left/right dirs.
    """

    def __init__(
        self,
        root: str,
        start: int,
        end: int,
        height: int,
        width: int,
        threads: int = 2,
        capacity: int = 8,
        left_dir: str | None = None,
        right_dir: str | None = None,
    ):
        lib = _load_lib()
        ld = left_dir or os.path.join(root, "image_2")
        rd = right_dir or os.path.join(root, "image_3")
        self.height, self.width = height, width
        self._handle = lib.svo_loader_create(
            ld.encode(), rd.encode(), start, end, capacity, threads, width, height
        )
        self._lib = lib

    def __iter__(self):
        sz = self.height * self.width
        while True:
            left = np.empty((self.height, self.width), np.uint8)
            right = np.empty((self.height, self.width), np.uint8)
            idx = self._lib.svo_loader_next(
                self._handle,
                left.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                right.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            if idx < 0:
                return
            yield idx, left, right

    def close(self):
        if self._handle:
            self._lib.svo_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
