"""Native parts of the port, built at first use, never at import.

``build.py`` compiles the hand-written CUDA kernels (``csrc/*.cu``) with
nvcc, and the shared-memory channel's native path (``channel.cpp``, the
copy of ``ray_tpu/_native/channel.cpp``) with g++; every library lands in
``ray_tpu_torch/_build/``.  ``channel_lib`` is the port of the loader in
``ray_tpu/_native/__init__.py``: waits block on a shared futex and payload
copies run with the GIL released; where the library cannot be built (no
compiler, a read-only install), the channel keeps its pure-Python path.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib = None
_tried = False


def channel_lib() -> Optional[ctypes.CDLL]:
    """The native channel library, or None (pure-Python fallback)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from ray_tpu_torch._native import build

        try:
            path = build.build_channel()
        except Exception as e:
            logger.warning("native channel build unavailable: %r", e)
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.ch_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint64, ctypes.c_double]
            lib.ch_write.restype = ctypes.c_int
            lib.ch_wait_writable.argtypes = [ctypes.c_void_p, ctypes.c_double]
            lib.ch_wait_writable.restype = ctypes.c_int
            lib.ch_wait_readable.argtypes = [
                ctypes.c_void_p, ctypes.c_double,
                ctypes.POINTER(ctypes.c_uint64)]
            lib.ch_wait_readable.restype = ctypes.c_int
            lib.ch_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_uint64, ctypes.c_double,
                                    ctypes.POINTER(ctypes.c_uint64)]
            lib.ch_read.restype = ctypes.c_int
            lib.ch_advance_tail.argtypes = [ctypes.c_void_p]
            lib.ch_wake.argtypes = [ctypes.c_void_p]
            _lib = lib
        except OSError as e:
            logger.warning("native channel load failed: %r", e)
            _lib = None
    return _lib
