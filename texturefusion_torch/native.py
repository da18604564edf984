"""The native chunk-slot allocator, built for this package.

The allocator's C++ source and its ctypes wrapper belong to the JAX
package (texturefusion_tpu/native/, jax-free). Its tracked library there
is built with -march=native for the machine that built it, so this
package compiles the same source once more, portable (no -march), into
texturefusion_torch/_build/, and falls back to the pure-Python allocator
of the same module when no C++ compiler is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from texturefusion_tpu.native import allocator as _alloc

_SRC = os.path.join(os.path.dirname(os.path.abspath(_alloc.__file__)), "chunk_alloc.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def get_lib() -> Optional[ctypes.CDLL]:
    """The allocator library, compiled on first use; None without g++."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        path = os.path.join(_BUILD, f"libtfnative_{tag}.so")
        if not os.path.exists(path):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            except (subprocess.CalledProcessError, FileNotFoundError,
                    subprocess.TimeoutExpired):
                return None
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        i64, p = ctypes.c_int64, ctypes.c_void_p
        lib.ca_create.restype = p
        lib.ca_create.argtypes = [i64]
        lib.ca_destroy.argtypes = [p]
        lib.ca_count.restype = i64
        lib.ca_count.argtypes = [p]
        lib.ca_touch.restype = i64
        lib.ca_touch.argtypes = [p, p, i64, ctypes.c_int32, p, p, p]
        lib.ca_lookup.argtypes = [p, p, i64, p]
        lib.ca_release.argtypes = [p, p, i64]
        lib.ca_export.argtypes = [p, p, p]
        lib.ca_import.argtypes = [p, p, p, i64]
        _lib = lib
        return _lib


class NativeChunkAllocator(_alloc.NativeChunkAllocator):
    """The JAX package's ctypes wrapper over this package's build."""

    kind = "native"

    def __init__(self, capacity: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native allocator unavailable (no g++)")
        self.lib = lib
        self.capacity = capacity
        self.handle = lib.ca_create(capacity)
        self._slots_buf = np.empty(capacity, np.int64)
        self._new_buf = np.empty(capacity, np.int64)


class PyChunkAllocator(_alloc.PyChunkAllocator):
    kind = "python"


def make_allocator(capacity: int):
    """Native allocator when g++ is present, the Python one otherwise.
    Both hand out slots in the order they first see chunk ids."""
    try:
        return NativeChunkAllocator(capacity)
    except (RuntimeError, OSError):
        return PyChunkAllocator(capacity)
