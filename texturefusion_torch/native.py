"""The native chunk-slot allocator, built for this package.

A copy of the JAX package's allocator (texturefusion_tpu/native/:
chunk_alloc.cpp, here csrc/chunk_alloc.cpp, and its ctypes wrapper), so
that this package imports nothing of the JAX package. The source is
compiled portable (no -march) into texturefusion_torch/_build/ on first
use; without a C++ compiler the pure-Python allocator takes its place.
Both hand out slots in the order they first see chunk ids.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "chunk_alloc.cpp")
_BUILD = os.path.join(_PKG, "_build")
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


class NativeChunkAllocator:
    """Chunk-ID → slot map with free list and per-call dedup, backed by
    csrc/chunk_alloc.cpp; it takes the raw per-frame candidate stream
    (no np.unique needed)."""

    kind = "native"

    def __init__(self, capacity: int):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native allocator unavailable (no g++)")
        self.capacity = capacity
        self.handle = self.lib.ca_create(capacity)
        self._slots_buf = np.empty(capacity, np.int64)
        self._new_buf = np.empty(capacity, np.int64)

    def __del__(self):
        if getattr(self, "handle", None) and self.lib is not None:
            self.lib.ca_destroy(self.handle)
            self.handle = None

    def touch(self, ids: np.ndarray, allocate: bool = True
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Deduplicate raw chunk IDs [N, 3] int32 and return
        (unique slots [M], newly allocated slots [K])."""
        ids = np.ascontiguousarray(ids, np.int32)
        n_new = np.zeros(1, np.int64)
        n = self.lib.ca_touch(
            self.handle, ids.ctypes.data, len(ids), 1 if allocate else 0,
            self._slots_buf.ctypes.data, self._new_buf.ctypes.data,
            n_new.ctypes.data)
        return (self._slots_buf[:n].copy(), self._new_buf[:int(n_new[0])].copy())

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int32)
        out = np.empty(len(ids), np.int64)
        self.lib.ca_lookup(self.handle, ids.ctypes.data, len(ids),
                           out.ctypes.data)
        return out

    def release(self, slots: np.ndarray) -> None:
        slots = np.ascontiguousarray(slots, np.int64)
        self.lib.ca_release(self.handle, slots.ctypes.data, len(slots))

    def export(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [capacity, 3] int32, used [capacity] bool)."""
        ids = np.empty((self.capacity, 3), np.int32)
        used = np.empty(self.capacity, np.uint8)
        self.lib.ca_export(self.handle, ids.ctypes.data, used.ctypes.data)
        return ids, used.astype(bool)

    def import_state(self, slots: np.ndarray, ids: np.ndarray) -> None:
        slots = np.ascontiguousarray(slots, np.int64)
        ids = np.ascontiguousarray(ids, np.int32)
        self.lib.ca_import(self.handle, slots.ctypes.data, ids.ctypes.data,
                           len(slots))

    def count(self) -> int:
        return int(self.lib.ca_count(self.handle))


class PyChunkAllocator:
    """Pure-Python fallback with the same API as NativeChunkAllocator."""

    kind = "python"

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.slot_of = {}
        self.ids = np.zeros((capacity, 3), np.int32)
        self.used = np.zeros(capacity, bool)
        self._free = list(range(capacity - 1, -1, -1))

    def touch(self, ids: np.ndarray, allocate: bool = True
              ) -> Tuple[np.ndarray, np.ndarray]:
        uniq = np.unique(np.ascontiguousarray(ids, np.int32), axis=0)
        slots, new = [], []
        for cid in map(tuple, uniq.tolist()):
            s = self.slot_of.get(cid)
            if s is None:
                if not allocate or not self._free:
                    continue
                s = self._free.pop()
                self.slot_of[cid] = s
                self.ids[s] = cid
                self.used[s] = True
                new.append(s)
            slots.append(s)
        return np.asarray(slots, np.int64), np.asarray(new, np.int64)

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        return np.asarray([self.slot_of.get(tuple(c), -1)
                           for c in np.asarray(ids, np.int32).tolist()], np.int64)

    def release(self, slots: np.ndarray) -> None:
        for s in np.atleast_1d(slots).tolist():
            s = int(s)
            if 0 <= s < self.capacity and self.used[s]:
                cid = tuple(self.ids[s])
                if self.slot_of.get(cid) == s:
                    del self.slot_of[cid]
                self.used[s] = False
                self._free.append(s)

    def export(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.ids.copy(), self.used.copy()

    def import_state(self, slots: np.ndarray, ids: np.ndarray) -> None:
        self.slot_of.clear()
        self.used[:] = False
        for s, cid in zip(np.asarray(slots).tolist(),
                          np.asarray(ids).tolist()):
            self.slot_of[tuple(cid)] = int(s)
            self.ids[int(s)] = cid
            self.used[int(s)] = True
        taken = set(np.asarray(slots).tolist())
        self._free = [s for s in range(self.capacity - 1, -1, -1)
                      if s not in taken]

    def count(self) -> int:
        return int(self.used.sum())


def make_allocator(capacity: int):
    """Native allocator when g++ is present, the Python one otherwise.
    Both hand out slots in the order they first see chunk ids."""
    try:
        return NativeChunkAllocator(capacity)
    except (RuntimeError, OSError):
        return PyChunkAllocator(capacity)
