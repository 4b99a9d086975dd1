"""ctypes binding of the C++ token loader (``native/dataloader.cpp``, the
port's copy of the JAX package's loader): an mmap'd token corpus ->
shuffled [batch, seq+1] uint32 batches, with a background prefetch
thread."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ray_tpu_torch._native import build_library

_U32P = ctypes.POINTER(ctypes.c_uint32)


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("dataloader", ("dataloader.cpp",))))
    lib.dl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64]
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_close.argtypes = [ctypes.c_void_p]
    lib.dl_close.restype = None
    lib.dl_num_windows.argtypes = [ctypes.c_void_p]
    lib.dl_num_windows.restype = ctypes.c_uint64
    lib.dl_shuffle.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.dl_shuffle.restype = ctypes.c_int
    lib.dl_set_shard.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64
    ]
    lib.dl_set_shard.restype = ctypes.c_int
    lib.dl_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, _U32P
    ]
    lib.dl_fill.restype = ctypes.c_uint64
    lib.dl_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.dl_prefetch_start.restype = ctypes.c_int
    lib.dl_next.argtypes = [ctypes.c_void_p, _U32P]
    lib.dl_next.restype = ctypes.c_uint64
    lib.dl_prefetch_stop.argtypes = [ctypes.c_void_p]
    lib.dl_prefetch_stop.restype = None
    return lib


class NativeTokenLoader:
    """Thin handle over the C++ loader; see
    ray_tpu_torch.train.dataloader for the user-facing iterator."""

    def __init__(self, path: str, window: int, dtype_bytes: int = 4):
        lib = _load()
        self._lib = lib
        self._h = lib.dl_open(path.encode(), dtype_bytes, window)
        if not self._h:
            raise OSError(f"dl_open({path!r}) failed")
        self.window = window
        self._prefetching = False

    @property
    def num_windows(self) -> int:
        return self._lib.dl_num_windows(self._h)

    def shuffle(self, seed: int) -> None:
        if self._lib.dl_shuffle(self._h, seed) != 0:
            raise RuntimeError("cannot shuffle while prefetching")

    def set_shard(self, rank: int, world: int) -> None:
        if self._lib.dl_set_shard(self._h, rank, world) != 0:
            raise RuntimeError("cannot re-shard while prefetching")

    def fill(self, start: int, batch: int) -> np.ndarray:
        out = np.empty((batch, self.window), np.uint32)
        rows = self._lib.dl_fill(self._h, start, batch,
                                 out.ctypes.data_as(_U32P))
        return out[:rows]

    def prefetch_start(self, batch: int) -> None:
        rc = self._lib.dl_prefetch_start(self._h, batch)
        if rc != 0:
            raise RuntimeError(f"prefetch already running ({rc})")
        self._batch = batch
        self._prefetching = True

    def next(self) -> np.ndarray:
        out = np.empty((self._batch, self.window), np.uint32)
        rows = self._lib.dl_next(self._h, out.ctypes.data_as(_U32P))
        return out[:rows]

    def prefetch_stop(self) -> None:
        if self._prefetching:
            self._lib.dl_prefetch_stop(self._h)
            self._prefetching = False

    def close(self) -> None:
        if self._h:
            self._lib.dl_close(self._h)
            self._h = None

    def __del__(self):
        # The handle owns an mmap, a file descriptor and maybe a thread.
        if getattr(self, "_h", None):
            self.close()
