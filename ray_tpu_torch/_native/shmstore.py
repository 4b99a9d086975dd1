"""ctypes binding for the C++ shared-memory object pool
(native/shmstore/shmstore.cpp — the plasma-store equivalent, reference:
src/ray/object_manager/plasma/{store.h,plasma_allocator.h,eviction_policy.h}).

Python-side object layout inside a pool allocation matches the file-store
layout (runtime/object_store.py): header + inband + 64B-aligned buffers,
so `PoolView` hands out zero-copy memoryviews into the pool mapping.
"""

from __future__ import annotations

import ctypes
import errno
import os
import struct
import weakref

from ray_tpu_torch._native import build_library

_HEADER = struct.Struct("<QQI")
_LEN = struct.Struct("<Q")
_MAGIC = 0x52545055_53544F52
_ALIGN = 64
_ID_LEN = 20


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build_library("shmstore", ("shmstore/shmstore.cpp",))
    lib = ctypes.CDLL(str(path))
    lib.shm_pool_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.shm_pool_create.restype = ctypes.c_int
    lib.shm_pool_open.argtypes = [ctypes.c_char_p]
    lib.shm_pool_open.restype = ctypes.c_void_p
    lib.shm_pool_close.argtypes = [ctypes.c_void_p]
    lib.shm_pool_base.argtypes = [ctypes.c_void_p]
    lib.shm_pool_base.restype = ctypes.c_void_p
    lib.shm_pool_capacity.argtypes = [ctypes.c_void_p]
    lib.shm_pool_capacity.restype = ctypes.c_uint64
    lib.shm_pool_used.argtypes = [ctypes.c_void_p]
    lib.shm_pool_used.restype = ctypes.c_uint64
    for fn in ("shm_seal", "shm_contains", "shm_release", "shm_delete", "shm_abort"):
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        f.restype = ctypes.c_int
    lib.shm_release_at.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.shm_release_at.restype = ctypes.c_int
    lib.shm_create.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.shm_create.restype = ctypes.c_int
    lib.shm_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.shm_get.restype = ctypes.c_int
    lib.shm_pool_scan.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint32,
    ]
    lib.shm_pool_scan.restype = ctypes.c_int
    _lib = lib
    return lib


def _pad_id(id_bytes: bytes) -> bytes:
    if len(id_bytes) > _ID_LEN:
        raise ValueError("object id too long for pool slot")
    return id_bytes.ljust(_ID_LEN, b"\0")


class _Pin:
    """Holds one pool refcount; drops it when garbage-collected. Keyed
    by the allocation's offset, not its id, so it stays correct if the
    id is deleted and re-created while this reader is still pinned."""

    __slots__ = ("__weakref__",)

    def __init__(self, pool: "ShmPool", abs_off: int):
        weakref.finalize(self, pool._release_at, abs_off)


class PoolView:
    """Zero-copy view into the pool.

    The refcount pin must outlive every consumer of the memory, not just
    this view object: pickle-5 deserialization hands the buffers to numpy
    arrays that alias the pool block. Each buffer is therefore exported
    through a ctypes array that carries the shared `_Pin` — the arrays sit
    on the deserialized values' `.base` chains, so the pin (and the block)
    is released exactly when the last aliasing value is garbage-collected,
    never while one is live. (The plasma client gets the same property from
    its C++ PlasmaBuffer releasing on destruction, reference:
    src/ray/object_manager/plasma/client.h.)
    """

    __slots__ = ("inband", "buffers", "_pin", "__weakref__")

    def __init__(self, pool: "ShmPool", abs_off: int, mv: memoryview):
        magic, inband_len, n_buffers = _HEADER.unpack_from(mv, 0)
        if magic != _MAGIC:
            raise ValueError("corrupt pool object")
        pin = _Pin(pool, abs_off)
        self._pin = pin
        off = _HEADER.size
        lens = []
        for _ in range(n_buffers):
            (length,) = _LEN.unpack_from(mv, off)
            lens.append(length)
            off += _LEN.size
        self.inband = mv[off : off + inband_len]
        off = _aligned(off + inband_len)
        self.buffers = []
        for length in lens:
            self.buffers.append(_pinned_slice(mv, off, length, pin))
            off = _aligned(off + length)


def _pinned_slice(mv: memoryview, off: int, length: int, pin: _Pin):
    """A memoryview of mv[off:off+length] whose exporter (a ctypes array)
    strongly references `pin`, tying the pool refcount to consumer
    lifetime (see PoolView docstring)."""
    if length == 0:
        return memoryview(b"")
    arr = (ctypes.c_char * length).from_buffer(mv, off)
    arr._pin = pin
    return memoryview(arr).cast("B")


class ShmPool:
    """One pool per node; every process maps the same file."""

    def __init__(self, path: str, capacity: int, num_slots: int = 65536):
        lib = _load()
        self._lib = lib
        self.path = path
        rc = lib.shm_pool_create(path.encode(), capacity, num_slots)
        if rc != 0 and rc != -errno.EEXIST:
            raise OSError(-rc, f"shm_pool_create({path}): {os.strerror(-rc)}")
        self._h = lib.shm_pool_open(path.encode())
        if not self._h:
            raise OSError(f"shm_pool_open({path}) failed")
        base = lib.shm_pool_base(self._h)
        cap = lib.shm_pool_capacity(self._h)
        self._mem = memoryview(
            (ctypes.c_char * cap).from_address(base)
        ).cast("B")

    # -- store interface ----------------------------------------------
    def put(self, id_bytes: bytes, data) -> int:
        """`data` is a Serialized (inband + buffers). Returns total bytes,
        0 if the object already exists (immutable double-put no-op)."""
        lib = self._lib
        if not self._h:
            raise ValueError("pool is closed")
        pid = _pad_id(id_bytes)
        header = _HEADER.pack(_MAGIC, len(data.inband), len(data.buffers))
        lens = b"".join(_LEN.pack(len(b)) for b in data.buffers)
        total = _aligned(len(header) + len(lens) + len(data.inband))
        for b in data.buffers:
            total = _aligned(total + len(b))
        total = max(total, 1)
        off = ctypes.c_uint64()
        rc = lib.shm_create(self._h, pid, total, ctypes.byref(off))
        if rc == -errno.EEXIST:
            return 0
        if rc != 0:
            raise MemoryError(
                f"pool create failed ({os.strerror(-rc)}): {total} bytes, "
                f"{self.used_bytes()}/{len(self._mem)} used"
            )
        try:
            m = self._mem
            base = off.value
            o = 0
            for part in (header, lens, bytes(data.inband)):
                m[base + o : base + o + len(part)] = part
                o += len(part)
            o = _aligned(o)
            for b in data.buffers:
                bb = b if isinstance(b, (bytes, memoryview)) else bytes(b)
                m[base + o : base + o + len(bb)] = bb
                o = _aligned(o + len(bb))
        except BaseException:
            if lib.shm_abort(self._h, pid) == -errno.ENOENT:
                # A concurrent delete zombified the in-creation slot
                # (find_slot skips zombies): drop the creator's pin by
                # offset so the block frees.
                lib.shm_release_at(self._h, off.value)
            raise
        rc = lib.shm_seal(self._h, pid)
        if rc == -errno.ENOENT:
            # Deleted while creating: equivalent to a successful put
            # immediately followed by the delete. Release the creator's
            # pin (frees the zombie block) and report success.
            lib.shm_release_at(self._h, off.value)
            return total
        if rc != 0:
            raise OSError(f"seal failed: {os.strerror(-rc)}")
        return total

    def get(self, id_bytes: bytes) -> PoolView | None:
        lib = self._lib
        if not self._h:
            return None
        pid = _pad_id(id_bytes)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = lib.shm_get(self._h, pid, ctypes.byref(off), ctypes.byref(size))
        if rc == -errno.ENOENT:
            return None
        if rc != 0:
            raise OSError(f"get failed: {os.strerror(-rc)}")
        mv = self._mem[off.value : off.value + size.value]
        return PoolView(self, off.value, mv)

    def contains(self, id_bytes: bytes) -> bool:
        if not self._h:
            return False
        return bool(self._lib.shm_contains(self._h, _pad_id(id_bytes)))

    def delete(self, id_bytes: bytes) -> None:
        if self._h:
            self._lib.shm_delete(self._h, _pad_id(id_bytes))

    def _release_at(self, abs_off: int) -> None:
        try:
            if self._h:
                self._lib.shm_release_at(self._h, abs_off)
        # tpulint: allow(broad-except reason=runs from buffer-finalizer callbacks during interpreter teardown where the pool handle may already be freed; raising would abort unrelated GC)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def used_bytes(self) -> int:
        return self._lib.shm_pool_used(self._h) if self._h else 0

    def capacity_bytes(self) -> int:
        return self._lib.shm_pool_capacity(self._h) if self._h else 0

    def scan(self, max_entries: int = 8192) -> list[tuple[bytes, int, int]]:
        """(id_bytes, size, lru_tick) for sealed, unpinned objects —
        the spill loop's candidate list, coldest-first after sorting."""
        if not self._h:
            return []
        ids = (ctypes.c_uint8 * (max_entries * _ID_LEN))()
        sizes = (ctypes.c_uint64 * max_entries)()
        lru = (ctypes.c_uint64 * max_entries)()
        n = self._lib.shm_pool_scan(
            self._h, ids, sizes, lru, max_entries
        )
        out = []
        raw = bytes(ids)
        for i in range(max(n, 0)):
            out.append(
                (raw[i * _ID_LEN : (i + 1) * _ID_LEN], sizes[i], lru[i])
            )
        return out

    def close(self) -> None:
        # Deliberately do NOT munmap: PoolViews hand out zero-copy
        # memoryviews into the mapping, and late finalizers (or user code
        # holding arrays) would fault on a torn-down map. The mapping and
        # fd live until process exit — same lifetime plasma clients give
        # their mmaps (reference: plasma client keeps maps for the
        # connection lifetime).
        self._h = None

    def destroy(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass
