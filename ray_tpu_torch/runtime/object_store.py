"""Per-node shared-memory object store (plasma equivalent).

The reference runs a slab-allocated shared-memory daemon inside the raylet
(reference: src/ray/object_manager/plasma/store.h:55, dlmalloc pool,
fd-passing over unix sockets). TPU-native design note: on Linux, POSIX shm
*is* files under /dev/shm — so instead of a daemon brokering fds, each
sealed object is one mmap'd file in a session directory. Create-then-seal
is an atomic rename; readers mmap the sealed file and get zero-copy
memoryviews (pickle-5 out-of-band buffers point straight into the map).
Eviction/spilling hooks live here; a C++ pool allocator can replace the
file-per-object layout behind this same interface.

Layout of a sealed object file:
    [u64 magic][u64 inband_len][u32 n_buffers][u64 len * n_buffers]
    inband bytes, then each buffer 64-byte aligned.
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
from pathlib import Path

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import Serialized

_MAGIC = 0x52545055_53544F52  # "RTPUSTOR"
_HEADER = struct.Struct("<QQI")
_LEN = struct.Struct("<Q")
_ALIGN = 64


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class PlasmaView:
    """Zero-copy view of a sealed object; keeps its mmap alive."""

    __slots__ = ("inband", "buffers", "_map", "_file_size", "__weakref__")

    def __init__(self, mapping: mmap.mmap):
        self._map = mapping
        mv = memoryview(mapping)
        magic, inband_len, n_buffers = _HEADER.unpack_from(mv, 0)
        if magic != _MAGIC:
            raise ValueError("corrupt object store entry")
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
            self.buffers.append(mv[off : off + length])
            off = _aligned(off + length)
        self._file_size = len(mv)


class ObjectStore:
    """One store per node; all processes on the node share the directory.

    Backend: the C++ shared-memory pool (ray_tpu_torch/_native/shmstore.py —
    slab allocator + LRU eviction, the plasma equivalent) when the native
    toolchain is available; the file-per-object layout below is the
    fallback and also serves as the layout spec.
    """

    def __init__(self, directory: str | Path, capacity_bytes: int | None = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        # Weak cache of views handed out by this process (avoids
        # re-mmap / re-pin on repeat gets). Lifetime of the backing
        # memory is carried by the views themselves: file views keep
        # their mmap alive through the buffers' exporter chain, and pool
        # views attach the refcount pin to every exported buffer
        # (shmstore.PoolView), so a zero-copy deserialized value keeps
        # its block pinned exactly as long as the value is alive — and
        # no longer. A strong cache here would pin every object a
        # long-lived worker ever read, making the pool unspillable.
        import weakref

        self._views: "weakref.WeakValueDictionary[ObjectID, object]" = (
            weakref.WeakValueDictionary()
        )
        from ray_tpu_torch._private import config

        self.pool = None
        if not config.get("DISABLE_NATIVE_STORE"):
            try:
                from ray_tpu_torch._native.shmstore import ShmPool

                self.pool = ShmPool(
                    str(self.dir / "pool"), _pool_capacity(self.dir)
                )
            except Exception as e:  # noqa: BLE001 - fall back to file store
                import logging

                logger = logging.getLogger("ray_tpu_torch")
                logger.warning(
                    "native shared-memory pool unavailable (%s: %s); "
                    "falling back to the file-per-object store",
                    type(e).__name__,
                    e,
                )
                self.pool = None
        # Spill directory on DISK (shm is RAM): cold objects move here
        # under memory pressure and are served back transparently
        # (reference: LocalObjectManager spills to external storage via
        # io workers, local_object_manager.h:44). Every process of the
        # session derives the same path from the store dir name.
        self.spill_dir = Path(
            config.get("SPILL_DIR")
            or os.path.join(
                tempfile.gettempdir(), f"{self.dir.name}-spill"
            )
        )
        self.capacity_bytes = (
            capacity_bytes
            or (self.pool.capacity_bytes() if self.pool is not None else 0)
            or _pool_capacity(self.dir)
        )

    def _path(self, object_id: ObjectID) -> Path:
        return self.dir / object_id.hex()

    def put(self, object_id: ObjectID, data: Serialized) -> int:
        """Create + seal in one step. Returns bytes written."""
        if self.pool is not None:
            try:
                return self.pool.put(
                    object_id.binary(), data.materialize_buffers()
                )
            except MemoryError:
                pass  # over-capacity object: fall through to a file
        path = self._path(object_id)
        if path.exists():
            return path.stat().st_size  # immutable: double-put is a no-op
        return _write_object_file(path, data.inband, data.buffers)

    def get(self, object_id: ObjectID):
        view = self._views.get(object_id)
        if view is not None:
            return view
        if self.pool is not None:
            pv = self.pool.get(object_id.binary())
            if pv is not None:
                self._views[object_id] = pv
                return pv
        view = self._map_file(self._path(object_id))
        if view is None:
            # Spilled to disk: serve from the spill file (mmap'd; the
            # page cache amortizes repeat reads). Reference restores to
            # plasma via io workers, local_object_manager.h:44.
            view = self._map_file(self._spill_path(object_id))
        if view is not None:
            self._views[object_id] = view
        return view

    def _map_file(self, path: Path):
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            return None
        try:
            size = os.fstat(fd).st_size
            mapping = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        return PlasmaView(mapping)

    def release(self, object_id: ObjectID) -> None:
        """Drop this process's cached mmap view (serving paths that touch
        many objects must not pin every mapping forever)."""
        self._views.pop(object_id, None)

    def contains(self, object_id: ObjectID) -> bool:
        if object_id in self._views or self._path(object_id).exists():
            return True
        if self.pool is not None and self.pool.contains(object_id.binary()):
            return True
        return self._spill_path(object_id).exists()

    def delete(self, object_id: ObjectID) -> None:
        self._views.pop(object_id, None)
        if self.pool is not None:
            self.pool.delete(object_id.binary())
        for path in (self._path(object_id), self._spill_path(object_id)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    # ---------------------------------------------------------- spilling
    def _spill_path(self, object_id: ObjectID) -> Path:
        return self.spill_dir / object_id.hex()

    def spill_candidates(self) -> list[tuple[ObjectID, int, float]]:
        """(object_id, size, lru_key) for spillable objects, coldest
        first. Pool objects rank by the pool's LRU tick; file-backed
        objects by mtime (both orderings are per-source; the merged list
        interleaves them, which is fine for a watermark loop)."""
        out = []
        if self.pool is not None:
            for id_bytes, size, lru in self.pool.scan():
                try:
                    out.append((ObjectID(id_bytes), size, float(lru)))
                except ValueError:
                    continue
            out.sort(key=lambda t: t[2])
        files = []
        for name, size in self.list_objects():
            try:
                oid = ObjectID.from_hex(name)
            except ValueError:
                continue
            try:
                mtime = self._path(oid).stat().st_mtime
            except OSError:
                continue
            files.append((oid, size, mtime))
        files.sort(key=lambda t: t[2])
        # Pool ticks and mtimes are different clocks: each group is
        # coldest-first internally; pool entries go first (they are the
        # allocator under pressure), file entries after.
        return out + files

    def spill_one(self, object_id: ObjectID) -> int:
        """Move one sealed object to the disk spill dir. Returns shm
        bytes freed (0 if the object was busy or already gone)."""
        spill_path = self._spill_path(object_id)
        if spill_path.exists():
            freed = self._drop_shm_copy(object_id)
            return freed
        shm_path = self._path(object_id)
        if shm_path.exists():
            # File-backed: copy to a temp name, atomic-rename into the
            # spill dir, then drop the shm copy. Readers racing this see
            # either copy (both sealed + immutable).
            self.spill_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.spill_dir, prefix=".spill-")
            try:
                with os.fdopen(fd, "wb") as dst, open(shm_path, "rb") as src:
                    import shutil

                    shutil.copyfileobj(src, dst)
                os.rename(tmp, spill_path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            return self._drop_shm_copy(object_id)
        if self.pool is not None:
            view = self.pool.get(object_id.binary())
            if view is None:
                return 0
            self.spill_dir.mkdir(parents=True, exist_ok=True)
            _write_object_file(spill_path, view.inband, view.buffers)
            del view  # release the pool pin before deleting
            # Report what was ACTUALLY freed: a reader pinning the
            # object between scan and delete leaves the shm copy in
            # place (the spill file is a harmless duplicate) — the next
            # watermark tick retries.
            return self._drop_shm_copy(object_id)
        return 0

    def _drop_shm_copy(self, object_id: ObjectID) -> int:
        """Remove the shm copy of an object that has a spill file."""
        freed = 0
        if self.pool is not None and self.pool.contains(object_id.binary()):
            before = self.pool.used_bytes()
            self.pool.delete(object_id.binary())
            freed = max(0, before - self.pool.used_bytes())
        path = self._path(object_id)
        try:
            size = path.stat().st_size
            os.unlink(path)
            freed += size
        except OSError:
            pass
        # A stale read-only view in THIS process keeps serving safely
        # (unlinked files stay mapped), but drop it so memory frees.
        self._views.pop(object_id, None)
        return freed

    def iter_ids(self) -> list[ObjectID]:
        """Every object resident in this store — pool, file-backed, and
        spilled copies. This is the drain-evacuation sweep's work list:
        anything here is a primary some consumer may still resolve to."""
        seen: set[ObjectID] = set()
        if self.pool is not None:
            for id_bytes, _size, _lru in self.pool.scan():
                try:
                    seen.add(ObjectID(id_bytes))
                except ValueError:
                    continue
        for name, _size in self.list_objects():
            try:
                seen.add(ObjectID.from_hex(name))
            except ValueError:
                continue
        if self.spill_dir.exists():
            for p in self.spill_dir.iterdir():
                try:
                    seen.add(ObjectID.from_hex(p.name))
                except ValueError:
                    continue
        return sorted(seen, key=lambda o: o.hex())

    def list_objects(self) -> list[tuple[str, int]]:
        """(object_id hex, size) pairs. Best-effort: covers the
        file-backed objects; the native pool does not expose a scan."""
        out = []
        for p in self.dir.iterdir():
            # Skip the pool file and in-flight temp files from concurrent
            # put()s; an entry may also vanish between iterdir and stat.
            if not all(c in "0123456789abcdef" for c in p.name):
                continue
            try:
                if p.is_file():
                    out.append((p.name, p.stat().st_size))
            except OSError:
                continue
        return out

    def used_bytes(self) -> int:
        pool = self.pool.used_bytes() if self.pool is not None else 0
        return pool + sum(
            p.stat().st_size
            for p in self.dir.iterdir()
            if p.is_file() and p.name != "pool"
        )

    def destroy(self) -> None:
        self._views.clear()
        if self.pool is not None:
            self.pool.destroy()
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)
        shutil.rmtree(self.spill_dir, ignore_errors=True)


def _write_object_file(path: Path, inband, buffers) -> int:
    """Write the sealed-object file layout (header + inband + aligned
    buffers) with create-then-atomic-rename sealing. Returns total bytes."""
    header = _HEADER.pack(_MAGIC, len(inband), len(buffers))
    lens = b"".join(_LEN.pack(len(b)) for b in buffers)
    meta_len = len(header) + len(lens)

    total = _aligned(meta_len + len(inband))
    for b in buffers:
        total = _aligned(total + len(b))
    total = max(total, 1)

    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".create-")
    try:
        os.ftruncate(fd, total)
        with mmap.mmap(fd, total) as m:
            m[: len(header)] = header
            off = len(header)
            m[off : off + len(lens)] = lens
            off += len(lens)
            m[off : off + len(inband)] = bytes(inband)
            off = _aligned(off + len(inband))
            for b in buffers:
                m[off : off + len(b)] = (
                    b if isinstance(b, (bytes, memoryview)) else bytes(b)
                )
                off = _aligned(off + len(b))
        os.close(fd)
        os.rename(tmp, path)  # seal
    except BaseException:
        os.close(fd) if fd >= 0 else None
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return total


def segment_meta(view) -> dict:
    """Segment layout of a serialized object view (chunked-pull meta)."""
    seg_lens = [len(view.inband)] + [len(b) for b in view.buffers]
    return {"ok": True, "seg_lens": seg_lens, "total": sum(seg_lens)}


def segment_window(view, offset: int, size: int) -> bytes:
    """One window of the logical byte stream (inband ++ buffers), sliced
    without copying the parts outside the window."""
    out = bytearray()
    pos = 0
    for seg in [view.inband, *view.buffers]:
        seg_len = len(seg)
        if offset < pos + seg_len and len(out) < size:
            start = max(0, offset - pos)
            take = min(seg_len - start, size - len(out))
            out += memoryview(seg)[start : start + take]
        pos += seg_len
        if len(out) >= size:
            break
    return bytes(out)


def _pool_capacity(directory: Path) -> int:
    from ray_tpu_torch._private import config

    override = config.get("POOL_BYTES")
    if override:
        return int(override)
    try:
        st = os.statvfs(directory)
        free = st.f_bavail * st.f_frsize
    except OSError:
        free = 4 << 30
    # Reference sizes plasma at 30% of system memory by default
    # (ray_config_def.h object_store defaults); cap at 2 GiB here.
    return max(64 << 20, min(2 << 30, int(free * 0.3)))


def default_store_dir(session: str) -> str:
    base = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    return os.path.join(base, f"ray_tpu_torch-{session}")
