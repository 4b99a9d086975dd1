"""Shared-memory channels for compiled graphs.

The reference's compiled-graph transport on one node is a *mutable plasma
object*: a fixed shared-memory slot with write-acquire / read-release
semantics (reference: src/ray/core_worker/experimental_mutable_object_manager.h:44,
python/ray/experimental/channel/shared_memory_channel.py). The TPU-native
equivalent keeps the idea but is a lock-free single-writer / multi-reader
ring over one mmap'd file in the node's /dev/shm session directory: the
writer publishes by bumping a 64-bit write counter; each reader owns a
64-bit read counter; backpressure = the writer waits while
``write_count - min(read_counts) == nslots``. Payloads that exceed the
slot capacity spill to a side file whose name is embedded in the slot
(the analogue of plasma's fallback allocation).

No daemons, no locks: on x86/ARM64 the aligned 8-byte counter stores are
single machine stores and the payload is written strictly before the
counter bump (TSO / release ordering is sufficient for SPMC here).
"""

from __future__ import annotations

import mmap
import os
import struct
import time

from ray_tpu_torch._private.serialization import deserialize, serialize

_MAGIC = 0x5254_5055_4348_414E  # "RTPUCHAN"
# header: magic u64 | nslots u32 | n_readers u32 | capacity u64 | closed u64
_HEADER = struct.Struct("<QIIQQ")
_U64 = struct.Struct("<Q")
# per-slot record header: data_len u64 | spill u32 | pad u32
_SLOT = struct.Struct("<QII")
_ALIGN = 64

DEFAULT_CAPACITY = 256 * 1024
DEFAULT_NSLOTS = 8


class ChannelClosed(Exception):
    """Raised by read/write after the peer has torn the channel down."""


class ChannelTimeout(Exception):
    pass


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class _Wait:
    """Spin-then-sleep poll loop (the hot path is the spin: same-host
    handoff latency stays in the microseconds)."""

    __slots__ = ("spins", "deadline")

    def __init__(self, timeout: float | None):
        self.spins = 0
        self.deadline = None if timeout is None else time.monotonic() + timeout

    def step(self):
        self.spins += 1
        if self.spins < 200:
            pass  # pure spin
        elif self.spins < 1000:
            time.sleep(0)
        else:
            time.sleep(0.0002)
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise ChannelTimeout("channel wait timed out")


class ShmChannel:
    """One file = one channel. The creating side picks geometry; writer
    and readers both ``open`` it by path. ``rank`` selects the reader
    cursor; the writer passes ``rank=None``.
    """

    def __init__(
        self,
        path: str,
        *,
        writer: bool,
        rank: int | None = None,
        create: bool = False,
        n_readers: int = 1,
        nslots: int = DEFAULT_NSLOTS,
        capacity: int = DEFAULT_CAPACITY,
    ):
        self.path = path
        self.writer = writer
        self.rank = rank
        if create:
            self._create(n_readers, nslots, capacity)
        self._open()

    # ------------------------------------------------------------ layout
    def _create(self, n_readers: int, nslots: int, capacity: int):
        slot_stride = _aligned(_SLOT.size + capacity)
        counters_off = _aligned(_HEADER.size)
        slots_off = _aligned(counters_off + 8 * (1 + n_readers))
        total = slots_off + nslots * slot_stride
        tmp = f"{self.path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.truncate(total)
            f.seek(0)
            f.write(_HEADER.pack(_MAGIC, nslots, n_readers, capacity, 0))
        os.rename(tmp, self.path)

    def _open(self):
        wait = _Wait(timeout=30.0)
        while not os.path.exists(self.path):
            wait.step()
        fd = os.open(self.path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            self._m = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        magic, nslots, n_readers, capacity, _ = _HEADER.unpack_from(self._m, 0)
        if magic != _MAGIC:
            raise ValueError(f"not a channel file: {self.path}")
        self.nslots = nslots
        self.n_readers = n_readers
        self.capacity = capacity
        self._counters_off = _aligned(_HEADER.size)
        self._slots_off = _aligned(self._counters_off + 8 * (1 + n_readers))
        self._slot_stride = _aligned(_SLOT.size + capacity)
        # local cursor mirrors the shared one (cheap reads)
        self._count = self._read_u64(self._counters_off) if self.writer else (
            0 if self.rank is None else self._read_u64(self._reader_off(self.rank))
        )

    # ------------------------------------------------------- tiny atomics
    def _read_u64(self, off: int) -> int:
        return _U64.unpack_from(self._m, off)[0]

    def _write_u64(self, off: int, value: int):
        _U64.pack_into(self._m, off, value)

    def _reader_off(self, rank: int) -> int:
        return self._counters_off + 8 * (1 + rank)

    @property
    def _write_count(self) -> int:
        return self._read_u64(self._counters_off)

    @property
    def closed(self) -> bool:
        return _HEADER.unpack_from(self._m, 0)[4] != 0

    def close(self):
        """Mark closed; blocked peers wake up and raise ChannelClosed."""
        header = list(_HEADER.unpack_from(self._m, 0))
        header[4] = 1
        _HEADER.pack_into(self._m, 0, *header)

    def destroy(self):
        self.close()
        try:
            self._m.close()
        except BufferError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass

    # ------------------------------------------------------------- write
    def _min_read_count(self) -> int:
        return min(
            self._read_u64(self._reader_off(r)) for r in range(self.n_readers)
        )

    def write(self, value, timeout: float | None = None):
        if not self.writer:
            raise RuntimeError("read end of channel cannot write")
        blob = _pack(value)
        count = self._count
        wait = _Wait(timeout)
        while count - self._min_read_count() >= self.nslots:
            if self.closed:
                raise ChannelClosed(self.path)
            wait.step()
        if self.closed:
            raise ChannelClosed(self.path)
        slot_off = self._slots_off + (count % self.nslots) * self._slot_stride
        old_spill = self._spill_path(count - self.nslots)
        if os.path.exists(old_spill):
            os.unlink(old_spill)
        if len(blob) <= self.capacity:
            _SLOT.pack_into(self._m, slot_off, len(blob), 0, 0)
            self._m[
                slot_off + _SLOT.size : slot_off + _SLOT.size + len(blob)
            ] = blob
        else:
            spill = self._spill_path(count)
            tmp = spill + ".w"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.rename(tmp, spill)
            _SLOT.pack_into(self._m, slot_off, 0, 1, 0)
        self._count = count + 1
        self._write_u64(self._counters_off, self._count)  # publish

    def _spill_path(self, count: int) -> str:
        return f"{self.path}.sp{count % (2 * self.nslots)}"

    # -------------------------------------------------------------- read
    def read(self, timeout: float | None = None):
        if self.writer or self.rank is None:
            raise RuntimeError("write end of channel cannot read")
        count = self._count
        wait = _Wait(timeout)
        while self._write_count <= count:
            if self.closed:
                raise ChannelClosed(self.path)
            wait.step()
        slot_off = self._slots_off + (count % self.nslots) * self._slot_stride
        data_len, spill, _ = _SLOT.unpack_from(self._m, slot_off)
        if spill:
            with open(self._spill_path(count), "rb") as f:
                blob = f.read()
        else:
            blob = bytes(
                self._m[
                    slot_off + _SLOT.size : slot_off + _SLOT.size + data_len
                ]
            )
        value = _unpack(blob)
        self._count = count + 1
        self._write_u64(self._reader_off(self.rank), self._count)  # release
        return value


# ------------------------------------------------------- serialization
_BLOB = struct.Struct("<I")


def _pack(value) -> bytes:
    s = serialize(value).materialize_buffers()
    parts = [_BLOB.pack(len(s.buffers) + 1), _U64.pack(len(s.inband)), s.inband]
    for b in s.buffers:
        parts.append(_U64.pack(len(b)))
        parts.append(bytes(b) if not isinstance(b, bytes) else b)
    return b"".join(parts)


def _unpack(blob: bytes):
    (n,) = _BLOB.unpack_from(blob, 0)
    off = _BLOB.size
    parts = []
    for _ in range(n):
        (length,) = _U64.unpack_from(blob, off)
        off += _U64.size
        parts.append(blob[off : off + length])
        off += length
    return deserialize(parts[0], parts[1:])


class IntraProcessChannel:
    """Driver-local channel (no shm needed): plain deque with the same
    read/write/close surface, used when producer and consumer share a
    process (reference: channel/intra_process_channel.py)."""

    def __init__(self):
        from collections import deque

        self._q = deque()
        self._closed = False

    def write(self, value, timeout: float | None = None):
        if self._closed:
            raise ChannelClosed("intra-process channel closed")
        self._q.append(value)

    def read(self, timeout: float | None = None):
        wait = _Wait(timeout)
        while not self._q:
            if self._closed:
                raise ChannelClosed("intra-process channel closed")
            wait.step()
        return self._q.popleft()

    def close(self):
        self._closed = True
