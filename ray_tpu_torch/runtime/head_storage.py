"""Pluggable head-state persistence (GCS fault tolerance).

The reference backs its GCS tables with a storage abstraction —
in-memory or Redis (reference: gcs/store_client/redis_store_client.h:126,
gcs_table_storage.h:200) — so a head restart reloads cluster metadata
and nodes resubscribe (node_manager.proto:325 NotifyGCSRestart). The
TPU-native equivalent here is an append-only local journal: every
durable mutation (KV, actor registry, placement groups) appends one
pickled record; restart replays the journal and then compacts it to a
single snapshot record. No external service required — the journal file
on shared storage is the single-host analogue; the same interface admits
a Redis-protocol backend later.

Record format: length-prefixed pickle frames, `(table, op, payload)`.
A truncated tail (crash mid-append) is ignored on replay.
"""

from __future__ import annotations

import logging
import os
import pickle
import struct
import tempfile
from typing import Any, Iterator

logger = logging.getLogger("ray_tpu_torch.head")

_HDR = struct.Struct("<I")


class FileJournal:
    """Append-only journal with replay + snapshot compaction.

    ``fsync=True`` makes every append durable against power loss (the
    reference's Redis equivalent is appendfsync always); the default
    flush-only survives process crashes, which is the head-FT threat
    model. ``size_bytes`` lets the owner trigger ONLINE compaction when
    KV churn grows the file (reference: Redis AOF rewrite) — restart
    replay also compacts, but a long-lived head must not wait for one.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = None
        self.fsync = fsync
        # While an async compaction's file rewrite runs off-thread,
        # appends land here and are replayed into the new file — they
        # must not hit the old inode mid-rename.
        self._buffering: list | None = None
        self._side_f = None
        try:
            self._nbytes = os.path.getsize(path)
        except OSError:
            self._nbytes = 0

    @property
    def size_bytes(self) -> int:
        return self._nbytes

    @property
    def _sidecar_path(self) -> str:
        return self.path + ".compacting"

    # ------------------------------------------------------------ write
    def append(self, record: tuple) -> None:
        data = pickle.dumps(record, protocol=5)
        if self._buffering is not None:
            # Mid-compaction. The durability promise of the current
            # mode must hold even now: the record also lands in a
            # sidecar (flushed always, fsynced under fsync mode) that
            # replay() consumes if we crash before the post-compaction
            # merge — the in-memory buffer alone would silently demote
            # crash durability during every compaction window.
            self._buffering.append(data)
            if self._side_f is None:
                self._side_f = open(self._sidecar_path, "ab")
            self._side_f.write(_HDR.pack(len(data)) + data)
            self._side_f.flush()
            if self.fsync:
                os.fsync(self._side_f.fileno())
            self._nbytes += _HDR.size + len(data)
            return
        if self._f is None:
            self._f = open(self.path, "ab")
        self._f.write(_HDR.pack(len(data)) + data)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._nbytes += _HDR.size + len(data)

    # ------------------------------------------------------------- read
    def replay(self) -> Iterator[tuple]:
        """All intact records, oldest first; stops at a torn tail. A
        sidecar left by a crash mid-online-compaction replays after the
        main file (its records are strictly newer)."""
        for path in (self.path, self._sidecar_path):
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                while True:
                    hdr = f.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    (length,) = _HDR.unpack(hdr)
                    data = f.read(length)
                    if len(data) < length:
                        break  # torn append from a crash — discard
                    try:
                        yield pickle.loads(data)
                    except Exception:  # noqa: BLE001 - corrupt frame
                        logger.warning(
                            "journal replay stopped at a corrupt frame "
                            "(state up to this point is restored)"
                        )
                        break

    def compact(self, snapshot: Any) -> None:
        """Atomically replace the journal with one snapshot record."""
        self.close()
        self._write_snapshot(pickle.dumps(
            ("snapshot", "set", snapshot), protocol=5
        ))
        try:
            # Any crash-left sidecar is folded into this snapshot (the
            # caller replayed it); keeping it would double-apply.
            os.unlink(self._sidecar_path)
        except OSError:
            pass
        self._nbytes = os.path.getsize(self.path)

    def _write_snapshot(self, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".", prefix=".journal-"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(_HDR.pack(len(data)) + data)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    async def compact_async(self, snapshot: Any) -> None:
        """Online compaction: the snapshot write + fsync + rename run
        off-thread so the head's event loop keeps serving RPCs
        (reference: Redis rewrites the AOF in a forked child for the
        same reason). Concurrent appends buffer in memory and replay
        into the fresh file afterwards."""
        import asyncio

        if self._buffering is not None:
            return  # one at a time
        data = pickle.dumps(("snapshot", "set", snapshot), protocol=5)
        self.close()
        self._buffering = []
        try:
            await asyncio.to_thread(self._write_snapshot, data)
        finally:
            buffered, self._buffering = self._buffering, None
            if self._side_f is not None:
                self._side_f.close()
                self._side_f = None
            self._f = open(self.path, "ab")
            for rec in buffered:
                self._f.write(_HDR.pack(len(rec)) + rec)
            self._f.flush()
            if self.fsync and buffered:
                os.fsync(self._f.fileno())
            try:
                os.unlink(self._sidecar_path)
            except OSError:
                pass
            self._nbytes = os.path.getsize(self.path)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._side_f is not None:
            self._side_f.close()
            self._side_f = None
