"""Content-addressed chunk layer over the per-node object store.

Checkpoint bytes are split into fixed-size chunks and keyed by content
hash (sha256, truncated to the ObjectID width), so the store
deduplicates by construction: a leaf that didn't change between
consecutive checkpoints (embedding tables, frozen layers, optimizer
slots that didn't update) re-produces the same hashes and writes zero
new bytes. Chunks live in the SAME node object store that task results
use (`runtime/object_store.py`), so the existing serving RPCs
(get_object_meta / get_object_chunk), the pull/transfer path, and the
spill-to-disk machinery all apply to checkpoint data for free.
"""

from __future__ import annotations

import hashlib
import logging

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import Serialized
from ray_tpu_torch.util.metrics import Counter

logger = logging.getLogger(__name__)

CORRUPT_CHUNKS = Counter(
    "ray_tpu_ckpt_corrupt_chunks_total",
    "checkpoint chunks whose stored bytes failed the content-hash check",
)

# Chunk keys are truncated sha256 digests widened to the ObjectID wire
# format so every existing object RPC can carry them.
CHUNK_HEX_LEN = ObjectID.LENGTH * 2

# In-cluster checkpoints are addressed by URI, not directory: the train
# resume plumbing (latest_checkpoint strings) carries these through
# unchanged call sites.
CKPT_URI_PREFIX = "ckpt://"


def is_ckpt_uri(path) -> bool:
    return isinstance(path, str) and path.startswith(CKPT_URI_PREFIX)


def make_uri(run: str, step: int) -> str:
    return f"{CKPT_URI_PREFIX}{run}/{int(step)}"


def parse_uri(uri: str) -> tuple[str, int]:
    if not is_ckpt_uri(uri):
        raise ValueError(f"not a checkpoint uri: {uri!r}")
    run, _, step = uri[len(CKPT_URI_PREFIX):].rpartition("/")
    return run, int(step)


def chunk_hash(data) -> str:
    return hashlib.sha256(data).hexdigest()[:CHUNK_HEX_LEN]


def chunk_oid(hex_hash: str) -> ObjectID:
    return ObjectID.from_hex(hex_hash)


def default_chunk_bytes() -> int:
    from ray_tpu_torch._private import config

    return int(config.get("CKPT_CHUNK_BYTES"))


def _maybe_corrupt(hex_hash: str, data: bytes) -> bytes:
    """Chaos hook: CKPT_CORRUPT='prefix:prob' flips a byte in matching
    chunks. The decision is a deterministic hash of the chunk id, so a
    corrupted chunk stays corrupted across retries — the reader can
    never win by re-reading, only by reconstructing."""
    from ray_tpu_torch._private import config

    spec = config.get("CKPT_CORRUPT")
    if not spec:
        return data
    prefix, _, prob = spec.partition(":")
    if prefix and not hex_hash.startswith(prefix):
        return data
    die = int(hashlib.sha256(("corrupt:" + hex_hash).encode()).hexdigest()[:8], 16)
    if die / 0xFFFFFFFF >= float(prob or 1.0):
        return data
    buf = bytearray(data)
    if buf:
        buf[len(buf) // 2] ^= 0xFF
    return bytes(buf)


class ShardStore:
    """Thin content-addressed facade over one node's ObjectStore."""

    def __init__(self, store):
        self._store = store

    def put_bytes(
        self, data, chunk_bytes: int | None = None
    ) -> tuple[list[str], int]:
        """Write ``data`` (bytes/memoryview) as content-addressed chunks.
        Returns ``(chunk_hashes, new_bytes)`` where new_bytes counts only
        chunks that were not already present (the dedup ledger)."""
        n = chunk_bytes or default_chunk_bytes()
        mv = memoryview(data).cast("B")
        hashes: list[str] = []
        new_bytes = 0
        for off in range(0, max(1, len(mv)), n):
            piece = mv[off : off + n]
            h = chunk_hash(piece)
            hashes.append(h)
            oid = chunk_oid(h)
            if not self._store.contains(oid):
                new_bytes += self._store.put(
                    oid, Serialized(bytes(piece), [])
                )
        return hashes, new_bytes

    def has_chunk(self, hex_hash: str) -> bool:
        return self._store.contains(chunk_oid(hex_hash))

    def get_chunk(self, hex_hash: str) -> bytes | None:
        from ray_tpu_torch._private import config

        oid = chunk_oid(hex_hash)
        view = self._store.get(oid)
        if view is None:
            return None
        try:
            data = bytes(view.inband)
        finally:
            # Checkpoint restores touch thousands of chunks; pinning
            # every mmap would hold the whole checkpoint in shm.
            self._store.release(oid)
        data = _maybe_corrupt(hex_hash, data)
        if config.get("CKPT_VERIFY_READS") and chunk_hash(data) != hex_hash:
            # Bit rot (or the chaos knob above). A corrupt local copy is
            # indistinguishable from a missing one to callers: they fall
            # through to peers / parity reconstruction, which re-caches a
            # good copy over this one.
            CORRUPT_CHUNKS.inc()
            logger.warning("ckpt chunk %s failed content-hash check; "
                           "treating as missing", hex_hash[:12])
            return None
        return data

    def put_chunk(self, hex_hash: str, data: bytes) -> int:
        oid = chunk_oid(hex_hash)
        if self._store.contains(oid):
            return 0
        return self._store.put(oid, Serialized(bytes(data), []))

    def delete_chunk(self, hex_hash: str) -> None:
        self._store.delete(chunk_oid(hex_hash))
