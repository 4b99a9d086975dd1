"""Remote spill tier: cross-cluster durability for committed checkpoints.

In-cluster replication and erasure coding survive node and slice loss;
they do not survive "the cluster is gone" (full preemption, region
outage, a deleted TPU pool). The remote tier is the last rung of the
restore ladder — head manifest → in-cluster peers → remote — and the
backing store for `ray_tpu_torch ckpt push/pull`, which makes a checkpoint an
explicit portable artifact (the LocalObjectManager external-storage
spill idea applied to the checkpoint plane).

Backends implement the small ``RemoteTier`` protocol. ``FileTier`` (any
mounted path — NFS, a persistent disk, a tmpdir in tests) is the real,
working backend; ``GcsTier`` is the GCS-shaped stub that activates only
when the cloud SDK is importable, so the wire format is pinned without
adding a dependency.

Every call is deadline-bounded (CKPT_REMOTE_TIMEOUT_S) and failures are
the typed ``RemoteTierError`` — a dead or slow tier degrades saves to
in-cluster-only with a lag alert; it can never hang a save or a restore.
The RAY_TPU_REMOTE_TIER_FAIL chaos knob ('outage' | 'latency:<s>')
injects exactly those failures to prove it.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import tempfile
import time

logger = logging.getLogger(__name__)


class RemoteTierError(Exception):
    """Typed failure of a remote-tier operation (outage, timeout,
    backend error). Callers degrade; they never see a raw hang."""


class FileTier:
    """Directory-backed tier: ``chunks/<hash>`` plus
    ``manifests/<run>/<step>.r<rank>.json``. Writes are
    tmp-file + rename so a torn upload is never visible."""

    scheme = "file"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "chunks"), exist_ok=True)
        os.makedirs(os.path.join(root, "manifests"), exist_ok=True)
        os.makedirs(os.path.join(root, "objects"), exist_ok=True)

    def _chunk_path(self, hex_hash: str) -> str:
        return os.path.join(self.root, "chunks", hex_hash)

    def _manifest_path(self, run: str, step: int, rank: int) -> str:
        return os.path.join(
            self.root, "manifests", run, f"{int(step):012d}.r{rank}.json"
        )

    def _write_atomic(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # ------------------------------------------------------------ chunks
    def has_chunk(self, hex_hash: str) -> bool:
        return os.path.exists(self._chunk_path(hex_hash))

    def put_chunk(self, hex_hash: str, data: bytes) -> None:
        if not self.has_chunk(hex_hash):
            self._write_atomic(self._chunk_path(hex_hash), bytes(data))

    def get_chunk(self, hex_hash: str) -> bytes | None:
        try:
            with open(self._chunk_path(hex_hash), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    # --------------------------------------------------------- manifests
    def put_manifest(self, run: str, step: int, rank: int, doc: dict):
        self._write_atomic(
            self._manifest_path(run, step, rank),
            json.dumps(doc).encode(),
        )

    def get_manifest(self, run: str, step: int, rank: int) -> dict | None:
        try:
            with open(self._manifest_path(run, step, rank)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def list_steps(self, run: str) -> dict[int, list[int]]:
        """step → sorted ranks present (completeness is judged against
        the world size recorded inside the manifests)."""
        d = os.path.join(self.root, "manifests", run)
        out: dict[int, list[int]] = {}
        try:
            names = os.listdir(d)
        except FileNotFoundError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            stem = name[: -len(".json")]
            step_s, _, rank_s = stem.partition(".r")
            try:
                out.setdefault(int(step_s), []).append(int(rank_s))
            except ValueError:
                continue
        return {s: sorted(rs) for s, rs in out.items()}

    # ------------------------------------------- general objects (drain)
    def put_object(self, oid_hex: str, data: bytes) -> None:
        self._write_atomic(
            os.path.join(self.root, "objects", oid_hex), bytes(data)
        )

    def get_object(self, oid_hex: str) -> bytes | None:
        try:
            with open(os.path.join(self.root, "objects", oid_hex), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None


class GcsTier(FileTier):
    """GCS-shaped stub: same layout keyed under gs://bucket/prefix. The
    real client is imported lazily; without the SDK baked into the image
    the constructor raises a typed error instead of half-working."""

    scheme = "gs"

    def __init__(self, uri: str):
        try:
            from google.cloud import storage  # noqa: F401
        except ImportError as e:
            raise RemoteTierError(
                f"CKPT_REMOTE_TIER={uri!r} needs google-cloud-storage, "
                "which this image does not bundle — use a mounted path "
                "(FileTier) or bake the SDK in"
            ) from e
        raise RemoteTierError(
            "GcsTier upload client not implemented in this build"
        )


class _ChaosTier:
    """REMOTE_TIER_FAIL wrapper: 'outage' raises on every call,
    'latency:<s>' sleeps first (the deadline then converts long sleeps
    into timeouts — exactly the slow-backend failure mode)."""

    def __init__(self, inner, spec: str):
        self._inner = inner
        self._spec = spec

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr
        spec = self._spec

        def chaoticed(*a, **kw):
            mode, _, arg = spec.partition(":")
            if mode == "outage":
                raise RemoteTierError(
                    f"remote tier outage (chaos) during {name}"
                )
            if mode == "latency":
                time.sleep(float(arg or 1.0))
            return attr(*a, **kw)

        return chaoticed


class _BoundedTier:
    """Deadline wrapper: every tier call runs on a worker thread with a
    CKPT_REMOTE_TIMEOUT_S budget; overruns and backend exceptions both
    surface as RemoteTierError. The thread is shared and lazily built —
    remote uploads already happen off the step loop."""

    def __init__(self, inner):
        self._inner = inner
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-remote"
        )

    @property
    def scheme(self) -> str:
        return self._inner.scheme

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        def bounded(*a, **kw):
            from ray_tpu_torch._private import config

            deadline = float(config.get("CKPT_REMOTE_TIMEOUT_S"))
            fut = self._pool.submit(attr, *a, **kw)
            try:
                return fut.result(timeout=deadline)
            except concurrent.futures.TimeoutError:
                fut.cancel()
                raise RemoteTierError(
                    f"remote tier {name} exceeded {deadline}s deadline"
                ) from None
            except RemoteTierError:
                raise
            except Exception as e:  # noqa: BLE001 - typed boundary
                raise RemoteTierError(
                    f"remote tier {name} failed: {e!r}"
                ) from e

        return bounded


_cached: tuple[str, object] | None = None


def get_tier(spec: str | None = None):
    """Resolve CKPT_REMOTE_TIER to a deadline-bounded tier (None when
    unset). '' → None; 'gs://…' → GcsTier; anything else (plain path or
    file:// URI) → FileTier. The chaos wrapper applies INSIDE the
    deadline so injected latency is bounded like real latency."""
    global _cached
    from ray_tpu_torch._private import config

    raw = spec if spec is not None else str(config.get("CKPT_REMOTE_TIER"))
    raw = (raw or "").strip()
    if not raw:
        return None
    chaos = str(config.get("REMOTE_TIER_FAIL") or "").strip()
    key = f"{raw}|{chaos}"
    if _cached is not None and _cached[0] == key:
        return _cached[1]
    if raw.startswith("gs://"):
        inner = GcsTier(raw)
    else:
        path = raw[len("file://"):] if raw.startswith("file://") else raw
        inner = FileTier(path)
    if chaos:
        inner = _ChaosTier(inner, chaos)
    tier = _BoundedTier(inner)
    _cached = (key, tier)
    return tier


def reset_tier_cache() -> None:
    """Test hook: drop the resolved-tier cache after config changes."""
    global _cached
    _cached = None


# General-object framing: a spilled/evacuated object is the logical
# segment stream (inband ++ buffers) plus its segment lengths, packed
# into one blob so any tier backend stays a dumb byte store.
def pack_object(seg_lens: list[int], payload: bytes) -> bytes:
    import struct

    header = json.dumps([int(n) for n in seg_lens]).encode()
    return struct.pack(">I", len(header)) + header + payload


def unpack_object(blob: bytes) -> tuple[list[int], bytes]:
    import struct

    (hlen,) = struct.unpack_from(">I", blob, 0)
    seg_lens = json.loads(blob[4 : 4 + hlen].decode())
    return [int(n) for n in seg_lens], blob[4 + hlen:]


# ------------------------------------------------------------ push / pull
def push_checkpoint(
    run: str, step: int | None = None, tier=None
) -> dict:
    """Copy a committed checkpoint (newest complete step by default)
    from the cluster to the remote tier — the explicit `ray_tpu_torch ckpt
    push` path for making a checkpoint portable before teardown."""
    # NOTE: the package re-exports restore() the FUNCTION as
    # `ray_tpu_torch.checkpoint.restore`; import the helper by symbol.
    from ray_tpu_torch.checkpoint.restore import _fetch_chunks
    from ray_tpu_torch.checkpoint.saver import _runtime

    tier = tier or get_tier()
    if tier is None:
        raise RemoteTierError("no remote tier configured (CKPT_REMOTE_TIER)")
    rt = _runtime()
    reply = rt.run(
        rt.core.head.call("ckpt_manifest", run=run, step=step)
    )
    if not reply.get("ok"):
        raise RemoteTierError(reply.get("error", "no manifest"))
    entries = reply["entries"]
    parity = reply.get("parity", [])
    from ray_tpu_torch.checkpoint.manifest import manifest_chunks

    hashes = sorted(manifest_chunks(entries))
    chunks = rt.run(
        _fetch_chunks(
            rt, hashes, reply.get("locations", {}), parity=parity
        )
    )
    # Parity shards ride along best-effort: a lost parity chunk must not
    # block the push (the data is whole — the head's repair loop can
    # re-encode parity later), it just ships less redundancy.
    from ray_tpu_torch.checkpoint.manifest import parity_chunks as _pchunks
    from ray_tpu_torch.exceptions import ObjectLostError

    for ph in sorted(_pchunks(parity)):
        try:
            pdata = rt.run(
                _fetch_chunks(
                    rt, [ph], reply.get("locations", {})
                )
            )
            chunks.update(pdata)
        except ObjectLostError:
            logger.warning(
                "push: parity chunk %s… unavailable in-cluster; "
                "pushing without it", ph[:12]
            )
    uploaded = 0
    for h, data in chunks.items():
        if not tier.has_chunk(h):
            tier.put_chunk(h, data)
            uploaded += 1
    # One merged world=1 manifest: pull needs no knowledge of the
    # original rank layout (the shards keep their index specs).
    tier.put_manifest(
        run,
        int(reply["step"]),
        0,
        {
            "run": run,
            "step": int(reply["step"]),
            "rank": 0,
            "world": 1,
            "entries": list(entries.values()),
            "parity": parity,
            "metrics": {},
            "ts": time.time(),
        },
    )
    return {
        "ok": True,
        "run": run,
        "step": int(reply["step"]),
        "chunks": len(hashes),
        "uploaded": uploaded,
    }


def pull_checkpoint(
    run: str, step: int | None = None, tier=None
) -> dict:
    """Re-seed the cluster from the remote tier: insert every chunk into
    the local shard store and commit the manifest(s) to the head — after
    this, restore() works exactly as if the checkpoint had been saved
    in-cluster (the 'cluster was gone' recovery path)."""
    from ray_tpu_torch.checkpoint.manifest import manifest_chunks
    from ray_tpu_torch.checkpoint.saver import _runtime
    from ray_tpu_torch.checkpoint.store import ShardStore

    tier = tier or get_tier()
    if tier is None:
        raise RemoteTierError("no remote tier configured (CKPT_REMOTE_TIER)")
    rt = _runtime()
    steps = tier.list_steps(run)
    if not steps:
        raise RemoteTierError(f"remote tier has no checkpoints for {run!r}")
    pick = int(step) if step is not None else max(steps)
    if pick not in steps:
        raise RemoteTierError(f"remote tier has no step {pick} for {run!r}")
    docs = [
        tier.get_manifest(run, pick, r)
        for r in steps[pick]
    ]
    docs = [d for d in docs if d is not None]
    world = max((int(d.get("world", 1)) for d in docs), default=1)
    if not docs or {int(d["rank"]) for d in docs} < set(range(world)):
        raise RemoteTierError(
            f"remote manifest set for {run!r} step {pick} is incomplete"
        )
    from ray_tpu_torch.checkpoint.manifest import parity_chunks as _pchunks

    store = ShardStore(rt.core.store)
    own_addr = rt.core.node_addr or rt.core.addr
    inserted = 0
    total = 0
    locations: dict[str, list[str]] = {}
    for doc in docs:
        parity_hs = _pchunks(doc.get("parity"))
        for h in sorted(
            manifest_chunks(doc["entries"]) | parity_hs
        ):
            if h in locations:
                continue
            if store.has_chunk(h):
                total += 1
                locations[h] = [own_addr]
                continue
            data = tier.get_chunk(h)
            if data is None:
                if h in parity_hs:
                    # Parity is redundancy, not state: a tier missing a
                    # parity shard still yields a usable checkpoint (the
                    # head's repair loop re-encodes it in-cluster).
                    logger.warning(
                        "pull: parity chunk %s… missing from the remote "
                        "tier; head repair will re-encode it", h[:12]
                    )
                    continue
                raise RemoteTierError(
                    f"remote tier missing chunk {h[:12]} for {run!r} "
                    f"step {pick}"
                )
            store.put_chunk(h, data)
            inserted += 1
            total += 1
            locations[h] = [own_addr]
    for doc in docs:
        rt.run(
            rt.core.head.call(
                "ckpt_commit",
                run=run,
                step=pick,
                rank=int(doc["rank"]),
                world=int(doc.get("world", 1)),
                entries=doc["entries"],
                parity=doc.get("parity", []),
                locations=locations,
                metrics=doc.get("metrics", {}),
            )
        )
    return {
        "ok": True,
        "run": run,
        "step": pick,
        "chunks": total,
        "inserted": inserted,
    }
