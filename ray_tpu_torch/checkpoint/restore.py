"""Elastic resharded restore from the in-cluster shard store.

Restore resolves a committed manifest from the head, assembles each leaf
from whichever chunk replicas survive, and re-places the result onto
the CURRENT mesh via the ``shardings=`` pytree (parallel/sharding.py
NamedShardings: each rank keeps its slice of a DTensor) or the target's
own DTensor placements — so a run that saved from N workers resumes on
M (the elastic resume path) without any shared filesystem.

The resolution ladder per chunk, cheapest first:

1. ``have=`` fingerprint — the live tree's bytes hashed through the
   same chunker (differential restore: a warm restart pulls ~0 bytes),
2. local shard store,
3. surviving peer replicas (pipelined transfer path),
4. erasure reconstruction from ≥k surviving group members,
5. the remote spill tier (CKPT_REMOTE_TIER),

and only then ``ObjectLostError``. Chunks gained along the way are
cached locally and reported to the head's location table in one batch,
so the restoring node immediately serves peers and GC sees the replica.
"""

from __future__ import annotations

import asyncio
import logging

from ray_tpu_torch.checkpoint import erasure as _erasure
from ray_tpu_torch.checkpoint import manifest as _manifest
from ray_tpu_torch.checkpoint.saver import _runtime
from ray_tpu_torch.checkpoint.store import (
    ShardStore,
    chunk_hash,
    default_chunk_bytes,
    parse_uri,
)

logger = logging.getLogger("ray_tpu_torch.checkpoint")

_PULL_WINDOW = 8  # concurrent chunk pulls per restore

# Stats of the LAST restore in this process (tests pin differential
# restore's ~0-pull property on these; dashboards read them too).
last_restore_stats: dict = {}


def latest_step(run: str) -> int | None:
    """Newest COMPLETE checkpoint step for a run, or None."""
    rt = _runtime()
    reply = rt.run(rt.core.head.call("ckpt_list", run=run))
    steps = [
        c["step"]
        for c in reply.get("runs", {}).get(run, [])
        if c.get("complete")
    ]
    return max(steps) if steps else None


def list_checkpoints(run: str | None = None) -> dict:
    rt = _runtime()
    return rt.run(rt.core.head.call("ckpt_list", run=run))


async def _fetch_chunks(
    rt,
    hashes: list[str],
    locations: dict[str, list[str]],
    parity: list | None = None,
    known: dict[str, bytes] | None = None,
    stats: dict | None = None,
) -> dict[str, bytes]:
    """Resolve chunk bytes down the ladder: ``known`` (differential
    fingerprint hits) → local store → peer replicas → erasure
    reconstruction → remote tier → ObjectLostError."""
    from ray_tpu_torch.exceptions import ObjectLostError
    from ray_tpu_torch.runtime import transfer

    stats = stats if stats is not None else {}
    for k in (
        "total", "have_hits", "local", "pulled",
        "reconstructed", "remote_tier",
    ):
        stats.setdefault(k, 0)
    stats["total"] += len(hashes)
    shard_store = ShardStore(rt.core.store)
    out: dict[str, bytes] = {}
    missing: list[str] = []
    for h in hashes:
        if known is not None and h in known:
            out[h] = known[h]
            stats["have_hits"] += 1
            continue
        data = shard_store.get_chunk(h)
        if data is not None:
            out[h] = data
            stats["local"] += 1
        else:
            missing.append(h)
    gained: set[str] = set()
    if missing:
        conns: dict[str, object] = {}

        async def connect(addr: str):
            if addr in conns or addr == rt.core.node_addr:
                return conns.get(addr)
            try:
                conns[addr] = await rt.core._connect(addr)
            except Exception as e:  # noqa: BLE001 - dead holder: rest
                logger.debug(
                    "checkpoint holder %s unreachable: %r", addr, e
                )
                conns[addr] = None
            return conns[addr]

        for addr in {a for h in missing for a in locations.get(h, ())}:
            await connect(addr)
        sem = asyncio.Semaphore(_PULL_WINDOW)
        failed: list[str] = []

        async def pull(h: str):
            srcs = [
                conns[a]
                for a in locations.get(h, ())
                if conns.get(a) is not None
            ]
            if not srcs:
                failed.append(h)
                return
            try:
                async with sem:
                    inband, _buffers = await transfer.pull_object(h, srcs)
            except Exception as e:  # noqa: BLE001 - replicas died
                logger.debug("chunk pull %s failed: %r", h[:12], e)
                failed.append(h)
                return
            if chunk_hash(inband) != h:
                # A peer served corrupt bytes — same treatment as a
                # local hash mismatch: this replica does not count.
                logger.warning(
                    "chunk %s pulled from peer failed content-hash "
                    "check", h[:12],
                )
                failed.append(h)
                return
            out[h] = inband
            gained.add(h)
            stats["pulled"] += 1

        await asyncio.gather(*(pull(h) for h in missing))

        if failed and parity:
            group_of = _manifest.parity_group_index(parity)
            for h in list(failed):
                if h not in group_of:
                    continue
                data = await _reconstruct_chunk(
                    rt, h, group_of[h], out, locations, connect, sem
                )
                if data is not None:
                    out[h] = data
                    gained.add(h)
                    failed.remove(h)
                    stats["reconstructed"] += 1

        if failed:
            from ray_tpu_torch.checkpoint import remote as _remote

            tier = _remote.get_tier()
            for h in list(failed):
                if tier is None:
                    break
                # RemoteTierError propagates: a tier outage while chunks
                # are otherwise lost IS the typed, deadline-bounded
                # failure the caller should see — never a hang.
                data = tier.get_chunk(h)
                if data is not None and chunk_hash(data) == h:
                    out[h] = data
                    gained.add(h)
                    failed.remove(h)
                    stats["remote_tier"] += 1

        if failed:
            raise ObjectLostError(
                f"checkpoint chunk {failed[0][:12]}…: no surviving "
                f"replica ({len(failed)} chunks unrecoverable; tried "
                "peers, parity, remote tier)"
            )
    if gained:
        # Cache locally: a retry attempt on this node restores from shm,
        # and this node becomes one more serving replica for peers —
        # which peers can only FIND if the head's location table knows
        # (one batched report; GC also needs it to collect this copy).
        for h in gained:
            shard_store.put_chunk(h, out[h])
        try:
            await rt.core.head.call(
                "ckpt_locations_add",
                addr=rt.core.node_addr or rt.core.addr,
                chunks=sorted(gained),
            )
        except Exception as e:  # noqa: BLE001 - head mid-failover:
            logger.debug(        # verify/repair probes catch up later
                "ckpt location report failed: %r", e
            )
    return out


async def _reconstruct_chunk(
    rt, h, group, out, locations, connect, sem
):
    """Erasure path: gather ≥k surviving members of ``h``'s parity group
    (preferring bytes already fetched), decode, verify by content hash.
    Returns None when not enough members survive."""
    from ray_tpu_torch.runtime import transfer

    members = list(group.get("data", ())) + list(group.get("parity", ()))
    k = len(group.get("data", ()))
    m = len(group.get("parity", ()))
    shard_store = ShardStore(rt.core.store)
    present: dict[int, bytes] = {}
    for idx, mh in enumerate(members):
        if len(present) >= k:
            break
        if mh == h:
            continue
        data = out.get(mh)
        if data is None:
            data = shard_store.get_chunk(mh)
        if data is None:
            for addr in locations.get(mh, ()):
                conn = await connect(addr)
                if conn is None:
                    continue
                try:
                    async with sem:
                        data, _buffers = await transfer.pull_object(
                            mh, [conn]
                        )
                except Exception as e:  # noqa: BLE001 - try next holder
                    logger.debug(
                        "group-member pull of %s from %s failed: %r",
                        mh[:12], addr, e,
                    )
                    data = None
                    continue
                if chunk_hash(data) == mh:
                    break
                data = None
        if data is not None:
            present[idx] = data
    if len(present) < k:
        logger.debug(
            "chunk %s: only %d/%d group members survive, cannot "
            "reconstruct", h[:12], len(present), k,
        )
        return None
    want = group["data"].index(h)
    try:
        data = _erasure.reconstruct(
            k, m, present, [want], group.get("lens")
        )[want]
    except Exception as e:  # noqa: BLE001 - singular/garbage survivors
        logger.warning("chunk %s reconstruction failed: %r", h[:12], e)
        return None
    if chunk_hash(data) != h:
        logger.warning(
            "chunk %s reconstruction produced wrong bytes (corrupt "
            "survivor?)", h[:12],
        )
        return None
    logger.info(
        "reconstructed checkpoint chunk %s from %d surviving group "
        "members", h[:12], len(present),
    )
    return data


def _fingerprint_have(have, needed: dict) -> dict[str, bytes]:
    """Differential restore: run the LIVE tree's bytes through the same
    chunker and keep pieces whose hashes match the manifest — those
    chunks never leave this host. Any layout/shape/chunk-size mismatch
    just means fewer hits, never a wrong restore (assembly only uses
    bytes that hash to the manifest's content address)."""
    live = dict(_manifest.tree_flatten_with_keys(have))
    n = default_chunk_bytes()
    known: dict[str, bytes] = {}
    for key, entry in needed.items():
        leaf = live.get(key)
        if leaf is None:
            continue
        if _manifest._is_dtensor(leaf):
            # Its whole value is on no one rank: no hits from it.
            continue
        arr = _manifest._as_tensor(leaf).detach().cpu()
        if tuple(arr.shape) != tuple(entry["shape"]):
            continue
        for sh in entry.get("shards", ()):
            index = sh.get("index")
            window = (
                arr
                if index is None
                else arr[tuple(slice(a, b) for a, b in index)]
            )
            flatb = _manifest.host_bytes(window)
            mv = memoryview(flatb)
            want = sh.get("chunks", ())
            for i, off in enumerate(range(0, max(1, len(mv)), n)):
                if i >= len(want):
                    break
                piece = bytes(mv[off : off + n])
                if chunk_hash(piece) == want[i]:
                    known[want[i]] = piece
    return known


def restore(
    run: str,
    step: int | None = None,
    *,
    target=None,
    shardings=None,
    keys=None,
    have=None,
):
    """Restore a committed checkpoint. ``target`` (pytree of arrays or
    anything with shape/dtype) pins structure; ``shardings`` (matching
    pytree) places each leaf on the current mesh — pass the NEW mesh's
    shardings to resume elastically on a different layout. Without
    ``target`` returns ``{leaf_key: host tensor}``; ``keys`` narrows
    that form to a subset of leaves.

    ``have=`` is the differential-restore hook: pass the LIVE state
    tree (e.g. the one still on device after a mid-run crash of a
    different worker) and its bytes are fingerprinted through the
    chunker — chunks whose content already matches the manifest are
    never pulled, so a warm restart moves ~0 bytes
    (``last_restore_stats`` records the split).

    Chunk pulls are scoped to the leaves actually assembled (the
    ``target``'s keys or the ``keys`` filter) — a ZeRO-sharded restore
    (train/zero.py) therefore pulls only this rank's shard of the
    optimizer state, never materializing the full fp32 state on any
    one GPU.

    Without ``target`` the leaves are host tensors. With it, each leaf
    lands where the target's does: on its device, as a DTensor with its
    mesh and placements when it is one (or those of ``shardings``),
    keeping its ``requires_grad``; a number in the target comes back as
    a number."""
    global last_restore_stats
    rt = _runtime()
    reply = rt.run(rt.core.head.call("ckpt_manifest", run=run, step=step))
    if not reply.get("ok"):
        raise FileNotFoundError(
            f"no complete checkpoint for run {run!r}"
            + (f" step {step}" if step is not None else "")
            + f": {reply.get('error', '')}"
        )
    entries: dict[str, dict] = reply["entries"]
    locations: dict[str, list[str]] = reply.get("locations", {})
    parity: list = reply.get("parity", [])

    if target is not None:
        flat = _manifest.tree_flatten_with_keys(target)
        wanted = [key for key, _leaf in flat]
    elif keys is not None:
        wanted = sorted(keys)
        missing = [k for k in wanted if k not in entries]
        if missing:
            raise KeyError(
                f"checkpoint for run {run!r} has no leaves "
                f"{missing[:4]}; saved leaves: {sorted(entries)[:8]}…"
            )
    else:
        wanted = sorted(entries)
    needed = {k: entries[k] for k in wanted if k in entries}
    hashes = sorted(_manifest.manifest_chunks(needed))
    known = _fingerprint_have(have, needed) if have is not None else None
    stats: dict = {"run": run, "step": reply.get("step")}
    chunks = rt.run(
        _fetch_chunks(
            rt, hashes, locations, parity=parity, known=known, stats=stats
        )
    )
    last_restore_stats = stats

    def assemble(key: str):
        e = entries[key]
        return _manifest.assemble_leaf(
            key, e["shape"], e["dtype"], e["shards"], chunks.__getitem__
        )

    if target is None:
        return {key: assemble(key) for key in wanted}

    placements = (
        [s for _k, s in _manifest.tree_flatten_with_keys(shardings)]
        if shardings is not None
        else [None] * len(flat)
    )
    if len(placements) != len(flat):
        raise ValueError(
            f"restore: shardings has {len(placements)} leaves, the target "
            f"{len(flat)}"
        )
    values = []
    for (key, leaf), sharding in zip(flat, placements):
        if key not in entries:
            raise KeyError(
                f"checkpoint for run {run!r} has no leaf {key}; "
                f"saved leaves: {sorted(entries)[:8]}…"
            )
        arr = assemble(key)
        if tuple(arr.shape) != tuple(getattr(leaf, "shape", ())):
            raise ValueError(
                f"checkpoint leaf {key}: saved shape {tuple(arr.shape)} "
                f"!= target shape {tuple(getattr(leaf, 'shape', ()))}"
            )
        values.append(_place(arr, leaf, sharding))
    return _manifest.tree_unflatten(target, values)


def _place(arr, leaf, sharding):
    """A restored host tensor where the target leaf ``leaf`` lives:
    ``sharding`` (a NamedSharding) or the leaf's own DTensor mesh and
    placements cut it to this rank's slice (no collective); a plain
    tensor goes to the leaf's device; a number stays a number."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import distribute

    if not isinstance(leaf, torch.Tensor) and sharding is None:
        return arr.item() if isinstance(leaf, (int, float, bool)) else arr
    if sharding is not None:
        mesh, where = sharding.mesh, sharding.placements
    elif isinstance(leaf, DTensor):
        mesh, where = leaf.device_mesh, leaf.placements
    else:
        return arr.to(leaf.device).requires_grad_(leaf.requires_grad)
    out = distribute(arr.to(mesh.device_type), mesh, where)
    return out.requires_grad_(getattr(leaf, "requires_grad", False))


def restore_uri(uri: str, *, target=None, shardings=None, keys=None):
    run, step = parse_uri(uri)
    return restore(run, step, target=target, shardings=shardings, keys=keys)
