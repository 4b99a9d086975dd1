"""Async snapshot-offload checkpointing.

``AsyncCheckpointer.save()`` pays only the device→host copy on the step
loop (pinned host tensors reused across saves, filled by non-blocking
copies and one stream sync per device, bounded to ONE in-flight
snapshot) and returns; a background writer thread then serializes the owned
shards into the content-addressed chunk store, replicates each chunk to
R-1 peer nodes over the existing object-transfer path, and commits the
manifest to the head. The manifest commit is the linearization point:
until it lands, the checkpoint does not exist, so a worker killed
mid-persist leaves the previous checkpoint fully restorable and never
exposes a partial one.

The emergency-checkpoint path (node drain notice) reuses whatever
snapshot is already offloaded: the drain window pays only the persist,
never the copy — ``wait()``/``wait_pending()`` is the barrier.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref


from ray_tpu_torch.checkpoint import erasure as _erasure
from ray_tpu_torch.checkpoint import manifest as _manifest
from ray_tpu_torch.checkpoint.store import ShardStore, chunk_hash, make_uri
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

logger = logging.getLogger("ray_tpu_torch.checkpoint")

CKPT_BYTES = Counter(
    "ray_tpu_ckpt_bytes_total",
    "checkpoint bytes by kind: 'logical' = snapshot size, 'written' = "
    "new chunk bytes after dedup",
    tag_keys=("job", "kind"),
)
DEDUP_RATIO = Gauge(
    "ray_tpu_ckpt_dedup_ratio",
    "fraction of the last checkpoint's bytes served by existing chunks",
    tag_keys=("job",),
)
REPLICATION_LAG = Gauge(
    "ray_tpu_ckpt_replication_lag_seconds",
    "snapshot-offload to manifest-commit latency of the last checkpoint",
    tag_keys=("job",),
)
PHASE_SECONDS = Histogram(
    "ray_tpu_ckpt_phase_seconds",
    "checkpoint pipeline time by phase (snapshot is the only one the "
    "step loop pays)",
    boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
    tag_keys=("job", "phase"),
)
REMOTE_LAG = Gauge(
    "ray_tpu_ckpt_remote_lag_seconds",
    "snapshot-offload to remote-tier-upload latency of the last "
    "checkpoint (the replication-lag twin for the durable tier)",
    tag_keys=("job",),
)
REMOTE_ERRORS = Counter(
    "ray_tpu_ckpt_remote_errors_total",
    "remote-tier upload failures (saves keep committing in-cluster)",
    tag_keys=("job",),
)
REMOTE_ALERT = Gauge(
    "ray_tpu_ckpt_remote_alert",
    "1 while the newest committed checkpoint has NOT reached the remote "
    "tier (outage / lag alert), 0 once it has",
    tag_keys=("job",),
)

# Live checkpointers in this process: the emergency-unwind barrier
# (session.report → wait_pending) must reach them without the train loop
# having to thread handles around.
_live: "weakref.WeakSet[AsyncCheckpointer]" = weakref.WeakSet()

# Step-loop stall seconds accumulated since the last report(): the
# goodput ledger charges ONLY this (the snapshot copy), not the
# background persist that overlaps compute.
_stall_lock = threading.Lock()
_stall_s = 0.0


def _add_stall(seconds: float) -> None:
    global _stall_s
    with _stall_lock:
        _stall_s += seconds


def take_step_stall_seconds() -> float:
    """Drain the accumulated checkpoint stall (called by report())."""
    global _stall_s
    with _stall_lock:
        s = _stall_s
        _stall_s = 0.0
    return s


def wait_pending(timeout: float | None = None) -> None:
    """Barrier every in-flight checkpoint in this process (attempt end,
    emergency unwind). Raises the first persist failure."""
    for cp in list(_live):
        cp.wait(timeout=timeout)


def _runtime():
    import ray_tpu_torch.api as api

    rt = api._runtime
    if getattr(rt, "core", None) is None:
        raise RuntimeError(
            "ray_tpu_torch.checkpoint needs an initialized runtime "
            "(ray_tpu_torch.init) — the shard store lives in the node object "
            "store and manifests commit to the head"
        )
    return rt


class AsyncCheckpointer:
    """Distributed, replicated checkpoints for one training run.

    ::

        cp = ray_tpu_torch.checkpoint.AsyncCheckpointer()   # run/rank from ctx
        for step in ...:
            state = train_step(state, batch)
            uri = cp.save(step, state)      # device→host copy only
            train.report(metrics, checkpoint=uri)
        cp.wait()                           # end-of-attempt barrier
    """

    def __init__(
        self,
        run: str | None = None,
        *,
        replication: int | None = None,
        rank: int | None = None,
        world: int | None = None,
        local_prefixes: tuple[str, ...] = (),
        erasure: str | tuple[int, int] | None = None,
    ):
        from ray_tpu_torch._private import config
        from ray_tpu_torch.train import session

        ctx = session._context
        self.run = run or (ctx.experiment_name if ctx else "default")
        self.rank = rank if rank is not None else (ctx.rank if ctx else 0)
        self.world = (
            world if world is not None else (ctx.world_size if ctx else 1)
        )
        self.replication = int(
            replication
            if replication is not None
            else config.get("CKPT_REPLICATION")
        )
        # (k, m) or None. With erasure on, each group's k data + m parity
        # chunks land on DISTINCT nodes (slice-diverse order) at
        # `replication` copies each — replication=1 is the intended
        # pairing: (k+m)/k bytes, any m node losses reconstructible.
        if erasure is None:
            self.erasure = _erasure.parse_spec(config.get("CKPT_ERASURE"))
        elif isinstance(erasure, str):
            self.erasure = _erasure.parse_spec(erasure)
        else:
            self.erasure = erasure
        # Subtree prefixes that are already per-rank shards (the ZeRO
        # optimizer state): persisted as-held, never re-partitioned
        # (manifest.owned_items local_prefixes semantics).
        self.local_prefixes = tuple(local_prefixes)
        # key → list[(index_spec, host buffer)]: the host half of the
        # double buffer (the device state is the other). save() only runs
        # while no persist is in flight, so the writer thread and the copy
        # never touch the same buffers concurrently.
        self._host: dict[str, list[tuple[list | None, "torch.Tensor"]]] = {}
        self._thread: threading.Thread | None = None
        self._err: Exception | None = None
        # Stats of the last completed persist (tests + dashboards).
        self.last: dict = {}
        # Host-side byte claim in the device-memory ledger: the
        # double-buffered snapshot arrays are the checkpoint
        # subsystem's big host tenant (one full model copy in RAM).
        from ray_tpu_torch.runtime import memory as _rmem

        self._mem_reg = _rmem.track(
            f"checkpoint.saver.{self.run}.r{self.rank}",
            kind="ckpt_host_buffer",
            device=False,
        )
        _live.add(self)

    # ------------------------------------------------------------- save
    def save(self, step: int, state, metrics: dict | None = None) -> str:
        """Snapshot ``state`` and return immediately; persistence +
        replication + manifest commit happen in the background. Bounded
        by one in-flight snapshot: a second save first waits out the
        previous persist (backpressure, not a queue)."""
        import torch

        t0 = time.perf_counter()
        self.wait()
        snapshot: list[tuple[str, tuple, list]] = []
        devices = set()
        for key, leaf in _manifest.owned_items(
            state, self.rank, self.world,
            local_prefixes=self.local_prefixes,
        ):
            # Global shape comes from the LEAF (a DTensor's local window
            # may not reach the far edge); a shapeless leaf (python
            # scalar/list) uses its host copy's.
            shape_attr = getattr(leaf, "shape", None)
            shards = _manifest.local_shards(leaf)
            if not shards:
                continue  # a replica of a DTensor: coordinate 0 writes it
            global_shape = (
                tuple(shape_attr)
                if shape_attr is not None
                else tuple(shards[0][1].shape)
            )
            bufs = self._host.get(key)
            if (
                bufs is None
                or len(bufs) != len(shards)
                or any(
                    b.shape != a.shape or b.dtype != a.dtype
                    or b.is_pinned() != a.is_cuda
                    for (_, b), (_, a) in zip(bufs, shards)
                )
            ):
                # Pinned host memory for a device tensor, so that its
                # copy is asynchronous.
                bufs = [
                    (idx, torch.empty(arr.shape, dtype=arr.dtype,
                                      pin_memory=arr.is_cuda))
                    for idx, arr in shards
                ]
            for (_, dst), (_, src) in zip(bufs, shards):
                dst.copy_(src, non_blocking=src.is_cuda)
                if src.is_cuda:
                    devices.add(src.device)
            self._host[key] = bufs = [
                (idx, dst) for (_, dst), (idx, _) in zip(bufs, shards)
            ]
            snapshot.append((key, global_shape, bufs))
        # One sync per device: every copy is on the host before save()
        # returns, so the next step may overwrite the state.
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        self._mem_reg.update(
            sum(
                buf.nbytes
                for _key, _shape, bufs in snapshot
                for _idx, buf in bufs
            )
        )
        snap_s = time.perf_counter() - t0
        _add_stall(snap_s)
        PHASE_SECONDS.observe(snap_s, tags={"job": self.run, "phase": "snapshot"})
        from ray_tpu_torch.util import tracing

        tracing.emit_span(
            "ckpt:snapshot",
            time.time() - snap_s,
            snap_s,
            train_job=self.run,
            ckpt_step=int(step),
        )
        self._err = None
        self._thread = threading.Thread(
            target=self._persist,
            args=(int(step), snapshot, dict(metrics or {}), time.time()),
            name=f"ckpt-persist-{self.run}",
            daemon=True,
        )
        self._thread.start()
        return make_uri(self.run, step)

    def wait(self, timeout: float | None = None) -> None:
        """Block until the in-flight persist (if any) commits; raise its
        failure. This is the attempt-end / emergency barrier."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"checkpoint persist for run {self.run!r} still "
                    f"running after {timeout}s"
                )
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    @property
    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # ---------------------------------------------------------- persist
    def _persist(self, step, snapshot, metrics, t_offloaded) -> None:
        try:
            self._persist_inner(step, snapshot, metrics, t_offloaded)
        except Exception as e:  # noqa: BLE001 - surfaced via wait()
            logger.warning(
                "checkpoint persist failed for %s step %s: %r",
                self.run,
                step,
                e,
            )
            self._err = e

    def _persist_inner(self, step, snapshot, metrics, t_offloaded) -> None:
        from ray_tpu_torch._private import config

        rt = _runtime()
        shard_store = ShardStore(rt.core.store)
        own_addr = rt.core.node_addr or rt.core.addr
        t0 = time.perf_counter()
        entries: list[dict] = []
        locations: dict[str, list[str]] = {}
        logical = 0
        new_bytes = 0
        for key, global_shape, bufs in snapshot:
            shards = []
            for index, arr in bufs:
                flat = _manifest.host_bytes(arr)
                hashes, nb = shard_store.put_bytes(flat)
                new_bytes += nb
                logical += flat.nbytes
                for h in hashes:
                    locations.setdefault(h, [own_addr])
                shards.append(
                    {
                        "index": index,
                        "chunks": hashes,
                        "nbytes": int(flat.nbytes),
                    }
                )
            entries.append(
                {
                    "key": key,
                    "shape": list(global_shape),
                    "dtype": _manifest.dtype_name(bufs[0][1]),
                    "shards": shards,
                }
            )
        parity: list[dict] = []
        if self.erasure:
            parity = self._encode_parity(
                shard_store, list(locations), own_addr, locations
            )
        write_s = time.perf_counter() - t0
        delay = config.get("CKPT_PERSIST_DELAY_S")
        if delay:
            # Chaos hook: hold the window between chunk writes and the
            # manifest commit open so kill-mid-save tests can land inside
            # the exact race the commit protocol closes.
            time.sleep(float(delay))

        t1 = time.perf_counter()
        all_chunks = list(locations)
        deletable: list[str] = []
        if self.erasure:
            replicated, deletable = self._distribute(
                rt, own_addr, locations, parity
            )
        else:
            replicated = self._replicate(
                rt, all_chunks, own_addr, locations
            )
        repl_s = time.perf_counter() - t1

        t2 = time.perf_counter()
        reply = rt.run(
            rt.core.head.call(
                "ckpt_commit",
                run=self.run,
                step=int(step),
                rank=self.rank,
                world=self.world,
                entries=entries,
                parity=parity,
                locations=locations,
                metrics=metrics,
            )
        )
        commit_s = time.perf_counter() - t2
        remote = self._remote_offload(
            shard_store, step, entries, parity, all_chunks, metrics,
            t_offloaded,
        )
        # Erasure placement frees the writer's copy of chunks that landed
        # elsewhere — that is where the ≤(k+m)/k stored-bytes ratio comes
        # from. Deletion strictly AFTER commit + remote upload: until
        # then the local copy is the only confirmed-readable one.
        for h in deletable:
            shard_store.delete_chunk(h)
        lag = time.time() - t_offloaded

        tags = {"job": self.run}
        CKPT_BYTES.inc(logical, tags={"job": self.run, "kind": "logical"})
        CKPT_BYTES.inc(new_bytes, tags={"job": self.run, "kind": "written"})
        if logical:
            DEDUP_RATIO.set(1.0 - new_bytes / logical, tags=tags)
        REPLICATION_LAG.set(lag, tags=tags)
        PHASE_SECONDS.observe(write_s, tags={"job": self.run, "phase": "write"})
        PHASE_SECONDS.observe(
            repl_s, tags={"job": self.run, "phase": "replicate"}
        )
        PHASE_SECONDS.observe(
            commit_s, tags={"job": self.run, "phase": "commit"}
        )
        from ray_tpu_torch.util import tracing

        tracing.emit_span(
            "ckpt:persist",
            t_offloaded,
            lag,
            train_job=self.run,
            ckpt_step=int(step),
            bytes=logical,
            new_bytes=new_bytes,
        )
        self.last = {
            "step": int(step),
            "uri": make_uri(self.run, step),
            "logical_bytes": logical,
            "new_bytes": new_bytes,
            "chunks": len(all_chunks),
            "parity_groups": len(parity),
            "replicas": replicated,
            "complete": bool(reply.get("complete")),
            "persist_s": write_s + repl_s + commit_s,
            "replication_lag_s": lag,
            "remote": remote,
        }

    # ---------------------------------------------------------- erasure
    def _encode_parity(
        self, shard_store, data_hashes, own_addr, locations
    ) -> list[dict]:
        """Group this rank's chunks k at a time and store m parity
        chunks per group (content-addressed like any other chunk, so a
        repeated save dedups its parity too). Returns the manifest
        parity-group records: {"data", "parity", "lens"}."""
        k, m = self.erasure
        groups: list[dict] = []
        for grp in _erasure.plan_groups(data_hashes, k):
            datas = []
            for h in grp:
                d = shard_store.get_chunk(h)
                if d is None:
                    # Only reachable under the corrupt-chunk chaos knob:
                    # put_bytes just wrote these. Skip the group — its
                    # members keep plain replication protection.
                    logger.warning(
                        "parity encode: chunk %s unreadable, skipping "
                        "group", h[:12]
                    )
                    datas = None
                    break
                datas.append(d)
            if datas is None:
                continue
            phashes = []
            for p in _erasure.encode(datas, m):
                ph = chunk_hash(p)
                shard_store.put_chunk(ph, p)
                locations.setdefault(ph, [own_addr])
                phashes.append(ph)
            groups.append(
                {
                    "data": list(grp),
                    "parity": phashes,
                    "lens": [len(d) for d in datas],
                }
            )
        return groups

    def _distribute(
        self, rt, own_addr, locations, parity_groups
    ) -> tuple[int, list[str]]:
        """Erasure placement: spread each group's k+m members over
        DISTINCT nodes (the peer-candidate order is slice-interleaved,
        so consecutive targets sit on different slices — any m node OR
        slice losses leave ≥k members). Each member gets
        ``self.replication`` copies (1 is the intended pairing).

        Returns (peer pushes confirmed, chunks whose local copy became
        redundant and can be deleted after commit)."""
        targets = [own_addr] + self._peer_candidates(rt, own_addr)
        if len(targets) == 1:
            return 0, []  # single node: everything stays local
        assigned: dict[str, list[str]] = {}
        for g, grp in enumerate(parity_groups):
            members = list(grp["data"]) + list(grp["parity"])
            for i, h in enumerate(members):
                if h in assigned:
                    continue  # dedup across groups
                assigned[h] = [
                    targets[(g + i + r) % len(targets)]
                    for r in range(min(self.replication, len(targets)))
                ]
        # Chunks outside any group (corrupt-chaos skip) stay local.
        per_target: dict[str, list[str]] = {}
        for h, tgts in assigned.items():
            for t in tgts:
                if t != own_addr:
                    per_target.setdefault(t, []).append(h)
        pushed: dict[str, set[str]] = {}
        confirmed = 0
        for peer, hs in per_target.items():
            try:
                conn = rt.run(rt.core._connect(peer))
                reply = rt.run(
                    conn.call(
                        "prefetch_objects", oids=hs, owner_addr=own_addr
                    )
                )
            except Exception as e:  # noqa: BLE001 - peer died: chunks
                logger.warning(     # stay local, head repair replaces
                    "erasure placement to %s failed: %r", peer, e
                )
                continue
            results = reply.get("results", {})
            ok = {h for h in hs if results.get(h)}
            if ok:
                confirmed += 1
            pushed[peer] = ok
        deletable: list[str] = []
        for h, tgts in assigned.items():
            landed = [
                t
                for t in tgts
                if t == own_addr or h in pushed.get(t, ())
            ]
            if landed and own_addr not in tgts:
                locations[h] = sorted(landed)
                deletable.append(h)
            else:
                locations[h] = sorted({own_addr, *landed})
        return confirmed, deletable

    # ------------------------------------------------------ remote tier
    def _remote_offload(
        self, shard_store, step, entries, parity, chunks, metrics,
        t_offloaded,
    ) -> dict | None:
        """Upload the committed manifest + chunks to the remote spill
        tier (CKPT_REMOTE_TIER), after in-cluster replication. Failure
        is ALERT + retry-next-save, never a save failure: the cluster
        copy committed, only cross-cluster durability lags."""
        from ray_tpu_torch.checkpoint import remote as _remote

        tags = {"job": self.run}
        tier = _remote.get_tier()
        if tier is None:
            return None
        try:
            uploaded = 0
            for h in chunks:
                if tier.has_chunk(h):
                    continue
                data = shard_store.get_chunk(h)
                if data is None:
                    continue
                tier.put_chunk(h, data)
                uploaded += 1
            tier.put_manifest(
                self.run,
                int(step),
                self.rank,
                {
                    "run": self.run,
                    "step": int(step),
                    "rank": self.rank,
                    "world": self.world,
                    "entries": entries,
                    "parity": parity,
                    "metrics": metrics,
                    "ts": time.time(),
                },
            )
        except _remote.RemoteTierError as e:
            REMOTE_ERRORS.inc(1, tags=tags)
            REMOTE_ALERT.set(1.0, tags=tags)
            logger.warning(
                "remote tier offload failed for %s step %s: %s "
                "(saves continue in-cluster)", self.run, step, e,
            )
            return {"ok": False, "error": str(e)}
        lag = time.time() - t_offloaded
        REMOTE_LAG.set(lag, tags=tags)
        REMOTE_ALERT.set(0.0, tags=tags)
        return {"ok": True, "chunks_uploaded": uploaded, "lag_s": lag}

    # -------------------------------------------------------- replicate
    def _pick_peers(self, rt, own_addr: str) -> list[str]:
        """R-1 peer node addrs across DISTINCT slices: a replica on the
        same slice as another copy dies with it under whole-slice
        preemption, so the first R-1 picks cover R-1 different slices
        when the cluster has them (one peer per slice, round-robin),
        before doubling up within a slice; same-slice-as-us and
        draining nodes come last."""
        return self._peer_candidates(rt, own_addr)[
            : max(0, self.replication - 1)
        ]

    def _peer_candidates(self, rt, own_addr: str) -> list[str]:
        """Every peer node addr, ordered slice-diverse-first (one addr
        per slice per round), then same-slice/draining fallbacks, with a
        deterministic per-rank rotation."""
        try:
            status = rt.run(rt.core.head.call("cluster_status"))
        except Exception as e:  # noqa: BLE001 - degraded head: local-only
            logger.warning("checkpoint peer pick failed: %r", e)
            return []
        draining = set(status.get("draining") or {})
        nodes = status.get("nodes", {})
        own_slice = None
        for nid, n in nodes.items():
            if n.get("addr") == own_addr:
                own_slice = (n.get("labels") or {}).get("slice")
        # slice label (or per-node singleton domain) → fresh addrs
        by_slice: dict[str, list[str]] = {}
        fallback = []
        for nid, n in nodes.items():
            addr = n.get("addr")
            if not addr or addr == own_addr:
                continue
            labels = n.get("labels") or {}
            if nid in draining:
                fallback.append(addr)
            elif own_slice is not None and labels.get("slice") == own_slice:
                fallback.append(addr)
            else:
                domain = labels.get("slice") or f"node:{addr}"
                by_slice.setdefault(domain, []).append(addr)
        # Interleave one addr per slice per round: the first R-1 picks
        # maximize slice diversity by construction.
        fresh: list[str] = []
        rounds = [sorted(by_slice[d]) for d in sorted(by_slice)]
        while rounds:
            next_rounds = []
            for addrs in rounds:
                fresh.append(addrs.pop(0))
                if addrs:
                    next_rounds.append(addrs)
            rounds = next_rounds
        # Deterministic per-rank rotation spreads replica load across the
        # cluster instead of every rank hammering the same peer.
        candidates = fresh + sorted(fallback)
        if candidates:
            shift = self.rank % len(candidates)
            candidates = candidates[shift:] + candidates[:shift]
        return candidates

    def _replicate(
        self, rt, chunks: list[str], own_addr: str, locations: dict
    ) -> int:
        """Push every chunk of this checkpoint at R-1 peers (peers skip
        chunks they already hold, so dedup'd saves replicate for free).
        Returns the number of peer replicas confirmed."""
        if self.replication <= 1 or not chunks:
            return 0
        confirmed = 0
        for peer in self._pick_peers(rt, own_addr):
            try:
                conn = rt.run(rt.core._connect(peer))
                reply = rt.run(
                    conn.call(
                        "prefetch_objects",
                        oids=chunks,
                        owner_addr=own_addr,
                    )
                )
            except Exception as e:  # noqa: BLE001 - peer died: head repair
                logger.warning(            # re-replicates once it notices
                    "checkpoint replication to %s failed: %r", peer, e
                )
                continue
            results = reply.get("results", {})
            for h in chunks:
                if results.get(h):
                    locations.setdefault(h, []).append(peer)
            confirmed += 1
        return confirmed
