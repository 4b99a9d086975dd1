"""The JAX package's checkpoint-store tests (tests/test_ckpt_store.py) on
the port's runtime and checkpoint package: snapshot-offload saves,
content-addressed dedup, commit-protocol atomicity, peer replication with
head-driven repair (node death and drain evacuation), integrity and
locations, and the checkpoint-dir naming. The same cases with torch
leaves where the reference's were jax arrays, and the CLI and dashboard
case on ``ray_tpu_torch.scripts`` and ``ray_tpu_torch.dashboard``.
"""

import logging
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import api as core_api
from ray_tpu_torch import checkpoint as dc
from ray_tpu_torch._private import config as _config


def _head_call(method, **kw):
    rt = core_api._runtime
    return rt.run(rt.core.head.call(method, **kw))


def _add_node(tmp_path, name, resources):
    from ray_tpu_torch.runtime.node import NodeManager

    rt = core_api._runtime

    async def launch():
        node = NodeManager(
            rt.core.head_addr,
            str(tmp_path / f"{name}_store"),
            resources=resources,
        )
        await node.start()
        return node

    return rt.run(launch())


def _stop_node(node):
    try:
        core_api._runtime.run(node.stop())
    except Exception:  # noqa: BLE001 - may already be dead
        pass


@pytest.fixture
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def fast_health_cluster():
    ray_tpu_torch.init(num_cpus=2, _system_config={"HEALTH_TIMEOUT_S": 2.0})
    yield
    ray_tpu_torch.shutdown()
    _config._overrides.pop("HEALTH_TIMEOUT_S", None)
    os.environ.pop("RAY_TPU_HEALTH_TIMEOUT_S", None)


@pytest.fixture
def steady_health_cluster():
    """Health timeout ABOVE the 5s sync keepalive: only genuinely dead
    nodes get reaped. fast_health_cluster's 2s timeout reaps idle nodes
    between keepalives (they silently re-register) — fine for repair
    races, fatal for tests that assert a node's drain record persists."""
    ray_tpu_torch.init(num_cpus=2, _system_config={"HEALTH_TIMEOUT_S": 6.0})
    yield
    ray_tpu_torch.shutdown()
    _config._overrides.pop("HEALTH_TIMEOUT_S", None)
    os.environ.pop("RAY_TPU_HEALTH_TIMEOUT_S", None)


# -------------------------------------------------- save/restore basics
def test_roundtrip_and_elastic_reshard(cluster):
    """A state of torch leaves round-trips through the shard store: with
    a target it comes back in the target's structure (bf16 bit for bit,
    a number as a number); without one as {leaf_key: host tensor}. (The
    resharded restore onto a mesh of other ranks is
    tests/test_torch_ckpt_manifest.py's, on gloo ranks.)"""
    w = torch.arange(64.0)
    mu = torch.randn(8, 4, generator=torch.Generator().manual_seed(0)
                     ).to(torch.bfloat16)
    state = {"w": w, "mu": mu, "step": 5}
    cp = dc.AsyncCheckpointer(run="reshard_run", replication=1)
    uri = cp.save(0, state)
    assert uri == "ckpt://reshard_run/0"
    cp.wait()
    assert cp.last["complete"]

    target = {"w": torch.zeros(64), "mu": torch.zeros(8, 4,
                                                      dtype=torch.bfloat16),
              "step": 0}
    out = dc.restore("reshard_run", target=target)
    assert torch.equal(out["w"], w) and out["step"] == 5
    assert out["mu"].dtype == torch.bfloat16
    assert torch.equal(out["mu"].view(torch.int16), mu.view(torch.int16))

    # No target: flat {leaf_key: host tensor}.
    flat = dc.restore("reshard_run")
    assert sorted(flat) == ["['mu']", "['step']", "['w']"]
    assert torch.equal(flat["['w']"], w)


def test_async_save_returns_under_50ms(cluster):
    """The stall the subsystem removes, pinned: save() on a multi-MB
    state returns to the step loop in < 50 ms (device→host copy only;
    serialization, hashing, I/O, and commit are all background)."""
    state = {
        "w": np.random.default_rng(0).random(2_000_000).astype(np.float32),
        "b": np.ones((256, 256), np.float32),
    }
    cp = dc.AsyncCheckpointer(run="perf_run", replication=1)
    cp.save(0, state)  # warm-up: allocates the double buffers
    cp.wait()
    t0 = time.perf_counter()
    cp.save(1, state)
    dt = time.perf_counter() - t0
    cp.wait()
    assert dt < 0.05, f"async save() stalled the step loop {dt * 1e3:.1f}ms"
    assert cp.last["logical_bytes"] > 8_000_000


def test_dedup_unchanged_leaves_write_zero_bytes(cluster):
    """Consecutive checkpoints of unchanged state reuse every chunk; a
    single mutated leaf re-writes only its own chunks."""
    rng = np.random.default_rng(1)
    state = {
        "emb": rng.random(1_000_000).astype(np.float32),  # "frozen"
        "w": rng.random(500_000).astype(np.float32),
    }
    cp = dc.AsyncCheckpointer(run="dedup_run", replication=1)
    cp.save(0, state)
    cp.wait()
    first = cp.last
    assert first["new_bytes"] > 0

    cp.save(1, state)  # nothing changed
    cp.wait()
    assert cp.last["new_bytes"] == 0
    assert cp.last["logical_bytes"] == first["logical_bytes"]

    state["w"] = state["w"] + 1.0  # one leaf updates
    cp.save(2, state)
    cp.wait()
    assert 0 < cp.last["new_bytes"] < first["new_bytes"]


def test_partial_commit_is_invisible(cluster):
    """The consistency protocol: a checkpoint exists only once EVERY
    rank of its world committed — a partial shard set never resolves."""
    entries = [
        {
            "key": "['w']",
            "shape": [2],
            "dtype": "float32",
            "shards": [{"index": None, "chunks": ["ab" * 20], "nbytes": 8}],
        }
    ]
    # Step 0 completes at world 1.
    r = _head_call(
        "ckpt_commit", run="proto", step=0, rank=0, world=1,
        entries=entries, locations={},
    )
    assert r["complete"]
    # Step 1: only rank 0 of world 2 commits — incomplete.
    r = _head_call(
        "ckpt_commit", run="proto", step=1, rank=0, world=2,
        entries=entries, locations={},
    )
    assert not r["complete"]
    man = _head_call("ckpt_manifest", run="proto")
    assert man["ok"] and man["step"] == 0  # restore resolves step 0
    assert dc.latest_step("proto") == 0
    rows = _head_call("ckpt_list", run="proto")["runs"]["proto"]
    by_step = {row["step"]: row for row in rows}
    assert by_step[1]["complete"] is False
    # Rank 1 lands → step 1 becomes the restore point.
    r = _head_call(
        "ckpt_commit", run="proto", step=1, rank=1, world=2,
        entries=entries, locations={},
    )
    assert r["complete"]
    assert dc.latest_step("proto") == 1


def test_retention_prunes_and_collects_chunks(cluster):
    """Old checkpoints prune to CKPT_KEEP and their unreferenced chunks
    leave the local store; chunks still referenced by retained
    checkpoints survive pruning."""
    from ray_tpu_torch.checkpoint.store import ShardStore

    rt = core_api._runtime
    store = ShardStore(rt.core.store)
    frozen = np.full(300_000, 7.0, np.float32)  # shared by every step
    cp = dc.AsyncCheckpointer(run="keep_run", replication=1)
    per_step_chunks = {}
    for step in range(4):
        state = {
            "frozen": frozen,
            "w": np.full(300_000, float(step), np.float32),
        }
        cp.save(step, state)
        cp.wait()
        man = _head_call("ckpt_manifest", run="keep_run", step=step)
        per_step_chunks[step] = {
            h
            for e in man["entries"].values()
            for sh in e["shards"]
            for h in sh["chunks"]
        }
    rows = _head_call("ckpt_list", run="keep_run")["runs"]["keep_run"]
    assert [r["step"] for r in rows] == [2, 3]  # CKPT_KEEP=2
    # Give the async GC a moment, then check the store.
    unique_old = per_step_chunks[0] - per_step_chunks[2] - per_step_chunks[3]
    shared = per_step_chunks[0] & per_step_chunks[3]
    assert unique_old and shared
    deadline = time.time() + 10
    while time.time() < deadline:
        if all(not store.has_chunk(h) for h in unique_old):
            break
        time.sleep(0.2)
    assert all(not store.has_chunk(h) for h in unique_old)
    assert all(store.has_chunk(h) for h in shared)


# ------------------------------------------------- replication + repair
def _holder_addrs(run):
    man = _head_call("ckpt_manifest", run=run)
    return man["locations"]


def test_repair_rereplicates_on_node_death(fast_health_cluster, tmp_path):
    """Kill a replica holder: the head's repair loop re-replicates every
    affected chunk onto a surviving node within the health window."""
    rt = core_api._runtime
    nodes = [
        _add_node(tmp_path, f"rep{i}", {"CPU": 1.0}) for i in range(2)
    ]
    try:
        cp = dc.AsyncCheckpointer(run="repair_run", replication=2)
        cp.save(0, {"w": np.arange(400_000, dtype=np.float32)})
        cp.wait()
        assert cp.last["replicas"] >= 1
        locs = _holder_addrs("repair_run")
        peer = next(
            n for n in nodes
            if any(n.addr in v for v in locs.values())
        )
        survivor = next(n for n in nodes if n is not peer)
        _stop_node(peer)

        alive = {rt.core.node_addr, survivor.addr}
        deadline = time.time() + 25
        healed = False
        while time.time() < deadline:
            locs = _holder_addrs("repair_run")
            if all(
                len([a for a in v if a in alive]) >= 2
                for v in locs.values()
            ):
                healed = True
                break
            time.sleep(0.3)
        assert healed, f"repair never restored replication: {locs}"
        ver = _head_call("ckpt_verify", run="repair_run")["checkpoints"][0]
        assert ver["healthy"] == ver["chunks"]
        assert not ver["lost"]
    finally:
        for n in nodes:
            _stop_node(n)


def test_drain_evacuates_checkpoint_replicas(fast_health_cluster, tmp_path):
    """ROADMAP drain follow-up: when a node enters DRAINING, chunks
    whose replica set depends on it re-replicate to healthy nodes inside
    the notice window — BEFORE the node dies."""
    rt = core_api._runtime
    nodes = [
        _add_node(tmp_path, f"ev{i}", {"CPU": 1.0}) for i in range(2)
    ]
    try:
        cp = dc.AsyncCheckpointer(run="evac_run", replication=2)
        cp.save(0, {"w": np.arange(400_000, dtype=np.float32)})
        cp.wait()
        locs = _holder_addrs("evac_run")
        peer = next(
            n for n in nodes
            if any(n.addr in v for v in locs.values())
        )
        survivor = next(n for n in nodes if n is not peer)
        assert _head_call(
            "drain_node", node_id=peer.node_id,
            reason="preempt", deadline_s=60,
        )["ok"]

        healthy = {rt.core.node_addr, survivor.addr}
        deadline = time.time() + 20
        evacuated = False
        while time.time() < deadline:
            locs = _holder_addrs("evac_run")
            if all(
                len([a for a in v if a in healthy]) >= 2
                for v in locs.values()
            ):
                evacuated = True
                break
            time.sleep(0.3)
        assert evacuated, (
            f"drain evacuation never re-replicated off the draining "
            f"node: {locs}"
        )
        # The draining node is still alive and serving — evacuation is
        # proactive, not a death reaction.
        assert peer.node_id in _head_call("drain_table")["draining"]
    finally:
        for n in nodes:
            _stop_node(n)


def test_restore_pulls_missing_chunks_from_peers(
    fast_health_cluster, tmp_path
):
    """Restore assembles from whichever replicas survive: wipe the
    driver's local copies and restore purely over the transfer path."""
    rt = core_api._runtime
    node = _add_node(tmp_path, "pull", {"CPU": 1.0})
    try:
        state = {"w": np.arange(500_000, dtype=np.float32)}
        cp = dc.AsyncCheckpointer(run="pull_run", replication=2)
        cp.save(0, state)
        cp.wait()
        locs = _holder_addrs("pull_run")
        assert all(node.addr in v for v in locs.values())
        # Wipe local copies: restore must go through the peer.
        from ray_tpu_torch.checkpoint.store import ShardStore

        local = ShardStore(rt.core.store)
        for h in locs:
            local.delete_chunk(h)
        assert all(not local.has_chunk(h) for h in locs)
        out = dc.restore("pull_run", target=state)
        np.testing.assert_array_equal(out["w"], state["w"])
    finally:
        _stop_node(node)


# ------------------------------------------------ CLI + dashboard
def test_ckpt_cli_and_dashboard_surfacing(cluster, monkeypatch, capsys):
    """`ray_tpu_torch.scripts ckpt ls/verify` and the dashboard's
    /api/checkpoints both read the head's manifest table."""
    import json as _json
    import urllib.request

    import ray_tpu_torch.scripts as scripts
    from ray_tpu_torch.dashboard import start_dashboard

    cp = dc.AsyncCheckpointer(run="surf_run", replication=1)
    cp.save(0, {"w": np.arange(1000, dtype=np.float32)})
    cp.wait()

    monkeypatch.setattr(scripts, "_connect", lambda *a, **k: None)
    assert scripts.main(["ckpt", "ls"]) == 0
    out = capsys.readouterr().out
    assert "surf_run step 0: complete" in out
    assert scripts.main(["ckpt", "verify"]) == 0
    out = capsys.readouterr().out
    assert "surf_run step 0" in out and "0 lost" in out

    dash = start_dashboard()
    try:
        data = _json.load(urllib.request.urlopen(
            dash.url + "/api/checkpoints", timeout=10))
        assert data["runs"]["surf_run"][0]["complete"]
    finally:
        dash.stop()


def test_checkpoint_naming_unified(cluster, tmp_path):
    """One naming scheme (ckpt-*), one discovery helper, both writers:
    CheckpointManager and report() agree, and discovery still reads the
    legacy checkpoint_* dirs."""
    from ray_tpu_torch.train.checkpoint import (
        CheckpointManager,
        checkpoint_dir_name,
        list_checkpoint_dirs,
    )

    run = tmp_path / "mgr"
    mgr = CheckpointManager(str(run), num_to_keep=4)
    mgr.save(0, {"x": torch.tensor(0.0)})
    assert (run / "ckpt-00000000").is_dir()

    # Legacy dir from a pre-unification run is still discovered, and
    # ordering is by index across both schemes.
    legacy = run / "checkpoint_000005"
    legacy.mkdir()
    (legacy / "state.txt").write_text("legacy")
    found = list_checkpoint_dirs(str(run))
    assert [i for i, _ in found] == [0, 5]
    assert mgr.latest().endswith("checkpoint_000005")

    # report() writes the SAME scheme and appends after the legacy max.
    from ray_tpu_torch.train.session import TrainContext, _set_context, report

    ctx = TrainContext(
        storage_path=str(tmp_path / "results"), experiment_name="naming"
    )
    _set_context(ctx)
    try:
        src = tmp_path / "src"
        src.mkdir()
        (src / "state.txt").write_text("x")
        report({"m": 1}, checkpoint=str(src))
    finally:
        _set_context(None)
    run_dir = tmp_path / "results" / "naming"
    assert sorted(os.listdir(run_dir)) == [checkpoint_dir_name(0)]

    # The trainer's discovery uses the same helper (legacy included).
    from ray_tpu_torch.train import RunConfig, TorchTrainer

    trainer = TorchTrainer(
        lambda: None,
        run_config=RunConfig(
            name="naming", storage_path=str(tmp_path / "results")
        ),
    )
    legacy2 = run_dir / "checkpoint_000009"
    legacy2.mkdir()
    (legacy2 / "state.txt").write_text("y")
    assert trainer._find_latest_checkpoint().endswith("checkpoint_000009")


def test_restore_latest_valid_logs_and_store_fallback(
    cluster, tmp_path, caplog
):
    """The restore-fallback event lands in shipped logs (module logger,
    not print), and an empty local dir falls back to the shard store."""
    from ray_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "run"), num_to_keep=3)
    for step in range(2):
        mgr.save(step, {"x": torch.tensor(float(step))})
    newest = mgr.latest()
    with open(os.path.join(newest, STATE_FILE.format(rank=0)), "r+b") as f:
        f.truncate(16)  # a torn write
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.train"):
        out = mgr.restore_latest_valid(device="cpu")
    assert out is not None and out[0].endswith("ckpt-00000000")
    assert any(
        "failed to restore" in rec.message for rec in caplog.records
    )

    # Store fallback: nothing restorable locally, but the run has a
    # complete shard-store checkpoint → restore_latest_valid serves it
    # with an unchanged call site.
    cp = dc.AsyncCheckpointer(run="fb_run", replication=1)
    cp.save(7, {"x": torch.tensor(3.5)})
    cp.wait()
    mgr2 = CheckpointManager(
        str(tmp_path / "empty"), store_run="fb_run"
    )
    got = mgr2.restore_latest_valid(target={"x": torch.tensor(0.0)})
    assert got is not None
    path, state = got
    assert path == "ckpt://fb_run/7"
    assert float(state["x"]) == 3.5


# --------------------------------------------- integrity + locations
def test_get_chunk_verifies_content_hash(cluster):
    """Integrity on READ: a chunk whose bytes no longer match its
    content hash is treated as missing (counted + logged), never served.
    The CKPT_CORRUPT chaos knob flips a byte deterministically, so
    re-reads can't accidentally pass."""
    from ray_tpu_torch.checkpoint.store import (
        CORRUPT_CHUNKS,
        ShardStore,
        chunk_hash,
    )

    rt = core_api._runtime
    store = ShardStore(rt.core.store)
    hashes, _ = store.put_bytes(b"payload" * 4096, 1 << 20)
    h = hashes[0]
    assert store.get_chunk(h) is not None
    before = CORRUPT_CHUNKS.value() or 0.0
    _config._overrides["CKPT_CORRUPT"] = f"{h[:6]}:1.0"
    try:
        assert store.get_chunk(h) is None  # corrupt == missing
        assert store.get_chunk(h) is None  # deterministically so
        assert (CORRUPT_CHUNKS.value() or 0.0) >= before + 2
    finally:
        _config._overrides.pop("CKPT_CORRUPT", None)
    assert store.get_chunk(h) is not None  # disk bytes were never harmed

    # Verification off: the knob's corruption would pass through, so
    # the default-on check is what stands between a flipped bit and a
    # silently wrong restore.
    _config._overrides["CKPT_CORRUPT"] = f"{h[:6]}:1.0"
    _config._overrides["CKPT_VERIFY_READS"] = False
    try:
        data = store.get_chunk(h)
        assert data is not None and chunk_hash(data) != h
    finally:
        _config._overrides.pop("CKPT_CORRUPT", None)
        _config._overrides.pop("CKPT_VERIFY_READS", None)


def test_restore_reports_pulled_replicas_to_head(
    fast_health_cluster, tmp_path
):
    """The pull-path bugfix pinned: chunks a restore pulls from peers
    are cached locally AND reported to the head's location table — the
    next repair/verify sees the new replica instead of a stale map."""
    rt = core_api._runtime
    node = _add_node(tmp_path, "locrep", {"CPU": 1.0})
    try:
        state = {"w": np.arange(400_000, dtype=np.float32)}
        cp = dc.AsyncCheckpointer(run="locrep_run", replication=2)
        cp.save(0, state)
        cp.wait()
        from ray_tpu_torch.checkpoint.store import ShardStore

        local = ShardStore(rt.core.store)
        locs = _holder_addrs("locrep_run")
        own = rt.core.node_addr
        for h in locs:
            local.delete_chunk(h)
            # Make the head's map honest about the wipe (the stale-map
            # half of the bug is covered by verify's probing): the
            # interesting half is that the RESTORE re-adds us.
            rt.head.ckpt_locations.get(h, set()).discard(own)
        locs = _holder_addrs("locrep_run")
        assert not any(own in v for v in locs.values())
        out = dc.restore("locrep_run", target=state)
        np.testing.assert_array_equal(out["w"], state["w"])
        # The head's map now lists this node for every pulled chunk.
        locs = _holder_addrs("locrep_run")
        assert all(own in v for v in locs.values()), locs
        assert all(local.has_chunk(h) for h in locs)
    finally:
        _stop_node(node)


def test_repair_survives_concurrent_drain_and_death(
    steady_health_cluster, tmp_path
):
    """Satellite for the repair loop's worst hour: one holder DRAINS
    while another DIES in the same window. Every chunk heals to the
    replication target on the healthy set, nothing is lost, and repair
    is idempotent — a repeated drain notice adds no extra copies."""
    rt = core_api._runtime
    nodes = [
        _add_node(tmp_path, f"cc{i}", {"CPU": 1.0}) for i in range(3)
    ]
    try:
        cp = dc.AsyncCheckpointer(run="cc_run", replication=2)
        cp.save(0, {"w": np.arange(500_000, dtype=np.float32)})
        cp.wait()
        locs = _holder_addrs("cc_run")
        holders = [
            n for n in nodes
            if any(n.addr in v for v in locs.values())
        ]
        drainee = holders[0] if holders else nodes[0]
        victim = next(n for n in nodes if n is not drainee)
        assert _head_call(
            "drain_node", node_id=drainee.node_id,
            reason="preempt", deadline_s=60,
        )["ok"]
        _stop_node(victim)  # concurrent death

        healthy = {rt.core.node_addr} | {
            n.addr for n in nodes if n not in (drainee, victim)
        }
        deadline = time.time() + 30
        healed = False
        while time.time() < deadline:
            locs = _holder_addrs("cc_run")
            if all(
                len([a for a in v if a in healthy]) >= 2
                for v in locs.values()
            ):
                healed = True
                break
            time.sleep(0.3)
        assert healed, f"never healed on the healthy set: {locs}"
        ver = _head_call("ckpt_verify", run="cc_run")["checkpoints"][0]
        assert not ver["lost"]

        # Idempotency: the SAME drain notice again must not stack more
        # replicas (journal loc ops replay-safe, no double-replication).
        counts = {
            h: len([a for a in v if a in healthy])
            for h, v in locs.items()
        }
        assert _head_call(
            "drain_node", node_id=drainee.node_id,
            reason="preempt", deadline_s=60,
        )["ok"]
        time.sleep(3.0)
        locs = _holder_addrs("cc_run")
        for h, v in locs.items():
            n_healthy = len([a for a in v if a in healthy])
            assert n_healthy <= max(counts[h], 2) + 1, (
                f"replica runaway on {h[:12]}: {counts[h]} -> {n_healthy}"
            )
    finally:
        for n in nodes:
            _stop_node(n)


def test_fork_shares_every_chunk(cluster):
    """A fork (the PBT exploit primitive) copies a manifest into a new
    run: no new chunks (dedup ratio 1.0), and the fork restores to the
    source's leaves bit for bit; a run with no complete checkpoint
    cannot be forked."""
    g = torch.Generator().manual_seed(4)
    state = {"w": torch.randn(300, 7, generator=g),
             "mu": torch.randn(300, 7, generator=g).to(torch.bfloat16),
             "step": 3}
    cp = dc.AsyncCheckpointer(run="fork_src", replication=1)
    cp.save(3, state)
    cp.wait()
    reply = dc.fork("fork_src", "fork_dst")
    assert reply["ok"] and reply["step"] == 3 and reply["new_bytes"] == 0
    share = dc.fork_shares_chunks("fork_src", "fork_dst", 3)
    assert share["new_chunks"] == 0 and share["dedup_ratio"] == 1.0
    src, dst = dc.restore("fork_src"), dc.restore("fork_dst", 3)
    assert src.keys() == dst.keys()
    for key in src:
        assert src[key].dtype == dst[key].dtype
        assert torch.equal(src[key].reshape(-1).view(torch.uint8),
                           dst[key].reshape(-1).view(torch.uint8)), key
    with pytest.raises(ValueError):
        dc.fork("no_such_run", "fork_nowhere")
