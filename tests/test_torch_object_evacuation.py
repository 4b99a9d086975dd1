"""Drain-time evacuation of GENERAL objects (the non-checkpoint plane).

When a node enters DRAINING, owners push sole-copy store-resident
objects to a healthy peer while the node can still serve pulls; with no
healthy peer, the bytes spill to the remote tier, and reads fall back to
the tier after the node retires. Zero lost objects is the acceptance
bar.

The JAX package's evacuation tests (tests/test_object_evacuation.py) on
the port's runtime, and the two cases that reach the remote tier with
none configured: a lost object raises ObjectLostError, and a drain
notice with no peer and no tier moves nothing and returns.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import api as core_api
from ray_tpu_torch._private import config as _config
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.checkpoint import remote as remote_mod
from ray_tpu_torch.runtime.drain import EVACUATED


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


def _own_node_id():
    rt = core_api._runtime
    status = _head_call("cluster_status")
    return next(
        nid
        for nid, n in status["nodes"].items()
        if n.get("addr") == rt.core.node_addr
    )


@pytest.fixture
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def tier_dir(tmp_path):
    root = tmp_path / "tier"
    _config._overrides["CKPT_REMOTE_TIER"] = str(root)
    remote_mod.reset_tier_cache()
    yield root
    _config._overrides.pop("CKPT_REMOTE_TIER", None)
    remote_mod.reset_tier_cache()


def test_drain_pushes_owned_objects_to_peer(cluster, tmp_path):
    """Owner-side evacuation: draining the only node holding a put()
    object moves the bytes to a healthy peer BEFORE retirement — the
    read survives losing the original copy entirely."""
    rt = core_api._runtime
    peer = _add_node(tmp_path, "evpeer", {"CPU": 1.0})
    try:
        value = np.arange(200_000, dtype=np.float32)  # > inline cutoff
        ref = ray_tpu_torch.put(value)
        oid_hex = ref.hex
        assert rt.core.memory[oid_hex][0] == "in_store"
        before = EVACUATED.value(tags={"outcome": "peer"}) or 0.0

        assert _head_call(
            "drain_node", node_id=_own_node_id(),
            reason="preempt", deadline_s=60,
        )["ok"]
        deadline = time.time() + 20
        moved = False
        while time.time() < deadline:
            if peer.addr in (rt.core._locations.get(oid_hex) or ()):
                moved = True
                break
            time.sleep(0.2)
        assert moved, "object never evacuated to the healthy peer"
        assert (EVACUATED.value(tags={"outcome": "peer"}) or 0.0) > before
        # The record's primary moved off the doomed node too.
        assert rt.core.memory[oid_hex] == ("in_store", peer.addr)

        # The drained node's copy is now expendable: wipe it and read.
        rt.core.store.delete(ObjectID.from_hex(oid_hex))
        np.testing.assert_array_equal(ray_tpu_torch.get(ref), value)
    finally:
        _stop_node(peer)


def test_drain_spills_to_remote_tier_without_peer(cluster, tier_dir):
    """No healthy peer exists: the draining node sweeps its store to the
    remote tier, and a later read of the lost object resolves from the
    tier (the last rung of the resolution ladder) — zero lost objects."""
    rt = core_api._runtime
    value = {"tensor": np.arange(150_000, dtype=np.float32), "tag": "x"}
    ref = ray_tpu_torch.put(value)
    oid_hex = ref.hex
    before = EVACUATED.value(tags={"outcome": "remote_tier"}) or 0.0

    assert _head_call(
        "drain_node", node_id=_own_node_id(),
        reason="preempt", deadline_s=60,
    )["ok"]
    obj_path = tier_dir / "objects" / oid_hex
    deadline = time.time() + 20
    while time.time() < deadline and not obj_path.exists():
        time.sleep(0.2)
    assert obj_path.exists(), "store sweep never reached the tier"
    assert (
        EVACUATED.value(tags={"outcome": "remote_tier"}) or 0.0
    ) > before

    # Simulate the node retiring with the bytes: local copy gone, no
    # peer ever held one. The tier copy must serve the read.
    rt.core.store.delete(ObjectID.from_hex(oid_hex))
    got = ray_tpu_torch.get(ref)
    np.testing.assert_array_equal(got["tensor"], value["tensor"])
    assert got["tag"] == "x"


def test_evacuation_disabled_by_knob(cluster, tmp_path):
    """RAY_TPU_OBJECT_DRAIN_EVACUATION=0 turns the whole plane off: a
    drain notice moves nothing."""
    rt = core_api._runtime
    _config._overrides["OBJECT_DRAIN_EVACUATION"] = False
    peer = _add_node(tmp_path, "offpeer", {"CPU": 1.0})
    try:
        ref = ray_tpu_torch.put(np.arange(150_000, dtype=np.float32))
        assert _head_call(
            "drain_node", node_id=_own_node_id(),
            reason="preempt", deadline_s=60,
        )["ok"]
        time.sleep(2.0)
        assert peer.addr not in (rt.core._locations.get(ref.hex) or ())
    finally:
        _config._overrides.pop("OBJECT_DRAIN_EVACUATION", None)
        _stop_node(peer)


def test_lost_object_raises_object_lost_error(cluster):
    """The resolution ladder's last rung is the remote tier; with none
    configured a lost object raises ObjectLostError."""
    from ray_tpu_torch.exceptions import ObjectLostError

    rt = core_api._runtime
    ref = ray_tpu_torch.put(np.arange(150_000, dtype=np.float32))
    assert rt.core.memory[ref.hex][0] == "in_store"
    rt.core.store.delete(ObjectID.from_hex(ref.hex))
    with pytest.raises(ObjectLostError):
        ray_tpu_torch.get(ref, timeout=30)


def test_drain_without_peer_or_tier_returns(cluster):
    """No healthy peer and no remote tier: the owner counts its objects
    as not evacuated, the node's store sweep finds no tier and returns,
    and the objects stay readable from the draining node."""
    rt = core_api._runtime
    value = np.arange(150_000, dtype=np.float32)
    ref = ray_tpu_torch.put(value)
    before = EVACUATED.value(tags={"outcome": "failed"}) or 0.0
    assert _head_call(
        "drain_node", node_id=_own_node_id(),
        reason="preempt", deadline_s=60,
    )["ok"]
    deadline = time.time() + 20
    while (time.time() < deadline
           and (EVACUATED.value(tags={"outcome": "failed"}) or 0.0)
           == before):
        time.sleep(0.2)
    assert (EVACUATED.value(tags={"outcome": "failed"}) or 0.0) > before
    assert rt.run(rt.node._drain_evacuate_store()) is None
    np.testing.assert_array_equal(ray_tpu_torch.get(ref), value)
