"""Remote spill tier: FileTier semantics, deadline-bounded typed
failures under chaos, background save offload with lag alerting, the
restore ladder's remote rung, and the `ckpt push/pull` CLI.

The invariant under test everywhere: a dead or slow remote tier DEGRADES
(saves stay in-cluster, errors are RemoteTierError within the deadline)
— it never hangs a save or a restore.

The JAX package's remote-tier tests (tests/test_ckpt_remote_tier.py) on
the port's runtime and checkpoint package, the push/pull CLI case on
``ray_tpu_torch.scripts``.
"""

import json
import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import api as core_api
from ray_tpu_torch import checkpoint as dc
from ray_tpu_torch._private import config as _config
import importlib

from ray_tpu_torch.checkpoint import remote as remote_mod

restore_mod = importlib.import_module("ray_tpu_torch.checkpoint.restore")
from ray_tpu_torch.checkpoint.store import ShardStore


def _head_call(method, **kw):
    rt = core_api._runtime
    return rt.run(rt.core.head.call(method, **kw))


@pytest.fixture
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def tier_dir(tmp_path):
    """A FileTier root wired into config for the duration of one test,
    with the tier cache reset on both sides."""
    root = tmp_path / "tier"
    _config._overrides["CKPT_REMOTE_TIER"] = str(root)
    remote_mod.reset_tier_cache()
    yield root
    _config._overrides.pop("CKPT_REMOTE_TIER", None)
    _config._overrides.pop("REMOTE_TIER_FAIL", None)
    _config._overrides.pop("CKPT_REMOTE_TIMEOUT_S", None)
    remote_mod.reset_tier_cache()


# ---------------------------------------------------- FileTier semantics
def test_file_tier_roundtrip(tmp_path):
    tier = remote_mod.FileTier(str(tmp_path / "t"))
    assert tier.get_chunk("ab" * 20) is None
    tier.put_chunk("ab" * 20, b"chunkdata")
    assert tier.has_chunk("ab" * 20)
    assert tier.get_chunk("ab" * 20) == b"chunkdata"

    tier.put_manifest("runA", 3, 0, {"rank": 0, "world": 2})
    tier.put_manifest("runA", 3, 1, {"rank": 1, "world": 2})
    tier.put_manifest("runA", 7, 0, {"rank": 0, "world": 1})
    assert tier.list_steps("runA") == {3: [0, 1], 7: [0]}
    assert tier.get_manifest("runA", 3, 1)["rank"] == 1
    assert tier.list_steps("missing_run") == {}

    blob = remote_mod.pack_object([4, 3], b"abcdxyz")
    tier.put_object("ff" * 20, blob)
    seg_lens, payload = remote_mod.unpack_object(
        tier.get_object("ff" * 20)
    )
    assert seg_lens == [4, 3] and payload == b"abcdxyz"
    # No torn files: everything visible is a complete rename target.
    for dirpath, _dirs, files in os.walk(str(tmp_path / "t")):
        assert not [f for f in files if f.endswith(".tmp")], (
            dirpath, files,
        )


def test_chaos_outage_is_typed_and_deadline_bounded(tmp_path):
    """RAY_TPU_REMOTE_TIER_FAIL=outage: every tier call raises
    RemoteTierError (never hangs); latency injection slower than the
    deadline is cut off by CKPT_REMOTE_TIMEOUT_S."""
    _config._overrides["REMOTE_TIER_FAIL"] = "outage"
    remote_mod.reset_tier_cache()
    try:
        tier = remote_mod.get_tier(str(tmp_path / "t"))
        t0 = time.monotonic()
        with pytest.raises(remote_mod.RemoteTierError):
            tier.put_chunk("ab" * 20, b"x")
        with pytest.raises(remote_mod.RemoteTierError):
            tier.get_chunk("ab" * 20)
        assert time.monotonic() - t0 < 5.0
    finally:
        _config._overrides.pop("REMOTE_TIER_FAIL", None)
        remote_mod.reset_tier_cache()

    # Latency past the deadline: bounded, typed — not a hang.
    _config._overrides["REMOTE_TIER_FAIL"] = "latency:30"
    _config._overrides["CKPT_REMOTE_TIMEOUT_S"] = 1.0
    remote_mod.reset_tier_cache()
    try:
        tier = remote_mod.get_tier(str(tmp_path / "t"))
        t0 = time.monotonic()
        with pytest.raises(remote_mod.RemoteTierError):
            tier.put_chunk("cd" * 20, b"x")
        assert time.monotonic() - t0 < 10.0
    finally:
        _config._overrides.pop("REMOTE_TIER_FAIL", None)
        _config._overrides.pop("CKPT_REMOTE_TIMEOUT_S", None)
        remote_mod.reset_tier_cache()


# ------------------------------------------------- save-side offloading
def test_save_offloads_committed_checkpoint(cluster, tier_dir):
    rng = np.random.default_rng(2)
    state = {"w": rng.random(500_000).astype(np.float32)}
    cp = dc.AsyncCheckpointer(run="off_run", replication=1)
    cp.save(0, state)
    cp.wait()
    assert cp.last["complete"]
    remote = cp.last["remote"]
    assert remote and remote["ok"], remote
    assert remote["chunks_uploaded"] >= 1
    assert remote["lag_s"] >= 0.0
    man_path = tier_dir / "manifests" / "off_run"
    assert sorted(os.listdir(man_path)) == ["000000000000.r0.json"]
    doc = json.loads((man_path / "000000000000.r0.json").read_text())
    assert doc["run"] == "off_run" and doc["world"] == 1
    # Re-saving unchanged state re-uploads nothing (chunk dedup spans
    # the tier too).
    cp.save(1, state)
    cp.wait()
    assert cp.last["remote"]["chunks_uploaded"] == 0


def test_outage_degrades_save_to_in_cluster(cluster, tier_dir):
    """Tier outage mid-run: the save still COMMITS in-cluster within the
    deadline, the remote result is a typed failure, and the lag alert
    gauge trips."""
    from ray_tpu_torch.checkpoint.saver import REMOTE_ALERT

    _config._overrides["REMOTE_TIER_FAIL"] = "outage"
    _config._overrides["CKPT_REMOTE_TIMEOUT_S"] = 2.0
    remote_mod.reset_tier_cache()
    state = {"w": np.arange(300_000, dtype=np.float32)}
    cp = dc.AsyncCheckpointer(run="outage_run", replication=1)
    t0 = time.monotonic()
    cp.save(0, state)
    cp.wait()
    assert time.monotonic() - t0 < 30.0
    assert cp.last["complete"]  # in-cluster commit unaffected
    assert cp.last["remote"]["ok"] is False
    assert "error" in cp.last["remote"]
    assert REMOTE_ALERT.value(tags={"job": "outage_run"}) == 1.0
    out = dc.restore("outage_run", target=state)
    np.testing.assert_array_equal(out["w"], state["w"])

    # Tier recovers: next save offloads and the alert clears.
    _config._overrides.pop("REMOTE_TIER_FAIL", None)
    remote_mod.reset_tier_cache()
    cp.save(1, {"w": state["w"] + 1.0})
    cp.wait()
    assert cp.last["remote"]["ok"] is True
    assert REMOTE_ALERT.value(tags={"job": "outage_run"}) == 0.0


# ---------------------------------------------------- the remote rung
def test_restore_falls_back_to_remote_tier(cluster, tier_dir):
    """Kill every in-cluster copy (wipe the only store) after the tier
    upload: restore resolves every chunk from the remote tier,
    bit-identical, and records the rung in last_restore_stats."""
    rt = core_api._runtime
    rng = np.random.default_rng(9)
    state = {"w": rng.random(800_000).astype(np.float32)}
    cp = dc.AsyncCheckpointer(run="rr_run", replication=1)
    cp.save(0, state)
    cp.wait()
    assert cp.last["remote"]["ok"]
    man = _head_call("ckpt_manifest", run="rr_run")
    store = ShardStore(rt.core.store)
    for h in man["locations"]:
        store.delete_chunk(h)
    out = dc.restore("rr_run", target=state)
    np.testing.assert_array_equal(out["w"], state["w"])
    stats = restore_mod.last_restore_stats
    assert stats["remote_tier"] == stats["total"] > 0, stats

    # The pulled chunks were re-cached in-cluster and their locations
    # reported to the head — a second restore is all-local.
    out = dc.restore("rr_run", target=state)
    np.testing.assert_array_equal(out["w"], state["w"])
    assert restore_mod.last_restore_stats["remote_tier"] == 0


def test_restore_raises_typed_when_tier_down(cluster, tier_dir):
    """No in-cluster copy AND a dead tier: restore fails with a typed
    error inside the deadline — never a hang."""
    rt = core_api._runtime
    state = {"w": np.arange(300_000, dtype=np.float32)}
    cp = dc.AsyncCheckpointer(run="dead_run", replication=1)
    cp.save(0, state)
    cp.wait()
    man = _head_call("ckpt_manifest", run="dead_run")
    store = ShardStore(rt.core.store)
    for h in man["locations"]:
        store.delete_chunk(h)
    _config._overrides["REMOTE_TIER_FAIL"] = "outage"
    _config._overrides["CKPT_REMOTE_TIMEOUT_S"] = 2.0
    remote_mod.reset_tier_cache()
    t0 = time.monotonic()
    with pytest.raises(remote_mod.RemoteTierError):
        dc.restore("dead_run", target=state)
    assert time.monotonic() - t0 < 30.0


# ------------------------------------------------------- push/pull CLI
def test_ckpt_push_pull_cli(cluster, tmp_path, monkeypatch, capsys):
    """`ckpt push` makes a checkpoint portable; after wiping the
    in-cluster copies, `ckpt pull` re-seeds the store and restore works
    as if the save had happened locally."""
    import ray_tpu_torch.scripts as scripts

    rt = core_api._runtime
    rng = np.random.default_rng(21)
    state = {"w": rng.random(400_000).astype(np.float32)}
    cp = dc.AsyncCheckpointer(run="pp_run", replication=1)
    cp.save(0, state)
    cp.wait()

    monkeypatch.setattr(scripts, "_connect", lambda *a, **k: None)
    tier_root = str(tmp_path / "portable")
    assert scripts.main(
        ["ckpt", "push", "--run", "pp_run", "--tier", tier_root]
    ) == 0
    out = capsys.readouterr().out
    assert "pp_run step 0" in out

    man = _head_call("ckpt_manifest", run="pp_run")
    store = ShardStore(rt.core.store)
    for h in man["locations"]:
        store.delete_chunk(h)

    assert scripts.main(
        ["ckpt", "pull", "--run", "pp_run", "--tier", tier_root, "--json"]
    ) == 0
    reply = json.loads(capsys.readouterr().out)
    assert reply["ok"] and reply["inserted"] >= 1

    out = dc.restore("pp_run", target=state)
    np.testing.assert_array_equal(out["w"], state["w"])
    # Missing run -> typed CLI failure, not a traceback.
    assert scripts.main(
        ["ckpt", "pull", "--run", "nope", "--tier", tier_root]
    ) == 1
