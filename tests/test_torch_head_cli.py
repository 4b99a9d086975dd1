"""`ray_tpu_torch head [--json]` CLI + dashboard /api/head smoke tests,
mirroring the `ray_tpu_torch mem` / `ray_tpu_torch slo` observability surfaces.
(port of tests/test_head_cli.py on ray_tpu_torch.scripts)
"""

import json
import subprocess
import sys
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.dashboard import start_dashboard


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=4)
    yield info
    ray_tpu_torch.shutdown()


def test_state_head_stats_surface(cluster):
    from ray_tpu_torch.util import state

    stats = state.head_stats()
    for key in (
        "uptime_s",
        "nodes",
        "fold_queue_depth",
        "fold_queue_max",
        "folded_total",
        "shed_total",
        "overload_alert",
        "pub_msgs_total",
        "pub_pushes_total",
    ):
        assert key in stats, key
    assert stats["nodes"] >= 1
    assert stats["overload_alert"] is False


def test_print_head_renders_without_cluster(capsys):
    """The render path alone — what `ray_tpu_torch head` prints — against a
    canned stats dict, no daemonized cluster needed."""
    from ray_tpu_torch import scripts

    stats = {
        "uptime_s": 12.0,
        "nodes": 3,
        "draining": 1,
        "slices": 1,
        "actors": 2,
        "overload_alert": True,
        "fold_queue_depth": 10,
        "fold_queue_max": 100,
        "folded_total": 500,
        "shed_total": 7,
        "pub_msgs_total": 20,
        "pub_pushes_total": 4,
        "subscriptions": {"node": 2},
        "journal": {
            "size_bytes": 2048,
            "floor_bytes": 1024,
            "watermark_bytes": 4096,
            "compacting": True,
            "last_compaction_ts": None,
            "replayed_records": 42,
            "replay_s": 0.012,
        },
    }
    assert scripts.print_head(stats) == 0
    out = capsys.readouterr().out
    assert "OVERLOAD" in out
    assert "depth=10/100" in out
    assert "shed=7" in out
    assert "(compacting)" in out
    assert "records=42" in out

    assert scripts.print_head(stats, as_json=True) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["shed_total"] == 7


def test_cli_head_json_end_to_end(cluster):
    """The full path: argparse → _connect(--address) → head_stats RPC
    → JSON on stdout, from a fresh subprocess like a real operator."""
    proc = subprocess.run(
        [
            sys.executable,
            "-m",
            "ray_tpu_torch.scripts",
            "--address",
            cluster["address"],
            "head",
            "--json",
        ],
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["nodes"] >= 1
    assert "shed_total" in doc and "fold_queue_depth" in doc

    human = subprocess.run(
        [
            sys.executable,
            "-m",
            "ray_tpu_torch.scripts",
            "--address",
            cluster["address"],
            "head",
        ],
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert human.returncode == 0, human.stderr
    assert "fold queue:" in human.stdout
    assert "pubsub:" in human.stdout


def test_dashboard_api_head(cluster):
    d = start_dashboard()
    try:
        with urllib.request.urlopen(d.url + "/api/head", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["nodes"] >= 1
        assert "fold_queue_depth" in doc
        assert "overload_alert" in doc
    finally:
        d.stop()
