"""Reduced control-plane scale smoke of the port in CI (the JAX
package's tests/test_scale_smoke.py against ray_tpu_torch, with the same
floors): 20 nodes x 200 actors x 20 PGs (reference:
release/benchmarks/distributed/test_many_actors.py / test_many_pgs.py —
run here at one-host scale via the documented WORKER_MODE=inproc
simulation; the full 50x1000x50 run is
`python -m ray_tpu_torch._private.scale_smoke`).

Runs in a subprocess so the inproc worker mode and its env knobs can't
leak into other suites.
"""

import json
import os
import subprocess
import sys

N_NODES, N_ACTORS, N_PGS = 20, 200, 20

# Floors are deliberately loose: CI shares one core with everything
# else. A 3x regression still trips these.
FLOORS = {
    f"scale: register {N_NODES} nodes": ("max", 30.0),
    f"scale: {N_ACTORS} actors ready": ("max", 120.0),
    "scale: actor ready throughput": ("min", 5.0),
    "scale: call fan-out all actors": ("min", 200.0),
    "scale: pg throughput": ("min", 20.0),
    "scale: resource view convergence": ("max", 30.0),
}


def test_scale_smoke_reduced(tmp_path):
    env = {
        **os.environ,
        "PYTHONPATH": f"{os.path.dirname(os.path.dirname(__file__))}"
        f"{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
    }
    proc = subprocess.run(
        [
            sys.executable, "-m", "ray_tpu_torch._private.scale_smoke",
            "--nodes", str(N_NODES),
            "--actors", str(N_ACTORS),
            "--pgs", str(N_PGS),
            "--journal-dir", str(tmp_path),
        ],
        capture_output=True,
        text=True,
        timeout=600,
        env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = {}
    for line in proc.stdout.splitlines():
        try:
            r = json.loads(line)
            rows[r["name"]] = r["value"]
        except (ValueError, KeyError):
            continue

    missing = [name for name in FLOORS if name not in rows]
    assert not missing, f"smoke emitted no row for {missing}; got {rows}"
    for name, (kind, bound) in FLOORS.items():
        value = rows[name]
        if kind == "min":
            assert value >= bound, f"{name}: {value} below floor {bound}"
        else:
            assert value <= bound, f"{name}: {value} above ceiling {bound}"

    # The scheduler spread actors over many nodes, not one hot node.
    assert rows.get("scale: nodes hosting actors", 0) >= 3
    # The journal actually recorded the churn.
    assert rows.get("scale: head journal after churn", 0) > 0


def test_throughput_per_node_holds_as_nodes_double(tmp_path):
    """Node-count scaling regression gate (PROFILE_r05.md): at FIXED
    actor load, doubling the node count must not collapse control-plane
    throughput. Before the vectorized scheduler columns, the per-pick
    O(nodes) Python scan bent this curve superlinearly (actor-ready
    throughput FELL when nodes doubled); now the remaining falloff is
    the one-core simulation itself, bounded here at 2.5x."""

    def run(n_nodes, journal_dir):
        env = {
            **os.environ,
            "PYTHONPATH": f"{os.path.dirname(os.path.dirname(__file__))}"
            f"{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
        }
        proc = subprocess.run(
            [
                sys.executable, "-m", "ray_tpu_torch._private.scale_smoke",
                "--nodes", str(n_nodes),
                "--actors", "200",
                "--pgs", "10",
                "--journal-dir", str(journal_dir),
            ],
            capture_output=True, text=True, timeout=600, env=env,
        )
        assert proc.returncode == 0, proc.stderr[-4000:]
        rows = {}
        for line in proc.stdout.splitlines():
            try:
                r = json.loads(line)
                rows[r["name"]] = r["value"]
            except (ValueError, KeyError):
                continue
        return rows

    a = run(16, tmp_path / "a")
    b = run(32, tmp_path / "b")
    for metric in (
        "scale: actor ready throughput",
        "scale: pg throughput",
    ):
        assert b[metric] >= a[metric] / 2.5, (
            f"{metric} collapsed when nodes doubled: "
            f"{a[metric]:.1f} -> {b[metric]:.1f}"
        )
