"""Reduced head-survival scale smoke of the port in CI (the JAX
package's tests/test_head_scale_smoke.py against ray_tpu_torch, with the
same floors): the simulated-scale harness
(ray_tpu_torch._private.scale_sim) end to end at toy scale — the port's
CLI-daemonized head, real RPC fake nodes, overdrive + 2x overload, slice
mass death, and a mid-load SIGKILL restart. This keeps the harness
itself honest in tier-1.

Runs in a subprocess so the daemonized head, auth token env, and fd
limit tweaks can't leak into other suites.
"""

import json
import os
import subprocess
import sys

# Floors are deliberately loose: CI shares one core with everything
# else.
FLOORS = {
    "head_register_per_s": ("min", 20.0),
    "head_fold_events_per_s": ("min", 1000.0),
    "head_overload_shed_total": ("min", 1.0),
    "head_death_fanout_coalesce_ratio": ("max", 0.75),
    "head_recover_first_rpc_s": ("max", 20.0),
    "head_recover_full_s": ("max", 60.0),
    "head_backoff_spread_s": ("min", 0.005),
    "head_scale_ok": ("min", 1.0),
}


def test_head_scale_smoke_reduced(tmp_path):
    env = {
        **os.environ,
        "PYTHONPATH": f"{os.path.dirname(os.path.dirname(__file__))}"
        f"{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
    }
    out = tmp_path / "scale.json"
    proc = subprocess.run(
        [
            sys.executable, "-m", "ray_tpu_torch._private.scale_sim",
            "--nodes", "10",
            "--slice-nodes", "3",
            "--subscribers", "2",
            "--overload-s", "1.0",
            "--probe-s", "1.0",
            "--journal-keys", "30",
            "--session-dir", str(tmp_path / "session"),
            "--out", str(out),
        ],
        capture_output=True,
        text=True,
        timeout=480,
        env=env,
    )
    assert proc.returncode == 0, (
        proc.stdout[-2000:],
        proc.stderr[-4000:],
    )
    rows = {}
    for line in proc.stdout.splitlines():
        try:
            r = json.loads(line)
            rows[r["name"]] = r["value"]
        except (ValueError, KeyError):
            continue

    missing = [name for name in FLOORS if name not in rows]
    assert not missing, f"no row for {missing}; got {rows}"
    for name, (kind, bound) in FLOORS.items():
        value = rows[name]
        if kind == "min":
            assert value >= bound, f"{name}: {value} below floor {bound}"
        else:
            assert value <= bound, (
                f"{name}: {value} above ceiling {bound}"
            )

    doc = json.loads(out.read_text())
    # Every fake node survived the head restart and re-registered.
    rec = doc["sigkill_recovery"]
    assert rec["reconnected"] == rec["expected"]
    assert rec["replayed_records"] > 0
    # Fan-out coalescing delivered fewer frames than naive per-msg
    # publication would have.
    md = doc["mass_death"]
    assert md["pushed_frames"] < md["naive_frames"]
