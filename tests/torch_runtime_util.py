"""One cluster of the port's runtime per test module, shut down with a
check that it left nothing behind: no store segment under /dev/shm and no
worker process of this test process still alive.

Only ``ray_tpu_torch``'s runtime is started here: both runtimes keep
module-level state, so a test process never holds a ``ray_tpu`` runtime
beside it.
"""

from __future__ import annotations

import glob
import os
import time

import ray_tpu_torch


def _children() -> set[int]:
    """Live (non-zombie) child processes of this process."""
    me = os.getpid()
    out = set()
    for stat in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(stat) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.add(int(stat.split("/")[2]))
    return out


def start_cluster(**kwargs) -> dict:
    before = _children()
    info = ray_tpu_torch.init(**kwargs)
    info["children_before"] = before
    return info


def stop_cluster(info: dict, timeout: float = 15.0) -> None:
    """Shut the runtime down and fail if its store segment or one of its
    worker processes outlives it."""
    ray_tpu_torch.shutdown()
    segments = glob.glob(f"/dev/shm/ray_tpu_torch-{info['session']}*")
    assert not segments, f"store segments left behind: {segments}"
    deadline = time.monotonic() + timeout
    while True:
        left = _children() - info["children_before"]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    assert not left, f"worker processes left behind: {sorted(left)}"
