"""The GPU as a scheduled resource in the port's runtime: the GPU manager's
count (FAKE_CHIPS, CUDA_VISIBLE_DEVICES, the /dev/nvidiaN files), with no
card and no CUDA context; ``num_gpus`` as the "GPU" resource; on a cluster
declared with one fake GPU, one GPU task at a time, a GPU placement group
that reserves and releases its bundle, and a request for more GPUs than
the cluster has that stays pending.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import api
from ray_tpu_torch._private.accelerators import gpu
from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager
from ray_tpu_torch.placement import (
    placement_group,
    remove_placement_group,
    slice_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy,
)
from torch_runtime_util import start_cluster, stop_cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_gpu_env(monkeypatch):
    monkeypatch.delenv("RAY_TPU_FAKE_CHIPS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    return monkeypatch


@pytest.mark.parametrize("fake,want", [("3", 3), ("1", 1), ("0", 0)])
def test_count_from_fake_chips(no_gpu_env, fake, want):
    no_gpu_env.setenv("RAY_TPU_FAKE_CHIPS", fake)
    no_gpu_env.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3,4,5,6,7")
    assert GPUAcceleratorManager().detect_count() == want


@pytest.mark.parametrize("visible,want", [
    ("0", 1), ("0,1", 2), ("GPU-8f2c,GPU-11aa,GPU-42", 3), ("", 0),
    ("-1", 0), ("0,-1,2", 1), ("NoDevFiles", 0),
])
def test_count_from_cuda_visible_devices(no_gpu_env, visible, want):
    no_gpu_env.setattr(gpu.glob, "glob", lambda pattern: [
        "/dev/nvidia0", "/dev/nvidia1", "/dev/nvidia2", "/dev/nvidia3"])
    no_gpu_env.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert GPUAcceleratorManager().detect_count() == want


@pytest.mark.parametrize("files,want", [
    (["/dev/nvidia0", "/dev/nvidiactl", "/dev/nvidia-uvm",
      "/dev/nvidia-uvm-tools"], 1),
    # A container that sees another card's file it may not open.
    (["/dev/nvidia0", "/dev/nvidia1", "/dev/nvidiactl"], 1),
    (["/dev/nvidia0", "/dev/nvidia1", "/dev/nvidia2", "/dev/nvidia3",
      "/dev/nvidia4", "/dev/nvidia5", "/dev/nvidia6", "/dev/nvidia7",
      "/dev/nvidiactl", "/dev/nvidia-modeset"], 8),
    (["/dev/nvidiactl"], 0),
    ([], 0),
])
def test_count_from_devfs(no_gpu_env, files, want):
    no_gpu_env.setattr(gpu.glob, "glob", lambda pattern: [
        f for f in files if f.startswith(pattern.rstrip("*"))])
    refused = "/dev/nvidia0" if "/dev/nvidia1" in files and want == 1 else ""
    no_gpu_env.setattr(gpu, "_usable", lambda path: path != refused)
    assert GPUAcceleratorManager().detect_count() == want


def test_usable_opens_the_file(tmp_path):
    ok = tmp_path / "nvidia0"
    ok.write_bytes(b"")
    assert gpu._usable(str(ok))
    assert not gpu._usable(str(tmp_path / "nvidia1"))


def test_detection_leaves_cuda_uninitialized():
    """detect_resources runs in the driver's own process: in a fresh
    process it imports no torch (so it cannot create a CUDA context), and
    torch.cuda.is_initialized() is false after it."""
    code = (
        "import json, sys\n"
        "from ray_tpu_torch.runtime.node import detect_resources\n"
        "res = detect_resources()\n"
        "loaded = 'torch' in sys.modules\n"
        "import torch\n"
        "print(json.dumps({'res': res, 'torch_loaded': loaded,"
        " 'cuda_initialized': torch.cuda.is_initialized()}))\n"
    )
    env = {**os.environ, "RAY_TPU_FAKE_CHIPS": "2",
           "PYTHONPATH": os.pathsep.join(
               [REPO, os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, env=env)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["res"]["GPU"] == 2.0 and got["res"]["CPU"] >= 1.0
    assert not got["torch_loaded"]
    assert not got["cuda_initialized"]


def test_num_gpus_becomes_the_gpu_resource():
    assert api._normalize_options({"num_gpus": 1, "num_cpus": 2}) == {
        "resources": {"GPU": 1.0, "CPU": 2.0}}
    assert api._normalize_options(
        {"num_gpus": 0.5, "resources": {"X": 1}}) == {
        "resources": {"X": 1, "GPU": 0.5}}


# ------------------------------------------------ one fake GPU, a cluster
@pytest.fixture(scope="module")
def cluster():
    with pytest.MonkeyPatch.context() as mp:
        # Declared before init: the node detects its GPUs at start.
        mp.setenv("RAY_TPU_FAKE_CHIPS", "1")
        info = start_cluster(num_cpus=4)
        yield info
        stop_cluster(info)


def test_cluster_has_one_gpu(cluster):
    assert ray_tpu_torch.cluster_resources().get("GPU") == 1.0


def test_one_gpu_task_at_a_time(cluster):
    @ray_tpu_torch.remote(num_gpus=1)
    def hold(seconds):
        start = time.time()
        time.sleep(seconds)
        return start, time.time()

    first = hold.remote(2.0)
    time.sleep(0.5)
    second = hold.remote(0.0)
    ready, _ = ray_tpu_torch.wait([second], timeout=0.8)
    assert not ready, "the second GPU task ran while the first held the GPU"
    (s1, e1), (s2, _) = ray_tpu_torch.get([first, second], timeout=60)
    assert s2 >= e1 - 0.05, "the GPU tasks overlapped"
    # A CPU task is not held back by the GPU.
    @ray_tpu_torch.remote
    def cpu():
        return 1

    slow = hold.remote(1.5)
    assert ray_tpu_torch.get(cpu.remote(), timeout=10) == 1
    ray_tpu_torch.get(slow, timeout=60)


def test_gpu_placement_group_reserves_and_releases(cluster):
    def free_gpu():
        deadline = time.time() + 10
        while True:
            free = ray_tpu_torch.available_resources().get("GPU", 0.0)
            if free == 1.0 or time.time() > deadline:
                return free
            time.sleep(0.1)

    assert free_gpu() == 1.0
    pg = slice_placement_group(1, chips_per_host=1)
    assert pg.bundles == [{"GPU": 1.0, "CPU": 1.0}]

    # The reserved GPU is the bundle's: a plain GPU task must wait.
    @ray_tpu_torch.remote(num_gpus=1)
    def gpu_task():
        return "ran"

    in_bundle = gpu_task.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)).remote()
    assert ray_tpu_torch.get(in_bundle, timeout=30) == "ran"
    waiting = gpu_task.remote()
    ready, _ = ray_tpu_torch.wait([waiting], timeout=1.0)
    assert not ready
    remove_placement_group(pg)
    assert ray_tpu_torch.get(waiting, timeout=30) == "ran"
    assert free_gpu() == 1.0
    # A second group for two GPUs cannot be placed on a one-GPU cluster.
    with pytest.raises(ValueError, match="placement group creation failed"):
        placement_group([{"GPU": 2.0}])
    assert free_gpu() == 1.0


def test_more_gpus_than_the_cluster_has_stays_pending(cluster):
    @ray_tpu_torch.remote(num_gpus=2)
    def too_big():
        return "ran"

    ref = too_big.remote()
    ready, not_ready = ray_tpu_torch.wait([ref], timeout=1.5)
    assert not ready and not_ready == [ref]
    ray_tpu_torch.cancel(ref)


def test_labels_from_the_driver_proc_entry(monkeypatch, tmp_path):
    """The card's model, as the driver's proc entry names it, is the
    node's accelerator-type label; a host without the entry has none."""
    info = tmp_path / "information"
    info.write_text("Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:   \t\t 42\n")
    monkeypatch.setattr(gpu.glob, "glob", lambda pattern: [str(info)])
    assert GPUAcceleratorManager().detect_labels() == {
        "ray_tpu_torch.io/accelerator-type": "NVIDIA H100 80GB HBM3"}
    monkeypatch.setattr(gpu.glob, "glob", lambda pattern: [])
    assert GPUAcceleratorManager().detect_labels() == {}
