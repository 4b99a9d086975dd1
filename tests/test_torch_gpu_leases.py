"""A GPU lease of the port's runtime is bound to its own card: on a node
of four fake cards (``RAY_TPU_FAKE_CHIPS=4``, ids "0".."3"), each whole
lease takes whole free cards, a fraction takes a share of one card, the
lease's worker starts with ``CUDA_VISIBLE_DEVICES`` naming its cards and
``CUDA_DEVICE_ORDER=PCI_BUS_ID``, idle workers are pooled by card set,
placement-group bundles hold their cards, and CPU leases keep the
driver's environment. The node's ``available["GPU"]`` moves as before.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import api
from ray_tpu_torch.placement import placement_group, remove_placement_group
from ray_tpu_torch.runtime.node import fit_cards, node_gpu_ids, pool_key
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
from ray_tpu_torch.train.trainer import _bind_leased_cards
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy,
)
from torch_runtime_util import start_cluster, stop_cluster

CARDS = ["0", "1", "2", "3"]


def _view():
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            os.environ.get("CUDA_DEVICE_ORDER"), os.getpid())


@ray_tpu_torch.remote
class Holder:
    def view(self):
        return _view()


@ray_tpu_torch.remote
def view_task():
    return _view()


@pytest.fixture(scope="module")
def cluster():
    with pytest.MonkeyPatch.context() as mp:
        # Declared before init: the node detects its cards at start.
        mp.setenv("RAY_TPU_FAKE_CHIPS", "4")
        info = start_cluster(num_cpus=12)
        yield info
        stop_cluster(info)


def _node():
    return api._runtime.node


def _all_free(timeout=15.0):
    """Wait for every card and the GPU count to come back, at the node
    and in the head's view (which placement groups are planned on);
    returns the node's card view and its available GPU."""
    deadline = time.monotonic() + timeout
    while True:
        node = _node()
        free = dict(node.gpu_free)
        if (free == dict.fromkeys(CARDS, 1.0)
                and node.available.get("GPU") == 4.0
                and ray_tpu_torch.available_resources().get("GPU") == 4.0
                or time.monotonic() > deadline):
            return free, node.available.get("GPU")
        time.sleep(0.1)


def _wait_idle(pid, timeout=15.0):
    """Until the owner returned the lease of the worker ``pid``: True
    once it idles, False if the node's idle cap retired it first."""
    deadline = time.monotonic() + timeout
    while True:
        w = next((w for w in _node().workers.values()
                  if w.get("pid") == pid), None)
        if w is None or w.get("state") == "idle":
            return w is not None
        assert time.monotonic() < deadline, f"worker {pid} never idled"
        time.sleep(0.05)


def _kill(*actors):
    for a in actors:
        ray_tpu_torch.kill(a)


# ------------------------------------------------------------ units
@pytest.mark.parametrize("gpus,free,want", [
    (0, {"0": 1.0}, {}),
    (1, {"0": 1.0, "1": 1.0}, {"0": 1.0}),
    (2, {"0": 0.5, "1": 1.0, "2": 1.0}, {"1": 1.0, "2": 1.0}),
    (1, {"0": 0.5, "1": 0.5}, None),
    (0.5, {"0": 0.25, "1": 0.75}, {"1": 0.5}),
    (0.5, {"0": 0.25, "1": 0.25}, None),
    (1.5, {"0": 1.0, "1": 1.0}, None),
    (0.25, {"0": 0.25}, {"0": 0.25}),
], ids=["none", "whole", "two_whole_skip_shared", "whole_needs_a_free_card",
        "fraction_first_fit", "fraction_never_straddles", "non_whole_above_one",
        "exact_share"])
def test_fit_cards(gpus, free, want):
    assert fit_cards(gpus, free) == want


def test_node_card_ids(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FAKE_CHIPS", "2")
    assert node_gpu_ids(2) == ["0", "1"]
    # A node told of more GPUs than it shows names the rest past the
    # last: a lease there sees no device, never the first card.
    assert node_gpu_ids(4) == ["0", "1", "2", "3"]
    assert node_gpu_ids(0) == []
    monkeypatch.setenv("RAY_TPU_FAKE_CHIPS", "")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,1")
    assert node_gpu_ids(2) == ["3", "1"]
    assert pool_key("h", ()) == "h"
    assert pool_key("h", ("3", "1")) != pool_key("h", ("1",))


def test_devfs_card_ids_number_the_usable_cards(monkeypatch):
    """A container given /dev/nvidia1 and /dev/nvidia3 (and shown
    /dev/nvidia0, which it may not open) has cards "0" and "1": CUDA
    numbers the cards it can open from 0, in PCI (minor) order."""
    from ray_tpu_torch._private.accelerators import gpu

    monkeypatch.setenv("RAY_TPU_FAKE_CHIPS", "")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(gpu.glob, "glob", lambda pattern: [
        "/dev/nvidia3", "/dev/nvidia0", "/dev/nvidia1", "/dev/nvidiactl"])
    monkeypatch.setattr(gpu, "_usable", lambda path: path != "/dev/nvidia0")
    assert gpu.GPUAcceleratorManager().detect_ids() == ["0", "1"]
    assert node_gpu_ids(2) == ["0", "1"]


def test_cuda_driver_check_reads_the_process_map(tmp_path):
    from ray_tpu_torch.runtime.core_worker import _cuda_driver_loaded

    maps = tmp_path / "maps"
    maps.write_text("7f00-7f01 r-xp 0 08:01 1 /usr/lib/libc.so.6\n")
    assert not _cuda_driver_loaded(str(maps))
    maps.write_text("7f00-7f01 r-xp 0 08:01 1 /usr/lib/libcuda.so.1\n")
    assert _cuda_driver_loaded(str(maps))
    assert _cuda_driver_loaded(str(tmp_path / "missing"))
    # This test process (CPU torch) never loaded the driver.
    assert not _cuda_driver_loaded()


def test_nccl_worker_refuses_a_view_without_its_card(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    with pytest.raises(RuntimeError, match="whole cards of its own"):
        _bind_leased_cards(1)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    with pytest.raises(RuntimeError, match="whole cards of its own"):
        _bind_leased_cards(1)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2")
    with pytest.raises(RuntimeError, match="whole cards of its own"):
        _bind_leased_cards(0.5)
    # One card named, but CUDA shows this CPU-only process none.
    with pytest.raises(RuntimeError, match="CUDA shows 0 devices"):
        _bind_leased_cards(1)


# ------------------------------------------------------------ the node
def test_node_has_four_cards(cluster):
    assert ray_tpu_torch.cluster_resources().get("GPU") == 4.0
    assert list(_node().gpu_free) == CARDS


def test_four_whole_actors_see_four_cards(cluster):
    actors = [Holder.options(num_gpus=1).remote() for _ in range(4)]
    views = ray_tpu_torch.get([a.view.remote() for a in actors], timeout=60)
    assert sorted(v[0] for v in views) == CARDS
    assert {v[1] for v in views} == {"PCI_BUS_ID"}
    assert _node().gpu_free == dict.fromkeys(CARDS, 0.0)
    assert _node().available["GPU"] == 0.0
    _kill(*actors)
    # Killed actors give their cards back.
    assert _all_free() == (dict.fromkeys(CARDS, 1.0), 4.0)


def test_half_actors_share_one_card(cluster):
    a, b = (Holder.options(num_gpus=0.5).remote() for _ in range(2))
    va, vb = ray_tpu_torch.get([a.view.remote(), b.view.remote()],
                               timeout=60)
    assert va[0] == vb[0] == "0"
    assert _node().gpu_free == {"0": 0.0, "1": 1.0, "2": 1.0, "3": 1.0}
    assert _node().available["GPU"] == 3.0
    _kill(a, b)
    assert _all_free() == (dict.fromkeys(CARDS, 1.0), 4.0)


def test_two_gpu_task_gets_two_cards(cluster):
    cards, order, _ = ray_tpu_torch.get(
        view_task.options(num_gpus=2).remote(), timeout=60)
    assert cards == "0,1" and order == "PCI_BUS_ID"
    assert _all_free() == (dict.fromkeys(CARDS, 1.0), 4.0)


def test_fraction_never_straddles_two_cards(cluster):
    """Four 0.75 leases take a card each; a 0.5 lease then waits, though
    a whole GPU is free in quarters over the four cards."""
    actors = [Holder.options(num_gpus=0.75).remote() for _ in range(4)]
    views = ray_tpu_torch.get([a.view.remote() for a in actors], timeout=60)
    assert sorted(v[0] for v in views) == CARDS
    assert _node().available["GPU"] == pytest.approx(1.0)
    assert _node().gpu_free == dict.fromkeys(CARDS, 0.25)
    waiting = view_task.options(num_gpus=0.5).remote()
    ready, _ = ray_tpu_torch.wait([waiting], timeout=1.5)
    assert not ready
    _kill(actors[2])
    cards, _, _ = ray_tpu_torch.get(waiting, timeout=60)
    assert cards == "2"
    _kill(*actors[:2], actors[3])
    assert _all_free() == (dict.fromkeys(CARDS, 1.0), 4.0)


def test_available_gpu_moves_as_before(cluster):
    """available["GPU"] is the sum of what the leases hold, whatever
    cards they are bound to."""
    seen = [_node().available["GPU"]]
    a = Holder.options(num_gpus=0.5).remote()
    ray_tpu_torch.get(a.view.remote(), timeout=60)
    seen.append(_node().available["GPU"])
    b = Holder.options(num_gpus=2).remote()
    ray_tpu_torch.get(b.view.remote(), timeout=60)
    seen.append(_node().available["GPU"])
    c = Holder.options(num_gpus=0.25).remote()
    ray_tpu_torch.get(c.view.remote(), timeout=60)
    seen.append(_node().available["GPU"])
    assert seen == [4.0, 3.5, 1.5, 1.25]
    # 0.5 and 0.25 share card 0; the two whole cards are 1 and 2.
    assert _node().gpu_free == {"0": 0.25, "1": 0.0, "2": 0.0, "3": 1.0}
    _kill(a, b, c)
    assert _all_free() == (dict.fromkeys(CARDS, 1.0), 4.0)


def test_bundles_hold_their_cards(cluster):
    pg = placement_group([{"GPU": 1.0, "CPU": 1.0}] * 4)
    assert _node().gpu_free == dict.fromkeys(CARDS, 0.0)
    views = ray_tpu_torch.get([
        view_task.options(
            num_gpus=1, scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=i)).remote()
        for i in range(4)], timeout=60)
    assert sorted(v[0] for v in views) == CARDS
    # A lease outside the group finds no card.
    waiting = view_task.options(num_gpus=1).remote()
    ready, _ = ray_tpu_torch.wait([waiting], timeout=1.0)
    assert not ready
    remove_placement_group(pg)
    assert ray_tpu_torch.get(waiting, timeout=60)[0] in CARDS
    assert _all_free() == (dict.fromkeys(CARDS, 1.0), 4.0)


def test_idle_worker_of_one_card_never_serves_another(cluster):
    """Two bundles pin cards 0 and 1: the worker card 0's task left idle
    is not the one that serves card 1's."""
    pg = placement_group([{"GPU": 1.0, "CPU": 1.0}] * 2)

    def in_bundle(i):
        return view_task.options(
            num_gpus=1, scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=i)).remote()

    first = ray_tpu_torch.get(in_bundle(0), timeout=60)
    _wait_idle(first[2])  # the worker idles in card 0's pool
    other = ray_tpu_torch.get(in_bundle(1), timeout=60)
    again = ray_tpu_torch.get(in_bundle(0), timeout=60)
    assert (first[0], other[0], again[0]) == ("0", "1", "0")
    assert other[2] not in (first[2], again[2])
    # Every live worker's pool is the card set its process sees.
    pids = {v[2]: v[0] for v in (first, other, again)}
    for w in _node().workers.values():
        if w.get("pid") in pids:
            assert w["cards"] == (pids[w["pid"]],)
    remove_placement_group(pg)
    assert _all_free() == (dict.fromkeys(CARDS, 1.0), 4.0)


def test_cpu_leases_keep_the_driver_environment(cluster):
    cards, order, _ = ray_tpu_torch.get(view_task.remote(), timeout=60)
    assert cards == os.environ.get("CUDA_VISIBLE_DEVICES")
    assert order == os.environ.get("CUDA_DEVICE_ORDER")
    assert _node().gpu_free == dict.fromkeys(CARDS, 1.0)


@ray_tpu_torch.remote
class Loaded:
    """Maps a file named like the CUDA driver, as a process that
    initialized CUDA has."""

    def load(self, path):
        import mmap
        import os

        self.f = open(path, "rb")
        self.m = mmap.mmap(self.f.fileno(), 0, access=mmap.ACCESS_READ)
        return os.getpid()


def test_idle_cpu_worker_without_cuda_is_rebound_to_a_card(cluster,
                                                           tmp_path):
    """A GPU lease with no idle worker of its cards takes an idle CPU
    worker that never loaded the CUDA driver: it sees the lease's card
    from then on and serves CPU leases no more. A worker that mapped
    libcuda refuses and stays a CPU worker."""
    env = {"env_vars": {"GPU_LEASES_REBIND": "1"}}  # a pool of its own

    @ray_tpu_torch.remote(runtime_env=env)
    def cpu_view():
        return _view()

    cards, _, pid = ray_tpu_torch.get(cpu_view.remote(), timeout=60)
    assert cards == os.environ.get("CUDA_VISIBLE_DEVICES")
    assert _wait_idle(pid)  # its lease returned: it idles in the pool
    rebound = ray_tpu_torch.get(view_task.options(
        num_gpus=1, runtime_env=env).remote(), timeout=60)
    assert rebound == ("0", "PCI_BUS_ID", pid)
    _wait_idle(pid)
    assert ray_tpu_torch.get(cpu_view.remote(), timeout=60)[2] != pid

    lib = tmp_path / "libcuda.so.1"
    lib.write_bytes(b"\0" * 4096)
    holder = Loaded.options(runtime_env=env).remote()
    loaded_pid = ray_tpu_torch.get(holder.load.remote(str(lib)), timeout=60)
    w = next(w for w in _node().workers.values()
             if w.get("pid") == loaded_pid)
    w.pop("cuda_loaded", None)
    assert not _cuda_refusal(w)
    ray_tpu_torch.kill(holder)
    assert _all_free() == (dict.fromkeys(CARDS, 1.0), 4.0)


def _cuda_refusal(w):
    """Ask the worker of record ``w`` to bind card 3, as the node does."""
    rt = api._runtime

    async def ask():
        from ray_tpu_torch._private import rpc

        conn = await rpc.connect(w["addr"], retries=1)
        try:
            return await conn.call("bind_cards", cards="3")
        finally:
            await conn.close()

    return rt.run(ask()).get("ok")


def test_a_gpu_lease_no_card_can_hold_is_refused(cluster):
    """1.5 GPUs fit no card set: the node refuses the lease as
    infeasible (it stays pending, as a request for more GPUs than the
    cluster has does), and no card is taken for it."""
    ref = view_task.options(num_gpus=1.5).remote()
    ready, _ = ray_tpu_torch.wait([ref], timeout=1.5)
    assert not ready
    assert _node().gpu_free == dict.fromkeys(CARDS, 1.0)
    assert _node()._feasible({"GPU": 1.5}) is False
    assert _node()._feasible({"GPU": 4.0}) is True
    ray_tpu_torch.cancel(ref)
    assert _all_free() == (dict.fromkeys(CARDS, 1.0), 4.0)


def test_trainer_workers_get_distinct_cards(cluster, tmp_path):
    """TorchTrainer, 4 workers of one GPU each on gloo: each worker's
    bundle brings a card of its own."""
    out = tmp_path / "views"
    out.mkdir()

    def loop(config):
        import os

        import ray_tpu_torch.train as train

        ctx = train.get_context()
        with open(os.path.join(config["out"], str(ctx.rank)), "w") as f:
            f.write(os.environ.get("CUDA_VISIBLE_DEVICES", ""))
        train.report({"rank": ctx.rank})

    result = TorchTrainer(
        loop, train_loop_config={"out": str(out)},
        scaling_config=ScalingConfig(num_workers=4, use_gpu=True,
                                     gpus_per_worker=1, distributed=True,
                                     dist_backend="gloo"),
        run_config=RunConfig(name="cards", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    views = [(out / str(r)).read_text() for r in range(4)]
    assert sorted(views) == CARDS
    assert _all_free() == (dict.fromkeys(CARDS, 1.0), 4.0)
