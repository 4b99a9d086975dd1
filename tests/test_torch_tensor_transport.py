"""The device-object transport on the port's runtime: the cases of
tests/test_tensor_transport.py, with torch tensors as well as numpy
arrays. An actor method's result stays in the producing actor's tensor
store and moves point to point to its consumer: over a shared collective
group's send/recv when one exists (the cpu hub's mailbox, or a "nccl"
group's process group, here over gloo), otherwise by the chunked RPC
fetch. Values arrive bit for bit, as tensors where tensors were sent."""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import api as core_api
from ray_tpu_torch import experimental
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import ObjectLostError
from torch_runtime_util import start_cluster, stop_cluster


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


@pytest.fixture(scope="module")
def actors(cluster):
    """One producer/consumer pair shared by all tests (actors pin their
    CPU lease for life)."""
    p = Producer.remote()
    c = Consumer.remote()
    yield p, c
    ray_tpu_torch.kill(p)
    ray_tpu_torch.kill(c)


@ray_tpu_torch.remote
class Producer:
    def make(self, n, fill):
        return np.full(n, fill, dtype=np.float32)

    def make_tensor(self, n, fill, dtype="float32"):
        return torch.full((n,), fill, dtype=getattr(torch, dtype))

    def make_pair(self, n):
        return {"a": np.ones(n), "b": torch.zeros(n)}

    def noop(self):
        return None

    def stored_count(self):
        import ray_tpu_torch.api as api

        return len(api._runtime.core.tensor_store)


@ray_tpu_torch.remote
class Consumer:
    def total(self, arr):
        if isinstance(arr, torch.Tensor):
            return {"tensor": True, "dtype": str(arr.dtype),
                    "sum": float(arr.double().sum())}
        return float(np.asarray(arr).sum())

    def route(self, group):
        from ray_tpu_torch import collective as col

        return col.get_group(group).last_route


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_tensor_ref_resolves_for_driver_and_actor(actors, kind):
    p, c = actors
    make = p.make if kind == "numpy" else p.make_tensor
    ref = make.options(tensor_transport=True).remote(50_000, 2.0)
    meta = experimental.tensor_meta(ref)
    assert meta is not None and meta["src_addr"]
    assert not core_api._runtime.core.store.contains(
        ObjectID.from_hex(ref.hex))
    out = ray_tpu_torch.get(ref, timeout=60)
    if kind == "tensor":
        assert isinstance(out, torch.Tensor)
        assert torch.equal(out, torch.full((50_000,), 2.0))
        assert ray_tpu_torch.get(c.total.remote(ref), timeout=60) == {
            "tensor": True, "dtype": "torch.float32", "sum": 100_000.0}
    else:
        np.testing.assert_array_equal(out, np.full(50_000, 2.0, np.float32))
        assert ray_tpu_torch.get(c.total.remote(ref), timeout=60) == 100_000.0
    assert ray_tpu_torch.get(p.stored_count.remote(), timeout=60) >= 1


@pytest.mark.parametrize("backend,dist_backend",
                         [("cpu", "nccl"), ("nccl", "gloo")])
def test_tensor_transport_via_collective_group(actors, backend,
                                               dist_backend):
    p, c = actors
    experimental.create_collective_group(
        [p, c], backend=backend, group_name="tt",
        dist_backend=dist_backend)
    try:
        ref = p.make_tensor.options(tensor_transport="tt").remote(
            30_000, 3.0, "bfloat16")
        meta = experimental.tensor_meta(ref)
        assert meta["group"] == "tt" and meta["src_rank"] == 0
        assert ray_tpu_torch.get(c.total.remote(ref), timeout=60) == {
            "tensor": True, "dtype": "torch.bfloat16", "sum": 90_000.0}
        if backend == "nccl":
            # The consumer's recv ran on the group's process group (gloo
            # on host tensors), not the RPC fetch.
            assert ray_tpu_torch.get(c.route.remote("tt")) == "gloo"
    finally:
        experimental.destroy_collective_group([p, c], group_name="tt")


def test_pytree_values_fall_back_to_rpc(actors):
    p, _ = actors
    ref = p.make_pair.options(tensor_transport=True).remote(1000)
    out = ray_tpu_torch.get(ref, timeout=60)
    assert set(out) == {"a", "b"} and out["a"].sum() == 1000
    assert isinstance(out["b"], torch.Tensor)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_large_tensor_fetch_is_chunked(actors, kind):
    """Payloads above one rpc chunk stream through the export-buffer
    protocol (fetch_tensor → fetch_tensor_chunk windows)."""
    p, c = actors
    n = 3_000_000  # ~12 MB float32 > 5 MiB chunk size
    make = p.make if kind == "numpy" else p.make_tensor
    ref = make.options(tensor_transport=True).remote(n, 1.5)
    out = ray_tpu_torch.get(ref, timeout=120)
    assert tuple(out.shape) == (n,) and float(out[-1]) == 1.5
    total = ray_tpu_torch.get(c.total.remote(ref), timeout=120)
    assert (total["sum"] if kind == "tensor" else total) == n * 1.5


def test_none_return_is_a_valid_tensor_value(actors):
    p, _ = actors
    ref = p.noop.options(tensor_transport=True).remote()
    assert ray_tpu_torch.get(ref, timeout=60) is None


def test_repeat_get_hits_consumer_cache(actors):
    p, _ = actors
    ref = p.make_tensor.options(tensor_transport=True).remote(20_000, 4.0)
    first = ray_tpu_torch.get(ref, timeout=60)
    meta = experimental.tensor_meta(ref)

    async def drop():
        rt = core_api._runtime
        conn = await rt.core._connect(meta["src_addr"])
        return await conn.call("drop_tensor", oid_hex=ref.hex)

    core_api._runtime.run(drop())
    again = ray_tpu_torch.get(ref, timeout=30)
    assert torch.equal(first, again)


def test_free_tensors_drops_payload(actors):
    """The payload is freed at its producer. A later get walks the
    resolution ladder to its last rung, the remote spill tier
    (``checkpoint.remote``); with no tier configured the object is lost,
    and the get raises ObjectLostError, as the JAX package does."""
    p, _ = actors
    ref = p.make_tensor.options(tensor_transport=True).remote(10_000, 1.0)
    ray_tpu_torch.get(ref, timeout=60)
    assert experimental.free_tensors([ref]) == 1
    assert ray_tpu_torch.get(p.stored_count.remote(), timeout=60) >= 0
    with pytest.raises(ObjectLostError):
        ray_tpu_torch.get(ref, timeout=30)
