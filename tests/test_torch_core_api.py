"""The port's runtime against the JAX package's own expectations: each
case of tests/test_core_api.py (tasks, objects, actors, failures) with the
same assertions, against ``ray_tpu_torch``; then torch tensors through the
object plane, bit for bit, and out of band.
"""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import serialization
from ray_tpu_torch.exceptions import RayTaskError, GetTimeoutError
from torch_runtime_util import start_cluster, stop_cluster


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


def test_task_roundtrip(cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    assert ray_tpu_torch.get(add.remote(1, 2)) == 3


def test_task_chain_and_by_ref_args(cluster):
    @ray_tpu_torch.remote
    def double(x):
        return 2 * x

    ref = double.remote(1)
    for _ in range(4):
        ref = double.remote(ref)
    assert ray_tpu_torch.get(ref) == 32


def test_put_get_large_numpy(cluster):
    arr = np.arange(1_000_000, dtype=np.float32)
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref)
    np.testing.assert_array_equal(arr, out)


def test_large_task_result_via_store(cluster):
    @ray_tpu_torch.remote
    def big():
        return np.ones((512, 512), dtype=np.float64)

    out = ray_tpu_torch.get(big.remote())
    assert out.sum() == 512 * 512


def test_multiple_returns(cluster):
    @ray_tpu_torch.remote(num_returns=3)
    def three():
        return 1, 2, 3

    r1, r2, r3 = three.remote()
    assert ray_tpu_torch.get([r1, r2, r3]) == [1, 2, 3]


def test_task_error_propagates(cluster):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kapow")

    with pytest.raises(RayTaskError, match="kapow"):
        ray_tpu_torch.get(boom.remote())


def test_nested_tasks(cluster):
    @ray_tpu_torch.remote
    def inner(x):
        return x + 1

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x)) * 10

    assert ray_tpu_torch.get(outer.remote(1)) == 20


def test_wait(cluster):
    @ray_tpu_torch.remote
    def fast():
        return "fast"

    @ray_tpu_torch.remote
    def slow():
        time.sleep(2.0)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = ray_tpu_torch.wait([f, s], num_returns=1, timeout=1.5)
    assert ready == [f]
    assert not_ready == [s]
    assert ray_tpu_torch.get(s) == "slow"


def test_get_timeout(cluster):
    @ray_tpu_torch.remote
    def sleepy():
        time.sleep(5)
        return 1

    with pytest.raises(GetTimeoutError):
        ray_tpu_torch.get(sleepy.remote(), timeout=0.5)


def test_actor_state_and_ordering(cluster):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self, k=1):
            self.n += k
            return self.n

        def value(self):
            return self.n

    c = Counter.remote()
    refs = [c.incr.remote() for _ in range(10)]
    assert ray_tpu_torch.get(refs) == list(range(1, 11))
    assert ray_tpu_torch.get(c.value.remote()) == 10


def test_named_actor(cluster):
    @ray_tpu_torch.remote
    class KV:
        def __init__(self):
            self.d = {}

        def set(self, k, v):
            self.d[k] = v
            return True

        def get(self, k):
            return self.d.get(k)

    KV.options(name="kv-store").remote()
    handle = ray_tpu_torch.get_actor("kv-store")
    ray_tpu_torch.get(handle.set.remote("a", 41))
    assert ray_tpu_torch.get(handle.get.remote("a")) == 41


def test_actor_handle_passing(cluster):
    @ray_tpu_torch.remote
    class Holder:
        def __init__(self):
            self.v = 7

        def read(self):
            return self.v

    @ray_tpu_torch.remote
    def use(handle):
        return ray_tpu_torch.get(handle.read.remote()) + 1

    h = Holder.remote()
    assert ray_tpu_torch.get(use.remote(h)) == 8


def test_kill_actor(cluster):
    @ray_tpu_torch.remote
    class Victim:
        def ping(self):
            return "pong"

    v = Victim.remote()
    assert ray_tpu_torch.get(v.ping.remote()) == "pong"
    ray_tpu_torch.kill(v)
    time.sleep(0.5)
    with pytest.raises(Exception):
        ray_tpu_torch.get(v.ping.remote(), timeout=5)


def test_cluster_resources(cluster):
    total = ray_tpu_torch.cluster_resources()
    assert total.get("CPU") == 4.0


# ------------------------------------------------------- torch tensors
def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes, for a bit-for-bit comparison (bf16 included)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def _tensor(dtype, n):
    g = torch.Generator().manual_seed(n)
    return torch.randn(n, generator=g).to(dtype)


# Below and above OUT_OF_BAND_MIN (4096 bytes): 512 elements are 2 KiB in
# fp32 and 1 KiB in bf16; 65536 are 256 / 128 KiB.
TENSOR_CASES = [
    pytest.param(dtype, n, id=f"{str(dtype)[6:]}-{n}")
    for dtype in (torch.float32, torch.bfloat16) for n in (512, 65536)
]


@pytest.mark.parametrize("dtype,n", TENSOR_CASES)
def test_tensor_put_get_bit_for_bit(cluster, dtype, n):
    t = _tensor(dtype, n)
    out = ray_tpu_torch.get(ray_tpu_torch.put(t))
    assert isinstance(out, torch.Tensor)
    assert out.dtype == dtype and out.shape == t.shape
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(_bits(out), _bits(t))


@pytest.mark.parametrize("dtype,n", TENSOR_CASES)
def test_tensor_task_argument_and_result(cluster, dtype, n):
    @ray_tpu_torch.remote
    def roundtrip(x, by_ref):
        # The argument arrives as a tensor of its dtype; the result is a
        # new tensor plus the one that came in.
        return x.dtype, x * 2, x, by_ref[0]

    t = _tensor(dtype, n)
    ref = ray_tpu_torch.put(t)
    got_dtype, doubled, same, nested = ray_tpu_torch.get(
        roundtrip.remote(t, [ref]))
    assert got_dtype == dtype
    np.testing.assert_array_equal(_bits(doubled), _bits(t * 2))
    np.testing.assert_array_equal(_bits(same), _bits(t))
    # A ref nested in an argument stays a ref: the task gets its value
    # with ray_tpu_torch.get only if it asks; here it passes the ref on.
    np.testing.assert_array_equal(
        _bits(ray_tpu_torch.get(nested)), _bits(t))


def test_tensor_strided_and_shaped(cluster):
    base = torch.arange(64 * 96, dtype=torch.float32).reshape(64, 96)
    t = base.to(torch.bfloat16)[::2, 1::3]  # not contiguous
    assert not t.is_contiguous()
    out = ray_tpu_torch.get(ray_tpu_torch.put(t))
    assert out.shape == (32, 32) and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out), _bits(t))
    p = torch.nn.Parameter(torch.ones(4, 4))
    out = ray_tpu_torch.get(ray_tpu_torch.put(p))
    assert isinstance(out, torch.nn.Parameter) and out.requires_grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_tensor_bytes_go_out_of_band(dtype):
    """Above OUT_OF_BAND_MIN the tensor's bytes leave as one out-of-band
    buffer that aliases its storage (no copy on the way out) and appear
    nowhere in the in-band stream; below it they stay in band."""
    t = _tensor(dtype, 65536)
    ser = serialization.serialize(t)
    assert len(ser.buffers) == 1
    buf = np.frombuffer(ser.buffers[0], np.uint8)
    assert buf.nbytes == t.nbytes
    assert buf.ctypes.data == t.data_ptr()
    assert len(ser.inband) < 512
    assert bytes(_bits(t)[:64]) not in ser.inband
    out = serialization.deserialize(ser.inband, ser.buffers)
    np.testing.assert_array_equal(_bits(out), _bits(t))
    small = _tensor(dtype, 512)
    ser = serialization.serialize(small)
    assert ser.buffers == []
    assert small.nbytes < serialization.OUT_OF_BAND_MIN


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA")
def test_cuda_tensor_to_a_process_without_a_card_raises():
    """A CUDA tensor that reaches a process without the card raises: it
    is never moved to the CPU without saying so."""
    t = _tensor(torch.float32, 65536)
    rebuild, args = serialization._reduce_tensor(t)
    assert args[3] == "cpu"
    with pytest.raises(RuntimeError, match="without that CUDA device"):
        rebuild(args[0], args[1], args[2], "cuda:0", *args[4:])


def test_gpu_request_without_a_gpu_stays_pending(cluster):
    """This cluster's node has no GPU (none detected here): a num_gpus
    task is never run on the CPU instead; it waits."""
    assert "GPU" not in ray_tpu_torch.cluster_resources()

    @ray_tpu_torch.remote(num_gpus=1)
    def needs_gpu():
        return "ran"

    ref = needs_gpu.remote()
    ready, not_ready = ray_tpu_torch.wait([ref], timeout=1.5)
    assert not ready and not_ready == [ref]
    ray_tpu_torch.cancel(ref)
