"""C++-defined remote functions executed by the port's C++ worker
runtime (port of tests/test_cpp_worker.py: the same cases against the
port's cluster, with the worker built from ray_tpu_torch/cpp/).

The symmetric half of the cross-language story (test_torch_cpp_client.py
covers C++ driver -> Python worker): a PYTHON driver calls functions
registered in a C++ binary with RAYTPU_REMOTE, through the NORMAL task
path — the node manager spawns the configured worker binary for
{"language": "cpp"} leases, the worker registers back over the native
wire and serves push_task, and msgpack crosses the boundary both ways.

(reference: cpp/include/ray/api/ray_remote.h RAY_REMOTE registration +
cpp/src/ray/runtime/task/task_executor.cc worker-side execution.)
"""

import shutil

import pytest

import ray_tpu_torch
from ray_tpu_torch._native import cpp_client
from ray_tpu_torch.exceptions import RayTaskError
from torch_runtime_util import start_cluster, stop_cluster

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ toolchain",
)


@pytest.fixture(scope="module")
def worker_bin():
    return cpp_client.program("raytpu_worker")


@pytest.fixture(scope="module")
def cluster(worker_bin):
    info = start_cluster(
        num_cpus=4,
        _system_config={"CPP_WORKER_CMD": str(worker_bin)},
    )
    yield info
    stop_cluster(info)
    from ray_tpu_torch._private import config as _config

    _config.clear_system_config("CPP_WORKER_CMD")


def test_python_driver_calls_cpp_functions(cluster):
    """Typed adapters (int/double/string) and the raw-Value form, all
    through ray_tpu_torch.get on normal ObjectRefs."""
    add = ray_tpu_torch.cross_language.cpp_function("Add")
    assert ray_tpu_torch.get(add.remote(19, 23)) == 42
    mul = ray_tpu_torch.cross_language.cpp_function("Mul")
    assert ray_tpu_torch.get(mul.remote(2.5, 4.0)) == 10.0
    greet = ray_tpu_torch.cross_language.cpp_function("Greet")
    assert ray_tpu_torch.get(greet.remote("tpu")) == "hello tpu"
    sort = ray_tpu_torch.cross_language.cpp_function("SortInts")
    assert ray_tpu_torch.get(sort.remote([5, 1, 4, 2])) == {
        "n": 4,
        "sorted": [1, 2, 4, 5],
    }


def test_cpp_error_propagates_to_python(cluster):
    boom = ray_tpu_torch.cross_language.cpp_function("Boom")
    with pytest.raises(RayTaskError, match="cpp kaboom"):
        ray_tpu_torch.get(boom.remote(1))
    # Wrong arity is also a task error, not a hang or crash.
    add = ray_tpu_torch.cross_language.cpp_function("Add")
    with pytest.raises(RayTaskError, match="expected 2 arguments"):
        ray_tpu_torch.get(add.remote(1))


def test_unregistered_cpp_function_fails_cleanly(cluster):
    nope = ray_tpu_torch.cross_language.cpp_function("NoSuchFn")
    with pytest.raises(RayTaskError, match="not registered"):
        ray_tpu_torch.get(nope.remote())


def test_cpp_and_python_pools_stay_separate(cluster):
    """A cpp task and a Python task run concurrently; the {language:
    cpp} runtime_env pools cpp workers apart from Python workers, so
    neither language's task ever lands on the other's worker."""

    @ray_tpu_torch.remote
    def py_side(x):
        return x * 2

    add = ray_tpu_torch.cross_language.cpp_function("Add")
    refs = [add.remote(i, i) for i in range(4)]
    py_refs = [py_side.remote(i) for i in range(4)]
    assert ray_tpu_torch.get(refs) == [0, 2, 4, 6]
    assert ray_tpu_torch.get(py_refs) == [0, 2, 4, 6]


def test_cpp_worker_is_reused_across_calls(cluster):
    """Consecutive calls reuse the idle cpp worker instead of spawning
    one binary per task."""
    from ray_tpu_torch import api as core_api

    add = ray_tpu_torch.cross_language.cpp_function("Add")
    ray_tpu_torch.get(add.remote(1, 1))
    node = core_api._runtime.node
    n_before = len(node.workers)
    for i in range(3):
        ray_tpu_torch.get(add.remote(i, i))
    assert len(node.workers) == n_before


def test_invalid_submissions_rejected_up_front(cluster):
    with pytest.raises(ValueError, match=":"):
        ray_tpu_torch.cross_language.cpp_function("bad:name")
    add = ray_tpu_torch.cross_language.cpp_function("Add")
    with pytest.raises(TypeError, match="msgpack"):
        ray_tpu_torch.get(add.remote(object()))


def test_worker_binary_is_the_ports_build(cluster, worker_bin):
    """The node spawned the port's worker build for the cpp lease."""
    from ray_tpu_torch._private import config as _config

    assert _config.get("CPP_WORKER_CMD") == str(worker_bin)
    assert worker_bin.parent == cpp_client.build()
    add = ray_tpu_torch.cross_language.cpp_function("Add")
    assert ray_tpu_torch.get(add.options(max_retries=0).remote(2, 3)) == 5
