"""Serve replicas on the port's GPU resource, and what importing the
port's serve and dag packages loads.

A replica declared with ``ray_actor_options={"num_gpus": n}`` is leased
the "GPU" resource (the controller's ``_start_replica``), on a cluster
declared with one fake GPU: it holds the GPU while it lives, a second
whole-GPU replica stays pending until the first is deleted, two
half-GPU replicas share the card, and deleting every application gives
the GPU back.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def gpu_cluster():
    with pytest.MonkeyPatch.context() as mp:
        # Declared before init: the node detects its GPUs at start.
        mp.setenv("RAY_TPU_FAKE_CHIPS", "1")
        ray_tpu_torch.init(num_cpus=4)
        try:
            yield
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()


def _free_gpu_becomes(want, timeout=15.0) -> float:
    deadline = time.monotonic() + timeout
    while True:
        free = ray_tpu_torch.available_resources().get("GPU", 0.0)
        if free == want or time.monotonic() > deadline:
            return free
        time.sleep(0.1)


def _replicas(app, name) -> int:
    return serve.status().get(app, {}).get(name, {}).get("replicas", 0)


@serve.deployment(ray_actor_options={"num_gpus": 1})
class WholeGpu:
    def __call__(self, x):
        return ("whole", x)


def test_whole_gpu_replica_holds_the_gpu(gpu_cluster):
    assert ray_tpu_torch.cluster_resources().get("GPU") == 1.0
    first = serve.run(WholeGpu.bind(), name="gpu_first")
    assert first.remote(1).result(timeout=30) == ("whole", 1)
    assert _free_gpu_becomes(0.0) == 0.0

    # A second whole-GPU replica cannot be placed while the first lives.
    serve.run(WholeGpu.bind(), name="gpu_second", _blocking=False)
    time.sleep(2.0)
    assert _replicas("gpu_second", "WholeGpu") == 0
    assert serve.status()["gpu_second"]["WholeGpu"]["status"] != "HEALTHY"

    serve.delete("gpu_first")
    deadline = time.monotonic() + 30
    while _replicas("gpu_second", "WholeGpu") < 1:
        assert time.monotonic() < deadline, "the pending replica never ran"
        time.sleep(0.2)
    second = serve.get_app_handle("gpu_second")
    assert second.remote(2).result(timeout=30) == ("whole", 2)
    assert _free_gpu_becomes(0.0) == 0.0
    serve.delete("gpu_second")
    assert _free_gpu_becomes(1.0) == 1.0


def test_half_gpu_replicas_share_the_card(gpu_cluster):
    @serve.deployment(num_replicas=2, ray_actor_options={"num_gpus": 0.5})
    class HalfGpu:
        def __call__(self, _):
            return os.getpid()

    handle = serve.run(HalfGpu.bind(), name="gpu_halves")
    assert _replicas("gpu_halves", "HalfGpu") == 2
    pids = {handle.remote(None).result(timeout=30) for _ in range(16)}
    assert len(pids) == 2, "both half-GPU replicas answer"
    assert _free_gpu_becomes(0.0) == 0.0
    serve.delete("gpu_halves")
    assert _free_gpu_becomes(1.0) == 1.0


def test_serve_and_dag_import_without_grpc_jax_or_ray_tpu():
    """``grpc`` and ``google.protobuf`` are imported inside the gRPC
    ingress's functions only: with both unimportable the packages load,
    and they load no ``jax`` and nothing of the JAX package."""
    code = (
        "import json, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top == 'grpc' or name.startswith('google.protobuf'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.dag\n"
        "import ray_tpu_torch.llm.serve_integration\n"
        "from ray_tpu_torch.serve import start_grpc, start_http\n"
        "from ray_tpu_torch.dag import InputNode, allreduce\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'grpc')\n"
        "    or m.startswith('google.protobuf'))))\n"
    )
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
