"""Serve: deployments, handles, composition, autoscaling, batching,
multiplexing, HTTP proxy.

(reference test model: python/ray/serve/tests/test_standalone.py,
test_handle.py, test_batching.py, test_multiplex.py — in-process serve
against a single-node cluster.)

The JAX package's serve tests (tests/test_serve.py) on the port's
runtime and serve package, every case kept.
"""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def serve_cluster():
    ray_tpu_torch.init(num_cpus=16)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_function_deployment_and_handle(serve_cluster):
    @serve.deployment
    def double(x):
        return 2 * x

    handle = serve.run(double.bind(), name="fn_app", route_prefix="/double")
    assert handle.remote(21).result(timeout=30) == 42


def test_class_deployment_replicas_and_state(serve_cluster):
    @serve.deployment(num_replicas=2)
    class Counter:
        def __init__(self, start):
            self.n = start

        def __call__(self, inc):
            self.n += inc
            return self.n

    handle = serve.run(Counter.bind(10), name="counter_app")
    results = [handle.remote(1).result(timeout=30) for _ in range(6)]
    # Two replicas each start at 10; six increments split between them.
    assert all(r > 10 for r in results)
    st = serve.status()["counter_app"]["Counter"]
    assert st["status"] == "HEALTHY" and st["replicas"] == 2


def test_composition_injects_child_handles(serve_cluster):
    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre  # DeploymentHandle injected by serve.run

        async def __call__(self, x):
            y = await self.pre.remote(x)
            return y * 10

    handle = serve.run(Model.bind(Preprocess.bind()), name="composed")
    assert handle.remote(4).result(timeout=30) == 50


def test_method_routing_via_options(serve_cluster):
    @serve.deployment
    class Multi:
        def __call__(self, x):
            return ("call", x)

        def other(self, x):
            return ("other", x)

    handle = serve.run(Multi.bind(), name="multi_method")
    assert handle.remote(1).result(timeout=30) == ("call", 1)
    assert handle.other.remote(2).result(timeout=30) == ("other", 2)


def test_batching(serve_cluster):
    @serve.deployment
    class Batcher:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        async def __call__(self, xs):
            # xs is the collected batch; return one result per element.
            return [("batch", len(xs), x) for x in xs]

    handle = serve.run(Batcher.bind(), name="batch_app")
    responses = [handle.remote(i) for i in range(8)]
    out = [r.result(timeout=30) for r in responses]
    sizes = {size for (_tag, size, _x) in out}
    assert {x for (_t, _s, x) in out} == set(range(8))
    # At least one multi-element batch formed under concurrency.
    assert max(sizes) > 1


def test_multiplexed_models(serve_cluster):
    @serve.deployment
    class MuxModel:
        def __init__(self):
            self.loads = 0

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id):
            self.loads += 1
            return {"id": model_id, "load_index": self.loads}

        async def __call__(self, _req):
            model_id = serve.get_multiplexed_model_id()
            model = await self.get_model(model_id)
            return (model["id"], model["load_index"])

    handle = serve.run(MuxModel.bind(), name="mux_app")
    r1 = handle.options(multiplexed_model_id="m1").remote(None).result(timeout=30)
    r2 = handle.options(multiplexed_model_id="m1").remote(None).result(timeout=30)
    r3 = handle.options(multiplexed_model_id="m2").remote(None).result(timeout=30)
    assert r1 == ("m1", 1)
    assert r2 == ("m1", 1)  # cached, not reloaded
    assert r3[0] == "m2"


def test_autoscaling_up_and_down(serve_cluster):
    @serve.deployment(
        max_ongoing_requests=1,
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1,
            max_replicas=3,
            target_ongoing_requests=1,
            downscale_delay_s=1.0,
        ),
    )
    class Slow:
        def __call__(self, _x):
            time.sleep(0.4)
            return "done"

    serve.run(Slow.bind(), name="auto_app")
    handle = serve.get_app_handle("auto_app")
    responses = [handle.remote(i) for i in range(12)]
    _ = [r.result(timeout=60) for r in responses]
    peak = serve.status()["auto_app"]["Slow"]["replicas"]
    assert peak >= 2, f"expected scale-up, saw {peak} replicas"
    deadline = time.time() + 20
    while time.time() < deadline:
        if serve.status()["auto_app"]["Slow"]["replicas"] == 1:
            break
        time.sleep(0.25)
    assert serve.status()["auto_app"]["Slow"]["replicas"] == 1


def test_replica_failure_recovery(serve_cluster):
    @serve.deployment(num_replicas=2)
    class Fragile:
        def __call__(self, x):
            return x

        def die(self):
            import os

            os._exit(1)

    handle = serve.run(Fragile.bind(), name="fragile_app")
    assert handle.remote(1).result(timeout=30) == 1
    # Kill one replica out from under the router.
    try:
        handle.die.remote().result(timeout=10)
    except Exception:
        pass
    # Requests keep succeeding (surviving replica) and the controller
    # eventually restores the target count.
    for i in range(5):
        assert handle.remote(i).result(timeout=30) == i
    deadline = time.time() + 30
    while time.time() < deadline:
        if serve.status()["fragile_app"]["Fragile"]["replicas"] == 2:
            break
        time.sleep(0.25)
    assert serve.status()["fragile_app"]["Fragile"]["replicas"] == 2


def test_http_proxy(serve_cluster):
    @serve.deployment
    def echo(request):
        return {"got": request["body"], "q": request["query"]}

    serve.run(echo.bind(), name="http_app", route_prefix="/echo")
    port = serve.start_http()
    url = f"http://127.0.0.1:{port}/echo?k=v"
    req = urllib.request.Request(
        url, data=json.dumps({"hello": "tpu"}).encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        body = json.loads(resp.read())
    assert body == {"got": {"hello": "tpu"}, "q": {"k": "v"}}


def test_delete_application(serve_cluster):
    @serve.deployment
    def f(_x):
        return "ok"

    serve.run(f.bind(), name="delete_me")
    assert "delete_me" in serve.status()
    serve.delete("delete_me")
    assert "delete_me" not in serve.status()


def test_rpc_ingress(serve_cluster):
    """The native-rpc ingress (gRPC-proxy analogue) routes by deployment
    name and method, no HTTP involved."""

    @serve.deployment
    class Calc:
        def __call__(self, x):
            return x + 1

        def mul(self, x, y):
            return x * y

    serve.run(Calc.bind(), name="rpcapp")

    Ingress = ray_tpu_torch.remote(serve.RpcIngressActor)
    ingress = Ingress.remote()
    addr = ray_tpu_torch.get(ingress.start.remote(), timeout=60)

    assert serve.rpc_request(addr, "Calc", 41, app="rpcapp") == 42
    assert serve.rpc_request(
        addr, "Calc", 6, 7, app="rpcapp", method="mul"
    ) == 42
    with pytest.raises(RuntimeError, match="ingress"):
        serve.rpc_request(addr, "Nope", 1, app="rpcapp")
    ray_tpu_torch.get(ingress.shutdown.remote(), timeout=30)
    ray_tpu_torch.kill(ingress)
    serve.delete("rpcapp")
