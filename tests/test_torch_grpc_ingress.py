"""gRPC Serve ingress: standard-protocol data plane for non-Python
clients (reference test model: python/ray/serve/tests/test_grpc.py —
unary + server-streaming calls through gRPCProxy, app routing by
metadata, NOT_FOUND/INTERNAL status mapping).

The JAX package's gRPC ingress tests (tests/test_grpc_ingress.py) on
the port's runtime and serve package, every case kept; the auth case's
subprocess imports no jax.
"""

import grpc
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.grpc_ingress import SERVICE_NAME, grpc_request, grpc_stream
from ray_tpu_torch.serve.protos import serve_pb2


@pytest.fixture(scope="module")
def ingress_addr():
    ray_tpu_torch.init(num_cpus=8)

    @serve.deployment
    class Echo:
        def __call__(self, x):
            return {"echo": x}

        def shout(self, x):
            return str(x).upper()

    @serve.deployment
    class Tokens:
        def __call__(self, n):
            for i in range(int(n)):
                yield f"tok{i}"

    @serve.deployment
    class Bytes:
        def __call__(self, payload):
            assert isinstance(payload, bytes)
            return payload[::-1]

    @serve.deployment
    class Boom:
        def __call__(self, x):
            raise ValueError("kaboom")

    serve.run(Echo.bind(), name="echo_app")
    serve.run(Tokens.bind(), name="tok_app")
    serve.run(Bytes.bind(), name="bytes_app")
    serve.run(Boom.bind(), name="boom_app")
    port = serve.start_grpc()
    yield f"127.0.0.1:{port}"
    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_unary_json_roundtrip(ingress_addr):
    out = grpc_request(
        ingress_addr, application="echo_app", payload={"k": [1, 2]}
    )
    assert out == {"echo": {"k": [1, 2]}}


def test_unary_method_dispatch(ingress_addr):
    out = grpc_request(
        ingress_addr, application="echo_app", method="shout", payload="hi"
    )
    assert out == "HI"


def test_unary_bytes_passthrough(ingress_addr):
    out = grpc_request(
        ingress_addr, application="bytes_app", payload=b"\x00\x01\x02"
    )
    assert out == b"\x02\x01\x00"


def test_server_streaming(ingress_addr):
    items = list(grpc_stream(ingress_addr, application="tok_app", payload=4))
    assert items == ["tok0", "tok1", "tok2", "tok3"]


def test_unknown_app_is_not_found(ingress_addr):
    with pytest.raises(grpc.RpcError) as ei:
        grpc_request(ingress_addr, application="nope", payload=1)
    assert ei.value.code() == grpc.StatusCode.NOT_FOUND


def test_replica_error_is_internal(ingress_addr):
    with pytest.raises(grpc.RpcError) as ei:
        grpc_request(ingress_addr, application="boom_app", payload=1)
    assert ei.value.code() == grpc.StatusCode.INTERNAL
    assert "kaboom" in ei.value.details()


def test_list_applications_and_healthz(ingress_addr):
    """Raw-channel calls, the way a non-Python client would construct
    them from the committed .proto."""
    with grpc.insecure_channel(ingress_addr) as ch:
        apps = ch.unary_unary(
            f"/{SERVICE_NAME}/ListApplications",
            request_serializer=(
                serve_pb2.ListApplicationsRequest.SerializeToString
            ),
            response_deserializer=(
                serve_pb2.ListApplicationsReply.FromString
            ),
        )(serve_pb2.ListApplicationsRequest(), timeout=30)
        assert {"echo_app", "tok_app"} <= set(apps.application_names)

        hz = ch.unary_unary(
            f"/{SERVICE_NAME}/Healthz",
            request_serializer=serve_pb2.HealthzRequest.SerializeToString,
            response_deserializer=serve_pb2.HealthzReply.FromString,
        )(serve_pb2.HealthzRequest(), timeout=30)
        assert hz.message == "success"


def test_proto_wire_format_is_stable(ingress_addr):
    """The committed serve_pb2 must encode with standard proto3 field
    numbers so foreign-language stubs interoperate."""
    req = serve_pb2.ServeRequest(
        application="a", deployment="d", method="m", payload=b"p",
        content_type="json",
    )
    raw = req.SerializeToString()
    # field 1 (application) tag 0x0a, field 4 (payload) tag 0x22
    assert b"\x0a\x01a" in raw and b"\x22\x01p" in raw


# --------------------------------------------------- round-5 depth


def test_bidi_chat_turns(ingress_addr):
    """Each inbound message's stream completes before the next turn —
    the token-in/token-out shape (reference: gRPCProxy streaming)."""
    from ray_tpu_torch.serve.grpc_ingress import grpc_chat

    items = list(
        grpc_chat(ingress_addr, [2, 3], application="tok_app")
    )
    # Turn 0 yields tok0..tok1, then turn 1 yields tok0..tok2 — the
    # ordering proves the server finished turn 0's stream before
    # consuming turn 1's message.
    assert items == ["tok0", "tok1", "tok0", "tok1", "tok2"]


def test_effective_timeout_prefers_tighter_bound():
    """The propagation rule itself: the gRPC client's remaining
    deadline caps the per-deployment timeout (and each covers for the
    other's absence). The e2e test below can't distinguish a local
    client deadline from a server abort, so the rule is gated here."""
    from ray_tpu_torch.serve.grpc_ingress import _effective_timeout

    class Ctx:
        def __init__(self, remaining):
            self._r = remaining

        def time_remaining(self):
            return self._r

    assert _effective_timeout(60.0, Ctx(1.5)) == 1.5
    assert _effective_timeout(0.5, Ctx(1.5)) == 0.5
    assert _effective_timeout(None, Ctx(1.5)) == 1.5
    assert _effective_timeout(60.0, Ctx(None)) == 60.0
    assert _effective_timeout(None, Ctx(None)) is None


def test_deadline_propagates_to_handle_wait(ingress_addr):
    """A short client deadline must bound the server-side handle wait
    (DEADLINE_EXCEEDED), even though the per-deployment timeout is much
    larger."""

    @serve.deployment
    class Slow:
        async def __call__(self, x):
            import asyncio

            await asyncio.sleep(30)
            return x

    serve.run(Slow.bind(), name="slow_app")
    with pytest.raises(grpc.RpcError) as err:
        grpc_request(
            ingress_addr, application="slow_app", payload=1, timeout=1.5
        )
    assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED


def test_auth_interceptor_honors_cluster_token(tmp_path):
    """An ingress started with require_auth admits only calls carrying
    the cluster token as Bearer metadata; Healthz stays open. Runs in
    its OWN cluster: the token must be set before init (mid-session
    token flips desynchronize existing plaintext server loops)."""
    import subprocess
    import sys

    code = """
import grpc
import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve.grpc_ingress import SERVICE_NAME, grpc_request
from ray_tpu_torch.serve.protos import serve_pb2

ray_tpu_torch.init(num_cpus=4, _system_config={"AUTH_TOKEN": "grpc-test-token"})

@serve.deployment
class Echo:
    def __call__(self, x):
        return {"echo": x}

serve.run(Echo.bind(), name="echo_app")
port = serve.start_grpc(require_auth=True)
addr = f"127.0.0.1:{port}"
try:
    grpc_request(addr, application="echo_app", payload=1)
    raise AssertionError("no-token call was admitted")
except grpc.RpcError as e:
    assert e.code() == grpc.StatusCode.UNAUTHENTICATED, e
try:
    grpc_request(addr, application="echo_app", payload=1, token="wrong")
    raise AssertionError("wrong-token call was admitted")
except grpc.RpcError as e:
    assert e.code() == grpc.StatusCode.UNAUTHENTICATED, e
out = grpc_request(addr, application="echo_app", payload=7,
                   token="grpc-test-token")
assert out == {"echo": 7}, out
with grpc.insecure_channel(addr) as channel:
    healthz = channel.unary_unary(
        f"/{SERVICE_NAME}/Healthz",
        request_serializer=serve_pb2.HealthzRequest.SerializeToString,
        response_deserializer=serve_pb2.HealthzReply.FromString,
    )
    assert healthz(serve_pb2.HealthzRequest()).message == "success"
print("AUTH INTERCEPTOR OK")
ray_tpu_torch.shutdown()
"""
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=180,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "AUTH INTERCEPTOR OK" in out.stdout
