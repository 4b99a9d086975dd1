"""Proxy robustness: chunked request bodies, duplicate headers,
body-size caps, in-flight load shedding, per-deployment timeouts.

(reference test model: python/ray/serve/tests/test_proxy.py +
test_request_timeout.py — request handling edge cases against
serve/_private/proxy.py:710.)

The JAX package's proxy tests (tests/test_proxy_hardening.py) on the
port's runtime and serve package, every case kept.
"""

import concurrent.futures
import json
import socket
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


def _custom_proxy(**kwargs):
    """A throwaway proxy with non-default caps (start_http() is the
    shared, default-capped singleton)."""
    from ray_tpu_torch.serve.proxy import ProxyActor

    proxy = (
        ray_tpu_torch.remote(ProxyActor)
        .options(max_concurrency=100, num_cpus=0.1)
        .remote("127.0.0.1", 0, **kwargs)
    )
    return proxy, ray_tpu_torch.get(proxy.get_port.remote())


def _recv_response(s):
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = s.recv(65536)
        if not chunk:
            return buf
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    clen = 0
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            clen = int(line.split(b":")[1])
    while len(rest) < clen:
        chunk = s.recv(65536)
        if not chunk:
            break
        rest += chunk
    return head + b"\r\n\r\n" + rest


def test_chunked_request_body(serve_cluster):
    """A chunked body is decoded, and the connection stays in sync for
    the next pipelined request (no request smuggling)."""

    @serve.deployment
    def chk(request):
        body = request["body"]
        if isinstance(body, bytes):
            body = body.decode()
        return {"body": body}

    serve.run(chk.bind(), name="chk_app", route_prefix="/chk")
    port = serve.start_http()
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(
            b"POST /chk HTTP/1.1\r\nHost: x\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n"
            b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n"
        )
        resp = _recv_response(s)
        assert b"200 OK" in resp
        assert json.loads(resp.partition(b"\r\n\r\n")[2]) == {
            "body": "hello world"
        }
        # Same connection, next request: proves the chunked body (and its
        # trailer section) was fully consumed.
        s.sendall(b"GET /chk HTTP/1.1\r\nHost: x\r\n\r\n")
        resp2 = _recv_response(s)
        assert b"200 OK" in resp2


def test_chunked_body_too_large(serve_cluster):
    @serve.deployment
    def big(request):
        return "ok"

    serve.run(big.bind(), name="big_chk_app", route_prefix="/bigchk")
    proxy, port = _custom_proxy(max_body_bytes=100)
    try:
        payload = b"x" * 256
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            s.sendall(
                b"POST /bigchk HTTP/1.1\r\nHost: x\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n"
                + b"%x\r\n%s\r\n0\r\n\r\n" % (len(payload), payload)
            )
            resp = _recv_response(s)
        assert b"413" in resp.split(b"\r\n")[0]
    finally:
        ray_tpu_torch.kill(proxy)


def test_content_length_body_too_large(serve_cluster):
    @serve.deployment
    def big2(request):
        return "ok"

    serve.run(big2.bind(), name="big_cl_app", route_prefix="/bigcl")
    proxy, port = _custom_proxy(max_body_bytes=100)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/bigcl", data=b"y" * 256
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 413
    finally:
        ray_tpu_torch.kill(proxy)


def test_duplicate_headers_preserved(serve_cluster):
    """Repeated field lines merge with commas; Cookie merges with
    semicolons (RFC 6265) instead of silently dropping one."""

    @serve.deployment
    def hdrs(request):
        h = request["headers"]
        return {"cookie": h.get("cookie"), "x-multi": h.get("x-multi")}

    serve.run(hdrs.bind(), name="hdr_app", route_prefix="/hdr")
    port = serve.start_http()
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(
            b"GET /hdr HTTP/1.1\r\nHost: x\r\n"
            b"Cookie: a=1\r\nCookie: b=2\r\n"
            b"X-Multi: u\r\nX-Multi: v\r\n\r\n"
        )
        resp = _recv_response(s)
    out = json.loads(resp.partition(b"\r\n\r\n")[2])
    assert out == {"cookie": "a=1; b=2", "x-multi": "u, v"}


def test_inflight_cap_sheds_load(serve_cluster):
    @serve.deployment(max_ongoing_requests=10)
    async def slow(request):
        import asyncio

        await asyncio.sleep(1.0)
        return "done"

    serve.run(slow.bind(), name="slow_cap_app", route_prefix="/slowcap")
    proxy, port = _custom_proxy(max_inflight=2)
    try:

        def one():
            req = urllib.request.Request(f"http://127.0.0.1:{port}/slowcap")
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    return resp.status
            except urllib.error.HTTPError as e:
                return e.code

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            codes = list(pool.map(lambda _: one(), range(8)))
        assert codes.count(503) >= 1, codes
        assert codes.count(200) >= 2, codes
    finally:
        ray_tpu_torch.kill(proxy)


def test_per_deployment_request_timeout(serve_cluster):
    @serve.deployment(request_timeout_s=0.5)
    async def sleepy(request):
        import asyncio

        await asyncio.sleep(30)
        return "never"

    serve.run(sleepy.bind(), name="sleepy_app", route_prefix="/sleepy")
    port = serve.start_http()
    import time

    t0 = time.time()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sleepy")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 408
    assert time.time() - t0 < 10  # deadline came from the deployment
