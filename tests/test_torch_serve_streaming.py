"""Streaming serve data plane: async-generator replicas, streaming
handles, SSE over the asyncio HTTP proxy, LLM token streaming.

(reference test model: python/ray/serve/tests/test_streaming_response.py
— StreamingResponse over the HTTP proxy arrives incrementally;
test_handle_streaming.py — handle.options(stream=True) yields
generator items.)

The JAX package's streaming tests (tests/test_serve_streaming.py) on
the port's runtime and serve package, every case kept; the LLM
deployment runs its engine with device="cpu".
"""

import concurrent.futures
import json
import socket
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


# --------------------------------------------------------------- handles


def test_handle_stream_async_generator(serve_cluster):
    @serve.deployment
    class Streamer:
        async def __call__(self, n):
            for i in range(n):
                yield i * i

    handle = serve.run(Streamer.bind(), name="stream_app")
    out = list(handle.options(stream=True).remote(5))
    assert out == [0, 1, 4, 9, 16]


def test_handle_stream_sync_generator(serve_cluster):
    @serve.deployment
    class SyncStreamer:
        def __call__(self, n):
            for i in range(n):
                yield f"chunk-{i}"

    handle = serve.run(SyncStreamer.bind(), name="sync_stream_app")
    out = list(handle.options(stream=True).remote(3))
    assert out == ["chunk-0", "chunk-1", "chunk-2"]


def test_handle_stream_incremental(serve_cluster):
    """Items arrive before the replica finishes (true streaming)."""

    @serve.deployment
    class Slow:
        async def __call__(self, n):
            import asyncio

            for i in range(n):
                yield i
                await asyncio.sleep(0.25)

    handle = serve.run(Slow.bind(), name="slow_stream_app")
    t0 = time.time()
    it = iter(handle.options(stream=True).remote(4))
    first = next(it)
    first_latency = time.time() - t0
    rest = list(it)
    total = time.time() - t0
    assert first == 0 and rest == [1, 2, 3]
    assert first_latency < total / 2


def test_handle_stream_plain_value_yields_once(serve_cluster):
    @serve.deployment
    def plain(x):
        return x + 1

    handle = serve.run(plain.bind(), name="plain_stream_app")
    assert list(handle.options(stream=True).remote(41)) == [42]


def test_handle_stream_early_close(serve_cluster):
    @serve.deployment
    class Endless:
        async def __call__(self, _):
            for i in range(100_000):
                yield i

    handle = serve.run(Endless.bind(), name="endless_app")
    stream = handle.options(stream=True).remote(None)
    it = iter(stream)
    assert next(it) == 0
    stream.close()
    # The deployment still answers fresh requests afterwards.
    out = list(handle.options(stream=True).remote(None))[:3]
    assert out == [0, 1, 2]


# ------------------------------------------------------------ HTTP / SSE


def _http_stream(port, path, body, headers=None, timeout=30):
    """Raw-socket SSE client: returns (frames, frame_arrival_times)."""
    payload = json.dumps(body).encode()
    req = (
        f"POST {path} HTTP/1.1\r\n"
        f"Host: 127.0.0.1\r\n"
        f"Accept: text/event-stream\r\n"
        f"Content-Length: {len(payload)}\r\n"
    )
    for k, v in (headers or {}).items():
        req += f"{k}: {v}\r\n"
    req += "\r\n"
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(req.encode() + payload)
        raw = b""
        while b"data: [DONE]" not in raw and b"event: error" not in raw:
            chunk = s.recv(65536)
            if not chunk:
                break
            raw += chunk
            yield raw


def _collect_sse(port, path, body):
    frames, times = [], []
    raw = b""
    for raw in _http_stream(port, path, body):
        times.append(time.time())
    head, _, rest = raw.partition(b"\r\n\r\n")
    assert b"200 OK" in head and b"text/event-stream" in head
    # De-chunk: join chunk payloads (tolerate a missing final 0-chunk —
    # the client stops reading once it has seen [DONE]).
    data = b""
    while rest:
        size, sep, rest = rest.partition(b"\r\n")
        if not sep or not size.strip():
            break
        n = int(size, 16)
        if n == 0:
            break
        if len(rest) < n:
            data += rest
            break
        data += rest[:n]
        rest = rest[n + 2 :]
    events = [
        e for e in data.decode().split("\n\n") if e.strip().startswith("data:")
    ]
    for e in events:
        frames.append(
            "\n".join(
                ln[len("data: ") :]
                for ln in e.splitlines()
                if ln.startswith("data: ")
            )
        )
    return frames, times


def test_http_sse_streaming(serve_cluster):
    @serve.deployment
    class SSEApp:
        async def __call__(self, request):
            import asyncio

            n = int(request["body"].get("n", 3))
            for i in range(n):
                yield {"i": i}
                await asyncio.sleep(0.2)

    serve.run(SSEApp.bind(), name="sse_app", route_prefix="/sse")
    port = serve.start_http()
    frames, times = _collect_sse(port, "/sse", {"n": 4, "stream": True})
    assert frames[-1] == "[DONE]"
    items = [json.loads(f) for f in frames[:-1]]
    assert items == [{"i": 0}, {"i": 1}, {"i": 2}, {"i": 3}]
    # Incremental delivery: the stream spans multiple socket reads over
    # a period comparable to the server-side sleeps.
    assert times[-1] - times[0] > 0.3


def test_http_plain_still_works(serve_cluster):
    @serve.deployment
    def echo(request):
        return {"got": request["body"], "q": request["query"]}

    serve.run(echo.bind(), name="plain_http_app", route_prefix="/plain")
    port = serve.start_http()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/plain?k=v",
        data=json.dumps({"x": 1}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        out = json.loads(resp.read())
    assert out == {"got": {"x": 1}, "q": {"k": "v"}}


def test_http_keep_alive_reuses_connection(serve_cluster):
    @serve.deployment
    def ka(request):
        return "ok"

    serve.run(ka.bind(), name="ka_app", route_prefix="/ka")
    port = serve.start_http()
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        for _ in range(3):
            s.sendall(b"GET /ka HTTP/1.1\r\nHost: x\r\n\r\n")
            buf = b""
            while b"\r\n\r\n" not in buf or not buf.endswith(b"ok"):
                chunk = s.recv(4096)
                assert chunk, "server closed a keep-alive connection"
                buf += chunk
            assert b"200 OK" in buf


def test_http_404(serve_cluster):
    port = serve.start_http()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/definitely-not")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 404


def test_http_concurrent_requests(serve_cluster):
    """>100 in-flight requests through the asyncio proxy at once."""

    @serve.deployment(max_ongoing_requests=200)
    class SlowEcho:
        async def __call__(self, request):
            import asyncio

            await asyncio.sleep(0.3)
            return {"n": request["body"]["n"]}

    serve.run(SlowEcho.bind(), name="conc_app", route_prefix="/conc")
    port = serve.start_http()

    def one(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/conc",
            data=json.dumps({"n": i}).encode(),
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())["n"]

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(max_workers=120) as pool:
        results = list(pool.map(one, range(120)))
    elapsed = time.time() - t0
    assert sorted(results) == list(range(120))
    # 120 requests each sleeping 0.3s: true concurrency keeps the wall
    # clock far under the 36s serial time.
    assert elapsed < 15.0


# ------------------------------------------------------------------- LLM


def test_llm_sse_token_streaming(serve_cluster):
    from ray_tpu_torch.llm.serve_integration import build_llm_deployment

    app = build_llm_deployment("tiny", engine_kwargs={"device": "cpu"})
    serve.run(app, name="llm_app", route_prefix="/llm", timeout_s=120)
    port = serve.start_http()
    frames, times = _collect_sse(
        port, "/llm", {"prompt": "hi", "max_tokens": 24, "stream": True}
    )
    assert frames[-1] == "[DONE]"
    deltas = [json.loads(f) for f in frames[:-1]]
    assert len(deltas) >= 2, "tokens should stream over multiple events"
    total = sum(len(d["tokens"]) for d in deltas)
    assert total == 24
    # And the non-streaming path still answers on the same app.
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llm",
        data=json.dumps({"prompt": "hi", "max_tokens": 4}).encode(),
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        out = json.loads(resp.read())
    assert out["num_generated"] == 4
