"""Microbenchmark suite (reference: python/ray/_private/ray_perf.py —
`ray microbenchmark`: put/get/task/actor ops-per-second; port of
ray_tpu/_private/perf.py under the same row names).

Run: python -m ray_tpu_torch._private.perf [--quick] [--device cpu]
     [--json PATH]
Each line: name, ops/s (mean over trials). ``--device`` (default cuda,
which raises without a GPU) is where the paged-decode row serves and the
mesh allreduce row runs; the control-plane rows are host work.
"""

from __future__ import annotations

import time


def timeit(
    name: str, fn, multiplier: int = 1, trials: int = 3, warmup: bool = True
) -> dict:
    if warmup:
        fn()
    rates = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        rates.append(multiplier / dt)
    rate = sum(rates) / len(rates)
    print(f"{name:<46s} {rate:>12.1f} ops/s")
    return {"name": name, "ops_per_s": rate}


def main(quick: bool = False, device: str = "cuda") -> list[dict]:
    import numpy as np

    import ray_tpu_torch

    n = 100 if quick else 1000
    results = []
    ray_tpu_torch.init(num_cpus=4)
    try:
        small = b"x" * 100
        big = np.zeros((1024, 1024), np.uint8)  # 1 MiB

        def put_small():
            for _ in range(n):
                ray_tpu_torch.put(small)

        results.append(timeit("put (100 B)", put_small, n))

        ref_small = ray_tpu_torch.put(small)

        def get_small():
            for _ in range(n):
                ray_tpu_torch.get(ref_small)

        results.append(timeit("get (100 B, cached owner)", get_small, n))

        def put_big():
            for _ in range(max(n // 10, 10)):
                ray_tpu_torch.put(big)

        results.append(timeit("put (1 MiB)", put_big, max(n // 10, 10)))

        @ray_tpu_torch.remote
        def noop():
            return b"ok"

        def task_sync():
            for _ in range(max(n // 10, 10)):
                ray_tpu_torch.get(noop.remote())

        results.append(
            timeit("task submit+get (sync)", task_sync, max(n // 10, 10))
        )

        def task_async():
            ray_tpu_torch.get([noop.remote() for _ in range(n)])

        results.append(timeit(f"tasks async x{n}", task_async, n))

        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.x = 0

            def inc(self):
                self.x += 1
                return self.x

        c = Counter.remote()

        def actor_sync():
            for _ in range(max(n // 10, 10)):
                ray_tpu_torch.get(c.inc.remote())

        results.append(
            timeit("actor call (sync)", actor_sync, max(n // 10, 10))
        )

        def actor_async():
            ray_tpu_torch.get([c.inc.remote() for _ in range(n)])

        results.append(timeit(f"actor calls async x{n}", actor_async, n))
        ray_tpu_torch.kill(c)

        # Queued-task stress (reference envelope: 1M tasks queued on one
        # node, release/benchmarks/README.md:32 — scaled to CI time):
        # submit a burst far beyond worker capacity, drain it all.
        burst = 1000 if quick else 10_000

        def queue_burst():
            ray_tpu_torch.get(
                [noop.remote() for _ in range(burst)], timeout=600
            )

        # warmup=False: running a 10k burst twice for one measurement
        # doubles the suite's most expensive bench for no signal.
        results.append(timeit(f"queued burst x{burst}", queue_burst, burst,
                              trials=1, warmup=False))
        results.extend(serve_bench(quick=quick))
        results.extend(object_plane_bench(quick=quick))
        results.extend(dag_pipeline_bench(quick=quick))
    finally:
        ray_tpu_torch.shutdown()
    results.extend(collective_bench(quick=quick, device=device))
    results.extend(collective_multiproc_bench(quick=quick))
    results.extend(llm_decode_bench(quick=quick, device=device))
    return results


def llm_decode_bench(quick: bool = False, device: str = "cuda",
                     inspect=None) -> list[dict]:
    """Continuous-batching decode throughput through the PAGED engine
    (reference capability: vLLM's paged decode behind ray.llm). 64
    concurrent variable-length requests share a page pool the dense
    slab layout could not hold; the metric is aggregate sampled
    tokens/s through engine.step() — it catches structural regressions
    (logits host round-trips, allocator churn) wherever it runs.

    On the CPU it serves ``tiny``, as the JAX package's does. On the
    card it serves ``mini`` at the same request mix and pool: the paged
    attention kernel is built for head_dim 64 and 128
    (ops/paged_attention.py), and tiny's head_dim is 16. ``backend`` is
    the device type. ``inspect(engine)``, when given, is called after the
    last step."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import PRESETS

    dev = resolve_device(device)
    cfg = PRESETS["tiny" if dev.type == "cpu" else "mini"]
    n_req = 16 if quick else 64
    max_tokens = 8 if quick else 32
    engine = LLMEngine(
        cfg, max_batch=8, max_seq=128, kv="paged", page_size=32,
        num_pages=28, device=dev,
    )
    prompts = [
        [(7 * i + j) % cfg.vocab_size for j in range(2 + i % 13)]
        for i in range(n_req)
    ]
    # Warm the allocator and the kernels' launch plans.
    engine.generate(prompts[:4], SamplingParams(max_tokens=2))
    for p in prompts:
        engine.add_request(p, SamplingParams(max_tokens=max_tokens))
    tokens = 0
    t0 = time.perf_counter()
    while engine.has_unfinished():
        for fin in engine.step():
            tokens += len(fin["tokens"])
    dt = time.perf_counter() - t0
    if inspect is not None:
        inspect(engine)
    rec = {
        "name": f"llm paged decode x{n_req} reqs",
        "tokens_per_s": round(tokens / dt, 1),
        "backend": dev.type,
    }
    print(f"{rec['name']:<46s} {rec['tokens_per_s']:>8.1f} tok/s "
          f"({rec['backend']})")
    return [rec]


def serve_bench(quick: bool = False) -> list[dict]:
    """Serve data-plane throughput and latency (reference: serve release
    microbenchmarks, python/ray/serve/benchmarks/microbenchmark.py —
    handle throughput, HTTP throughput, streaming TTFB)."""
    import concurrent.futures
    import json as _json
    import socket

    from ray_tpu_torch import serve

    results: list[dict] = []

    @serve.deployment(max_ongoing_requests=64)
    class Echo:
        async def __call__(self, request):
            body = request.get("body") if isinstance(request, dict) else None
            if isinstance(body, dict) and body.get("stream"):
                return self._gen()
            return "ok"

        async def _gen(self):
            for i in range(8):
                yield {"i": i}

    handle = serve.run(Echo.bind(), name="_perf", route_prefix="/perf")
    port = serve.start_http()
    try:
        n = 200 if quick else 1000

        # Handle path: concurrent calls through the router.
        def handle_burst():
            responses = [handle.remote(None) for _ in range(n)]
            for r in responses:
                r.result(timeout=60)

        results.append(timeit(f"serve handle calls x{n}", handle_burst, n))

        # HTTP path: 8 keep-alive connections, n requests total.
        def http_worker(count: int):
            with socket.create_connection(
                ("127.0.0.1", port), timeout=30
            ) as s:
                req = b"GET /perf HTTP/1.1\r\nHost: x\r\n\r\n"
                for _ in range(count):
                    s.sendall(req)
                    buf = b""
                    while not buf.endswith(b"ok"):
                        chunk = s.recv(4096)
                        if not chunk:
                            raise RuntimeError("connection closed")
                        buf += chunk

        def http_burst():
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                list(pool.map(http_worker, [n // 8] * 8))

        results.append(timeit(f"serve http req x{n}", http_burst, n))

        # Streaming TTFB: time from connect to the first SSE frame.
        payload = _json.dumps({"stream": True}).encode()
        req = (
            f"POST /perf HTTP/1.1\r\nHost: x\r\n"
            f"Accept: text/event-stream\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n"
        ).encode() + payload
        ttfbs = []
        for _ in range(20 if quick else 50):
            with socket.create_connection(
                ("127.0.0.1", port), timeout=30
            ) as s:
                t0 = time.perf_counter()
                s.sendall(req)
                buf = b""
                while b"data: " not in buf:
                    chunk = s.recv(65536)
                    if not chunk:
                        raise RuntimeError("stream closed before first frame")
                    buf += chunk
                ttfbs.append(time.perf_counter() - t0)
                while b"[DONE]" not in buf:
                    chunk = s.recv(65536)
                    if not chunk:
                        raise RuntimeError("stream closed before [DONE]")
                    buf += chunk
        ttfbs.sort()
        rec = {
            "name": "serve sse ttfb",
            "p50_ms": round(ttfbs[len(ttfbs) // 2] * 1e3, 2),
            "p99_ms": round(ttfbs[int(len(ttfbs) * 0.99)] * 1e3, 2),
        }
        print(f"{rec['name']:<46s} p50={rec['p50_ms']}ms p99={rec['p99_ms']}ms")
        results.append(rec)
    finally:
        serve.shutdown()
    return results


def object_plane_bench(quick: bool = False) -> list[dict]:
    """Broadcast envelope (BASELINE.md: the reference's scalability
    envelope is a 1 GiB object broadcast to 50+ nodes riding
    push_manager chunked pushes; here 8 simulated nodes with separate
    store dirs on one host — the metric is aggregate store-to-store
    GB/s through the relay waves)."""
    import shutil
    import tempfile

    import numpy as np

    from ray_tpu_torch import api as core_api
    from ray_tpu_torch.runtime.node import NodeManager

    rt = core_api._runtime
    import ray_tpu_torch

    n_nodes = 8
    nbytes = (64 << 20) if quick else (1 << 30)
    payload = np.random.default_rng(0).integers(
        0, 255, size=nbytes, dtype=np.uint8
    )

    # Store dirs on /dev/shm like the real per-node plasma pools — a
    # disk-backed tempdir benchmarks the disk, not the object plane.
    import os

    base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    dirs = [
        tempfile.mkdtemp(prefix=f"bcast{i}_", dir=base)
        for i in range(n_nodes)
    ]
    nodes = []

    async def launch(d):
        node = NodeManager(rt.core.head_addr, d, resources={"CPU": 0.01})
        await node.start()
        return node

    results: list[dict] = []
    try:
        for d in dirs:
            nodes.append(rt.run(launch(d)))
        ref = ray_tpu_torch.put(payload)
        t0 = time.perf_counter()
        reply = ray_tpu_torch.broadcast(ref, timeout=600, return_details=True)
        dt = time.perf_counter() - t0
        n = reply["nodes"]
        agg = n * nbytes / dt / 1e9
        rec = {
            "name": f"broadcast {nbytes >> 20} MiB x{n} nodes",
            "s": round(dt, 3),
            "agg_GB_s": round(agg, 2),
            # Relay-tree depth — deterministic, so CI can floor it even
            # when the memcpy-bound GB/s is noisy.
            "waves": reply["waves"],
        }
        print(
            f"{rec['name']:<46s} {dt:>8.2f}s  {agg:>6.2f} GB/s aggregate"
            f"  ({rec['waves']} waves)"
        )
        results.append(rec)
    finally:
        for node in nodes:
            try:
                rt.run(node.stop())
            # tpulint: allow(broad-except reason=bench teardown of throwaway nodes; the rows are already collected and shutdown() reaps leftovers)
            except Exception:  # noqa: BLE001
                pass
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    return results


def dag_pipeline_bench(quick: bool = False) -> list[dict]:
    """Compiled-DAG pipeline throughput (reference: compiled graphs
    execution, compiled_dag_node.py). The reference's overlapped
    schedule hides NCCL latency behind GPU compute; the host-thread
    analogue measured net-negative here at small AND 8 MiB payloads
    (GIL-serialized copies) and was removed — the ShmChannel ring
    already pipelines across actors.

    Submission is WINDOWED: a compiled pipeline only buffers
    nslots×stages executions, so submit-all-then-read deadlocks past
    that depth.
    """
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class Stage:
        def work(self, x):
            return x + 1

    n_exec = 300 if quick else 2000
    stages = [Stage.remote() for _ in range(3)]
    with InputNode() as inp:
        node = inp
        for s in stages:
            node = s.work.bind(node)
        dag = node.experimental_compile()
    try:
        dag.execute(0).get(timeout=60)  # warm the loops
        t0 = time.perf_counter()
        window = []
        for i in range(n_exec):
            window.append(dag.execute(i))
            if len(window) >= 6:
                window.pop(0).get(timeout=120)
        while window:
            window.pop(0).get(timeout=120)
        dt = time.perf_counter() - t0
    finally:
        dag.teardown()
        for s in stages:
            try:
                ray_tpu_torch.kill(s)
            # tpulint: allow(broad-except reason=bench teardown of throwaway stage actors; the measurement is already taken)
            except Exception:  # noqa: BLE001
                pass
    rate = n_exec / dt
    rec = {"name": "dag 3-stage pipeline", "ops_per_s": rate}
    print(f"{rec['name']:<46s} {rate:>12.1f} ops/s")
    return [rec]


def collective_multiproc_bench(quick: bool = False) -> list[dict]:
    """Allreduce bus bandwidth across REAL process boundaries: N
    subprocesses form one torch.distributed gloo world around
    NcclDistGroup (dist_backend="gloo", host tensors) and allreduce a
    shared-size payload (the NCCL-vs-Gloo allreduce sweep's honest
    single-host proxy, unlike a 1-device 'allreduce' which is a copy)."""
    import json as _json
    import os
    import socket
    import subprocess
    import sys
    import tempfile
    import textwrap

    results: list[dict] = []
    nbytes = (8 << 20) if quick else (64 << 20)
    worlds = (2,) if quick else (2, 4, 8)
    trials = 3

    script = textwrap.dedent(
        """
        import asyncio, datetime, os, sys, time, json
        import torch
        import torch.distributed as dist
        from ray_tpu_torch.collective.backends.nccl_group import NcclDistGroup

        store = dist.TCPStore(
            "127.0.0.1", {port}, {world}, {rank} == 0,
            datetime.timedelta(seconds=120),
        )
        g = NcclDistGroup({world}, {rank}, timeout_s=120, store=store,
                          dist_backend="gloo")
        x = torch.ones(({nelem},), dtype=torch.float32)
        out = g.allreduce(x)
        float(out[0])  # warm + sync
        g.barrier()
        t0 = time.perf_counter()
        for _ in range({trials}):
            out = g.allreduce(out)
        float(out[0])
        dt = (time.perf_counter() - t0) / {trials}
        if {rank} == 0:
            print("DT=" + json.dumps(dt))
        # Leave together, and without the interpreter's teardown: gloo's
        # threads and rank 0's store server, torn down in the order of
        # finalization, abort a busy host's process ("terminate called
        # without an active exception") after the row is measured.
        g.barrier()
        asyncio.run(g.destroy())
        sys.stdout.flush()
        os._exit(0)
        """
    )

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    env = dict(os.environ)
    import ray_tpu_torch as _rt

    repo_root = os.path.dirname(os.path.dirname(_rt.__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo_root, env.get("PYTHONPATH", "")) if p
    )

    for world in worlds:
        port = free_port()
        procs = []
        try:
            with tempfile.TemporaryDirectory() as td:
                for rank in range(world):
                    path = os.path.join(td, f"r{rank}.py")
                    with open(path, "w") as f:
                        f.write(
                            script.format(
                                port=port,
                                world=world,
                                rank=rank,
                                nelem=nbytes // 4,
                                trials=trials,
                            )
                        )
                    procs.append(
                        subprocess.Popen(
                            [sys.executable, path],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT,
                            text=True,
                            env=env,
                        )
                    )
                outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            # One wedged rank (port race, import error → the others
            # block in the store's rendezvous) must not orphan the rest.
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for rank, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(
                    f"gloo bench rank{rank}/{world} rc={p.returncode}:"
                    f"\n{out[-2000:]}"
                )
        dt = next(
            _json.loads(line[3:])
            for line in outs[0].splitlines()
            if line.startswith("DT=")
        )
        bus = 2 * (world - 1) / world * nbytes / dt / 1e9
        rec = {
            "name": f"allreduce gloo {nbytes >> 20} MiB {world}p",
            "per_s": round(1.0 / dt, 2),
            "bus_GB_s": round(bus, 3),
        }
        print(
            f"{rec['name']:<46s} {rec['per_s']:>8.2f}/s "
            f"{rec['bus_GB_s']:>7.3f} GB/s bus"
        )
        results.append(rec)
    return results


def collective_bench(quick: bool = False, device: str = "cuda") -> list[dict]:
    """Allreduce bus bandwidth on the mesh backend vs the naive host path
    (the NCCL-vs-Gloo analogue: NcclMeshGroup's allreduce over every
    visible GPU, NCCL when they are distinct cards, vs a single-host
    numpy reduce). ``device`` "cpu" takes the host as one device."""
    import numpy as np
    import torch

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.collective.backends.nccl_group import NcclMeshGroup

    dev = resolve_device(device)
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    results: list[dict] = []
    nbytes = (4 << 20) if quick else (64 << 20)  # per-shard payload
    n_elem = nbytes // 4
    world = len(devs)
    trials = 5

    def bus_gb_s(dt: float) -> float:
        # Ring-allreduce bus-bandwidth convention: 2(w-1)/w * bytes/t.
        factor = 2 * (world - 1) / world if world > 1 else 1.0
        return round(factor * nbytes / dt / 1e9, 2)

    if world > 1:
        # A single-device "allreduce" is a copy, not a collective — the
        # mesh entry only means something with 2+ devices; the honest
        # single-host collective number is collective_multiproc_bench.
        group = NcclMeshGroup(devs)
        out = group.allreduce(
            [torch.ones(n_elem, dtype=torch.float32, device=d) for d in devs]
        )
        for d in devs:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        for _ in range(trials):
            out = group.allreduce(out)
        for d in devs:
            torch.cuda.synchronize(d)
        dt = (time.perf_counter() - t0) / trials
        results.append({
            "name": f"allreduce {group.route}_mesh {nbytes >> 20} MiB "
                    f"x{world}dev",
            "per_s": 1.0 / dt,
            "bus_GB_s": bus_gb_s(dt),
        })
        print(results[-1])

    # Host baseline: numpy sum over per-rank buffers (the Gloo stand-in).
    host = [np.ones(n_elem, np.float32) for _ in range(world)]
    t0 = time.perf_counter()
    for _ in range(trials):
        reduced = np.sum(host, axis=0)
        host = [reduced.copy() for _ in range(world)]
    dt_host = (time.perf_counter() - t0) / trials
    results.append({
        "name": f"allreduce host-numpy {nbytes >> 20} MiB x{world}",
        "per_s": 1.0 / dt_host,
        "bus_GB_s": bus_gb_s(dt_host),
    })
    print(results[-1])
    return results


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="write the rows to this path")
    args = ap.parse_args()
    results = main(quick=args.quick, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(
                {
                    "results": results,
                    "note": "control-plane microbenchmarks "
                            "(ray_perf.py equivalent); floors "
                            "enforced by tests/test_torch_perf_floors.py",
                },
                f,
                indent=2,
            )
        print(f"wrote {args.json}")
