"""The JAX package's tests of the util/ helpers (tests/test_util.py:
ActorPool, Queue, the multiprocessing Pool) and of the joblib backend and
tqdm_ray (tests/test_chaos_and_bridges.py) on the port's runtime. Every
case runs unchanged but for the package name (the joblib backend
registers as "ray_tpu_torch"); the joblib cases skip only where joblib is
not installed.
"""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.multiprocessing import Pool
from ray_tpu_torch.util.queue import Empty, Queue
from torch_runtime_util import start_cluster, stop_cluster


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


@pytest.fixture(scope="module")
def pool_actors(cluster):
    @ray_tpu_torch.remote
    class Doubler:
        def double(self, x):
            return 2 * x

        def slow_double(self, x):
            time.sleep(0.05 * (3 - x % 3))
            return 2 * x

    actors = [Doubler.options(num_cpus=0.5).remote() for _ in range(2)]
    yield actors
    for a in actors:
        ray_tpu_torch.kill(a)


def test_actor_pool_map_ordered(pool_actors):
    pool = ActorPool(pool_actors)
    out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert out == [2 * i for i in range(8)]


def test_actor_pool_map_unordered(pool_actors):
    pool = ActorPool(pool_actors)
    out = list(
        pool.map_unordered(lambda a, v: a.slow_double.remote(v), range(6))
    )
    assert sorted(out) == [2 * i for i in range(6)]


def test_actor_pool_submit_get_next(pool_actors):
    pool = ActorPool(pool_actors)
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)
    assert pool.get_next() == 20
    assert pool.get_next() == 40
    assert not pool.has_next()


def test_queue_basic(cluster):
    q = Queue(maxsize=3)
    try:
        q.put("a")
        q.put("b")
        assert q.qsize() == 2
        assert q.get() == "a"
        assert q.get() == "b"
        with pytest.raises(Empty):
            q.get_nowait()
    finally:
        q.shutdown()


def test_queue_get_timeout(cluster):
    q = Queue()
    try:
        with pytest.raises(Empty):
            q.get(timeout=0.2)
    finally:
        q.shutdown()


def test_queue_cross_process(cluster):
    q = Queue()

    @ray_tpu_torch.remote
    def producer(queue, n):
        for i in range(n):
            queue.put(i)
        return n

    try:
        ref = producer.remote(q, 5)
        got = [q.get(timeout=10) for _ in range(5)]
        assert got == list(range(5))
        assert ray_tpu_torch.get(ref) == 5
    finally:
        q.shutdown()


def test_actor_pool_survives_task_error(cluster):
    @ray_tpu_torch.remote
    class Flaky:
        def run(self, x):
            if x == 0:
                raise ValueError("bad input")
            return x

    pool = ActorPool([Flaky.options(num_cpus=0.5).remote()])
    for v in (0, 1, 2):
        pool.submit(lambda a, v: a.run.remote(v), v)
    with pytest.raises(Exception):
        pool.get_next()
    # The error must not wedge the pool: later results still arrive.
    assert pool.get_next() == 1
    assert pool.get_next() == 2


def _square(x):
    return x * x


def _add(a, b):
    return a + b


def test_mp_pool_map(cluster):
    with Pool(processes=2) as pool:
        assert pool.map(_square, range(10)) == [i * i for i in range(10)]


def test_mp_pool_starmap_apply(cluster):
    with Pool(processes=2) as pool:
        assert pool.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]
        assert pool.apply(_add, (5, 6)) == 11
        r = pool.apply_async(_square, (9,))
        assert r.get(timeout=30) == 81
        assert r.successful() is True
    pool.join()  # closed by __exit__; join drains outstanding refs


def test_mp_pool_imap_unordered(cluster):
    with Pool(processes=2) as pool:
        out = sorted(pool.imap_unordered(_square, range(6), chunksize=2))
        assert out == sorted(i * i for i in range(6))
    with pytest.raises(ValueError):
        pool.map(_square, [1])


def test_joblib_backend(cluster):
    joblib = pytest.importorskip("joblib")

    from ray_tpu_torch.util.joblib import register_ray_tpu

    register_ray_tpu()
    with joblib.parallel_backend("ray_tpu_torch"):
        out = joblib.Parallel(n_jobs=4)(
            joblib.delayed(lambda x: x * x)(i) for i in range(12)
        )
    assert out == [i * i for i in range(12)]


def test_joblib_effective_n_jobs(cluster):
    pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import RayTpuBackend

    backend = RayTpuBackend()
    assert backend.effective_n_jobs(-1) >= 4
    assert backend.effective_n_jobs(2) == 2


def test_joblib_error_propagates_without_hanging(cluster):
    joblib = pytest.importorskip("joblib")

    from ray_tpu_torch.util.joblib import register_ray_tpu

    def maybe_fail(i):
        if i == 5:
            raise ValueError("boom")
        return i

    register_ray_tpu()
    with joblib.parallel_backend("ray_tpu_torch"):
        with pytest.raises(Exception):
            joblib.Parallel(n_jobs=2)(
                joblib.delayed(maybe_fail)(i) for i in range(10)
            )


def test_joblib_negative_n_jobs(cluster):
    pytest.importorskip("joblib")
    from ray_tpu_torch.util.joblib import RayTpuBackend

    backend = RayTpuBackend()
    total = backend.effective_n_jobs(-1)
    assert backend.effective_n_jobs(-2) == total - 1


def test_tqdm_ray_reports_progress(cluster, capfd):
    import io

    from ray_tpu_torch.experimental import tqdm_ray

    sink = io.StringIO()
    tqdm_ray.enable_display(out=sink)

    @ray_tpu_torch.remote
    def work(n):
        bar = tqdm_ray.tqdm(
            range(n), desc="work", flush_interval_s=0.0
        )
        total = 0
        for i in bar:
            total += i
        return total

    assert ray_tpu_torch.get(work.remote(10), timeout=60) == 45
    deadline = time.time() + 15
    while time.time() < deadline:
        text = sink.getvalue()
        if "done" in text and "[work]" in text:
            break
        time.sleep(0.2)
    else:
        pytest.fail(f"no progress rendered: {sink.getvalue()!r}")
    assert "10/10" in sink.getvalue()

