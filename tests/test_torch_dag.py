"""Compiled-graph tests (model: python/ray/dag/tests in the reference —
non-GPU suite: build, execute, multi-output, error propagation,
collective nodes on the CPU-mock communicator, teardown).

The JAX package's compiled-graph tests (tests/test_dag.py) on the port's
runtime, and the port's own cases: collective nodes over torch tensors
(reduced with torch, each equal to the numpy reduction of the same
values, the result a tensor), numpy payloads that stay numpy, an error
that flows through a collective node, and ``ActorMethod.bind``.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import (
    ChannelClosed,
    InputNode,
    MultiOutputNode,
    ShmChannel,
    allreduce,
)


@pytest.fixture(scope="module")
def cluster():
    # Each test leaves its actors alive until module teardown; size the
    # node so later tests' actor leases never starve.
    ray_tpu_torch.init(num_cpus=64)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Adder:
    def __init__(self, bias):
        self.bias = bias

    def add(self, x):
        return x + self.bias

    def pair(self, x):
        return {"v": x, "twice": 2 * x}

    def boom(self, x):
        raise ValueError("boom")

    def contribute(self, x):
        return np.full((4,), float(x + self.bias))


# ------------------------------------------------------------- channels
def test_shm_channel_roundtrip(tmp_path):
    path = str(tmp_path / "ch")
    w = ShmChannel(path, writer=True, create=True, n_readers=2)
    r0 = ShmChannel(path, writer=False, rank=0)
    r1 = ShmChannel(path, writer=False, rank=1)
    for i in range(20):  # exceeds nslots → exercises wraparound
        w.write({"i": i, "arr": np.arange(8) + i})
        assert r0.read()["i"] == i
        got = r1.read()
        assert got["i"] == i
        np.testing.assert_array_equal(got["arr"], np.arange(8) + i)
    w.close()
    with pytest.raises(ChannelClosed):
        r0.read()


def test_shm_channel_spill(tmp_path):
    path = str(tmp_path / "big")
    w = ShmChannel(path, writer=True, create=True, n_readers=1, capacity=1024)
    r = ShmChannel(path, writer=False, rank=0)
    big = np.random.default_rng(0).standard_normal(100_000)
    for _ in range(3):
        w.write(big)
        np.testing.assert_array_equal(r.read(), big)


# ------------------------------------------------------------ build/run
def test_eager_execute(cluster):
    a = Adder.remote(1)
    b = Adder.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    assert dag.execute(5) == 16


def test_compiled_linear_pipeline(cluster):
    a = Adder.remote(1)
    b = Adder.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    cdag = dag.experimental_compile()
    try:
        for i in range(10):
            assert cdag.execute(i).get() == i + 11
    finally:
        cdag.teardown()


def test_compiled_multi_output_and_fanout(cluster):
    a = Adder.remote(1)
    b = Adder.remote(100)
    with InputNode() as inp:
        x = a.add.bind(inp)  # consumed by b AND the driver
        y = b.add.bind(x)
        dag = MultiOutputNode([x, y])
    cdag = dag.experimental_compile()
    try:
        for i in (0, 3, 7):
            got = cdag.execute(i).get()
            assert got == [i + 1, i + 101]
    finally:
        cdag.teardown()


def test_compiled_attribute_extraction(cluster):
    a = Adder.remote(1)
    b = Adder.remote(10)
    with InputNode() as inp:
        p = a.pair.bind(inp)
        dag = b.add.bind(p["twice"])
    cdag = dag.experimental_compile()
    try:
        assert cdag.execute(4).get() == 18  # 2*4 + 10
    finally:
        cdag.teardown()


def test_compiled_pipelined_inputs(cluster):
    """Submit several inputs before reading any output (static schedule
    keeps them ordered; channel ring buffers them)."""
    a = Adder.remote(1)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    cdag = dag.experimental_compile()
    try:
        refs = [cdag.execute(i) for i in range(5)]
        assert [r.get() for r in refs] == [1, 2, 3, 4, 5]
    finally:
        cdag.teardown()


def test_compiled_error_propagates_and_dag_survives(cluster):
    a = Adder.remote(1)
    b = Adder.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.boom.bind(inp))
    cdag = dag.experimental_compile()
    try:
        with pytest.raises(ValueError, match="boom"):
            cdag.execute(1).get()
        # the loop keeps running after an error
        with pytest.raises(ValueError, match="boom"):
            cdag.execute(2).get()
    finally:
        cdag.teardown()


def test_compiled_collective_allreduce(cluster):
    """DAG-level allreduce across two actors (reference:
    dag/collective_node.py lowering; CPU backend stands in for ICI)."""
    a = Adder.remote(1)
    b = Adder.remote(2)
    with InputNode() as inp:
        ca = a.contribute.bind(inp)
        cb = b.contribute.bind(inp)
        ra, rb = allreduce.bind([ca, cb])
        dag = MultiOutputNode([ra, rb])
    cdag = dag.experimental_compile()
    try:
        out_a, out_b = cdag.execute(10).get()
        np.testing.assert_array_equal(out_a, np.full((4,), 23.0))
        np.testing.assert_array_equal(out_b, np.full((4,), 23.0))
    finally:
        cdag.teardown()


def test_teardown_frees_actor(cluster):
    a = Adder.remote(5)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    cdag = dag.experimental_compile()
    assert cdag.execute(1).get() == 6
    cdag.teardown()
    # actor takes normal calls again after the loop exits
    assert ray_tpu_torch.get(a.add.remote(1)) == 6


# ------------------------------------------------------------- permute
def test_permute_pipeline_handoff(cluster):
    """The permute verb rotates values rank→rank (the P2P channel for
    pipeline stage handoff; reference: NCCL P2P channels nccl_group.py,
    lowered to ppermute on a TPU mesh)."""
    from ray_tpu_torch.dag import permute

    stages = [Adder.remote(bias=10 * (i + 1)) for i in range(3)]
    with InputNode() as inp:
        outs = [s.add.bind(inp) for s in stages]
        # ring: 0→1, 1→2, 2→0
        received = permute.bind(outs, perm=[(0, 1), (1, 2), (2, 0)])
        dag = MultiOutputNode(received).experimental_compile()
    try:
        got = dag.execute(1).get(timeout=60)
        # rank 1 receives rank 0's output (1+10), rank 2 gets rank 1's
        # (1+20), rank 0 gets rank 2's (1+30).
        assert got == [31, 11, 21]
    finally:
        dag.teardown()


def test_permute_without_incoming_edge(cluster):
    from ray_tpu_torch.dag import permute

    stages = [Adder.remote(bias=i) for i in range(2)]
    with InputNode() as inp:
        outs = [s.add.bind(inp) for s in stages]
        received = permute.bind(outs, perm=[(0, 1)])  # rank 0 gets nothing
        dag = MultiOutputNode(received).experimental_compile()
    try:
        got = dag.execute(5).get(timeout=60)
        assert got == [None, 5]
    finally:
        dag.teardown()


def test_large_payload_pipeline(cluster):
    """8 MiB tensors flow through a 3-stage compiled pipeline intact
    (the ring slots carry multi-MiB payloads; no overlap threads —
    measured net-negative and removed)."""
    import numpy as np

    @ray_tpu_torch.remote
    class Big:
        def work(self, x):
            return x + 1.0

    stages = [Big.remote() for _ in range(3)]
    with InputNode() as inp:
        node = inp
        for s in stages:
            node = s.work.bind(node)
        # Explicit buffer_size: a config override here would be a
        # silent no-op once ANY earlier test froze the DAGContext
        # singleton.
        dag = node.experimental_compile(buffer_size=32 * 1024 * 1024)
    try:
        payload = np.zeros((1024, 2048), np.float32)  # 8 MiB
        out = dag.execute(payload).get(timeout=120)
        assert float(out[0, 0]) == 3.0
        out = dag.execute(payload + 1).get(timeout=120)
        assert float(out[-1, -1]) == 4.0
    finally:
        dag.teardown()




# ------------------------------------------------- torch collective nodes
WORLD = 3


def _values(seed, rank):
    rng = np.random.default_rng([seed, rank])
    return rng.integers(-3, 4, size=(7, 2)).astype(np.float32)


@ray_tpu_torch.remote
class Rank:
    """One rank's contribution: integer-valued float32 rows drawn from
    the seed the DAG's input carries (exact under every reduction)."""

    def __init__(self, rank):
        self.rank = rank

    def values(self, seed):
        return _values(seed, self.rank)

    def tensor(self, seed):
        import torch

        return torch.from_numpy(self.values(seed))

    def tensor_or_boom(self, seed):
        if self.rank == 1 and seed < 0:
            raise ValueError("rank 1 failed")
        return self.tensor(abs(seed))


@pytest.fixture(scope="module")
def ranks(cluster):
    """One set of rank actors for every collective case: a torn-down
    graph leaves its actors free for the next."""
    return [Rank.remote(r) for r in range(WORLD)]


def _want(verb, op, per_rank):
    stack = np.stack(per_rank)
    if verb == "allgather":
        return [list(per_rank)] * WORLD
    reduced = {"sum": stack.sum(0), "product": stack.prod(0),
               "min": stack.min(0), "max": stack.max(0)}[op]
    if verb == "allreduce":
        return [reduced] * WORLD
    return np.array_split(reduced, WORLD, axis=0)


def _per_rank(seed):
    return [_values(seed, r) for r in range(WORLD)]


@pytest.mark.parametrize("verb,op", [
    ("allreduce", "sum"), ("allreduce", "product"), ("allreduce", "min"),
    ("allreduce", "max"), ("allgather", "sum"), ("reducescatter", "sum"),
    ("reducescatter", "max"),
])
def test_collective_node_over_torch_tensors(ranks, verb, op):
    import torch

    from ray_tpu_torch import dag as rdag

    with InputNode() as inp:
        outs = getattr(rdag, verb).bind(
            [r.tensor.bind(inp) for r in ranks], op=op)
        cdag = MultiOutputNode(outs).experimental_compile()
    try:
        for seed in (5, 6):
            got = cdag.execute(seed).get(timeout=60)
            want = _want(verb, op, _per_rank(seed))
            for g, w in zip(got, want):
                if verb == "allgather":
                    assert all(isinstance(t, torch.Tensor) for t in g)
                    for t, a in zip(g, w):
                        np.testing.assert_array_equal(t.numpy(), a)
                    continue
                assert isinstance(g, torch.Tensor)
                assert g.dtype == torch.float32 and g.device.type == "cpu"
                np.testing.assert_array_equal(g.numpy(), w)
    finally:
        cdag.teardown()


def test_collective_node_keeps_numpy_payloads_numpy(ranks):
    with InputNode() as inp:
        outs = allreduce.bind([r.values.bind(inp) for r in ranks])
        cdag = MultiOutputNode(outs).experimental_compile()
    try:
        got = cdag.execute(9).get(timeout=60)
        want = np.stack(_per_rank(9)).sum(0)
        for g in got:
            assert type(g) is np.ndarray
            np.testing.assert_array_equal(g, want)
    finally:
        cdag.teardown()


def test_error_flows_through_a_collective_node(ranks):
    """A rank that raises poisons the collective for every rank instead
    of hanging it, and the graph runs on afterwards."""
    with InputNode() as inp:
        outs = allreduce.bind([r.tensor_or_boom.bind(inp) for r in ranks])
        cdag = MultiOutputNode(outs).experimental_compile()
    try:
        with pytest.raises(ValueError, match="rank 1 failed"):
            cdag.execute(-3).get(timeout=60)
        got = cdag.execute(3).get(timeout=60)
        want = np.stack(_per_rank(3)).sum(0)
        for g in got:
            np.testing.assert_array_equal(g.numpy(), want)
    finally:
        cdag.teardown()


def test_actor_method_bind_builds_a_graph_node(cluster):
    from ray_tpu_torch.api import ActorMethod
    from ray_tpu_torch.dag import ClassMethodNode

    a = Adder.remote(2)
    method = a.add
    assert isinstance(method, ActorMethod)
    with InputNode() as inp:
        node = method.bind(inp)
    assert isinstance(node, ClassMethodNode)
    assert node.method_name == "add" and node.actor is a
    assert node.execute(4) == 6
