"""NcclMeshGroup (ray_tpu_torch/collective/backends/nccl_group.py) against
the JAX package's XlaMeshGroup over conftest's 8 fake CPU devices: every
verb and mode on the same seeded inputs, the port's group on 8 CPU ranks
(its device-local route, the one several ranks on one card take). Integer
data must match exactly; random fp32 sums at rtol 1e-5 (the reference
test's own, fp32 reassociation); the int8 paths within one quantization
step of the reduced value (both sides quantize bit for bit alike, the
fp32 sums may round apart). Analytic wire bytes must be equal."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.collective.backends.xla_group import XlaMeshGroup
from ray_tpu.collective.types import PartialResult as RefPartial
from ray_tpu_torch.collective import algo as colalgo
from ray_tpu_torch.collective.backends.nccl_group import NcclMeshGroup
from ray_tpu_torch.collective.types import (
    CollectiveTimeoutError,
    PartialResult,
    ReduceOp,
)

WORLD = 8


@pytest.fixture(scope="module")
def groups():
    assert len(jax.devices()) == WORLD
    return (XlaMeshGroup(name="ref_mesh"),
            NcclMeshGroup(["cpu"] * WORLD, name="port_mesh"))


def _data(seed, shape, ints=False):
    rng = np.random.default_rng(seed)
    if ints:
        return [rng.integers(-8, 9, size=shape).astype(np.float32)
                for _ in range(WORLD)]
    return [rng.normal(size=shape).astype(np.float32) for _ in range(WORLD)]


def _ref_kw(kw):
    """The same kwargs for the JAX package (its own ReduceOp enum)."""
    from ray_tpu.collective.types import ReduceOp as RefOp

    return {k: RefOp(v.value) if k == "op" else v for k, v in kw.items()}


def _np(v):
    return np.asarray(v.value if isinstance(v, (PartialResult, RefPartial))
                      else v)


def _compare(want, got, tol):
    if isinstance(want, RefPartial):
        assert isinstance(got, PartialResult)
        assert (got.contributed, got.skipped, got.world) == (
            want.contributed, want.skipped, want.world)
        want, got = want.value, got.value
    assert len(got) == len(want) == WORLD
    for w, g in zip(want, got):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (g.shape, w.shape)
        if tol == "exact":
            np.testing.assert_array_equal(g.numpy(), w)
        elif tol == "codec":
            np.testing.assert_allclose(g.numpy(), w,
                                       atol=2 * np.abs(w).max() / 127)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


CASES = [
    # (verb, shape, kwargs, tolerance on random data)
    ("allreduce", (33, 5), {}, "fp32"),
    ("allreduce", (33, 5), {"op": ReduceOp.MAX}, "exact"),
    ("allreduce", (33, 5), {"op": ReduceOp.MIN}, "exact"),
    ("allreduce", (6,), {"op": ReduceOp.PRODUCT}, "fp32"),
    ("allreduce", (33, 5), {"algo": "ring"}, "fp32"),
    ("allreduce", (33, 5), {"algo": "tree"}, "fp32"),
    ("allreduce", (33, 5), {"algo": "auto"}, "fp32"),
    ("allreduce", (128, 128), {"compression": "int8"}, "codec"),
    ("allreduce", (33, 5), {"min_ranks": 4, "skip_ranks": [1, 5]}, "fp32"),
    ("allreduce", (128, 128), {"compression": "int8", "min_ranks": 4,
                               "skip_ranks": [1, 5]}, "codec"),
    ("reduce", (7,), {}, "fp32"),
    ("allgather", (4, 3), {}, "exact"),
    ("allgather", (300,), {"compression": "int8"}, "codec"),
    ("reducescatter", (16, 3), {}, "fp32"),
    ("reducescatter", (16, 3), {"algo": "tree"}, "fp32"),
    ("reducescatter", (16, 3), {"op": ReduceOp.MAX}, "exact"),
    ("reducescatter", (16, 3), {"compression": "int8"}, "codec"),
    ("reducescatter", (16, 3), {"min_ranks": 2, "skip_ranks": [0, 7]},
     "fp32"),
    ("broadcast", (5,), {"root": 3}, "exact"),
    ("permute", (5,), {"perm": [(i, (i + 1) % WORLD) for i in range(4)]},
     "exact"),
]


@pytest.mark.parametrize("verb,shape,kw,tol", CASES,
                         ids=[f"{c[0]}-{'-'.join(map(str, c[2]))}"
                              for c in CASES])
def test_verb_matches_xla_mesh(groups, verb, shape, kw, tol):
    ref, port = groups
    for ints in (False, True):
        if ints and "compression" in kw:
            continue
        xs = _data(len(verb) * 100 + shape[0], shape, ints)
        want = getattr(ref, verb)(xs, **_ref_kw(kw))
        got = getattr(port, verb)([torch.from_numpy(x) for x in xs], **kw)
        # Integer-valued data sums exactly in any order.
        _compare(want, got, "exact" if ints else tol)
        if ref._last_wire_bytes is not None or verb != "broadcast":
            assert port._last_wire_bytes == ref._last_wire_bytes, verb
    assert port.last_route == "local"


@pytest.mark.parametrize("verb", ["allreduce", "reducescatter",
                                  "allgather"])
def test_async_verbs_match_sync(groups, verb):
    ref, port = groups
    xs = _data(5, (16, 2))
    t = [torch.from_numpy(x) for x in xs]
    kw = {"min_ranks": 7, "skip_ranks": [2]} if verb == "allreduce" else {}
    work = getattr(port, f"{verb}_async")(t, **kw)
    got = work.wait()
    assert work.done() and work.wait() is got
    want = getattr(ref, f"{verb}_async")(xs, **kw).wait()
    _compare(want, got, "fp32")


def test_errors_barrier_and_send(groups):
    ref, port = groups
    xs = [torch.ones(4) for _ in range(WORLD)]
    with pytest.raises(CollectiveTimeoutError):
        port.allreduce(xs, min_ranks=8, skip_ranks=[0])
    with pytest.raises(ValueError, match="SUM only"):
        port.allreduce(xs, op=ReduceOp.MAX, compression="int8")
    with pytest.raises(TypeError, match="floating"):
        port.allreduce([torch.ones(4, dtype=torch.int32)] * WORLD,
                       compression="int8")
    with pytest.raises(ValueError, match="hub"):
        port.allreduce(xs, algo="hub")
    with pytest.raises(ValueError, match="not divisible"):
        port.reducescatter([torch.ones(3)] * WORLD)
    with pytest.raises(ValueError, match="expected 8"):
        port.allreduce(xs[:3])
    with pytest.raises(NotImplementedError, match="permute"):
        port.send(xs[0], 1)
    port.barrier()
    ref.barrier()


def test_bf16_sums_in_rank_order(groups):
    """bf16 ranks: the local route adds in rank order, rounding to bf16
    after each add (what the card's route does too)."""
    _, port = groups
    xs = [torch.from_numpy(x).to(torch.bfloat16) for x in _data(6, (64,))]
    want = xs[0].clone()
    for x in xs[1:]:
        want = want + x
    for g in port.allreduce(xs):
        assert g.dtype == torch.bfloat16 and torch.equal(g, want)


def test_init_collective_group_nccl_mesh_on_cpu_ranks():
    """Backend.NCCL_MESH through the public API, ranks given as CPU
    devices (no runtime needed: the mesh group is in-process)."""
    import ray_tpu_torch.api as api
    from ray_tpu_torch import collective as col

    class _Ready:
        ready = True

    saved = api._runtime
    api._runtime = _Ready()
    try:
        col.init_collective_group(4, 0, backend="nccl_mesh",
                                  group_name="mesh_api",
                                  devices=["cpu"] * 4)
        out = col.allreduce([torch.full((3,), float(i)) for i in range(4)],
                            group_name="mesh_api")
        assert [float(o[0]) for o in out] == [6.0] * 4
        work = col.allreduce_async([torch.ones(2)] * 4,
                                   group_name="mesh_api")
        assert float(work.wait()[3][0]) == 4.0
        with pytest.raises(TypeError, match="per-rank"):
            col.allreduce(torch.ones(2), group_name="mesh_api")
        with pytest.raises(ValueError, match="4 local devices"):
            col.init_collective_group(3, 0, backend="nccl_mesh",
                                      group_name="mesh_bad",
                                      devices=["cpu"] * 4)
    finally:
        col._groups.pop("mesh_api", None)
        api._runtime = saved


def test_slice_devices_route_auto_to_hierarchical():
    g = NcclMeshGroup(colalgo.fake_slice_devices(2, ["cpu"] * 4), name="sl")
    assert g._choose_algo("auto", [torch.ones(4)] * 4, ReduceOp.SUM) == \
        colalgo.HIERARCHICAL
