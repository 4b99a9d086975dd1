"""The port's GradBucketer (ray_tpu_torch/collective/bucketer.py) against
the JAX package's, on the same seeded per-rank gradient trees: the port
over NcclMeshGroup on 8 CPU ranks, the reference over XlaMeshGroup on
conftest's 8 fake CPU devices. The bucket plans must be equal (leaf names
in the JAX package's key-string form, bytes, dtype, algorithm,
compression, layout), and the synced trees equal the reference's at
rtol 1e-5 (fp32 reassociation), int8 within one quantization step of the
reduced value; the ZeRO-sharded sync's plan, owned reductions and
gathered weights too; the analytic bucket cost reads NVLink's rate."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.collective.backends.xla_group import XlaMeshGroup
from ray_tpu.collective.bucketer import GradBucketer as RefBucketer
from ray_tpu_torch.collective import bucketer as port_bucketer
from ray_tpu_torch.collective.backends.nccl_group import NcclMeshGroup
from ray_tpu_torch.collective.bucketer import GradBucketer

WORLD = 8


@pytest.fixture(scope="module")
def groups():
    assert len(jax.devices()) == WORLD
    return (XlaMeshGroup(name="ref_bucket"),
            NcclMeshGroup(["cpu"] * WORLD, name="port_bucket"))


def _trees(seed=0):
    """A layered model's gradients (names sort apart from layer order)."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (64, 16), "layers": [{"wq": (16, 16), "b": (16,)}
                                            for _ in range(3)],
              "head": (16, 64), "norm": (16,), "step": (2,)}

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [make(v) for v in spec]
        return rng.normal(size=spec).astype(np.float32)

    return [make(shapes) for _ in range(WORLD)]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _plan(buckets):
    return [(b.names, b.nbytes, b.dtype, b.algo, b.compression, b.layout)
            for b in buckets]


@pytest.mark.parametrize("kw", [
    {},
    {"algo": None},
    {"algo": "ring"},
    {"compression": "int8"},
    {"compression": "int8", "error_feedback": True},
    {"min_ranks": 6},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "auto")
@pytest.mark.parametrize("bucket_bytes", [1024, 1 << 20])
def test_sync_plan_and_tree_match(groups, kw, bucket_bytes):
    ref_g, port_g = groups
    trees = _trees()
    ref = RefBucketer(group=ref_g, bucket_bytes=bucket_bytes, **kw)
    port = GradBucketer(group=port_g, bucket_bytes=bucket_bytes, **kw)
    want = ref.sync(trees)
    got = port.sync([_to_torch(t) for t in trees])
    assert _plan(port.last_plan) == _plan(ref.last_plan)
    assert len(got) == WORLD
    for w_tree, g_tree in zip(want, got):
        for w, g in zip(_leaves(w_tree), _leaves(g_tree)):
            assert isinstance(g, torch.Tensor)
            w = np.asarray(w)
            if "compression" in kw:
                np.testing.assert_allclose(
                    g.numpy(), w, atol=2 * np.abs(w).max() / 127)
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                           atol=1e-5)
    assert port._scratch_bytes == 0


def test_stream_issues_full_buckets_on_add(groups):
    _, port_g = groups
    b = GradBucketer(group=port_g, bucket_bytes=256)
    st = b.stream()
    st.add("['a']", [torch.ones(64) * r for r in range(WORLD)])
    assert len(st._handles) == 1  # 256 bytes: issued on the spot
    st.add("['b']", [torch.ones(3) for _ in range(WORLD)])
    pending = st.finish()
    out = pending.wait()
    assert float(out["['a']"][0][0]) == sum(range(WORLD))
    assert [bk.names for bk in pending.buckets] == [["['a']"], ["['b']"]]


def test_zero_sharded_sync_matches(groups):
    ref_g, port_g = groups
    trees = _trees(1)
    ref = RefBucketer(group=ref_g, bucket_bytes=4096)
    port = GradBucketer(group=port_g, bucket_bytes=4096)
    r_pending = ref.sync_sharded_async(trees)
    p_pending = port.sync_sharded_async([_to_torch(t) for t in trees])
    plan = [(b.names, b.nbytes, b.dtype, b.algo_rs, b.algo_ag, b.seg_len,
             b.layout) for b in p_pending.buckets]
    assert plan == [(b.names, b.nbytes, b.dtype, b.algo_rs, b.algo_ag,
                     b.seg_len, b.layout) for b in r_pending.buckets]
    r_owned, p_owned = r_pending.wait(), p_pending.wait()
    assert sorted(p_owned) == sorted(r_owned)
    for k in r_owned:
        np.testing.assert_allclose(p_owned[k].numpy(),
                                   np.asarray(r_owned[k]), rtol=1e-5,
                                   atol=1e-5)
    r_gat = r_pending.allgather_updated(
        {k: np.asarray(v) / WORLD for k, v in r_owned.items()}).wait()
    p_gat = p_pending.allgather_updated(
        {k: v / WORLD for k, v in p_owned.items()}).wait()
    r_tree = ref.zero_unflatten(trees, r_gat)
    p_tree = port.zero_unflatten([_to_torch(t) for t in trees], p_gat)
    for w, g in zip(_leaves(r_tree), _leaves(p_tree)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert port._scratch_bytes == 0


def test_analytic_cost_reads_nvlink():
    assert port_bucketer.link_bandwidth_per_gpu("NVIDIA H100 80GB HBM3") \
        == 450e9
    nbytes = 100 << 20
    assert port_bucketer.bucket_analytic_cost_s(nbytes, 4) == pytest.approx(
        nbytes * 1.5 / 450e9)
    assert port_bucketer.bucket_analytic_cost_s(nbytes, 1) == 0.0
    assert port_bucketer.bucket_analytic_cost_s(
        nbytes, 4, "reducescatter") == pytest.approx(nbytes * 0.75 / 450e9)
