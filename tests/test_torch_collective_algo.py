"""The port's algorithm selection (ray_tpu_torch/collective/algo.py)
against the JAX package's: the crossover table, ``choose_algorithm`` and
every wire-byte count exactly, and ``hierarchical_allreduce`` (eager
torch over per-rank tensors) against the JAX package's compiled program
over conftest's 8 fake CPU devices cut into 2 fake slices: classic, one
slice skipped in partial mode, the int8 DCN hop, both at once, and the
RAY_TPU_SLICE_FAIL chaos knob. fp32 sums are compared at rtol 1e-4, the
reference test's own; the int8 paths at the codec's bound."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.collective import algo as ref
from ray_tpu.parallel.mesh import fake_slice_devices as jax_fake_slices
from ray_tpu_torch.collective import algo

SIZES = [0, 100, 64 << 10, (64 << 10) + 1, 200 << 10, 1 << 20, 8 << 20]
WORLDS = [1, 2, 3, 4, 8, 16, 33]


@pytest.mark.parametrize("override", [None, "auto", "ring", "tree", "hub",
                                      "hierarchical"])
def test_choose_algorithm_matches(override):
    for nbytes in SIZES:
        for world in WORLDS:
            for n_slices in (1, 2):
                for verb in ("allreduce", "reducescatter", "allgather"):
                    args = (nbytes, world, n_slices, override, verb)
                    assert (algo.choose_algorithm(*args)
                            == ref.choose_algorithm(*args)), args
    with pytest.raises(ValueError):
        algo.choose_algorithm(1, 2, override="nope")


@pytest.mark.parametrize("spec", ["", "65536", "2:1000,8:5000"])
def test_crossover_table_and_override(spec, monkeypatch):
    monkeypatch.setenv("RAY_TPU_COLLECTIVE_ALGO_CROSSOVER", spec)
    assert algo._crossover_table() == ref._crossover_table()
    for world in WORLDS:
        assert algo.crossover_bytes(world) == ref.crossover_bytes(world)


@pytest.mark.parametrize("verb", ["allreduce", "reducescatter", "allgather"])
def test_wire_bytes_match(verb):
    names = {"allreduce": ref.ALGOS[:3] + ("hierarchical",)}.get(
        verb, ("hub", "ring", "tree"))
    for a in names:
        for nbytes in SIZES:
            for world in WORLDS:
                for comp in (None, nbytes // 4 + 7):
                    args = (a, nbytes, world, 2, comp, verb)
                    assert (algo.wire_bytes_per_rank(*args)
                            == ref.wire_bytes_per_rank(*args)), args
    for length in (1, 1000, 123457):
        for block in (None, 256):
            args = (length, 4, 8, 2, block)
            assert algo.hier_dcn_wire_bytes(*args) == \
                ref.hier_dcn_wire_bytes(*args)


def _tensors(seed=7, n=8, length=1000):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(length,)).astype(np.float32) for _ in range(n)]


def _run_both(xs, **kw):
    want = ref.hierarchical_allreduce(
        xs, devices=jax_fake_slices(2, jax.devices()), group="hier_ref",
        **kw)
    got = algo.hierarchical_allreduce(
        [torch.from_numpy(x) for x in xs],
        devices=algo.fake_slice_devices(2, ["cpu"] * 8), group="hier_port",
        **kw)
    return want, got


@pytest.mark.parametrize("kw,tol", [
    ({}, None),
    ({"min_slices": 1, "skip_slices": [1]}, None),
    ({"compression": "int8"}, "codec"),
    ({"compression": "int8", "min_slices": 1, "skip_slices": [0]}, "codec"),
])
def test_hierarchical_matches_reference(kw, tol):
    xs = _tensors()
    want, got = _run_both(xs, **kw)
    partial = "min_slices" in kw
    if partial:
        assert (got.contributed, got.skipped, got.world) == (
            want.contributed, want.skipped, want.world)
        want, got = want.value, got.value
    assert len(got) == 8
    for w, g in zip(want, got):
        w = np.asarray(w)
        if tol is None:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)
        else:
            # Two codec round trips on the inter-slice hop, each within
            # absmax/254 of its block (sum of 2 slices' shards, then the
            # reduced shard): the JAX result and the port's differ by at
            # most one quantization step where their fp32 sums round
            # differently.
            bound = 2 * np.abs(w).max() / 127
            np.testing.assert_allclose(g.numpy(), w, atol=bound)
    # Exact where nothing rounds: integer-valued data.
    ints = [np.round(x * 10).astype(np.float32) for x in xs]
    want_i, got_i = _run_both(ints, **{k: v for k, v in kw.items()
                                       if k != "compression"})
    if partial:
        want_i, got_i = want_i.value, got_i.value
    for w, g in zip(want_i, got_i):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hierarchical_slice_kill_chaos_and_errors(monkeypatch):
    xs = _tensors(9)
    monkeypatch.setenv("RAY_TPU_SLICE_FAIL", "1:kill@0")
    want, got = _run_both(xs, min_slices=1)
    assert got.skipped == want.skipped == [1]
    for w, g in zip(want.value, got.value):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    monkeypatch.delenv("RAY_TPU_SLICE_FAIL")
    with pytest.raises(ValueError, match="do not split"):
        algo.hierarchical_allreduce([torch.from_numpy(x) for x in xs],
                                    devices=["cpu"] * 8, n_slices=3)
    from ray_tpu_torch.collective.types import CollectiveTimeoutError

    with pytest.raises(CollectiveTimeoutError):
        algo.hierarchical_allreduce(
            [torch.from_numpy(x) for x in xs],
            devices=algo.fake_slice_devices(2, ["cpu"] * 8),
            min_slices=2, skip_slices=[0])
    assert algo.slice_skip_stats("hier_port")[1] >= 1
