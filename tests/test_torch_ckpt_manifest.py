"""The port's checkpoint manifests (ray_tpu_torch/checkpoint/manifest.py)
against the JAX package's, and train/checkpoint.py from several ranks.

- The same tree of dicts, lists and a NamedTuple with fp32, int32 and
  bf16 leaves gives the same manifest in both packages: keys (jax's
  ``keystr``), ownership, shapes, dtype names, windows and the sha256
  chunk hashes of every window's bytes. The port needs no ``ml_dtypes``
  (the JAX side builds its bf16 leaf with it from the port's bits).
- A DTensor's window on 2 and 4 gloo CPU ranks equals the reference's
  addressable-shard window of the same logical sharding on the same
  mesh coordinate (replica 0 only), and its bytes equal the shard's.
- ``train/checkpoint.py`` saves an fsdp=2 TrainState from 2 gloo ranks
  (each its windows, the lead swapping) and restores it resharded: onto
  tp=2 placements on the same ranks, and whole in one process, bit for
  bit.

The ranks run in spawned processes (tests/torch_spawn_util.py); the
module's top level imports no JAX (tests/test_torch_ops.py scans it).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from ray_tpu_torch.checkpoint import manifest as tman

CHUNK = 96  # bytes per chunk: several chunks per leaf, a short last one


class Pair(NamedTuple):
    step: object
    moments: object


def _tree():
    """Seeded leaves as torch tensors: fp32, int32, bf16, a 0-d int."""
    g = torch.Generator().manual_seed(3)
    return {
        "params": {
            "wq": torch.randn(6, 8, generator=g),
            "norm": [torch.randn(8, generator=g),
                     torch.randn(3, 2, generator=g)],
        },
        "ids": torch.randint(-50, 50, (5, 7), generator=g,
                             dtype=torch.int32),
        "opt": Pair(torch.tensor(7, dtype=torch.int32),
                    (torch.randn(4, 9, generator=g).to(torch.bfloat16),)),
    }


def _as_numpy(tree):
    """The same tree for the JAX package: numpy leaves, bf16 through
    ml_dtypes from the port's bits."""
    import ml_dtypes

    def conv(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, Pair):
            return Pair(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return conv(node)

    return walk(tree)


def _hashes(flat_bytes):
    from ray_tpu_torch.checkpoint.store import chunk_hash

    mv = memoryview(flat_bytes).cast("B")
    return [chunk_hash(mv[o:o + CHUNK])
            for o in range(0, max(1, len(mv)), CHUNK)]


@pytest.mark.parametrize("world", [1, 3])
def test_manifest_matches_reference(world):
    from ray_tpu.checkpoint import manifest as jman

    tree = _tree()
    ref_tree = _as_numpy(tree)
    assert ([k for k, _ in tman.flatten_with_keys(tree)]
            == [k for k, _ in jman.flatten_with_keys(ref_tree)]
            == sorted(["['ids']", "['opt'].moments[0]", "['opt'].step",
                       "['params']['norm'][0]", "['params']['norm'][1]",
                       "['params']['wq']"]))
    for rank in range(world):
        got = tman.owned_items(tree, rank, world)
        want = jman.owned_items(ref_tree, rank, world)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (key, leaf), (_, ref_leaf) in zip(got, want):
            ours, theirs = (tman.local_shards(leaf),
                            jman.local_shards(ref_leaf))
            assert len(ours) == len(theirs) == 1
            (idx, t), (ref_idx, arr) = ours[0], theirs[0]
            assert idx == ref_idx is None
            assert tuple(t.shape) == arr.shape, key
            assert tman.dtype_name(t) == arr.dtype.name, key
            data = tman.host_bytes(t)
            ref_data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
            assert _hashes(data) == _hashes(ref_data), key


def test_assemble_and_unflatten_round_trip():
    """Windows back to leaves (bf16 included) and the tree rebuilt in its
    own structure, NamedTuple and all."""
    tree = _tree()
    flat = tman.tree_flatten_with_keys(tree)
    chunks = {}

    def put(data):
        hs = _hashes(data)
        mv = memoryview(data).cast("B")
        for i, h in enumerate(hs):
            chunks[h] = bytes(mv[i * CHUNK:(i + 1) * CHUNK])
        return hs

    leaves = []
    for key, leaf in flat:
        shard = {"index": None, "chunks": put(tman.host_bytes(leaf))}
        leaves.append(tman.assemble_leaf(key, list(leaf.shape),
                                         tman.dtype_name(leaf), [shard],
                                         chunks.__getitem__))
    back = tman.tree_unflatten(tree, leaves)
    assert isinstance(back["opt"], Pair)
    for (k, a), (_, b) in zip(tman.tree_flatten_with_keys(back), flat):
        assert a.dtype == b.dtype and torch.equal(a, b), k


# (logical mesh sizes, per-case placements as mesh-axis names per dim)
MESHES = {
    2: {"fsdp": 2},
    4: {"fsdp": 2, "tp": 2},
}
CASES = {
    2: [("fsdp", None), (None, "fsdp"), (None, None)],
    4: [("fsdp", "tp"), ("tp", None), (None, "fsdp"), (("fsdp", "tp"),
                                                        None), (None, None)],
}
SHAPE = (8, 12)


def _placements(spec, axes):
    """DTensor placements (one per mesh axis) of a PartitionSpec-like
    tuple: each dim names a mesh axis, a tuple of them (major first) or
    None."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(axes)
    for dim, names in enumerate(spec):
        for name in (names if isinstance(names, tuple) else (names,)):
            if name is not None:
                out[axes.index(name)] = Shard(dim)
    return out


def _rank_windows(rank, world, sizes, cases, shape):
    """This rank's (window, bytes) of each case's DTensor."""
    from ray_tpu_torch.checkpoint import manifest
    from ray_tpu_torch.parallel.mesh import MESH_AXES, make_mesh
    from ray_tpu_torch.parallel.sharding import distribute

    mesh = make_mesh(sizes, device_type="cpu")
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    out = []
    for spec in cases:
        dt = distribute(full, mesh, _placements(spec, MESH_AXES))
        shards = manifest.local_shards(dt)
        out.append([(idx, t.numpy().copy()) for idx, t in shards])
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_dtensor_windows_match_reference_shards(world, tmp_path):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from ray_tpu.checkpoint import manifest as jman
    from ray_tpu.parallel.mesh import MESH_AXES
    from torch_spawn_util import run_ranks

    sizes = MESHES[world]
    got = run_ranks(_rank_windows, world, tmp_path, sizes, CASES[world],
                    SHAPE)
    shape = tuple(sizes.get(a, 1) for a in MESH_AXES)
    devices = np.array(jax.devices()[:world]).reshape(shape)
    mesh = Mesh(devices, MESH_AXES)
    full = np.arange(int(np.prod(SHAPE)), dtype=np.float32).reshape(SHAPE)
    for c, spec in enumerate(CASES[world]):
        arr = jax.device_put(full, NamedSharding(mesh, PartitionSpec(*spec)))
        by_device = {sh.device: sh for sh in arr.addressable_shards}
        for rank in range(world):
            sh = by_device[devices.reshape(-1)[rank]]
            if sh.replica_id != 0:
                assert got[rank][c] == [], (spec, rank)
                continue
            # The reference's window of that one shard (its local_shards
            # walks every addressable shard of the process).
            want = [w for w in jman.local_shards(arr)
                    if np.array_equal(w[1], np.asarray(sh.data))]
            assert len(got[rank][c]) == 1, (spec, rank)
            idx, data = got[rank][c][0]
            assert any(idx == w_idx for w_idx, _ in want), (spec, rank, idx)
            np.testing.assert_array_equal(data, np.asarray(sh.data))


def _rank_checkpoint(rank, world, path):
    """Save an fsdp=2 TrainState of the tiny preset from this rank (both
    ranks call save_checkpoint); restore it onto tp=2 placements; return
    each restored local shard with its window, and the saved whole
    tensors (rank 0)."""
    from ray_tpu_torch.checkpoint import manifest
    from ray_tpu_torch.models.llama import PRESETS
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import checkpoint as ck
    from ray_tpu_torch.train import step as tstep

    cfg = PRESETS["tiny"]
    opt = tstep.make_optimizer(lr=1e-2, warmup=1, total_steps=8,
                               mu_dtype=torch.bfloat16)
    fsdp = make_mesh({"fsdp": 2}, device_type="cpu")
    state = tstep.init_train_state(cfg, opt, seed=5, device="cpu",
                                   mesh=fsdp)
    # One step, so the moments are not zeros.
    step = tstep.jit_train_step(cfg, opt, fsdp)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 17)).astype(np.int32))
    state, _ = step(state, {"tokens": tokens})
    mgr = ck.CheckpointManager(path, num_to_keep=1)
    saved = mgr.save(1, state)
    tp = make_mesh({"tp": 2}, device_type="cpu")
    target = tstep.init_train_state(cfg, opt, seed=9, device="cpu", mesh=tp)
    _, back = mgr.restore_latest_valid(target=target)
    out = {}
    for name, t in tstep.train_state_dict(back).items():
        window = None
        if hasattr(t, "to_local"):
            window, t = manifest.dtensor_window(t), t.to_local()
        # numpy across the process boundary (bf16 as its int16 bits)
        out[name] = (window, str(t.dtype),
                     (t.view(torch.int16) if t.dtype == torch.bfloat16
                      else t).numpy().copy())
    return saved, out


def test_train_checkpoint_two_ranks_restores_resharded(tmp_path):
    from ray_tpu_torch.train import checkpoint as ck
    from torch_spawn_util import run_ranks

    path = str(tmp_path / "run")
    results = run_ranks(_rank_checkpoint, 2, tmp_path, path)
    saved = results[0][0]
    assert sorted(f for f in os.listdir(saved)
                  if f.endswith(".pt")) == ["state.r0.pt", "state.r1.pt"]
    whole = ck.restore_checkpoint(saved, device="cpu")
    flat = dict(ck.train_state_dict(whole))
    assert whole.step == 1 and whole.opt_state.count == 1
    assert flat["mu/tok_emb"].dtype == torch.bfloat16
    resharded = 0
    for _, out in results:
        assert out.keys() == flat.keys()
        for name, (window, dtype, local) in out.items():
            want = flat[name]
            if window is not None:
                want = want[tuple(slice(a, b) for a, b in window)]
                resharded += local.size < flat[name].numel()
            assert dtype == str(want.dtype), name
            if want.dtype == torch.bfloat16:
                want = want.view(torch.int16)
            np.testing.assert_array_equal(local, want.numpy(), err_msg=name)
    assert resharded > 0
