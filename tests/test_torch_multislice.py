"""The port's multislice mesh (ray_tpu_torch/parallel/mesh.py:
``make_multislice_mesh``, ``fake_slice_devices``) against the reference's
on conftest's 8 fake CPU devices.

- The rank arrangement of fake slices equals the reference's device-id
  arrangement (``jax.experimental.mesh_utils.create_hybrid_device_mesh``
  through ``make_multislice_mesh``), for the reference's case ({fsdp: 2,
  tp: 2} inside slices x {dp: 2} across them, tests/test_ops.py) and
  others; and a rank's slice read from ``LOCAL_WORLD_SIZE`` (torchrun's
  ranks per node).
- The validation errors are the reference's.
- 8 spawned gloo ranks build the meshes: the hybrid one holds the
  arrangement and its dp groups are the slices; with one slice the DCN
  factors fold into the flat mesh (tests/test_ops.py); a sum over
  (dp, fsdp) on the hybrid mesh is the whole sum.

This module's top level imports torch, numpy and ray_tpu_torch only.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import mesh as tmesh

CASES = [
    ({"fsdp": 2, "tp": 2}, {"dp": 2}, 2),  # the reference's case
    ({"tp": 2, "sp": 2}, {"fsdp": 2}, 2),
    ({"tp": 2}, {"dp": 2, "pp": 2}, 4),
    ({"ep": 2, "sp": 2}, {"dp": 2}, 2),
    ({}, {"fsdp": 8}, 8),
]


def _ref_arrangement(ici, dcn, n_slices):
    import jax

    from ray_tpu.parallel.mesh import fake_slice_devices, make_multislice_mesh

    mesh = make_multislice_mesh(ici, dcn, devices=fake_slice_devices(
        n_slices, jax.devices()))
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _port_arrangement(ici, dcn, ranks):
    sizes_dcn = [int(dcn.get(a, 1)) for a in tmesh.MESH_AXES]
    sizes_ici = tmesh._resolve_sizes(
        {a: int(ici.get(a, 1)) for a in tmesh.MESH_AXES},
        len(ranks) // int(np.prod(sizes_dcn)))
    return tmesh.hybrid_rank_array(
        [sizes_ici[a] for a in tmesh.MESH_AXES], sizes_dcn, ranks)


@pytest.mark.parametrize("ici,dcn,n_slices", CASES)
def test_hybrid_arrangement_matches_reference(ici, dcn, n_slices):
    got = _port_arrangement(ici, dcn,
                            tmesh.fake_slice_devices(n_slices, range(8)))
    np.testing.assert_array_equal(got, _ref_arrangement(ici, dcn, n_slices))


def test_slices_from_local_world_size(monkeypatch):
    """Under torchrun a rank's slice is its node: rank // LOCAL_WORLD_SIZE
    gives the fake slices' arrangement."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert [tmesh.slice_index(r) for r in range(8)] == [0] * 4 + [1] * 4
    np.testing.assert_array_equal(
        _port_arrangement({"fsdp": 2, "tp": 2}, {"dp": 2}, list(range(8))),
        _ref_arrangement({"fsdp": 2, "tp": 2}, {"dp": 2}, 2))
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert {tmesh.slice_index(r) for r in range(8)} == {0}


@pytest.mark.parametrize("ici,dcn", [
    ({"xp": 2}, {"dp": 2}),
    ({"tp": 2}, {"bogus": 2}),
    ({"tp": -1}, {"dp": 2}),
    ({"tp": 2}, {"dp": 0}),
])
def test_validation_errors_match_reference(ici, dcn):
    from ray_tpu.parallel.mesh import make_multislice_mesh

    with pytest.raises(ValueError) as ref_err:
        make_multislice_mesh(ici, dcn)
    with pytest.raises(ValueError) as err:
        tmesh.make_multislice_mesh(ici, dcn, device_type="cpu")
    assert str(err.value) == str(ref_err.value)


def test_fake_slices_must_split_evenly():
    with pytest.raises(ValueError, match="do not split"):
        tmesh.fake_slice_devices(3, range(8))


def _worker(rank, world, want_hybrid):
    import torch.distributed as dist

    out = {}
    mesh = tmesh.make_multislice_mesh(
        {"fsdp": 2, "tp": 2}, {"dp": 2}, ranks=tmesh.fake_slice_devices(2),
        device_type="cpu")
    out["hybrid"] = mesh.mesh.numpy()
    out["dp_group"] = sorted(dist.get_process_group_ranks(
        mesh.get_group("dp")))
    x = torch.tensor([float(rank)])
    for a in ("dp", "fsdp"):
        dist.all_reduce(x, group=mesh.get_group(a))
    out["data_sum"] = float(x)
    flat = tmesh.make_multislice_mesh({"tp": 2, "sp": 2}, {"dp": 2},
                                      device_type="cpu")
    ref_flat = tmesh.make_mesh({"tp": 2, "sp": 2, "dp": 2},
                               device_type="cpu")
    out["fold"] = (flat.mesh.numpy(), ref_flat.mesh.numpy(),
                   flat.mesh_dim_names)
    return out if rank == want_hybrid else None


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from torch_spawn_util import run_ranks

    return run_ranks(_worker, 8, tmp_path_factory.mktemp("rdzv"), 0)[0]


def test_hybrid_mesh_holds_the_arrangement(port):
    np.testing.assert_array_equal(
        port["hybrid"].reshape(-1),
        _ref_arrangement({"fsdp": 2, "tp": 2}, {"dp": 2}, 2).reshape(-1))
    # rank 0's dp group: rank 0 and the same place in the other slice.
    assert port["dp_group"] == [0, 4]


def test_hybrid_mesh_runs_collectives(port):
    """A sum over (dp, fsdp) on the hybrid mesh is rank 0's data group's:
    the ranks with tp index 0 (0, 2, 4, 6)."""
    assert port["data_sum"] == 0.0 + 2.0 + 4.0 + 6.0


def test_single_slice_folds_into_the_flat_mesh(port):
    got, want, names = port["fold"]
    np.testing.assert_array_equal(got, want)
    assert names == tmesh.MESH_AXES
