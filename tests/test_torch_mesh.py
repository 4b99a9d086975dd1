"""The port's mesh layout (ray_tpu_torch/parallel/mesh.py) against the
reference's: axis order, default factorizations and the size errors.
Meshes of real ranks are built in the multi-process tests
(test_torch_parallel_*.py, test_torch_sequence_parallel.py)."""

import pytest

from ray_tpu.parallel import mesh as ref_mesh
from ray_tpu_torch.parallel import mesh as tmesh


def test_mesh_axes_are_the_reference_axes():
    assert tmesh.MESH_AXES == ref_mesh.MESH_AXES


@pytest.mark.parametrize("n", range(1, 9))
def test_default_axis_sizes(n):
    assert tmesh.default_axis_sizes(n) == ref_mesh.default_axis_sizes(n)


@pytest.mark.parametrize("sizes,n", [
    ({"tp": 2, "fsdp": 2}, 4),
    ({"tp": 2, "dp": -1}, 8),
    ({"sp": -1}, 6),
    ({}, 1),
])
def test_resolve_sizes(sizes, n):
    assert tmesh._resolve_sizes(sizes, n) == ref_mesh._resolve_sizes(sizes, n)


@pytest.mark.parametrize("sizes,n", [
    ({"xp": 2}, 2),  # unknown axis
    ({"dp": -1, "tp": -1}, 4),  # two wildcards
    ({"tp": 0}, 1),  # invalid size
    ({"tp": 3, "dp": -1}, 8),  # wildcard cannot fill
    ({"tp": 2, "dp": 2}, 8),  # product differs
])
def test_resolve_sizes_errors_match(sizes, n):
    with pytest.raises(ValueError) as ref_err:
        ref_mesh._resolve_sizes(sizes, n)
    with pytest.raises(ValueError) as err:
        tmesh._resolve_sizes(sizes, n)
    assert str(err.value) == str(ref_err.value)


def test_make_mesh_needs_a_process_group():
    """The port never starts a process group on its own."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh({"tp": 1}, device_type="cpu")


def test_axis_size_without_mesh_is_one():
    assert all(tmesh.axis_size(None, a) == 1 for a in tmesh.MESH_AXES)
