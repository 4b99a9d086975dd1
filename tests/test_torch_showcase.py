"""The composed pp x ep x fsdp program of the port
(ray_tpu_torch/parallel/showcase.py) against the reference's
(ray_tpu/parallel/showcase.py) on the mesh {pp: 2, ep: 2, fsdp: 2} of
conftest's 8 fake CPU devices: the reference's parameters (converted by
``composed_params_from_jax``), the loss and every gradient at 1e-5, for
whole parameters and for DTensors placed by ``composed_param_specs``.

The port side runs in 8 spawned ranks of a gloo process group
(tests/torch_spawn_util.py), once per module; this module's top level
imports torch, numpy and ray_tpu_torch only.
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import MESH_AXES, make_mesh
from ray_tpu_torch.parallel.sharding import distribute
from ray_tpu_torch.parallel.showcase import (
    D,
    N_EXPERTS,
    PP,
    composed_param_specs,
    composed_params_from_jax,
    composed_value_and_grad,
    make_composed_params,
)

MESH = {"pp": 2, "ep": 2, "fsdp": 2}


def _whole(t):
    if not isinstance(t, DTensor):
        return t.detach().numpy()
    x = t.to_local().detach()
    for i in reversed(range(len(MESH_AXES))):
        if t.placements[i].is_shard():
            x = col.gather_from(x, t.device_mesh, MESH_AXES[i],
                                t.placements[i].dim)
    return x.numpy()


def _worker(rank, world, params):
    mesh = make_mesh(MESH, device_type="cpu")
    loss, grads = composed_value_and_grad(params, mesh)
    out = {"whole": (loss.item(), {k: g.numpy() for k, g in grads.items()})}
    specs = composed_param_specs()
    placed = {k: distribute(v, mesh, specs[k]).requires_grad_()
              for k, v in params.items()}
    loss, grads = composed_value_and_grad(placed, mesh)
    out["placed"] = (loss.item(), {k: _whole(g) for k, g in grads.items()})
    out["placements_kept"] = all(
        tuple(grads[k].placements) == specs[k] for k in grads)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def ref():
    import jax

    from ray_tpu.parallel import make_mesh as ref_make_mesh
    from ray_tpu.parallel.showcase import (
        composed_value_and_grad as ref_value_and_grad,
        make_composed_params as ref_params,
    )

    mesh = ref_make_mesh(MESH)
    params = ref_params(jax.random.key(7))
    loss, grads = jax.jit(lambda p: ref_value_and_grad(p, mesh))(params)
    return dict(params=jax.tree.map(np.asarray, params), loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    from torch_spawn_util import run_ranks

    params = composed_params_from_jax(ref["params"], device="cpu")
    return run_ranks(_worker, 8, tmp_path_factory.mktemp("rdzv"),
                     params)[0]


@pytest.mark.parametrize("kind", ["whole", "placed"])
def test_composed_loss_matches_reference(ref, port, kind):
    np.testing.assert_allclose(port[kind][0], ref["loss"], rtol=1e-5)


@pytest.mark.parametrize("kind", ["whole", "placed"])
@pytest.mark.parametrize("leaf", ["experts", "dense"])
def test_composed_grads_match_reference(ref, port, kind, leaf):
    np.testing.assert_allclose(port[kind][1][leaf], ref["grads"][leaf],
                               rtol=1e-5, atol=1e-5)


def test_composed_grads_keep_their_placements(port):
    assert port["placements_kept"]


def test_make_composed_params_from_a_generator():
    """Shapes of the reference's tree; the same generator seed gives the
    same weights."""
    a = make_composed_params(torch.Generator().manual_seed(7), device="cpu")
    b = make_composed_params(torch.Generator().manual_seed(7), device="cpu")
    assert a["experts"].shape == (PP, N_EXPERTS, D, D)
    assert a["dense"].shape == (PP, D, D)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert 0.2 < float(a["experts"].std()) < 0.4
