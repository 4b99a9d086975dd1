"""Logical-axis sharding rules (ray_tpu_torch/parallel/sharding.py)
against the reference's: for every leaf of the dense, MoE and train-state
axis trees the port's placements equal the reference's PartitionSpec,
mesh axis by mesh axis. No processes: the mapping needs no mesh."""

import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.models import PRESETS as REF_PRESETS
from ray_tpu.models import param_logical_axes as ref_param_axes
from ray_tpu.models.moe import MOE_PRESETS as REF_MOE
from ray_tpu.models.moe import moe_param_logical_axes as ref_moe_axes
from ray_tpu.parallel import sharding as ref_sharding
from ray_tpu.train.step import make_optimizer as ref_make_optimizer
from ray_tpu.train.step import state_logical_axes as ref_state_axes
from ray_tpu_torch.models.llama import PRESETS, embed_impl, param_logical_axes
from ray_tpu_torch.models.moe import MOE_PRESETS, moe_param_logical_axes
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.mesh import MESH_AXES
from ray_tpu_torch.train import step as tstep


def _placements_of(spec):
    """A reference PartitionSpec as one placement per mesh axis."""
    out = [Replicate()] * len(MESH_AXES)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            out[MESH_AXES.index(axis)] = Shard(dim)
    return tuple(out)


def _leaves(tree, prefix=()):
    if sharding.is_axes_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        raise TypeError(tree)


def _compare(ref_tree, tree):
    ref = dict(_leaves(ref_tree))
    got = dict(_leaves(tree))
    assert got == ref  # the same axes, leaf for leaf
    for path, axes in got.items():
        want = _placements_of(ref_sharding.logical_spec(axes))
        assert sharding.logical_spec(axes) == want, path


def test_default_rules_are_the_reference_rules():
    assert sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES


def test_param_placements_match_reference():
    _compare(ref_param_axes(REF_PRESETS["tiny"]),
             param_logical_axes(PRESETS["tiny"]))


def test_moe_param_placements_match_reference():
    _compare(ref_moe_axes(REF_MOE["moe_tiny"]),
             moe_param_logical_axes(MOE_PRESETS["moe_tiny"]))


def _adam_axes(opt_axes):
    """The (mu, nu) axis trees inside optax's clip-then-adamw state."""
    if hasattr(opt_axes, "mu") and hasattr(opt_axes, "nu"):
        return opt_axes.mu, opt_axes.nu
    for sub in opt_axes:
        if isinstance(sub, tuple) and not sharding.is_axes_leaf(sub):
            found = _adam_axes(sub)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_state_placements_match_reference(moe):
    ref_cfg = REF_MOE["moe_tiny"] if moe else REF_PRESETS["tiny"]
    cfg = MOE_PRESETS["moe_tiny"] if moe else PRESETS["tiny"]
    ref = ref_state_axes(ref_cfg, ref_make_optimizer())
    got = tstep.state_logical_axes(cfg, tstep.make_optimizer())
    assert got.step == ref.step == ()
    _compare(ref.params, got.params)
    ref_mu, ref_nu = _adam_axes(ref.opt_state)
    assert got.opt_state.count == ()
    _compare(ref_mu, got.opt_state.mu)
    _compare(ref_nu, got.opt_state.nu)


@pytest.mark.parametrize("axes", [
    ("batch", None), ("batch", "act_seq", "act_embed"),
    ("embed", "vocab"), ("layers", "expert", "embed", "mlp"), (),
])
def test_activation_placements_match_reference(axes):
    want = _placements_of(ref_sharding.logical_spec(axes))
    assert sharding.logical_spec(axes) == want


def test_unknown_logical_axis_raises_like_reference():
    with pytest.raises(ValueError) as ref_err:
        ref_sharding.logical_spec(("nope",))
    with pytest.raises(ValueError) as err:
        sharding.logical_spec(("nope",))
    assert str(err.value) == str(ref_err.value)


def test_embed_auto_is_gather_on_one_device():
    """Outside a mesh "auto" is "gather" (under a mesh of more than one
    rank, "onehot": tests/test_torch_parallel_train.py)."""
    assert embed_impl(PRESETS["tiny"]) == "gather"
    assert jax.device_count() == 8  # the reference would take "onehot"


def test_constrain_is_identity_outside_a_mesh():
    import torch

    x = torch.ones(2, 3)
    assert sharding.constrain(x, "batch", None) is x
