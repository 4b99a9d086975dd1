"""ResNet (ray_tpu_torch/models/resnet.py) against the JAX package's.

The four cases of tests/test_resnet.py on the port (shapes; the resnet50
preset; tiny learning the synthetic set; data-parallel training), then
parity in fp32 with weights from the reference's ``init_params`` through
``params_from_jax``: logits within 1e-4, each gradient leaf within 1e-4
of its norm, three Adam steps within 1e-4, for tiny at 16 pixels, tiny
with the ImageNet stem (7x7 stride-2 SAME convolution and the -inf padded
max pool) at 32 pixels, tiny's widths repeated (the stride-only residual
path), and a bottleneck tiny. The dp case runs 4 spawned gloo ranks
(tests/torch_spawn_util.py), each on its quarter of the batch with the
gradients mean-reduced here, against the reference's {"dp": 4} mesh.
This module's top level imports torch, numpy and ray_tpu_torch only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.resnet import (
    PRESETS,
    forward,
    init_params,
    loss_fn,
    params_from_jax,
)

TOL = 1e-4
F32 = dict(dtype=torch.float32)
CASES = {
    "tiny": ({}, 16),
    "imagenet_stem": (dict(stem_kernel=7, stem_stride=2, stem_pool=True),
                      32),
    "stride_only_residual": (dict(widths=(8, 8)), 16),
    "bottleneck": (dict(widths=(16, 32), bottleneck=True), 16),
}
DP, DP_STEPS, DP_PARITY_STEPS = 4, 40, 10


def _synthetic(n, hw=16, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    images = rng.normal(0, 0.1, (n, hw, hw, 3)).astype(np.float32)
    # SPATIAL class signal (a bright row at a label-dependent position):
    # a constant per-image shift would be erased by GroupNorm.
    images[np.arange(n), labels % hw, :, :] += 2.0
    return {"images": images, "labels": labels.astype(np.int64)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _grads(params, batch, cfg):
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, aux = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss, aux, grads


def _adam_steps(params, batch, cfg, steps, lr=1e-2):
    """``steps`` Adam steps (torch.optim.Adam, optax.adam's update); the
    loss before each."""
    leaves = _leaves(params)
    opt = torch.optim.Adam(leaves, lr=lr, foreach=False)
    losses = []
    for _ in range(steps):
        loss, _, grads = _grads(params, batch, cfg)
        for t, g in zip(leaves, grads):
            t.grad = g
        opt.step()
        losses.append(float(loss.detach()))
    return losses


# ------------------------------------------------ tests/test_resnet.py
def test_forward_shapes():
    cfg = PRESETS["tiny"]
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = _torch(_synthetic(4))
    logits = forward(params, batch["images"], cfg)
    assert logits.shape == (4, 10) and logits.dtype == torch.float32


def test_resnet50_preset_builds():
    cfg = PRESETS["resnet50"]
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    logits = forward(params, torch.zeros((1, 32, 32, 3)), cfg)
    assert logits.shape == (1, 1000)
    assert cfg.num_params() > 2e7  # ~23M+ (GroupNorm variant)
    assert cfg.num_params() == sum(t.numel() for t in _leaves(params))


def test_training_learns_synthetic():
    cfg = PRESETS["tiny"]
    params = init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    batch = _torch(_synthetic(64))
    losses = _adam_steps(params, batch, cfg, 100)
    loss, aux = loss_fn(params, batch, cfg)
    assert float(loss) < losses[0] * 0.5
    assert float(aux["accuracy"]) > 0.7


def _dp_worker(rank, world, params, batch, steps):
    """One dp rank: its quarter of the batch, gradients and loss averaged
    over the group, Adam on the replicated params; the mean loss before
    each step."""
    cfg = dataclasses.replace(PRESETS["tiny"], **F32)
    n = len(batch["labels"]) // world
    mine = _torch({k: v[rank * n:(rank + 1) * n] for k, v in batch.items()})
    # The spawn moved ``params`` to memory every rank shares: a copy each.
    params = _clone(params)
    leaves = _leaves(params)
    opt = torch.optim.Adam(leaves, lr=1e-2, foreach=False)
    losses = []
    for _ in range(steps):
        loss, _, grads = _grads(params, mine, cfg)
        flat = torch.cat([loss.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat)
        flat /= world
        i = 1
        for t, g in zip(leaves, grads):
            t.grad = flat[i:i + g.numel()].view_as(g)
            i += g.numel()
        opt.step()
        losses.append(float(flat[0]))
    return losses


# ------------------------------------------------------------ reference
@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.models import resnet as jr
    from ray_tpu.parallel import make_mesh

    def train(cfg, params, batch, steps, mesh=None):
        opt = optax.adam(1e-2)
        state = opt.init(params)
        if mesh is not None:
            data = NamedSharding(mesh, P("dp"))
            batch = jax.tree.map(lambda x: jax.device_put(x, data), batch)
            params = jax.device_put(params, NamedSharding(mesh, P()))
            state = jax.device_put(state, NamedSharding(mesh, P()))

        @jax.jit
        def step(params, state, batch):
            loss, grads = jax.value_and_grad(
                lambda p: jr.loss_fn(p, batch, cfg)[0])(params)
            updates, state = opt.update(grads, state)
            return optax.apply_updates(params, updates), state, loss

        losses = []
        for _ in range(steps):
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
        return losses, jax.tree.map(np.asarray, params)

    out = {}
    for name, (kw, hw) in CASES.items():
        cfg = dataclasses.replace(jr.PRESETS["tiny"], dtype=jnp.float32,
                                  **kw)
        params = jr.init_params(jax.random.key(1), cfg)
        batch = _synthetic(8, hw=hw)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.value_and_grad(
            lambda p: jr.loss_fn(p, jb, cfg)[0])(params)
        losses, final = train(cfg, params, jb, 3)
        out[name] = dict(
            params=jax.tree.map(np.asarray, params), batch=batch,
            logits=np.asarray(jr.forward(params, jb["images"], cfg)),
            loss=float(loss), grads=jax.tree.map(np.asarray, grads),
            losses=losses, final=final)
    cfg = dataclasses.replace(jr.PRESETS["tiny"], dtype=jnp.float32)
    params = jr.init_params(jax.random.key(1), cfg)
    batch = _synthetic(64)
    mesh = make_mesh({"dp": DP}, devices=jax.devices()[:DP])
    losses, _ = train(cfg, params, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                      DP_STEPS, mesh)
    out["dp"] = dict(params=jax.tree.map(np.asarray, params), batch=batch,
                     losses=losses)
    return out


def _cfg(name):
    return dataclasses.replace(PRESETS["tiny"], **F32, **CASES[name][0])


@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_gradients_match_reference(ref, name):
    want, cfg = ref[name], _cfg(name)
    params = params_from_jax(want["params"], "cpu")
    batch = _torch(want["batch"])
    logits = forward(params, batch["images"], cfg)
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"],
                               atol=TOL, rtol=TOL)
    loss, _, grads = _grads(params, batch, cfg)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=TOL)
    wgrads = _leaves(params_from_jax(want["grads"], "cpu"))
    assert len(grads) == len(wgrads)
    for g, w in zip(grads, wgrads):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= TOL * max(float(w.norm()),
                                                       1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_adam_trajectory_matches_reference(ref, name):
    want, cfg = ref[name], _cfg(name)
    params = params_from_jax(want["params"], "cpu")
    losses = _adam_steps(params, _torch(want["batch"]), cfg, 3)
    np.testing.assert_allclose(losses, want["losses"], rtol=TOL)
    for got, w in zip(_leaves(params),
                      _leaves(params_from_jax(want["final"], "cpu"))):
        # Per leaf, as the gradients: Adam's first steps move an element
        # by ~lr whatever its gradient's size, so an element whose
        # gradient is near 0 may step either way.
        assert float((got - w).abs().max()) <= TOL * float(w.norm())


def test_data_parallel_training_matches_reference_mesh(ref, tmp_path):
    """tests/test_resnet.py's dp case: 4 ranks, 40 Adam steps on a 64-image
    batch, the loss below 0.8 of the first; the first DP_PARITY_STEPS
    losses (the ranks' mean) within 1e-4 of the reference's dp = 4 mesh
    run. Later steps drift apart as Adam at lr 1e-2 amplifies fp32
    rounding (about 1e-5 relative at step 10, 1e-3 at step 40), which is
    a property of the trajectory, not of the data parallelism: one
    process on the whole batch drifts from the reference alike."""
    from torch_spawn_util import run_ranks

    want = ref["dp"]
    params = params_from_jax(want["params"], "cpu")
    losses = run_ranks(_dp_worker, DP, tmp_path, params, want["batch"],
                       DP_STEPS)
    assert all(got == losses[0] for got in losses)
    assert losses[0][-1] < losses[0][0] * 0.8
    np.testing.assert_allclose(losses[0][:DP_PARITY_STEPS],
                               want["losses"][:DP_PARITY_STEPS], rtol=TOL)
