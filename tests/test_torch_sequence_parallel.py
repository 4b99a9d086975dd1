"""Ring attention and Ulysses of the port (ray_tpu_torch/parallel/) against
the reference's dense attention, and the train step with each against the
reference's dense step: the reference's own checks
(tests/test_sequence_parallel.py) on the mesh {"sp": 4, "tp": 2}; dense
and flash attention under sp (the sequence gathered over sp) against the
reference's sharded steps.

The port side runs in 8 spawned ranks of a gloo process group
(tests/torch_spawn_util.py), once per module; this module's top level
imports torch, numpy and ray_tpu_torch only. Tolerances are the
reference's: outputs 2e-5, ring gradients 5e-4, losses rtol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.models.llama import PRESETS, params_from_jax
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import make_mesh
from ray_tpu_torch.parallel.ring_attention import make_ring_attention
from ray_tpu_torch.parallel.sharding import distribute, shard_pytree
from ray_tpu_torch.parallel.ulysses import make_ulysses_attention
from ray_tpu_torch.train import step as tstep

CFG = PRESETS["tiny"]
SP_MESH = {"sp": 4, "tp": 2}
ULYSSES_TRAIN = {"sp": 2, "dp": 2, "ep": 2}
DENSE_TRAIN = {"dp": 2, "tp": 4}
# Dense and flash attention under sp = 2: each rank gathers the sequence.
GATHERED_MESH = {"sp": 2, "dp": 2, "tp": 2}
GATHERED = ("dense", "flash")


def _qkv(seed, h=4, hkv=2, b=2, s=32, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, d)).astype(np.float32)
                 for n in (h, hkv, hkv))


def _local(x, mesh):
    """This rank's block of a whole [B, S, H, D] array: sequence over sp,
    heads over tp."""
    x = col.local_chunk(torch.from_numpy(x), mesh, "sp", 1)
    return col.local_chunk(x, mesh, "tp", 2).contiguous()


def _whole(x, mesh):
    with torch.no_grad():
        x = col.gather_from(x.detach(), mesh, "tp", 2)
        return col.gather_from(x, mesh, "sp", 1).numpy()


def _attention(make, mesh, qkv, grads=False):
    fn = make(mesh)
    q, k, v = (_local(x, mesh).requires_grad_(grads) for x in qkv)
    out = fn(q, k, v)
    res = {"out": _whole(out, mesh)}
    if grads:
        dq, dk, dv = torch.autograd.grad((out ** 2).sum(), (q, k, v))
        res.update(dq=_whole(dq, mesh), dk=_whole(dk, mesh),
                   dv=_whole(dv, mesh))
    return res


def _loss(cfg, params, sizes, tokens):
    mesh = make_mesh(sizes, device_type="cpu")
    opt = tstep.make_optimizer(total_steps=10)
    params = dict(params)
    for _, t in tstep._flatten(params):
        t.requires_grad_(True)
    state = shard_pytree(tstep.TrainState(0, params, opt.init(params)), mesh,
                         tstep.state_logical_axes(cfg, opt))
    _, m = tstep.jit_train_step(cfg, opt, mesh)(
        state, {"tokens": torch.from_numpy(tokens)})
    return {k: float(v) for k, v in m.items()}


def _worker(rank, world, params, tokens):
    mesh = make_mesh(SP_MESH, device_type="cpu")
    out = {"ring": _attention(make_ring_attention, mesh, _qkv(0)),
           "ulysses": _attention(make_ulysses_attention, mesh,
                                 _qkv(1, h=8, hkv=8)),
           "ring_grads": _attention(make_ring_attention, mesh, _qkv(2),
                                    grads=True)}
    # DTensor inputs: redistributed to the ring's spec, a DTensor back.
    ring = make_ring_attention(mesh)
    from ray_tpu_torch.parallel.sharding import logical_spec
    spec = logical_spec(("batch", None, None, None))
    dq, dk, dv = (distribute(torch.from_numpy(x), mesh, spec)
                  for x in _qkv(0))
    o = ring(dq, dk, dv)
    assert isinstance(o, DTensor)
    out["ring_dtensor"] = _whole(o.to_local(), mesh)
    # Dense attention under sp > 1: the sequence gathered over sp.
    out["dense_under_sp"] = _loss(CFG, params, SP_MESH, tokens)
    for impl in GATHERED:
        out["gathered_" + impl] = _loss(
            dataclasses.replace(CFG, attn_impl=impl), params, GATHERED_MESH,
            tokens)
    out["loss_ring"] = _loss(dataclasses.replace(CFG, attn_impl="ring"),
                             params, SP_MESH, tokens)
    out["loss_ulysses"] = _loss(dataclasses.replace(CFG, attn_impl="ulysses"),
                                params, ULYSSES_TRAIN, tokens)
    out["loss_dense"] = _loss(CFG, params, DENSE_TRAIN, tokens)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import PRESETS as REF_PRESETS
    from ray_tpu.models import init_params
    from ray_tpu.ops.attention import causal_attention
    from ray_tpu.parallel import make_mesh as ref_make_mesh
    from ray_tpu.parallel.sharding import tree_shardings
    from ray_tpu.train import step as ref_step

    out = {}
    for name, qkv in (("ring", _qkv(0)), ("ulysses", _qkv(1, h=8, hkv=8)),
                      ("ring_grads", _qkv(2))):
        out[name] = {"out": np.asarray(causal_attention(*qkv))}

    def loss(q, k, v):
        return jnp.sum(causal_attention(q, k, v) ** 2)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(*_qkv(2))
    out["ring_grads"].update(dq=np.asarray(dq), dk=np.asarray(dk),
                             dv=np.asarray(dv))

    rcfg = REF_PRESETS["tiny"]
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (2, 65), 0,
                                           rcfg.vocab_size))
    opt = ref_step.make_optimizer(total_steps=10)
    mesh = ref_make_mesh(DENSE_TRAIN)
    state = jax.device_put(
        ref_step.init_train_state(jax.random.key(0), rcfg, opt),
        tree_shardings(mesh, ref_step.state_logical_axes(rcfg, opt)))
    batch = {"tokens": jax.device_put(
        tokens, tree_shardings(mesh, ("batch", None)))}
    _, m = ref_step.jit_train_step(rcfg, opt, mesh)(state, batch)
    out["loss_dense"] = {k: float(v) for k, v in m.items()}
    # The reference's own step with dense and flash (interpreted) under
    # sp = 2, on the port's mesh.
    mesh = ref_make_mesh(GATHERED_MESH)
    for impl in GATHERED:
        cfg = dataclasses.replace(rcfg, attn_impl=impl)
        state = jax.device_put(
            ref_step.init_train_state(jax.random.key(0), cfg, opt),
            tree_shardings(mesh, ref_step.state_logical_axes(cfg, opt)))
        batch = {"tokens": jax.device_put(
            tokens, tree_shardings(mesh, ("batch", None)))}
        _, m = ref_step.jit_train_step(cfg, opt, mesh)(state, batch)
        out["gathered_" + impl] = {k: float(v) for k, v in m.items()}
    out["tokens"] = tokens
    out["params"] = jax.tree.map(
        np.asarray, init_params(jax.random.key(0), rcfg))
    return out


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    from torch_spawn_util import run_ranks

    params = params_from_jax(ref["params"], CFG, device="cpu")
    return run_ranks(_worker, 8, tmp_path_factory.mktemp("rdzv"), params,
                     ref["tokens"])[0]


def test_ring_matches_dense(ref, port):
    np.testing.assert_allclose(port["ring"]["out"], ref["ring"]["out"],
                               atol=2e-5)


def test_ring_takes_dtensors(ref, port):
    np.testing.assert_allclose(port["ring_dtensor"], ref["ring"]["out"],
                               atol=2e-5)


def test_ulysses_matches_dense(ref, port):
    np.testing.assert_allclose(port["ulysses"]["out"],
                               ref["ulysses"]["out"], atol=2e-5)


@pytest.mark.parametrize("name", ["out", "dq", "dk", "dv"])
def test_ring_attention_grads(ref, port, name):
    np.testing.assert_allclose(port["ring_grads"][name],
                               ref["ring_grads"][name], atol=5e-4)


def test_dense_attention_under_sp_raises(ref, port):
    """Dense attention under sp = 4 no longer raises: each rank gathers
    the sequence over sp, attends it whole and keeps its rows, as the
    reference's partitioner does; the step equals the reference's dense
    step on {"dp": 2, "tp": 4}."""
    got, want = port["dense_under_sp"], ref["loss_dense"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)


@pytest.mark.parametrize("impl", GATHERED)
def test_gathered_attention_under_sp_matches_reference(ref, port, impl):
    """attn_impl "dense" and "flash" on {"sp": 2, "dp": 2, "tp": 2}
    against the reference's sharded step with the same attention on the
    same mesh (its flash kernel interpreted)."""
    got, want = port["gathered_" + impl], ref["gathered_" + impl]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)


@pytest.mark.parametrize("impl", ["ring", "ulysses", "dense"])
def test_train_step_with_sequence_parallelism(ref, port, impl):
    """Ring on {"sp": 4, "tp": 2} and Ulysses on {"sp": 2, "dp": 2,
    "ep": 2} against the reference's dense step on {"dp": 2, "tp": 4}
    (the port's own dense step on that mesh too)."""
    got, want = port["loss_" + impl], ref["loss_dense"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
