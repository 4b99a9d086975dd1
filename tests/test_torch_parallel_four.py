"""The meshes of ``sharded_chip.py nccl-train`` at four ranks, against the
JAX package's sharded programs on 4 of conftest's 8 fake CPU devices
(``ray_tpu.parallel.make_mesh(..., devices=jax.devices()[:4])``):

- the train step (2 steps, the first at learning rate 0) under
  ``{"fsdp": 4}``, ``{"tp": 4}``, ``{"fsdp": 2, "tp": 2}``, and
  ``{"sp": 4}`` with ring and with Ulysses attention;
- moe_tiny's train step under ``{"ep": 4}`` (one expert per rank);
- the GPipe schedule over ``{"pp": 4}``, one layer per stage, 4
  microbatches: loss and every gradient;
- under ``{"ep": 4}`` and ``{"pp": 4}``, gradients of replicated leaves
  that differ by rank made one value (``agree_over_replicas``).

The dense model is tiny with bench's 2:1 head ratio, 8/4 heads of 16, so
that tp = 4 and Ulysses over sp = 4 split the KV heads (2/1 per rank).
The port runs flash attention (its plain version on the CPU) under remat
"flash_qkv", the reference its dense attention; ring and Ulysses both
sides. The same inputs from a numpy seed; weights through
``params_from_jax``. Tolerances are tests/test_torch_parallel_train.py's:
losses and gradient norms rtol 1e-4, parameters atol 2e-4; the pipeline's
loss and gradients tests/test_torch_pipeline.py's 1e-4.

The port side runs in 4 spawned ranks of a gloo process group
(tests/torch_spawn_util.py), once per module; this module's top level
imports torch, numpy and ray_tpu_torch only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.llama import (
    PRESETS,
    apply_blocks,
    embed,
    params_from_jax,
)
from ray_tpu_torch.models.moe import MOE_PRESETS
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import rope_frequencies
from ray_tpu_torch.parallel import pipeline_loss_fn
from ray_tpu_torch.parallel.mesh import MESH_AXES, make_mesh
from ray_tpu_torch.train import step as tstep

WORLD = 4
CFG = dataclasses.replace(PRESETS["tiny"], d_model=128, n_heads=8,
                          n_kv_heads=4, d_ff=256, n_layers=4)
MOE = MOE_PRESETS["moe_tiny"]
STEPS = 2  # the first update runs at lr 0 (warmup), the second moves
# name -> (mesh, the port's attention, the reference's attention)
MESHES = {
    "fsdp=4": ({"fsdp": 4}, "flash", "dense"),
    "tp=4": ({"tp": 4}, "flash", "dense"),
    "fsdp=2,tp=2": ({"fsdp": 2, "tp": 2}, "flash", "dense"),
    "sp=4 ring": ({"sp": 4}, "ring", "ring"),
    "sp=4 ulysses": ({"sp": 4}, "ulysses", "ulysses"),
}
MOE_MESH = {"ep": 4}
REPLICA_AXES = ("ep", "pp")
PP_MESH, MICRO = {"pp": 4}, 4
LEAVES = ("tok_emb", "final_norm", "lm_head", "blocks/attn_norm", "blocks/wq",
          "blocks/wk", "blocks/wv", "blocks/wo", "blocks/mlp_norm",
          "blocks/w_gate", "blocks/w_up", "blocks/w_down")


def _opt():
    return dict(lr=3e-4, warmup=1, total_steps=10)


def _port_cfg(impl):
    return dataclasses.replace(
        CFG, attn_impl=impl, remat="flash_qkv" if impl == "flash" else "none")


# ------------------------------------------------------------ port side
def _full(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()


def _train(cfg, params, sizes, tokens):
    from ray_tpu_torch.parallel.sharding import shard_pytree

    mesh = make_mesh(sizes, device_type="cpu")
    opt = tstep.make_optimizer(**_opt())
    params = dict(params)
    for _, t in tstep._flatten(params):
        t.requires_grad_(True)
    state = shard_pytree(tstep.TrainState(0, params, opt.init(params)), mesh,
                         tstep.state_logical_axes(cfg, opt))
    step = tstep.jit_train_step(cfg, opt, mesh)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, params={
        "/".join(p): _full(t) for p, t in tstep._flatten(state.params)})


def _pipeline(params, tokens):
    """The GPipe schedule over pp = 4: each rank holds one layer (the
    stacked leaves cut into 4 stages), the embedding before the pipeline
    and the final norm and cross entropy after it, flash attention in
    the stages (chip_smoke.py's phase 9a program)."""
    from ray_tpu_torch.parallel import mesh_spec
    from ray_tpu_torch.parallel.sharding import distribute, local

    cfg = _port_cfg("flash")
    mesh = make_mesh(PP_MESH, device_type="cpu")
    params = {k: ({n: v.clone() for n, v in t.items()}
                  if isinstance(t, dict) else t.clone())
              for k, t in params.items()}
    params["blocks"] = {
        k: distribute(v.reshape(WORLD, -1, *v.shape[1:]), mesh,
                      mesh_spec("pp"))
        for k, v in params["blocks"].items()}
    leaves = {"tok_emb": params["tok_emb"], "final_norm": params["final_norm"],
              "lm_head": params["lm_head"],
              **{"blocks/" + k: v for k, v in params["blocks"].items()}}
    for t in leaves.values():
        t.requires_grad_(True)
    toks = torch.from_numpy(tokens).long()
    inputs, targets = toks[:, :-1], toks[:, 1:]
    cos, sin = rope_frequencies(cfg.head_dim, inputs.shape[1],
                                cfg.rope_theta, device="cpu")

    def stage_fn(p, x):
        return apply_blocks(x, p, cos, sin, cfg, flash_attention)[0]

    def loss_head(y, batch):
        return tstep.chunked_cross_entropy(
            rms_norm(y, params["final_norm"]), params["lm_head"],
            batch["targets"], cfg.dtype)

    loss = pipeline_loss_fn(params["blocks"],
                            {"inputs": embed(params, inputs, cfg),
                             "targets": targets},
                            stage_fn, loss_head, mesh=mesh,
                            num_microbatches=MICRO)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    out = {}
    for k, g in zip(leaves, grads):
        g = local(g)
        if k.startswith("blocks/"):  # this rank's stage: gather the stack
            parts = [torch.empty_like(g) for _ in range(WORLD)]
            torch.distributed.all_gather(parts, g.contiguous(),
                                         group=mesh.get_group("pp"))
            g = torch.cat(parts).reshape(-1, *g.shape[2:])
        out[k] = g.numpy()
    return dict(loss=loss.item(), grads=out)


def _replicas(moe, axis):
    """moe_tiny's leaves under {axis: 4} (ep or pp) as gradients that
    differ by rank (each rank's shard plus rank + 1, as F2's atomic sums
    make a replicated leaf's gradient differ on the card), through
    ``agree_over_replicas``: {leaf: (sharded over axis, before, after)}."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import shard_pytree

    mesh = make_mesh({axis: WORLD}, device_type="cpu")
    rank = torch.distributed.get_rank()
    axes = tstep.state_logical_axes(MOE, tstep.make_optimizer(**_opt()))
    paths, leaves = zip(*tstep._flatten(shard_pytree(moe, mesh, axes.params)))
    grads = [DTensor.from_local(t.to_local().detach() + rank + 1, mesh,
                                t.placements, run_check=False)
             for t in leaves]
    after = tstep.agree_over_replicas(grads, mesh)
    dim = MESH_AXES.index(axis)
    return {"/".join(p): (g.placements[dim].is_shard(),
                          g.to_local().numpy(), a.to_local().numpy())
            for p, g, a in zip(paths, grads, after)}


def _worker(rank, world, dense, moe, tokens, moe_tokens):
    out = {name: _train(_port_cfg(impl), dense, sizes, tokens)
           for name, (sizes, impl, _) in MESHES.items()}
    out["moe ep=4"] = _train(MOE, moe, MOE_MESH, moe_tokens)
    out["pp=4"] = _pipeline(dense, tokens)
    out["replicas"] = {a: _replicas(moe, a) for a in REPLICA_AXES}
    return out if rank == 0 else {"replicas": out["replicas"]}


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import PRESETS as REF_PRESETS
    from ray_tpu.models import init_params
    from ray_tpu.models.llama import _block, _dense_ffn, _embed
    from ray_tpu.models.moe import MOE_PRESETS as REF_MOE
    from ray_tpu.models.moe import init_moe_params
    from ray_tpu.ops.attention import causal_attention
    from ray_tpu.ops.norms import rms_norm as ref_rms_norm
    from ray_tpu.ops.rope import rope_frequencies as ref_rope
    from ray_tpu.parallel import make_mesh as ref_make_mesh
    from ray_tpu.parallel.pipeline import pipeline_loss_fn as ref_loss_fn
    from ray_tpu.parallel.sharding import tree_shardings
    from ray_tpu.train import step as ref_step

    devices = jax.devices()[:WORLD]
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, CFG.vocab_size, (4, 33)).astype(np.int32)
    moe_tokens = rng.integers(0, MOE.vocab_size, (4, 33)).astype(np.int32)
    rcfg = dataclasses.replace(REF_PRESETS["tiny"], d_model=128, n_heads=8,
                               n_kv_heads=4, d_ff=256, n_layers=4)
    rmoe = REF_MOE["moe_tiny"]
    params = init_params(jax.random.key(0), rcfg)
    mparams = init_moe_params(jax.random.key(0), rmoe)
    out = {"tokens": tokens, "moe_tokens": moe_tokens,
           "params": jax.tree.map(np.asarray, params),
           "moe_params": jax.tree.map(np.asarray, mparams)}

    def train(cfg, sizes, toks):
        mesh = ref_make_mesh(sizes, devices=devices)
        opt = ref_step.make_optimizer(**_opt())
        step = ref_step.jit_train_step(cfg, opt, mesh)
        state = ref_step.init_train_state(jax.random.key(0), cfg, opt)
        state = jax.device_put(state, tree_shardings(
            mesh, ref_step.state_logical_axes(cfg, opt)))
        batch = {"tokens": jax.device_put(
            toks, tree_shardings(mesh, ("batch", None)))}
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        flat = {"/".join(str(k.key) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    state.params)[0]}
        return dict(metrics=metrics, params=flat)

    for name, (sizes, _, impl) in MESHES.items():
        out[name] = train(dataclasses.replace(rcfg, attn_impl=impl,
                                              remat="none"), sizes, tokens)
    out["moe ep=4"] = train(rmoe, MOE_MESH, moe_tokens)

    # The pipeline: 4 stages of one reference _block each.
    mesh = ref_make_mesh(PP_MESH, devices=devices)
    toks = jnp.asarray(tokens)
    inputs, targets = toks[:, :-1], toks[:, 1:]
    cos, sin = ref_rope(rcfg.head_dim, inputs.shape[1], rcfg.rope_theta)

    def stage(p, x):
        for i in range(p["wq"].shape[0]):
            x, _ = _block(x, jax.tree.map(lambda a: a[i], p), cos, sin, rcfg,
                          causal_attention, _dense_ffn)
        return x

    def pipe_loss(p):
        def loss_head(y, batch):
            logits = (ref_rms_norm(y, p["final_norm"])
                      @ p["lm_head"]).astype(jnp.float32)
            logz = jax.nn.logsumexp(logits, axis=-1)
            tgt = jnp.take_along_axis(logits, batch["targets"][..., None],
                                      -1)[..., 0]
            return jnp.mean(logz - tgt)

        stages = jax.tree.map(lambda a: a.reshape(WORLD, -1, *a.shape[1:]),
                              p["blocks"])
        x = _embed(p["tok_emb"], inputs, rcfg)
        return ref_loss_fn(stages, {"inputs": x, "targets": targets}, stage,
                           loss_head, mesh=mesh, num_microbatches=MICRO)

    loss, g = jax.jit(jax.value_and_grad(pipe_loss))(params)
    grads = {k: np.asarray(g[k]) for k in ("tok_emb", "final_norm",
                                           "lm_head")}
    grads.update({"blocks/" + k: np.asarray(v)
                  for k, v in g["blocks"].items()})
    out["pp=4"] = dict(loss=float(loss), grads=grads)
    return out


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    from torch_spawn_util import run_ranks

    dense = params_from_jax(ref["params"], CFG, device="cpu")
    moe = params_from_jax(ref["moe_params"], MOE, device="cpu")
    ranks = run_ranks(_worker, WORLD, tmp_path_factory.mktemp("rdzv"), dense,
                      moe, ref["tokens"], ref["moe_tokens"], timeout=300)
    return {**ranks[0], "replicas": [r["replicas"] for r in ranks]}


# ------------------------------------------------------------ tests
@pytest.mark.parametrize("name", [*MESHES, "moe ep=4"])
def test_train_step_on_four_ranks_matches_reference(ref, port, name):
    got, want = port[name], ref[name]
    for g, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
        if "aux_loss" in w:
            np.testing.assert_allclose(g["aux_loss"], w["aux_loss"],
                                       rtol=1e-4)
    assert len(got["metrics"]) == len(want["metrics"]) == STEPS
    assert got["params"].keys() == want["params"].keys()
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, atol=2e-4, err_msg=k)


def test_pipeline_over_four_stages_loss_matches_reference(ref, port):
    np.testing.assert_allclose(port["pp=4"]["loss"], ref["pp=4"]["loss"],
                               rtol=1e-4)


@pytest.mark.parametrize("leaf", LEAVES)
def test_pipeline_over_four_stages_grads_match_reference(ref, port, leaf):
    np.testing.assert_allclose(port["pp=4"]["grads"][leaf],
                               ref["pp=4"]["grads"][leaf], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("axis,kinds", [("ep", {True, False}),
                                        ("pp", {False})])
def test_replicated_gradients_agree_over_replicas(port, axis, kinds):
    """A leaf replicated over ep (or pp) leaves the train step's gradient
    with the axis's first rank's value on every rank; a leaf sharded over
    it (the experts, the router) keeps each rank's."""
    ranks = [r[axis] for r in port["replicas"]]
    assert {sharded for sharded, _, _ in ranks[0].values()} == kinds
    for leaf, (sharded, _, _) in ranks[0].items():
        want0 = ranks[0][leaf][1]
        for r, got in enumerate(ranks):
            _, before, after = got[leaf]
            np.testing.assert_array_equal(
                after, before if sharded else want0,
                err_msg=f"{leaf} on rank {r}")
