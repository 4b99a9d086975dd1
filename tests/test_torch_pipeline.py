"""Pipeline parallelism of the port (ray_tpu_torch/parallel/pipeline.py)
against the reference's (ray_tpu/parallel/pipeline.py) on conftest's 8
fake CPU devices: the same inputs, made from a numpy seed, through both.

- the reference test's residual-MLP stage, P = 4 stages with dp = 2,
  M in {1, 2, 8}: outputs, and the gradients of ``pipeline_loss_fn`` (every
  parameter and the input) at M = 4, rtol / atol 1e-5
  (tests/test_pipeline.py);
- the three ``ValueError``s;
- the pp x ep x fsdp stage with ``param_specs`` (the reference test's,
  the port's showcase stage): outputs and gradients at 1e-5;
- a 4-layer ``tiny`` Llama cut into 2 stages of 2 blocks (the reference's
  ``_block``, the port's ``apply_blocks``), the embedding before the
  pipeline and the final norm, logits and cross entropy after it: logits
  and every gradient at 1e-4.

The port side runs in 8 spawned ranks of a gloo process group
(tests/torch_spawn_util.py), once per module; this module's top level
imports torch, numpy and ray_tpu_torch only.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.llama import (
    PRESETS,
    apply_blocks,
    embed,
    params_from_jax,
)
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import rope_frequencies
from ray_tpu_torch.parallel import mesh_spec, pipeline_apply, pipeline_loss_fn
from ray_tpu_torch.parallel.mesh import make_mesh
from ray_tpu_torch.parallel.showcase import _stage_fn as composed_stage

P_STAGES, D = 4, 16
MLP_MESH = {"pp": P_STAGES, "dp": 2}
COMPOSED_MESH = {"pp": 2, "ep": 2, "fsdp": 2}
LLAMA_MESH = {"pp": 2, "dp": 4}
MICROBATCHES = (1, 2, 8)
CFG = dataclasses.replace(PRESETS["tiny"], n_layers=4, embed_impl="gather")


def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    return {
        "w": (rng.standard_normal((P_STAGES, D, D)) * 0.3).astype(f),
        "b": (rng.standard_normal((P_STAGES, D)) * 0.1).astype(f),
        "x16": rng.standard_normal((16, D)).astype(f),
        "x8": rng.standard_normal((8, D)).astype(f),
        "tgt8": rng.standard_normal((8, D)).astype(f),
        "experts": (rng.standard_normal((2, 4, 8, 8)) * 0.3).astype(f),
        "dense": (rng.standard_normal((2, 8, 8)) * 0.3).astype(f),
        "xc": rng.standard_normal((8, 8)).astype(f),
        "tokens": rng.integers(0, CFG.vocab_size, (8, 17)).astype(np.int32),
    }


# ------------------------------------------------------------ port side
def _mlp_stage(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _errors(mesh, inp):
    out = {}
    bad = {"w": torch.zeros((8, D, D)), "b": torch.zeros((8, D))}
    cases = {
        "stage": (bad, torch.zeros((8, D)), 4, None),
        "microbatching": ({"w": _t(inp["w"]), "b": _t(inp["b"])},
                          torch.zeros((10, D)), 3, None),
        "specs": ({"w": _t(inp["w"]), "b": _t(inp["b"])},
                  torch.zeros((8, D)), 4,
                  {"w": mesh_spec(None, "pp"), "b": mesh_spec("pp")}),
    }
    for name, (params, x, m, specs) in cases.items():
        try:
            pipeline_apply(params, x, _mlp_stage, mesh=mesh,
                           num_microbatches=m, param_specs=specs)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _llama(mesh, params, tokens):
    params = {k: ({n: _t(v.numpy(), True) for n, v in t.items()}
                  if isinstance(t, dict) else _t(t.numpy(), True))
              for k, t in params.items()}
    tokens = torch.from_numpy(tokens).long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    s = inputs.shape[1]
    cos, sin = rope_frequencies(CFG.head_dim, s, CFG.rope_theta,
                                device="cpu")
    stages = {k: v.reshape(2, -1, *v.shape[1:])
              for k, v in params["blocks"].items()}

    def stage_fn(p, x):
        return apply_blocks(x, p, cos, sin, CFG)[0]

    def loss_head(y, batch):
        h = rms_norm(y, params["final_norm"])
        logits = (h @ params["lm_head"]).float()
        ce = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), batch["targets"].reshape(-1))
        return ce, logits

    x = embed(params, inputs, CFG)
    loss, logits = pipeline_loss_fn(
        stages, {"inputs": x, "targets": targets}, stage_fn, loss_head,
        mesh=mesh, num_microbatches=2)
    leaves = {"tok_emb": params["tok_emb"], "final_norm": params["final_norm"],
              "lm_head": params["lm_head"],
              **{"blocks/" + k: v for k, v in params["blocks"].items()}}
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(loss=loss.item(), logits=logits.detach().numpy(),
                grads={k: g.numpy() for k, g in zip(leaves, grads)})


def _worker(rank, world, inp, llama_params):
    out = {}
    mesh = make_mesh(MLP_MESH, device_type="cpu")
    params = {"w": _t(inp["w"]), "b": _t(inp["b"])}
    for m in MICROBATCHES:
        with torch.no_grad():
            out[f"mlp_m{m}"] = pipeline_apply(
                params, _t(inp["x16"]), _mlp_stage, mesh=mesh,
                num_microbatches=m).numpy()
    params = {"w": _t(inp["w"], True), "b": _t(inp["b"], True)}
    x = _t(inp["x8"], True)
    loss = pipeline_loss_fn(
        params, {"inputs": x, "target": _t(inp["tgt8"])}, _mlp_stage,
        lambda y, batch: torch.mean((y - batch["target"]) ** 2),
        mesh=mesh, num_microbatches=4)
    gw, gb, gx = torch.autograd.grad(loss, (params["w"], params["b"], x))
    out["mlp_grads"] = dict(loss=loss.item(), w=gw.numpy(), b=gb.numpy(),
                            x=gx.numpy())
    out["errors"] = _errors(mesh, inp)

    mesh = make_mesh(COMPOSED_MESH, device_type="cpu")
    params = {"experts": _t(inp["experts"], True),
              "dense": _t(inp["dense"], True)}
    x = _t(inp["xc"], True)
    y = pipeline_apply(params, x, functools.partial(composed_stage,
                                                    mesh=mesh),
                       mesh=mesh, num_microbatches=2,
                       param_specs={"experts": mesh_spec("pp", "ep"),
                                    "dense": mesh_spec("pp", None, "fsdp")})
    ge, gd, gx = torch.autograd.grad(torch.mean(y**2),
                                     (params["experts"], params["dense"], x))
    out["composed"] = dict(out=y.detach().numpy(), experts=ge.numpy(),
                           dense=gd.numpy(), x=gx.numpy())

    mesh = make_mesh(LLAMA_MESH, device_type="cpu")
    out["llama"] = _llama(mesh, llama_params, inp["tokens"])
    return out if rank == 0 else None


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu.models import PRESETS as REF_PRESETS
    from ray_tpu.models import init_params
    from ray_tpu.models.llama import _block, _dense_ffn, _embed
    from ray_tpu.ops.attention import causal_attention
    from ray_tpu.ops.norms import rms_norm as ref_rms_norm
    from ray_tpu.ops.rope import rope_frequencies as ref_rope
    from ray_tpu.parallel import make_mesh as ref_make_mesh
    from ray_tpu.parallel.pipeline import (
        pipeline_apply as ref_apply,
        pipeline_loss_fn as ref_loss_fn,
    )

    inp = _inputs()
    out = {"inputs": inp}

    def mlp_stage(p, x):
        return x + jnp.tanh(x @ p["w"] + p["b"])

    mesh = ref_make_mesh(MLP_MESH)
    params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    for m in MICROBATCHES:
        out[f"mlp_m{m}"] = np.asarray(jax.jit(functools.partial(
            ref_apply, stage_fn=mlp_stage, mesh=mesh, num_microbatches=m))(
            params, jnp.asarray(inp["x16"])))

    def pipe_loss(p, x):
        return ref_loss_fn(
            p, {"inputs": x, "target": inp["tgt8"]}, mlp_stage,
            lambda y, batch: jnp.mean((y - batch["target"]) ** 2),
            mesh=mesh, num_microbatches=4)

    loss, (g, gx) = jax.jit(jax.value_and_grad(pipe_loss, argnums=(0, 1)))(
        params, jnp.asarray(inp["x8"]))
    out["mlp_grads"] = dict(loss=loss.item(), w=np.asarray(g["w"]),
                            b=np.asarray(g["b"]), x=np.asarray(gx))
    errors = {}
    for name, call in {
        "stage": lambda: ref_apply(
            {"w": jnp.zeros((8, D, D)), "b": jnp.zeros((8, D))},
            jnp.zeros((8, D)), mlp_stage, mesh=mesh, num_microbatches=4),
        "microbatching": lambda: ref_apply(
            params, jnp.zeros((10, D)), mlp_stage, mesh=mesh,
            num_microbatches=3),
        "specs": lambda: ref_apply(
            params, jnp.zeros((8, D)), mlp_stage, mesh=mesh,
            num_microbatches=4, param_specs={"w": P(None, "pp"),
                                             "b": P("pp")}),
    }.items():
        with pytest.raises(ValueError) as err:
            call()
        errors[name] = str(err.value)
    out["errors"] = errors

    # The reference test's pp x ep x fsdp stage (tests/test_pipeline.py).
    cmesh = ref_make_mesh(COMPOSED_MESH)

    def cstage(p, x):
        w = jax.lax.all_gather(p["dense"], "fsdp", axis=1, tiled=True)
        x = x + jnp.tanh(x @ w)
        local = p["experts"]
        e_local = local.shape[0]
        ep_idx = jax.lax.axis_index("ep")
        outs = jnp.einsum("md,edh->emh", x, local)
        assigned = (jnp.abs(x[:, 0]) * 100).astype(jnp.int32) % 4
        local_ids = ep_idx * e_local + jnp.arange(e_local)
        mask = assigned[None, :] == local_ids[:, None]
        y = jnp.sum(outs * mask[..., None], axis=0)
        y = jax.lax.psum(y, "ep")
        return x + jnp.tanh(y)

    def composed(p, x):
        return ref_apply(p, x, cstage, mesh=cmesh, num_microbatches=2,
                         param_specs={"experts": P("pp", "ep"),
                                      "dense": P("pp", None, "fsdp")})

    cparams = {"experts": jnp.asarray(inp["experts"]),
               "dense": jnp.asarray(inp["dense"])}
    y = jax.jit(composed)(cparams, jnp.asarray(inp["xc"]))
    g, gx = jax.jit(jax.grad(lambda p, x: jnp.mean(composed(p, x) ** 2),
                             argnums=(0, 1)))(cparams, jnp.asarray(inp["xc"]))
    out["composed"] = dict(out=np.asarray(y), experts=np.asarray(
        g["experts"]), dense=np.asarray(g["dense"]), x=np.asarray(gx))

    # A 4-layer tiny Llama in 2 stages of the reference's _block.
    rcfg = dataclasses.replace(REF_PRESETS["tiny"], n_layers=4,
                               embed_impl="gather")
    lparams = init_params(jax.random.key(0), rcfg)
    out["llama_params"] = jax.tree.map(np.asarray, lparams)
    lmesh = ref_make_mesh(LLAMA_MESH)
    tokens = jnp.asarray(inp["tokens"])
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    cos, sin = ref_rope(rcfg.head_dim, inputs.shape[1], rcfg.rope_theta)

    def lstage(p, x):
        for i in range(p["wq"].shape[0]):
            x, _ = _block(x, jax.tree.map(lambda a: a[i], p), cos, sin, rcfg,
                          causal_attention, _dense_ffn)
        return x

    def lloss(p):
        stages = jax.tree.map(lambda a: a.reshape(2, -1, *a.shape[1:]),
                              p["blocks"])
        x = _embed(p["tok_emb"], inputs, rcfg)
        y = ref_apply(stages, x, lstage, mesh=lmesh, num_microbatches=2)
        logits = (ref_rms_norm(y, p["final_norm"]) @ p["lm_head"]).astype(
            jnp.float32)
        logz = jax.nn.logsumexp(logits, axis=-1)
        tgt = jnp.take_along_axis(logits, targets[..., None], -1)[..., 0]
        return jnp.mean(logz - tgt), logits

    (loss, logits), g = jax.jit(jax.value_and_grad(lloss, has_aux=True))(
        lparams)
    grads = {k: np.asarray(g[k]) for k in ("tok_emb", "final_norm",
                                           "lm_head")}
    grads.update({"blocks/" + k: np.asarray(v)
                  for k, v in g["blocks"].items()})
    out["llama"] = dict(loss=float(loss), logits=np.asarray(logits),
                        grads=grads)
    return out


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    from torch_spawn_util import run_ranks

    params = params_from_jax(ref["llama_params"], CFG, device="cpu")
    return run_ranks(_worker, 8, tmp_path_factory.mktemp("rdzv"),
                     ref["inputs"], params)[0]


# ------------------------------------------------------------ tests
@pytest.mark.parametrize("m", MICROBATCHES)
def test_pipeline_microbatch_counts(ref, port, m):
    np.testing.assert_allclose(port[f"mlp_m{m}"], ref[f"mlp_m{m}"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["loss", "w", "b", "x"])
def test_pipeline_gradients_match_reference(ref, port, name):
    """pipeline_loss_fn's loss and the gradients of every stage parameter
    and of the input (which only stage 0 reads: summed over pp)."""
    np.testing.assert_allclose(port["mlp_grads"][name],
                               ref["mlp_grads"][name], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,match", [("stage", "stage dim"),
                                        ("microbatching", "not divisible"),
                                        ("specs", "LEADING")])
def test_pipeline_rejects_like_reference(ref, port, name, match):
    got, want = port["errors"][name], ref["errors"][name]
    assert got is not None and match in got and match in want
    if name != "specs":  # a spec prints as placements in the port
        assert got == want


@pytest.mark.parametrize("name", ["out", "experts", "dense", "x"])
def test_pipeline_composes_with_ep_and_fsdp(ref, port, name):
    """{pp: 2, ep: 2, fsdp: 2}: GPipe + expert dispatch (combine summed
    over ep) + ZeRO-3 gathering over fsdp, outputs and gradients."""
    np.testing.assert_allclose(port["composed"][name],
                               ref["composed"][name], rtol=1e-5, atol=1e-5)


def test_llama_stages_logits_match_reference(ref, port):
    np.testing.assert_allclose(port["llama"]["loss"], ref["llama"]["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(port["llama"]["logits"],
                               ref["llama"]["logits"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("leaf", [
    "tok_emb", "final_norm", "lm_head", "blocks/attn_norm", "blocks/wq",
    "blocks/wk", "blocks/wv", "blocks/wo", "blocks/mlp_norm",
    "blocks/w_gate", "blocks/w_up", "blocks/w_down"])
def test_llama_stages_grads_match_reference(ref, port, leaf):
    """Every parameter's gradient, the embedding's before the pipeline
    included (it reaches every pp rank only through the input's sum)."""
    np.testing.assert_allclose(port["llama"]["grads"][leaf],
                               ref["llama"]["grads"][leaf], rtol=1e-4,
                               atol=1e-4)
