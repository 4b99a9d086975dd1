"""Sharded training of the port (mesh, logical-axis sharding, the ZeRO-3
gather at use, tp/ep collectives, the sharded train step) against the
reference's sharded programs on conftest's 8 fake CPU devices.

The port side runs in 8 spawned ranks of a gloo process group
(tests/torch_spawn_util.py): one spawn per module, every case in it, one
test per case. This module's top level imports torch, numpy and
ray_tpu_torch only, so the ranks never import JAX; the tests import it.
Also: flash_qkv_ffn8 under tp, a mesh with pp = 2, and MoE under sp.
Tolerances are the reference tests': forward 2e-4 / 1e-4
(tests/test_model.py:121), loss rtol 1e-4, parameters 2e-4, MoE forward
2e-3 and aux loss rtol 1e-4 (tests/test_moe.py:99-103).
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Shard

from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import (
    PRESETS,
    embed_impl,
    forward,
    params_from_jax,
    quantize_int8,
)
from ray_tpu_torch.models.moe import MOE_PRESETS, moe_forward
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import MESH_AXES, make_mesh
from ray_tpu_torch.parallel.sharding import (
    distribute,
    logical_spec,
    shard_pytree,
    tree_map_axes,
    use_mesh,
)
from ray_tpu_torch.train import step as tstep

CFG = PRESETS["tiny"]
MOE = MOE_PRESETS["moe_tiny"]
MESH8 = {"dp": 2, "fsdp": 2, "tp": 2}
MOE_EP = {"ep": 4, "dp": 2}
MOE_TRAIN = {"dp": 2, "fsdp": 2, "ep": 2}
STEPS = 2  # the first update runs at lr 0 (warmup), the second moves
PP_MESH = {"pp": 2, "dp": 2, "tp": 2}
# MoE under sp = 2: moe_tiny's 64-token groups span both sp ranks of a
# 32-token sequence (every rank routes the gathered batch); 8-token groups
# lie in one rank's 16-token block (each rank routes its own).
MOE_SP_MESH = {"sp": 2, "dp": 2, "ep": 2}
MOE_SP = {"moe_sp_groups_span": MOE,
          "moe_sp_groups_local": dataclasses.replace(MOE, group_size=8)}
INT8_GRAD_REL = 1e-2  # tests/test_torch_llama_train.py


def _opt():
    return dict(lr=3e-4, warmup=1, total_steps=10)


def _full(t):
    """A DTensor gathered whole (the port's collectives, no DTensor
    redistribution), as numpy."""
    if not isinstance(t, DTensor):
        return t.detach().numpy()
    x = t.to_local().detach()
    with torch.no_grad():
        for i in reversed(range(len(MESH_AXES))):
            if isinstance(t.placements[i], Shard):
                x = col.gather_from(x, t.device_mesh, MESH_AXES[i],
                                    t.placements[i].dim)
    return x.numpy()


def _flat(tree):
    return {"/".join(p): _full(t) for p, t in tstep._flatten(tree)}


def _train(cfg, params, sizes, tokens):
    mesh = make_mesh(sizes, device_type="cpu")
    opt = tstep.make_optimizer(**_opt())
    params = {k: v for k, v in params.items()}
    for _, t in tstep._flatten(params):
        t.requires_grad_(True)
    axes = tstep.state_logical_axes(cfg, opt)
    state = shard_pytree(tstep.TrainState(0, params, opt.init(params)),
                         mesh, axes)
    step = tstep.jit_train_step(cfg, opt, mesh)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    placed = tree_map_axes(
        lambda ax, t: (not isinstance(t, torch.Tensor)
                       or tuple(t.placements) == logical_spec(ax)),
        axes, state)
    ok = all(b for _, b in tstep._flatten(dict(
        params=placed.params, mu=placed.opt_state.mu,
        nu=placed.opt_state.nu)))
    return dict(metrics=metrics, params=_flat(state.params),
                placements_ok=ok and state.step == STEPS
                and state.opt_state.count == STEPS)


def _grads(cfg, params, sizes, tokens):
    """The loss and the whole gradients of one grad_step on ``sizes``."""
    mesh = make_mesh(sizes, device_type="cpu")
    params = shard_pytree(params, mesh, tstep.state_logical_axes(cfg, None)
                          .params)
    with use_mesh(mesh):
        toks = distribute(torch.from_numpy(tokens), mesh,
                          logical_spec(("batch", None))).to_local()
        metrics, grads = tstep.grad_step(cfg)(params, {"tokens": toks})
    return dict(loss=float(metrics["loss"]), grads=_flat(grads))


@contextlib.contextmanager
def _int8_recorded():
    """Within: (x, q, scale) of every quantization the int8 op of
    "flash_qkv_ffn8" makes (models/llama.py's ``_int8_ckpt_op``, through
    ``quantize_int8``), as the op returned them."""
    calls = []

    def record(x, mesh=None):
        q, scale = quantize_int8(x, mesh)
        calls.append((x.detach(), q, scale))
        return q, scale

    with mock.patch.object(llama, "quantize_int8", record):
        yield calls


def _int8_mismatches(calls, mesh):
    """How many int8 values and scales of ``calls`` (over all ranks)
    differ from the whole rows' quantization: each activation gathered
    over tp, quantized with no mesh, this rank's columns kept."""
    bad = torch.zeros((), dtype=torch.int64)
    for x, q, scale in calls:
        want_q, want_scale = quantize_int8(col.gather_from(x, mesh, "tp", -1))
        bad += ((col.local_chunk(want_q, mesh, "tp", -1) != q).sum()
                + (want_scale != scale).sum())
    torch.distributed.all_reduce(bad)
    return int(bad)


def _worker(rank, world, dense, moe, tokens, moe_tokens, q8_input):
    out = {}
    mesh = make_mesh(MESH8, device_type="cpu")
    with use_mesh(mesh):
        out["embed_impl"] = embed_impl(CFG)
        logits = forward(shard_pytree(dense, mesh,
                                      tstep.state_logical_axes(CFG, None)
                                      .params),
                         distribute(torch.from_numpy(tokens[:, :16]), mesh,
                                    logical_spec(("batch", "act_seq"))), CFG)
    out["forward"] = _full(logits)
    # flash_qkv_ffn8 under tp: a row's int8 scale is its max over all of
    # d_ff, the local max then the max over tp.
    x = col.local_chunk(torch.from_numpy(q8_input), mesh, "tp", -1)
    q, scale = quantize_int8(x, mesh)
    out["q8_tp"] = col.gather_from(q.float() * scale, mesh, "tp", -1).numpy()
    with _int8_recorded() as calls:
        out["ffn8_tp"] = _grads(
            dataclasses.replace(CFG, remat="flash_qkv_ffn8"), dense, MESH8,
            tokens)
    out["ffn8_tp_int8"] = dict(calls=len(calls),
                               bad=_int8_mismatches(calls, mesh))
    out["train"] = _train(CFG, dense, MESH8, tokens)
    out["train_pp"] = _train(CFG, dense, PP_MESH, tokens)
    flash = dataclasses.replace(CFG, attn_impl="flash", remat="flash_qkv")
    out["train_flash"] = _train(flash, dense, MESH8, tokens)
    out["train_dots_tp4"] = _train(dataclasses.replace(CFG, remat="dots"),
                                   dense, {"dp": 2, "tp": 4}, tokens)
    mesh = make_mesh(MOE_EP, device_type="cpu")
    sharded = shard_pytree(moe, mesh, tstep.state_logical_axes(MOE, None)
                           .params)
    for name, toks in moe_tokens.items():
        with use_mesh(mesh):
            lg, aux = moe_forward(sharded, distribute(
                torch.from_numpy(toks), mesh, logical_spec(("batch", None))),
                MOE)
        out[name] = (_full(lg), float(aux))
    out["moe_train"] = _train(MOE, moe, MOE_TRAIN, moe_tokens["moe_train"])
    for name, cfg in MOE_SP.items():
        out[name] = _train(cfg, moe, MOE_SP_MESH, moe_tokens["moe_train"])
    return out if rank == 0 else None


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def ref():
    """The reference's inputs and sharded results, as numpy."""
    import jax

    from ray_tpu.models import forward as ref_forward
    from ray_tpu.models import init_params, param_logical_axes
    from ray_tpu.models.moe import (
        MOE_PRESETS as REF_MOE,
        init_moe_params,
        moe_forward as ref_moe_forward,
        moe_param_logical_axes,
    )
    from ray_tpu.models import PRESETS as REF_PRESETS
    from ray_tpu.models.llama import _int8_ckpt
    from ray_tpu.parallel import make_mesh as ref_make_mesh
    from ray_tpu.parallel.sharding import (
        shard_pytree as ref_shard,
        tree_shardings,
        use_mesh as ref_use_mesh,
    )
    from ray_tpu.train import step as ref_step

    rng = np.random.default_rng(1)
    tokens = rng.integers(0, CFG.vocab_size, (4, 33)).astype(np.int32)
    moe_tokens = {
        "moe_fwd": rng.integers(0, MOE.vocab_size, (2, 32)).astype(np.int32),
        "moe_fwd_local": rng.integers(0, MOE.vocab_size,
                                      (8, 32)).astype(np.int32),
        "moe_train": rng.integers(0, MOE.vocab_size,
                                  (4, 33)).astype(np.int32),
    }
    rcfg, rmoe = REF_PRESETS["tiny"], REF_MOE["moe_tiny"]
    params = init_params(jax.random.key(0), rcfg)
    mparams = init_moe_params(jax.random.key(0), rmoe)
    out = {"tokens": tokens, "moe_tokens": moe_tokens,
           "params": jax.tree.map(np.asarray, params),
           "moe_params": jax.tree.map(np.asarray, mparams)}

    mesh8 = ref_make_mesh(MESH8)
    sp = ref_shard(params, mesh8, param_logical_axes(rcfg))
    st = jax.device_put(tokens[:, :16],
                        tree_shardings(mesh8, ("batch", "act_seq")))
    out["forward"] = np.asarray(
        jax.jit(lambda p, t: ref_forward(p, t, rcfg))(sp, st))

    def train(cfg, sizes, toks):
        mesh = ref_make_mesh(sizes)
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

    out["train"] = train(rcfg, MESH8, tokens)
    out["train_pp"] = train(rcfg, PP_MESH, tokens)
    out["moe_train"] = train(rmoe, MOE_TRAIN, moe_tokens["moe_train"])
    for name, cfg in MOE_SP.items():
        rc = dataclasses.replace(rmoe, group_size=cfg.group_size)
        out[name] = train(rc, MOE_SP_MESH, moe_tokens["moe_train"])

    # flash_qkv_ffn8 under tp: the quantizer on a whole activation, and
    # one sharded loss + gradient on mesh8.
    q8 = np.random.default_rng(2).standard_normal((2, 8, 128)).astype(
        np.float32)
    out["q8_input"] = q8
    out["q8"] = np.asarray(_int8_ckpt(jax.numpy.asarray(q8), "ffn_gate"))
    rffn8 = dataclasses.replace(rcfg, remat="flash_qkv_ffn8")
    batch = {"tokens": jax.device_put(tokens,
                                      tree_shardings(mesh8, ("batch", None)))}
    with ref_use_mesh(mesh8):
        (loss, _), grads = jax.jit(
            jax.value_and_grad(ref_step.loss_fn, has_aux=True),
            static_argnums=(2,))(sp, batch, rffn8)
    out["ffn8_tp"] = dict(loss=float(loss), grads={
        "/".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]})
    mesh = ref_make_mesh(MOE_EP)
    sharded = ref_shard(mparams, mesh, moe_param_logical_axes(rmoe))
    for name in ("moe_fwd", "moe_fwd_local"):
        with ref_use_mesh(mesh):
            lg, aux = jax.jit(lambda p, t: ref_moe_forward(p, t, rmoe))(
                sharded, moe_tokens[name])
        out[name] = (np.asarray(lg), float(aux))
    return out


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    from torch_spawn_util import run_ranks

    dense = params_from_jax(ref["params"], CFG, device="cpu")
    moe = params_from_jax(ref["moe_params"], MOE, device="cpu")
    return run_ranks(_worker, 8, tmp_path_factory.mktemp("rdzv"), dense,
                     moe, ref["tokens"], ref["moe_tokens"],
                     ref["q8_input"])[0]


# ------------------------------------------------------------ tests
def _check_train(got, want):
    for g, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
        if "aux_loss" in w:
            np.testing.assert_allclose(g["aux_loss"], w["aux_loss"],
                                       rtol=1e-4)
    assert got["params"].keys() == want["params"].keys()
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, atol=2e-4, err_msg=k)


def test_sharded_forward_matches_reference(ref, port):
    np.testing.assert_allclose(port["forward"], ref["forward"], atol=2e-4,
                               rtol=1e-4)


def test_embed_auto_is_onehot_under_a_mesh(port):
    assert port["embed_impl"] == "onehot"


def test_ffn8_under_tp_raises(ref, port):
    """remat "flash_qkv_ffn8" under tp no longer raises: each tp rank
    quantizes its columns of the FFN activations with the rows' scales
    over all of d_ff (the local max, then the max over tp), the
    reference's quantizer bit for bit; in the sharded step, every int8
    value and scale the kept op makes (two per layer) equals the whole
    rows' quantization; one sharded loss and gradient on mesh8 against
    the reference's, the loss at 1e-5 and each gradient leaf within 1e-2
    of its norm (int8 rounding flips, tests/test_torch_llama_train.py)."""
    np.testing.assert_array_equal(port["q8_tp"], ref["q8"])
    assert port["ffn8_tp_int8"] == dict(calls=2 * CFG.n_layers, bad=0)
    got, want = port["ffn8_tp"], ref["ffn8_tp"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["grads"].keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        rel = np.linalg.norm(got["grads"][k] - w) / np.linalg.norm(w)
        assert rel <= INT8_GRAD_REL, (k, rel)


def test_pp_train_step_matches_reference(ref, port):
    """A mesh with pp = 2 runs jit_train_step as the reference does: the
    Llama leaves carry "layers", not "stage", so they and the batch are
    replicated over pp."""
    _check_train(port["train_pp"], ref["train_pp"])


def test_sharded_train_step_matches_reference(ref, port):
    _check_train(port["train"], ref["train"])


def test_sharded_state_keeps_its_placements(port):
    """After the steps every parameter and moment is a DTensor placed by
    state_logical_axes, and the step and count advanced."""
    assert port["train"]["placements_ok"]
    assert port["moe_train"]["placements_ok"]


def test_sharded_flash_remat_step_matches_reference(ref, port):
    """attn_impl "flash" (the flash op per shard) under remat "flash_qkv"
    (a selective checkpoint whose replay runs the collectives again)
    against the reference's dense step on the same mesh."""
    _check_train(port["train_flash"], ref["train"])


def test_tp4_replicated_attention_step_matches_reference(ref, port):
    """tp 4 over 2 KV heads: attention replicated over tp, remat "dots";
    the same steps as the reference's on mesh8 (the mesh changes where
    the work runs, not the values)."""
    _check_train(port["train_dots_tp4"], ref["train"])


@pytest.mark.parametrize("name", ["moe_fwd", "moe_fwd_local"],
                         ids=["groups_span_ranks", "groups_local"])
def test_moe_expert_sharded_forward_matches_reference(ref, port, name):
    logits, aux = port[name]
    np.testing.assert_allclose(logits, ref[name][0], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(aux, ref[name][1], rtol=1e-4)


def test_moe_train_step_on_mesh_matches_reference(ref, port):
    _check_train(port["moe_train"], ref["moe_train"])
    assert port["moe_train"]["metrics"][0]["aux_loss"] > 0.0


@pytest.mark.parametrize("name", list(MOE_SP))
def test_moe_train_step_under_sp_matches_reference(ref, port, name):
    """MoE under sp = 2 (dense attention, the sequence gathered): routing
    groups that span the sp ranks (gathered, routed whole on every rank)
    and groups inside one rank's block (routed locally); the aux loss the
    reference's."""
    _check_train(port[name], ref[name])
