"""The port's MoE model (ray_tpu_torch/models/moe.py) and its training
against the reference (ray_tpu/models/moe.py, ray_tpu/train/step.py) on
the moe_tiny preset, fp32 on the CPU. Parameters come from the
reference's init_moe_params through params_from_jax.

Routing (expert indices, slots, the keep mask) must be identical: it is
a discrete function of fp32 values both sides compute in the same order,
with planted ties resolved lower index first. Tolerances: moe_ffn's
output 1e-5 and its aux loss 1e-6 (fp32, summation order only); model
logits and aux 1e-4 (two layers, as the port's other logits tests);
loss and gradients 1e-5 (test_torch_llama_train.py's TOL); the 3-step
trajectory: loss, aux loss and gradient norm 1e-5 relative, as
test_torch_train_step.py's, and parameters 2e-5 but for at most
TRAJ_NOISY elements, each within 5e-4. Those are elements whose gradient
cancels to fp32 noise (tok_emb[343, 6] here: -3.3e-7 in the reference,
-4.6e-7 in the port, against 0.27 elsewhere in its row); AdamW's step
there is g / (|g| + 1e-8), so the noise moves its size by a few percent
of the rate 1e-2. The dense-ensemble oracle is the reference's own test
(tests/test_moe.py) at its 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu.ops.pallas.flash_attention import (
    make_flash_attention as jax_make_flash,
)
from ray_tpu.train import step as jstep
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.llama import params_from_jax
from ray_tpu_torch.ops.flash_attention import make_flash_attention
from ray_tpu_torch.train import step as tstep

CFG = tmoe.MOE_PRESETS["moe_tiny"]
JCFG = jmoe.MOE_PRESETS["moe_tiny"]
TOL = dict(atol=1e-5, rtol=1e-5)
TRAJ_NOISY = 3

# fp32 products in full fp32 wherever these tests run (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
# Tiny shapes: one intra-op thread keeps these tests off the cores that
# the suite's other workers use.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jparams():
    return jmoe.init_moe_params(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(b, s)
    ).astype(np.int32)


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree["blocks"].items()}


def _jax_routing(x, router, cfg):
    """The reference moe_ffn's routing lines, on its own arrays: (expert
    indices, slots, keep mask, capacity)."""
    n = x.shape[0] * x.shape[1]
    g = min(cfg.group_size, n)
    if n % g:
        g = n
    e, k = cfg.num_experts, cfg.top_k
    capacity = max(1, int(cfg.capacity_factor * g * k / e))
    tokens = x.reshape(n // g, g, -1)
    logits = jnp.einsum("Ggd,de->Gge", tokens,
                        router.astype(cfg.dtype)).astype(jnp.float32)
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    sel = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32)
    flat = sel.reshape(n // g, g * k, e)
    slot = ((jnp.cumsum(flat, axis=1) - flat) * flat).sum(-1)
    slot = slot.reshape(n // g, g, k)
    return (np.asarray(gate_idx), np.asarray(slot),
            np.asarray(slot < capacity), capacity)


# (label, config changes, batch, seq, plant ties)
FFN_CASES = [
    ("ample capacity", dict(capacity_factor=8.0), 2, 32, False),
    ("tight capacity, drops", dict(capacity_factor=0.5), 2, 32, False),
    ("group fallback", dict(group_size=48), 2, 20, False),
    ("planted ties", dict(capacity_factor=0.5), 2, 32, True),
]


@pytest.mark.parametrize("label,changes,b,s,ties", FFN_CASES,
                         ids=[c[0] for c in FFN_CASES])
def test_moe_ffn_matches_reference(jparams, label, changes, b, s, ties):
    """Identical routing, output within 1e-5, aux within 1e-6. The group
    fallback: 40 tokens are not a multiple of the group size 48, so all
    40 form one group. Ties: router columns 1 and 3 equal column 0, so
    three experts share each token's top probability."""
    jcfg = dataclasses.replace(JCFG, **changes)
    cfg = dataclasses.replace(CFG, **changes)
    layer = jax.tree.map(np.asarray, _layer(jparams))
    if ties:
        layer["router"] = layer["router"].copy()
        layer["router"][:, 1] = layer["router"][:, 0]
        layer["router"][:, 3] = layer["router"][:, 0]
    x = np.random.default_rng(3).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(jnp.asarray, layer)
    want, want_aux = jmoe.moe_ffn(jnp.asarray(x), jlayer, jcfg)
    tlayer = {k: torch.tensor(np.asarray(v)) for k, v in layer.items()}
    got, aux = tmoe.moe_ffn(torch.from_numpy(x), tlayer, cfg)

    w_idx, w_slot, w_keep, w_cap = _jax_routing(
        jnp.asarray(x), jlayer["router"], jcfg)
    g = tmoe.group_size(b * s, cfg)
    _, _, idx, slot, cap = tmoe.route(
        torch.from_numpy(x).reshape(b * s // g, g, -1), tlayer["router"], cfg)
    assert cap == w_cap
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    np.testing.assert_array_equal(slot.numpy(), w_slot)
    np.testing.assert_array_equal((slot < cap).numpy(), w_keep)
    if label == "tight capacity, drops" or ties:
        assert not w_keep.all()  # some choices are dropped
    if ties:  # experts 0, 1, 3 tie: 0 then 1 where they lead, else 2, 0
        lead = w_idx[..., 0] == 0
        assert lead.any() and (~lead).any()
        np.testing.assert_array_equal(w_idx[lead], [[0, 1]] * lead.sum())
        np.testing.assert_array_equal(w_idx[~lead],
                                      [[2, 0]] * (~lead).sum())
    if label == "group fallback":
        assert g == b * s and w_idx.shape[:2] == (1, b * s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6,
                               rtol=1e-6)


def _attn(impl):
    return (make_flash_attention() if impl == "flash" else None,
            jax_make_flash(None) if impl == "flash" else None)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_moe_forward_matches_reference(jparams, tparams, attn_impl):
    tokens = _tokens(0, 2, 32)
    t_attn, j_attn = _attn(attn_impl)
    want, want_aux = jmoe.moe_forward(jparams, jnp.asarray(tokens), JCFG,
                                      attn_fn=j_attn)
    got, aux = tmoe.moe_forward(tparams, torch.from_numpy(tokens), CFG,
                                attn_fn=t_attn)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-4,
                               rtol=1e-4)
    assert float(aux) > 0.0


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("remat", ["none", "full", "flash_qkv_ffn8"])
def test_moe_loss_gradients_match_reference(jparams, tparams, remat,
                                            attn_impl):
    """The MoE loss (cross entropy + aux) and every leaf's gradient, the
    router's and the experts' included. Under "flash_qkv_ffn8" the MoE FFN
    stays as it is (only the dense FFN is swapped), as in the
    reference."""
    tokens = _tokens(1, 2, 33)
    t_attn, j_attn = _attn(attn_impl)
    jcfg = dataclasses.replace(JCFG, remat=remat)
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        jstep.loss_fn, has_aux=True
    )(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, j_attn)
    cfg = dataclasses.replace(CFG, remat=remat)
    metrics, grads = tstep.grad_step(cfg, t_attn)(
        tparams, {"tokens": torch.from_numpy(tokens)}
    )
    assert set(metrics) == {"loss", "perplexity", "aux_loss"}
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(j_metrics[key]), **TOL)
    np.testing.assert_allclose(
        float(metrics["loss"] + metrics["aux_loss"]), float(j_loss), **TOL)
    grads = dict(tstep._flatten(grads))
    paths = [p for p, _ in tstep._flatten(jax.tree.map(np.asarray,
                                                       j_grads))]
    assert ("blocks", "router") in paths and len(paths) == len(grads)
    for path, want in tstep._flatten(jax.tree.map(np.asarray, j_grads)):
        np.testing.assert_allclose(grads[path].numpy(), want, **TOL,
                                   err_msg="/".join(path))


def test_moe_leaf_order_is_optax_order(tparams):
    """The optimizer walks the leaves in sorted-key order, as optax
    flattens the reference's dicts: router between mlp_norm and w_down."""
    names = [p[-1] for p, _ in tstep._flatten(tparams) if p[0] == "blocks"]
    assert names == sorted(names)
    assert names.index("mlp_norm") < names.index("router") < names.index(
        "w_down")


def test_moe_train_trajectory_matches_reference():
    """3 steps of the reference's jit_train_step (mesh None) against the
    port's: loss, aux loss and gradient norm per step, parameters after
    the last."""
    steps, lr = 3, 1e-2
    toks = np.random.default_rng(5).integers(
        0, CFG.vocab_size, size=(steps, 2, 17)).astype(np.int32)
    opt = jstep.make_optimizer(lr=lr, warmup=1, total_steps=8)
    state = jstep.init_train_state(jax.random.key(0), JCFG, opt)
    init = jax.tree.map(np.asarray, state.params)
    step = jstep.jit_train_step(JCFG, opt, None)
    want = []
    for t in toks:
        state, m = step(state, {"tokens": jnp.asarray(t)})
        want.append([float(m[k]) for k in ("loss", "aux_loss", "grad_norm")])
    want_params = jax.tree.map(np.asarray, state.params)

    topt = tstep.make_optimizer(lr=lr, warmup=1, total_steps=8)
    params = params_from_jax(init, CFG, "cpu")
    for _, t in tstep._flatten(params):
        t.requires_grad_(True)
    tstate = tstep.TrainState(0, params, topt.init(params))
    tstep_fn = tstep.jit_train_step(CFG, topt)
    got = []
    for t in toks:
        tstate, m = tstep_fn(tstate, {"tokens": torch.from_numpy(t)})
        got.append([float(m[k]) for k in ("loss", "aux_loss", "grad_norm")])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1][0] < got[0][0]
    err = np.concatenate([
        np.abs(p.detach().numpy() - w).ravel()
        for (_, p), (_, w) in zip(tstep._flatten(tstate.params),
                                  tstep._flatten(want_params))
    ])
    assert (err > 2e-5).sum() <= TRAJ_NOISY and err.max() <= 5e-4


def test_moe_ffn_matches_dense_ensemble_when_capacity_ample(tparams):
    """The reference's oracle (tests/test_moe.py): with capacity for
    every token, moe_ffn equals the gate-weighted sum of each chosen
    expert's dense SwiGLU FFN."""
    cfg = dataclasses.replace(CFG, capacity_factor=8.0)
    layer = {k: v[0] for k, v in tparams["blocks"].items()}
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 8, cfg.d_model)).astype(np.float32))
    out, _ = tmoe.moe_ffn(x, layer, cfg)
    tokens = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(tokens @ layer["router"], -1)
    gv, gi = probs.topk(cfg.top_k, -1)
    gv = gv / gv.sum(-1, keepdim=True)
    expect = torch.zeros_like(tokens)
    for t in range(tokens.shape[0]):
        for j in range(cfg.top_k):
            e, h = int(gi[t, j]), tokens[t]
            act = torch.nn.functional.silu(h @ layer["w_gate"][e]) * (
                h @ layer["w_up"][e])
            expect[t] += gv[t, j] * (act @ layer["w_down"][e])
    np.testing.assert_allclose(out.reshape(-1, cfg.d_model).numpy(),
                               expect.numpy(), rtol=2e-3, atol=2e-3)


def test_init_moe_params_shapes_and_law():
    """The reference's leaf names and shapes; fp32 norm scales of zeros;
    matrices truncated at 2 / sqrt(fan_in) with the law's spread."""
    cfg = dataclasses.replace(CFG, n_layers=3)
    params = tmoe.init_moe_params(cfg, 1, device="cpu")
    want = jax.eval_shape(
        lambda: jmoe.init_moe_params(jax.random.key(0),
                                     dataclasses.replace(JCFG, n_layers=3)))
    for (path, t), (_, w) in zip(tstep._flatten(params),
                                 tstep._flatten(want)):
        assert tuple(t.shape) == w.shape, path
    d, f = cfg.d_model, cfg.d_ff
    for name, fan_in in (("router", d), ("w_gate", d), ("w_down", f)):
        t = params["blocks"][name]
        assert t.abs().max() <= 2 * fan_in**-0.5
        # truncated standard normal on [-2, 2]: std 0.8796
        assert abs(float(t.std()) * fan_in**0.5 - 0.8796) < 0.05, name
    assert not params["blocks"]["mlp_norm"].any()
    again = tmoe.init_moe_params(cfg, 1, device="cpu")
    assert torch.equal(again["blocks"]["router"], params["blocks"]["router"])


def test_moe_default_device_never_falls_back_to_cpu():
    opt = tstep.make_optimizer()
    if torch.cuda.is_available():
        state = tstep.init_train_state(CFG, opt)
        assert state.params["blocks"]["router"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tstep.init_train_state(CFG, opt)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmoe.init_moe_params(CFG)
