"""The port's train step (ray_tpu_torch/train/step.py) against the
reference's (ray_tpu/train/step.py) on the tiny preset, fp32 on the CPU:
the learning-rate schedule, the chunked cross-entropy, and a 4-step
trajectory through the hand-written AdamW against the optax chain.

Tolerances. Schedule: 1e-6 of the peak rate (the same fp32 operations).
Cross-entropy: 1e-5 (fp32 summation order). Trajectory: loss and grad norm
per step to 1e-5 relative; parameters after 4 steps to 2e-5 with an fp32
first moment (measured 1.6e-6) and 5e-4 with a bf16 one (measured 1e-4:
gradients that differ in the 7th digit now and then round mu to the
neighbouring bf16 value, 2^-8 of an update). Both are far below one step's
update (the rate is 1e-2), and the tests check that an optimizer without
updates, without weight decay or without the clip misses them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.train import step as jstep
from ray_tpu_torch.models.llama import PRESETS, params_from_jax
from ray_tpu_torch.train import step as tstep

CFG = PRESETS["tiny"]
JCFG = jllama.PRESETS["tiny"]
LR, WARMUP, TOTAL, STEPS = 1e-2, 2, 8, 4

# fp32 products in full fp32 wherever these tests run (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
# Tiny shapes: one intra-op thread keeps these tests off the cores that
# the suite's other workers use.
torch.set_num_threads(1)


@pytest.mark.parametrize("warmup,total", [(2, 8), (100, 10000), (0, 10),
                                          (3, 3)])
def test_schedule_matches_optax(warmup, total):
    lr = 3e-4
    want = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(total, warmup + 1), lr * 0.1
    )
    opt = tstep.make_optimizer(lr=lr, warmup=warmup, total_steps=total)
    for count in (0, 1, 2, 3, 5, 50, 99, 100, 101, 5000, 9999, 10000, 20000):
        assert abs(opt.schedule(count) - float(want(count))) <= 1e-6 * lr
    if warmup:
        assert opt.schedule(0) == 0.0  # the first update runs at lr 0


@pytest.mark.parametrize("s,chunk", [(256, 128), (384, 256), (24, 16)])
def test_chunked_cross_entropy_matches_reference(s, chunk):
    """Chunk 128 divides 256; 256 does not divide 384 (its largest divisor
    192 is taken); 16 does not divide 24 and the divisor 12 is under 128,
    so the whole sequence is one chunk. Loss and both gradients."""
    rng = np.random.default_rng(s)
    hidden = rng.normal(size=(2, s, 16)).astype(np.float32)
    head = rng.normal(size=(16, 64)).astype(np.float32)
    targets = rng.integers(0, 64, size=(2, s)).astype(np.int32)

    def jloss(h, w):
        return jstep.chunked_cross_entropy(h, w, jnp.asarray(targets),
                                           jnp.float32, chunk=chunk)

    j_loss, (j_dh, j_dw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head)
    )
    h, w = (torch.from_numpy(a).requires_grad_() for a in (hidden, head))
    loss = tstep.chunked_cross_entropy(h, w, torch.from_numpy(targets),
                                       torch.float32, chunk=chunk)
    loss.backward()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **tol)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(j_dh), **tol)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(j_dw), **tol)


def _tokens():
    return np.random.default_rng(1).integers(
        0, CFG.vocab_size, size=(STEPS, 2, 17)
    ).astype(np.int32)


@functools.cache
def _reference_run(bf16_mu: bool, clip: float):
    """(initial params, per-step (loss, grad_norm), final params) of the
    reference's jitted make_train_step, as numpy."""
    opt = jstep.make_optimizer(
        lr=LR, warmup=WARMUP, total_steps=TOTAL, grad_clip=clip,
        mu_dtype=jnp.bfloat16 if bf16_mu else None,
    )
    state = jstep.init_train_state(jax.random.key(0), JCFG, opt)
    init = jax.tree.map(np.asarray, state.params)
    step = jax.jit(jstep.make_train_step(JCFG, opt))
    metrics = []
    for toks in _tokens():
        state, m = step(state, {"tokens": jnp.asarray(toks)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return init, metrics, jax.tree.map(np.asarray, state.params)


def _port_run(init, bf16_mu, clip, lr=LR, weight_decay=0.1):
    opt = tstep.make_optimizer(
        lr=lr, warmup=WARMUP, total_steps=TOTAL, weight_decay=weight_decay,
        grad_clip=clip, mu_dtype=torch.bfloat16 if bf16_mu else None,
    )
    params = params_from_jax(init, CFG, "cpu")
    for _, t in tstep._flatten(params):
        t.requires_grad_(True)
    state = tstep.TrainState(0, params, opt.init(params))
    step = tstep.jit_train_step(CFG, opt)
    metrics = []
    for toks in _tokens():
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    assert state.step == STEPS and state.opt_state.count == STEPS
    return metrics, state.params


def _max_param_err(params, want):
    return max(
        float(np.abs(t.detach().numpy() - w).max())
        for (_, t), (_, w) in zip(tstep._flatten(params),
                                  tstep._flatten(want))
    )


@pytest.mark.parametrize("bf16_mu", [False, True])
@pytest.mark.parametrize("clip", [10.0, 1.0])  # the norm is ~5: 1.0 clips
def test_train_trajectory_matches_reference(bf16_mu, clip):
    init, j_metrics, j_params = _reference_run(bf16_mu, clip)
    metrics, params = _port_run(init, bf16_mu, clip)
    np.testing.assert_allclose(metrics, j_metrics, rtol=1e-5)
    assert any(norm >= clip for _, norm in j_metrics) == (clip == 1.0)
    atol = 5e-4 if bf16_mu else 2e-5
    assert _max_param_err(params, j_params) <= atol
    if clip == 1.0:
        # The tolerance is tight enough to tell a wrong optimizer apart.
        for wrong in (dict(lr=0.0), dict(weight_decay=0.0),
                      dict(clip=1e9)):
            _, p = _port_run(init, bf16_mu, **{"clip": clip, **wrong})
            assert _max_param_err(p, j_params) > 10 * atol, wrong


def test_optimizer_state_dtypes():
    params = {"w": torch.zeros((3, 4), requires_grad=True)}
    state = tstep.make_optimizer(mu_dtype=torch.bfloat16).init(params)
    assert state.count == 0
    assert state.mu["w"].dtype == torch.bfloat16
    assert state.nu["w"].dtype == torch.float32
    assert not state.mu["w"].requires_grad


def test_grad_step_leaves_params_untouched():
    """grad_step differentiates leaves that do not require grad without
    changing them."""
    params = params_from_jax(
        jax.tree.map(np.asarray, _reference_run(False, 10.0)[0]), CFG, "cpu"
    )
    metrics, grads = tstep.grad_step(CFG)(
        params, {"tokens": torch.from_numpy(_tokens()[0])}
    )
    assert set(metrics) == {"loss", "perplexity"}
    for (path, p), (_, g) in zip(tstep._flatten(params),
                                 tstep._flatten(grads)):
        assert not p.requires_grad and p.grad is None
        assert g.shape == p.shape, path


def test_jit_train_step_rejects_what_is_not_ported():
    """An unknown attn_impl raises. Ring and Ulysses are ported: without a
    mesh (sp = 1) each is plain causal attention, and a step through
    either gives the dense step's loss (meshes of more than one rank:
    tests/test_torch_parallel_train.py and
    tests/test_torch_sequence_parallel.py)."""
    opt = tstep.make_optimizer(warmup=1, total_steps=10)
    with pytest.raises(ValueError, match="attn_impl"):
        tstep.jit_train_step(dataclasses.replace(CFG, attn_impl="x"), opt)
    batch = {"tokens": torch.from_numpy(_tokens()[0])}
    losses = {}
    for impl in ("dense", "ring", "ulysses"):
        cfg = dataclasses.replace(CFG, attn_impl=impl)
        state = tstep.init_train_state(cfg, opt, device="cpu")
        _, metrics = tstep.jit_train_step(cfg, opt)(state, batch)
        losses[impl] = float(metrics["loss"])
    assert losses["ring"] == pytest.approx(losses["dense"], rel=1e-6)
    assert losses["ulysses"] == pytest.approx(losses["dense"], rel=1e-6)


def test_default_device_never_falls_back_to_cpu():
    opt = tstep.make_optimizer()
    if torch.cuda.is_available():
        state = tstep.init_train_state(CFG, opt)
        assert state.params["lm_head"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tstep.init_train_state(CFG, opt)
