"""The port's differentiable model forward (forward_with_aux) against the
reference on the tiny preset, fp32 on the CPU: logits, hidden states and
the gradients of the cross-entropy loss in every ported remat mode, with
dense and flash attention (the reference's flash kernel in interpret mode,
the port's plain versions).

Tolerances: values and gradients against the reference 1e-5 (fp32,
summation order only; under tests/conftest.py's 8 fake devices the
reference's embed_impl "auto" takes the one-hot product, whose tok_emb
gradient sums in another order than the port's gather). The port's remat
modes agree with each other to 1e-6: they recompute the same operations.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops.pallas.flash_attention import (
    make_flash_attention as jax_make_flash,
)
from ray_tpu.train import step as jstep
from ray_tpu_torch.models.llama import (
    PRESETS,
    UNPORTED_REMAT_MODES,
    forward_with_aux,
    params_from_jax,
)
from ray_tpu_torch.ops.flash_attention import make_flash_attention
from ray_tpu_torch.train.step import _flatten, grad_step

CFG = PRESETS["tiny"]
JCFG = jllama.PRESETS["tiny"]
TOL = dict(atol=1e-5, rtol=1e-5)
MODES_TOL = dict(atol=1e-6, rtol=1e-6)

# fp32 products in full fp32 wherever these tests run (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
# Tiny shapes: one intra-op thread keeps these tests off the cores that
# the suite's other workers use.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(b, s)
    ).astype(np.int32)


def _attn(impl):
    return (make_flash_attention() if impl == "flash" else None,
            jax_make_flash(None) if impl == "flash" else None)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_forward_with_aux_matches_reference(jparams, tparams, attn_impl):
    tokens = _tokens(0, 2, 32)
    t_attn, j_attn = _attn(attn_impl)
    for hidden in (False, True):
        want, j_aux = jllama.forward_with_aux(
            jparams, jnp.asarray(tokens), JCFG, attn_fn=j_attn,
            return_hidden=hidden,
        )
        got, t_aux = forward_with_aux(
            tparams, torch.from_numpy(tokens), CFG, attn_fn=t_attn,
            return_hidden=hidden,
        )
        assert got.dtype == torch.float32 and float(t_aux) == float(j_aux)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def _port_grads(tparams, cfg, tokens, attn_fn):
    metrics, grads = grad_step(cfg, attn_fn)(
        tparams, {"tokens": torch.from_numpy(tokens)}
    )
    return float(metrics["loss"]), dict(_flatten(grads))


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("remat", ["none", "full", "flash_qkv"])
def test_loss_gradients_match_reference(jparams, tparams, remat, attn_impl):
    """jax.grad of the reference's loss_fn against the port's grad_step,
    leaf by leaf."""
    tokens = _tokens(1, 2, 33)
    t_attn, j_attn = _attn(attn_impl)
    jcfg = dataclasses.replace(JCFG, remat=remat)
    (j_loss, _), j_grads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jparams, {"tokens": jnp.asarray(tokens)}, jcfg, j_attn
    )
    cfg = dataclasses.replace(CFG, remat=remat)
    loss, grads = _port_grads(tparams, cfg, tokens, t_attn)
    np.testing.assert_allclose(loss, float(j_loss), **TOL)
    for path, want in _flatten(jax.tree.map(np.asarray, j_grads)):
        np.testing.assert_allclose(grads[path].numpy(), want, **TOL,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_remat_modes_agree(tparams, attn_impl):
    tokens = _tokens(2, 2, 33)
    t_attn, _ = _attn(attn_impl)
    runs = {
        remat: _port_grads(
            tparams, dataclasses.replace(CFG, remat=remat), tokens, t_attn
        )
        for remat in ("none", "full", "flash_qkv")
    }
    base_loss, base = runs["none"]
    for remat in ("full", "flash_qkv"):
        loss, grads = runs[remat]
        np.testing.assert_allclose(loss, base_loss, **MODES_TOL)
        for path, g in grads.items():
            torch.testing.assert_close(g, base[path], **MODES_TOL,
                                       msg=f"{remat} {'/'.join(path)}")


@pytest.mark.parametrize(
    "remat,forwards", [("none", 2), ("full", 4), ("flash_qkv", 2)]
)
def test_flash_forward_replays(tparams, monkeypatch, remat, forwards):
    """Plain flash forwards run in one forward+backward of the 2-layer
    model: "flash_qkv" never replays it in backward (one per layer), "full"
    replays every layer's; each layer's backward runs once."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_reference, (
        fa.flash_attention_backward_reference
    )

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_reference", count("fwd", fwd))
    monkeypatch.setattr(fa, "flash_attention_backward_reference",
                        count("bwd", bwd))
    cfg = dataclasses.replace(CFG, remat=remat)
    _port_grads(tparams, cfg, _tokens(3, 1, 17), make_flash_attention())
    assert calls == {"fwd": forwards, "bwd": CFG.n_layers}


@pytest.mark.parametrize("remat", UNPORTED_REMAT_MODES)
def test_unported_remat_modes_raise(tparams, remat):
    """The reference's other modes raise instead of acting like "none"."""
    tokens = torch.from_numpy(_tokens(4, 1, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        forward_with_aux(tparams, tokens,
                         dataclasses.replace(CFG, remat=remat))
    with pytest.raises(ValueError, match="unknown remat"):
        forward_with_aux(tparams, tokens,
                         dataclasses.replace(CFG, remat=remat + "_x"))


def test_embed_gather_equals_onehot(tparams):
    """Values and gradients of the two embedding paths (embed_impl "auto"
    is the gather on the port)."""
    tokens = _tokens(5, 2, 17)
    out = {}
    for impl in ("auto", "gather", "onehot"):
        cfg = dataclasses.replace(CFG, embed_impl=impl)
        out[impl] = _port_grads(tparams, cfg, tokens, None)
    for impl in ("auto", "onehot"):
        np.testing.assert_allclose(out[impl][0], out["gather"][0],
                                   **MODES_TOL)
        for path, g in out[impl][1].items():
            torch.testing.assert_close(g, out["gather"][1][path],
                                       **MODES_TOL)
    with pytest.raises(ValueError, match="embed_impl"):
        forward_with_aux(tparams, torch.from_numpy(tokens),
                         dataclasses.replace(CFG, embed_impl="bogus"))
