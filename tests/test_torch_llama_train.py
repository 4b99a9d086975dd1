"""The port's differentiable model forward (forward_with_aux) against the
reference on the tiny preset, fp32 on the CPU: logits, hidden states and
the gradients of the cross-entropy loss in each of the eight remat modes,
with dense and flash attention (the reference's flash kernel in interpret
mode, the port's plain versions); what each mode keeps across its
boundary and how often it replays the flash forward.

Tolerances: values and gradients against the reference 1e-5 (fp32,
summation order only; under tests/conftest.py's 8 fake devices the
reference's embed_impl "auto" takes the one-hot product, whose tok_emb
gradient sums in another order than the port's gather). The port's remat
modes agree with each other to 1e-6: they recompute the same operations.

"flash_qkv_ffn8" quantizes the FFN activations to int8. On identical
inputs the port's int8 values equal the reference's bit for bit
(test_int8_ckpt_matches_reference); end to end, an activation that lies
within fp32 summation-order noise of a rounding boundary may round to the
neighbouring int8 step in one framework and not the other (one such flip
in these tokens moves a gradient leaf by ~2e-3 of its largest entry). So
the mode's loss is held at 1e-5 and each gradient leaf to 1e-2 of its
norm (INT8_GRAD_REL), inside the reference's own bound for the mode
against "full" (tests/test_model.py: loss 2%, gradient norm 5%).
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
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.llama import (
    PRESETS,
    REMAT_MODES,
    forward_with_aux,
    params_from_jax,
)
from ray_tpu_torch.ops.flash_attention import make_flash_attention
from ray_tpu_torch.train.step import _flatten, grad_step

CFG = PRESETS["tiny"]
JCFG = jllama.PRESETS["tiny"]
TOL = dict(atol=1e-5, rtol=1e-5)
MODES_TOL = dict(atol=1e-6, rtol=1e-6)
INT8_GRAD_REL = 1e-2

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
@pytest.mark.parametrize("remat", REMAT_MODES)
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
        got = grads[path].numpy()
        if remat == "flash_qkv_ffn8":  # int8 rounding flips (docstring)
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= INT8_GRAD_REL, ("/".join(path), rel)
        else:
            np.testing.assert_allclose(got, want, **TOL,
                                       err_msg="/".join(path))


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_remat_modes_agree(tparams, attn_impl):
    """Every exact mode recomputes the same operations as "none" (the
    int8 mode quantizes its FFN activations and is held to the reference
    by test_loss_gradients_match_reference instead)."""
    tokens = _tokens(2, 2, 33)
    t_attn, _ = _attn(attn_impl)
    exact = [m for m in REMAT_MODES if m != "flash_qkv_ffn8"]
    runs = {
        remat: _port_grads(
            tparams, dataclasses.replace(CFG, remat=remat), tokens, t_attn
        )
        for remat in exact
    }
    base_loss, base = runs["none"]
    for remat in exact[1:]:
        loss, grads = runs[remat]
        np.testing.assert_allclose(loss, base_loss, **MODES_TOL)
        for path, g in grads.items():
            torch.testing.assert_close(g, base[path], **MODES_TOL,
                                       msg=f"{remat} {'/'.join(path)}")


# Flash forwards per layer in one forward + backward: the modes that keep
# the flash op's outputs never replay it.
F1_PER_LAYER = {"none": 1, "full": 2, "attn": 2, "flash": 1, "dots": 2,
                "flash_qkv": 1, "flash_qkv_ffn": 1, "flash_qkv_ffn8": 1}


@pytest.mark.parametrize(
    "remat,forwards",
    [(m, F1_PER_LAYER[m] * CFG.n_layers) for m in REMAT_MODES],
)
def test_flash_forward_replays(tparams, monkeypatch, remat, forwards):
    """Plain flash forwards run in one forward+backward of the 2-layer
    model: the modes that keep the flash outputs never replay it in
    backward (one per layer), the others replay every layer's; each
    layer's backward runs once."""
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


def test_unknown_remat_raises(tparams):
    tokens = torch.from_numpy(_tokens(4, 1, 8))
    with pytest.raises(ValueError, match="unknown remat"):
        forward_with_aux(tparams, tokens,
                         dataclasses.replace(CFG, remat="flash_x"))


@pytest.mark.parametrize("shape", [(2, 7, 16), (3, 32)])
def test_int8_ckpt_matches_reference(shape):
    """The int8 round trip equals the reference's bit for bit in fp32
    (so do the int8 values: q = dequantized / scale), with a row of ties
    at .5 steps (round half to even) and a zero row; the cotangent passes
    straight through."""
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    x[..., 0, :] = 0.0
    x[..., -1, :4] = [127.0, 0.5, 1.5, -2.5]  # scale 1 + 1e-12: .5 ties
    want = jllama._int8_ckpt(jnp.asarray(x), "ffn_gate")
    xt = torch.from_numpy(x).requires_grad_()
    got = tllama._int8_ckpt(xt, "ffn_gate")
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    q, scale = tllama.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(
        q.numpy(), np.round(np.asarray(want) / scale.numpy()))
    g = torch.from_numpy(
        np.random.default_rng(8).normal(size=shape).astype(np.float32))
    got.backward(g)
    torch.testing.assert_close(xt.grad, g, rtol=0, atol=0)


def test_int8_ckpt_product_gradients(tparams):
    """_int8_ckpt of a product x @ w: the straight-through gradients are
    the product's, as the reference's _int8_ckpt(x @ w) gives them."""
    rng = np.random.default_rng(9)
    x, w = rng.normal(size=(2, 5, 8)), rng.normal(size=(8, 6))
    g = rng.normal(size=(2, 5, 6))

    def jloss(x, w):
        return (jllama._int8_ckpt(x @ w, "ffn_up") * g).sum()

    j_dx, j_dw = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32))
    xt, wt = (torch.tensor(a, dtype=torch.float32, requires_grad=True)
              for a in (x, w))
    (tllama._int8_ckpt(xt, "ffn_up", wt) * torch.from_numpy(g)).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(j_dw), **TOL)


def _kept(tparams, cfg, tokens, monkeypatch):
    """What one forward of the port keeps for its backward: the tensors
    the layers' selective-checkpoint policies hold (their caches), and
    those autograd saves outside any checkpoint region."""
    caches = []
    make = tllama.create_selective_checkpoint_contexts

    def recording(policy):
        contexts = make(policy)
        caches.append(contexts[0].storage)
        return contexts

    monkeypatch.setattr(tllama, "create_selective_checkpoint_contexts",
                        recording)
    outside = []
    with torch.autograd.graph.saved_tensors_hooks(
        lambda t: outside.append(t) or t, lambda t: t
    ):
        logits, _ = forward_with_aux(tparams, tokens, cfg,
                                     attn_fn=make_flash_attention())
    held = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            held.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif hasattr(node, "val"):
            walk(node.val)

    for storage in caches:
        walk(storage)
    return held, outside


@pytest.mark.parametrize("remat", ["flash_qkv_ffn", "flash_qkv_ffn8"])
def test_ffn_residuals_are_kept_as_stored(tparams, monkeypatch, remat):
    """Under "flash_qkv_ffn8" the FFN's gate-pre and up activations are
    kept as int8 [B, S, d_ff] with an fp32 [B, S, 1] scale, one pair per
    layer, and no floating tensor of that shape is kept; under
    "flash_qkv_ffn" they are kept in cfg.dtype. Each layer also keeps its
    flash O and LSE and its q/k/v products."""
    b, s = 2, 16
    cfg = dataclasses.replace(CFG, remat=remat)
    held, outside = _kept(tparams, cfg,
                          torch.from_numpy(_tokens(6, b, s)), monkeypatch)
    ffn_shape = (b, s, CFG.d_ff)
    kept = [t for t in held + outside if t.shape[-1] == CFG.d_ff]
    n = 2 * CFG.n_layers  # gate and up per layer
    if remat == "flash_qkv_ffn8":
        assert [t.dtype for t in kept] == [torch.int8] * n
        assert all(t.shape == ffn_shape for t in kept)
        scales = [t for t in held if t.shape == (b, s, 1)]
        assert [t.dtype for t in scales] == [torch.float32] * n
    else:
        assert [t.dtype for t in kept] == [CFG.dtype] * n
        assert all(t.shape == (b * s, CFG.d_ff) for t in kept)
    lse = [t for t in held if t.shape == (b * CFG.n_heads, 1, s)]
    assert len(lse) == CFG.n_layers
    assert sum(t.shape[-1] == CFG.d_model for t in held) >= CFG.n_layers


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
