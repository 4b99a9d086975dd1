"""Flash backward of the port (plain version of csrc/flash_bwd.cu) against
the reference's _flash_fwd/_flash_bwd pair in interpret mode, and the
port's differentiable flash_attention against autograd through the plain
dense attention.

Both sides are fp32 on the CPU and differ only in summation order: dq,
dk and dv agree to 1e-5 (measured ~1e-6; the reference's own test allows
5e-3 between flash and dense gradients).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas.flash_attention import _flash_bwd, _flash_fwd
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_forward,
    flash_attention_reference,
    make_flash_attention,
)

TOL = dict(atol=1e-5, rtol=1e-5)

# fp32 products in full fp32 wherever these tests run (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
# Tiny shapes: one intra-op thread keeps these tests off the cores that
# the suite's other workers use.
torch.set_num_threads(1)

B, H, HKV, D = 1, 4, 2, 32


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    shapes = [(B, s, H, D), (B, s, HKV, D), (B, s, HKV, D), (B, s, H, D)]
    return [rng.normal(size=sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("s", [128, 120])  # 120: ragged for 64-row tiles
@pytest.mark.parametrize("causal", [True, False])
def test_backward_plain_matches_reference(s, causal):
    """dq, dk, dv against _flash_bwd fed the residuals of _flash_fwd (one
    block of the whole sequence, interpret mode)."""
    q, k, v, g = _inputs(s + int(causal), s)
    scale = D**-0.5
    static = (causal, scale, s, s, s, s, True)
    _, res = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        *static)
    want = _flash_bwd(causal, scale, s, s, s, s, True, res, jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = flash_attention_reference(tq, tk, tv, causal)
    got = flash_attention_backward_reference(tq, tk, tv, o, lse, tg, causal)
    for name, t, j in zip(("dq", "dk", "dv"), got, want):
        assert t.shape == tuple(j.shape), name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("s", [128, 120])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_plain_matches_reference_head_dim_64(s, causal):
    """As above at head_dim 64, the MoE preset's, with its 2:1 GQA."""
    rng = np.random.default_rng(s + 64 + int(causal))
    q, k, v, g = (rng.normal(size=(B, s, h, 64)).astype(np.float32)
                  for h in (H, HKV, HKV, H))
    scale = 64**-0.5
    static = (causal, scale, s, s, s, s, True)
    _, res = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        *static)
    want = _flash_bwd(causal, scale, s, s, s, s, True, res, jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = flash_attention_reference(tq, tk, tv, causal)
    np.testing.assert_allclose(o.permute(0, 2, 1, 3).reshape(-1, s, 64),
                               np.asarray(res[3]), **TOL)
    got = flash_attention_backward_reference(tq, tk, tv, o, lse, tg, causal)
    for name, t, j in zip(("dq", "dk", "dv"), got, want):
        assert t.shape == tuple(j.shape), name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("s", [128, 120])
def test_autograd_matches_dense_autograd(s):
    """Gradients of sum(O * g) through flash_attention equal those through
    the plain causal attention, including the GQA group sum of dk/dv."""
    arrays = _inputs(s, s)
    grads = []
    for attend in (flash_attention, causal_attention):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
        (attend(q, k, v) * torch.from_numpy(arrays[3])).sum().backward()
        grads.append((q.grad, k.grad, v.grad))
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        torch.testing.assert_close(a, b, **TOL, msg=name)


def test_forward_and_backward_take_plain_versions_on_cpu():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(0, 64))
    before = (flash_attention_forward.launches,
              flash_attention_backward.launches)
    o, lse = flash_attention_forward(q, k, v)
    dq, dk, dv = flash_attention_backward(q, k, v, o, lse, g)
    assert (flash_attention_forward.launches,
            flash_attention_backward.launches) == before
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape


def test_no_grad_forward_saves_nothing_and_runs_once(monkeypatch):
    """The serving path calls flash_attention under no_grad: one forward,
    no graph."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    calls = []
    plain = fa.flash_attention_reference
    monkeypatch.setattr(fa, "flash_attention_reference",
                        lambda *a: calls.append(1) or plain(*a))
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(1, 64)[:3])
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert len(calls) == 1 and out.grad_fn is None


def test_backward_wrapper_rejects_bad_inputs():
    q, k, v, g = (torch.from_numpy(a).to("meta") for a in _inputs(2, 64))
    o = torch.empty_like(q)
    lse = torch.empty((B * H, 1, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_backward(q, k, v, o, lse, g)
    q, g = torch.zeros((B, 64, H, D)), torch.zeros((B, 64, H, D))
    k3 = torch.zeros((B, 64, 3, D))
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention_backward(q, k3, k3, q, lse, g)


def test_make_flash_attention_single_device_only():
    """No mesh, or a mesh of one rank: the flash op itself."""
    class Mesh:
        size = 1

    for mesh in (None, Mesh()):
        fn = make_flash_attention(mesh)
        assert fn is flash_attention
        # models/llama.py takes the "flash_qkv" split on this attribute.
        assert fn.keeps_residuals


def test_make_flash_attention_mesh_returns_per_shard_fn(monkeypatch):
    """A mesh of more than one rank: a per-shard function that takes plain
    tensors as this rank's shards and hands the op contiguous q, k, v (a
    local shard of a head-split view need not be contiguous). Its values
    against the JAX package are in tests/test_torch_parallel_train.py."""
    class Mesh:
        size = 4

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    seen = []

    def op(q, k, v):
        seen.append([t.is_contiguous() for t in (q, k, v)])
        return q

    sharded = make_flash_attention(Mesh())
    assert sharded is not flash_attention and sharded.keeps_residuals
    monkeypatch.setattr(fa, "flash_attention", op)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 16, 4, 16), generator=g)
    kv = torch.randn((2, 16, 4, 16), generator=g)
    k, v = kv[:, :, :2], kv[:, :, 2:]  # head-split views
    assert not k.is_contiguous()
    assert sharded(q, k, v) is q
    assert seen == [[True, True, True]]
