"""Flash forward of the port (plain version of csrc/flash_fwd.cu) against
the reference Pallas kernel in interpret mode, O and LSE.

The cases are those of tests/test_flash_attention.py:21-66 plus the
ragged seq 100. Both sides are fp32 and differ only in summation order:
tolerance 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import flash_attention as jax_flash
from ray_tpu.ops.pallas.flash_attention import _fit_block as jax_fit_block
from ray_tpu.ops.pallas.flash_attention import _flash_impl
from ray_tpu_torch.llm.kv_cache import flash_gate
from ray_tpu_torch.ops.flash_attention import (
    DEFAULT_BLOCK,
    _fit_block,
    flash_attention,
    flash_attention_forward,
    flash_attention_reference,
)

TOL = dict(atol=1e-4, rtol=1e-4)

# fp32 products in full fp32 wherever these tests run (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
# Tiny shapes: one intra-op thread keeps these tests off the cores that
# the suite's other workers use.
torch.set_num_threads(1)

CASES = [  # b, s, h, hkv, d, block, causal
    (2, 128, 4, 4, 64, 64, True),
    (2, 256, 4, 4, 64, 128, True),
    (1, 128, 8, 2, 32, 64, True),  # GQA
    (1, 128, 2, 2, 32, 64, False),  # full attention
    (1, 100, 2, 2, 32, 64, True),  # ragged: fitted block 50
    (1, 128, 4, 2, 64, 64, True),  # head_dim 64 with GQA (moe_bench's)
    (1, 100, 4, 2, 64, 64, False),  # head_dim 64, ragged, full
]


def _qkv(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, s, h, d)).astype(np.float32),
        rng.normal(size=(b, s, hkv, d)).astype(np.float32),
        rng.normal(size=(b, s, hkv, d)).astype(np.float32),
    )


@pytest.mark.parametrize("b,s,h,hkv,d,block,causal", CASES)
def test_plain_matches_reference_impl(b, s, h, hkv, d, block, causal):
    """O and LSE against the reference's _flash_impl, both [B*H, ...]."""
    q, k, v = _qkv(s + h, b, s, h, hkv, d)
    blk = jax_fit_block(block, s)
    out_j, lse_j = _flash_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, d**-0.5,
        blk, blk, True,
    )
    out_t, lse_t = flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal
    )
    out_t = out_t.permute(0, 2, 1, 3).reshape(b * h, s, d)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


@pytest.mark.parametrize("b,s,h,hkv,d,block,causal", CASES)
def test_wrapper_matches_reference_entry_point(b, s, h, hkv, d, block,
                                               causal):
    q, k, v = _qkv(s + d, b, s, h, hkv, d)
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block, block_kv=block, interpret=True,
    )
    got = flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [128, 512, 768, 1000, 1024, 1031, 2048, 6144])
def test_prefill_gate_matches_reference(s):
    """The gate's arithmetic is the reference's (kv_cache.py:83-86)."""
    blk = jax_fit_block(1024, s)
    want = s >= 512 and blk >= 128 and blk % 8 == 0
    assert _fit_block(DEFAULT_BLOCK, s) == blk
    assert flash_gate(s, True) == want
    assert not flash_gate(s, False)


def test_wrapper_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _qkv(0, 1, 64, 4, 2, 16)]
    before = flash_attention_forward.launches
    out, lse = flash_attention_forward(*args)
    assert flash_attention_forward.launches == before
    assert out.shape == (1, 64, 4, 16) and lse.shape == (4, 1, 64)


def test_wrapper_rejects_bad_shapes_and_devices():
    k = torch.zeros((1, 128, 3, 32))
    with pytest.raises(ValueError):
        flash_attention(torch.zeros((1, 128, 4, 32)), k, k)
    q, k, v = (torch.from_numpy(a).to("meta")
               for a in _qkv(0, 1, 64, 4, 2, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, k, v)
