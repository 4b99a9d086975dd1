"""The port's int8 codec (ray_tpu_torch/collective/codec.py) against the
JAX package's, bit for bit: the numpy half is a copy, and the torch half
(``quantize_torch`` / ``quantize_blocked_torch`` / ``dequantize_torch``)
must give the int8 data and the fp32 scales of ``quantize_jax`` exactly,
on seeded inputs that include round-half-to-even ties, all-zero blocks,
non-aligned tails and one huge outlier per block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.collective import codec as ref
from ray_tpu_torch.collective import codec


def _cases():
    rng = np.random.default_rng(0)
    worst = rng.uniform(-1e-3, 1e-3, size=(8, 256)).astype(np.float32)
    worst[:, 0] = 1e6
    # Exact ties: a block whose absmax is 127 quantizes x.5 values, which
    # round half to even.
    ties = (np.arange(-256, 256, dtype=np.float32) / 2.0)[:512]
    ties[0] = 127.0
    return {
        "normal": rng.normal(size=(4096,)).astype(np.float32),
        "ragged": rng.normal(size=(333, 7)).astype(np.float32) * 1e4,
        "zeros": np.zeros((512,), np.float32),
        "tiny": rng.uniform(-1e-6, 1e-6, size=(1024,)).astype(np.float32),
        "outlier": worst.reshape(-1),
        "ties": ties,
        "scalar": np.array(3.7, np.float32),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("block", [256, 64])
def test_quantize_torch_is_bit_identical(name, block):
    x = CASES[name]
    q_ref, s_ref = (np.asarray(a) for a in ref.quantize_jax(
        jnp.asarray(x), block))
    q, s = codec.quantize_torch(torch.from_numpy(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), q_ref)
    assert s.numpy().tobytes() == s_ref.tobytes()
    # ... and the numpy half (a copy) gives the same bits.
    qt = codec.quantize(x, block=block)
    np.testing.assert_array_equal(qt.q.reshape(q_ref.shape), q_ref)
    assert qt.scales.tobytes() == s_ref.tobytes()
    d_ref = np.asarray(ref.dequantize_jax(jnp.asarray(q_ref),
                                          jnp.asarray(s_ref)))
    d = codec.dequantize_torch(q, s).numpy()
    assert d.tobytes() == d_ref.tobytes()


def test_quantize_blocked_torch_keeps_leading_axes():
    x = np.random.default_rng(1).normal(size=(3, 4, 5, 256)).astype(
        np.float32)
    q_ref, s_ref = (np.asarray(a) for a in ref.quantize_blocked_jax(
        jnp.asarray(x)))
    q, s = codec.quantize_blocked_torch(torch.from_numpy(x))
    assert q.shape == (3, 4, 5, 256) and s.shape == (3, 4, 5)
    np.testing.assert_array_equal(q.numpy(), q_ref)
    assert s.numpy().tobytes() == s_ref.tobytes()
    d_ref = np.asarray(ref.dequantize_jax(jnp.asarray(q_ref),
                                          jnp.asarray(s_ref)))
    assert codec.dequantize_torch(q, s).numpy().tobytes() == d_ref.tobytes()


def test_bf16_input_quantizes_its_fp32_value():
    x = np.random.default_rng(2).normal(size=(700,)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q_ref, s_ref = (np.asarray(a) for a in ref.quantize_jax(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)))
    q, s = codec.quantize_torch(xb)
    np.testing.assert_array_equal(q.numpy(), q_ref)
    assert s.numpy().tobytes() == s_ref.tobytes()


def test_error_feedback_on_tensors_matches_numpy():
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(1000,)).astype(np.float32) for _ in range(3)]
    ef_ref, ef = ref.ErrorFeedback(block=256), codec.ErrorFeedback(block=256)
    for x in xs:
        want = ef_ref.apply("k", x)
        got = ef.apply("k", torch.from_numpy(x))
        assert isinstance(got, torch.Tensor)
        assert got.numpy().tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        codec.quantization_residual(torch.from_numpy(xs[0]), 256).numpy(),
        ref.quantization_residual(xs[0], 256),
    )


@pytest.mark.parametrize("n", [1, 255, 256, 257, 100_000])
def test_wire_sizes_match(n):
    assert codec.padded_len(n) == ref.padded_len(n)
    assert codec.wire_nbytes_torch(n) == ref.wire_nbytes_jax(n)
    x = np.ones(n, np.float32)
    assert codec.quantize(x).wire_nbytes == ref.quantize(x).wire_nbytes
    with pytest.raises(ValueError, match="unknown compression"):
        codec.check_codec("fp8")
