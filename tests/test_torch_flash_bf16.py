"""The bf16 arithmetic contract of the flash kernels, on the CPU: the port's
plain forward (O, LSE) and backward (dq, dk, dv) in bf16 against the
reference's _flash_fwd/_flash_bwd in bf16 (interpret mode).

These plain versions are what chip_smoke.py holds the tensor-core kernels
to, so they fix the rounding points those kernels keep: q pre-scaled and
rounded to bf16, p rounded to bf16 before p . v and p^T . dO, ds rounded to
bf16 before ds . k and ds^T . q, every sum in fp32.

Tolerances, each beside the worst reading of these four cases on the CPU:

- LSE: atol 1e-5. Both sides compute it in fp32 from the same bf16
  pre-scaled q and k (worst 4.8e-7, one fp32 step at |LSE| ~ 6).
- O and dq: atol 1e-3 with rtol 1e-2. The two sides round at the same
  points but sum in other orders, so a rounded value may land one bf16
  step apart (worst 2.0e-3 at |dq| ~ 2.7; the largest excess over
  rtol * |want| is 1.1e-7).
- dk and dv: atol 2e-2 with rtol 2e-2 (worst 3.1e-2 at |dv| ~ 5.3, within
  6.9e-3 of rtol 1e-2 * |want|). They differ the most because the
  reference rounds each query head's dk and dv to bf16 and then sums the
  GQA group, while the port sums the group in fp32 and rounds once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas.flash_attention import _flash_bwd, _flash_fwd
from ray_tpu_torch.ops.flash_attention import (
    flash_attention_backward_reference,
    flash_attention_reference,
)

TOL = {
    "LSE": dict(atol=1e-5, rtol=0.0),
    "O": dict(atol=1e-3, rtol=1e-2),
    "dq": dict(atol=1e-3, rtol=1e-2),
    "dk": dict(atol=2e-2, rtol=2e-2),
    "dv": dict(atol=2e-2, rtol=2e-2),
}

torch.set_num_threads(1)

B, H, HKV, D = 1, 4, 2, 32


def _inputs(seed, s):
    """q, k, v, dO as fp32 numpy arrays holding bf16 values exactly, so
    both frameworks start from the same bf16 inputs."""
    rng = np.random.default_rng(seed)
    shapes = [(B, s, H, D), (B, s, HKV, D), (B, s, HKV, D), (B, s, H, D)]
    return [
        torch.from_numpy(rng.normal(size=sh).astype(np.float32))
        .to(torch.bfloat16).float().numpy()
        for sh in shapes
    ]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("s", [128, 120])  # 120: ragged for 64-row tiles
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_matches_reference(s, causal):
    q, k, v, g = _inputs(7 * s + int(causal), s)
    scale = D**-0.5
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    out_j, res = _flash_fwd(jq, jk, jv, causal, scale, s, s, s, s, True)
    want_grads = _flash_bwd(causal, scale, s, s, s, s, True, res, jg)

    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, g))
    o, lse = flash_attention_reference(tq, tk, tv, causal)
    grads = flash_attention_backward_reference(tq, tk, tv, o, lse, tg,
                                               causal)

    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), _np(out_j), **TOL["O"],
                               err_msg="O")
    np.testing.assert_allclose(lse.numpy(), _np(res[4]), **TOL["LSE"],
                               err_msg="LSE")
    for name, t, j in zip(("dq", "dk", "dv"), grads, want_grads):
        assert t.dtype == torch.bfloat16 and t.shape == tuple(j.shape), name
        np.testing.assert_allclose(t.float().numpy(), _np(j), **TOL[name],
                                   err_msg=name)
