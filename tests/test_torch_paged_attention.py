"""Paged attention of the port (plain version of csrc/paged_attention.cu)
against the reference Pallas kernel run in interpret mode.

The cases are those of tests/test_paged_attention_kernel.py: GQA, MHA
and MQA decode, speculative verify across a page boundary, an inactive
slot clamped to the dump page, and stale cells past the frontier.
Tolerance 2e-5 in fp32, the reference tests' own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas.paged_attention import paged_attention as jax_paged
from ray_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
)

TOL = dict(atol=2e-5, rtol=2e-5)

# fp32 products in full fp32 wherever these tests run (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
# Tiny shapes: one intra-op thread keeps these tests off the cores that
# the suite's other workers use.
torch.set_num_threads(1)


def _case(seed, b, k, h, hkv, dh, p, maxp, positions):
    rng = np.random.default_rng(seed)
    npages = b * maxp + 1
    q = rng.normal(size=(b, k, h, dh)).astype(np.float32)
    kp = rng.normal(size=(npages, hkv, p, dh)).astype(np.float32)
    vp = rng.normal(size=(npages, hkv, p, dh)).astype(np.float32)
    tables = np.full((b, maxp), -1, np.int32)
    nxt = 1
    for i, pos in enumerate(positions):
        need = (pos + k + p - 1) // p
        tables[i, :need] = np.arange(nxt, nxt + need)
        nxt += need
    return q, kp, vp, tables, np.asarray(positions, np.int32)


def _both(q, kp, vp, tables, pos, hkv):
    want = jax_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), n_kv_heads=hkv,
        interpret=True,
    )
    got = paged_attention_reference(*(torch.from_numpy(a) for a in (
        q, kp, vp, tables, pos)))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize(
    "b,k,h,hkv,dh,p,maxp,positions",
    [
        (3, 1, 8, 2, 64, 16, 4, [17, 50, 3]),  # GQA decode
        (2, 1, 4, 4, 32, 8, 3, [0, 20]),  # MHA, pos 0
        (3, 4, 8, 2, 64, 16, 4, [15, 47, 60]),  # verify K=4 across a page
        (2, 2, 16, 1, 64, 8, 8, [31, 62]),  # 1 kv head (MQA)
    ],
)
def test_plain_matches_reference_kernel(b, k, h, hkv, dh, p, maxp, positions):
    args = _case(7, b, k, h, hkv, dh, p, maxp, positions)
    got, want = _both(*args, hkv=hkv)
    np.testing.assert_allclose(got, want, **TOL)


def test_inactive_slot_matches_reference_kernel():
    q, kp, vp, tables, pos = _case(3, 3, 1, 8, 2, 64, 16, 4, [9, 25, 40])
    tables[1, :] = -1
    pos[1] = 0
    got, want = _both(q, kp, vp, tables, pos, hkv=2)
    np.testing.assert_allclose(got, want, **TOL)


def test_stale_cells_beyond_frontier_are_masked():
    q, kp, vp, tables, pos = _case(5, 2, 1, 4, 2, 32, 8, 4, [5, 12])
    clean, want = _both(q, kp, vp, tables, pos, hkv=2)
    for b in range(2):
        frontier = int(pos[b]) + 1
        for pi, pg in enumerate(tables[b]):
            if pg < 0:
                continue
            lo = max(0, frontier - pi * 8)
            kp[pg, :, lo:] = 999.0
            vp[pg, :, lo:] = -999.0
    poisoned, _ = _both(q, kp, vp, tables, pos, hkv=2)
    np.testing.assert_allclose(poisoned, want, **TOL)
    np.testing.assert_allclose(clean, want, **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _case(
        1, 2, 2, 8, 2, 16, 8, 4, [3, 20])]
    before = paged_attention.launches
    got = paged_attention(*args)
    assert paged_attention.launches == before  # no kernel on the CPU
    torch.testing.assert_close(got, paged_attention_reference(*args),
                               atol=0, rtol=0)


def test_wrapper_raises_off_cpu_and_cuda():
    args = [torch.from_numpy(a).to("meta") for a in _case(
        1, 2, 1, 8, 2, 16, 8, 4, [3, 20])]
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(*args)
