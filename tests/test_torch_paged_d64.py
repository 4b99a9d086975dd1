"""The paged attention kernel's plain versions at the head size 64 build
of csrc/paged_attention.cu: mini's layout (12 query heads over 4 KV heads,
so n_rep = 3, head_dim 64) with 64-token pages, decode (K = 1: 3 query rows
per KV head, padded to a row block of 4 in the kernel) and verify (K = 4:
12 rows, padded to 16), against the reference Pallas kernel run in
interpret mode. ``paged_attention_split_reference`` is held at the split
the wrapper would launch with on a 132-SM card and at others;
``paged_attention_reference`` (the wrapper's CPU path) too. Tolerance 2e-5
in fp32, the reference tests' own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas.paged_attention import paged_attention as jax_paged
from ray_tpu_torch.ops.paged_attention import (
    KERNEL_HEAD_DIMS,
    stage_layout,
    pages_per_split,
    paged_attention,
    paged_attention_reference,
    paged_attention_split_reference,
    row_block,
)

TOL = dict(atol=2e-5, rtol=2e-5)
H, HKV, DH, P = 12, 4, 64, 64  # mini's heads; the kernel's page size
SMS = 132  # an H100 SXM's SMs

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)


def _case(seed, b, k, maxp, positions, inactive=(), poison=False):
    """Pages shuffled across the pool (page 0 = dump), tables covering
    positions .. positions + k - 1; ``inactive`` slots all -1 at position
    0; ``poison`` sets K and V past each slot's frontier to +-999."""
    rng = np.random.default_rng(seed)
    npages = b * maxp + 1
    q = rng.normal(size=(b, k, H, DH)).astype(np.float32)
    kp = rng.normal(size=(npages, HKV, P, DH)).astype(np.float32)
    vp = rng.normal(size=(npages, HKV, P, DH)).astype(np.float32)
    tables = np.full((b, maxp), -1, np.int32)
    pos = np.asarray(positions, np.int32)
    ids = rng.permutation(npages - 1) + 1
    nxt = 0
    for i in range(b):
        if i in inactive:
            pos[i] = 0
            continue
        need = (int(pos[i]) + k - 1) // P + 1
        tables[i, :need] = ids[nxt: nxt + need]
        nxt += need
        if poison:
            frontier = int(pos[i]) + k
            for pi in range(need):
                lo = max(0, frontier - pi * P)
                kp[tables[i, pi], :, lo:] = 999.0
                vp[tables[i, pi], :, lo:] = -999.0
    return q, kp, vp, tables, pos


def _kernel_split(b, k, maxp):
    """pages_per_split as the wrapper's launch plan computes it."""
    rows = H // HKV * k
    groups = HKV * -(-rows // row_block(rows))
    return pages_per_split(b, groups, maxp, SMS)


def test_head_dim_64_is_built_and_padded():
    assert 64 in KERNEL_HEAD_DIMS and stage_layout(P) == (64 // P, 1)
    assert row_block(H // HKV) == 4  # decode: 3 live rows of 4
    assert row_block(4 * H // HKV) == 16  # verify: 12 live rows of 16


@pytest.mark.parametrize("k,positions,maxp,inactive", [
    # decode at page boundaries and deep in the table
    (1, [0, 63, 64, 127, 300, 511], 8, ()),
    # decode, one slot inactive on the dump page
    (1, [200, 9, 450], 8, (1,)),
    # verify: one to three cells before a page boundary, and long
    (4, [61, 62, 63, 125, 500], 8, ()),
    # verify in a wider table, many pages per slot
    (4, [700, 1000, 1500], 32, ()),
])
@pytest.mark.parametrize("poison", [False, True])
def test_split_matches_reference_kernel(k, positions, maxp, inactive,
                                        poison):
    b = len(positions)
    args = _case(b + k, b, k, maxp, positions, inactive, poison)
    want = np.asarray(jax_paged(*(jnp.asarray(a) for a in args),
                                n_kv_heads=HKV, interpret=True))
    t = [torch.from_numpy(a) for a in args]
    own = _kernel_split(b, k, maxp)
    for pps in sorted({1, 2, 3, own, maxp}):
        split = paged_attention_split_reference(*t, pps).numpy()
        np.testing.assert_allclose(split, want, **TOL, err_msg=f"pps {pps}")
    np.testing.assert_allclose(paged_attention_reference(*t).numpy(), want,
                               **TOL)
    # On CPU tensors the wrapper is the one-block plain version.
    np.testing.assert_allclose(paged_attention(*t).numpy(), want, **TOL)


def test_bf16_split_rounds_like_one_block_within_a_step():
    """bf16 at the head size 64: the split version rounds p against each
    page's running max, the one-block version against the row's max, so
    the two differ, by at most a few bf16 steps of the output."""
    args = _case(5, 4, 1, 8, [100, 200, 300, 400])
    t = [torch.from_numpy(a) for a in args]
    tb = [x.to(torch.bfloat16) if x.is_floating_point() else x for x in t]
    split = paged_attention_split_reference(*tb, 1).float()
    single = paged_attention_reference(*tb).float()
    assert split.shape == (4, 1, H, DH)
    assert not torch.equal(split, single)
    torch.testing.assert_close(split, single, atol=2e-2, rtol=2e-2)
