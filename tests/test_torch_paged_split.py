"""The split schedule of the paged attention kernel (csrc/paged_attention.cu)
in PyTorch, ``paged_attention_split_reference``, against the reference
Pallas kernel run in interpret mode and against the port's one-block plain
version.

Each slot's page walk is cut into runs of ``pages_per_split`` table
entries, each run an online softmax of its own, combined at the end. The
cases: one, two and more pages per split than the table has; splits wholly
past a slot's last page; K=4 with positions one to three cells before a
split boundary (rows of the last live split see no cell of it); an
inactive slot on the dump page; stale cells poisoned past the frontier;
MQA and MHA. Tolerance 2e-5 in fp32, the reference tests' own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas.paged_attention import paged_attention as jax_paged
from ray_tpu_torch.ops.paged_attention import (
    pages_per_split,
    paged_attention_reference,
    paged_attention_split_reference,
    row_block,
)

TOL = dict(atol=2e-5, rtol=2e-5)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)


def _case(seed, b, k, h, hkv, dh, p, maxp, positions, inactive=(),
          poison=False):
    """Pages shuffled across the pool (page 0 = dump), tables covering
    positions .. positions + k - 1; ``inactive`` slots all -1 at position
    0; ``poison`` sets K and V past each slot's frontier to +-999."""
    rng = np.random.default_rng(seed)
    npages = b * maxp + 1
    q = rng.normal(size=(b, k, h, dh)).astype(np.float32)
    kp = rng.normal(size=(npages, hkv, p, dh)).astype(np.float32)
    vp = rng.normal(size=(npages, hkv, p, dh)).astype(np.float32)
    tables = np.full((b, maxp), -1, np.int32)
    pos = np.asarray(positions, np.int32)
    ids = rng.permutation(npages - 1) + 1
    nxt = 0
    for i in range(b):
        if i in inactive:
            pos[i] = 0
            continue
        need = (int(pos[i]) + k - 1) // p + 1
        tables[i, :need] = ids[nxt: nxt + need]
        nxt += need
        if poison:
            frontier = int(pos[i]) + k
            for pi in range(need):
                lo = max(0, frontier - pi * p)
                kp[tables[i, pi], :, lo:] = 999.0
                vp[tables[i, pi], :, lo:] = -999.0
    return q, kp, vp, tables, pos


def _run(args, hkv, pps):
    want = np.asarray(jax_paged(*(jnp.asarray(a) for a in args),
                                n_kv_heads=hkv, interpret=True))
    t = [torch.from_numpy(a) for a in args]
    split = paged_attention_split_reference(*t, pps).numpy()
    single = paged_attention_reference(*t).numpy()
    return split, single, want


@pytest.mark.parametrize(
    "b,k,h,hkv,dh,p,maxp,positions,pps",
    [
        # GQA decode, one page per split; slot 2's splits 1-3 are empty
        (3, 1, 8, 2, 64, 16, 4, [17, 50, 3], 1),
        # two pages per split; slot 0 leaves its second and third empty
        (3, 1, 8, 2, 64, 16, 6, [5, 40, 95], 2),
        # more pages per split than the table has: one block walk
        (2, 1, 8, 2, 64, 16, 4, [20, 63], 8),
        # a split width that does not divide the table
        (2, 1, 8, 2, 64, 16, 7, [70, 111], 3),
        # verify K=4 three, two and one cells before the boundary of a
        # two-page split (32 cells): the last live split holds cells no
        # row but the last ones can see
        (3, 4, 8, 2, 64, 16, 6, [29, 30, 31], 2),
        # the same at one page per split (boundaries every 16 cells)
        (3, 4, 8, 2, 64, 16, 6, [45, 46, 47], 1),
        # MQA, K=2
        (2, 2, 16, 1, 64, 8, 8, [31, 62], 3),
        # MHA, position 0
        (2, 1, 4, 4, 32, 8, 3, [0, 20], 1),
    ],
)
def test_split_matches_reference_kernel(b, k, h, hkv, dh, p, maxp, positions,
                                        pps):
    args = _case(7, b, k, h, hkv, dh, p, maxp, positions)
    split, single, want = _run(args, hkv, pps)
    np.testing.assert_allclose(split, want, **TOL)
    np.testing.assert_allclose(split, single, **TOL)


@pytest.mark.parametrize("pps", [1, 2, 5])
def test_split_inactive_slot(pps):
    args = _case(3, 3, 1, 8, 2, 64, 16, 4, [9, 25, 40], inactive=(1,))
    split, single, want = _run(args, 2, pps)
    np.testing.assert_allclose(split, want, **TOL)
    np.testing.assert_allclose(split, single, **TOL)


@pytest.mark.parametrize("pps", [1, 2])
def test_split_stale_cells_are_masked(pps):
    clean = _case(5, 2, 4, 8, 2, 32, 8, 4, [5, 12])
    poisoned = _case(5, 2, 4, 8, 2, 32, 8, 4, [5, 12], poison=True)
    want = _run(clean, 2, pps)[2]
    split, single, _ = _run(poisoned, 2, pps)
    np.testing.assert_allclose(split, want, **TOL)
    np.testing.assert_allclose(single, want, **TOL)


def test_split_bf16_rounds_p_per_page():
    """In bf16 the split version rounds p against each page's running max,
    the one-block version against the row's max: they agree to bf16
    precision and differ from each other, which the fp32 cases cannot
    show."""
    args = _case(11, 2, 4, 8, 2, 64, 16, 8, [70, 120])
    t = [torch.from_numpy(a) for a in args]
    t[:3] = [x.to(torch.bfloat16) for x in t[:3]]
    split = paged_attention_split_reference(*t, 1).float()
    single = paged_attention_reference(*t).float()
    torch.testing.assert_close(split, single, atol=2e-2, rtol=2e-2)
    assert not torch.equal(split, single)


@pytest.mark.parametrize(
    "batch,groups,max_pages,want",
    [
        (8, 8, 32, 2),    # decode at batch 8, 32/8 heads
        (8, 8, 64, 4),    # the wide-table case of phase 1
        (64, 8, 32, 11),  # decode at batch 64
        (1, 8, 256, 2),   # one long slot
        (4, 8, 256, 8),
        (8, 8, 2, 1),     # never more splits than pages
        (1, 1, 4, 1),     # one split per page at most
    ],
)
def test_pages_per_split_from_static_shapes(batch, groups, max_pages, want):
    pps = pages_per_split(batch, groups, max_pages, sm_count=132)
    assert pps == want
    n_split = -(-max_pages // pps)
    assert 1 <= n_split <= max_pages
    assert n_split * pps >= max_pages > (n_split - 1) * pps


@pytest.mark.parametrize("rows,want", [(1, 4), (4, 4), (5, 8), (8, 8),
                                       (16, 16), (32, 16)])
def test_row_block(rows, want):
    assert row_block(rows) == want
