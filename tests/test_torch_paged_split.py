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
    stage_cells,
    stage_layout,
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


@pytest.mark.parametrize(
    "k,dh,p,positions",
    [
        # decode over pages of 8, 16 and 32 tokens: a kernel stage holds
        # 64 / P pages, the last one cut short at each slot's frontier
        (1, 64, 8, [0, 7, 63, 64, 201]),
        (1, 128, 16, [15, 16, 100, 255, 2]),
        (1, 64, 32, [31, 32, 190, 63, 0]),
        # verify K=4 across page and stage boundaries
        (4, 128, 8, [60, 61, 62, 125, 5]),
        (4, 64, 16, [61, 62, 126, 13, 200]),
        (4, 128, 32, [29, 62, 127, 0, 180]),
    ],
)
@pytest.mark.parametrize("wide", [False, True])
def test_split_small_pages_match_reference_kernel(k, dh, p, positions, wide):
    """Pages under 64 tokens at the split the wrapper launches with on a
    132-SM card (whole stages of 64 cells), and at a split of two stages
    (``wide``), stale cells poisoned past each frontier."""
    b, h, hkv = len(positions), 8, 2
    maxp = 256 // p
    args = _case(13, b, k, h, hkv, dh, p, maxp, positions, poison=True)
    rows = h // hkv * k
    groups = hkv * -(-rows // row_block(rows))
    step = 64 // p
    pps = (2 * step if wide
           else pages_per_split(b, groups, maxp, sm_count=132, page_size=p))
    assert pps % step == 0
    clean = _case(13, b, k, h, hkv, dh, p, maxp, positions)
    want = _run(clean, hkv, pps)[2]
    split, single, _ = _run(args, hkv, pps)
    np.testing.assert_allclose(split, want, **TOL)
    np.testing.assert_allclose(single, want, **TOL)


@pytest.mark.parametrize(
    "batch,groups,max_pages,page_size,want",
    [
        (8, 8, 256, 8, 16),    # 2048 tokens of 8: two stages per split
        (8, 8, 128, 16, 8),    # two stages of 4 pages
        (8, 8, 64, 32, 4),
        (64, 8, 128, 16, 44),  # 43 pages rounded up to whole stages
        (1, 1, 3, 16, 4),      # one stage, past the table's end
    ],
)
def test_pages_per_split_counts_whole_stages(batch, groups, max_pages,
                                             page_size, want):
    pps = pages_per_split(batch, groups, max_pages, sm_count=132,
                          page_size=page_size)
    assert pps == want and pps % (64 // page_size) == 0


@pytest.mark.parametrize("rows,want", [(1, 4), (4, 4), (5, 8), (8, 8),
                                       (16, 16), (32, 16)])
def test_row_block(rows, want):
    assert row_block(rows) == want


@pytest.mark.parametrize(
    "page,want",
    [(1, (64, 1)), (4, (16, 1)), (12, (5, 1)), (48, (1, 1)), (64, (1, 1)),
     (65, (1, 2)), (128, (1, 2)), (200, (1, 4))],
)
def test_stage_layout(page, want):
    """Whole pages per stage up to 64 tokens (P = 12: five pages, 60
    cells), 64-cell parts of one page above."""
    assert stage_layout(page) == want
    cells = stage_cells(page)
    assert cells[0][0] == 0 and cells[-1][1] == page
    assert all(0 < c1 - c0 <= 64 for c0, c1 in cells)


@pytest.mark.parametrize(
    "k,dh,p,positions",
    [
        # 16 four-token pages per stage; frontiers on page and stage edges
        (1, 64, 4, [0, 3, 63, 64, 201]),
        (4, 128, 4, [60, 61, 62, 125, 5]),
        # five 12-token pages per stage: every stage is 60 of 64 cells
        (1, 128, 12, [11, 59, 60, 119, 230]),
        (4, 64, 12, [56, 57, 58, 179, 0]),
        # one 48-token page per stage: 48 of 64 cells
        (1, 64, 48, [47, 48, 95, 0, 250]),
        (4, 128, 48, [44, 45, 46, 143, 200]),
        # a 128-token page spans two stages of 64 cells
        (1, 128, 128, [63, 64, 127, 128, 250]),
        (4, 64, 128, [60, 61, 62, 125, 190]),
    ],
)
@pytest.mark.parametrize("wide", [False, True])
def test_split_any_page_size_matches_reference_kernel(k, dh, p, positions,
                                                      wide):
    """Page sizes that are not 8-64 or not powers of two, at the split the
    wrapper launches with on a 132-SM card and at two stages' pages
    (``wide``), stale cells poisoned past each frontier; the split plain
    version steps through the kernel's stages (stage_layout)."""
    b, h, hkv = len(positions), 8, 2
    maxp = -(-256 // p)
    rows = h // hkv * k
    groups = hkv * -(-rows // row_block(rows))
    step = stage_layout(p)[0]
    pps = (2 * step if wide
           else pages_per_split(b, groups, maxp, sm_count=132, page_size=p))
    assert pps % step == 0
    clean = _case(17, b, k, h, hkv, dh, p, maxp, positions)
    want = _run(clean, hkv, pps)[2]
    split, single, _ = _run(
        _case(17, b, k, h, hkv, dh, p, maxp, positions, poison=True), hkv,
        pps)
    np.testing.assert_allclose(split, want, **TOL)
    np.testing.assert_allclose(single, want, **TOL)
