"""Paged decode/verify attention: the CUDA kernel's wrapper and its plain
PyTorch versions (port of ray_tpu/ops/pallas/paged_attention.py).

Query token k of slot b attends the key cells at positions
<= positions[b] + k of the pages its block table lists (-1 = unused,
read as the dump page 0). Pools are head-major [pages, Hkv, P, Dh], so one
KV head's page tile is contiguous. Scores are scaled inside the kernel
(q is not pre-scaled); the softmax is fp32 with the finite -1e9 mask; the
probabilities are cast to v's dtype before the value product; the output
is in q's dtype. The kernel is ``csrc/paged_attention.cu``: each slot's
page walk is split across blocks of ``pages_per_split`` pages, and the
splits are combined in the same launch (:func:`paged_attention_split_reference`
is its arithmetic in PyTorch). It is built for head sizes 64 and 128 and
64-token pages.

What bounds it on the H100 is bytes: every live K/V page is read once and
takes 2 * n_rep * K flops per element. At ``mini``'s decode (12/4 heads of
64, K = 1: 3 query rows per KV head) that is 3 flops per byte in bf16, at
llama3_8b's (32/8 heads of 128) 4, against ~295 where the tensor cores
would become the limit; so a step's bound is its live pages' bytes over
the HBM rate (``chip_smoke.py`` prints it beside the kernel's time).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch import _build

_MASK = -1e9
_M_INIT = -1e30
KERNEL_HEAD_DIMS = (64, 128)  # the head sizes csrc/paged_attention.cu builds
KERNEL_PAGE_SIZE = 64  # the one page size it builds (16 cells per warp)
# Blocks to aim for if every slot's table were full. Slots fill a part of
# their table (the table is sized for max_seq), so this asks for ~2 live
# blocks per SM at a quarter full; 16 (one page per split at decode batch
# 8) measured no faster at any shape timed (PERF.md).
_BLOCKS_PER_SM = 8


def paged_attention_reference(
    q: torch.Tensor,  # [B, K, H, Dh] (rope applied)
    k_pool: torch.Tensor,  # [num_pages, Hkv, P, Dh]
    v_pool: torch.Tensor,  # [num_pages, Hkv, P, Dh]
    block_tables: torch.Tensor,  # [B, max_pages] int32 (-1 = unused)
    positions: torch.Tensor,  # [B] int32: write position of q[:, 0]
) -> torch.Tensor:
    """The kernel's arithmetic on gathered pages, in one softmax block:
    fp32 scores scaled after the product, -1e9 mask, p = exp(s - max)
    rounded to v's dtype for the PV product, fp32 sum, divide by the
    unrounded row sum (0 where it is 0). Returns [B, K, H, Dh]."""
    b, kq, n_heads, dh = q.shape
    _, hkv, page_size, _ = k_pool.shape
    n_rep = n_heads // hkv
    max_pages = block_tables.shape[1]
    window = max_pages * page_size
    tables = block_tables.clamp(min=0).long()
    # [B, n_pages, Hkv, P, Dh] -> [B, Hkv, window, Dh]
    kk = k_pool[tables].permute(0, 2, 1, 3, 4).reshape(b, hkv, window, dh)
    vv = v_pool[tables].permute(0, 2, 1, 3, 4).reshape(b, hkv, window, dh)
    # q head h = g * n_rep + r: [B, Hkv, n_rep, K, Dh]
    qg = q.permute(0, 2, 1, 3).reshape(b, hkv, n_rep, kq, dh)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg.float(), kk.float()) * dh**-0.5
    q_pos = positions.long()[:, None] + torch.arange(kq, device=q.device)
    key_pos = torch.arange(window, device=q.device)
    hidden = key_pos[None, None, :] > q_pos[:, :, None]  # [B, K, window]
    s = s.masked_fill(hidden[:, None, None], _MASK)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum(
        "bgrqk,bgkd->bgrqd", p.to(v_pool.dtype).float(), vv.float()
    )
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    # [B, Hkv, n_rep, K, Dh] -> [B, K, H, Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, kq, n_heads, dh).to(q.dtype)


def paged_attention_split_reference(
    q: torch.Tensor,  # [B, K, H, Dh]
    k_pool: torch.Tensor,  # [num_pages, Hkv, P, Dh]
    v_pool: torch.Tensor,  # [num_pages, Hkv, P, Dh]
    block_tables: torch.Tensor,  # [B, max_pages] int32 (-1 = unused)
    positions: torch.Tensor,  # [B] int32
    pages_per_split: int,
) -> torch.Tensor:
    """The kernel's arithmetic at its rounding points: each run of
    ``pages_per_split`` table entries is one split, walked page by page
    with an fp32 online softmax (p = exp(s - running max), rounded to v's
    dtype for the PV product; pages past the slot's last live page are
    skipped); the splits are then combined in fp32 as
    sum_s exp(m_s - M) acc_s / sum_s exp(m_s - M) l_s, M = max_s m_s (0
    where the sum is 0). An empty split keeps m = -1e30, l = 0, acc = 0,
    so its weight is exactly 0. For tests and chip_smoke.py; the main
    path never calls it. Returns [B, K, H, Dh]."""
    b, kq, n_heads, dh = q.shape
    _, hkv, page_size, _ = k_pool.shape
    n_rep = n_heads // hkv
    rows = n_rep * kq
    max_pages = block_tables.shape[1]
    dev = q.device
    qg = q.permute(0, 2, 1, 3).reshape(b, hkv, rows, dh).float()
    q_pos = positions.long()[:, None] + torch.arange(rows, device=dev) % kq
    lastp = ((positions.long() + kq - 1) // page_size).clamp(0, max_pages - 1)
    tables = block_tables.clamp(min=0).long()
    cells = torch.arange(page_size, device=dev)
    parts = []
    for first in range(0, max_pages, pages_per_split):
        m = torch.full((b, hkv, rows), _M_INIT, device=dev)
        l = torch.zeros((b, hkv, rows), device=dev)
        acc = torch.zeros((b, hkv, rows, dh), device=dev)
        for ip in range(first, min(first + pages_per_split, max_pages)):
            live = (ip <= lastp)[:, None, None]  # [B, 1, 1]
            kt = k_pool[tables[:, ip]].float()  # [B, Hkv, P, Dh]
            vt = v_pool[tables[:, ip]]
            s = torch.einsum("bgrd,bgcd->bgrc", qg, kt) * dh**-0.5
            hidden = (ip * page_size + cells)[None, None] > q_pos[:, :, None]
            s = s.masked_fill(hidden[:, None], _MASK)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            pv = torch.einsum(
                "bgrc,bgcd->bgrd", p.to(v_pool.dtype).float(), vt.float()
            )
            l = torch.where(live, alpha * l + p.sum(dim=-1), l)
            acc = torch.where(live[..., None], alpha[..., None] * acc + pv,
                              acc)
            m = torch.where(live, m_new, m)
        parts.append((m, l, acc))
    m_s = torch.stack([p[0] for p in parts])  # [S, B, Hkv, R]
    w = torch.exp(m_s - m_s.amax(dim=0))
    den = (w * torch.stack([p[1] for p in parts])).sum(dim=0)
    num = (w[..., None] * torch.stack([p[2] for p in parts])).sum(dim=0)
    out = num / torch.where(den == 0, torch.ones_like(den), den)[..., None]
    # [B, Hkv, n_rep * K, Dh] -> [B, K, H, Dh]
    return (out.reshape(b, hkv, n_rep, kq, dh).permute(0, 3, 1, 2, 4)
            .reshape(b, kq, n_heads, dh).to(q.dtype))


def row_block(rows: int) -> int:
    """Query rows per block of the kernel (n_rep * K rows of one KV head,
    padded): 4, 8 or 16; more rows take several blocks per KV head."""
    return 4 if rows <= 4 else 8 if rows <= 8 else 16


def pages_per_split(batch: int, groups: int, max_pages: int,
                    sm_count: int) -> int:
    """Table entries per split, from static quantities only (never the
    positions, which would cost a host sync): enough splits that a full
    table gives ``_BLOCKS_PER_SM`` blocks per SM over the ``batch x
    groups`` (slot, KV head x row block) pairs, at most one per page."""
    n_split = min(max_pages, -(-_BLOCKS_PER_SM * sm_count // (batch * groups)))
    return -(-max_pages // max(n_split, 1))


@functools.cache
def _launch_plan(device: torch.device, b: int, kq: int, n_heads: int,
                 hkv: int, max_pages: int, dh: int):
    """Row block, pages per split and workspace of one launch shape. The
    workspace holds the splits' fp32 partial O and (m, l) and one int32
    ticket per (slot, KV head x row block), zero between calls (the
    kernel's combining block resets it). Calls on one stream reuse it in
    order; nothing here syncs."""
    rows = n_heads // hkv * kq
    rb = row_block(rows)
    groups = hkv * -(-rows // rb)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    pps = pages_per_split(b, groups, max_pages, sm_count)
    n_part = b * groups * -(-max_pages // pps) * rb
    workspace = (
        torch.empty(n_part * dh, dtype=torch.float32, device=device),
        torch.empty(n_part * 2, dtype=torch.float32, device=device),
        torch.zeros(b * groups, dtype=torch.int32, device=device),
    )
    return rb, pps, workspace


def kernel_split(q: torch.Tensor, k_pool: torch.Tensor,
                 block_tables: torch.Tensor) -> int:
    """The ``pages_per_split`` the wrapper launches with for these CUDA
    inputs (chip_smoke.py holds the kernel to the split plain version at
    it)."""
    b, kq, n_heads, dh = q.shape
    return _launch_plan(q.device, b, kq, n_heads, k_pool.shape[1],
                        block_tables.shape[1], dh)[1]


@functools.cache
def _kernel():
    fn = _build.load("paged_attention").rtt_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p]
    )
    return fn


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Decode/verify attention over the page pool; returns [B, K, H, Dh].

    A CPU tensor takes :func:`paged_attention_reference`; a CUDA tensor
    launches ``csrc/paged_attention.cu`` on the current stream (counted in
    ``paged_attention.launches``) or raises. The launch reads nothing back
    to the host."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, positions
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    b, kq, n_heads, dh = q.shape
    num_pages, hkv, page_size, dh_k = k_pool.shape
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables),
                    ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pool and v_pool must share "
                        "a dtype")
    if v_pool.shape != k_pool.shape or dh_k != dh or n_heads % hkv:
        raise ValueError(
            f"paged_attention: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not match"
        )
    if dh not in KERNEL_HEAD_DIMS or page_size != KERNEL_PAGE_SIZE:
        raise ValueError(
            f"paged_attention: the kernel is built for head_dim in "
            f"{KERNEL_HEAD_DIMS} and {KERNEL_PAGE_SIZE}-token pages, got "
            f"{dh} and {page_size}"
        )
    if (block_tables.dtype != torch.int32 or positions.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or positions.shape != (b,)):
        raise ValueError("paged_attention: block_tables must be int32 "
                         "[B, max_pages] and positions int32 [B]")
    tensors = (q, k_pool, v_pool, block_tables, positions)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention: the pools must be 16-byte "
                         "aligned (each page tile is one bulk copy)")
    code = _build.dtype_code(q.dtype)
    max_pages = block_tables.shape[1]
    rb, pps, (ws_acc, ws_ml, tickets) = _launch_plan(
        q.device, b, kq, n_heads, hkv, max_pages, dh
    )
    out = torch.empty_like(q)
    err = _kernel()(
        code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        ws_acc.data_ptr(), ws_ml.data_ptr(), tickets.data_ptr(),
        b, kq, n_heads, hkv, dh, page_size, max_pages, rb, pps,
        dh**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
