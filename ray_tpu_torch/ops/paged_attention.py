"""Paged decode/verify attention: the CUDA kernel's wrapper and its plain
PyTorch version (port of ray_tpu/ops/pallas/paged_attention.py).

Query token k of slot b attends the key cells at positions
<= positions[b] + k of the pages its block table lists (-1 = unused,
read as the dump page 0). Pools are head-major [pages, Hkv, P, Dh], so one
KV head's page tile is contiguous. Scores are scaled inside the kernel
(q is not pre-scaled); the softmax is fp32 with the finite -1e9 mask; the
probabilities are cast to v's dtype before the value product; the output
is in q's dtype. The kernel is ``csrc/paged_attention.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch import _build

_MASK = -1e9
KERNEL_HEAD_DIM = 128  # the one head size csrc/paged_attention.cu builds


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


@functools.cache
def _kernel():
    fn = _build.load("paged_attention").rtt_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 7
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
    ``paged_attention.launches``) or raises."""
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
    if dh != KERNEL_HEAD_DIM:
        raise ValueError(f"paged_attention: the kernel is built for head_dim "
                         f"{KERNEL_HEAD_DIM}, got {dh}")
    if (block_tables.dtype != torch.int32 or positions.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or positions.shape != (b,)):
        raise ValueError("paged_attention: block_tables must be int32 "
                         "[B, max_pages] and positions int32 [B]")
    tensors = (q, k_pool, v_pool, block_tables, positions)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    code = _build.dtype_code(q.dtype)
    out = torch.empty_like(q)
    err = _kernel()(
        code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        b, kq, n_heads, hkv, dh, page_size, block_tables.shape[1],
        dh**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
