"""Paged KV cache: block-table attention over a fixed page pool (port of
ray_tpu/llm/paged_kv.py).

- One page pool per layer, [L, num_pages, Hkv, page_size, Dh], head-major
  so one KV head's page tile is contiguous for the decode kernel.
- A block table per request lists its pages; tables live on the host and
  ship as [B, max_pages] int32 each step (-1 = unused).
- Physical page 0 is the dump page: inactive slots and writes past the
  table window land there, and nobody attends it.
- Prefix sharing: full pages whose token-prefix hash matches a live page
  are refcounted and reused.

The pool is updated IN PLACE (``index_put_``), where the reference
donates it to a jitted program; the functions return the same pool
object for the reference's call shape. Within each layer the new K/V are
scattered BEFORE attention reads the pool, so rejected draft cells need
no rollback: the next step rewrites them before any query can see them.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.llm.kv_cache import _mlp
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    attn_out,
    embed,
    kv_heads_per_rank,
    layer_params,
    lm_logits,
    project_qkv,
)
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.paged_attention import paged_attention
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

_NEG_INF = -2.0e38
# The pool's live claim in the device-memory ledger (runtime/memory.py),
# kept so a re-created pool retires the previous claim.
_KV_REG = None

PagedKV = dict[str, torch.Tensor]  # {"k","v": [L, num_pages, Hkv, P, Dh]}


def init_paged_kv(
    cfg: LlamaConfig,
    num_pages: int,
    page_size: int = 64,
    device: str | torch.device = "cuda",
    mesh=None,
) -> PagedKV:
    """Zero pools [L, num_pages, Hkv, P, Dh]. Under a mesh whose tp divides
    the KV heads each rank allocates only its heads' pool (never the whole
    pool first); otherwise every rank holds all of them (the reference's
    condition, :func:`~ray_tpu_torch.models.llama.kv_heads_per_rank`)."""
    shape = (cfg.n_layers, num_pages, kv_heads_per_rank(cfg, mesh),
             page_size, cfg.head_dim)
    dev = resolve_device(device)
    kv = {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }
    # Claim the pool in the device-memory ledger: the KV pages are
    # serving's big fixed tenant of device memory.
    from ray_tpu_torch.runtime import memory as _rmem

    global _KV_REG
    if _KV_REG is not None:
        _KV_REG.close()
    _KV_REG = _rmem.track(
        "llm.paged_kv", kind="kv_cache",
        nbytes=int(kv["k"].nbytes + kv["v"].nbytes),
    )
    _rmem.tag_arrays("llm.paged_kv", "kv_cache", kv)
    return kv


class PageAllocator:
    """Host-side page bookkeeping: free list, per-page refcounts, and the
    prefix-hash -> page map for sharing."""

    def __init__(self, num_pages: int, page_size: int):
        # `num_pages` counts USABLE pages; physical page 0 is the dump
        # page, so the pool is created with num_pages + 1 pages.
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(1, num_pages + 1))
        self._refs = np.zeros(num_pages + 1, np.int32)
        # prefix hash -> page id; the hash covers every token up to and
        # including the page, so equal hash => identical page contents.
        self._prefix_pages: dict[int, int] = {}
        self._page_hash: dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self) -> int:
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def share(self, page: int) -> int:
        self._refs[page] += 1
        return page

    def release(self, page: int) -> None:
        self._refs[page] -= 1
        if self._refs[page] == 0:
            h = self._page_hash.pop(page, None)
            if h is not None and self._prefix_pages.get(h) == page:
                del self._prefix_pages[h]
            self._free.append(page)

    def lookup_prefix(self, prefix_hash: int) -> int | None:
        return self._prefix_pages.get(prefix_hash)

    def register_prefix(self, prefix_hash: int, page: int) -> None:
        self._prefix_pages[prefix_hash] = page
        self._page_hash[page] = prefix_hash


def prefix_hashes(tokens: list[int], page_size: int) -> list[int]:
    """One hash per FULL page, each covering tokens[0 : (i+1)*page]."""
    return [
        hash(tuple(tokens[:end]))
        for end in range(page_size, len(tokens) + 1, page_size)
    ]


def _gather_page_attention(q, k_pool, v_pool, page_index, mask, cfg):
    """Dense masked attention over gathered pool pages: the plain path of
    decode/verify and the attention of chunked prefill.

    q: [B, Q, H, Dh]; page_index: [B, n_pages] (>= 0);
    mask: [B, Q, window] bool, True = hidden. Returns [B, Q, H, Dh].
    """
    b, q_len, n_heads = q.shape[0], q.shape[1], q.shape[2]
    hkv = k_pool.shape[1]  # under tp: this rank's heads
    n_rep = n_heads // hkv
    dh = cfg.head_dim
    n_pages = page_index.shape[1]
    page_size = k_pool.shape[2]
    window = n_pages * page_size
    kk = k_pool[page_index]  # [B, n_pages, Hkv, P, Dh]
    vv = v_pool[page_index]
    qg = q.reshape(b, q_len, hkv, n_rep, dh)
    logits = (
        torch.einsum("bqgrd,bngpd->bgrqnp", qg.float(), kk.float())
        * dh**-0.5
    ).reshape(b, hkv, n_rep, q_len, window)
    logits = logits.masked_fill(mask[:, None, None, :, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
    attn = torch.einsum(
        "bgrqnp,bngpd->bqgrd",
        probs.reshape(b, hkv, n_rep, q_len, n_pages, page_size),
        vv,
    )
    return attn.reshape(b, q_len, n_heads, dh)


def _to_pages(t: torch.Tensor, n_pages: int, page_size: int, cfg):
    """[1, n_pages * P, Hkv, Dh] -> head-major [n_pages, Hkv, P, Dh]."""
    return t.to(cfg.dtype).reshape(
        n_pages, page_size, t.shape[2], cfg.head_dim
    ).transpose(1, 2)


@torch.no_grad()
def paged_prefill(
    params,
    tokens: torch.Tensor,  # [1, S_pad] int
    pool: PagedKV,
    pages: torch.Tensor,  # [n_write_pages] int: page ids for this prompt
    cfg: LlamaConfig,
    n_write_pages: int,
):
    """Dense prompt pass; K/V scattered into ``pages`` of the pool.

    S_pad must equal n_write_pages * page_size. ``pages`` covers the whole
    padded prompt; the engine passes the dump page 0 for shared-prefix
    pages, so their writes land there (attention here is dense over the
    fresh K/V and does not read the pool).
    Returns (logits [1, S_pad, V] fp32, pool).
    """
    seq = tokens.shape[1]
    page_size = pool["k"].shape[3]
    cos, sin = rope_frequencies(
        cfg.head_dim, seq, cfg.rope_theta, device=tokens.device
    )
    pages = pages.long()
    x = embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        q, k, v = project_qkv(x, p, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = causal_attention(q, k, v)
        x = x + attn_out(attn, p, cfg)
        x = _mlp(x, p, cfg)
        pool["k"][i][pages] = _to_pages(k, n_write_pages, page_size, cfg)
        pool["v"][i][pages] = _to_pages(v, n_write_pages, page_size, cfg)
    return lm_logits(params, x, cfg), pool


@torch.no_grad()
def paged_prefill_chunk(
    params,
    tokens: torch.Tensor,  # [1, C] int, C = chunk_pages * page_size
    pool: PagedKV,
    pages: torch.Tensor,  # [n_write_pages] int: the FULL context table
    start: int,  # global position of tokens[0, 0], page-aligned
    cfg: LlamaConfig,
    n_write_pages: int,
    chunk_pages: int,
    write_pages: torch.Tensor,  # [n_write_pages] int: where K/V are written
):
    """One prefill chunk: K/V for positions start .. start+C-1 scattered
    into the chunk's slice of ``write_pages`` (``pages`` with the dump
    page 0 in place of each shared-prefix page, which is never rewritten);
    each chunk query attends the whole context so far through ``pages``.
    Returns (logits [1, C, V] fp32, pool)."""
    c = tokens.shape[1]
    dev = tokens.device
    page_size = pool["k"].shape[3]
    window = n_write_pages * page_size
    cos, sin = rope_frequencies(
        cfg.head_dim, window, cfg.rope_theta, device=dev
    )
    pos = start + torch.arange(c, device=dev)[None, :]  # [1, C]
    pages = pages.long()
    chunk = write_pages.long()[start // page_size: start // page_size + chunk_pages]
    mask = torch.arange(window, device=dev)[None, None, :] > pos[:, :, None]
    x = embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        k_pool, v_pool = pool["k"][i], pool["v"][i]
        q, k, v = project_qkv(x, p, cfg)  # [1, C, H, Dh]
        q = apply_rope(q, cos, sin, positions=pos)
        k = apply_rope(k, cos, sin, positions=pos)
        k_pool[chunk] = _to_pages(k, chunk_pages, page_size, cfg)
        v_pool[chunk] = _to_pages(v, chunk_pages, page_size, cfg)
        attn = _gather_page_attention(
            q, k_pool, v_pool, pages[None, :], mask, cfg
        )
        x = x + attn_out(attn, p, cfg)
        x = _mlp(x, p, cfg)
    return lm_logits(params, x, cfg), pool


def paged_decode(
    params,
    tokens: torch.Tensor,  # [B, 1] int
    pool: PagedKV,
    block_tables: torch.Tensor,  # [B, max_pages] int32 (-1 = unused)
    positions: torch.Tensor,  # [B] int32: position this token writes at
    temperature: torch.Tensor,  # [B] fp32 (0 = greedy)
    generator: torch.Generator | None,
    cfg: LlamaConfig,
    use_kernel: bool = False,
):
    """One decode step: the K=1 case of :func:`paged_verify`. Sampling
    happens on the device. Returns (sampled [B], logits [B, V] fp32,
    pool)."""
    sampled, _accept, _rej, logits, pool = paged_verify(
        params, tokens, pool, block_tables, positions, temperature,
        generator, cfg=cfg, use_kernel=use_kernel, stochastic=False,
    )
    return sampled[:, 0], logits, pool


def _categorical(logits: torch.Tensor, generator) -> torch.Tensor:
    """One draw per row of [N, V] logits."""
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def paged_verify(
    params,
    tokens: torch.Tensor,  # [B, K] int: next token + K-1 draft tokens
    pool: PagedKV,
    block_tables: torch.Tensor,  # [B, max_pages] int32 (-1 = unused)
    positions: torch.Tensor,  # [B] int32: position tokens[:, 0] writes at
    temperature: torch.Tensor,  # [B] fp32 (0 = greedy)
    generator: torch.Generator | None,
    cfg: LlamaConfig,
    use_kernel: bool = False,
    stochastic: bool = True,
):
    """Speculative verify step: K tokens per slot in one pass.
    tokens[:, 0] is the next token; tokens[:, 1:] are host-proposed
    drafts. Acceptance inputs are computed on the device:

    - greedy slots: ``accept[b, j]`` = the argmax after position j equals
      draft j+1;
    - stochastic slots: exact rejection sampling against the draft's
      delta distribution: accept with probability p(draft); on rejection
      emit a sample of p with the draft masked out.

    ``use_kernel`` reads the pool through the CUDA paged-attention kernel
    (``ops/paged_attention.py``) instead of the gather path.

    Returns (sampled [B, K] int, accept [B, K-1] bool, rej [B, K-1] int,
    logits [B, V] fp32 of position 0, pool).
    """
    b, kk_w = tokens.shape
    dev = tokens.device
    page_size = pool["k"].shape[3]
    max_pages = block_tables.shape[1]
    window = max_pages * page_size
    cos, sin = rope_frequencies(
        cfg.head_dim, window, cfg.rope_theta, device=dev
    )
    pos2d = positions.long()[:, None] + torch.arange(kk_w, device=dev)
    mask = torch.arange(window, device=dev)[None, None, :] > pos2d[:, :, None]
    page_of = torch.clamp(pos2d // page_size, max=max_pages - 1)
    off_of = pos2d % page_size
    # Inactive slots (table -1) and draft positions past the table window
    # write to the dump page 0, never into a live cell.
    write_pages = torch.gather(block_tables.long(), 1, page_of).clamp(min=0)
    write_pages = torch.where(pos2d < window, write_pages, 0)
    gather_index = block_tables.long().clamp(min=0)

    x = embed(params, tokens, cfg)  # [B, K, d]
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        k_pool, v_pool = pool["k"][i], pool["v"][i]
        q, k, v = project_qkv(x, p, cfg)  # [B, K, H, Dh]
        q = apply_rope(q, cos, sin, positions=pos2d)
        k = apply_rope(k, cos, sin, positions=pos2d)
        # Advanced indices at dims 0 and 2 around a slice: the indexed
        # block is [B, K, Hkv, Dh], matching k.
        k_pool[write_pages, :, off_of, :] = k.to(cfg.dtype)
        v_pool[write_pages, :, off_of, :] = v.to(cfg.dtype)
        if use_kernel:
            attn = paged_attention(q, k_pool, v_pool, block_tables, positions)
        else:
            attn = _gather_page_attention(
                q, k_pool, v_pool, gather_index, mask, cfg
            )
        x = x + attn_out(attn, p, cfg)
        x = _mlp(x, p, cfg)
    logits = lm_logits(params, x, cfg)  # [B, K, V]

    flat = logits.reshape(b * kk_w, -1)
    temp_flat = temperature.repeat_interleave(kk_w)
    greedy = flat.argmax(dim=-1)
    drawn = _categorical(
        flat / temp_flat.clamp(min=1e-6)[:, None], generator
    )
    sampled = torch.where(temp_flat > 0.0, drawn, greedy).reshape(b, kk_w)

    if kk_w > 1:
        drafts = tokens[:, 1:].long()  # [B, K-1]
        head = logits[:, : kk_w - 1]  # [B, K-1, V]
        head_argmax = head.argmax(dim=-1)
        acc_greedy = head_argmax == drafts
        if stochastic:
            temp_c = temperature.clamp(min=1e-6)[:, None, None]
            probs = torch.softmax(head / temp_c, dim=-1)
            p_draft = torch.gather(probs, 2, drafts[:, :, None])[..., 0]
            u = torch.rand(
                (b, kk_w - 1), generator=generator, device=dev
            )
            greedy_slot = temperature[:, None] <= 0.0
            accept = torch.where(greedy_slot, acc_greedy, u < p_draft)
            masked = head.scatter(2, drafts[:, :, None], _NEG_INF)
            rej_drawn = _categorical(
                (masked / temp_c).reshape(b * (kk_w - 1), -1), generator
            ).reshape(b, kk_w - 1)
            rej = torch.where(greedy_slot, head_argmax, rej_drawn)
        else:
            accept = acc_greedy
            rej = head_argmax
    else:
        accept = torch.zeros((b, 0), dtype=torch.bool, device=dev)
        rej = torch.zeros((b, 0), dtype=torch.long, device=dev)
    return sampled, accept, rej, logits[:, 0], pool


def propose_ngram_draft(
    context: list[int] | np.ndarray, k: int, ngram: int = 2
) -> list[int]:
    """Prompt-lookup drafting (host side, no draft model): find the most
    recent earlier occurrence of the last ``ngram`` tokens and propose the
    ``k`` tokens that followed it; [] when there is none."""
    ctx = np.asarray(context, dtype=np.int64)
    n = len(ctx)
    if n < ngram + 1 or k <= 0:
        return []
    tail = ctx[n - ngram:]
    hits = ctx[: n - 1 - (ngram - 1)] == tail[0]
    for j in range(1, ngram):
        hits = hits & (ctx[j: n - 1 - (ngram - 1) + j] == tail[j])
    idx = np.nonzero(hits)[0]
    if idx.size == 0:
        return []
    start = int(idx[-1])  # rightmost: recent repetition predicts best
    return ctx[start + ngram: start + ngram + k].astype(int).tolist()


def sample_on_device(
    logits: torch.Tensor,  # [B, V] fp32
    temperature: torch.Tensor,  # [B] fp32, 0 = greedy
    generator: torch.Generator | None,
) -> torch.Tensor:
    """Greedy / temperature sampling without shipping logits to the host;
    the per-slot temperature selects between the two."""
    greedy = logits.argmax(dim=-1)
    drawn = _categorical(
        logits / temperature.clamp(min=1e-6)[:, None], generator
    )
    return torch.where(temperature > 0.0, drawn, greedy)
