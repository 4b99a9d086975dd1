"""KV-cached forward passes over a dense slab (port of
ray_tpu/llm/kv_cache.py).

The cache is a [L, B, S_max, Hkv, Dh] pair of tensors; prefill writes one
slot's prompt, decode advances every slot by one token. Keys past a
slot's position are masked, so padding and stale entries are never read.
Unlike the reference, which donates the cache to a jitted program, the
cache here is updated IN PLACE (slice assignment); the functions return
the same cache object for the reference's call shape.
"""

from __future__ import annotations

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    Params,
    _tp_in,
    _tp_out,
    attn_out,
    embed,
    kv_heads_per_rank,
    layer_params,
    lm_logits,
    project_qkv,
)
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.flash_attention import (
    DEFAULT_BLOCK,
    _fit_block,
    flash_attention,
)
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

_NEG_INF = -2.0e38

KVCache = dict[str, torch.Tensor]  # {"k": [L,B,S,Hkv,Dh], "v": same}


def init_kv_cache(
    cfg: LlamaConfig,
    max_batch: int,
    max_seq: int,
    device: str | torch.device = "cuda",
    mesh=None,
) -> KVCache:
    """Zeros [L, B, S, Hkv, Dh]; under a mesh this rank's KV heads
    (:func:`~ray_tpu_torch.models.llama.kv_heads_per_rank`)."""
    shape = (cfg.n_layers, max_batch, max_seq, kv_heads_per_rank(cfg, mesh),
             cfg.head_dim)
    dev = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def _mlp(x, p, cfg):
    dt = cfg.dtype
    h = _tp_in(rms_norm(x, p["mlp_norm"]))
    gate = torch.nn.functional.silu(h @ p["w_gate"].to(dt))
    up = h @ p["w_up"].to(dt)
    return x + _tp_out((gate * up) @ p["w_down"].to(dt))


def flash_gate(seq: int, use_flash: bool) -> bool:
    """The reference's prefill gate: flash for a sequence >= 512 whose
    fitted block (largest divisor <= DEFAULT_BLOCK) is >= 128 and a
    multiple of 8; awkward lengths keep the plain path."""
    blk = _fit_block(DEFAULT_BLOCK, seq)
    return use_flash and seq >= 512 and blk >= 128 and blk % 8 == 0


@torch.no_grad()
def forward_prefill(
    params: Params,
    tokens: torch.Tensor,  # [1, S_pad] int (one slot's prompt, padded)
    cache: KVCache,
    slot: int,
    cfg: LlamaConfig,
    use_flash: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt through the model, writing K/V into cache[:, slot]
    in place. Returns logits [1, S_pad, V] fp32 (the caller reads
    position true_len-1) and the cache. ``use_flash`` routes attention
    through the flash kernel when :func:`flash_gate` admits the length.
    """
    seq = tokens.shape[1]
    cos, sin = rope_frequencies(
        cfg.head_dim, seq, cfg.rope_theta, device=tokens.device
    )
    attend = flash_attention if flash_gate(seq, use_flash) else (
        causal_attention
    )
    x = embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        q, k, v = project_qkv(x, p, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attend(q, k, v)
        x = x + attn_out(attn, p, cfg)
        x = _mlp(x, p, cfg)
        cache["k"][i, slot, :seq] = k[0].to(cfg.dtype)
        cache["v"][i, slot, :seq] = v[0].to(cfg.dtype)
    return lm_logits(params, x, cfg), cache


@torch.no_grad()
def forward_decode(
    params: Params,
    tokens: torch.Tensor,  # [B, 1] int: current token of every slot
    cache: KVCache,
    positions: torch.Tensor,  # [B] int: position each token sits at
    cfg: LlamaConfig,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step for all slots; K/V written in place at
    ``positions``. Returns logits [B, V] fp32 and the cache."""
    b = tokens.shape[0]
    dev = tokens.device
    max_seq = cache["k"].shape[2]
    # Table sized to the cache length, not cfg.max_seq.
    cos, sin = rope_frequencies(
        cfg.head_dim, max_seq, cfg.rope_theta, device=dev
    )
    positions = positions.long()
    mask = torch.arange(max_seq, device=dev)[None, :] > positions[:, None]
    rows = torch.arange(b, device=dev)
    scale = cfg.head_dim**-0.5
    x = embed(params, tokens, cfg)  # [B, 1, d]
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        q, k, v = project_qkv(x, p, cfg)  # q [B, 1, H, Dh]
        q = apply_rope(q, cos, sin, positions=positions[:, None])
        k = apply_rope(k, cos, sin, positions=positions[:, None])
        cache["k"][i, rows, positions] = k[:, 0].to(cfg.dtype)
        cache["v"][i, rows, positions] = v[:, 0].to(cfg.dtype)
        n_rep = q.shape[2] // cache["k"].shape[3]
        kk = cache["k"][i].repeat_interleave(n_rep, dim=2)  # [B, S, H, Dh]
        vv = cache["v"][i].repeat_interleave(n_rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
        logits = logits.masked_fill(mask[:, None, None, :], _NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
        x = x + attn_out(attn, p, cfg)
        x = _mlp(x, p, cfg)
    return lm_logits(params, x, cfg)[:, 0], cache
