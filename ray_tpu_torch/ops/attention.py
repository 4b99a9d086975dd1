"""Causal multi-head attention, GQA-aware (port of ray_tpu/ops/attention.py).

Plain PyTorch: fp32 scores, fp32 softmax, probabilities cast back to the
input dtype for the value product. Prefill's attention in the paged
engine, and the oracle the flash kernel's plain version is held against.
"""

from __future__ import annotations

import torch

_NEG_INF = -2.0e38


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D]; head h reads kv h // n_rep."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: torch.Tensor | int = 0,
    kv_offset: torch.Tensor | int = 0,
) -> torch.Tensor:
    """Causal attention over [B, S, H, D] tensors; supports GQA (Hkv | H).

    ``q_offset``/``kv_offset`` shift the absolute positions of the query
    and key blocks. A query row that sees no key returns 0.
    """
    n_heads, n_kv = q.shape[2], k.shape[2]
    if n_heads % n_kv:
        raise ValueError(f"n_heads={n_heads} not divisible by n_kv={n_kv}")
    k = _repeat_kv(k, n_heads // n_kv)
    v = _repeat_kv(v, n_heads // n_kv)

    scale = q.shape[-1] ** -0.5
    # Products of the stored values accumulated in fp32 (the reference's
    # preferred_element_type=f32): upcast, then multiply.
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale

    dev = q.device
    q_pos = torch.arange(q.shape[1], device=dev) + q_offset
    k_pos = torch.arange(k.shape[1], device=dev) + kv_offset
    mask = (q_pos[:, None] >= k_pos[None, :])[None, None, :, :]
    logits = torch.where(mask, logits, torch.tensor(_NEG_INF, device=dev))

    probs = torch.softmax(logits, dim=-1)
    row_valid = (q_pos >= kv_offset).to(probs.dtype)
    probs = (probs * row_valid[None, None, :, None]).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
