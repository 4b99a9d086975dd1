"""Ring attention: causal attention with the sequence sharded over ``sp``
(port of ray_tpu/parallel/ring_attention.py).

Each sp rank holds one sequence block of Q/K/V. The K/V blocks travel
around the ring (:func:`~ray_tpu_torch.parallel.collectives.ring_shift`,
the reference's ``ppermute``) while each rank folds its queries'
attention over every block into streaming (max, denominator) statistics
in fp32, the flash combine.

The blocks run the plain attention (:func:`_block_stats`, the reference's
own arithmetic), not the flash kernels: the combine differentiates
through each block's row max and sum, and the flash op's backward (F2)
takes no cotangent of its logsumexp. The reference differentiates its
``ppermute``; here ``ring_shift`` is an autograd Function whose backward
sends the gradient back around the ring, so autograd differentiates the
whole ring, block products and combine included, as JAX's transpose does.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.attention import _repeat_kv
from ray_tpu_torch.parallel.collectives import ring_shift
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.parallel.sharding import per_shard

_NEG_BIG = -1.0e30


def _block_stats(q, k, v, q_off, kv_off):
    """One Q-block x KV-block partial attention.

    Returns (o, m, l): unnormalized output [B, Sq, H, D] = exp(S - m) @ V,
    row max m and row sum l, both [B, H, Sq], fp32. Fully masked rows give
    m = _NEG_BIG, l = 0, o = 0, so they vanish in the streaming combine.
    """
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dev = q.device
    q_pos = torch.arange(q.shape[1], device=dev) + q_off
    k_pos = torch.arange(k.shape[1], device=dev) + kv_off
    mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    logits = torch.where(mask, logits, torch.tensor(_NEG_BIG, device=dev))
    m = logits.amax(dim=-1)  # [B, H, Sq]
    p = torch.exp(logits - m[..., None]) * mask  # masked rows -> 0
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return o, m, l


def ring_attention_kernel(q, k, v, *, mesh, axis_name: str = "sp"):
    """Per-rank body: q/k/v are this rank's sequence block [B, S_local,
    H (or Hkv), D]; rank i of ``axis_name`` holds positions
    i * S_local ... (i + 1) * S_local - 1."""
    n = axis_size(mesh, axis_name)
    r = axis_index(mesh, axis_name) if n > 1 else 0
    b, s_local, h, d = q.shape
    q_off = r * s_local
    o = q.new_zeros((b, s_local, h, d), dtype=torch.float32)
    m = q.new_full((b, h, s_local), _NEG_BIG, dtype=torch.float32)
    l = q.new_zeros((b, h, s_local), dtype=torch.float32)
    for step in range(n):
        # This iteration's KV block came from rank (r - step) mod n.
        kv_off = (r - step) % n * s_local
        o_b, m_b, l_b = _block_stats(q, k, v, q_off, kv_off)
        m_new = torch.maximum(m, m_b)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_b - m_new)
        o = (o * alpha.transpose(1, 2)[..., None]
             + o_b * beta.transpose(1, 2)[..., None])
        l = l * alpha + l_b * beta
        m = m_new
        if step != n - 1:
            k = ring_shift(k, mesh, axis_name)
            v = ring_shift(v, mesh, axis_name)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype)


def make_ring_attention(mesh, batch_axes=("dp", "fsdp"), seq_axis="sp",
                        head_axis="tp"):
    """An attention function (q, k, v -> o, [B, S, H, D]) running the ring
    on ``mesh``: batch over ``batch_axes``, sequence over ``seq_axis``,
    heads over ``head_axis``. Drop-in for models/llama.py
    ``forward_with_aux(attn_fn=...)`` (plain tensors are this rank's
    blocks) and takes DTensors too."""

    def kernel(q, k, v):
        return ring_attention_kernel(q, k, v, mesh=mesh, axis_name=seq_axis)

    attn = per_shard(kernel, mesh, batch_axes, seq_axis, head_axis)
    attn.seq_sharded = True  # models/llama.py requires it under sp > 1
    return attn
