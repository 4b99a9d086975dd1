"""Mixture-of-Experts decoder (port of ray_tpu/models/moe.py).

GShard/Switch-style MoE on the Llama block: tokens are routed in
fixed-size groups (GShard section 3.2), each token to its top-k experts,
every expert taking at most ``capacity`` tokens per group; a choice past
its expert's capacity is dropped (its residual passes through), and the
Switch load-balance loss is returned beside the output. The attention
sublayer, the layer loop and the remat modes are models/llama.py's: this
module only swaps the FFN.

On one device, without the reference's mesh: ``moe_param_logical_axes``
and ``constrain`` (expert parallelism over the "ep" axis) are not ported
(ROADMAP.md, Queue 1).

Where the reference builds one-hot dispatch and combine tensors
([G, g, e, capacity], 335 MB each in fp32 at moe_bench, batch 16 x 2048)
and contracts them with einsums, the port moves rows by index: each
expert slot holds at most one token, so the dispatch einsum equals a
scatter of the token's row (empty slots 0), and the combine einsum equals
the gate-weighted sum of each token's kept choices, top_k fp32 terms, as
there. Nothing of size [G, g, e, capacity] is made.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    Params,
    _init_params,
    forward_with_aux,
    truncated_normal,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    # capacity per expert per group = capacity_factor * g * top_k / num_experts
    capacity_factor: float = 1.25
    # routing group size (tokens): bounds a group's slots at g * top_k
    group_size: int = 1024
    # weight of the load-balancing auxiliary loss (Switch section 2.2)
    aux_loss_weight: float = 0.01


MOE_PRESETS: dict[str, MoEConfig] = {
    "moe_tiny": MoEConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=256, dtype=torch.float32, remat="none",
        num_experts=4, top_k=2, group_size=64,
    ),
    # Single-device scale (head_dim 64).
    "moe_bench": MoEConfig(
        vocab_size=32768, d_model=1024, n_layers=6, n_heads=16,
        n_kv_heads=8, d_ff=2048, max_seq=2048, num_experts=4, top_k=2,
    ),
    # The reference's pod scale (experts sharded over its ep axis).
    "moe_8x430m": MoEConfig(
        vocab_size=32768, d_model=1024, n_layers=12, n_heads=16,
        n_kv_heads=8, d_ff=4096, max_seq=2048, num_experts=8, top_k=2,
    ),
}


def init_moe_params(
    cfg: MoEConfig,
    seed: int = 0,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """The dense model's parameters (models/llama.py ``init_params``) with
    the FFN replaced by ``router [L, d, e]`` and the experts ``w_gate``,
    ``w_up [L, e, d, f]`` and ``w_down [L, e, f, d]``, each truncated
    normal times fan_in**-0.5 (fan-in d, or f for w_down), all drawn from
    one ``torch.Generator`` seeded with ``seed``, stored in ``dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = _init_params(cfg, gen, dev, dtype)
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.n_layers
    for name, shape, fan_in in (
        ("router", (L, d, e), d),
        ("w_gate", (L, e, d, f), d),
        ("w_up", (L, e, d, f), d),
        ("w_down", (L, e, f, d), f),
    ):
        params["blocks"][name] = truncated_normal(shape, fan_in, gen, dev,
                                                  dtype)
    return params


def group_size(n: int, cfg: MoEConfig) -> int:
    """Tokens per routing group: ``cfg.group_size`` (at most n), or all n
    tokens when that does not divide them."""
    g = min(cfg.group_size, n)
    return n if n % g else g


def route(tokens: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Top-k routing of grouped tokens [G, g, d]. Returns (probs [G, g, e]
    fp32, gate values [G, g, k] renormalized over the chosen experts,
    expert indices [G, g, k], slots [G, g, k], capacity). The router
    product runs in ``cfg.dtype``, upcast before the softmax. Among equal
    probabilities the lower expert index comes first (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none). A choice's slot counts the
    earlier choices of its expert in the group, token-major then choice;
    a slot >= capacity is dropped."""
    _, g, _ = tokens.shape
    e, k = cfg.num_experts, cfg.top_k
    capacity = max(1, int(cfg.capacity_factor * g * k / e))
    logits = (tokens @ router.to(cfg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    ordered, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = ordered[..., :k], order[..., :k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    sel = F.one_hot(gate_idx, e).flatten(1, 2)  # [G, g * k, e]
    before = torch.cumsum(sel, dim=1) - sel
    slot = (before * sel).sum(-1).view_as(gate_idx)
    return probs, gate_vals, gate_idx, slot, capacity


def moe_ffn(x: torch.Tensor, p: Params, cfg: MoEConfig):
    """FFN hook of models/llama.py ``_block``: x [B, S, d] -> (out,
    aux loss). Routing and the combine run in fp32, the experts' FFNs in
    ``cfg.dtype``."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    g = group_size(b * s, cfg)
    G = b * s // g
    dt = cfg.dtype
    tokens = x.reshape(G, g, d)
    probs, gate_vals, gate_idx, slot, capacity = route(tokens, p["router"],
                                                       cfg)
    keep = slot < capacity
    group = torch.arange(G, device=x.device).view(G, 1, 1).expand_as(slot)

    # Dispatch: each kept choice's token row into its expert's slot; the
    # dropped ones into a spare slot past the capacity, then cut off.
    spill = torch.where(keep, slot, capacity)
    expert_in = tokens.new_zeros((e, G, capacity + 1, d)).index_put(
        (gate_idx, group, spill), tokens.unsqueeze(2).expand(G, g, k, d)
    )[:, :, :capacity].to(dt).reshape(e, G * capacity, d)
    gate = F.silu(torch.bmm(expert_in, p["w_gate"].to(dt)))
    up = torch.bmm(expert_in, p["w_up"].to(dt))
    expert_out = torch.bmm(gate * up, p["w_down"].to(dt))
    expert_out = expert_out.view(e, G, capacity, d)

    # Combine: the gate-weighted kept choices, summed in fp32.
    picked = expert_out[gate_idx, group, slot.clamp(max=capacity - 1)]
    weight = (gate_vals * keep).unsqueeze(-1)
    out = (weight * picked.float()).sum(2).to(dt)

    # Load-balance loss: e * sum_e (fraction routed) * (mean prob), over
    # every top-k choice, averaged over groups.
    me = probs.mean(1)  # [G, e]
    ce = F.one_hot(gate_idx, e).float().sum(2).mean(1)  # [G, e]
    aux = e * (me * ce).sum(-1).mean() * cfg.aux_loss_weight
    return out.reshape(b, s, d), aux


def moe_forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: MoEConfig,
    attn_fn=None,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] fp32, or the final hidden states
    with ``return_hidden``, and the aux loss averaged over layers)."""
    out, aux_total = forward_with_aux(
        params, tokens, cfg, attn_fn=attn_fn, ffn_fn=moe_ffn,
        return_hidden=return_hidden,
    )
    return out, aux_total / cfg.n_layers
