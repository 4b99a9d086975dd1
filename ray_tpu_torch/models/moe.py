"""Mixture-of-Experts decoder (port of ray_tpu/models/moe.py).

GShard/Switch-style MoE on the Llama block: tokens are routed in
fixed-size groups (GShard section 3.2), each token to its top-k experts,
every expert taking at most ``capacity`` tokens per group; a choice past
its expert's capacity is dropped (its residual passes through), and the
Switch load-balance loss is returned beside the output. The attention
sublayer, the layer loop and the remat modes are models/llama.py's: this
module only swaps the FFN.

Under a mesh (parallel/sharding.py ``use_mesh``) the experts are split
over the "ep" axis (``moe_param_logical_axes``) and their hidden dim over
tp. The tokens are replicated over ep, as in the reference, where XLA
places the experts' work by two ``constrain``s on the expert dim; here the
activations are plain local tensors and each ep rank runs its own experts
on the tokens routed to them, and the combine is summed over ep. Routing groups are cut from the whole batch, as the reference's
reshape of the global tokens cuts them; when a group would span ranks
(``g`` does not divide a rank's tokens, or under sp its sequence block)
the tokens are gathered over the data axes and sp first and every rank
routes the whole batch, keeping its own rows of the output.

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
    param_logical_axes,
    truncated_normal,
)
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.parallel.sharding import active_mesh


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


def moe_param_logical_axes(cfg: MoEConfig) -> Params:
    axes = param_logical_axes(cfg)
    axes["blocks"].update(
        router=("layers", "embed", "expert"),
        w_gate=("layers", "expert", "embed", "mlp"),
        w_up=("layers", "expert", "embed", "mlp"),
        w_down=("layers", "expert", "mlp", "embed"),
    )
    return axes


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
    ``cfg.dtype``. Under a mesh ``p`` holds the whole router, this rank's
    experts (over ep) and their hidden columns (over tp)."""
    mesh = active_mesh()
    if mesh is None:
        return _moe_ffn(x, p, cfg, None)
    data = ("dp", "fsdp")
    b, s, d = x.shape
    n_sp = axis_size(mesh, "sp")
    g = group_size(b * s * col.group_size(mesh, data) * n_sp, cfg)
    # Under sp a rank holds a block of each of its sequences: its groups
    # are the reference's only if every group lies in one block.
    if (s % g if n_sp > 1 else b * s % g) == 0:
        return _moe_ffn(x, p, cfg, mesh)
    # A routing group spans ranks: route the whole batch on every rank.
    whole = col.all_gather(col.all_gather(x, mesh, data, 0), mesh, "sp", 1)
    out, aux = _moe_ffn(whole, p, cfg, mesh)
    return col.local_chunk(col.local_chunk(out, mesh, "sp", 1), mesh, data,
                           0), aux


def _moe_ffn(x: torch.Tensor, p: Params, cfg: MoEConfig, mesh):
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    g = group_size(b * s, cfg)
    G = b * s // g
    dt = cfg.dtype
    ep = 1 if mesh is None else axis_size(mesh, "ep")
    e_local = p["w_gate"].shape[0]  # this rank's experts (all without ep)
    lo = 0 if ep == 1 else axis_index(mesh, "ep") * e_local
    # Every ep rank sees every token; the gradient each computes (its
    # experts', its share of the router's) is partial.
    x = col.copy_to(x, mesh, "ep")
    tokens = x.reshape(G, g, d)
    probs, gate_vals, gate_idx, slot, capacity = route(tokens, p["router"],
                                                       cfg)
    # The choices this rank's experts take.
    mine = (gate_idx >= lo) & (gate_idx < lo + e_local)
    keep = (slot < capacity) & mine
    local_idx = (gate_idx - lo).clamp(0, e_local - 1)
    group = torch.arange(G, device=x.device).view(G, 1, 1).expand_as(slot)

    # Dispatch: each kept choice's token row into its expert's slot; the
    # dropped ones (and other ranks' choices) into a spare slot past the
    # capacity, then cut off. Under tp the experts' products are split on
    # their hidden dim, so the rows enter them replicated.
    src = col.copy_to(tokens, mesh, "tp")
    spill = torch.where(keep, slot, capacity)
    expert_in = src.new_zeros((e_local, G, capacity + 1, d)).index_put(
        (local_idx, group, spill), src.unsqueeze(2).expand(G, g, k, d)
    )[:, :, :capacity].to(dt)
    expert_in = expert_in.reshape(e_local, G * capacity, d)
    gate = F.silu(torch.bmm(expert_in, p["w_gate"].to(dt)))
    up = torch.bmm(expert_in, p["w_up"].to(dt))
    expert_out = torch.bmm(gate * up, p["w_down"].to(dt))
    expert_out = col.reduce_from(expert_out, mesh, "tp")
    expert_out = expert_out.view(e_local, G, capacity, d)

    # Combine: the gate-weighted kept choices, summed in fp32 (over ep:
    # each rank adds its experts' terms).
    picked = expert_out[local_idx, group, slot.clamp(max=capacity - 1)]
    weight = (gate_vals * keep).unsqueeze(-1)
    out = col.reduce_from((weight * picked.float()).sum(2).to(dt), mesh,
                          "ep")

    # Load-balance loss: e * sum_e (fraction routed) * (mean prob), over
    # every top-k choice, averaged over groups.
    me = probs.mean(1)  # [G, e]
    ce = F.one_hot(gate_idx, e).float().sum(2).mean(1)  # [G, e]
    aux = e * (me * ce).sum(-1).mean() * cfg.aux_loss_weight
    if ep > 1:
        # Every ep rank holds the whole aux loss; its gradient is taken
        # 1/ep times on each, so that it is partial like the combine's.
        aux = aux.detach() + (aux - aux.detach()) / ep
    return out.reshape(b, s, d), aux


moe_ffn.param_axes = moe_param_logical_axes  # read by forward_with_aux


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
