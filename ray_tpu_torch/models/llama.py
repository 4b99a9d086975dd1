"""Llama-3-style decoder in PyTorch (port of ray_tpu/models/llama.py).

GQA attention + RoPE + SwiGLU + RMSNorm. Parameters are a plain dict with
the reference's leaf names: layers stacked on a leading [L, ...] dim,
weights oriented [in, out], norm scales fp32. Matrices are cast to
``cfg.dtype`` at use (a no-op when stored cast already). A Python loop
over the layer stack replaces ``lax.scan``.

:func:`forward` is inference (no autograd). :func:`forward_with_aux` is the
differentiable training forward, with the reference's remat modes
``"none"``, ``"full"`` and ``"flash_qkv"`` as non-reentrant
``torch.utils.checkpoint`` regions:

- ``"full"``: one region around the whole block; backward replays all of
  it, the attention forward included.
- ``"flash_qkv"``: two regions, norm/q-k-v projections/RoPE, then
  wo/residual/FFN, with the attention call between them. The flash
  Function (ops/flash_attention.py) saves its own q, k, v, O and LSE, so
  across the block only the layer input x and those residuals stay alive,
  and the backward never replays the forward kernel: one forward and one
  backward launch per layer per step. The kernel is a ctypes launch inside
  an autograd Function, which no selective checkpoint policy can name;
  placing it between two regions is what keeps it out of every replay.
  (A ``torch.library.custom_op`` would let a policy name it, at the cost
  of a registered op per kernel.) The split is taken for an attention
  function whose ``keeps_residuals`` attribute is true (set on
  ``flash_attention``). With any other attention function
  (``attn_impl="dense"``) the mode keeps nothing by name and acts as
  ``"full"``, as in the reference.

The reference's other modes (``attn``, ``flash``, ``dots``,
``flash_qkv_ffn``, ``flash_qkv_ffn8``) raise NotImplementedError until
they are ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

Params = dict[str, Any]
AttnFn = Callable[..., torch.Tensor]
FfnFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]

# Leaves of params["blocks"] that are norm scales: kept fp32, because
# rms_norm upcasts the scale itself and a bf16 copy would change it.
NORM_LEAVES = ("attn_norm", "mlp_norm")

REMAT_MODES = ("none", "full", "flash_qkv")
# Named by the reference, not ported yet (ROADMAP.md, Queue 1).
UNPORTED_REMAT_MODES = ("attn", "flash", "dots", "flash_qkv_ffn",
                        "flash_qkv_ffn8")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.bfloat16
    # Remat mode of the layer body in training (see the module docstring).
    remat: str = "full"
    # "dense" | "flash" (ring/ulysses: not ported; train/step.py raises).
    attn_impl: str = "dense"
    # Embedding lookup: "gather" (table[tokens]), "onehot"
    # (one_hot(tokens) @ table), or "auto", which is "gather" until the
    # port has multi-GPU sharding (the reference takes "onehot" when more
    # than one device is visible, for its SPMD partitioner).
    embed_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        attn = d * (self.n_heads * self.head_dim) * 2 + d * (
            self.n_kv_heads * self.head_dim
        ) * 2
        per_layer = attn + 3 * d * f + 2 * d
        return self.n_layers * per_layer + 2 * v * d + d

    def flops_per_token(self, seq: int) -> float:
        """Training (fwd+bwd) FLOPs per token: 6*N_matmul + attention term."""
        d, v = self.d_model, self.vocab_size
        matmul_params = self.num_params() - v * d  # exclude embedding lookup
        attn_flops = 12 * self.n_layers * d * seq  # 6 * 2 * L * d * s
        return 6.0 * matmul_params + attn_flops


PRESETS: dict[str, LlamaConfig] = {
    # CPU-test scale.
    "tiny": LlamaConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=256, dtype=torch.float32, remat="none",
    ),
    "mini": LlamaConfig(
        vocab_size=32768, d_model=768, n_layers=12, n_heads=12, n_kv_heads=4,
        d_ff=2048, max_seq=2048,
    ),
    # Single-device benchmark scale (~444M parameters), trained at full
    # width and depth; "flash_qkv" keeps q/k/v and the flash residuals.
    "bench": LlamaConfig(
        vocab_size=32768, d_model=1024, n_layers=24, n_heads=8, n_kv_heads=4,
        d_ff=4096, max_seq=2048, remat="flash_qkv",
    ),
    # Llama-3-8B widths.
    "llama3_8b": LlamaConfig(),
}


def _shapes(cfg: LlamaConfig) -> dict[str, tuple[tuple[int, ...], int]]:
    """(shape, fan_in) of every matrix leaf; blocks' leaves carry [L]."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    return {
        "tok_emb": ((cfg.vocab_size, d), d),
        "wq": ((L, d, hq), d),
        "wk": ((L, d, hkv), d),
        "wv": ((L, d, hkv), d),
        "wo": ((L, hq, d), hq),
        "w_gate": ((L, d, f), d),
        "w_up": ((L, d, f), d),
        "w_down": ((L, f, d), f),
        "lm_head": ((d, cfg.vocab_size), d),
    }


def init_params(
    cfg: LlamaConfig,
    seed: int = 0,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random parameters: truncated normal in [-2, 2] times fan_in**-0.5,
    drawn in fp32 from a ``torch.Generator`` on ``device`` seeded with
    ``seed``, stored in ``dtype`` (fp32 like the reference by default;
    pass ``cfg.dtype`` to hold a full-size model at half the bytes). Norm
    scales are fp32 zeros. Draws go one layer at a time, so the fp32
    scratch is one layer's matrix, not the stack's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for sl in out.view(-1, *shape[-2:]):
            tmp = torch.empty(shape[-2:], dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            sl.copy_(tmp.mul_(fan_in**-0.5))
        return out

    shapes = _shapes(cfg)
    blocks = {
        name: w(*shapes[name])
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    }
    L, d = cfg.n_layers, cfg.d_model
    for name in NORM_LEAVES:
        blocks[name] = torch.zeros((L, d), dtype=torch.float32, device=dev)
    return {
        "tok_emb": w(*shapes["tok_emb"]),
        "blocks": blocks,
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=dev),
        "lm_head": w(*shapes["lm_head"]),
    }


def params_from_jax(
    tree: Params, cfg: LlamaConfig, device: str | torch.device = "cuda"
) -> Params:
    """Carry a reference parameter tree (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) into torch tensors on
    ``device``. Matrices are stored cast to ``cfg.dtype`` (the reference
    casts them at every use, so the values are the same); norm scales
    stay fp32."""
    dev = resolve_device(device)

    def conv(x, keep_fp32):
        dtype = torch.float32 if keep_fp32 else cfg.dtype
        return torch.tensor(np.asarray(x)).to(device=dev, dtype=dtype)

    return {
        "tok_emb": conv(tree["tok_emb"], False),
        "blocks": {
            k: conv(v, k in NORM_LEAVES) for k, v in tree["blocks"].items()
        },
        "final_norm": conv(tree["final_norm"], True),
        "lm_head": conv(tree["lm_head"], False),
    }


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked block parameters."""
    return {k: v[i] for k, v in params["blocks"].items()}


def embed(params: Params, tokens: torch.Tensor, cfg: LlamaConfig):
    """Token embedding in ``cfg.dtype`` (port of the reference's
    ``_embed``). "gather" takes the rows, then casts them: the values of
    gathering from the cast table, without casting all of it (the
    gradient is accumulated into the rows in fp32). "onehot" multiplies a
    one-hot matrix by the cast table, as the reference does under a
    sharded mesh. "auto" is "gather": the port runs on one device."""
    table = params["tok_emb"]
    impl = "gather" if cfg.embed_impl == "auto" else cfg.embed_impl
    if impl == "gather":
        return table[tokens].to(cfg.dtype)
    if impl != "onehot":
        raise ValueError(f"unknown embed_impl {cfg.embed_impl!r}")
    table = table.to(cfg.dtype)
    return F.one_hot(tokens.long(), table.shape[0]).to(table.dtype) @ table


def project_qkv(x: torch.Tensor, p: Params, cfg: LlamaConfig):
    """Pre-attention norm and q/k/v projections: q [B, S, H, Dh], k and v
    [B, S, Hkv, Dh], before RoPE."""
    b, s, _ = x.shape
    dt = cfg.dtype
    h = rms_norm(x, p["attn_norm"])
    q = (h @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ p["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def lm_logits(params: Params, x: torch.Tensor, cfg: LlamaConfig):
    """Final norm, then a ``cfg.dtype`` product upcast to fp32 (not an
    fp32 matmul, as in the reference)."""
    x = rms_norm(x, params["final_norm"])
    return (x @ params["lm_head"].to(cfg.dtype)).float()


def _dense_ffn(h: torch.Tensor, p: Params, cfg: LlamaConfig):
    """SwiGLU FFN; returns (out, aux loss 0) as MoE FFNs return (out, aux)."""
    dt = cfg.dtype
    gate = F.silu(h @ p["w_gate"].to(dt))
    up = h @ p["w_up"].to(dt)
    aux = h.new_zeros((), dtype=torch.float32)
    return (gate * up) @ p["w_down"].to(dt), aux


def _attn_inputs(x, p, cos, sin, cfg: LlamaConfig):
    """q, k, v of the attention sublayer, RoPE applied to q and k."""
    q, k, v = project_qkv(x, p, cfg)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attn_out_and_ffn(x, attn, p, cfg: LlamaConfig, ffn_fn: FfnFn):
    """Output projection and residual, then the pre-norm FFN sublayer."""
    b, s, _ = x.shape
    x = x + attn.reshape(b, s, -1) @ p["wo"].to(cfg.dtype)
    ffn_out, aux = ffn_fn(rms_norm(x, p["mlp_norm"]), p, cfg)
    return x + ffn_out, aux


def _block(x, p, cos, sin, cfg: LlamaConfig, attn_fn: AttnFn, ffn_fn: FfnFn):
    """Pre-norm attention + FFN sublayers; ffn_fn returns (out, aux)."""
    q, k, v = _attn_inputs(x, p, cos, sin, cfg)
    return _attn_out_and_ffn(x, attn_fn(q, k, v), p, cfg, ffn_fn)


def _remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def forward_with_aux(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    attn_fn: AttnFn | None = None,
    ffn_fn: FfnFn | None = None,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> (logits [B, S, V] fp32, summed aux loss),
    differentiable in ``params``.

    With ``return_hidden`` the final-norm hidden states [B, S, d] come
    back instead of logits (the chunked-CE loss projects them a slice at a
    time). ``cfg.remat`` selects what the layer loop keeps for backward
    (module docstring); ``attn_fn`` defaults to the plain causal attention.
    """
    if cfg.remat in UNPORTED_REMAT_MODES:
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet; the port has "
            f"{REMAT_MODES} (ROADMAP.md, Queue 1)"
        )
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {cfg.remat!r}")
    attn_fn = attn_fn or causal_attention
    ffn_fn = ffn_fn or _dense_ffn
    split = cfg.remat == "flash_qkv" and getattr(
        attn_fn, "keeps_residuals", False
    )
    seq = tokens.shape[1]
    cos, sin = rope_frequencies(
        cfg.head_dim, seq, cfg.rope_theta, device=tokens.device
    )
    x = embed(params, tokens, cfg)
    aux_total = x.new_zeros((), dtype=torch.float32)
    # One unbind per stacked leaf: its backward stacks the layers' grads
    # once, where indexing would build a full-size grad per layer.
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in layers.items()}
        if cfg.remat == "none":
            x, aux = _block(x, p, cos, sin, cfg, attn_fn, ffn_fn)
        elif split:
            q, k, v = _remat(_attn_inputs, x, p, cos, sin, cfg)
            x, aux = _remat(_attn_out_and_ffn, x, attn_fn(q, k, v), p, cfg,
                            ffn_fn)
        else:
            x, aux = _remat(_block, x, p, cos, sin, cfg, attn_fn, ffn_fn)
        aux_total = aux_total + aux
    if return_hidden:
        return rms_norm(x, params["final_norm"]), aux_total
    return lm_logits(params, x, cfg), aux_total


@torch.no_grad()
def forward(
    params: Params, tokens: torch.Tensor, cfg: LlamaConfig
) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, V] fp32 (inference only)."""
    b, s = tokens.shape
    dt = cfg.dtype
    cos, sin = rope_frequencies(
        cfg.head_dim, s, cfg.rope_theta, device=tokens.device
    )
    x = embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        q, k, v = project_qkv(x, p, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = causal_attention(q, k, v)
        x = x + attn.reshape(b, s, -1) @ p["wo"].to(dt)
        h = rms_norm(x, p["mlp_norm"])
        gate = torch.nn.functional.silu(h @ p["w_gate"].to(dt))
        x = x + (gate * (h @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    return lm_logits(params, x, cfg)
