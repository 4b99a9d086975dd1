"""Llama-3-style decoder in PyTorch (port of ray_tpu/models/llama.py).

GQA attention + RoPE + SwiGLU + RMSNorm. Parameters are a plain dict with
the reference's leaf names: layers stacked on a leading [L, ...] dim,
weights oriented [in, out], norm scales fp32. Matrices are cast to
``cfg.dtype`` at use (a no-op when stored cast already). A Python loop
over the layer stack replaces ``lax.scan``. Inference only: the remat
modes of the reference belong to training.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

Params = dict[str, Any]

# Leaves of params["blocks"] that are norm scales: kept fp32, because
# rms_norm upcasts the scale itself and a bf16 copy would change it.
NORM_LEAVES = ("attn_norm", "mlp_norm")


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


PRESETS: dict[str, LlamaConfig] = {
    # CPU-test scale.
    "tiny": LlamaConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=256, dtype=torch.float32,
    ),
    "mini": LlamaConfig(
        vocab_size=32768, d_model=768, n_layers=12, n_heads=12, n_kv_heads=4,
        d_ff=2048, max_seq=2048,
    ),
    "bench": LlamaConfig(
        vocab_size=32768, d_model=1024, n_layers=24, n_heads=8, n_kv_heads=4,
        d_ff=4096, max_seq=2048,
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
    """Rows of the table in ``cfg.dtype`` (gathered, then cast: the same
    values as gathering from the cast table, without casting all of it)."""
    return params["tok_emb"][tokens].to(cfg.dtype)


def lm_logits(params: Params, x: torch.Tensor, cfg: LlamaConfig):
    """Final norm, then a ``cfg.dtype`` product upcast to fp32 (not an
    fp32 matmul, as in the reference)."""
    x = rms_norm(x, params["final_norm"])
    return (x @ params["lm_head"].to(cfg.dtype)).float()


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
        h = rms_norm(x, p["attn_norm"])
        q = (h @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = (h @ p["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ p["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = causal_attention(q, k, v)
        x = x + attn.reshape(b, s, -1) @ p["wo"].to(dt)
        h = rms_norm(x, p["mlp_norm"])
        gate = torch.nn.functional.silu(h @ p["w_gate"].to(dt))
        x = x + (gate * (h @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    return lm_logits(params, x, cfg)
