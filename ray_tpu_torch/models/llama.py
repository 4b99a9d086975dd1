"""Llama-3-style decoder in PyTorch (port of ray_tpu/models/llama.py).

GQA attention + RoPE + SwiGLU + RMSNorm. Parameters are a plain dict with
the reference's leaf names: layers stacked on a leading [L, ...] dim,
weights oriented [in, out], norm scales fp32. Matrices are cast to
``cfg.dtype`` at use (a no-op when stored cast already). A Python loop
over the layer stack replaces ``lax.scan``.

:func:`forward` is inference (no autograd). :func:`forward_with_aux` is the
differentiable training forward, with the reference's eight remat modes.
Each layer is one non-reentrant ``torch.utils.checkpoint`` region
("none": no region); a selective-checkpoint policy keeps the outputs of
the ops named below, as the reference's ``save_only_these_names`` keeps
tagged values, and the backward replays the rest of the layer:

==================  ===========================================  ===========
mode                kept across the boundary                     F1 / layer
==================  ===========================================  ===========
``none``            everything autograd saves                    1
``full``            nothing (the layer input)                    2
``attn``            the attention output (``"attn_out"``)        2
``flash``           the flash op's O and LSE (``"flash_out"``)   1
``dots``            every 2-D product (``aten.mm``)              2
``flash_qkv``       ``flash`` + the q/k/v products               1
``flash_qkv_ffn``   ``flash_qkv`` + FFN gate-pre and up products 1
``flash_qkv_ffn8``  ``flash_qkv`` + those two as int8 + scale    1
==================  ===========================================  ===========

(F1: launches of the flash forward kernel per layer in a forward and
backward.) An op is named in one of three ways: the flash forward is the
registered op ``ray_tpu_torch::flash_fwd`` (ops/flash_attention.py); a
product is computed inside :func:`saved_as`; a value passes through
:func:`checkpoint_name` (a copy) or :func:`_int8_ckpt`. Where the
reference tags a product's output, the port keeps the product itself, so
the replay skips the matmul as XLA's does: "flash_qkv" keeps the q/k/v
projections before RoPE (the same bytes as the reference's post-RoPE q,
k, v; RoPE is replayed), and ``_int8_ckpt`` computes its product inside
the op that is kept, so the replay never recomputes the bf16 product it
quantizes. The q/k/v products are named only for an attention function
that keeps its own residuals (``flash_attention``): under dense attention
"flash" and "flash_qkv" keep nothing, and act as "full", as in the
reference.

Under a mesh (parallel/sharding.py ``use_mesh``) the parameters and the
tokens may arrive as DTensors; the model computes on plain local tensors:
each rank's activations are its shard ([B / (dp fsdp), S / sp, ...]), and
the collectives between them are stated (parallel/collectives.py), where
the reference's ``constrain``s leave them to XLA's partitioner.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from torch.distributed.tensor import DTensor

from ray_tpu_torch import mesh_size, resolve_device
import ray_tpu_torch.ops.flash_attention  # noqa: F401 (registers flash_fwd)
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.parallel.sharding import (
    DATA_AXES,
    active_mesh,
    constrain,
    current_scope,
    gather_param,
    local,
    logical_spec,
    mesh_scope,
    sequence_gathered,
)

Params = dict[str, Any]
AttnFn = Callable[..., torch.Tensor]
FfnFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]

# Leaves of params["blocks"] that are norm scales: kept fp32, because
# rms_norm upcasts the scale itself and a bf16 copy would change it.
NORM_LEAVES = ("attn_norm", "mlp_norm")

REMAT_MODES = ("none", "full", "attn", "flash", "dots", "flash_qkv",
               "flash_qkv_ffn", "flash_qkv_ffn8")
# The names each selective mode keeps (module docstring); "flash_out"
# stands for the reference's "flash_out" and "flash_lse", "ffn_gate" and
# "ffn_up" for their "_scale" siblings too under flash_qkv_ffn8.
KEPT_NAMES = {
    "attn": ("attn_out",),
    "flash": ("flash_out",),
    "flash_qkv": ("flash_out", "flash_qkv"),
    "flash_qkv_ffn": ("flash_out", "flash_qkv", "ffn_gate", "ffn_up"),
    "flash_qkv_ffn8": ("flash_out", "flash_qkv", "ffn_gate", "ffn_up"),
}


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
    # "dense" | "flash" | "ring" | "ulysses" (the last two need a mesh
    # with sp > 1; train/step.py's jit_train_step builds them).
    attn_impl: str = "dense"
    # Embedding lookup: "gather" (table[tokens]), "onehot"
    # (one_hot(tokens) @ table), or "auto": "onehot" under a mesh of more
    # than one rank, else "gather" (the reference's rule: "onehot" when
    # more than one device is visible).
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


def param_logical_axes(cfg: LlamaConfig) -> Params:
    """Tree of logical-axis tuples, mirroring init_params' structure."""
    del cfg
    return {
        "tok_emb": ("vocab", "embed"),
        "blocks": {
            "attn_norm": ("layers", "embed"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
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


def truncated_normal(shape, fan_in: int, gen: torch.Generator,
                     device: torch.device, dtype: torch.dtype):
    """A ``shape`` tensor in ``dtype``: truncated normal in [-2, 2] times
    fan_in**-0.5, drawn in fp32 from ``gen`` one trailing matrix at a time
    (the fp32 scratch is one matrix, not the whole stack)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for sl in out.view(-1, *shape[-2:]):
        tmp = torch.empty(shape[-2:], dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
        sl.copy_(tmp.mul_(fan_in**-0.5))
    return out


def _init_params(cfg: LlamaConfig, gen: torch.Generator,
                 dev: torch.device, dtype: torch.dtype) -> Params:
    shapes = _shapes(cfg)

    def w(name):
        return truncated_normal(*shapes[name], gen, dev, dtype)

    blocks = {name: w(name) for name in ("wq", "wk", "wv", "wo", "w_gate",
                                         "w_up", "w_down")}
    L, d = cfg.n_layers, cfg.d_model
    for name in NORM_LEAVES:
        blocks[name] = torch.zeros((L, d), dtype=torch.float32, device=dev)
    return {
        "tok_emb": w("tok_emb"),
        "blocks": blocks,
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=dev),
        "lm_head": w("lm_head"),
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
    scales are fp32 zeros."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _init_params(cfg, gen, dev, dtype)


def params_from_jax(
    tree: Params, cfg: LlamaConfig, device: str | torch.device = "cuda"
) -> Params:
    """Carry a reference parameter tree (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) into torch tensors on
    ``device``, a dense or an MoE tree (models/moe.py). Matrices, the
    router and the experts included, are stored cast to ``cfg.dtype`` (the
    reference casts them at every use, so the values are the same); norm
    scales stay fp32."""
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


def attention_split(cfg: LlamaConfig, mesh) -> bool:
    """Whether each tp rank attends its own query heads with their KV
    heads (both head counts split over tp: the heads, the KV cache and
    the paged pool split over tp) or all ranks attend every head (the
    projections gathered whole, each rank keeping its share of the
    output's ``n_heads * head_dim`` columns for its rows of ``wo``; a
    share may end inside a head, as mini's 12 heads do at tp = 8)."""
    tp = axis_size(mesh, "tp")
    return cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0


def kv_heads_per_rank(cfg: LlamaConfig, mesh) -> int:
    """The KV heads a rank holds in its cache or pool: its share under a
    mesh where :func:`attention_split`, else all of them."""
    if mesh_size(mesh) > 1 and attention_split(cfg, mesh):
        return cfg.n_kv_heads // axis_size(mesh, "tp")
    return cfg.n_kv_heads


def _tp_in(x: torch.Tensor) -> torch.Tensor:
    """A tp-replicated activation entering tp-sharded products: the
    identity, with its gradient summed over tp (no mesh: the identity)."""
    return col.copy_to(x, active_mesh(), "tp")


def _tp_out(x: torch.Tensor) -> torch.Tensor:
    """The partial sums of a tp-sharded contraction, summed over tp."""
    return col.reduce_from(x, active_mesh(), "tp")


def use_params(params: Params, axes: Params, cfg: LlamaConfig, mesh,
               ) -> Params:
    """Under ``mesh``: every parameter of ``params`` (DTensors, or local
    shards placed by ``axes``) as the tensor this rank computes with
    (:func:`~ray_tpu_torch.parallel.sharding.gather_param`): gathered over
    fsdp; kept split over tp and ep, except the router (gathered over ep)
    and, where :func:`attention_split` is False, the q/k/v projections
    (gathered over tp)."""
    split = attention_split(cfg, mesh)

    def use(name, t, ax):
        whole = ()
        if name == "router":
            whole = ("ep",)
        elif name in ("wq", "wk", "wv") and not split:
            whole = ("tp",)
        return gather_param(local(t), ax, mesh, whole)

    out = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out[key] = {n: use(n, t, axes[key][n]) for n, t in val.items()}
        else:
            out[key] = use(key, val, axes[key])
    return out


def embed_impl(cfg: LlamaConfig) -> str:
    """``cfg.embed_impl`` with "auto" resolved: "onehot" under a mesh of
    more than one rank (:func:`~ray_tpu_torch.parallel.sharding.use_mesh`),
    else "gather"."""
    if cfg.embed_impl != "auto":
        return cfg.embed_impl
    return "gather" if active_mesh() is None else "onehot"


def embed(params: Params, tokens: torch.Tensor, cfg: LlamaConfig):
    """Token embedding in ``cfg.dtype`` (port of the reference's
    ``_embed``). "gather" takes the rows, then casts them: the values of
    gathering from the cast table, without casting all of it (the
    gradient is accumulated into the rows in fp32). "onehot" multiplies a
    one-hot matrix by the cast table, as the reference does under a
    sharded mesh. "auto": :func:`embed_impl`.

    Under a mesh whose tp splits the vocabulary, ``params["tok_emb"]`` is
    this rank's rows: each rank embeds the tokens that fall in its rows
    (zeros elsewhere) and the sum over tp is the embedding."""
    table = params["tok_emb"]
    impl = embed_impl(cfg)
    if impl not in ("gather", "onehot"):
        raise ValueError(f"unknown embed_impl {cfg.embed_impl!r}")
    mesh = active_mesh()
    if mesh is not None and axis_size(mesh, "tp") > 1:
        n = table.shape[0]
        lo = axis_index(mesh, "tp") * n
        idx = tokens.long() - lo
        if impl == "gather":
            inside = ((idx >= 0) & (idx < n)).unsqueeze(-1)
            rows = table[idx.clamp(0, n - 1)].to(cfg.dtype) * inside
        else:
            hot = idx.unsqueeze(-1) == torch.arange(n, device=idx.device)
            rows = hot.to(cfg.dtype) @ table.to(cfg.dtype)
        return _tp_out(rows)
    if impl == "gather":
        return table[tokens].to(cfg.dtype)
    table = table.to(cfg.dtype)
    return F.one_hot(tokens.long(), table.shape[0]).to(table.dtype) @ table


# ------------------------------------------------------------ remat names
_naming = threading.local()


@contextlib.contextmanager
def saved_as(name: str | None):
    """Products (``aten.mm``) computed inside carry ``name`` for the remat
    policy (None: no name). The same code runs in the backward's replay,
    so the policy sees the same names there."""
    prev = getattr(_naming, "name", None)
    _naming.name = name
    try:
        yield
    finally:
        _naming.name = prev


@torch.library.custom_op("ray_tpu_torch::checkpoint_name", mutates_args=())
def _checkpoint_name_op(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()  # a registered op's output may not alias its input


_checkpoint_name_op.register_autograd(lambda ctx, g: (g, None))


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under ``name`` for the remat policy (the reference's
    ``checkpoint_name``); a copy of x."""
    return torch.ops.ray_tpu_torch.checkpoint_name(x, name)


def quantize_int8(x: torch.Tensor, mesh=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale fp32 [..., 1]) of the reference's ``_int8_ckpt``:
    scale = max|x| / 127 + 1e-12 per row in fp32, q = round(x / scale)
    (half to even, as ``jnp.round``) clipped to [-127, 127]. Under a
    ``mesh`` whose tp splits the rows' last dim (this rank's columns of
    the FFN's hidden dim), a row's max is over all of it: the local max,
    then the max over tp."""
    amax = x.abs().amax(-1, keepdim=True).float()
    if mesh is not None and axis_size(mesh, "tp") > 1:
        amax = col.all_max(amax, mesh, "tp")
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


@torch.library.custom_op("ray_tpu_torch::int8_ckpt", mutates_args=())
def _int8_ckpt_op(x: torch.Tensor, w: torch.Tensor | None,
                  name: str) -> tuple[torch.Tensor, torch.Tensor]:
    # The tp max runs inside the op a policy keeps, so a replay reads the
    # kept int8 and scale and issues no collective.
    return quantize_int8(x if w is None else x @ w, active_mesh())


class _Int8Ckpt(torch.autograd.Function):
    """Forward: the int8 op, then its dequantized value; backward: the
    cotangent straight through the quantization (and, with ``w``, the
    product's gradients)."""

    @staticmethod
    def forward(ctx, x, w, name):
        q, scale = torch.ops.ray_tpu_torch.int8_ckpt(x, w, name)
        ctx.product = w is not None
        if ctx.product:
            ctx.save_for_backward(x, w)
        return (q.float() * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.product:
            return g, None, None
        x, w = ctx.saved_tensors
        dx = g @ w.mT if ctx.needs_input_grad[0] else None
        dw = (x.reshape(-1, x.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None


def _int8_ckpt(x: torch.Tensor, name: str,
               w: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's ``_int8_ckpt``: ``x`` (or the product ``x @ w``)
    through int8 + a per-row fp32 scale, dequantized to its dtype; the
    gradient passes straight through. What a policy keeps under ``name``
    is the int8 tensor and its scale. With ``w`` the product is computed
    inside the kept op, so a backward replay never recomputes it."""
    return _Int8Ckpt.apply(x, w, name)


def _policy(names: tuple[str, ...], dots: bool):
    """Selective-checkpoint policy: keep the ops named in ``names``; with
    ``dots`` every 2-D product (the reference's
    ``dots_with_no_batch_dims_saveable``; attention's batched products and
    the flash op are not 2-D products)."""
    mm = torch.ops.aten.mm.default
    flash = torch.ops.ray_tpu_torch.flash_fwd.default
    named = (torch.ops.ray_tpu_torch.checkpoint_name.default,
             torch.ops.ray_tpu_torch.int8_ckpt.default)

    def policy(ctx, op, *args, **kwargs):
        if op is mm:
            keep = dots or getattr(_naming, "name", None) in names
        elif op is flash:
            keep = "flash_out" in names
        elif op in named:
            keep = args[-1] in names
        else:
            keep = False
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _remat_contexts(remat: str):
    """``context_fn`` of the layer's checkpoint region under ``remat``
    (None: plain recompute, "full")."""
    if remat == "full":
        return None
    policy = _policy(KEPT_NAMES.get(remat, ()), remat == "dots")
    return functools.partial(create_selective_checkpoint_contexts, policy)


def project_qkv(x: torch.Tensor, p: Params, cfg: LlamaConfig,
                name: str | None = None):
    """Pre-attention norm and q/k/v projections: q [B, S, H, Dh], k and v
    [B, S, Hkv, Dh], before RoPE; the products under ``name``."""
    b, s, _ = x.shape
    dt = cfg.dtype
    h = _tp_in(rms_norm(x, p["attn_norm"]))
    wq, wk, wv = (p[n].to(dt) for n in ("wq", "wk", "wv"))
    # Heads from the weights' widths: under tp they are this rank's.
    with saved_as(name):
        q = (h @ wq).reshape(b, s, -1, cfg.head_dim)
        k = (h @ wk).reshape(b, s, -1, cfg.head_dim)
        v = (h @ wv).reshape(b, s, -1, cfg.head_dim)
    return q, k, v


def attn_out(attn: torch.Tensor, p: Params, cfg: LlamaConfig):
    """The attention output [B, S, H, Dh] through ``wo``: under tp each
    rank multiplies its heads by its rows of ``wo`` and the partial sums
    are summed over tp (where every rank attended every head, it first
    keeps its share of the flattened heads' columns, the rows of ``wo``
    it holds)."""
    b, s = attn.shape[:2]
    o = attn.reshape(b, s, -1)
    mesh = active_mesh()
    if mesh is not None and not attention_split(cfg, mesh):
        o = col.local_chunk(o, mesh, "tp", 2)
    return _tp_out(o @ p["wo"].to(cfg.dtype))


def vocab_logits(x: torch.Tensor, lm_head: torch.Tensor, dtype):
    """``x @ lm_head`` in ``dtype``, upcast to fp32; under a mesh whose
    tp splits the vocabulary, each rank's columns gathered over tp."""
    logits = _tp_in(x) @ lm_head.to(dtype)
    return col.gather_from(logits, active_mesh(), "tp", -1).float()


def lm_logits(params: Params, x: torch.Tensor, cfg: LlamaConfig):
    """Final norm, then a ``cfg.dtype`` product upcast to fp32 (not an
    fp32 matmul, as in the reference)."""
    x = rms_norm(x, params["final_norm"])
    return vocab_logits(x, params["lm_head"], cfg.dtype)


def _dense_ffn(h: torch.Tensor, p: Params, cfg: LlamaConfig):
    """SwiGLU FFN; returns (out, aux loss 0) as MoE FFNs return (out, aux).
    Its gate-pre and up products are named "ffn_gate" and "ffn_up" (kept
    in ``cfg.dtype`` under "flash_qkv_ffn": the reference's
    ``_dense_ffn_save``)."""
    dt = cfg.dtype
    h = _tp_in(h)
    w_gate, w_up = p["w_gate"].to(dt), p["w_up"].to(dt)
    with saved_as("ffn_gate"):
        gate_pre = h @ w_gate
    with saved_as("ffn_up"):
        up = h @ w_up
    aux = h.new_zeros((), dtype=torch.float32)
    return _tp_out((F.silu(gate_pre) * up) @ p["w_down"].to(dt)), aux


def _dense_ffn_q8(h: torch.Tensor, p: Params, cfg: LlamaConfig):
    """FFN whose gate-pre and up activations cross the remat boundary as
    int8 + a per-row fp32 scale (:func:`_int8_ckpt` of each product): the
    replay recomputes neither product and keeps no bf16 copy. Under tp
    each rank quantizes its columns with the rows' scales over all of
    d_ff (:func:`quantize_int8`)."""
    dt = cfg.dtype
    h = _tp_in(h)
    gate_pre = _int8_ckpt(h, "ffn_gate", p["w_gate"].to(dt))
    up = _int8_ckpt(h, "ffn_up", p["w_up"].to(dt))
    aux = h.new_zeros((), dtype=torch.float32)
    return _tp_out((F.silu(gate_pre) * up) @ p["w_down"].to(dt)), aux


def _block(x, p, cos, sin, cfg: LlamaConfig, attn_fn: AttnFn, ffn_fn: FfnFn,
           axes: Params | None = None, scope=None):
    """Pre-norm attention + FFN sublayers; ffn_fn returns (out, aux) so MoE
    layers (models/moe.py) reuse this block unchanged. Under a mesh
    (``scope``, entered here so that a remat replay on autograd's thread
    sees it too), ``p`` holds this rank's shards of the layer (placed by
    ``axes``), gathered here for use, so a replay gathers them again
    (ZeRO-3)."""
    with mesh_scope(scope):
        return _block_body(x, p, cos, sin, cfg, attn_fn, ffn_fn, axes)


def _block_body(x, p, cos, sin, cfg, attn_fn, ffn_fn, axes):
    mesh = active_mesh()
    if mesh is not None:
        p = use_params(p, axes, cfg, mesh)
    qkv = "flash_qkv" if getattr(attn_fn, "keeps_residuals", False) else None
    q, k, v = project_qkv(x, p, cfg, name=qkv)
    attn = attn_fn(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
    if cfg.remat == "attn":  # the copy is made only where it is kept
        attn = checkpoint_name(attn, "attn_out")
    x = x + attn_out(attn, p, cfg)
    ffn_out, aux = ffn_fn(rms_norm(x, p["mlp_norm"]), p, cfg)
    return x + ffn_out, aux


def _local_tokens(tokens: torch.Tensor, mesh):
    """(this rank's tokens [B / (dp fsdp), S / sp], its first position,
    the whole sequence length). A DTensor is placed by ("batch",
    "act_seq"); a plain tensor is this rank's batch shard, whole
    sequences, and is cut over sp here."""
    if isinstance(tokens, DTensor):
        seq = tokens.shape[1]
        tokens = constrain(tokens, "batch", "act_seq").to_local()
    else:
        seq = tokens.shape[1]
        tokens = col.local_chunk(tokens, mesh, "sp", 1)
    return tokens, axis_index(mesh, "sp") * tokens.shape[1], seq


def apply_blocks(x, blocks: Params, cos, sin, cfg: LlamaConfig,
                 attn_fn: AttnFn | None = None, ffn_fn: FfnFn | None = None,
                 axes: Params | None = None):
    """The layer loop: ``x`` [B, S, d] through the stacked layers of
    ``blocks`` (leaves [L, ...], L their leading dim) under ``cfg.remat``,
    each layer one checkpoint region (module docstring). Returns (x, the
    summed aux loss). ``attn_fn`` defaults to the plain causal attention,
    ``ffn_fn`` to the dense FFN (:func:`_dense_ffn_q8` under
    "flash_qkv_ffn8"). Under a mesh ``axes`` places each layer's shards
    (:func:`_block`). A pipeline stage runs its own layers through this
    (parallel/pipeline.py)."""
    attn_fn = attn_fn or causal_attention
    ffn_fn = ffn_fn or _dense_ffn
    if ffn_fn is _dense_ffn and cfg.remat == "flash_qkv_ffn8":
        ffn_fn = _dense_ffn_q8
    contexts = _remat_contexts(cfg.remat)
    aux_total = x.new_zeros((), dtype=torch.float32)
    # One unbind per stacked leaf: its backward stacks the layers' grads
    # once, where indexing would build a full-size grad per layer.
    layers = {k: v.unbind(0) for k, v in blocks.items()}
    scope = current_scope()
    for i in range(len(next(iter(layers.values())))):
        p = {k: v[i] for k, v in layers.items()}
        if cfg.remat == "none":
            x, aux = _block(x, p, cos, sin, cfg, attn_fn, ffn_fn, axes, scope)
        else:
            kw = {} if contexts is None else {"context_fn": contexts}
            x, aux = checkpoint(_block, x, p, cos, sin, cfg, attn_fn, ffn_fn,
                                axes, scope, use_reentrant=False,
                                preserve_rng_state=False, **kw)
        aux_total = aux_total + aux
    return x, aux_total


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
    Under "flash_qkv_ffn8" the dense FFN becomes :func:`_dense_ffn_q8`;
    another ``ffn_fn`` (the MoE FFN) stays as it is, as in the reference.

    Under :func:`~ray_tpu_torch.parallel.sharding.use_mesh` (more than
    one rank) the parameters are DTensors placed by
    :func:`param_logical_axes` (or the ffn's ``param_axes``), ``tokens`` a
    DTensor or this rank's batch shard, and the logits (or hidden states)
    come back as a DTensor placed by ("batch", "act_seq", None); the aux
    loss is its mean over the data ranks. Each rank computes on its
    shards, states its collectives, and runs ``attn_fn`` on its local
    batch and heads. With sp > 1 each rank holds a sequence block: an
    attention that passes blocks between ranks (``seq_sharded``: ring,
    Ulysses) takes it as it is; any other (dense, flash) runs on the whole
    sequence, gathered over sp, and each rank keeps its rows
    (:func:`~ray_tpu_torch.parallel.sharding.sequence_gathered`: what the
    reference's partitioner does for dense and flash attention).
    """
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {cfg.remat!r}")
    attn_fn = attn_fn or causal_attention
    ffn_fn = ffn_fn or _dense_ffn
    mesh = active_mesh()
    block_axes = None
    offset, seq = 0, tokens.shape[1]
    if mesh is not None:
        if axis_size(mesh, "sp") > 1 and not getattr(attn_fn, "seq_sharded",
                                                     False):
            attn_fn = sequence_gathered(attn_fn, mesh)
        axes = getattr(ffn_fn, "param_axes", param_logical_axes)(cfg)
        block_axes = {n: a[1:] for n, a in axes["blocks"].items()}
        tokens, offset, seq = _local_tokens(tokens, mesh)
        top = {k: v for k, v in params.items() if k != "blocks"}
        params = dict(use_params(top, axes, cfg, mesh),
                      blocks={k: local(v)
                              for k, v in params["blocks"].items()})
    cos, sin = rope_frequencies(
        cfg.head_dim, seq, cfg.rope_theta, device=tokens.device
    )
    cos, sin = (t[offset:offset + tokens.shape[1]] for t in (cos, sin))
    x = embed(params, tokens, cfg)
    x, aux_total = apply_blocks(x, params["blocks"], cos, sin, cfg, attn_fn,
                                ffn_fn, block_axes)
    if return_hidden:
        out = rms_norm(x, params["final_norm"])
    else:
        out = lm_logits(params, x, cfg)
    if mesh is None:
        return out, aux_total
    out = DTensor.from_local(out, mesh, logical_spec(
        ("batch", "act_seq", None)), run_check=False)
    return out, col.reduce_from(aux_total, mesh, DATA_AXES, mean=True)


@torch.no_grad()
def forward(
    params: Params, tokens: torch.Tensor, cfg: LlamaConfig
) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, V] fp32 (inference only). Under
    a mesh: :func:`forward_with_aux`'s sharded forward, its logits a
    DTensor."""
    if active_mesh() is not None:
        return forward_with_aux(params, tokens,
                                dataclasses.replace(cfg, remat="none"))[0]
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
