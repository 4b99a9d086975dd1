"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain PyTorch versions, and the autograd Function that joins them (port of
ray_tpu/ops/pallas/flash_attention.py).

Layout [B, S, H, D], GQA by index (query head h reads KV head
h // n_rep). q is pre-scaled in fp32 and rounded to its storage dtype
before either kernel, as ``_flash_impl`` and ``_flash_bwd`` do. The
forward (``csrc/flash_fwd.cu``) outputs O [B, S, H, D] in the input dtype
and the fp32 logsumexp [B * H, 1, S]; the backward (``csrc/flash_bwd.cu``)
recomputes the probabilities from that logsumexp and returns dq, dk, dv
with dk and dv summed over each KV group.

Both kernels are built for head_dim 64 and 128 and pick their route by
dtype: bf16 runs on the tensor cores
(``wgmma``, tiles laid out by ``csrc/wgmma_tile.cuh``; the backward is
one fused pass whose dq is summed with fp32 atomics, so bf16 dq is not
bit-reproducible run to run), fp32 on scalar FMAs.

:func:`flash_attention` is differentiable: the forward is the registered
op ``torch.ops.ray_tpu_torch.flash_fwd`` (O and LSE), whose autograd
formula saves (q, k, v, O, LSE) as ``_flash_fwd`` does and launches the
backward kernel once. Being one op, it is what a selective-checkpoint
policy can keep by name: the remat modes that keep the flash outputs
("flash", "flash_qkv", ...) never replay the forward kernel in backward
(models/llama.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch import _build, mesh_size
from ray_tpu_torch.parallel.sharding import per_shard

_MASK = -1e9
KERNEL_HEAD_DIMS = (64, 128)  # the head sizes csrc/flash_{fwd,bwd}.cu build

# Tile arithmetic of the reference kernel, kept as the prefill gate's
# (llm/kv_cache.py): the gate admits a sequence whose fitted block is
# >= 128 and a multiple of 8.
DEFAULT_BLOCK = 1024


def _fit_block(requested: int, s: int) -> int:
    """Largest block <= requested that divides s (s itself when s fits)."""
    if s <= requested:
        return s
    for d in range(requested, 0, -1):
        if s % d == 0:
            return d
    return 1


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in fp32, rounded to q's dtype (the reference's one
    rounding of q when the scale is not a power of two). PyTorch computes
    a bf16 product in fp32 and rounds it once, so one op gives the same
    bits as the fp32 round trip without its two fp32 copies of q."""
    return q * scale


def _scores(qs, k, n_rep, causal):
    """fp32 scores [B, H, S, S] of the pre-scaled q, -1e9 above the
    diagonal when causal."""
    kk = k.repeat_interleave(n_rep, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kk.float())
    if causal:
        pos = torch.arange(qs.shape[1], device=qs.device)
        sc = sc.masked_fill(pos[None, :] > pos[:, None], _MASK)
    return sc


def flash_attention_reference(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in one softmax block: fp32 scores of the
    pre-scaled q, -1e9 mask, p = exp(s - max) rounded to v's dtype for
    the PV product, divide by the unrounded row sum. Returns (O
    [B, S, H, D], LSE [B * H, 1, S] fp32)."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    if scale is None:
        scale = d**-0.5
    sc = _scores(_prescale(q, scale), k, n_rep, causal)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)  # [B, H, S, 1]
    vv = v.repeat_interleave(n_rep, dim=2)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vv.float())
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m + torch.log(l_safe))
    return out, lse.reshape(b * h, 1, s)


def flash_attention_backward_reference(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    o: torch.Tensor,  # [B, S, H, D], the forward's output
    lse: torch.Tensor,  # [B * H, 1, S] fp32, the forward's logsumexp
    do: torch.Tensor,  # [B, S, H, D], the gradient of o
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic on whole [S, S] blocks: p =
    exp(s - lse) under the -1e9 mask, delta = rowsum(dO * O) in fp32,
    dv = p^T dO with p rounded to dO's dtype, ds = p (dO v^T - delta),
    dq = (ds k) * scale with ds rounded to k's dtype, dk = ds^T qs with ds
    rounded to q's dtype; dk and dv summed over each KV group in fp32,
    then cast. Returns (dq, dk, dv) in the shapes and dtypes of q, k, v."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    n_rep = h // hkv
    if scale is None:
        scale = d**-0.5
    qs = _prescale(q, scale)
    p = torch.exp(_scores(qs, k, n_rep, causal) - lse.reshape(b, h, s, 1))
    dof = do.float()
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    vv = v.repeat_interleave(n_rep, dim=2).float()
    kk = k.repeat_interleave(n_rep, dim=2).float()
    dv_e = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vv) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kk) * scale
    dk_e = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs.float())

    def group_sum(t, like):
        return t.reshape(b, s, hkv, n_rep, d).sum(3).to(like.dtype)

    return dq.to(q.dtype), group_sum(dk_e, k), group_sum(dv_e, v)


def _cuda_checks(name, q, k, v, *more):
    """Raise unless q, k, v (and ``more``, shaped like q) are CUDA tensors
    of one kernel dtype with the kernel's head size."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    for t in (k, v, *more):
        if t.device != q.device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: inputs must share a dtype")
    if k.shape != (b, s, hkv, d) or v.shape != k.shape or any(
        t.shape != q.shape for t in more
    ):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel is built for head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")


@functools.cache
def _kernel():
    fn = _build.load("flash_fwd").rtt_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 6
        + [ctypes.c_void_p]
    )
    return fn


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(O [B, S, H, D], LSE [B * H, 1, S]). A CPU tensor takes
    :func:`flash_attention_reference`; a CUDA tensor launches
    ``csrc/flash_fwd.cu`` on the current stream (counted in
    ``flash_attention_forward.launches``) or raises."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"n_heads={h} not divisible by n_kv={hkv}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    _cuda_checks("flash_attention", q, k, v)
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: k and v must be contiguous")
    code = _build.dtype_code(q.dtype)
    qs = _prescale(q, d**-0.5 if scale is None else scale).contiguous()
    out = torch.empty_like(qs)
    lse = torch.empty((b * h, 1, s), dtype=torch.float32, device=q.device)
    err = _kernel()(
        code, qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, hkv, d, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    flash_attention_forward.launches += 1
    return out, lse


flash_attention_forward.launches = 0


@functools.cache
def _bwd_kernel():
    fn = _build.load("flash_bwd").rtt_flash_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 11
        + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p]
    )
    return fn


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the attention that produced (o, lse). A CPU tensor
    takes :func:`flash_attention_backward_reference`; a CUDA tensor
    launches ``csrc/flash_bwd.cu`` (its kernels, counted as one launch in
    ``flash_attention_backward.launches``) or raises.

    Replaces ``_bwd_kernel`` of ray_tpu/ops/pallas/flash_attention.py. It
    is bound by operations, 10 * B * H * D * S(S+1)/2 flops causal (five
    products per head), against O(S * D * H) bytes; see the kernel source
    for its design."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"n_heads={h} not divisible by n_kv={hkv}")
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, causal, scale
        )
    _cuda_checks("flash_attention_backward", q, k, v, o, do)
    if lse.shape != (b * h, 1, s) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_backward: lse must be fp32 "
                         f"[{b * h}, 1, {s}], got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    scale = d**-0.5 if scale is None else scale
    code = _build.dtype_code(q.dtype)
    qs = _prescale(q, scale).contiguous()
    k, v, o, do, lse = (t.contiguous() for t in (k, v, o, do, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (qs, k, v))
    # Scratch the kernels fill: delta = rowsum(dO * O) in fp32, [B * H, S]
    # like the logsumexp; for bf16 the fp32 dq accumulator of the fused
    # pass's atomics.
    delta = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if q.dtype == torch.bfloat16 else None)
    err = _bwd_kernel()(
        code, qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if dq_acc is None else dq_acc.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, h, hkv, d, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention_backward")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float | None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) of :func:`flash_attention_forward`, as one registered op."""
    return flash_attention_forward(q, k, v, causal, scale)


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale):
    # Shapes for tracing; a meta tensor is refused as the wrapper refuses it.
    if q.device.type == "meta":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b * h, 1, s),
                                             dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    # The residuals of the reference's _flash_fwd: (q, k, v, O, LSE).
    q, k, v, causal, scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.scale = causal, scale


def _flash_backward(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do, ctx.causal,
                                          ctx.scale)
    return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention output [B, S, H, D], differentiable in q, k and v. Under
    ``torch.no_grad()`` it is one forward launch and saves nothing."""
    return torch.ops.ray_tpu_torch.flash_fwd(q, k, v, causal, scale)[0]


# Read by models/llama.py: an attention function that saves its own
# residuals (the flash op) has its q/k/v products kept under the
# "flash_qkv*" remat modes, as the reference tags the flash kernel's
# inputs; under dense attention those modes keep no q/k/v.
flash_attention.keeps_residuals = True


def make_flash_attention(mesh=None, batch_axes=("dp", "fsdp"),
                         head_axis="tp"):
    """The trainer's attention function (counterpart of the reference's
    ``make_flash_attention``, which runs the kernel per shard under
    ``shard_map``). Without a mesh, or on one of one rank:
    :func:`flash_attention`. Under a larger mesh: batch sharded over
    ``batch_axes``, heads over ``head_axis``, the sequence whole; each
    rank runs F1 forward and F2 backward on its own [B / (dp fsdp), S,
    H / tp, D] through the same registered op. DTensor inputs are
    redistributed to those placements and the output is a DTensor with
    them; plain tensors are taken as this rank's shards already (what the
    model hands it under ``use_mesh``; under sp > 1 the model gathers each
    rank's sequence block for it, models/llama.py ``forward_with_aux``). A
    local shard of a head-split view need not be contiguous, and the
    kernels take contiguous k and v: each shard is made contiguous here."""
    if mesh_size(mesh) == 1:
        return flash_attention
    sharded = per_shard(
        lambda q, k, v: flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous()),
        mesh, batch_axes, None, head_axis)
    sharded.keeps_residuals = True
    return sharded
