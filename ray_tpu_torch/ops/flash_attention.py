"""Flash-attention forward: the CUDA kernel's wrapper and its plain
PyTorch version (port of the forward of
ray_tpu/ops/pallas/flash_attention.py; the backward is not ported yet).

Layout [B, S, H, D], GQA by index (query head h reads KV head
h // n_rep). q is pre-scaled in fp32 and rounded to its storage dtype
before the kernel, as ``_flash_impl`` does. Outputs O [B, S, H, D] in the
input dtype and the fp32 logsumexp [B * H, 1, S] that the backward will
consume. The kernel is ``csrc/flash_fwd.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch import _build

_MASK = -1e9
KERNEL_HEAD_DIM = 128  # the one head size csrc/flash_fwd.cu builds

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
    rounding of q when the scale is not a power of two)."""
    return (q.float() * scale).to(q.dtype)


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
    qs = _prescale(q, scale)
    kk = k.repeat_interleave(n_rep, dim=2)
    vv = v.repeat_interleave(n_rep, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kk.float())
    if causal:
        pos = torch.arange(s, device=q.device)
        sc = sc.masked_fill(pos[None, :] > pos[:, None], _MASK)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)  # [B, H, S, 1]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vv.float())
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m + torch.log(l_safe))
    return out, lse.reshape(b * h, 1, s)


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
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share a dtype")
    if k.shape != (b, s, hkv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} do not match"
        )
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel is built for head_dim "
                         f"{KERNEL_HEAD_DIM}, got {d}")
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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention output [B, S, H, D] (forward only)."""
    return flash_attention_forward(q, k, v, causal, scale)[0]
