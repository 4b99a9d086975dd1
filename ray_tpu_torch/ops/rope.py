"""Rotary position embeddings, split-halves convention (port of
ray_tpu/ops/rope.py)."""

from __future__ import annotations

import torch


def rope_frequencies(
    head_dim: int,
    max_seq: int,
    theta: float = 500000.0,
    *,
    device: str | torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin) tables of shape [max_seq, head_dim // 2], fp32, on
    ``device`` (no default: a forgotten device must not mean the CPU)."""
    exponents = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )
    inv_freq = 1.0 / torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=device), exponents
    )
    pos = torch.arange(max_seq, dtype=torch.float32, device=device)
    angles = torch.outer(pos, inv_freq)  # [S, D/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rotate ``x`` of shape [..., S, H, D] by position.

    ``cos``/``sin`` are [max_seq, D/2]; ``positions`` (optional, [..., S])
    selects rows, defaulting to arange(S).
    """
    seq = x.shape[-3]
    if positions is None:
        c = cos[:seq][:, None, :]
        s = sin[:seq][:, None, :]
    else:
        c = cos[positions][..., :, None, :]
        s = sin[positions][..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
