"""RMSNorm, computed in fp32 and cast back (port of ray_tpu/ops/norms.py)."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Normalize over the last dim in fp32, scale by ``1 + scale``.

    ``scale`` is kept in fp32 by the parameter tree; it is upcast here
    either way, as the reference does."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * (1.0 + scale.float())).to(x.dtype)
