"""Block-scaled int8 codec for compressed collectives.

EQuARX (arXiv:2506.17615) shows a block-scaled quantized allreduce inside
XLA recovers a near-2x communication speedup with negligible quality
loss. This module is the codec both backends share:

- **Quantization** is per-block absmax: the flat payload is padded to a
  multiple of ``block`` elements, each block gets one fp32 scale
  ``absmax / 127``, and values quantize to ``round(x / scale)`` clipped
  to [-127, 127]. Bytes on the wire drop to
  ``1 + 4/block`` per element vs 4 for f32 (~3.9x at block=256).
- **Accumulation stays fp32**: reduction always dequantizes first, sums
  in float32, then requantizes — int8 is a *wire* format, never an
  accumulator (an int8 sum of K ranks would overflow at K=2).
- **Error bound**: per element, ``|x - dq(q(x))| <= scale/2`` where
  ``scale`` is that element's block scale — i.e. absmax(block)/254.
  A reduce over K contributors with one requantize of the result is
  bounded by ``sum_k scale_k/2 + scale_result/2``.

- **Error feedback** (:func:`quantization_residual` /
  :class:`ErrorFeedback`): a sender can carry the per-payload
  quantization error into the next step's payload before quantizing,
  so repeated compression bias stops accumulating across steps — the
  gradient bucketer turns this on with ``error_feedback=True``.

The numpy half serializes to a plain dict (``to_wire``/``from_wire``) so
it rides the existing collective RPC serializer; the torch half
(:func:`quantize_torch` / :func:`dequantize_torch`) runs the same steps
in the same fp32 order on tensors of any device, so the NCCL backends
quantize on the card *around* their collectives (quantize →
all_to_all/all_gather int8 → dequant), bit for bit as the numpy half
(and the JAX package's codec) would.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

# Codec names accepted by the collective verbs' ``compression=`` kwarg.
INT8 = "int8"
CODECS = (INT8,)

# Per-block element count for the absmax scales. 256 puts the scale
# overhead at 4/256 = 1.6% of the int8 payload.
DEFAULT_BLOCK = 256

_QMAX = 127.0


def is_tensor(x) -> bool:
    """A torch tensor (torch is never imported here: a process that holds
    a tensor has imported it)."""
    import sys

    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def check_codec(compression: str | None) -> str | None:
    """Validate a ``compression=`` kwarg (None passes through)."""
    if compression is None:
        return None
    if compression not in CODECS:
        raise ValueError(
            f"unknown compression {compression!r}; supported: {CODECS}"
        )
    return compression


@dataclasses.dataclass
class Quantized:
    """One block-scaled int8 payload.

    ``q`` is the padded flat int8 tensor ``(nblocks * block,)``;
    ``scales`` the per-block fp32 scales ``(nblocks,)``; ``shape`` /
    ``dtype`` restore the original array on dequantize."""

    q: np.ndarray
    scales: np.ndarray
    shape: tuple
    dtype: str
    block: int = DEFAULT_BLOCK

    @property
    def wire_nbytes(self) -> int:
        """Bytes this payload puts on the wire (int8 data + scales)."""
        return int(self.q.nbytes + self.scales.nbytes)

    @property
    def logical_nbytes(self) -> int:
        """Bytes the uncompressed payload would have moved."""
        return int(
            np.dtype(self.dtype).itemsize * math.prod(self.shape or (1,))
        )

    def max_error(self) -> float:
        """Worst-case per-element round-trip error (absmax/254)."""
        return float(self.scales.max(initial=0.0)) / 2.0


def _blocks(flat: np.ndarray, block: int) -> np.ndarray:
    n = flat.size
    nblk = max(1, math.ceil(n / block))
    padded = np.zeros(nblk * block, np.float32)
    padded[:n] = flat
    return padded.reshape(nblk, block)


def quantize(
    arr: Any, block: int = DEFAULT_BLOCK, out_dtype: str | None = None
) -> Quantized:
    """Block-scaled int8 quantization of any array-like (fp32 math)."""
    a = np.asarray(arr)
    shape, dtype = a.shape, str(out_dtype or a.dtype)
    blocks = _blocks(a.astype(np.float32).reshape(-1), block)
    scales = (np.max(np.abs(blocks), axis=1) / _QMAX).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0).astype(np.float32)
    q = np.clip(np.rint(blocks / safe[:, None]), -_QMAX, _QMAX).astype(
        np.int8
    )
    return Quantized(
        q=q.reshape(-1), scales=scales, shape=shape, dtype=dtype, block=block
    )


def dequantize(qt: Quantized, dtype: str | None = None) -> np.ndarray:
    """Inverse of :func:`quantize`; accumulate-grade fp32 by default
    (pass ``dtype`` to cast back to the original payload dtype)."""
    blocks = qt.q.reshape(-1, qt.block).astype(np.float32)
    flat = (blocks * qt.scales[:, None]).reshape(-1)
    n = math.prod(qt.shape or (1,))
    out = flat[:n].reshape(qt.shape)
    return out.astype(dtype) if dtype is not None else out


_WIRE_KEY = "__q8__"


def to_wire(qt: Quantized) -> dict:
    """Serializer-friendly dict (numpy leaves ride the buffer path)."""
    return {
        _WIRE_KEY: 1,
        "q": qt.q,
        "scales": qt.scales,
        "shape": list(qt.shape),
        "dtype": qt.dtype,
        "block": qt.block,
    }


def is_wire(payload: Any) -> bool:
    return isinstance(payload, dict) and _WIRE_KEY in payload


def from_wire(d: dict) -> Quantized:
    return Quantized(
        q=np.asarray(d["q"], np.int8),
        scales=np.asarray(d["scales"], np.float32),
        shape=tuple(d["shape"]),
        dtype=str(d["dtype"]),
        block=int(d["block"]),
    )


def quantization_residual(
    arr: Any, block: int | None = None
) -> np.ndarray:
    """The local error one wire round trip of this codec would commit:
    ``x - dequantize(quantize(x))``, fp32.

    This is the error-feedback primitive (1-bit SGD / EF-SGD lineage):
    a sender that adds this residual into the NEXT step's payload
    before quantizing stops repeated-compression bias from
    accumulating — each step transmits what the previous step's
    quantizer dropped. The quantizer here mirrors the wire path
    exactly for the cpu hub (same codec, same block size); the NCCL
    backends' quantizer differs only in chunk-boundary padding, so the
    residual remains a faithful first-order correction there too. A
    torch tensor stays on its device (the residual is a tensor)."""
    if block is None:
        from ray_tpu_torch._private import config

        block = int(config.get("COLLECTIVE_COMPRESSION_BLOCK"))
    if is_tensor(arr):
        x = arr.float()
        q, scales = quantize_torch(x, block)
        return x - dequantize_torch(q, scales)[: x.numel()].reshape(x.shape)
    x = np.asarray(arr, np.float32)
    return x - dequantize(quantize(x, block=block))


class ErrorFeedback:
    """Per-key residual accumulator for repeated compressed syncs.

    One instance per sender; ``apply(key, x)`` returns the
    residual-compensated payload to hand to the compressed collective
    and updates the stored residual to the error the codec will commit
    on it. A key whose payload changes shape (re-bucketing, elastic
    resize) resets silently — stale residuals must not leak across
    layouts."""

    def __init__(self, block: int | None = None):
        self.block = block
        self._residuals: dict = {}

    def apply(self, key, x: np.ndarray) -> np.ndarray:
        x = x.float() if is_tensor(x) else np.asarray(x, np.float32)
        r = self._residuals.get(key)
        if r is not None and r.shape == x.shape:
            x = x + r
        self._residuals[key] = quantization_residual(x, self.block)
        return x

    def reset(self) -> None:
        self._residuals.clear()


# ---------------------------------------------------------------- torch
# The same codec on torch tensors of any device, for the NCCL backends
# and the cpu hub's tensor path. Padded length and block count depend on
# the input's shape only, never on the data. Every division is tensor by
# tensor: CUDA computes ``tensor / python_scalar`` as a product with the
# scalar's reciprocal, which can differ in the last bit, and the output
# must equal the numpy half's (and the JAX package's) bit for bit.

def padded_len(n: int, block: int = DEFAULT_BLOCK) -> int:
    return max(1, math.ceil(n / block)) * block


def quantize_torch(x, block: int = DEFAULT_BLOCK):
    """``x`` (any shape) → ``(q int8 (nblk, block), scales f32 (nblk,))``
    on ``x``'s device."""
    import torch

    flat = x.to(torch.float32).reshape(-1)
    total = padded_len(flat.numel(), block)
    flat = torch.nn.functional.pad(flat, (0, total - flat.numel()))
    return quantize_blocked_torch(flat.reshape(-1, block))


def quantize_blocked_torch(blocks):
    """``blocks (..., nblk, block)`` (already block-aligned, f32) →
    ``(q int8 same shape, scales f32 (..., nblk))``: the form the NCCL
    backends quantize per destination chunk."""
    import torch

    amax = blocks.abs().amax(dim=-1)
    scales = amax / torch.full_like(amax, _QMAX)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.round(blocks / safe[..., None]).clamp_(-_QMAX, _QMAX)
    return q.to(torch.int8), scales.to(torch.float32)


def dequantize_torch(q, scales):
    """``(q (..., nblk, block), scales (..., nblk))`` → flat f32 of the
    padded length (caller slices back to the logical size)."""
    import torch

    return (q.to(torch.float32) * scales[..., None]).reshape(
        *q.shape[:-2], -1
    )


def wire_nbytes_torch(n_elements: int, block: int = DEFAULT_BLOCK) -> int:
    """Wire bytes of one quantized payload of ``n_elements`` (int8 data
    + fp32 scales): the analytic size the NCCL backends report for the
    phases that ship compressed chunks."""
    total = padded_len(n_elements, block)
    return total + (total // block) * 4
