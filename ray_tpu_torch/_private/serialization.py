"""Object serialization: cloudpickle + pickle-5 out-of-band buffers.

Analogue of the reference's SerializationContext (reference:
python/ray/_private/serialization.py:149): cloudpickle for arbitrary
Python (lambdas, closures, classes), pickle-5 out-of-band buffers so large
numpy arrays and torch tensors are captured as contiguous memoryviews and
written to the shared-memory store without an extra copy.

ObjectRef semantics match the reference: refs nested inside values pickle
into reconstructable refs on the receiving side (ObjectRef.__reduce__ in
ray_tpu_torch.api); only *top-level* task arguments that are refs get resolved
to values before execution (core_worker builds those as by-ref args).

A torch tensor crosses as its bytes (a flat ``uint8`` view, out of band at
or above ``OUT_OF_BAND_MIN``) with its dtype, shape and device beside
them: bf16 has no numpy dtype, so the bytes never pass through numpy's
dtype. A CPU tensor costs no copy on the sending side; a CUDA tensor costs
one device-to-host copy. The receiver rebuilds the tensor on the device it
left and raises where that device is absent, never moving it to the CPU.
"""

from __future__ import annotations

import io
import pickle
import sys
from dataclasses import dataclass, field
from typing import Any

import cloudpickle

# Buffers at or above this size are kept out-of-band (zero-copy path).
OUT_OF_BAND_MIN = 4096


@dataclass
class Serialized:
    """A serialized object: in-band pickle stream + out-of-band buffers."""

    inband: bytes
    buffers: list = field(default_factory=list)

    def total_bytes(self) -> int:
        return len(self.inband) + sum(len(b) for b in self.buffers)

    def materialize_buffers(self) -> "Serialized":
        return Serialized(self.inband, [bytes(b) for b in self.buffers])


def _tensor_types():
    """(Tensor, Parameter) when torch is loaded, else None: a value can
    hold a tensor only if its process imported torch, so serializing
    never imports it."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    return torch.Tensor, torch.nn.Parameter


def _reduce_tensor(t):
    """Reduce a strided tensor to (flat uint8 bytes, dtype, shape,
    device, requires_grad, is_parameter)."""
    import torch

    host = t.detach()
    if host.device.type != "cpu":
        host = host.to("cpu")  # the one device-to-host copy
    host = host.contiguous()  # a no-op unless strided
    flat = host.reshape(-1).view(torch.uint8)
    return _rebuild_tensor, (
        pickle.PickleBuffer(flat.numpy()),
        str(t.dtype).removeprefix("torch."),
        tuple(t.shape),
        str(t.device),
        t.requires_grad,
        isinstance(t, torch.nn.Parameter),
    )


def _rebuild_tensor(buf, dtype, shape, device, requires_grad, parameter):
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and (
        not torch.cuda.is_available()
        or (dev.index or 0) >= torch.cuda.device_count()
    ):
        raise RuntimeError(
            f"a tensor on {device!r} reached a process without that CUDA "
            "device; it is not moved to the CPU"
        )
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"cannot rebuild a tensor on {device!r}")
    mv = memoryview(buf).cast("B")
    if mv.nbytes == 0:
        flat = torch.empty(0, dtype=torch.uint8)
    elif mv.readonly and dev.type == "cpu":
        # torch has no read-only tensor: a read-only mapping (the file
        # store) is copied once rather than aliased.
        flat = torch.frombuffer(bytearray(mv), dtype=torch.uint8)
    else:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # read-only views
            flat = torch.frombuffer(mv, dtype=torch.uint8)
    t = flat.view(getattr(torch, dtype)).reshape(shape)
    if dev.type == "cuda":
        t = t.to(dev)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad)


class _Pickler(cloudpickle.CloudPickler):
    def reducer_override(self, obj):
        types = _tensor_types()
        if (
            types is not None
            and type(obj) in types
            and obj.layout is sys.modules["torch"].strided
            and not obj.is_quantized
        ):
            return _reduce_tensor(obj)
        return super().reducer_override(obj)


def serialize(value: Any) -> Serialized:
    buffers: list[memoryview] = []

    def buffer_callback(buf) -> bool:
        raw = buf.raw()
        if raw.nbytes >= OUT_OF_BAND_MIN:
            buffers.append(raw)
            return False  # keep out-of-band
        return True  # small: keep in-band

    sink = io.BytesIO()
    _Pickler(sink, protocol=5, buffer_callback=buffer_callback).dump(value)
    return Serialized(sink.getvalue(), buffers)


def deserialize(inband: bytes, buffers: list | None = None) -> Any:
    return pickle.loads(inband, buffers=buffers or [])
