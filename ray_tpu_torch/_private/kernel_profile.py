"""Kernel-time attribution of a ``torch.profiler`` capture.

The port's counterpart of ``ray_tpu/_private/xla_profile.py``, the
empirical half of the step profiler (``train/profile.py``). The port has
no HLO and no xplane, so neither the HLO walker nor the protobuf parser
carries over: a capture is a ``torch.profiler.profile`` object, and
:func:`measured_category_seconds` sums the device time of its CUDA
events (kernels, memcpy, memset) into the reference's four categories by
kernel name:

- ``matmul``: cuBLAS and CUTLASS kernels (``gemm``, ``gemv``,
  ``cutlass``, ``nvjet``, ``xmma``), and the port's attention kernels
  (``flash_fwd*``, ``flash_bwd*``, ``paged_attention*``), whose work is
  tensor-core products;
- ``collective``: NCCL kernels;
- ``layout``: memcpy, memset, copies (dtype casts run as copies too),
  transposes, gathers, scatters, index and concatenation kernels;
- ``elementwise_fusion``: everything else (norms, RoPE, softmax,
  reductions, the optimizer's arithmetic).

Profiler overhead events are skipped. A capture without CUDA events (a
process on the CPU) is read from its aten ops' self times on the host
instead, classified by op name: the CPU stands in for the device, as the
reference reads the CPU backend's executor lines. View ops and autograd
node shells move no data and are skipped.

Besides the reference's ``categories``, ``device_busy_s`` and ``events``,
the result has ``kernels``: device ms per kernel name within each
category, and ``attention_ms``: the port's attention kernels' own total
(inside ``matmul``). ``kernels["elementwise_fusion"]`` is the split of the
"other" class of a train step.

Imports no torch at module level: it reads the objects it is given.
"""

from __future__ import annotations

import re

CATEGORIES = ("matmul", "collective", "elementwise_fusion", "layout")

ATTENTION_TOKENS = ("flash_fwd", "flash_bwd", "paged_attention")
MATMUL_TOKENS = ("gemm", "gemv", "cutlass", "nvjet", "xmma", "cublas")
COLLECTIVE_TOKENS = ("nccl",)
LAYOUT_TOKENS = (
    "memcpy", "memset", "copy", "transpose", "gather", "scatter",
    "index", "catarray", "cat_batched", "embedding",
)
# CUPTI and profiler bookkeeping that shows up beside the kernels.
OVERHEAD_NAMES = frozenset({
    "Activity Buffer Request", "Buffer Flush", "Instrumentation",
    "Resource", "CUPTI Overhead",
})
_OVERHEAD_PREFIXES = ("[", "$", "ProfilerStep", "cuda", "cupti")

# aten ops on the CPU path.
_CPU_MATMUL_OPS = frozenset({
    "mm", "bmm", "addmm", "addbmm", "baddbmm", "addmv", "mv", "dot",
    "_scaled_mm", "convolution", "_convolution",
})
_CPU_LAYOUT_OPS = frozenset({
    "copy_", "_to_copy", "clone", "contiguous", "cat", "stack", "index",
    "index_select", "index_add_", "index_put_", "_index_put_impl_",
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "embedding", "embedding_dense_backward", "take_along_dim", "fill_",
    "zero_", "flip", "roll", "narrow_copy", "constant_pad_nd",
})
_CPU_FREE_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "as_strided", "t", "transpose",
    "permute", "expand", "expand_as", "detach", "detach_", "alias",
    "slice", "select", "unsqueeze", "squeeze", "unflatten", "flatten",
    "split", "chunk", "unbind", "resolve_conj", "resolve_neg",
    "empty", "empty_like", "empty_strided", "lift_fresh", "numpy_T",
    "_reshape_alias", "view_as", "split_with_sizes", "narrow",
})
_CPU_COLLECTIVE_TOKENS = ("c10d", "gloo", "nccl", "allreduce",
                          "all_reduce", "allgather", "all_gather",
                          "reduce_scatter", "broadcast_")

KERNEL_NAME_CHARS = 400


def is_overhead(name: str) -> bool:
    """Profiler or CUPTI bookkeeping, not work the program asked for."""
    return name in OVERHEAD_NAMES or name.startswith(_OVERHEAD_PREFIXES)


def categorize_kernel_name(name: str) -> str | None:
    """Category of one CUDA event by its kernel name; None for profiler
    overhead."""
    if is_overhead(name):
        return None
    low = name.lower()
    if any(t in low for t in ATTENTION_TOKENS):
        return "matmul"
    if any(t in low for t in COLLECTIVE_TOKENS):
        return "collective"
    if any(t in low for t in MATMUL_TOKENS):
        return "matmul"
    if any(t in low for t in LAYOUT_TOKENS):
        return "layout"
    return "elementwise_fusion"


def is_attention_kernel(name: str) -> bool:
    low = name.lower()
    return any(t in low for t in ATTENTION_TOKENS)


def categorize_cpu_op(name: str) -> str | None:
    """Category of one host op by its aten name (the CPU path); None for
    views, allocations, autograd node shells and profiler spans, whose
    children (if any) are their own events."""
    if is_overhead(name) or name.startswith("autograd::") or (
            "Backward" in name and "::" not in name):
        return None
    low = name.lower()
    if any(t in low for t in _CPU_COLLECTIVE_TOKENS):
        return "collective"
    base = name.split("::", 1)[1] if name.startswith("aten::") else None
    if base is None:
        return None  # user spans (record_function), torch::autograd nodes
    if base in _CPU_FREE_OPS:
        return None
    if base in _CPU_MATMUL_OPS:
        return "matmul"
    if base in _CPU_LAYOUT_OPS:
        return "layout"
    return "elementwise_fusion"


def _short(name: str) -> str:
    if name.startswith("void "):
        name = name[5:]
    return name[:KERNEL_NAME_CHARS]


def _device_us(ev) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(ev, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def _is_cuda_event(ev) -> bool:
    kind = getattr(ev, "device_type", None)
    return getattr(kind, "name", str(kind)).upper().endswith("CUDA")


def measured_category_seconds(prof) -> dict:
    """One capture's per-category measured seconds.

    ``prof`` is a stopped ``torch.profiler.profile``. Sums the device time
    of its CUDA events by :func:`categorize_kernel_name`; without any CUDA
    event, the aten ops' host self times by :func:`categorize_cpu_op`.
    ``device_busy_s`` is the sum over every counted event, ``events`` their
    number of calls, ``kernels`` the ms of each kernel (or op) name within
    its category, ``attention_ms`` the attention kernels' ms."""
    cats = {c: 0.0 for c in CATEGORIES}
    kernels: dict[str, dict[str, float]] = {c: {} for c in CATEGORIES}
    busy = 0.0
    events = 0
    attention_us = 0.0
    averages = list(prof.key_averages())
    cuda = [ev for ev in averages if _is_cuda_event(ev)]
    if cuda:
        rows = [(ev.key, categorize_kernel_name(ev.key), _device_us(ev),
                 ev.count) for ev in cuda]
    else:
        rows = [(ev.key, categorize_cpu_op(ev.key),
                 float(ev.self_cpu_time_total), ev.count)
                for ev in averages]
    for name, cat, us, count in rows:
        if cat is None or us <= 0.0:
            continue
        cats[cat] += us / 1e6
        busy += us / 1e6
        events += int(count)
        key = _short(name)
        kernels[cat][key] = kernels[cat].get(key, 0.0) + us / 1e3
        if cuda and is_attention_kernel(name):
            attention_us += us
    return {
        "categories": cats,
        "device_busy_s": busy,
        "events": events,
        "kernels": kernels,
        "attention_ms": attention_us / 1e3,
    }


_NOISE = re.compile(
    r"\b(void|at::|native::|\(anonymous namespace\)::|c10::|detail::|"
    r"binary_internal::|gpu_kernel_impl_nocast|memory::|"
    r"LoadWithoutCast|StoreWithoutCast|TrivialOffsetCalculator|"
    r"OffsetCalculator)")


def brief(name: str, chars: int = 72) -> str:
    """A kernel name for a printed table: the launch's own name and the
    functors or lambdas in its template, namespaces dropped."""
    head, _, rest = name.partition("<")
    head = _NOISE.sub("", head).strip()
    parts = []
    for word in re.findall(r"[A-Za-z_][A-Za-z0-9_]*", rest):
        if ("Functor" in word or word.endswith(("Op", "Ops", "copy",
                                                  "_kernel", "_cuda"))
                or word.startswith("launch_")) and word not in parts:
            parts.append(word)
    return (head + (f"[{' '.join(parts)}]" if parts else ""))[:chars]


def largest(measured: dict, category: str, n: int = 8) -> list[tuple]:
    """The ``n`` kernels of ``category`` with the most ms, largest first."""
    items = measured["kernels"][category].items()
    return sorted(items, key=lambda kv: -kv[1])[:n]
