"""ResNet for image classification (port of ray_tpu/models/resnet.py).

The same pure function of (params, batch) as the reference: GroupNorm in
place of BatchNorm (no running statistics, and normalization independent
of how data parallelism cuts the batch), images ``[B, H, W, 3]`` in,
fp32 logits out. Convolutions are ``F.conv2d``, plain torch: the
reference leaves them to XLA (``lax.conv_general_dilated``), so no
hand-written kernel stands in for one. On the card they run in
``channels_last`` (NHWC in memory, the layout the reference computes in)
on cuDNN.

Weights are OIHW (torch's layout); the leaf names and the list of blocks
are the reference's, whose HWIO weights :func:`params_from_jax` turns
into these. Where the reference pads SAME, so does this port, explicitly:
at stride 2 SAME pads ``total // 2`` before and the rest after (a 3x3
stride-2 conv on 32 pixels pads 0 and 1), where ``F.conv2d(padding=)``
pads both sides alike; the stem's max pool pads with -inf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device

Params = Any
# The 4-D leaves: convolution weights, OIHW here and HWIO in the reference.
CONV_LEAVES = ("stem", "conv1", "conv2", "conv3", "proj")


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (2, 2, 2, 2)  # ResNet-18 layout
    widths: tuple = (64, 128, 256, 512)
    num_classes: int = 10
    groups: int = 32  # GroupNorm groups (clamped per width)
    dtype: torch.dtype = torch.bfloat16
    stem_kernel: int = 3  # 3 for CIFAR-sized inputs, 7 for ImageNet
    stem_stride: int = 1  # 2 + stem_pool for the ImageNet 4x stem
    stem_pool: bool = False  # stride-2 3x3 maxpool after the stem
    bottleneck: bool = False  # True -> 3-layer blocks (ResNet-50 style)

    @property
    def stem_width(self) -> int:
        return 64 if self.bottleneck else self.widths[0]

    def num_params(self) -> int:
        return sum(math.prod(s) for s in _leaves(param_shapes(self)))


PRESETS = {
    "resnet18": ResNetConfig(),
    "resnet50": ResNetConfig(
        stage_sizes=(3, 4, 6, 3),
        widths=(256, 512, 1024, 2048),
        bottleneck=True,
        stem_kernel=7,
        stem_stride=2,  # + maxpool = the canonical 4x ImageNet stem
        stem_pool=True,
        num_classes=1000,
    ),
    # Tiny config for unit tests / dry runs.
    "tiny": ResNetConfig(
        stage_sizes=(1, 1), widths=(8, 16), groups=4, num_classes=10
    ),
}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree, name=None):
    """``fn(leaf_name, leaf)`` over the tree (a leaf's name is its dict
    key; a list's items keep their parent's)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, name) for v in tree]
    return fn(name, tree)


def _conv_shape(kh, kw, cin, cout):
    return ("conv", (cout, cin, kh, kw))


def _gn_shape(c):
    return {"scale": ("ones", (c,)), "bias": ("zeros", (c,))}


def _block_shapes(cin, cout, cfg: ResNetConfig):
    if cfg.bottleneck:
        mid = cout // 4
        p = {
            "conv1": _conv_shape(1, 1, cin, mid),
            "gn1": _gn_shape(mid),
            "conv2": _conv_shape(3, 3, mid, mid),
            "gn2": _gn_shape(mid),
            "conv3": _conv_shape(1, 1, mid, cout),
            "gn3": _gn_shape(cout),
        }
    else:
        p = {
            "conv1": _conv_shape(3, 3, cin, cout),
            "gn1": _gn_shape(cout),
            "conv2": _conv_shape(3, 3, cout, cout),
            "gn2": _gn_shape(cout),
        }
    if cin != cout:
        p["proj"] = _conv_shape(1, 1, cin, cout)
        p["gn_proj"] = _gn_shape(cout)
    return p


def _spec(cfg: ResNetConfig):
    """The parameter tree with (kind, shape) leaves, kind one of "conv"
    (He normal), "ones", "zeros", "head" (normal x 0.01)."""
    k = cfg.stem_kernel
    spec: dict = {
        "stem": _conv_shape(k, k, 3, cfg.stem_width),
        "gn_stem": _gn_shape(cfg.stem_width),
        "blocks": [],
    }
    cin = cfg.stem_width
    for n, width in zip(cfg.stage_sizes, cfg.widths):
        for _ in range(n):
            spec["blocks"].append(_block_shapes(cin, width, cfg))
            cin = width
    spec["head"] = {"w": ("head", (cin, cfg.num_classes)),
                    "b": ("zeros", (cfg.num_classes,))}
    return spec


def param_shapes(cfg: ResNetConfig):
    """The parameter tree's shapes (OIHW convolutions), allocating
    nothing."""
    return _map(lambda _, leaf: leaf[1], _spec(cfg))


def init_params(gen: torch.Generator, cfg: ResNetConfig,
                device: str | torch.device = "cuda") -> Params:
    """fp32 parameters drawn from ``gen`` (He-normal convolutions, the
    head's weight normal x 0.01, GroupNorm scales 1 and biases 0), in the
    reference's order of leaves; drawn on ``gen``'s device, then placed on
    ``device``."""
    dev = resolve_device(device)

    def draw(_, leaf):
        kind, shape = leaf
        if kind == "ones":
            t = torch.ones(shape)
        elif kind == "zeros":
            t = torch.zeros(shape)
        else:
            t = torch.randn(shape, generator=gen, device=gen.device)
            fan_in = math.prod(shape[1:])
            t = t * (math.sqrt(2.0 / fan_in) if kind == "conv" else 0.01)
        return t.to(dev, torch.float32)

    return _map(draw, _spec(cfg))


def params_from_jax(tree, device: str | torch.device = "cuda") -> Params:
    """The reference's parameter (or gradient) tree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as fp32 tensors on ``device``:
    HWIO convolutions become OIHW."""
    dev = resolve_device(device)

    def conv(name, x):
        x = np.asarray(x, np.float32)
        if name in CONV_LEAVES:
            x = x.transpose(3, 2, 0, 1)
        return torch.tensor(np.ascontiguousarray(x), device=dev)

    return _map(conv, tree)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """``x`` (NCHW) padded as SAME pads it for a ``k`` x ``k`` window at
    stride ``s``."""
    top, bottom = _same_pads(x.shape[2], k, s)
    left, right = _same_pads(x.shape[3], k, s)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x.contiguous(memory_format=torch.channels_last)


def _conv(w, x, stride=1, dtype=torch.bfloat16):
    """SAME convolution of ``x`` (NCHW, channels_last) by ``w`` (OIHW),
    both cast to ``dtype``; the result in ``dtype``."""
    x = _pad_same(x.to(dtype), w.shape[2], stride)
    w = w.to(dtype).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride)


def _group_norm(p, x, groups):
    """GroupNorm in fp32 (population variance, eps 1e-5), cast back to
    ``x``'s dtype; the group count is clamped to a divisor of the
    width."""
    c = x.shape[1]
    g = min(groups, c)
    while c % g:
        g -= 1
    return F.group_norm(x.float(), g, p["scale"], p["bias"],
                        1e-5).to(x.dtype)


def _block_apply(p, x, stride, cfg: ResNetConfig):
    dtype = cfg.dtype
    residual = x
    if cfg.bottleneck:
        y = _conv(p["conv1"], x, 1, dtype)
        y = F.relu(_group_norm(p["gn1"], y, cfg.groups))
        y = _conv(p["conv2"], y, stride, dtype)
        y = F.relu(_group_norm(p["gn2"], y, cfg.groups))
        y = _conv(p["conv3"], y, 1, dtype)
        y = _group_norm(p["gn3"], y, cfg.groups)
    else:
        y = _conv(p["conv1"], x, stride, dtype)
        y = F.relu(_group_norm(p["gn1"], y, cfg.groups))
        y = _conv(p["conv2"], y, 1, dtype)
        y = _group_norm(p["gn2"], y, cfg.groups)
    if "proj" in p or stride != 1:
        if "proj" in p:
            residual = _conv(p["proj"], residual, stride, dtype)
            residual = _group_norm(p["gn_proj"], residual, cfg.groups)
        else:  # same width, spatial downsample only
            residual = residual[:, :, ::stride, ::stride]
    return F.relu(y + residual.to(y.dtype))


def forward(params: Params, images: torch.Tensor, cfg: ResNetConfig):
    """images [B, H, W, 3] float -> logits [B, num_classes] (fp32)."""
    x = images.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    x = _conv(params["stem"], x, cfg.stem_stride, cfg.dtype)
    x = F.relu(_group_norm(params["gn_stem"], x, cfg.groups))
    if cfg.stem_pool:
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
    bi = 0
    for si, n in enumerate(cfg.stage_sizes):
        for block_i in range(n):
            stride = 2 if (si > 0 and block_i == 0) else 1
            x = _block_apply(params["blocks"][bi], x, stride, cfg)
            bi += 1
    x = x.float().mean(dim=(2, 3))  # global average pool
    return x @ params["head"]["w"] + params["head"]["b"]


def loss_fn(params, batch, cfg: ResNetConfig):
    """Softmax cross entropy; batch = {"images": [B,H,W,3],
    "labels": [B]}."""
    logits = forward(params, batch["images"], cfg)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, -1)
    ll = torch.gather(logp, -1, labels[:, None])
    acc = (logits.argmax(-1) == labels).float().mean()
    return -ll.mean(), {"accuracy": acc}
