"""RLModule: the policy/value network as a functional torch (init, forward)
pair (port of ray_tpu/rl/module.py).

The reference's RLModule (reference: rllib/core/rl_module/rl_module.py) is
a torch nn.Module with forward_inference/forward_train methods; here the
module is functional, as ``models/llama.py`` is in this package: params
are an explicit tree (dicts and lists) of tensors, so the same weights
move freely between CPU rollout actors (numpy) and the learner (tensors on
its device) without framework glue. Leaf names and the ``[in, out]``
orientation are the JAX package's, so :func:`params_from_jax` carries its
parameters across unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

Params = Any  # tree of tensors: dicts and lists of torch.Tensor


def tree_map(fn: Callable, tree: Params) -> Params:
    """``fn`` over every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Params) -> list:
    """Leaves in the JAX package's order (``jax.tree.leaves``: dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Params, leaves) -> Params:
    """A tree shaped like ``tree`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    return rebuild(tree)


@dataclass(frozen=True)
class RLModule:
    """Base: subclasses define init(generator) and forward(params, obs)."""

    observation_size: int
    num_actions: int

    def init(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    def forward(self, params: Params, obs) -> dict:
        """obs [B, obs_size] -> {"logits": [B, A], "value": [B]}."""
        raise NotImplementedError


def _dense_init(generator: torch.Generator, n_in, n_out, scale=None):
    if scale is None:
        scale = float(np.sqrt(2.0 / n_in))
    w = torch.randn((n_in, n_out), generator=generator,
                    dtype=torch.float32, device=generator.device) * scale
    return {"w": w, "b": torch.zeros((n_out,), dtype=torch.float32,
                                     device=generator.device)}


def _dense(p, x):
    return x @ p["w"] + p["b"]


def _as_input(params: Params, obs) -> torch.Tensor:
    """``obs`` (numpy or a tensor) as fp32 on the params' device."""
    device = tree_leaves(params)[0].device
    return torch.as_tensor(obs, device=device).to(torch.float32)


@dataclass(frozen=True)
class MLPModule(RLModule):
    """Shared-trunk MLP with policy and value heads (the reference's default
    fcnet, rllib/core/models/configs.py MLPHeadConfig)."""

    hidden: tuple = (64, 64)
    dueling: bool = False  # DQN dueling heads: value + advantage

    def init(self, generator: torch.Generator) -> Params:
        trunk = []
        n_in = self.observation_size
        for h in self.hidden:
            trunk.append(_dense_init(generator, n_in, h))
            n_in = h
        return {
            "trunk": trunk,
            "policy": _dense_init(generator, n_in, self.num_actions,
                                  scale=0.01),
            "value": _dense_init(generator, n_in, 1, scale=1.0),
        }

    def forward(self, params: Params, obs) -> dict:
        x = _as_input(params, obs)
        for layer in params["trunk"]:
            x = torch.tanh(_dense(layer, x))
        logits = _dense(params["policy"], x)
        value = _dense(params["value"], x)[..., 0]
        if self.dueling:
            # logits are advantages; combine with state value (dueling DQN).
            logits = value[..., None] + logits - logits.mean(-1, keepdim=True)
        return {"logits": logits, "value": value}


def params_to_numpy(params: Params) -> Params:
    """Device → host copy for shipping weights to CPU rollout actors."""
    return tree_map(lambda a: a.detach().cpu().numpy()
                    if isinstance(a, torch.Tensor) else np.asarray(a),
                    params)


def params_to_torch(params: Params, device="cpu") -> Params:
    """A numpy (or tensor) tree as fp32-preserving tensors on ``device``."""
    return tree_map(
        lambda a: torch.as_tensor(np.array(a, copy=True)).to(device)
        if not isinstance(a, torch.Tensor) else a.detach().to(device),
        params)


def params_from_jax(tree: Params, device="cpu") -> Params:
    """The JAX package's parameters (``ray_tpu.rl`` module ``init``
    output, or any tree of arrays) as tensors on ``device``: each leaf
    crosses as a numpy array, names and orientation unchanged."""
    return params_to_torch(tree, device)
