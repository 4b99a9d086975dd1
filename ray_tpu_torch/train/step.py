"""Next-token-prediction train step for the flagship model, on one device
(port of ray_tpu/train/step.py).

forward (remat) -> chunked cross-entropy -> backward -> AdamW, eagerly.
Where the reference compiles one program and donates the state, the port
updates the parameters and optimizer moments in place. The optimizer is
written out by hand to reproduce the reference's optax chain
(``clip_by_global_norm`` then ``adamw`` on a warmup-cosine schedule):
``torch.optim.AdamW`` has no bf16 first moment and ``clip_grad_norm_``
adds 1e-6 to the norm, so neither gives the same numbers.

The MoE model (models/moe.py) trains through the same entry points: an
``MoEConfig`` selects its parameters and its loss, cross-entropy plus the
load-balance loss. Meshes of more than one device, ring/ulysses attention
and the device-memory ledger claims are not ported yet (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import mesh_size, resolve_device
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    forward_with_aux,
    init_params,
)
from ray_tpu_torch.models.moe import MoEConfig, init_moe_params, moe_forward
from ray_tpu_torch.ops.flash_attention import make_flash_attention

Params = dict[str, Any]


def _flatten(tree: Params, prefix: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) pairs in the reference's leaf order (sorted keys)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def _unflatten(items) -> Params:
    out: Params = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32 (the
    reference's ``optax.global_norm``, summed leaf by leaf in its order)."""
    sq = (t.float().square().sum() for _, t in _flatten(tree))
    return torch.sqrt(sum(sq))


def _as_dtype(x: float, dtype: torch.dtype) -> float:
    """A Python float rounded to ``dtype``, as JAX rounds a weakly typed
    constant to the dtype of the array it multiplies."""
    return float(torch.tensor(x, dtype=dtype))


class TrainState(NamedTuple):
    step: int
    params: Params
    opt_state: Any


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied so far
    mu: Params  # first moment, stored in mu_dtype
    nu: Params  # second moment, fp32


class AdamW:
    """clip_by_global_norm(grad_clip), then AdamW (b1 0.9, b2 0.95, eps
    1e-8) with decoupled weight decay on every leaf and the learning rate
    of :meth:`schedule`: the reference's optax chain, operation by
    operation.

    - The clip scales every gradient by clip / norm (divide, then
      multiply) only when the global norm is >= grad_clip; no epsilon.
    - mu and nu are fp32 moving averages; mu is stored in ``mu_dtype``
      after the update, which uses the fp32 value. With a bf16 mu, optax's
      ``b1 * mu`` takes b1 in bf16 (0.8984375), the product in fp32 once
      compiled; so does this. Bias correction uses the incremented count.
    - update = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * param, times
      -lr; the learning rate is read at the count before the increment,
      so the first update runs at lr 0 when warmup > 0.
    """

    b1, b2, eps = 0.9, 0.95, 1e-8

    def __init__(self, lr: float = 3e-4, warmup: int = 100,
                 total_steps: int = 10000, weight_decay: float = 0.1,
                 grad_clip: float = 1.0, mu_dtype: torch.dtype | None = None):
        self.lr, self.warmup, self.total_steps = lr, warmup, total_steps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.mu_dtype = mu_dtype

    def schedule(self, count: int) -> float:
        """``optax.warmup_cosine_decay_schedule(0, lr, warmup,
        max(total_steps, warmup + 1), 0.1 * lr)`` at ``count``, with the
        same fp32 operations."""
        f = np.float32
        lr, warmup = self.lr, self.warmup
        if count < warmup:  # linear from 0 to lr
            frac = f(1) - f(min(max(count, 0), warmup)) / f(warmup)
            return float(f(0.0 - lr) * frac + f(lr))
        alpha = 0.0 if lr == 0.0 else lr * 0.1 / lr
        steps = max(self.total_steps, warmup + 1) - warmup
        t = f(min(count - warmup, steps))
        cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * t / f(steps)))
        return float(f(lr) * (f(1 - alpha) * cosine + f(alpha)))

    def init(self, params: Params) -> AdamWState:
        def zeros(dtype=None):
            return _unflatten(
                (path, torch.zeros_like(t, dtype=dtype or t.dtype,
                                        requires_grad=False))
                for path, t in _flatten(params)
            )

        return AdamWState(0, zeros(self.mu_dtype), zeros())

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: AdamWState,
              grad_norm: torch.Tensor | None = None) -> AdamWState:
        """Update ``params`` and the moments of ``state`` in place from
        ``grads``; returns the state with the count advanced. Pass
        ``grad_norm`` when the caller has computed it already."""
        g_norm = global_norm(grads) if grad_norm is None else grad_norm
        keep = g_norm < self.grad_clip
        one = torch.ones_like(g_norm)
        denom = torch.where(keep, one, g_norm)
        mult = torch.where(keep, one, torch.full_like(g_norm, self.grad_clip))
        b1, b2, f = self.b1, self.b2, np.float32
        count = state.count + 1
        bc1 = float(f(1) - f(b1) ** f(count))
        bc2 = float(f(1) - f(b2) ** f(count))
        neg_lr = -self.schedule(state.count)
        for (_, p), (_, g), (_, mu), (_, nu) in zip(
            _flatten(params), _flatten(grads), _flatten(state.mu),
            _flatten(state.nu),
        ):
            g = g.float() / denom * mult
            mu32 = g * (1 - b1) + mu.float() * _as_dtype(b1, mu.dtype)
            nu.copy_(g.square() * (1 - b2) + nu * b2)
            u = (mu32 / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_((u + p * self.weight_decay) * neg_lr)
            mu.copy_(mu32)
        return AdamWState(count, state.mu, state.nu)


def _from_numpy(x, device: torch.device) -> torch.Tensor:
    """A copy of a numpy array as a tensor of the same dtype on
    ``device`` (never a view: the port updates its state in place, and
    the array may be a JAX buffer); a bf16 array (ml_dtypes, as JAX hands
    it over) is carried bit for bit."""
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _adam_state(opt_state):
    """optax's ScaleByAdamState (``count``, ``mu``, ``nu``) inside the
    reference's clip-then-adamw chain state, found by its fields."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, device: str | torch.device = "cuda"
                         ) -> TrainState:
    """The reference's train state, passed as numpy (``jax.tree.map(
    np.asarray, state)``: ``step``, the parameter tree and optax's
    ``(clip, (adam, ..., schedule))`` state), as the port's
    :class:`TrainState` on ``device``. Every leaf keeps its dtype: fp32
    parameters (requiring grad), mu in its ``mu_dtype`` (bf16 under
    ``mu_dtype=bfloat16``), fp32 nu. The dense and the MoE trees both
    carry over, leaf for leaf; the step and adam's count become ints."""
    dev = resolve_device(device)
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("train_state_from_jax: no adamw state (count, mu, "
                         "nu) in opt_state")

    def tree(t, grad=False):
        return _unflatten((path, _from_numpy(leaf, dev).requires_grad_(grad))
                          for path, leaf in _flatten(t))

    params = tree(state.params, grad=True)
    return TrainState(int(state.step), params,
                      AdamWState(int(adam.count), tree(adam.mu),
                                 tree(adam.nu)))


def train_state_dict(state: TrainState) -> dict[str, torch.Tensor]:
    """``state`` as named tensors, for a checkpoint: "params/<path>",
    "mu/<path>" and "nu/<path>" (paths joined by "/", in the reference's
    leaf order), and "step" and "count" as 0-d int64 tensors. The
    tensors are the state's own, detached (no copy)."""
    out = {"step": torch.tensor(state.step, dtype=torch.int64),
           "count": torch.tensor(state.opt_state.count, dtype=torch.int64)}
    for name, tree in (("params", state.params), ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        for path, t in _flatten(tree):
            out["/".join((name, *path))] = t.detach()
    return out


def train_state_from_dict(flat: dict[str, torch.Tensor]) -> TrainState:
    """The inverse of :func:`train_state_dict`, on the tensors' own
    devices: parameters require grad, as :func:`init_train_state`'s."""
    trees: dict[str, list] = {"params": [], "mu": [], "nu": []}
    for key, t in flat.items():
        if key in ("step", "count"):
            continue
        name, *path = key.split("/")
        if name not in trees:
            raise KeyError(f"train_state_from_dict: unknown entry {key!r}")
        trees[name].append((tuple(path), t))
    params = _unflatten((path, t.requires_grad_(True))
                        for path, t in trees["params"])
    return TrainState(int(flat["step"]), params,
                      AdamWState(int(flat["count"]), _unflatten(trees["mu"]),
                                 _unflatten(trees["nu"])))


def make_optimizer(
    lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10000,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    mu_dtype: torch.dtype | None = None,
) -> AdamW:
    """``mu_dtype=torch.bfloat16`` halves the first-moment memory (the
    variance stays fp32), as in the reference."""
    return AdamW(lr, warmup, total_steps, weight_decay, grad_clip, mu_dtype)


def init_train_state(
    cfg: LlamaConfig,
    optimizer: AdamW,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> TrainState:
    """fp32 parameters from ``seed`` on ``device`` (``init_moe_params`` for
    an ``MoEConfig``, else ``init_params``: the reference's
    ``_model_fns``), requiring grad, and a fresh optimizer state."""
    init = init_moe_params if isinstance(cfg, MoEConfig) else init_params
    params = init(cfg, seed, device=device)
    for _, t in _flatten(params):
        t.requires_grad_(True)
    return TrainState(0, params, optimizer.init(params))


def _ce_chunk(x, lm_head, targets, dtype):
    logits = (x @ lm_head.to(dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (logz - tgt).sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,  # [B, S, d] final-norm hidden states
    lm_head: torch.Tensor,  # [d, V]
    targets: torch.Tensor,  # [B, S] int
    dtype: torch.dtype,
    chunk: int = 1024,
) -> torch.Tensor:
    """Mean next-token CE without materializing [B, S, V] logits: one
    checkpointed projection per sequence chunk, so forward and backward
    hold one chunk's [B, chunk, V] logits at a time. A chunk that does not
    divide S becomes its largest divisor, or S itself below 128 (the
    reference's rule)."""
    b, s, _ = hidden.shape
    if s % chunk:
        chunk = next(c for c in range(min(chunk, s), 0, -1) if s % c == 0)
        if chunk < 128:
            chunk = s
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, s, chunk):
        total = total + checkpoint(
            _ce_chunk, hidden[:, i:i + chunk], lm_head,
            targets[:, i:i + chunk], dtype, use_reentrant=False,
            preserve_rng_state=False,
        )
    return total / (b * s)


def loss_fn(
    params: Params,
    batch: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    attn_fn=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token cross entropy. batch["tokens"]: [B, S+1] int. For an
    ``MoEConfig`` the loss is cross entropy plus the load-balance loss,
    reported as ``metrics["aux_loss"]`` (``metrics["loss"]`` stays the
    cross entropy)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    moe = isinstance(cfg, MoEConfig)
    forward = moe_forward if moe else forward_with_aux
    hidden, aux = forward(
        params, inputs, cfg, attn_fn=attn_fn, return_hidden=True
    )
    ce = chunked_cross_entropy(hidden, params["lm_head"], targets, cfg.dtype)
    metrics = {"loss": ce, "perplexity": torch.exp(ce)}
    if not moe:
        return ce, metrics
    metrics["aux_loss"] = aux
    return ce + aux, metrics


def grad_step(cfg: LlamaConfig, attn_fn=None):
    """The forward+backward half of the train step (counterpart of the
    reference's ``jit_grad_step``): ``(params, batch) -> (metrics,
    grads)``, grads a tree like ``params``. Leaves that do not require
    grad are differentiated through detached views; ``params`` is left
    as it is."""

    def step(params: Params, batch: dict[str, torch.Tensor]):
        paths, leaves = zip(*(
            (path, t if t.requires_grad else t.detach().requires_grad_())
            for path, t in _flatten(params)
        ))
        loss, metrics = loss_fn(_unflatten(zip(paths, leaves)), batch, cfg,
                                attn_fn)
        grads = torch.autograd.grad(loss, leaves)
        return ({k: v.detach() for k, v in metrics.items()},
                _unflatten(zip(paths, grads)))

    return step


def make_train_step(cfg: LlamaConfig, optimizer: AdamW, attn_fn=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are 0-dim tensors ``loss``, ``perplexity``, ``grad_norm`` (before the
    clip) and, for an MoE model, ``aux_loss``. The parameters and moments
    are updated in place."""
    grads_of = grad_step(cfg, attn_fn)

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        metrics, grads = grads_of(state.params, batch)
        metrics["grad_norm"] = global_norm(grads)
        opt_state = optimizer.apply(state.params, grads, state.opt_state,
                                    metrics["grad_norm"])
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return train_step


def jit_train_step(cfg: LlamaConfig, optimizer: AdamW, mesh=None):
    """The train step for ``cfg.attn_impl`` on one device: "flash" runs the
    flash kernels (:func:`make_flash_attention`), "dense" the plain
    attention. (The name is the reference's; PyTorch runs eagerly.)"""
    if mesh_size(mesh) > 1:
        raise NotImplementedError(
            "jit_train_step: meshes of more than one device are not ported "
            "yet (ROADMAP.md, Queue 1)"
        )
    if cfg.attn_impl == "flash":
        attn_fn = make_flash_attention(mesh)
    elif cfg.attn_impl == "dense":
        attn_fn = None
    elif cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported yet (ROADMAP.md, "
            "Queue 1)"
        )
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return make_train_step(cfg, optimizer, attn_fn=attn_fn)
