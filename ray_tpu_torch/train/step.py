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
load-balance loss.

Under a mesh of more than one rank (parallel/mesh.py; one process per
device), :func:`jit_train_step` runs the same step on every rank, SPMD:
the parameters and both AdamW moments are DTensors placed by
:func:`state_logical_axes` (fsdp on ``embed``, tp on ``heads``,
``kv_heads``, ``mlp`` and ``vocab``, ep on ``expert``), the batch is cut
on ``batch``, each rank computes on its shards (weights sharded over fsdp
gathered at use: ZeRO-3), each gradient arrives reduced over the data
axes with its parameter's placements, :func:`global_norm` is the norm of
the whole tensors, and AdamW updates the local shards. On a mesh with
pp > 1 every pp rank runs the same step: the Llama leaves carry
"layers", not "stage", so they and the batch are replicated over pp, as
under the reference's partitioner (a pipelined step goes through
parallel/pipeline.py). The device-memory ledger claims are not ported
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import mesh_size, resolve_device
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    forward_with_aux,
    init_params,
    param_logical_axes,
    use_params,
    vocab_logits,
)
from ray_tpu_torch.models.moe import (
    MoEConfig,
    init_moe_params,
    moe_forward,
    moe_param_logical_axes,
)
from ray_tpu_torch.ops.flash_attention import make_flash_attention
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import MESH_AXES
from ray_tpu_torch.parallel.ring_attention import make_ring_attention
from ray_tpu_torch.parallel.sharding import (
    DATA_AXES,
    active_mesh,
    constrain,
    current_scope,
    distribute,
    local,
    logical_spec,
    mesh_scope,
    shard_pytree,
    use_mesh,
)
from ray_tpu_torch.parallel.ulysses import make_ulysses_attention

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
    reference's ``optax.global_norm``, summed leaf by leaf in its order).
    For DTensor leaves, the norm of the whole tensors: each rank sums its
    shard's squares, and a leaf's sum is added up over the mesh axes it is
    sharded on only (summing over an axis it is replicated on would count
    it once per rank)."""
    leaves = [t for _, t in _flatten(tree)]
    if not any(isinstance(t, DTensor) for t in leaves):
        return torch.sqrt(sum(t.float().square().sum() for t in leaves))
    mesh = leaves[0].device_mesh
    by_axes: dict[tuple[str, ...], torch.Tensor] = {}
    for t in leaves:
        axes = tuple(a for a, p in zip(MESH_AXES, t.placements)
                     if isinstance(p, Shard))
        sq = local(t).float().square().sum()
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    with torch.no_grad():
        total = sum(col.reduce_from(sq, mesh, axes)
                    for axes, sq in by_axes.items())
    return torch.sqrt(total)


def _zeros_like(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of ``t``'s shape in ``dtype``; a DTensor's keep its mesh and
    placements (allocated as shards)."""
    if isinstance(t, DTensor):
        return DTensor.from_local(
            torch.zeros_like(t.to_local(), dtype=dtype), t.device_mesh,
            t.placements, run_check=False)
    return torch.zeros_like(t, dtype=dtype, requires_grad=False)


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
                (path, _zeros_like(t.detach(), dtype or t.dtype))
                for path, t in _flatten(params)
            )

        return AdamWState(0, zeros(self.mu_dtype), zeros())

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: AdamWState,
              grad_norm: torch.Tensor | None = None) -> AdamWState:
        """Update ``params`` and the moments of ``state`` in place from
        ``grads``; returns the state with the count advanced. Pass
        ``grad_norm`` when the caller has computed it already. DTensors
        are updated shard by shard (every operation is elementwise; the
        clip's norm is the whole tensors')."""
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
            p, g, mu, nu = (local(t) for t in (p, g, mu, nu))
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


def _model_fns(cfg: LlamaConfig):
    """(init, logical_axes) for the config's model family: dense Llama or
    MoE (the reference's ``_model_fns``)."""
    if isinstance(cfg, MoEConfig):
        return init_moe_params, moe_param_logical_axes
    return init_params, param_logical_axes


def state_logical_axes(cfg: LlamaConfig, optimizer: AdamW) -> TrainState:
    """Logical axes of every leaf of :class:`TrainState`: the moments mirror
    their parameter's axes, the step and the count get ()."""
    del optimizer  # the moments are param-shaped, leaf for leaf
    p_axes = _model_fns(cfg)[1](cfg)
    return TrainState((), p_axes, AdamWState((), p_axes, p_axes))


def init_train_state(
    cfg: LlamaConfig,
    optimizer: AdamW,
    seed: int = 0,
    device: str | torch.device = "cuda",
    mesh=None,
) -> TrainState:
    """fp32 parameters from ``seed`` on ``device`` (``init_moe_params`` for
    an ``MoEConfig``, else ``init_params``: the reference's
    ``_model_fns``), requiring grad, and a fresh optimizer state. Under a
    mesh of more than one rank every rank draws the same parameters and
    keeps its shards: DTensors placed by :func:`state_logical_axes`."""
    init, logical_axes = _model_fns(cfg)
    params = init(cfg, seed, device=device)
    if mesh_size(mesh) > 1:
        params = shard_pytree(params, mesh, logical_axes(cfg))
    for _, t in _flatten(params):
        t.requires_grad_(True)
    return TrainState(0, params, optimizer.init(params))


def _ce_chunk(x, lm_head, targets, dtype, scope=None):
    with mesh_scope(scope):
        logits = vocab_logits(x, lm_head, dtype)
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
    reference's rule). Under a mesh whose tp splits the vocabulary,
    ``lm_head`` is this rank's columns and each chunk's logits are
    gathered over tp."""
    b, s, _ = hidden.shape
    if s % chunk:
        chunk = next(c for c in range(min(chunk, s), 0, -1) if s % c == 0)
        if chunk < 128:
            chunk = s
    total = hidden.new_zeros((), dtype=torch.float32)
    scope = current_scope()
    for i in range(0, s, chunk):
        total = total + checkpoint(
            _ce_chunk, hidden[:, i:i + chunk], lm_head,
            targets[:, i:i + chunk], dtype, scope, use_reentrant=False,
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
    cross entropy).

    Under a mesh (``use_mesh``) the parameters are DTensors and
    ``tokens`` this rank's batch shard; the loss and the metrics are the
    whole batch's, the same on every rank, and each rank's backward gives
    its own share of every gradient."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    moe = isinstance(cfg, MoEConfig)
    forward = moe_forward if moe else forward_with_aux
    hidden, aux = forward(
        params, inputs, cfg, attn_fn=attn_fn, return_hidden=True
    )
    lm_head = params["lm_head"]
    mesh = active_mesh()
    if mesh is not None:
        hidden = hidden.to_local()
        targets = col.local_chunk(targets, mesh, "sp", 1)
        lm_head = use_params({"lm_head": lm_head},
                             {"lm_head": ("embed", "vocab")}, cfg,
                             mesh)["lm_head"]
    ce = chunked_cross_entropy(hidden, lm_head, targets, cfg.dtype)
    if mesh is not None:
        ce = col.reduce_from(ce, mesh, DATA_AXES, mean=True)
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


def jit_train_step(cfg: LlamaConfig, optimizer: AdamW, mesh=None,
                   batch_axes: tuple = ("batch", None)):
    """The train step for ``cfg.attn_impl``: "flash" runs the flash kernels
    (:func:`make_flash_attention`), "dense" the plain attention, "ring"
    and "ulysses" the sequence-parallel attentions over the mesh's sp.
    (The name is the reference's; PyTorch runs eagerly.)

    A mesh of one rank (or None) returns the plain step, as the reference
    does. Under a larger mesh every rank calls the step with the state of
    :func:`init_train_state` (``mesh=``) or :func:`shard_pytree` by
    :func:`state_logical_axes`, and the batch: a DTensor, or the whole
    batch, the same on every rank; ``batch_axes`` places the tokens
    [B, S+1] (the sequence is cut over sp inside the model)."""
    if cfg.attn_impl == "flash":
        attn_fn = make_flash_attention(mesh)
    elif cfg.attn_impl == "dense":
        attn_fn = None
    elif cfg.attn_impl == "ring":
        attn_fn = make_ring_attention(mesh)
    elif cfg.attn_impl == "ulysses":
        attn_fn = make_ulysses_attention(mesh)
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    step = make_train_step(cfg, optimizer, attn_fn=attn_fn)
    if mesh_size(mesh) == 1:
        return step
    placements = logical_spec(batch_axes)

    def step_in_mesh(state: TrainState, batch: dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        with use_mesh(mesh):
            if isinstance(tokens, DTensor):
                tokens = constrain(tokens, *batch_axes).to_local()
            else:
                tokens = distribute(tokens, mesh, placements).to_local()
            return step(state, {"tokens": tokens})

    return step_in_mesh
