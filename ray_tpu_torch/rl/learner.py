"""Learner: one update step on the learner's device (port of
ray_tpu/rl/learner.py).

The reference scales learning with DDP across learner actors (reference:
rllib/core/learner/learner_group.py:101, torch DDP per learner); the JAX
package runs one jit program over its device mesh. Here one learner owns
params and optimizer state on one device (a GPU by default in the
algorithms, the CPU for tests): ``update`` runs the loss under
``torch.autograd`` and applies the optimizer (``algorithm.make_adam``:
global-norm clipping, then Adam, written by hand).

A mesh with ``dp`` > 1 (``parallel.make_mesh`` over an initialised
process group: one process per rank) makes this the reference's
data-parallel learner in the port's layout: params drawn from the same
seed on every rank (replicated), each rank taking its ``1 / dp`` of the
batch along each leaf's row axis (``batch_axes``: axis 0 unless the
algorithm names another, as IMPALA and APPO name the env axis of their
[T, N] rollouts), and the gradients and metrics mean-reduced over the dp
group before the optimizer. Where a row axis does not split evenly every
rank takes the whole batch. A loss that is a mean over rows then gives
one learner's result on the whole batch; a statistic of the whole batch
inside a loss (the advantage normalisation of v-trace) is taken through
``dp_mean``. The reference reaches the same answer by laying the batch
out with ``P("dp")`` under one jit of the global loss.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch.rl.module import (
    RLModule,
    params_to_numpy,
    params_to_torch,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

LossFn = Callable[..., tuple[torch.Tensor, dict]]


def _dp_size(mesh) -> int:
    """The size of a DeviceMesh's dp axis (1 without a mesh or axis)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return int(mesh.size(names.index("dp"))) if "dp" in names else 1


def _to_device(x, device: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if not x.flags.writeable:  # a read-only view (a Data batch): copy
        x = x.copy()
    return torch.as_tensor(x, device=device)


class Learner:
    """Owns params + optimizer state on ``device``; update() runs the loss
    fn and one optimizer step."""

    def __init__(
        self,
        module: RLModule,
        loss_fn: LossFn,
        optimizer,
        mesh=None,
        seed: int = 0,
        device: str | torch.device = "cpu",
        batch_axes: dict | None = None,
    ):
        self.module = module
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self.batch_axes = dict(batch_axes or {})
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Learner: device 'cuda' requested but no CUDA GPU is "
                "available; pass device='cpu'")
        generator = torch.Generator().manual_seed(seed)
        self.params = tree_map(lambda t: t.to(self.device),
                               module.init(generator))
        self.opt_state = optimizer.init(self.params)

    def update(self, batch: dict, *extra) -> dict:
        """One step: loss and gradients of ``loss_fn(params, module,
        batch, *extra)``, then the optimizer. Params are replaced by new
        tensors, never written in place (no donation), so aliases a caller
        holds (DQN's target network) keep the values they had."""
        batch = self._shard({k: _to_device(v, self.device)
                             for k, v in batch.items()})
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(self.params)]
        params = tree_unflatten(self.params, leaves)
        loss, aux = self.loss_fn(params, self.module, batch, *extra)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = self._mean_over_dp([torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)])
        with torch.no_grad():
            new, self.opt_state, grad_norm = self.optimizer.update(
                grads, self.opt_state, [p.detach() for p in leaves])
        self.params = tree_unflatten(self.params, new)
        aux["loss"] = loss
        values = torch.stack([
            torch.as_tensor(v, device=self.device).detach().float()
            for v in aux.values()])
        # The shards' metrics averaged; the norm is of the reduced grads.
        values = torch.cat([self._mean_over_dp([values])[0],
                            grad_norm.detach().float().reshape(1)])
        # One host read for every metric (a sync on the GPU).
        return dict(zip([*aux, "grad_norm"], values.tolist()))

    def _shard(self, batch: dict) -> dict:
        """This rank's ``1 / dp`` of every leaf along its row axis under a
        dp mesh; the whole batch where some row axis does not split
        evenly (every rank then computes the same whole-batch loss)."""
        dp = _dp_size(self.mesh)
        axes = {k: self.batch_axes.get(k, 0) for k in batch}
        if dp == 1 or any(x.ndim > axes[k] and x.shape[axes[k]] % dp
                          for k, x in batch.items()):
            return batch
        r = self.mesh.get_local_rank("dp")

        def rows(k, x):
            if x.ndim <= axes[k]:
                return x
            n = x.shape[axes[k]] // dp
            return x.narrow(axes[k], r * n, n)

        return {k: rows(k, x) for k, x in batch.items()}

    def dp_mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (no gradient) averaged over the dp ranks: a loss takes a
        whole-batch mean of equal shards through it (``t`` itself without
        a dp mesh)."""
        return self._mean_over_dp([t.detach()])[0]

    def _mean_over_dp(self, tensors: list) -> list:
        """``tensors`` averaged over the dp group: one all-reduce of their
        concatenation (no mesh or dp = 1: unchanged)."""
        dp = _dp_size(self.mesh)
        if dp == 1:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        torch.distributed.all_reduce(flat, group=self.mesh.get_group("dp"))
        flat = flat / dp
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return out

    def get_weights(self) -> Any:
        """Host numpy copy for broadcast to CPU env runners."""
        return params_to_numpy(self.params)

    def set_weights(self, params: Any) -> None:
        self.params = params_to_torch(params, self.device)
