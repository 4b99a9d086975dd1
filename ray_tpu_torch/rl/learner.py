"""Learner: one update step on the learner's device (port of
ray_tpu/rl/learner.py).

The reference scales learning with DDP across learner actors (reference:
rllib/core/learner/learner_group.py:101, torch DDP per learner); the JAX
package runs one jit program over its device mesh. Here one learner owns
params and optimizer state on one device (a GPU by default in the
algorithms, the CPU for tests): ``update`` runs the loss under
``torch.autograd`` and applies the optimizer (``algorithm.make_adam``:
global-norm clipping, then Adam, written by hand). A data-parallel mesh
is not ported: a mesh with ``dp`` > 1 raises.
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
    ):
        if _dp_size(mesh) > 1:
            raise NotImplementedError(
                "Learner: a data-parallel mesh (dp > 1) is not ported; the "
                "learner runs on one device (pass mesh=None)")
        self.module = module
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
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
        batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(self.params)]
        params = tree_unflatten(self.params, leaves)
        loss, aux = self.loss_fn(params, self.module, batch, *extra)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        with torch.no_grad():
            new, self.opt_state, grad_norm = self.optimizer.update(
                grads, self.opt_state, [p.detach() for p in leaves])
        self.params = tree_unflatten(self.params, new)
        aux["loss"] = loss
        aux["grad_norm"] = grad_norm
        # One host read for every metric (a sync on the GPU).
        values = torch.stack([
            torch.as_tensor(v, device=self.device).detach().float()
            for v in aux.values()]).tolist()
        return dict(zip(aux, values))

    def get_weights(self) -> Any:
        """Host numpy copy for broadcast to CPU env runners."""
        return params_to_numpy(self.params)

    def set_weights(self, params: Any) -> None:
        self.params = params_to_torch(params, self.device)
