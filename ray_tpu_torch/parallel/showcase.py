"""Composed parallelism in one mesh: pp x ep x fsdp (port of
ray_tpu/parallel/showcase.py).

A minimal but complete composition of the three mechanisms a large run
stacks: GPipe pipeline stages (pp) whose bodies are expert-parallel blocks
(ep: each rank runs its own experts, the combine summed over ep) with a
ZeRO-3-sharded dense weight (fsdp: gathered at use), the batch cut over
fsdp. The reference also drives it through its trainer's session and
gradient bucketer (``composed_trainer_loop``); that loop is not ported
yet (ROADMAP.md, Queue 1 item 2), though the trainer, the session and the
bucketer it needs now are.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.parallel.pipeline import mesh_spec, pipeline_loss_fn

N_EXPERTS = 4
D = 8
PP = 2


def make_composed_params(gen: torch.Generator,
                         device: str | torch.device = "cuda"):
    """Normal(0, 0.3) weights drawn from ``gen`` (a generator on
    ``device``): ``experts`` [pp, E, d, d] (stage dim over pp, experts over
    ep) and ``dense`` [pp, d, d] (ZeRO-3 over fsdp, gathered inside the
    stage)."""
    dev = resolve_device(device)
    return {
        "experts": torch.randn((PP, N_EXPERTS, D, D), generator=gen,
                               device=dev) * 0.3,
        "dense": torch.randn((PP, D, D), generator=gen, device=dev) * 0.3,
    }


def composed_params_from_jax(tree, device: str | torch.device = "cuda"):
    """The reference's composed parameters (numpy arrays: ``jax.tree.map(
    np.asarray, params)``) as fp32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
            for k, v in tree.items()}


def composed_param_specs():
    return {
        "experts": mesh_spec("pp", "ep"),
        "dense": mesh_spec("pp", None, "fsdp"),
    }


def _stage_fn(p, x, mesh):  # x: [mb, d]
    # ZeRO-3: the dense weight gathered from its fsdp shards (its last
    # dim, per mesh_spec("pp", None, "fsdp")); its gradient is
    # reduce-scattered back over the fsdp ranks' data.
    w = col.all_gather(p["dense"], mesh, "fsdp", 1)
    x = x + torch.tanh(x @ w)
    # MoE dispatch: token i -> expert (|x_i0| * 100 mod E); each rank runs
    # its LOCAL experts on every token (the gradient of x it computes is
    # partial: summed over ep) and the combine is summed over ep.
    local = p["experts"]  # [E / ep, d, d]
    e_local = local.shape[0]
    ep_idx = axis_index(mesh, "ep") if axis_size(mesh, "ep") > 1 else 0
    xe = col.copy_to(x, mesh, "ep")
    outs = torch.einsum("md,edh->emh", xe, local)  # [E / ep, mb, d]
    assigned = (xe[:, 0].abs() * 100).to(torch.int32) % N_EXPERTS
    local_ids = ep_idx * e_local + torch.arange(e_local, device=x.device)
    mask = assigned[None, :] == local_ids[:, None]  # [E / ep, mb]
    y = torch.sum(outs * mask[..., None], dim=0)
    y = col.reduce_from(y, mesh, "ep")
    return x + torch.tanh(y)


def composed_value_and_grad(params, mesh):
    """One forward + backward of the composed program on ``mesh`` (axes
    pp, ep, fsdp), on every rank. ``params``: whole tensors (the same on
    every rank) or DTensors placed by :func:`composed_param_specs`.
    Returns (loss, grads): the loss the same on every rank; each gradient
    whole and the same on every rank for a whole tensor, a DTensor placed
    like its parameter for a DTensor. The batch is synthesized to fill the
    fsdp axis."""
    fsdp = axis_size(mesh, "fsdp")
    names = sorted(params)
    leaves = [params[k] if params[k].requires_grad
              else params[k].detach().requires_grad_() for k in names]
    dev = leaves[0].device

    def loss_head(y, batch):
        return torch.mean(y**2)

    batch = 2 * fsdp * 2  # microbatches x fsdp shards x mb
    loss = pipeline_loss_fn(
        dict(zip(names, leaves)),
        {"inputs": torch.ones((batch, D), device=dev)},
        functools.partial(_stage_fn, mesh=mesh),
        loss_head,
        mesh=mesh,
        num_microbatches=2,
        param_specs=composed_param_specs(),
    )
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))
