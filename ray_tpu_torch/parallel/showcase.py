"""Composed parallelism in one mesh: pp x ep x fsdp (port of
ray_tpu/parallel/showcase.py).

A minimal but complete composition of the three mechanisms a large run
stacks: GPipe pipeline stages (pp) whose bodies are expert-parallel blocks
(ep: each rank runs its own experts, the combine summed over ep) with a
ZeRO-3-sharded dense weight (fsdp: gathered at use), the batch cut over
fsdp. ``composed_trainer_loop`` drives it through the trainer's session
and gradient bucketer, as the reference drives it through its
JaxTrainer.
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


def composed_trainer_loop(config):
    """train_loop_per_worker for TorchTrainer: the composed {pp: 2, ep: 2,
    fsdp: N} mesh over the trainer's process group (start the trainer
    with ``ScalingConfig(distributed=True)``; ``dist_backend="gloo"`` for
    CPU workers or several workers on one card), and real optimizer steps
    of the composed program, reporting metrics and a rank-0 checkpoint
    (``params.npz``) through the Train session.

    The reference's single worker holds the whole mesh on its devices; a
    mesh here is one rank per process, so ``num_workers`` is the mesh's
    4 N ranks. Each step is a ``train.step_span`` with compute and
    collective phases: the loss mean over every worker through a
    recorded collective (what the head's goodput ledger attributes as
    comm), and with ``ScalingConfig(grad_overlap=True)`` the bucketed
    async gradient sync over every worker, issued in the compute phase
    and joined before the update, then divided by the world size, as
    the reference's is. The gradients are already whole on every rank of
    the mesh, so that mean leaves them as they are (the reference's
    single worker averages over itself); its buckets, the
    ``grad_buckets`` metric, are the same.

    ``config``: ``fsdp`` (N), ``steps`` (default 2), ``device`` (default
    "cuda"), and optionally ``params``, the starting parameters as numpy
    arrays (:func:`composed_params_from_jax`; default: drawn from seed 7
    on the device)."""
    import os
    import tempfile

    import ray_tpu_torch.train as train
    from ray_tpu_torch import collective as cols
    from ray_tpu_torch.parallel.mesh import make_mesh

    ctx = train.get_context()
    if not torch.distributed.is_initialized():
        raise RuntimeError(
            "composed_trainer_loop builds its mesh on the trainer's process "
            "group: start TorchTrainer with ScalingConfig(distributed=True)")
    dev = resolve_device(config.get("device", "cuda"))
    fsdp, world, rank = int(config["fsdp"]), ctx.get_world_size(), \
        ctx.get_world_rank()
    if world != 4 * fsdp:
        raise ValueError(f"composed_trainer_loop: {world} workers for the "
                         f"{4 * fsdp} ranks of {{pp: 2, ep: 2, fsdp: {fsdp}}}")
    mesh = make_mesh({"pp": 2, "ep": 2, "fsdp": fsdp}, device_type=dev.type)
    if "params" in config:
        params = composed_params_from_jax(config["params"], dev)
    else:
        params = make_composed_params(
            torch.Generator(dev).manual_seed(7), dev)
    # Attempt-scoped group name: an elastic retry must not rendezvous
    # with a dead attempt's KV keys.
    gname = f"composed_sync{ctx.attempt}"
    cols.init_collective_group(world, rank, backend="cpu", group_name=gname)
    overlap = bool(train.grad_sync_opts().get("overlap"))
    n_buckets = 0
    try:
        for step in range(int(config.get("steps", 2))):
            with train.step_span() as sp:
                pending = None
                with sp.phase("compute"):
                    loss, grads = composed_value_and_grad(params, mesh)
                    if overlap:
                        bucketer = train.grad_bucketer(group_name=gname)
                        pending = bucketer.sync_async(grads)
                        # In-flight buckets overlap this remaining
                        # compute (the gradient norm: one host read).
                        sq = sum(torch.sum(g * g) for g in grads.values())
                        # tpulint: allow(TPU601 reason=deliberate - this single scalar read IS the remaining in-phase work the in-flight buckets overlap with; phase 17c checks exposed comm against exactly this probe)
                        gnorm = float(torch.sqrt(sq))
                with sp.phase("collective"):
                    mean_loss = cols.allreduce(
                        np.asarray([float(loss)], np.float32),
                        group_name=gname,
                    )[0] / max(1, world)
                    if pending is not None:
                        # Join tail: only what did not finish during
                        # compute shows up as exposed comm.
                        synced = bucketer.unflatten(grads, pending.wait())
                        grads = {k: v / world for k, v in synced.items()}
                        n_buckets = len(pending.buckets)
                with sp.phase("compute"):
                    params = {k: p - 0.1 * grads[k]
                              for k, p in params.items()}
            ckpt = None
            if rank == 0:
                ckpt = tempfile.mkdtemp(prefix="composed_ck_")
                # tpulint: allow(TPU601 reason=the checkpoint is the step's declared host copy, made after the step span closes, by rank 0 only)
                host = {k: v.detach().cpu().numpy() for k, v in params.items()}
                np.savez(os.path.join(ckpt, "params.npz"), **host)
            metrics = {"loss": float(mean_loss), "step": step,
                       "mesh": {"pp": 2, "ep": 2, "fsdp": fsdp}}
            if overlap:
                metrics["grad_buckets"] = n_buckets
                metrics["grad_norm"] = gnorm
            train.report(metrics, checkpoint=ckpt)
    finally:
        cols.destroy_collective_group(gname)
