"""``composed_trainer_loop`` (ray_tpu_torch/parallel/showcase.py) through
``TorchTrainer.fit`` on 4 CPU workers: the composed {pp: 2, ep: 2,
fsdp: 1} mesh over the trainer's gloo process group, with the bucketed
overlap gradient sync (``grad_overlap``, 1 KiB buckets).

The reference dry run's checks (__graft_entry__.py, its JaxTrainer run
of the same loop): no error, a checkpoint holding ``params.npz``, at
least 2 gradient buckets, a finite loss, and the head's train ledger
showing exposed comm. The parity: from the reference's starting
parameters (``make_composed_params(jax.random.key(7))``), the last
step's loss and gradient norm and every checkpointed step's parameters
within 1e-5 of the reference loop's arithmetic (``composed_value_and_grad``
on a 4-device mesh, then ``p - 0.1 g``: the gradient sync over one
worker changes nothing).
"""

import glob
import math
import os
import time

import numpy as np
import pytest

from ray_tpu_torch.parallel.showcase import composed_trainer_loop
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
from torch_runtime_util import start_cluster, stop_cluster

STEPS, TOL, NAME = 2, 1e-5, "composed_loop"


@pytest.fixture(scope="module")
def ref():
    """The reference loop's arithmetic: per step the loss, the gradient
    norm, and the parameters after the update."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import make_mesh
    from ray_tpu.parallel.showcase import (
        composed_value_and_grad,
        make_composed_params,
    )

    mesh = make_mesh({"pp": 2, "ep": 2, "fsdp": 1},
                     devices=jax.devices()[:4])
    params = make_composed_params(jax.random.key(7))
    init = jax.tree.map(np.asarray, params)
    steps = []
    for _ in range(STEPS):
        loss, grads = composed_value_and_grad(params, mesh)
        norm = float(jnp.sqrt(sum(jnp.sum(g * g)
                                  for g in jax.tree.leaves(grads))))
        params = jax.tree.map(lambda p, g: p - 0.1 * g, params, grads)
        steps.append(dict(loss=float(loss), grad_norm=norm,
                          params=jax.tree.map(np.asarray, params)))
    return init, steps


@pytest.fixture(scope="module")
def fit(ref, tmp_path_factory):
    init, _ = ref
    storage = str(tmp_path_factory.mktemp("composed"))
    info = start_cluster(num_cpus=5)
    try:
        result = TorchTrainer(
            composed_trainer_loop,
            train_loop_config={"fsdp": 1, "steps": STEPS, "device": "cpu",
                               "params": init},
            scaling_config=ScalingConfig(
                num_workers=4, grad_overlap=True, grad_bucket_mb=0.001,
                distributed=True, dist_backend="gloo"),
            run_config=RunConfig(name=NAME, storage_path=storage),
        ).fit()
        from ray_tpu_torch.util import state

        job, deadline = {}, time.time() + 15
        while time.time() < deadline:
            job = state.train_stats().get("jobs", {}).get(NAME, {})
            if job.get("comm_exposed_s", 0) > 0:
                break
            time.sleep(0.3)
        yield result, job, storage
    finally:
        stop_cluster(info)


def test_composed_loop_dry_run_checks(fit):
    result, job, _ = fit
    assert result.error is None, f"trainer attempt failed: {result.error}"
    assert result.checkpoint is not None, "no checkpoint persisted"
    assert os.path.exists(os.path.join(result.checkpoint, "params.npz"))
    assert result.metrics["grad_buckets"] >= 2, result.metrics
    assert math.isfinite(result.metrics["loss"])
    assert result.metrics["mesh"] == {"pp": 2, "ep": 2, "fsdp": 1}
    assert result.metrics["step"] == STEPS - 1
    assert job.get("comm_exposed_s", 0) > 0, job


def test_composed_loop_matches_reference_loop(ref, fit):
    _, want = ref
    result, _, storage = fit
    np.testing.assert_allclose(result.metrics["loss"], want[-1]["loss"],
                               rtol=TOL)
    np.testing.assert_allclose(result.metrics["grad_norm"],
                               want[-1]["grad_norm"], rtol=TOL)
    saved = sorted(glob.glob(os.path.join(storage, NAME, "*",
                                          "params.npz")))
    assert len(saved) == STEPS
    assert saved[-1] == os.path.join(result.checkpoint, "params.npz")
    for path, w in zip(saved, want):
        with np.load(path) as got:
            assert sorted(got.files) == sorted(w["params"])
            for k in got.files:
                np.testing.assert_allclose(got[k], w["params"][k],
                                           rtol=TOL, atol=TOL, err_msg=k)
