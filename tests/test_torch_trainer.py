"""The port's Train library on its runtime (ray_tpu_torch/train/trainer.py,
session.py, zero.py, admission.py, telemetry.py) against the JAX
package's, on the CPU.

- ``TorchTrainer`` and ``JaxTrainer`` each train the ``tiny`` preset for 3
  steps from the same weights (the reference's, carried over with
  ``params_from_jax``) and report per-step loss and gradient norm: within
  1e-5 relative, the tolerance of tests/test_torch_train_step.py. The
  reference runs in a subprocess with its own runtime (both runtimes read
  the same ``RAY_TPU_*`` names).
- A fit that checkpoints into the shard store at step 2 and a second fit
  that resumes from it (``resume_from_checkpoint="auto"``) report the
  uninterrupted run's losses.
- Two workers with ``distributed=True`` over gloo build an fsdp=2 mesh on
  the trainer's default process group, restore that checkpoint onto it
  (each rank's shard bit for bit its slice of the saved leaf), and save it
  again from both ranks: the committed manifest is the saved state.
- ``ZeroOptimizer`` on 2 ranks equals the unsharded AdamW update, and the
  admission verdict equals the reference's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.train import (
    RunConfig,
    ScalingConfig,
    TorchTrainer,
    admission,
    zero,
)
from ray_tpu_torch.train import step as tstep
from torch_runtime_util import start_cluster, stop_cluster

REPO = Path(__file__).resolve().parent.parent
LR, WARMUP, TOTAL = 1e-2, 2, 8
STEPS = 3  # the parity run
RESUME_STEPS, SAVE_AT = 4, 2

torch.set_num_threads(1)


def _tokens(n):
    """n batches of 2 x 17 tokens of the tiny preset (vocab 512)."""
    return np.random.default_rng(1).integers(0, 512, size=(n, 2, 17)
                                             ).astype(np.int32)


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


# The reference's run: JaxTrainer, one worker, the tiny preset's jitted
# train step; prints the initial parameters (npz) and the reports.
_REFERENCE = textwrap.dedent('''
    import json, sys
    import numpy as np
    import jax
    import ray_tpu
    from ray_tpu.models import llama
    from ray_tpu.train import JaxTrainer, RunConfig
    from ray_tpu.train import step as jstep

    out, storage, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
    LR, WARMUP, TOTAL = {lr}, {warmup}, {total}

    def loop(config):
        import jax, jax.numpy as jnp
        import ray_tpu.train as train
        from ray_tpu.models import llama
        from ray_tpu.train import step as jstep
        cfg = llama.PRESETS["tiny"]
        opt = jstep.make_optimizer(lr=LR, warmup=WARMUP, total_steps=TOTAL)
        state = jstep.init_train_state(jax.random.key(0), cfg, opt)
        step = jax.jit(jstep.make_train_step(cfg, opt))
        reports = []
        for toks in config["tokens"]:
            state, m = step(state, {{"tokens": jnp.asarray(toks)}})
            reports.append([float(m["loss"]), float(m["grad_norm"])])
            train.report({{"reports": list(reports)}})

    cfg = llama.PRESETS["tiny"]
    opt = jstep.make_optimizer(lr=LR, warmup=WARMUP, total_steps=TOTAL)
    params = jstep.init_train_state(jax.random.key(0), cfg, opt).params
    flat = {{}}
    def walk(t, path=()):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            flat["/".join(path)] = np.asarray(t)
    walk(params)
    np.savez(out + ".npz", **flat)
    tokens = np.random.default_rng(1).integers(
        0, 512, size=(steps, 2, 17)).astype(np.int32)
    ray_tpu.init(num_cpus=2)
    try:
        result = JaxTrainer(
            loop, train_loop_config={{"tokens": tokens}},
            run_config=RunConfig(name="jax_parity", storage_path=storage),
        ).fit()
        assert result.error is None, result.error
        with open(out + ".json", "w") as f:
            json.dump(result.metrics["reports"], f)
    finally:
        ray_tpu.shutdown()
''').format(lr=LR, warmup=WARMUP, total=TOTAL)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(initial parameters as a nested numpy tree, per-step [loss,
    grad_norm]) of the reference's JaxTrainer run."""
    d = tmp_path_factory.mktemp("jax_trainer")
    out = str(d / "ref")
    # The reference's own runtime, on its defaults: no RAY_TPU_* setting
    # of a runtime this test process ran before.
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, out, str(d), str(STEPS)],
        env=env, cwd=str(d), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    params: dict = {}
    with np.load(out + ".npz") as z:
        for key in z.files:
            node = params
            *path, last = key.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[last] = z[key]
    with open(out + ".json") as f:
        return params, json.load(f)


def _torch_loop_factory(lr, warmup, total):
    """The port's train loop: the tiny preset from config["init"] (numpy,
    the reference's weights), resumed from get_checkpoint() when there is
    one, checkpointed into the shard store at config["save_at"], stopped
    after config["stop"] steps; reports every step's [loss, grad_norm]
    since this fit began."""

    def loop(config):
        import torch

        import ray_tpu_torch.train as train
        from ray_tpu_torch import checkpoint as dc
        from ray_tpu_torch.models.llama import PRESETS, params_from_jax
        from ray_tpu_torch.train import step as tstep

        torch.set_num_threads(1)
        cfg = PRESETS["tiny"]
        opt = tstep.make_optimizer(lr=lr, warmup=warmup, total_steps=total)
        params = params_from_jax(config["init"], cfg, "cpu")
        for _, t in tstep._flatten(params):
            t.requires_grad_(True)
        state = tstep.TrainState(0, params, opt.init(params))
        restored = train.get_checkpoint()
        if restored is not None:
            state = dc.restore_uri(restored, target=state)
        step = tstep.jit_train_step(cfg, opt)
        saver = dc.AsyncCheckpointer() if config.get("save_at") else None
        reports = []
        for toks in config["tokens"][state.step:config["stop"]]:
            state, m = step(state, {"tokens": torch.from_numpy(toks)})
            reports.append([float(m["loss"]), float(m["grad_norm"])])
            uri = None
            if saver is not None and state.step == config["save_at"]:
                uri = saver.save(state.step, state)
            train.report({"reports": list(reports), "step": state.step},
                         checkpoint=uri)

    return loop


def _fit(init, tokens, name, storage, stop, save_at=None, resume=None):
    result = TorchTrainer(
        _torch_loop_factory(LR, WARMUP, TOTAL),
        train_loop_config={"init": init, "tokens": tokens, "stop": stop,
                           "save_at": save_at},
        run_config=RunConfig(name=name, storage_path=storage,
                             resume_from_checkpoint=resume),
    ).fit()
    assert result.error is None, result.error
    return result


def test_trainer_matches_jax_trainer(cluster, reference, tmp_path):
    init, want = reference
    result = _fit(init, _tokens(STEPS), "parity", str(tmp_path), STEPS)
    got = result.metrics["reports"]
    assert len(got) == STEPS == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert result.metrics["step"] == STEPS


def test_fit_resumes_from_the_shard_store(cluster, reference, tmp_path):
    """Steps 1-2 with a shard-store checkpoint at 2 (reported as a
    ckpt:// URI), then a second fit that finds it ("auto") and runs steps
    3-4: the uninterrupted run's losses and norms, bit for bit."""
    init, _ = reference
    tokens = _tokens(RESUME_STEPS)
    whole = _fit(init, tokens, "whole", str(tmp_path), RESUME_STEPS)
    first = _fit(init, tokens, "resumed", str(tmp_path), SAVE_AT,
                 save_at=SAVE_AT)
    assert first.checkpoint == f"ckpt://resumed/{SAVE_AT}"
    second = _fit(init, tokens, "resumed", str(tmp_path), RESUME_STEPS,
                  resume="auto")
    assert second.metrics["step"] == RESUME_STEPS
    assert (first.metrics["reports"] + second.metrics["reports"]
            == whole.metrics["reports"])


def test_two_workers_restore_resharded_and_save_from_both(
        cluster, reference, tmp_path):
    """distributed=True over gloo: each worker's default process group
    carries an fsdp=2 mesh; the shard-store checkpoint of the tiny state
    restores onto it as DTensors (each local shard bit for bit its slice
    of the saved leaf), and both ranks save it again (each its windows):
    the second checkpoint restores to the first, leaf for leaf."""
    import ray_tpu_torch.checkpoint as dc

    init, _ = reference
    _fit(init, _tokens(SAVE_AT), "one", str(tmp_path), SAVE_AT,
         save_at=SAVE_AT)

    def loop(config):
        import torch
        from torch.distributed.tensor import DTensor

        import ray_tpu_torch.train as train
        from ray_tpu_torch import checkpoint as dc
        from ray_tpu_torch.checkpoint import manifest
        from ray_tpu_torch.models.llama import PRESETS
        from ray_tpu_torch.parallel.mesh import make_mesh
        from ray_tpu_torch.train import step as tstep

        ctx = train.get_context()
        mesh = make_mesh({"fsdp": 2}, device_type="cpu")
        cfg = PRESETS["tiny"]
        opt = tstep.make_optimizer(lr=1e-2, warmup=2, total_steps=8)
        target = tstep.init_train_state(cfg, opt, seed=1, device="cpu",
                                        mesh=mesh)
        state = dc.restore_uri(config["uri"], target=target)
        saved = dc.restore_uri(config["uri"])
        sharded = 0
        for key, leaf in manifest.tree_flatten_with_keys(state):
            want = saved[key]
            if isinstance(leaf, DTensor):
                window = manifest.dtensor_window(leaf)
                part = want[tuple(slice(a, b) for a, b in window)]
                assert torch.equal(leaf.to_local(), part), key
                sharded += leaf.to_local().numel() < want.numel()
            else:
                assert leaf == want.item(), key
        saver = dc.AsyncCheckpointer(run="two", rank=ctx.rank,
                                     world=ctx.world_size)
        saver.save(state.step, state)
        saver.wait()
        train.report({"sharded": sharded, "step": state.step})

    result = TorchTrainer(
        loop,
        train_loop_config={"uri": f"ckpt://one/{SAVE_AT}"},
        scaling_config=ScalingConfig(num_workers=2, distributed=True,
                                     dist_backend="gloo"),
        run_config=RunConfig(name="two-workers", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    assert result.metrics["step"] == SAVE_AT
    assert result.metrics["sharded"] > 0
    one, two = dc.restore("one", SAVE_AT), dc.restore("two", SAVE_AT)
    assert one.keys() == two.keys()
    for key in one:
        assert torch.equal(one[key], two[key]), key


def test_scaling_config_gpu_bundle_and_refused_topology():
    assert ScalingConfig(num_workers=2, use_gpu=True,
                         gpus_per_worker=0.5).bundle() == {"CPU": 1.0,
                                                           "GPU": 0.5}
    assert ScalingConfig().bundle() == {"CPU": 1.0}
    with pytest.raises(ValueError, match="topology"):
        ScalingConfig(topology="2x2")


def test_zero_optimizer_two_ranks_equals_unsharded_update():
    """Each of 2 ranks updates the leaves it owns (round-robin over the
    sorted keys, the checkpoint manifest's partition) with the whole
    tree's gradient norm; together they equal AdamW on the whole tree,
    bit for bit, over 3 steps that clip."""
    gen = torch.Generator().manual_seed(0)
    shapes = {f"w{i}": (4 + i, 3) for i in range(5)}
    start = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = [{k: 4 * torch.randn(s, generator=gen) for k, s in
              shapes.items()} for _ in range(3)]
    opt = tstep.make_optimizer(lr=1e-2, warmup=1, total_steps=8,
                               grad_clip=1.0)
    whole = {k: v.clone() for k, v in start.items()}
    state = opt.init(whole)
    for g in grads:
        state = opt.apply(whole, g, state)

    ranks = [{k: v.clone() for k, v in start.items()} for _ in range(2)]
    zos = [zero.ZeroOptimizer(opt, p, r, 2, mem_tag=f"test.zero.{r}")
           for r, p in enumerate(ranks)]
    try:
        assert sorted(k for zo in zos for k in zo.owned_keys()) == sorted(
            f"['{k}']" for k in shapes)
        for g in grads:
            norm = tstep.global_norm(g)
            for zo, p in zip(zos, ranks):
                owned = {k: g[k[2:-2]] for k in zo.owned_keys()}
                updated = zo.apply(owned, p, grad_norm=norm)
                assert sorted(updated) == zo.owned_keys()
            # the all-gather: every rank takes each owner's update
            for zo, p in zip(zos, ranks):
                for k in zo.owned_keys():
                    for other in ranks:
                        other[k[2:-2]].copy_(p[k[2:-2]])
        for p in ranks:
            for k in shapes:
                assert torch.equal(p[k], whole[k]), k
        # clipping mattered: without the norm each leaf clips alone
        alone = {k: v.clone() for k, v in start.items()}
        zo = zero.ZeroOptimizer(opt, alone, 0, 1, mem_tag="test.zero.x")
        zo.apply({f"['{k}']": grads[0][k] for k in shapes}, alone)
        zo.close()
        assert not torch.equal(alone["w0"], whole["w0"])
    finally:
        for zo in zos:
            zo.close()


@pytest.mark.parametrize("kw", [
    dict(num_workers=2, chips_per_worker=1.0),
    dict(num_workers=5, chips_per_worker=1.0),
    dict(num_workers=2, chips_per_worker=1.0, plan=("tiny", 2, 64)),
    dict(num_workers=1, chips_per_worker=1.0, plan=("bench", 64, 2048)),
])
def test_admission_verdict_equals_reference(kw, monkeypatch):
    """The same cluster view (4 CPU slots on healthy nodes, one draining
    node, one node of a draining slice) and the same config priced by
    each package's memory planner give the same ticket (the port's
    planner with the reference's fitted constants, as
    tests/test_torch_memory.py holds it)."""
    import dataclasses

    from ray_tpu.models import llama as jllama
    from ray_tpu.train import admission as jadmission
    from ray_tpu.train import memory as jmem

    from ray_tpu_torch.models.llama import PRESETS
    from ray_tpu_torch.train import memory as tmem

    for name in ("ACT_WORKING_FACTOR", "ACT_DOTS_PER_LAYER_FACTOR",
                 "ACT_NONE_PER_LAYER_FACTOR"):
        monkeypatch.setattr(tmem, name, getattr(jmem, name))
    monkeypatch.setattr(tmem, "ALLOCATOR_RESERVE_BYTES",
                        jmem.XLA_RESERVE_BYTES)

    status = {
        "nodes": {
            "a": {"resources": {"CPU": 2}, "available": {"CPU": 2}},
            "b": {"resources": {"CPU": 2}, "available": {"CPU": 2}},
            "c": {"resources": {"CPU": 4}, "available": {"CPU": 4}},
            "d": {"resources": {"CPU": 4}, "available": {"CPU": 4}},
        },
        "draining": {"c": {}},
        "slices": {"s": {"state": "draining", "nodes": ["d"]}},
    }
    kw = dict(kw)
    plan = kw.pop("plan", None)
    port_kw, ref_kw = dict(kw), dict(kw)
    if plan is not None:
        name, batch, seq = plan
        port_kw["plan_kwargs"] = dict(cfg=PRESETS[name], batch=batch,
                                      seq=seq, hbm_gb=80.0)
        ref_kw["plan_kwargs"] = dict(cfg=jllama.PRESETS[name], batch=batch,
                                     seq=seq, hbm_gb=80.0)
    got = admission.admit_gang(status=status, **port_kw)
    want = jadmission.admit_gang(status=status, **ref_kw)
    assert (got.admitted, got.reason, got.required_chips, got.free_chips,
            got.total_chips) == (want.admitted, want.reason,
                                 want.required_chips, want.free_chips,
                                 want.total_chips)
    assert (got.plan is None) == (want.plan is None)
    if got.plan is not None:
        assert (dataclasses.asdict(got.plan)
                == dataclasses.asdict(want.plan))
