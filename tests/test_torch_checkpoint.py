"""The port's checkpoints (ray_tpu_torch/train/checkpoint.py) and the
train state they carry, on the CPU.

- The reference's cases that need no mesh (tests/test_checkpoint.py):
  round trip, top-K by step, best by metric, restore_latest_valid
  falling back past a corrupt entry; an interrupted swap recovered from
  ``.old``; legacy names listed; a target of another shape or dtype
  refused.
- Resume: a training loop fed by TokenDataset, saved through
  CheckpointManager at step K, restored into a fresh state and run on to
  step N, equals the uninterrupted run bit for bit (parameters, both
  moments, the step count and every loss), dense and MoE.
- Carry-across: the reference's state at step K through
  train_state_from_jax is bit for bit the reference's arrays, and the
  port's continuation to N equals the reference's at
  test_torch_train_step.py's tolerances: loss and gradient norm 1e-5
  relative, parameters 2e-5 with an fp32 first moment and 5e-4 with a
  bf16 one (the reasons are given there); for MoE, test_torch_moe.py's
  rule (2e-5 but for at most 3 elements within 5e-4) with an fp32 one.
  Measured: 2.2e-6 (tiny) and 1.1e-6 (moe_tiny) with fp32 mu, 3.6e-5 and
  3.1e-5 with bf16 mu.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.train import step as jstep
from ray_tpu_torch.models.llama import PRESETS
from ray_tpu_torch.models.moe import MOE_PRESETS
from ray_tpu_torch.train import checkpoint as ck
from ray_tpu_torch.train import step as tstep
from ray_tpu_torch.train.dataloader import TokenDataset

# fp32 products in full fp32 wherever these tests run (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
# Tiny shapes: one intra-op thread keeps these tests off the cores that
# the suite's other workers use.
torch.set_num_threads(1)
LR, WARMUP, TOTAL, K, N = 1e-2, 1, 8, 2, 4
CONFIGS = {"tiny": (PRESETS["tiny"], jllama.PRESETS["tiny"]),
           "moe_tiny": (MOE_PRESETS["moe_tiny"], jmoe.MOE_PRESETS["moe_tiny"])}


def _x(v):
    return {"x": torch.tensor(float(v))}


def test_roundtrip_plain_tree(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4), "step": 7,
             "inner": {"b": torch.ones(2, dtype=torch.bfloat16)}}
    path = ck.save_checkpoint(str(tmp_path / "ck"), state,
                              metadata={"step": 7})
    assert ck.load_metadata(path)["step"] == 7
    assert sorted(os.listdir(path)) == ["metadata.json",
                                        ck.STATE_FILE.format(rank=0)]
    out = ck.restore_checkpoint(path, device="cpu")
    assert torch.equal(out["w"], state["w"])
    assert int(out["step"]) == 7
    assert out["inner"]["b"].dtype == torch.bfloat16


def test_manager_keeps_topk_by_step(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "run"), num_to_keep=2)
    for step in range(4):
        mgr.save(step, _x(step))
    entries = sorted(p.name for p in (tmp_path / "run").iterdir())
    assert entries == ["ckpt-00000002", "ckpt-00000003"]
    latest = mgr.latest()
    assert latest.endswith("ckpt-00000003")
    assert float(ck.restore_checkpoint(latest, device="cpu")["x"]) == 3.0


def test_manager_restore_latest_valid_falls_back(tmp_path):
    """A corrupt newest checkpoint costs one entry, not the run."""
    mgr = ck.CheckpointManager(str(tmp_path / "run"), num_to_keep=3)
    for step in range(3):
        mgr.save(step, _x(step))
    newest = mgr.latest()
    assert newest.endswith("ckpt-00000002")
    state_file = os.path.join(newest, ck.STATE_FILE.format(rank=0))
    with open(state_file, "r+b") as f:
        f.truncate(100)  # cut mid-write
    with pytest.raises(Exception):
        ck.restore_checkpoint(newest, device="cpu")  # a plain restore fails
    out = mgr.restore_latest_valid(device="cpu")
    assert out is not None
    path, state = out
    assert path.endswith("ckpt-00000001")
    assert float(state["x"]) == 1.0
    # A target that no entry matches falls back past every one.
    assert mgr.restore_latest_valid(target={"y": torch.zeros(())}) is None
    for name in list((tmp_path / "run").iterdir()):
        shutil.rmtree(name)
    assert mgr.restore_latest_valid(device="cpu") is None


def test_manager_keeps_best_by_metric(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "run"), num_to_keep=2,
                               score_attribute="accuracy", score_order="max")
    for step, acc in enumerate([0.1, 0.9, 0.3, 0.2]):
        mgr.save(step, _x(step), metrics={"accuracy": acc})
    names = sorted(p.name for p in (tmp_path / "run").iterdir())
    # The best (step 1, 0.9) and the latest (step 3) survive.
    assert names == ["ckpt-00000001", "ckpt-00000003"]
    assert mgr.best().endswith("ckpt-00000001")
    low = ck.CheckpointManager(str(tmp_path / "low"), num_to_keep=2,
                               score_attribute="loss", score_order="min")
    for step, loss in enumerate([3.0, 1.0, 2.0, 4.0]):
        low.save(step, _x(step), metrics={"loss": loss})
    assert low.best().endswith("ckpt-00000001")
    assert sorted(p.name for p in (tmp_path / "low").iterdir()) == [
        "ckpt-00000001", "ckpt-00000003"]


def test_interrupted_swap_recovered_from_old(tmp_path):
    """A crash between the two renames leaves only <path>.old; restoring,
    listing or saving again puts it back. With both present (a crash
    after the swap) the stale .old goes."""
    mgr = ck.CheckpointManager(str(tmp_path / "run"), num_to_keep=3)
    path = mgr.save(5, _x(5))
    os.rename(path, path + ".old")
    assert mgr.latest() == path  # _entries recovered it
    assert not os.path.exists(path + ".old")
    os.rename(path, path + ".old")
    assert float(ck.restore_checkpoint(path, device="cpu")["x"]) == 5.0
    shutil.copytree(path, path + ".old")
    ck.save_checkpoint(path, _x(6))
    assert not os.path.exists(path + ".old")
    assert not os.path.exists(path + ".tmp")
    assert float(ck.restore_checkpoint(path, device="cpu")["x"]) == 6.0


def test_legacy_names_listed(tmp_path):
    run = tmp_path / "run"
    for name in ("checkpoint_000005", "ckpt-00000007", "ckpt-x",
                 "checkpoint_12.old", "other"):
        (run / name).mkdir(parents=True)
    assert ck.list_checkpoint_dirs(str(run)) == [
        (5, "checkpoint_000005"), (7, "ckpt-00000007")]
    assert ck.checkpoint_dir_name(7) == "ckpt-00000007"
    assert ck.list_checkpoint_dirs(str(tmp_path / "absent")) == []
    legacy = ck.CheckpointManager(str(tmp_path / "legacy"))
    ck.save_checkpoint(str(tmp_path / "legacy" / "checkpoint_000003"), _x(3))
    assert legacy.latest().endswith("checkpoint_000003")


def test_restore_refuses_another_shape_or_dtype(tmp_path):
    path = ck.save_checkpoint(str(tmp_path / "ck"),
                              {"w": torch.zeros(3, 4), "b": torch.zeros(4)})
    ok = ck.restore_checkpoint(path, target={"w": torch.ones(3, 4),
                                             "b": torch.ones(4)})
    assert torch.equal(ok["w"], torch.zeros(3, 4))
    for bad, what in (({"w": torch.zeros(4, 3), "b": torch.zeros(4)}, "w"),
                      ({"w": torch.zeros(3, 4),
                        "b": torch.zeros(4, dtype=torch.bfloat16)}, "b"),
                      ({"w": torch.zeros(3, 4)}, "extra")):
        with pytest.raises(ValueError, match=what):
            ck.restore_checkpoint(path, target=bad)


def test_runtime_features_raise(tmp_path):
    """The shard store lives in the runtime: without ray_tpu_torch.init a
    manager asked for it raises at once, not at its first save."""
    with pytest.raises(RuntimeError, match="initialized runtime"):
        ck.CheckpointManager(str(tmp_path / "run"), store_run="r")


def test_default_device_never_falls_back_to_cpu(tmp_path):
    path = ck.save_checkpoint(str(tmp_path / "ck"), _x(1))
    if torch.cuda.is_available():
        assert ck.restore_checkpoint(path)["x"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ck.restore_checkpoint(path)


# ------------------------------------------------------------- resume
def _batches(tmp_path, cfg, seed=3):
    """N batches of 2 x 17 tokens through TokenDataset from a token file
    written from a seed, as int32 tensors."""
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=40 * 17, dtype=np.uint32).tofile(path)
    ds = TokenDataset(path, seq_len=16, seed=seed)
    try:
        out = []
        for b in ds.iter_batches(2):
            out.append({"tokens": torch.from_numpy(b["tokens"].view(np.int32))})
            if len(out) == N:
                return out
    finally:
        ds.close()
    raise AssertionError("the token file holds fewer than N batches")


def _opt(mu_dtype):
    return tstep.make_optimizer(lr=LR, warmup=WARMUP, total_steps=TOTAL,
                                mu_dtype=mu_dtype)


def _run(cfg, opt, state, batches):
    step = tstep.jit_train_step(cfg, opt)
    losses = []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return state, losses


def _assert_bit_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    da, db = tstep.train_state_dict(a), tstep.train_state_dict(b)
    assert da.keys() == db.keys()
    for key in da:
        assert da[key].dtype == db[key].dtype, key
        assert torch.equal(da[key], db[key]), key


@pytest.mark.parametrize("name,mu_dtype", [("tiny", None),
                                           ("tiny", torch.bfloat16),
                                           ("moe_tiny", torch.bfloat16)])
def test_resume_is_bit_exact(tmp_path, name, mu_dtype):
    cfg = CONFIGS[name][0]
    batches = _batches(tmp_path, cfg)
    opt = _opt(mu_dtype)
    whole, want_losses = _run(cfg, opt, tstep.init_train_state(
        cfg, opt, seed=0, device="cpu"), batches)

    first, losses = _run(cfg, opt, tstep.init_train_state(
        cfg, opt, seed=0, device="cpu"), batches[:K])
    mgr = ck.CheckpointManager(str(tmp_path / "run"), num_to_keep=2)
    mgr.save(first.step, first, metrics={"loss": losses[-1]})
    saved = {k: v.clone() for k, v in tstep.train_state_dict(first).items()}
    del first
    fresh = tstep.init_train_state(cfg, opt, seed=1, device="cpu")
    path, restored = mgr.restore_latest_valid(target=fresh)
    assert path.endswith(ck.checkpoint_dir_name(K))
    assert all(p.requires_grad for _, p in tstep._flatten(restored.params))
    for key, t in tstep.train_state_dict(restored).items():
        assert torch.equal(t, saved[key]), key
    resumed, rest = _run(cfg, opt, restored, batches[K:])
    assert losses + rest == want_losses
    _assert_bit_equal(resumed, whole)


# ------------------------------------------------------- carry-across
def _jax_opt(mu_dtype):
    return jstep.make_optimizer(lr=LR, warmup=WARMUP, total_steps=TOTAL,
                                mu_dtype=mu_dtype)


@pytest.mark.parametrize("name,bf16_mu", [("tiny", False), ("tiny", True),
                                          ("moe_tiny", False),
                                          ("moe_tiny", True)])
def test_state_carried_from_jax_continues_as_the_reference(tmp_path, name,
                                                           bf16_mu):
    cfg, jcfg = CONFIGS[name]
    batches = _batches(tmp_path, cfg)
    jopt = _jax_opt(jnp.bfloat16 if bf16_mu else None)
    jstate = jstep.init_train_state(jax.random.key(0), jcfg, jopt)
    step = jstep.jit_train_step(jcfg, jopt, None)
    want = []
    for i, batch in enumerate(batches):
        if i == K:
            at_k = jax.tree.map(np.array, jstate)  # copies
        jstate, m = step(jstate, {"tokens": jnp.asarray(
            batch["tokens"].numpy())})
        want.append((float(m["loss"]), float(m["grad_norm"])))
    want_params = jax.tree.map(np.asarray, jstate.params)

    at_k_copy = np.array(at_k.params["lm_head"])
    state = tstep.train_state_from_jax(at_k, device="cpu")
    assert state.step == K and state.opt_state.count == K
    adam = at_k.opt_state[1][0]
    for tree, ref in ((state.params, at_k.params),
                      (state.opt_state.mu, adam.mu),
                      (state.opt_state.nu, adam.nu)):
        for (path, t), (_, r) in zip(tstep._flatten(tree),
                                     tstep._flatten(ref)):
            assert str(t.dtype).endswith(r.dtype.name), path
            got = t.detach().float().numpy()
            assert np.array_equal(got, r.astype(np.float32)), path
    assert all(p.requires_grad for _, p in tstep._flatten(state.params))

    topt = _opt(torch.bfloat16 if bf16_mu else None)
    tfn = tstep.jit_train_step(cfg, topt)
    got = []
    for batch in batches[K:]:
        state, m = tfn(state, batch)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(got, want[K:], rtol=1e-5)
    err = np.concatenate([
        np.abs(p.detach().numpy() - w).ravel()
        for (_, p), (_, w) in zip(tstep._flatten(state.params),
                                  tstep._flatten(want_params))
    ])
    if bf16_mu:
        assert err.max() <= 5e-4
    elif name == "moe_tiny":
        assert (err > 2e-5).sum() <= 3 and err.max() <= 5e-4
    else:
        assert err.max() <= 2e-5
    # The JAX buffers the state was carried from are untouched.
    assert np.array_equal(jax.tree.map(np.asarray, at_k.params)["lm_head"],
                          at_k_copy)


def test_train_state_from_jax_needs_adam_state():
    class State:
        step = np.int32(0)
        params = {"w": np.zeros((2, 2), np.float32)}
        opt_state = ((), ())

    with pytest.raises(ValueError, match="adamw"):
        tstep.train_state_from_jax(State(), device="cpu")
