"""The two GPU consumers of the port's Data library, on the CPU (the tiny
preset in fp32, inputs made from seeds):

- batch inference: ``build_batch_inferencer``'s class under
  ``Dataset.map_batches(compute="actors", concurrency=1)`` on the port's
  runtime gives the ``generated`` column that the JAX package's class
  gives when called on the same batch dict (the same weights, carried
  over with ``params_from_jax``);
- training: the JAX package's ``test_trainer_dataset_shards`` on
  ``TorchTrainer`` (each of two workers reads a disjoint half of 40
  rows), and three tiny-preset steps fed from a Dataset through
  ``get_dataset_shard(...).iter_batches`` that are bit for bit the same
  three steps fed directly in this process. The direct steps are held to
  the JAX package's by tests/test_torch_llama_train.py and
  tests/test_torch_trainer.py.
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm.batch import build_batch_inferencer as jax_inferencer
from ray_tpu.models import llama as jllama
import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.llm import build_batch_inferencer
from ray_tpu_torch.models.llama import PRESETS, params_from_jax
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
from ray_tpu_torch.train import step as tstep
from torch_runtime_util import start_cluster, stop_cluster

CFG = PRESETS["tiny"]
PROMPTS = ("hello world", "the quick brown fox", "a", "map me 10 tokens",
           "data")
MAX_TOKENS = 10
ENGINE = {"max_batch": 2, "max_seq": 64, "page_size": 16}
# Three steps of 2 x 17 tokens (vocab 512), and the optimizer both sides use.
STEPS, BATCH, SEQ = 3, 2, 17
LR, WARMUP, TOTAL = 1e-2, 2, 8

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.key(0), jllama.PRESETS["tiny"])


def _wait_idle(timeout: float = 30.0) -> None:
    """Wait until the node's CPUs are all free again: a trainer's
    placement group takes its bundles from what is free now, and the
    leases of an earlier test's actors and gang come back a few seconds
    after they end."""
    deadline = time.monotonic() + timeout
    while (ray_tpu_torch.available_resources().get("CPU", 0)
           < ray_tpu_torch.cluster_resources()["CPU"]):
        assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.2)


# Prompts as text, and as token-id lists of several lengths (the form
# the card's batch inference feeds: an object column of lists).
PROMPT_SETS = {
    "text": list(PROMPTS),
    "token_ids": [np.random.default_rng(n).integers(0, 256, n).tolist()
                  for n in (5, 17, 1, 30, 9)],
}


@pytest.mark.parametrize("kind", sorted(PROMPT_SETS))
def test_batch_inference_through_actor_pool_matches_reference(cluster,
                                                               jparams, kind):
    prompts = PROMPT_SETS[kind]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu")
    want = jax_inferencer(
        "tiny", engine_kwargs={**ENGINE, "params": jparams},
        max_tokens=MAX_TOKENS)()({"prompt": list(prompts)})["generated"]
    cls = build_batch_inferencer(
        "tiny", engine_kwargs={**ENGINE, "params": tparams, "device": "cpu"},
        max_tokens=MAX_TOKENS)
    ds = rd.from_items([{"prompt": p} for p in prompts])
    rows = ds.map_batches(cls, batch_size=len(prompts), compute="actors",
                          concurrency=1).take_all()
    assert [list(r["prompt"]) if kind == "token_ids" else r["prompt"]
            for r in rows] == prompts
    assert [r["generated"] for r in rows] == list(want)
    assert any(len(g) for g in want)  # some byte ids decode to text


def test_trainer_dataset_shards(cluster, tmp_path):
    """datasets= splits blocks across workers; each worker sees a
    disjoint shard via get_dataset_shard (reference: DataConfig +
    ray.train.get_dataset_shard)."""
    from ray_tpu_torch import train

    _wait_idle()
    ds = rd.from_items([{"x": i} for i in range(40)]).repartition(8)

    def loop():
        shard = train.get_dataset_shard("train")
        seen = [row["x"] for row in shard.iter_rows()]
        ctx = train.get_context()
        train.report({"count": len(seen), "sum": sum(seen),
                      "rank": ctx.rank})

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="dsexp", storage_path=str(tmp_path)),
        datasets={"train": ds},
    ).fit()
    assert result.error is None
    # Round-robin over 8 blocks of 5 rows: rank 0 gets exactly half the
    # rows (a split handing every block to both workers would report 40).
    assert result.metrics["count"] == 20
    assert 0 < result.metrics["sum"] < sum(range(40))


def _tokens() -> np.ndarray:
    """STEPS x BATCH rows of SEQ tokens, one row id in front of each."""
    toks = np.random.default_rng(2).integers(
        0, CFG.vocab_size, size=(STEPS * BATCH, SEQ))
    return np.concatenate([np.arange(STEPS * BATCH)[:, None], toks], axis=1)


def test_dataset_fed_steps_equal_direct_steps(cluster, tmp_path):
    """One worker reads the rows from its shard in batches of 2 (the
    blocks hold 3 rows, so a batch spans two blocks) and steps on them;
    its losses and gradient norms are those of the same steps fed the
    same rows directly, bit for bit, and it read each row once."""
    _wait_idle()
    rows = _tokens()

    def loop():
        import torch

        import ray_tpu_torch.train as train
        from ray_tpu_torch.train import step as tstep

        torch.set_num_threads(1)
        # The loop pickles by value: a module-level helper would pickle by
        # reference, and the worker cannot import this test module.
        opt = tstep.make_optimizer(lr=LR, warmup=WARMUP, total_steps=TOTAL)
        state = tstep.init_train_state(CFG, opt, seed=1, device="cpu")
        step = tstep.jit_train_step(CFG, opt)
        reports, ids = [], []
        shard = train.get_dataset_shard("train")
        for batch in shard.iter_batches(batch_size=BATCH):
            ids += batch["data"][:, 0].tolist()
            state, m = step(state, {"tokens": torch.from_numpy(
                batch["data"][:, 1:])})
            reports.append([float(m["loss"]), float(m["grad_norm"])])
        train.report({"reports": reports, "ids": ids})

    result = TorchTrainer(
        loop, run_config=RunConfig(name="fed", storage_path=str(tmp_path)),
        datasets={"train": rd.from_numpy(rows, parallelism=2)},
    ).fit()
    assert result.error is None, result.error
    assert result.metrics["ids"] == list(range(STEPS * BATCH))

    opt = tstep.make_optimizer(lr=LR, warmup=WARMUP, total_steps=TOTAL)
    state = tstep.init_train_state(CFG, opt, seed=1, device="cpu")
    step = tstep.jit_train_step(CFG, opt)
    want = []
    for i in range(STEPS):
        batch = rows[i * BATCH:(i + 1) * BATCH, 1:]
        state, m = step(state, {"tokens": torch.from_numpy(batch)})
        want.append([float(m["loss"]), float(m["grad_norm"])])
    assert result.metrics["reports"] == want
