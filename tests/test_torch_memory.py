"""The port's memory planner (ray_tpu_torch/train/memory.py) against the
reference's (ray_tpu/train/memory.py). The byte model is the same; only
the fitted constants differ (the port's are fitted to the caching
allocator on an H100). With the port's constants set to the reference's,
every MemoryPlan field must be equal, exactly: the same integer
arithmetic on the same parameter counts."""

import dataclasses

import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.train import memory as jmem
from ray_tpu_torch.models.llama import PRESETS
from ray_tpu_torch.train import memory as tmem

FITTED = ("ACT_WORKING_FACTOR", "ACT_DOTS_PER_LAYER_FACTOR",
          "ACT_NONE_PER_LAYER_FACTOR")
LEVERS = [
    dict(),
    dict(mu_dtype="float32"),
    dict(fsdp=4),
    dict(zero=8),
    dict(fsdp=2, zero=4),
    dict(grad_bucket_mb=25),
    dict(grad_bucket_mb=25, compression="int8"),
]


@pytest.fixture()
def reference_constants(monkeypatch):
    for name in FITTED:
        monkeypatch.setattr(tmem, name, getattr(jmem, name))
    monkeypatch.setattr(tmem, "ALLOCATOR_RESERVE_BYTES",
                        jmem.XLA_RESERVE_BYTES)


@pytest.mark.parametrize("remat", ["full", "dots", "none", "flash_qkv"])
@pytest.mark.parametrize("preset", ["tiny", "mini", "bench", "llama3_8b"])
def test_plan_matches_reference(reference_constants, preset, remat):
    cfg = dataclasses.replace(PRESETS[preset], remat=remat)
    jcfg = dataclasses.replace(jllama.PRESETS[preset], remat=remat)
    assert cfg.num_params() == jcfg.num_params()
    for batch, seq in ((1, 128), (16, 2048), (2, 4096)):
        for kw in LEVERS:
            got = tmem.plan(cfg, batch, seq, hbm_gb=80.0, **kw)
            want = jmem.plan(jcfg, batch, seq, hbm_gb=80.0, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), kw
            assert got.to_dict() == want.to_dict()
            assert got.breakdown() == want.breakdown()


@pytest.mark.parametrize("n_layers", [1, 2, 3, 4, 5, 6])
def test_plan_bench8b_matches_reference(reference_constants, n_layers):
    for batch in (1, 2):
        got = tmem.plan_bench8b(n_layers, batch, hbm_gb=16.0)
        want = jmem.plan_bench8b(n_layers, batch, hbm_gb=16.0)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_modes_other_than_full_and_dots_are_priced_as_none():
    """The reference's rule, kept: flash_qkv (the bench preset's mode)
    costs what "none" costs, with the port's constants too."""
    cfg = PRESETS["bench"]
    plans = {m: tmem.plan(dataclasses.replace(cfg, remat=m), 16, 2048,
                          hbm_gb=80.0)
             for m in ("full", "dots", "none", "flash_qkv", "attn")}
    assert plans["flash_qkv"] == plans["none"] == plans["attn"]
    assert plans["full"].total_bytes < plans["dots"].total_bytes \
        < plans["none"].total_bytes


def test_reserve_is_read_at_call_time(monkeypatch):
    cfg = PRESETS["tiny"]
    monkeypatch.setattr(tmem, "ALLOCATOR_RESERVE_BYTES", 123)
    p = tmem.plan(cfg, 1, 128, hbm_gb=1.0)
    assert p.reserve_bytes == 123 and p.usable_bytes == (1 << 30) - 123
    assert tmem.plan(cfg, 1, 128, hbm_gb=1.0,
                     reserve_bytes=7).reserve_bytes == 7


def test_torch_dtypes_price_as_their_width():
    cfg = PRESETS["mini"]
    by_name = tmem.plan(cfg, 2, 512, hbm_gb=80.0, mu_dtype="bfloat16")
    by_dtype = tmem.plan(cfg, 2, 512, hbm_gb=80.0, mu_dtype=torch.bfloat16)
    assert by_name == by_dtype
    wide = tmem.plan(cfg, 2, 512, hbm_gb=80.0, mu_dtype=torch.float32)
    assert wide.optimizer_bytes - by_name.optimizer_bytes == \
        2 * cfg.num_params()


def test_fits_follows_capacity():
    cfg = PRESETS["bench"]
    p = tmem.plan(cfg, 16, 2048, hbm_gb=80.0)
    assert p.fits and p.headroom_bytes == p.usable_bytes - p.total_bytes
    assert not tmem.plan(cfg, 16, 2048, hbm_gb=p.total_gb * 0.5).fits


def test_capacity_needs_a_card_or_hbm_gb():
    if torch.cuda.is_available():
        assert tmem.default_capacity_bytes() > 0
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmem.plan(PRESETS["tiny"], 1, 128)
    with pytest.raises(RuntimeError, match="hbm_gb"):
        tmem.default_capacity_bytes()
