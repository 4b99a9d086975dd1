"""The port's step profiler (ray_tpu_torch/train/profile.py,
ray_tpu_torch/_private/kernel_profile.py) against the JAX package's
(tests/test_profile.py).

The pure functions (wire factors, roofline pricing, the static
fingerprint, the attribution join) get the same inputs in both packages
and must agree to 1e-9; ``price_categories`` is fed the JAX package's HLO
walk of the reference test's synthetic module. The HLO walker and the
xplane parser have no counterpart (the port has neither), so their cases
are not ported; in their place the kernel-name classification is pinned.
The capture machinery, the head's fold and sentinel, and the
``profile_capture`` fan-out run on the port's runtime; the last case is a
capture requested through ``util.state.profile_capture()`` that comes back
from a ``TorchTrainer`` worker's step as a ``profile:step`` span.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import config as _config
from ray_tpu_torch._private import kernel_profile, rpc
from ray_tpu_torch.train import profile
from ray_tpu_torch.util import state
from torch_runtime_util import start_cluster, stop_cluster

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-9


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


def _jax_walk():
    from ray_tpu._private import xla_profile

    sys.path.insert(0, str(Path(__file__).parent))
    from test_profile import SYNTHETIC_HLO

    return xla_profile.analyze_hlo_text(SYNTHETIC_HLO)


# ------------------------------------------------------ static half
def test_wire_factors_equal_reference():
    from ray_tpu.train import profile as ref

    for op in ("all-reduce", "all-reduce-start", "all-gather",
               "reduce-scatter", "collective-permute", "allreduce",
               "allgather", "reducescatter", "all-to-all"):
        for n in (None, 1, 2, 4, 8):
            assert (profile.collective_wire_factor(op, n)
                    == ref.collective_wire_factor(op, n)), (op, n)
    assert profile.collective_wire_factor("all-reduce", 4) == 1.5
    assert profile.collective_wire_factor("all-gather", 4) == 0.75
    assert profile.collective_wire_factor("reduce-scatter", 2) == 0.5
    assert profile.collective_wire_factor("collective-permute", 4) == 1.0
    assert profile.collective_wire_factor("all-reduce", 1) == 0.0


def test_roofline_pricing_equals_reference():
    """price_categories on the JAX walker's output of the synthetic HLO,
    with explicit peaks, gives the reference's floors."""
    from ray_tpu.train import profile as ref

    walk = _jax_walk()
    peaks = dict(peak_flops=1e12, hbm_bps=1e9, ici_bps=1e9)
    got = profile.price_categories(walk, **peaks)
    want = ref.price_categories(walk, **peaks)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=TOL, abs=TOL), k
    mat = walk["categories"]["matmul"]
    assert got["matmul"] == pytest.approx(
        max(mat["flops"] / 1e12, mat["bytes"] / 1e9))
    assert got["collective"] == pytest.approx(64 * 64 * 4 * 1.5 / 1e9)
    assert got["elementwise_fusion"] > 0 and got["layout"] > 0


def test_static_fingerprint_deterministic():
    """_finish_static hashes the category shape, as the reference's does;
    analyze_train_step's signature is a hash of the config, batch,
    sequence and mesh, equal in another process."""
    walk = _jax_walk()
    s1 = profile._finish_static(walk, {})
    s2 = profile._finish_static(_jax_walk(), {})
    assert s1["sig"] == s2["sig"] and len(s1["sig"]) == 16
    assert s1["ideal_step_s"] == pytest.approx(
        sum(c["floor_s"] for c in s1["categories"].values()))

    from ray_tpu_torch.models.llama import PRESETS

    tiny = PRESETS["tiny"]
    static = profile.analyze_train_step(tiny, batch_size=8, seq=128)
    code = textwrap.dedent("""
        from ray_tpu_torch.models.llama import PRESETS
        from ray_tpu_torch.train import profile
        print(profile.analyze_train_step(PRESETS["tiny"], batch_size=8,
                                         seq=128)["sig"])
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == static["sig"]
    assert profile.analyze_train_step(tiny, 4, 128)["sig"] != static["sig"]
    assert set(static["categories"]) == {
        "matmul", "collective", "elementwise_fusion", "layout"}
    model = tiny.flops_per_token(128) * 8 * 128
    assert static["model_flops_per_step"] == pytest.approx(model)
    assert static["categories"]["matmul"]["flops"] == pytest.approx(model)
    assert static["categories"]["layout"]["floor_s"] == 0.0
    assert static["categories"]["elementwise_fusion"]["floor_s"] == 0.0
    from ray_tpu_torch.train import telemetry

    floor = static["categories"]["matmul"]["floor_s"]
    assert floor == pytest.approx(model / telemetry.peak_flops_per_chip())
    assert static["ideal_step_s"] == pytest.approx(floor)


def test_kernel_names_classify():
    """One kernel name of each class lands in its category; profiler
    overhead events are skipped."""
    cases = {
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64":
            "matmul",
        "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN": "matmul",
        "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm>": "matmul",
        "void gemv2T_kernel_val<int, int, float>": "matmul",
        "flash_fwd_wgmma_kernel": "matmul",
        "flash_bwd_dq_kernel": "matmul",
        "paged_attention_kernel": "matmul",
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)":
            "collective",
        "Memcpy DtoD (Device -> Device)": "layout",
        "Memset (Device)": "layout",
        "void at::native::elementwise_kernel<128, 4, "
        "direct_copy_kernel_cuda>": "layout",
        "void at::native::index_elementwise_kernel<128, 4>": "layout",
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy":
            "layout",
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float>>": "elementwise_fusion",
        "void at::native::reduce_kernel<512, 1>": "elementwise_fusion",
    }
    for name, cat in cases.items():
        assert kernel_profile.categorize_kernel_name(name) == cat, name
    for name in ("Activity Buffer Request", "Buffer Flush",
                 "[memory]", "ProfilerStep#3", "cudaDeviceSynchronize"):
        assert kernel_profile.categorize_kernel_name(name) is None, name
    assert kernel_profile.brief(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3> >"
    ) == "vectorized_elementwise_kernel[CUDAFunctor_add]"
    assert kernel_profile.is_attention_kernel("flash_bwd_convert_kernel")
    assert not kernel_profile.is_attention_kernel("nvjet_tst_128x256")
    # The CPU path reads aten ops: views and autograd shells are skipped.
    assert kernel_profile.categorize_cpu_op("aten::mm") == "matmul"
    assert kernel_profile.categorize_cpu_op("aten::copy_") == "layout"
    assert kernel_profile.categorize_cpu_op("aten::mul") == \
        "elementwise_fusion"
    for name in ("aten::view", "aten::transpose", "MmBackward0",
                 "autograd::engine::evaluate_function: MmBackward0",
                 "ProfilerStep#1", "[memory]"):
        assert kernel_profile.categorize_cpu_op(name) is None, name


def test_measured_category_seconds_sums_events():
    """Synthetic key averages: device events by kernel name (overhead
    skipped), ms per kernel, the attention total."""
    def ev(key, us, count=1, kind="CUDA"):
        return types.SimpleNamespace(
            key=key, count=count, self_device_time_total=us,
            self_cpu_time_total=0.0,
            device_type=types.SimpleNamespace(name=kind))

    prof = types.SimpleNamespace(key_averages=lambda: [
        ev("aten::mm", 900.0, kind="CPU"),
        ev("nvjet_tst_128x256", 3000.0, 2),
        ev("flash_fwd_wgmma_kernel", 500.0, 4),
        ev("ncclDevKernel_AllReduce", 250.0),
        ev("Memcpy DtoD (Device -> Device)", 100.0),
        ev("void at::native::vectorized_elementwise_kernel<4, add>", 150.0),
        ev("Activity Buffer Request", 999.0),
    ])
    m = kernel_profile.measured_category_seconds(prof)
    assert m["categories"] == pytest.approx({
        "matmul": 3500e-6, "collective": 250e-6, "layout": 100e-6,
        "elementwise_fusion": 150e-6})
    assert m["device_busy_s"] == pytest.approx(4000e-6)
    assert m["events"] == 9
    assert m["attention_ms"] == pytest.approx(0.5)
    assert m["kernels"]["matmul"]["flash_fwd_wgmma_kernel"] == \
        pytest.approx(0.5)
    assert kernel_profile.largest(m, "matmul", 1) == [
        ("nvjet_tst_128x256", pytest.approx(3.0))]


# -------------------------------------------------- measured half
def test_capture_attribution_cpu_acceptance():
    """Acceptance: a real capture of the tiny train step on the CPU
    decomposes the measured step wall into shares that sum to 1 within
    10%, and names the dominant non-compute consumer."""
    from ray_tpu_torch.models.llama import PRESETS

    rep = profile.profile_train_step(
        PRESETS["tiny"], batch_size=8, seq=128, steps=3, device="cpu")
    shares = rep["shares"]
    assert set(shares) == set(profile.CATEGORIES)
    assert all(v >= 0.0 for v in shares.values())
    assert abs(sum(shares.values()) - 1.0) <= 0.10
    assert rep["dominant_gap"] in profile.CATEGORIES
    assert rep["dominant_gap"] != "compute_floor"
    assert rep["sig"] == rep["static"]["sig"]
    assert rep["steps"] == 3 and rep["step_s"] > 0
    assert rep["mfu"] > 0
    # compute_floor is the analytic floor when it undercuts measured
    # matmul time — it can never exceed the whole step.
    assert rep["seconds"]["compute_floor"] <= rep["step_s"] * 1.01
    measured = rep["measured"]
    assert measured["categories"]["matmul"] > 0
    assert measured["kernels"]["matmul"]
    assert rep["path"] and os.path.isdir(rep["path"])


def test_attribution_report_equals_reference():
    """The decomposition of the reference's pinned case, and of the
    oversumming case, equal in both packages; then the reference's
    asserts."""
    from ray_tpu.train import profile as ref

    measured = {
        "categories": {
            "matmul": 0.6, "collective": 0.2,
            "elementwise_fusion": 0.6, "layout": 0.0,
        },
        "device_busy_s": 1.6,
        "events": 100,
    }
    static = {
        "categories": {"matmul": {"floor_s": 0.15}},
        "sig": "sigtest",
        "model_flops_per_step": 1e12,
    }
    over = dict(measured, device_busy_s=8.0)
    for args in ((measured, 2.0, 2, static), (over, 2.0, 2, None),
                 (measured, 3.0, 3, None)):
        got = profile.attribution_report(*args)
        want = ref.attribution_report(*args)
        assert got.keys() == want.keys()
        for key in ("seconds", "shares"):
            for k in want[key]:
                assert got[key][k] == pytest.approx(
                    want[key][k], rel=TOL, abs=TOL), (key, k)
        for key in ("step_s", "steps", "device_busy_s", "dominant_gap",
                    "sig"):
            assert got[key] == pytest.approx(want[key], rel=TOL), key
    rep = profile.attribution_report(measured, 2.0, 2, static=static)
    sec = rep["seconds"]
    assert sec["compute_floor"] == pytest.approx(0.15)
    assert sec["comm_in_program"] == pytest.approx(0.1)
    assert sec["hbm_bound"] == pytest.approx(0.3)
    assert sec["host_gap"] == pytest.approx(0.2)
    assert sec["unattributed"] == pytest.approx(0.25)
    assert sum(rep["shares"].values()) == pytest.approx(1.0, abs=1e-4)
    assert rep["dominant_gap"] == "hbm_bound"
    assert rep["sig"] == "sigtest"
    # The MFU denominator is the process group's GPUs (one here).
    from ray_tpu_torch.train import telemetry

    assert rep["mfu"] == pytest.approx(
        round(1e12 / (1.0 * telemetry.peak_flops_per_chip()), 6))
    rep2 = profile.attribution_report(over, 2.0, 2, static=None)
    assert rep2["seconds"]["host_gap"] == pytest.approx(0.0)
    assert sum(rep2["shares"].values()) == pytest.approx(1.0, abs=1e-4)


# --------------------------------------------- capture state machine
def _ctx(job="j", rank=0):
    return types.SimpleNamespace(experiment_name=job, rank=rank, attempt=0)


PROFILE_DISABLED_CEILING_S = 50e-6


def test_disabled_path_floor():
    """The per-step hook while disarmed is the cost every training step
    pays forever: pinned under 50µs (it is two branches)."""
    profile._reset_for_tests()
    ctx = _ctx()
    for _ in range(100):  # warmup
        profile.step_hook(ctx, 0.01)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        profile.step_hook(ctx, 0.01)
    per_step = (time.perf_counter() - t0) / n
    assert per_step < PROFILE_DISABLED_CEILING_S, (
        f"disarmed profile.step_hook costs {per_step * 1e6:.1f}µs/"
        f"step (budget {PROFILE_DISABLED_CEILING_S * 1e6:.0f}µs)"
    )


def test_profile_kill_switch_and_arming():
    """RAY_TPU_PROFILE=0 turns capture requests into a warning no-op;
    the pubsub fan-out entry point arms with the requested depth."""
    profile._reset_for_tests()
    _config.set_system_config({"PROFILE": False})
    try:
        profile.request_capture(steps=2)
        assert profile._armed is False
    finally:
        _config.clear_system_config("PROFILE")
    profile.note_capture_request({"steps": 2})
    assert profile._armed is True
    assert profile._pending_steps == 2
    profile._reset_for_tests()


def test_capture_failure_degrades_to_warning(monkeypatch, caplog):
    """A capture-path failure costs one warning and disarms — never an
    exception in the step loop."""
    profile._reset_for_tests()
    profile.request_capture(steps=2)
    assert profile._armed is True
    from ray_tpu_torch.util import tracing

    def boom(*a, **k):
        raise RuntimeError("tracer unavailable")

    monkeypatch.setattr(tracing, "torch_profile", boom)
    with caplog.at_level("WARNING", logger="ray_tpu_torch.train.profile"):
        profile.step_hook(_ctx(), 0.01)  # must not raise
    assert profile._armed is False
    assert any(
        "profile capture failed" in r.message for r in caplog.records)
    profile._reset_for_tests()


def test_hook_captures_steps_and_emits_span(monkeypatch, tmp_path):
    """Armed for 2 steps: the hook opens torch_profile at one boundary,
    closes it two boundaries later, and emits profile:step with the
    reference's keys; then it disarms."""
    import torch

    from ray_tpu_torch.util import tracing

    profile._reset_for_tests()
    spans = []
    monkeypatch.setattr(tracing, "emit_span",
                        lambda name, ts, dur, **kw: spans.append(
                            dict(kw, name=name, dur=dur)))
    monkeypatch.setenv("RAY_TPU_PROFILE_DIR", str(tmp_path))
    profile.request_capture(steps=2)
    ctx = _ctx("hookjob")
    x = torch.randn(64, 64)
    profile.step_hook(ctx, 0.0)  # boundary: the capture starts
    for _ in range(2):
        t0 = time.perf_counter()
        (x @ x).relu().sum()
        profile.step_hook(ctx, time.perf_counter() - t0)
    assert profile._armed is False and profile._active is None
    [span] = [s for s in spans if s["name"] == "profile:step"]
    for key in ("train_job", "train_rank", "train_attempt", "profile_sig",
                "profile_steps", "profile_step_s", "profile_shares",
                "profile_dominant", "path"):
        assert key in span, key
    assert span["train_job"] == "hookjob" and span["profile_steps"] == 2
    assert span["profile_measured_s"]["matmul"] > 0
    rep = profile.last_report("hookjob")
    assert rep["measured"]["kernels"]["matmul"]
    profile._reset_for_tests()


# ------------------------------------------------- head fold + sentinel
BASE_SHARES = {
    "compute_floor": 0.3, "comm_in_program": 0.0,
    "hbm_bound": 0.4, "host_gap": 0.1, "unattributed": 0.2,
}
DRIFT_SHARES = {
    "compute_floor": 0.3, "comm_in_program": 0.0,
    "hbm_bound": 0.1, "host_gap": 0.4, "unattributed": 0.2,
}


def _profile_span(job, sig, shares, ts, rank=0, dominant="hbm_bound"):
    return {
        "task_id": f"span:profile-{job}-{ts}",
        "name": "profile:step",
        "state": "SPAN",
        "ts": ts,
        "dur": 0.06,
        "train_job": job,
        "train_rank": rank,
        "train_attempt": 0,
        "profile_sig": sig,
        "profile_steps": 3,
        "profile_step_s": 0.02,
        "profile_shares": shares,
        "profile_dominant": dominant,
        "path": "/tmp/capture",
    }


def test_fingerprint_journal_survives_restart(tmp_path):
    """First sight of a step signature journals its fingerprint; a head
    restart replays it, so a later drifted capture alerts against the
    PRE-restart baseline."""
    path = str(tmp_path / "head.journal")

    async def first():
        from ray_tpu_torch.runtime.head import HeadService

        head = HeadService(journal_path=path)
        addr = await head.start()
        conn = await rpc.connect(addr)
        try:
            await conn.call("add_task_events", events=[
                _profile_span("jobA", "sigX", BASE_SHARES, time.time()),
                # non-rank-0 reports are ignored
                _profile_span("jobB", "sigY", BASE_SHARES, time.time(),
                              rank=1),
            ])
            stats = await conn.call("profile_stats")
            assert stats["fingerprints"]["sigX"]["shares"][
                "hbm_bound"] == pytest.approx(0.4)
            assert stats["jobs"]["jobA"]["alert"] is False
            assert "jobB" not in stats["jobs"]
            assert "sigY" not in stats["fingerprints"]
        finally:
            await conn.close()
            await head.stop()

    asyncio.run(first())

    async def second():
        from ray_tpu_torch.runtime.head import HeadService

        head = HeadService(journal_path=path)
        addr = await head.start()
        conn = await rpc.connect(addr)
        try:
            stats = await conn.call("profile_stats")
            assert "sigX" in stats["fingerprints"]  # survived restart
            await conn.call("add_task_events", events=[
                _profile_span("jobA", "sigX", DRIFT_SHARES, time.time()),
            ])
            stats = await conn.call("profile_stats")
            rec = stats["jobs"]["jobA"]
            assert rec["alert"] is True
            assert "hbm_bound" in rec["drift"]
            assert "host_gap" in rec["drift"]
            assert "compute_floor" not in rec["drift"]
        finally:
            await conn.close()
            await head.stop()

    asyncio.run(second())


def _feed_profile(rt, job, sig, shares, ts):
    rt.run(rt.core.head.call("add_task_events", events=[
        _profile_span(job, sig, shares, ts)
    ]))


def test_regression_alert_off_on_off(cluster):
    """The sentinel gauge tracks current state: baseline capture OFF,
    drifted capture ON, recovered capture OFF again — next to the
    per-category decomposition gauges."""
    rt = ray_tpu_torch.api._runtime
    base = time.time()
    _feed_profile(rt, "profjob", "sigP", BASE_SHARES, base)
    stats = state.profile_stats()
    assert stats["jobs"]["profjob"]["alert"] is False
    alert_series = ('ray_tpu_profile_regression_alert{job="profjob",'
                    'worker="head"}')
    text = state.prometheus_metrics()
    assert ('ray_tpu_train_mfu_decomposition{job="profjob",'
            'category="hbm_bound",worker="head"} 0.4' in text)
    assert f"{alert_series} 0.0" in text

    _feed_profile(rt, "profjob", "sigP", DRIFT_SHARES, base + 1)
    assert state.profile_stats()["jobs"]["profjob"]["alert"] is True
    assert f"{alert_series} 1.0" in state.prometheus_metrics()

    _feed_profile(rt, "profjob", "sigP", BASE_SHARES, base + 2)
    assert state.profile_stats()["jobs"]["profjob"]["alert"] is False
    assert f"{alert_series} 0.0" in state.prometheus_metrics()


def test_api_profile_and_capture_fanout(cluster):
    """Dashboard /api/profile serves the ledger's per-job record with the
    reference's keys; profile_capture fans the request over the
    collective channel and acks."""
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard

    rt = ray_tpu_torch.api._runtime
    _feed_profile(rt, "apijob", "sigAPI", BASE_SHARES, time.time())
    dash = start_dashboard()
    try:
        with urllib.request.urlopen(dash.url + "/api/profile",
                                    timeout=10) as r:
            body = json.loads(r.read())
    finally:
        dash.stop()
    assert "jobs" in body and "fingerprints" in body
    rec = body["jobs"]["apijob"]
    for key in ("sig", "shares", "step_s", "steps", "dominant_gap",
                "drift", "alert", "path", "ts"):
        assert key in rec
    assert rec["dominant_gap"] == "hbm_bound"
    reply = state.profile_capture(steps=2)
    assert reply["ok"] is True and reply["steps"] == 2


def test_cli_profile_schema(monkeypatch, capsys):
    """The exact `ray_tpu_torch.scripts profile` output path."""
    from ray_tpu_torch import scripts

    monkeypatch.setattr(scripts, "_connect", lambda *a, **k: None)
    stats = {
        "jobs": {
            "jobZ": {
                "sig": "sigZ", "shares": dict(BASE_SHARES),
                "step_s": 0.0213, "steps": 3,
                "dominant_gap": "hbm_bound",
                "drift": {"hbm_bound": -0.75}, "alert": True,
                "path": "/tmp/capture", "ts": 1.0,
            },
        },
        "fingerprints": {"sigZ": {"job": "jobZ"}},
    }
    monkeypatch.setattr(state, "profile_stats", lambda: stats)
    assert scripts.main(["profile"]) == 0
    out = capsys.readouterr().out
    assert "jobZ" in out and "sig=sigZ" in out and "ALERT" in out
    assert "step=21.3ms" in out
    assert "compute_floor=0.300" in out
    assert "dominant_gap: hbm_bound" in out
    assert "drift vs fingerprint" in out

    assert scripts.main(["profile", "--json"]) == 0
    body = json.loads(capsys.readouterr().out)
    assert body["jobs"]["jobZ"]["dominant_gap"] == "hbm_bound"

    monkeypatch.setattr(
        state, "profile_capture", lambda steps=None: {
            "ok": True, "steps": steps
        }
    )
    assert scripts.main(["profile", "--capture", "--steps", "4"]) == 0
    assert "capture requested (steps=4)" in capsys.readouterr().out

    monkeypatch.setattr(state, "profile_stats", lambda: {"jobs": {}})
    assert scripts.main(["profile"]) == 0
    assert "no profile captures" in capsys.readouterr().out


def test_cli_goodput_decomposition_columns(monkeypatch, capsys):
    """`ray_tpu_torch.scripts goodput` prints the in-program decomposition
    next to the exposure ratios."""
    from ray_tpu_torch import scripts

    monkeypatch.setattr(scripts, "_connect", lambda *a, **k: None)
    job = {
        "goodput": 0.91, "steps": 120, "attempts": 1, "mfu": 0.42,
        "productive_s": 100.0, "stall_s": 5.0, "restart_lost_s": 0.0,
        "comm_exposed_s": 2.0, "comm_overlapped_s": 8.0,
        "comm_exposed_ratio": 0.2,
        "profile": {
            "shares": dict(BASE_SHARES), "dominant_gap": "hbm_bound",
            "alert": True, "sig": "sigG", "step_s": 0.02, "steps": 3,
            "drift": {}, "path": "", "ts": 0.0,
        },
    }
    monkeypatch.setattr(
        state, "train_stats", lambda: {"jobs": {"gjob": job}}
    )
    assert scripts.main(["goodput"]) == 0
    out = capsys.readouterr().out
    assert "in_program:" in out
    assert "hbm_bound=0.400" in out
    assert "dominant_gap=hbm_bound" in out
    assert "ALERT" in out
    # Without a capture the goodput rollup prints exactly as before.
    monkeypatch.setattr(
        state, "train_stats",
        lambda: {"jobs": {"gjob": {
            k: v for k, v in job.items() if k != "profile"
        }}},
    )
    assert scripts.main(["goodput"]) == 0
    assert "in_program:" not in capsys.readouterr().out


def _capture_loop_factory():
    """A tiny train step per step_span; after step 1 it writes the
    marker and steps on until this worker's capture report exists (or a
    deadline), so the test's profile_capture lands mid-loop."""

    def loop(config):
        import os as _os
        import time as _t

        import numpy as _np
        import torch

        import ray_tpu_torch.train as train
        from ray_tpu_torch.models.llama import PRESETS
        from ray_tpu_torch.train import profile as _profile
        from ray_tpu_torch.train import step as tstep

        torch.set_num_threads(1)
        cfg = PRESETS["tiny"]
        opt = tstep.make_optimizer(total_steps=100)
        state = tstep.init_train_state(cfg, opt, seed=0, device="cpu")
        step = tstep.jit_train_step(cfg, opt)
        rng = _np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 33)))}
        job = train.get_context().experiment_name
        deadline = _t.monotonic() + config["deadline_s"]
        i = 0
        while _t.monotonic() < deadline:
            with train.step_span(tokens=2 * 32,
                                 flops_per_token=cfg.flops_per_token(32)):
                state, m = step(state, batch)
                loss = float(m["loss"])
            i += 1
            if i == 1:
                with open(config["marker"], "w") as f:
                    f.write(str(_os.getpid()))
            if i > 1 and _profile.last_report(job) is not None:
                break
            _t.sleep(0.05)
        rep = _profile.last_report(job)
        train.report({"loss": loss, "steps": i,
                      "captured": rep is not None,
                      "matmul_s": (rep or {}).get("measured", {}).get(
                          "categories", {}).get("matmul", 0.0)})

    return loop


def test_profile_capture_reaches_a_trainer_worker(cluster, tmp_path):
    """util.state.profile_capture() arms a TorchTrainer worker's step hook
    through the head's fan-out; the worker's next steps are captured and
    come back to the head as a profile:step span, and profile_stats shows
    the job's decomposition."""
    import threading

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    marker = str(tmp_path / "stepped")
    job = "capture-job"
    replies = []

    def requester():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not os.path.exists(marker):
            time.sleep(0.05)
        replies.append(state.profile_capture(steps=1))

    t = threading.Thread(target=requester, daemon=True)
    t.start()
    result = TorchTrainer(
        _capture_loop_factory(),
        train_loop_config={"marker": marker, "deadline_s": 40.0},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name=job, storage_path=str(tmp_path / "runs")),
    ).fit()
    t.join(timeout=60)
    assert result.error is None, result.error
    assert replies and replies[0]["ok"] is True
    assert result.metrics["captured"] is True, result.metrics
    assert result.metrics["matmul_s"] > 0
    rt = ray_tpu_torch.api._runtime
    deadline = time.monotonic() + 30
    spans, rec = [], None
    while time.monotonic() < deadline:
        events = rt.run(rt.core.head.call(
            "list_task_events", limit=20000, raw=True))["events"]
        spans = [e for e in events if e.get("name") == "profile:step"
                 and e.get("train_job") == job]
        rec = state.profile_stats()["jobs"].get(job)
        if spans and rec:
            break
        time.sleep(0.2)
    assert spans, "no profile:step span reached the head"
    span = spans[0]
    for key in ("train_job", "train_rank", "train_attempt", "profile_sig",
                "profile_steps", "profile_step_s", "profile_shares",
                "profile_dominant", "path"):
        assert key in span, key
    assert span["train_rank"] == 0 and span["profile_steps"] == 1
    assert span["profile_measured_s"]["matmul"] > 0
    assert rec is not None
    assert set(rec["shares"]) == set(profile.CATEGORIES)
    assert abs(sum(rec["shares"].values()) - 1.0) <= 0.10
    assert rec["dominant_gap"] in profile.CATEGORIES
    json.dumps(rec)
