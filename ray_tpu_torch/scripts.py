"""CLI: `python -m ray_tpu_torch.scripts <command>` (port of
ray_tpu/scripts.py; reference: `ray status`, `ray list ...`, `ray
timeline` from scripts/scripts.py + state_cli.py).

Commands connect to a running cluster via --address (or
RAY_TPU_ADDRESS). `start` launches the port's daemon
(`python -m ray_tpu_torch.daemon`) with the port's session directory;
`start --tls` needs the `cryptography` package to generate the
certificate, and says so plainly when it is absent (no plaintext
fallback). `lint` runs the port's tpulint (`_private/lint/`) without a
cluster.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _connect(address: str | None, session_dir: str | None = None):
    import os

    import ray_tpu_torch

    from ray_tpu_torch._private import config

    # Same-host convenience: a CLI running where `start` ran can read
    # the session token instead of requiring the env var (`stop`
    # removes the file, so it can't outlive its cluster). Only for
    # THIS session's cluster: sending the local token to an unrelated
    # --address would corrupt that connection.
    if not config.get("AUTH_TOKEN"):
        from ray_tpu_torch.daemon import DEFAULT_SESSION_DIR

        sdir = session_dir or DEFAULT_SESSION_DIR
        token_path = os.path.join(sdir, "auth.token")
        addr_path = os.path.join(sdir, "head.addr")
        session_addr = (
            open(addr_path).read().strip()
            if os.path.exists(addr_path)
            else None
        )

        def _norm(a: str | None) -> str | None:
            # "ray://host:port", "localhost" and "127.0.0.1" all name
            # the same endpoint for this comparison.
            if a is None:
                return None
            a = a.removeprefix("ray://")
            host, _, port = a.rpartition(":")
            host = host.strip("[]")  # bracketed IPv6
            if host in ("localhost", "::1"):
                host = "127.0.0.1"
            return f"{host}:{port}"

        if os.path.exists(token_path) and (
            address is None or _norm(address) == _norm(session_addr)
        ):
            config.set_system_config(
                {"AUTH_TOKEN": open(token_path).read().strip()}
            )
    address = address or config.get("ADDRESS") or None
    if not address:
        # Booting a fresh cluster just to inspect it would print a
        # plausible-looking answer about the wrong cluster (reference:
        # `ray status` errors when no cluster is found).
        print(
            "error: no cluster address (pass --address or set "
            "RAY_TPU_ADDRESS)",
            file=sys.stderr,
        )
        raise SystemExit(2)
    # Observer: read-only attach — the CLI must not register itself as a
    # schedulable node (tasks spilled onto it would die when the command
    # exits seconds later).
    return ray_tpu_torch.init(address=address, observer=True)


def cmd_status(args) -> int:
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    nodes = state.list_nodes()
    print(f"nodes: {len(nodes)}")
    for n in nodes:
        print(
            f"  {n['node_id'][:12]}  {n['addr']}"
            f"  total={n['resources']}  available={n['available']}"
        )
    actors = state.list_actors()
    alive = [a for a in actors if a["state"] == "ALIVE"]
    print(f"actors: {len(alive)} alive / {len(actors)} total")
    print(f"tasks: {state.summarize_tasks()}")
    return 0


def cmd_list(args) -> int:
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    kind = args.kind
    if kind == "nodes":
        out = state.list_nodes()
    elif kind == "actors":
        out = state.list_actors()
    elif kind == "tasks":
        out = state.list_tasks(limit=args.limit)
    elif kind == "placement-groups":
        out = state.list_placement_groups()
    elif kind == "jobs":
        from ray_tpu_torch.job import JobSubmissionClient

        out = JobSubmissionClient().list_jobs()
    else:
        print(f"unknown kind {kind!r}", file=sys.stderr)
        return 2
    json.dump(out, sys.stdout, indent=2, default=str)
    print()
    return 0


def cmd_timeline(args) -> int:
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    path = state.timeline(args.output)
    print(f"wrote chrome trace to {path} (open in chrome://tracing)")
    return 0


def cmd_metrics(args) -> int:
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    sys.stdout.write(state.prometheus_metrics())
    return 0


def cmd_goodput(args) -> int:
    """Per-train-job goodput rollup: productive step time vs. stalls
    and elastic restart loss, plus MFU and phase breakdowns (the head's
    train-step accounting; same data as the dashboard's /api/train)."""
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    jobs = state.train_stats().get("jobs", {})
    if args.json:
        json.dump(jobs, sys.stdout, indent=2, default=str)
        print()
        return 0
    if not jobs:
        print("no train jobs have reported steps")
        return 0
    for name, j in sorted(jobs.items()):
        mfu = (
            f"  mfu={j['mfu']:.4f}" if j.get("mfu") is not None else ""
        )
        print(
            f"{name}: goodput={j['goodput']:.3f}  steps={j['steps']}  "
            f"attempts={j['attempts']}{mfu}"
        )
        print(
            f"  productive={j['productive_s']:.2f}s  "
            f"stalls={j['stall_s']:.2f}s  "
            f"restart_lost={j['restart_lost_s']:.2f}s"
        )
        if j.get("comm_exposed_s") or j.get("comm_overlapped_s"):
            print(
                f"  comm: exposed={j['comm_exposed_s']:.2f}s  "
                f"overlapped={j.get('comm_overlapped_s', 0.0):.2f}s  "
                f"exposed_ratio={j.get('comm_exposed_ratio', 0.0):.3f}"
            )
        if j.get("host_sync_exposed_s"):
            print(
                f"  host_sync: exposed="
                f"{j['host_sync_exposed_s']:.2f}s  exposed_ratio="
                f"{j.get('host_sync_exposed_ratio', 0.0):.3f}"
            )
        prof = j.get("profile")
        if prof:
            shares = "  ".join(
                f"{k}={v:.3f}"
                for k, v in sorted(prof.get("shares", {}).items())
            )
            alert = "  ALERT" if prof.get("alert") else ""
            print(
                f"  in_program: {shares}  "
                f"dominant_gap={prof.get('dominant_gap', '')}{alert}"
            )
        if j.get("phase_s"):
            phases = "  ".join(
                f"{k}={v:.2f}s" for k, v in sorted(j["phase_s"].items())
            )
            print(f"  phases: {phases}")
    return 0


def print_sweeps(stats: dict, as_json: bool = False) -> int:
    """Render the sweep-engine ledger (factored out of cmd_tune so
    tier-1 can smoke the exact CLI output path without a daemonized
    cluster)."""
    sweeps = stats.get("sweeps", {})
    if as_json:
        json.dump(sweeps, sys.stdout, indent=2, default=str)
        print()
        return 0
    if not sweeps:
        print("no sweeps have been journaled")
        return 0
    for sid, rec in sorted(sweeps.items()):
        trials = rec.get("trials", {})
        states: dict[str, int] = {}
        for t in trials.values():
            s = t.get("state", "?")
            states[s] = states.get(s, 0) + 1
        state_str = "  ".join(
            f"{k}={v}" for k, v in sorted(states.items())
        )
        makespan = rec.get("makespan_s")
        print(
            f"{sid}: state={rec.get('state', '?')}  "
            f"trials={len(trials)}  forks={rec.get('forks', 0)}  "
            f"preemptions={rec.get('preemptions', 0)}"
            + (f"  makespan={makespan:.1f}s" if makespan else "")
        )
        if state_str:
            print(f"  {state_str}")
        for tid, t in sorted(trials.items()):
            ledger = t.get("ledger") or {}
            bits = [f"state={t.get('state', '?')}"]
            if ledger.get("steps") is not None:
                bits.append(f"steps={ledger['steps']}")
            if ledger.get("loss") is not None:
                bits.append(f"loss={ledger['loss']:.4f}")
            if ledger.get("goodput") is not None:
                bits.append(f"goodput={ledger['goodput']:.3f}")
            if t.get("attempts"):
                bits.append(f"attempts={t['attempts']}")
            if t.get("forked_from"):
                bits.append(f"forked_from={t['forked_from']}")
            if t.get("stop_reason"):
                bits.append(f"stop={t['stop_reason']}")
            print(f"  {tid}: " + "  ".join(bits))
    return 0


def cmd_tune(args) -> int:
    """Sweep-engine ledger: per-trial gang states with each trial's
    train-job row joined in, plus fork/preemption counters (the head's
    journaled sweeps table; same data as the dashboard's /api/tune)."""
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    return print_sweeps(
        state.sweep_stats(sweep_id=args.sweep), as_json=args.json
    )


def print_profile(stats: dict, as_json: bool = False) -> int:
    """Render the compiled-program profile ledger (factored out of
    cmd_profile so tier-1 can smoke the exact CLI output path without
    a daemonized cluster)."""
    if as_json:
        json.dump(stats, sys.stdout, indent=2, default=str)
        print()
        return 0
    jobs = stats.get("jobs", {})
    if not jobs:
        print(
            "no profile captures have been reported (trigger one with "
            "`ray_tpu_torch profile --capture`)"
        )
        return 0
    for name, rec in sorted(jobs.items()):
        alert = "  ALERT" if rec.get("alert") else ""
        print(
            f"{name}: step={rec.get('step_s', 0.0) * 1e3:.1f}ms  "
            f"steps={rec.get('steps', 0)}  "
            f"sig={rec.get('sig', '')}{alert}"
        )
        shares = "  ".join(
            f"{k}={v:.3f}"
            for k, v in sorted(rec.get("shares", {}).items())
        )
        print(f"  shares: {shares}")
        print(f"  dominant_gap: {rec.get('dominant_gap', '')}")
        if rec.get("drift"):
            drifts = "  ".join(
                f"{k}={v:+.2f}"
                for k, v in sorted(rec["drift"].items())
            )
            print(f"  drift vs fingerprint: {drifts}")
    return 0


def cmd_profile(args) -> int:
    """Compiled-program profiler surface: per-job MFU decomposition
    from the latest capture (the head's profile:step accounting; same
    data as the dashboard's /api/profile). --capture fans a capture
    request out to every rank first."""
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    if args.capture:
        reply = state.profile_capture(steps=args.steps)
        print(
            f"capture requested (steps={reply.get('steps') or 'default'})"
        )
        return 0
    return print_profile(state.profile_stats(), as_json=args.json)


def _fmt_ms(v) -> str:
    return f"{v * 1e3:.0f}ms" if v is not None else "—"


def print_slo(deployments: dict, as_json: bool = False) -> int:
    """Render the per-deployment serve SLO ledger (factored out of
    cmd_slo so tier-1 can smoke the exact CLI output path without a
    daemonized cluster)."""
    if as_json:
        json.dump(deployments, sys.stdout, indent=2, default=str)
        print()
        return 0
    if not deployments:
        print("no serve deployments have reported requests")
        return 0
    for name, d in sorted(deployments.items()):
        alert = "  ALERT" if d.get("alert") else ""
        print(
            f"{name}: requests={d.get('requests', 0)}  "
            f"errors={d.get('errors', 0)}  "
            f"attainment={d.get('attainment', 1.0):.3f}{alert}"
        )
        if d.get("window_requests") is not None:
            print(
                f"  ttft p50={_fmt_ms(d.get('ttft_p50_s'))} "
                f"p99={_fmt_ms(d.get('ttft_p99_s'))}  "
                f"latency p50={_fmt_ms(d.get('latency_p50_s'))} "
                f"p99={_fmt_ms(d.get('latency_p99_s'))}  "
                f"window={d.get('window_requests', 0)} reqs "
                f"({d.get('request_rate_per_s', 0.0):.1f}/s)"
            )
        if d.get("streamed"):
            print(
                f"  streamed={d['streamed']}  items={d.get('items', 0)}"
            )
        asc = d.get("autoscale")
        if asc:
            print(
                f"  autoscale: target={asc.get('target')}  "
                f"replicas={asc.get('replicas')}  "
                f"draining={asc.get('draining')}  "
                f"desired={asc.get('desired')}  "
                f"reason={asc.get('reason')}"
            )
    return 0


def cmd_slo(args) -> int:
    """Per-deployment serve SLO rollup: TTFT/latency percentiles over
    the sliding window, attainment vs SERVE_SLO_TTFT_S /
    SERVE_SLO_LATENCY_S, and the burn-rate alert state (the head's
    serve:ingress-span accounting; same data as /api/serve)."""
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    deployments = state.serve_stats().get("deployments", {})
    return print_slo(deployments, as_json=args.json)


def _fmt_gib(v) -> str:
    return f"{v / (1 << 30):.2f}GiB" if v is not None else "—"


def print_mem(stats: dict, as_json: bool = False) -> int:
    """Render the head memory ledger (factored out of cmd_mem so
    tier-1 can smoke the exact CLI output path without a daemonized
    cluster)."""
    if as_json:
        json.dump(stats, sys.stdout, indent=2, default=str)
        print()
        return 0
    nodes = stats.get("nodes", {})
    jobs = stats.get("jobs", {})
    if not nodes:
        print("no nodes have reported memory samples")
        return 0
    for name, n in sorted(nodes.items()):
        alert = "  ALERT" if n.get("alert") else ""
        print(
            f"{name}: used={_fmt_gib(n.get('used_bytes'))}  "
            f"peak={_fmt_gib(n.get('peak_bytes'))}  "
            f"capacity={_fmt_gib(n.get('capacity_bytes'))}  "
            f"headroom={_fmt_gib(n.get('headroom_bytes'))}{alert}"
        )
        by_kind = n.get("by_kind") or {}
        if by_kind:
            kinds = "  ".join(
                f"{k}={_fmt_gib(v)}"
                for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])
                if v
            )
            if kinds:
                print(f"  by kind: {kinds}")
        if n.get("host_rss_bytes"):
            print(f"  host rss={_fmt_gib(n['host_rss_bytes'])}")
    for name, j in sorted(jobs.items()):
        print(
            f"job {name}: peak={_fmt_gib(j.get('peak_bytes'))}  "
            f"current={_fmt_gib(j.get('used_bytes'))}  "
            f"nodes={len(j.get('nodes') or [])}"
        )
    return 0


def cmd_mem(args) -> int:
    """Per-node device-memory rollup: current/peak used bytes vs
    capacity, per-subsystem attribution, headroom alert state, and
    per-job peaks (the head's mem:sample accounting; same data as the
    dashboard's /api/memory)."""
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    return print_mem(state.mem_stats(), as_json=args.json)


def print_head(stats: dict, as_json: bool = False) -> int:
    """Render the head control-plane load stats (factored out of
    cmd_head so tier-1 can smoke the exact CLI output path without a
    daemonized cluster)."""
    if as_json:
        json.dump(stats, sys.stdout, indent=2, default=str)
        print()
        return 0
    alert = "  OVERLOAD" if stats.get("overload_alert") else ""
    print(
        f"head: uptime={stats.get('uptime_s', 0.0):.0f}s  "
        f"nodes={stats.get('nodes', 0)}  "
        f"draining={stats.get('draining', 0)}  "
        f"slices={stats.get('slices', 0)}  "
        f"actors={stats.get('actors', 0)}{alert}"
    )
    print(
        f"  fold queue: depth={stats.get('fold_queue_depth', 0)}/"
        f"{stats.get('fold_queue_max', 0)}  "
        f"folded={stats.get('folded_total', 0)}  "
        f"shed={stats.get('shed_total', 0)}"
    )
    print(
        f"  pubsub: msgs={stats.get('pub_msgs_total', 0)}  "
        f"pushes={stats.get('pub_pushes_total', 0)}  "
        f"channels={len(stats.get('subscriptions') or {})}"
    )
    j = stats.get("journal")
    if j:
        last = j.get("last_compaction_ts")
        ago = f"{time.time() - last:.0f}s ago" if last else "never"
        print(
            f"  journal: size={j.get('size_bytes', 0)}B  "
            f"floor={j.get('floor_bytes', 0)}B  "
            f"watermark={j.get('watermark_bytes', 0)}B  "
            f"compaction={ago}"
            + ("  (compacting)" if j.get("compacting") else "")
        )
        print(
            f"  replay: records={j.get('replayed_records', 0)}  "
            f"took={j.get('replay_s', 0.0):.3f}s"
        )
    return 0


def cmd_head(args) -> int:
    """Head control-plane load rollup: telemetry fold-queue depth and
    shed counter, overload alert state, pubsub coalescing counters, and
    journal size/compaction/replay accounting (same data as the
    dashboard's /api/head)."""
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    return print_head(state.head_stats(), as_json=args.json)


def cmd_ckpt(args) -> int:
    """Shard-store checkpoints: `ckpt ls` lists per-run manifests with
    dedup'd sizes and replica health; `ckpt verify` probes every chunk
    on its recorded holders and reports under-replicated/lost ones;
    `ckpt push`/`ckpt pull` copy a committed checkpoint to/from the
    remote spill tier (portable across cluster teardowns)."""
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    if args.action in ("push", "pull"):
        from ray_tpu_torch.checkpoint import remote as _remote

        if not args.run:
            print("ckpt push/pull requires --run", file=sys.stderr)
            return 2
        try:
            tier = _remote.get_tier(args.tier) if args.tier else None
            fn = (
                _remote.push_checkpoint
                if args.action == "push"
                else _remote.pull_checkpoint
            )
            out = fn(args.run, step=args.step, tier=tier)
        except _remote.RemoteTierError as e:
            print(f"ckpt {args.action} failed: {e}", file=sys.stderr)
            return 1
        if args.json:
            json.dump(out, sys.stdout, indent=2, default=str)
            print()
            return 0
        moved = out.get("uploaded", out.get("inserted", 0))
        verb = "uploaded" if args.action == "push" else "inserted"
        print(
            f"{out['run']} step {out['step']}: {out['chunks']} chunks, "
            f"{moved} {verb}"
        )
        return 0
    if args.action == "verify":
        report = state.verify_checkpoints(run=args.run)
        if args.json:
            json.dump(report, sys.stdout, indent=2, default=str)
            print()
            return 0
        rows = report.get("checkpoints", [])
        if not rows:
            print("no complete checkpoints in the shard store")
            return 0
        bad = 0
        for r in rows:
            n_under = len(r["under_replicated"])
            n_lost = len(r["lost"])
            bad += n_under + n_lost
            print(
                f"{r['run']} step {r['step']}: {r['chunks']} chunks, "
                f"{r['healthy']} at replication "
                f"{r['replication_target']}, {n_under} under-replicated, "
                f"{n_lost} lost"
            )
            colocated = r.get("colocated") or []
            if colocated:
                # Not counted in the exit code: the replicas exist —
                # but one slice preemption away from not existing.
                print(
                    f"  WARNING: {len(colocated)} chunks have two "
                    "replicas on the SAME slice (whole-slice loss "
                    "would drop them to one copy): "
                    + ", ".join(h[:12] + "…" for h in colocated[:4])
                    + ("…" if len(colocated) > 4 else "")
                )
        return 1 if bad else 0
    data = state.list_checkpoints(run=args.run)
    if args.json:
        json.dump(data, sys.stdout, indent=2, default=str)
        print()
        return 0
    runs = data.get("runs", {})
    if not any(runs.values()):
        print("no checkpoints in the shard store")
        return 0
    for run, rows in sorted(runs.items()):
        for r in rows:
            status = "complete" if r["complete"] else (
                f"partial {len(r['ranks'])}/{r['world']}"
            )
            ec = (
                f"  parity_groups={r['parity_groups']}"
                if r.get("parity_groups")
                else ""
            )
            print(
                f"{run} step {r['step']}: {status}  world={r['world']}  "
                f"bytes={r['bytes']}  chunks={r['chunks']}  "
                f"min_replicas={r['min_replicas']}{ec}"
            )
    return 0


def cmd_dashboard(args) -> int:
    import time

    from ray_tpu_torch.dashboard import start_dashboard

    _connect(args.address, getattr(args, "session_dir", None))
    dash = start_dashboard(port=args.port)
    print(f"dashboard at {dash.url} (ctrl-c to stop)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        dash.stop()
    return 0


def cmd_start(args) -> int:
    """Bring up daemonized cluster processes on this host (reference:
    `ray start --head` / `--address`, scripts/scripts.py:682). One
    command per host: `start --head` on the first host, `start
    --address <head>` on the rest."""
    import os
    import subprocess
    import time

    from ray_tpu_torch.daemon import DEFAULT_SESSION_DIR

    session_dir = args.session_dir or DEFAULT_SESSION_DIR
    os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)
    # Daemon logs echo cluster internals (addresses, join hints): keep
    # the whole session dir operator-only, like the 0600 token file.
    os.chmod(session_dir, 0o700)

    # Auth is ON by default: resolve (or generate) the token here so the
    # join command can be printed, and hand it to the daemon via the
    # environment — argv would leak it to every `ps` on the host.
    from ray_tpu_torch.daemon import resolve_token

    env = dict(os.environ)
    token = resolve_token(
        session_dir,
        explicit=args.auth_token,
        no_auth=args.no_auth,
        is_head=args.head,
        host=args.host,
        warn=lambda msg: print(msg, file=sys.stderr),
    )
    token_path = os.path.join(session_dir, "auth.token")
    if token:
        env["RAY_TPU_AUTH_TOKEN"] = token
    else:
        env.pop("RAY_TPU_AUTH_TOKEN", None)

    if args.tls and args.head and not _tls_material_given(session_dir):
        import importlib.util

        if importlib.util.find_spec("cryptography") is None:
            print(
                "error: --tls generates a self-signed certificate with the "
                "'cryptography' package, which is not installed here; "
                "install it, or give an existing cert and key "
                "(RAY_TPU_TLS_CERT / RAY_TPU_TLS_KEY, or tls.crt and "
                "tls.key in the session dir)",
                file=sys.stderr,
            )
            return 2
    if args.head:
        role = "head"
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.daemon", "head",
            "--host", args.host, "--port", str(args.port),
            "--session-dir", session_dir,
        ]
        if args.no_auth:
            cmd.append("--no-auth")
        if args.tls:
            cmd.append("--tls")
        if args.head_only:
            cmd.append("--head-only")
    else:
        if not args.address:
            print(
                "error: pass --head to start a head, or --address "
                "host:port to join one",
                file=sys.stderr,
            )
            return 2
        role = "node"
        cmd = [
            sys.executable, "-m", "ray_tpu_torch.daemon", "node",
            "--address", args.address,
            "--host", args.host,
            "--session-dir", session_dir,
        ]
        if args.no_auth:
            cmd.append("--no-auth")
        if args.tls:
            cmd.append("--tls")
    if args.num_cpus is not None:
        cmd += ["--num-cpus", str(args.num_cpus)]
    if args.resources:
        cmd += ["--resources", args.resources]

    log_path = os.path.join(session_dir, "logs", f"{role}.log")
    if args.head:
        # A stale address file from a crashed prior head would be read
        # as the NEW head's address the instant the wait loop starts.
        try:
            os.unlink(os.path.join(session_dir, "head.addr"))
        except OSError:
            pass
    if args.block:
        return subprocess.call(cmd, env=env)
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True,  # survive the CLI's terminal
        )
    pid_path = os.path.join(session_dir, f"{role}-{proc.pid}.pid")
    with open(pid_path, "w") as f:
        f.write(str(proc.pid))

    if args.head:
        # Wait for the daemon to publish its address.
        addr_path = os.path.join(session_dir, "head.addr")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                print(
                    f"head daemon exited rc={proc.returncode}; "
                    f"see {log_path}",
                    file=sys.stderr,
                )
                return 1
            if os.path.exists(addr_path):
                addr = open(addr_path).read().strip()
                print(f"head started at {addr} (pid {proc.pid})")
                # Only print the literal secret to an interactive terminal;
                # in CI/scripts it would land in captured logs, so show a
                # placeholder pointing at the 0600 token file instead.
                if token and sys.stdout.isatty():
                    prefix = f"RAY_TPU_AUTH_TOKEN={token} "
                    token_note = ""
                elif token:
                    # $(cat ...) only resolves on the joining host after
                    # the operator copies auth.token there — say so.
                    prefix = f"RAY_TPU_AUTH_TOKEN=$(cat {token_path}) "
                    token_note = " (copy auth.token over first)"
                else:
                    prefix = ""
                    token_note = ""
                tls_note = " --tls (copy tls.crt over first)" if args.tls else ""
                print(
                    f"join other hosts with: {prefix}python -m "
                    f"ray_tpu_torch.scripts start --address {addr}"
                    f"{tls_note}{token_note}"
                )
                if token:
                    print(f"auth token: {token_path} (0600)")
                print("stop with: python -m ray_tpu_torch.scripts stop")
                return 0
            time.sleep(0.1)
        print(f"head did not come up in 30s; see {log_path}",
              file=sys.stderr)
        return 1
    # Node mode: catch immediate failures (bad address, missing auth
    # token) instead of reporting success for a daemon that already died.
    time.sleep(1.0)
    if proc.poll() is not None:
        print(
            f"node daemon exited rc={proc.returncode}; see {log_path}",
            file=sys.stderr,
        )
        try:
            os.unlink(pid_path)
        except OSError:
            pass
        return 1
    print(f"node started (pid {proc.pid}), joining {args.address}")
    return 0


def _tls_material_given(session_dir: str) -> bool:
    """Whether the daemon's --tls finds a cert and key to load (config,
    else the session dir), so that it generates none."""
    import os

    from ray_tpu_torch._private import config

    cert = config.get("TLS_CERT") or os.path.join(session_dir, "tls.crt")
    key = config.get("TLS_KEY") or os.path.join(session_dir, "tls.key")
    return os.path.exists(cert) and os.path.exists(key)


def cmd_stop(args) -> int:
    """Stop daemons started by `start` on this host: SIGTERM every
    tracked pid, escalate to SIGKILL after a grace period (reference:
    `ray stop`)."""
    import os
    import signal as _signal
    import time

    from ray_tpu_torch.daemon import DEFAULT_SESSION_DIR

    session_dir = args.session_dir or DEFAULT_SESSION_DIR
    if not os.path.isdir(session_dir):
        print("nothing to stop (no session dir)")
        return 0
    pids = []
    for name in os.listdir(session_dir):
        if not name.endswith(".pid"):
            continue
        path = os.path.join(session_dir, name)
        try:
            pid = int(open(path).read().strip())
        except (OSError, ValueError):
            os.unlink(path)
            continue
        try:
            os.kill(pid, _signal.SIGTERM)
            pids.append((pid, path))
        except ProcessLookupError:
            os.unlink(path)
    deadline = time.monotonic() + args.grace
    for pid, path in pids:
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            try:
                os.kill(pid, _signal.SIGKILL)
            except ProcessLookupError:
                pass
        os.unlink(path)
        print(f"stopped pid {pid}")
    # A stale address or token from this cluster would poison the next
    # one started in the same session dir (TLS material stays: it is
    # not cluster-instance state, and regenerating it would force a
    # re-copy to every host).
    for name in ("head.addr", "auth.token"):
        try:
            os.unlink(os.path.join(session_dir, name))
        except OSError:
            pass
    return 0


def cmd_logs(args) -> int:
    """List or print worker logs across the cluster (reference:
    `ray logs`, which reads /tmp/ray/session_*/logs via the agents).
    With no worker id: one line per captured log. With a worker-id
    prefix: print that worker's log — dead workers included."""
    from ray_tpu_torch.util import state

    _connect(args.address, getattr(args, "session_dir", None))
    if args.worker_id:
        text = state.read_worker_log(args.worker_id, tail_bytes=args.tail)
        if text is None:
            print(f"no log found for worker {args.worker_id!r}",
                  file=sys.stderr)
            return 1
        sys.stdout.write(text)
        return 0
    for rec in state.list_worker_logs():
        status = "alive" if rec["alive"] else "dead"
        print(
            f"{rec['worker_id']}  node={rec['node_id'][:12]}  "
            f"{rec['size']:>8}B  {status}"
        )
    return 0


def cmd_config(args) -> int:
    """Print the config registry with resolved values (reference: the
    internal-config surface of GetInternalConfig)."""
    from ray_tpu_torch._private import config

    for name, info in sorted(config.describe().items()):
        mark = "*" if info["value"] != info["default"] else " "
        print(
            f"{mark} {info['env']:<34} {info['type']:<6} "
            f"value={info['value']!r:<12} default={info['default']!r:<10} "
            f"{info['doc']}"
        )
    return 0


def main(argv=None) -> int:
    import os
    import tempfile

    argv = list(sys.argv[1:] if argv is None else argv)
    # `lint` needs no cluster and owns its full flag set — delegate
    # before the cluster-flavored parser sees the args.
    if argv[:1] == ["lint"]:
        from ray_tpu_torch._private.lint.cli import main as lint_main

        return lint_main(argv[1:])

    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    p.add_argument("--address", default=None, help="head address host:port")
    p.add_argument("--session-dir", default=None,
                   help="session dir to read the auth token from "
                        "(same-host convenience; default "
                        "<tmp>/ray_tpu_torch_cluster)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", default=None,
                    help="head address to join (worker-node mode)")
    sp.add_argument("--port", type=int, default=6380)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--resources", default=None, help="JSON dict")
    sp.add_argument("--session-dir", default=argparse.SUPPRESS)
    sp.add_argument("--head-only", action="store_true",
                    help="head service without a co-located node (so a "
                         "head crash can't take worker processes down)")
    sp.add_argument("--auth-token", default=None,
                    help="shared-secret token (default: generated on "
                         "--head, read from the session dir on join)")
    sp.add_argument("--no-auth", action="store_true",
                    help="disable the connection token (loopback dev "
                         "only; a warning is printed for routable hosts)")
    sp.add_argument("--tls", action="store_true",
                    help="encrypt cluster RPC with a self-signed cert "
                         "generated in the session dir")
    sp.add_argument("--block", action="store_true",
                    help="run in the foreground")
    stp = sub.add_parser("stop")
    stp.add_argument("--session-dir", default=argparse.SUPPRESS)
    stp.add_argument("--grace", type=float, default=10.0)

    sub.add_parser("status")
    lp = sub.add_parser("list")
    lp.add_argument(
        "kind",
        choices=["nodes", "actors", "tasks", "placement-groups", "jobs"],
    )
    lp.add_argument("--limit", type=int, default=200)
    tp = sub.add_parser("timeline")
    tp.add_argument("--output", default=os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch_timeline.json"))
    sub.add_parser("metrics")
    gp = sub.add_parser("goodput")
    gp.add_argument("--json", action="store_true",
                    help="raw per-job stats as JSON")
    tn = sub.add_parser("tune",
                        help="sweep-engine ledger (per-trial gang "
                             "states, rung stops, PBT forks, "
                             "preemption migrations)")
    tn.add_argument("--sweep", default=None,
                    help="restrict to one sweep id")
    tn.add_argument("--json", action="store_true",
                    help="raw sweeps table as JSON")
    pf = sub.add_parser("profile",
                        help="compiled-program MFU decomposition from "
                             "the latest capture (+ regression-"
                             "sentinel drift)")
    pf.add_argument("--json", action="store_true",
                    help="raw profile stats as JSON")
    pf.add_argument("--capture", action="store_true",
                    help="fan a capture request out to every rank "
                         "instead of printing")
    pf.add_argument("--steps", type=int, default=None,
                    help="steps per capture (default "
                         "PROFILE_CAPTURE_STEPS)")
    slo = sub.add_parser("slo",
                         help="per-deployment serve SLO attainment "
                              "(TTFT/latency percentiles + alert)")
    slo.add_argument("--json", action="store_true",
                     help="raw per-deployment stats as JSON")
    mp = sub.add_parser("mem",
                        help="per-node device-memory ledger "
                             "(used/peak/headroom + per-subsystem "
                             "attribution + alert)")
    mp.add_argument("--json", action="store_true",
                    help="raw per-node/per-job stats as JSON")
    hp = sub.add_parser("head",
                        help="head control-plane load (fold-queue "
                             "depth, shed counter, overload alert, "
                             "journal size/compaction)")
    hp.add_argument("--json", action="store_true",
                    help="raw head stats as JSON")
    cp = sub.add_parser("ckpt",
                        help="in-cluster shard-store checkpoints")
    cp.add_argument("action", choices=["ls", "verify", "push", "pull"],
                    help="ls: list checkpoints; verify: probe every "
                         "chunk replica on its holders; push/pull: copy "
                         "a checkpoint to/from the remote spill tier")
    cp.add_argument("--run", default=None, help="restrict to one run")
    cp.add_argument("--step", type=int, default=None,
                    help="push/pull: checkpoint step (default: newest)")
    cp.add_argument("--tier", default=None,
                    help="push/pull: tier spec (path or gs://…); "
                         "default: RAY_TPU_CKPT_REMOTE_TIER")
    cp.add_argument("--json", action="store_true",
                    help="raw head reply as JSON")
    lg = sub.add_parser("logs")
    lg.add_argument("worker_id", nargs="?", default=None,
                    help="worker-id prefix; omit to list all logs")
    lg.add_argument("--tail", type=int, default=0,
                    help="print only the last N bytes")
    dp = sub.add_parser("dashboard")
    dp.add_argument("--port", type=int, default=8265)
    sub.add_parser("config")
    # Dispatched above (before cluster flags); listed here so it shows
    # in --help.
    sub.add_parser(
        "lint",
        help="tpulint static analysis (see "
             "`python -m ray_tpu_torch._private.lint --help`)",
    )

    args = p.parse_args(argv)
    return {
        "start": cmd_start,
        "stop": cmd_stop,
        "status": cmd_status,
        "list": cmd_list,
        "timeline": cmd_timeline,
        "metrics": cmd_metrics,
        "goodput": cmd_goodput,
        "tune": cmd_tune,
        "profile": cmd_profile,
        "slo": cmd_slo,
        "mem": cmd_mem,
        "head": cmd_head,
        "ckpt": cmd_ckpt,
        "logs": cmd_logs,
        "dashboard": cmd_dashboard,
        "config": cmd_config,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
