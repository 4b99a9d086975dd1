"""Central config registry (reference: the RAY_CONFIG X-macro list,
src/ray/common/ray_config_def.h — 228 typed knobs with env overrides —
and the `_system_config` dict `ray.init` threads through the GCS,
gcs_service.proto:642 GetInternalConfig).

Every knob is declared ONCE here with type, default, and doc. Resolution
order: programmatic override (init(system_config=...)) → environment
variable ``RAY_TPU_<NAME>`` → default. Worker processes inherit the
driver's overrides through the environment (set_system_config exports
them), the same propagation path the reference uses for its serialized
_system_config."""

from __future__ import annotations

import os
from typing import Any

# name → (type, default, doc). The env var is RAY_TPU_<NAME>.
CONFIG_DEFS: dict[str, tuple[type, Any, str]] = {
    # --- object store / spilling
    "POOL_BYTES": (int, 0, "shm pool capacity; 0 = auto (30% free, ≤2GiB)"),
    "DISABLE_NATIVE_STORE": (bool, False, "force the file-per-object store"),
    "SPILL_HIGH": (float, 0.8, "store usage fraction that triggers spilling"),
    "SPILL_LOW": (float, 0.5, "spill target usage fraction"),
    "SPILL_DIR": (str, "", "disk spill directory override"),
    # --- scheduling / memory
    "SCHED_TIMEOUT_S": (float, 60.0, "wait for autoscaler before failing "
                                     "an infeasible lease"),
    "MEMORY_THRESHOLD": (float, 0.95, "system memory fraction that "
                                      "triggers the OOM worker killer"),
    "HEALTH_TIMEOUT_S": (float, 30.0, "heartbeat silence before the head "
                                      "declares a node dead"),
    "FAKE_MEMORY_FRAC_FILE": (str, "", "test hook: read memory fraction "
                                       "from this file"),
    "FAKE_CHIPS": (str, "", "test hook: report this many TPU chips"),
    "NODE_LABELS": (str, "", "extra node labels as k=v,k=v"),
    "NODE_AGENT": (bool, True, "per-node dashboard agent (node-local "
                               "/healthz /api/stats /api/logs /metrics)"),
    "NODE_AGENT_HOST": (str, "127.0.0.1", "agent bind host — loopback "
                                          "by default: the agent has "
                                          "no auth, so expose it only "
                                          "behind your own proxy"),
    "MAX_LINEAGE_BYTES": (int, 512 << 20, "lineage byte budget per worker; "
                                          "oldest entries evict past it"),
    "WORKER_JAX_PLATFORMS": (str, "cpu", "JAX_PLATFORMS for spawned "
                                         "workers"),
    # --- compiled graphs
    "DAG_BUFFER_SIZE": (int, 256 * 1024, "channel slot capacity (bytes)"),
    "DAG_MAX_BUFFERED": (int, 8, "max in-flight executions per DAG"),
    "DAG_GET_TIMEOUT": (float, 30.0, "CompiledDAGRef.get timeout"),
    "DAG_SUBMIT_TIMEOUT": (float, 30.0, "execute() backpressure timeout"),
    # --- worker log pipeline
    "LOG_TO_DRIVER": (bool, True, "stream worker stdout/stderr to drivers "
                                  "via pubsub"),
    "LOG_DIR": (str, "", "worker log directory override"),
    # --- head fault tolerance
    "HEAD_JOURNAL": (str, "", "journal file for durable head state "
                              "(KV/actors/PGs); empty = off for "
                              "library init() (its session dir is "
                              "ephemeral), session default for CLI "
                              "daemons ('off' disables those too)"),
    "JOURNAL_FSYNC": (bool, False, "fsync every journal append (power-"
                                   "loss durability; default survives "
                                   "process crashes only)"),
    "JOURNAL_COMPACT_BYTES": (int, 8 << 20, "rewrite the head journal "
                                            "as one snapshot once it "
                                            "grows past this size"),
    "HEAD_RECONNECT_S": (float, 20.0, "how long clients retry head calls "
                                      "across a head restart"),
    # --- control-plane overload protection
    "HEAD_FOLD_QUEUE_MAX": (int, 20000, "bounded head telemetry fold "
                                        "queue: add_task_events batches "
                                        "queue here and fold off the "
                                        "dispatch path; when full the "
                                        "OLDEST events shed "
                                        "(ray_tpu_head_shed_total) "
                                        "rather than stall control RPCs"),
    "HEAD_SNAPSHOT_WATERMARK_BYTES": (int, 4 << 20, "journal bytes "
                                      "appended since the last snapshot "
                                      "before compaction fires "
                                      "regardless of the 2x floor "
                                      "guard — bounds restart-replay "
                                      "depth when the tables themselves "
                                      "are large (1000-node regime)"),
    "RPC_BACKOFF_BASE_S": (float, 0.2, "reconnect backoff base: attempt "
                                       "n sleeps uniform(0, min(cap, "
                                       "base*2^n)) — full jitter so a "
                                       "head restart's re-dial herd "
                                       "spreads instead of spiking"),
    "RPC_BACKOFF_MAX_S": (float, 5.0, "per-sleep cap on the jittered "
                                      "exponential reconnect backoff"),
    "RPC_RECONNECT_ATTEMPTS": (int, 64, "cap on reconnect attempts per "
                                        "call (0 = bounded only by the "
                                        "HEAD_RECONNECT_S deadline)"),
    "HEAD_NICE": (int, 0, "daemonized head only: renice the head "
                          "process to this value (e.g. -5) so control "
                          "RPCs win CPU contention against co-located "
                          "data-plane work; 0 = leave priority alone; "
                          "negative values need privileges and degrade "
                          "to a warning without them"),
    "HEAD_GC_FREEZE": (bool, True, "daemonized head only: gc.freeze() "
                                   "after boot + raised gen0 threshold "
                                   "— at 100k+ telemetry events/s the "
                                   "default (700,10,10) cadence runs "
                                   "full gen2 passes ~2/s, each "
                                   "scanning every module object plus "
                                   "the queued event dicts: tens-of-ms "
                                   "control-RPC tail spikes"),
    # --- rpc hardening
    "AUTH_TOKEN": (str, "", "shared-secret connection token; empty "
                            "disables auth (the start CLI generates one "
                            "by default — see scripts.py start)"),
    "TLS_CERT": (str, "", "path to a PEM cert: servers present it, "
                          "clients pin it (self-signed is fine; "
                          "`start --head --tls` generates one)"),
    "TLS_KEY": (str, "", "path to the PEM private key for TLS_CERT "
                         "(servers only)"),
    "RPC_MAX_FRAME": (int, 2 << 30, "largest accepted rpc frame (bytes)"),
    "WORKER_MODE": (str, "subprocess", "worker isolation: 'subprocess' "
                                       "(default) or 'inproc' — scale-"
                                       "simulation mode where workers "
                                       "are CoreWorkers on the node "
                                       "loop; the control plane "
                                       "(registration, leases, sync, "
                                       "journal) stays real, only "
                                       "process isolation is simulated"),
    # --- runtime envs
    "ENV_CACHE_BYTES": (int, 10 << 30, "built runtime-env cache budget; "
                                       "unreferenced envs evict oldest-"
                                       "idle-first past it"),
    "CPP_WORKER_CMD": (str, "", "command line for the C++ worker binary "
                                "(e.g. cpp/build/raytpu_worker); spawned "
                                "for leases whose runtime_env is "
                                "{'language': 'cpp'}"),
    # --- node drain / preemption
    "DRAIN_DEADLINE_S": (float, 30.0, "default drain notice window: how "
                                      "long a DRAINING node is expected "
                                      "to keep serving before it dies "
                                      "(GCE preemption notice is ~30s)"),
    "DRAIN_SIGTERM_LINGER_S": (float, 0.0, "how long a SIGTERMed node "
                                           "daemon keeps serving after "
                                           "self-reporting drain (0 = "
                                           "stop right after the "
                                           "notice; a second signal "
                                           "always cuts the linger "
                                           "short)"),
    "TRAIN_EMERGENCY_CHECKPOINT": (bool, True, "on a drain notice for "
                                               "this worker's node, "
                                               "report() raises "
                                               "PreemptedError once a "
                                               "checkpoint is in hand "
                                               "so the attempt resumes "
                                               "losing ≤1 step"),
    # --- sweep engine (tune)
    "TUNE_MAX_CONCURRENT": (int, 0, "trial gangs admitted at once "
                                    "(0 = as many as fit the healthy "
                                    "chip budget)"),
    "TUNE_ADMISSION_HEADROOM": (float, 0.0, "fraction of per-chip HBM "
                                            "the memory-planner "
                                            "admission check must "
                                            "leave free before a "
                                            "trial gang is admitted"),
    "TUNE_POLL_S": (float, 0.2, "sweep orchestrator poll interval: "
                                "ledger reads, rung checks, admission "
                                "retries"),
    "TUNE_INFRA_RETRIES": (int, 2, "re-admissions granted to a trial "
                                   "after an INFRA failure (worker/"
                                   "actor death); preemptions retry "
                                   "unconditionally, trial-code "
                                   "errors never do"),
    # --- distributed checkpoints
    "CKPT_REPLICATION": (int, 2, "total in-cluster copies of each "
                                 "checkpoint chunk (1 = local store "
                                 "only, no durability without a shared "
                                 "filesystem)"),
    "CKPT_CHUNK_BYTES": (int, 1 << 20, "content-addressed checkpoint "
                                       "chunk size (the dedup "
                                       "granularity)"),
    "CKPT_KEEP": (int, 2, "complete checkpoints retained per run in the "
                          "shard store; older manifests prune and their "
                          "unreferenced chunks are collected"),
    "CKPT_REPAIR_INTERVAL_S": (float, 2.0, "head repair-loop cadence for "
                                           "re-replicating under-"
                                           "replicated checkpoint "
                                           "chunks"),
    "CKPT_PERSIST_DELAY_S": (float, 0.0, "chaos spec: hold the window "
                                         "between chunk writes and the "
                                         "manifest commit open this "
                                         "long (kill-mid-save tests)"),
    "CKPT_ERASURE": (str, "", "'k,m' enables chunk-level erasure coding: "
                              "k data + m parity shards per group, "
                              "placed on distinct slices; any m losses "
                              "reconstruct ((k+m)/k bytes vs "
                              "replication's Nx). Empty = off"),
    "CKPT_VERIFY_READS": (bool, True, "re-hash every chunk on get_chunk; "
                                      "a mismatch is treated as a "
                                      "missing replica (corruption "
                                      "detection on the read path)"),
    "CKPT_CORRUPT": (str, "", "chaos spec: 'prefix:prob' — chunk reads "
                              "whose hash starts with prefix are "
                              "bit-flipped with probability prob "
                              "(deterministic per chunk), driving the "
                              "detect→reconstruct path"),
    "CKPT_REMOTE_TIER": (str, "", "remote spill tier for committed "
                                  "checkpoints: a directory path or "
                                  "file:// URI (FileTier), or gs:// "
                                  "(GCS, requires the cloud SDK). "
                                  "Empty = in-cluster only"),
    "CKPT_REMOTE_TIMEOUT_S": (float, 10.0, "deadline per remote-tier "
                                           "call; a slow or dead tier "
                                           "becomes a typed "
                                           "RemoteTierError, never a "
                                           "hang"),
    "REMOTE_TIER_FAIL": (str, "", "chaos spec: 'outage' (every tier call "
                                  "raises) or 'latency:<s>' (every tier "
                                  "call sleeps that long first; the "
                                  "deadline still applies)"),
    "OBJECT_DRAIN_EVACUATION": (bool, True, "on a drain notice, owners "
                                            "push sole-primary objects "
                                            "off the draining node to a "
                                            "healthy peer (or the "
                                            "remote tier when no peer "
                                            "fits)"),
    # --- misc
    "RPC_FAILURE": (str, "", "chaos spec: comma-separated method:prob "
                             "list ('*' matches any method)"),
    "HEAD_STALL": (str, "", "chaos spec: comma-separated "
                            "'method:seconds' — the head sleeps that "
                            "long inside each matching RPC handler "
                            "('*' matches any method, 'fold' stalls "
                            "the telemetry fold worker instead); "
                            "deterministic overload/starvation "
                            "injection for the admission-class tests"),
    "PREEMPT_AFTER_S": (str, "", "chaos spec: '<delay_s>[@<substr>]' — "
                                 "synthetic preemption notice: a node "
                                 "whose node_id/addr contains <substr> "
                                 "(every node when omitted) self-drains "
                                 "<delay_s> seconds after start"),
    "COLLECTIVE_TIMEOUT_S": (float, 60.0, "default collective deadline "
                                          "(rendezvous and per-op); "
                                          "group override via "
                                          "init_collective_group("
                                          "timeout_s=), per-op via the "
                                          "verb's timeout_s="),
    "COLLECTIVE_PARTIAL_GRACE_S": (float, 1.0, "default partial-mode "
                                               "sub-deadline past the "
                                               "fastest arrival "
                                               "(allreduce grace_s= "
                                               "overrides per op); "
                                               "fallback when the "
                                               "adaptive window has too "
                                               "few lag samples"),
    "COLLECTIVE_ADAPTIVE_GRACE": (bool, True, "derive the partial-mode "
                                              "grace window from the "
                                              "hub's straggler-lag "
                                              "histogram (p99 * 1.5, "
                                              "clamped to COLLECTIVE_"
                                              "GRACE_MIN/MAX_S) instead "
                                              "of the static default"),
    "COLLECTIVE_GRACE_MIN_S": (float, 0.1, "lower clamp for the "
                                           "adaptive grace window"),
    "COLLECTIVE_GRACE_MAX_S": (float, 10.0, "upper clamp for the "
                                            "adaptive grace window"),
    "COLLECTIVE_ALGO_CROSSOVER": (str, "", "tree-to-ring crossover "
                                           "override for algo='auto': "
                                           "a byte count ('65536') or "
                                           "per-world entries "
                                           "('2:65536,8:262144'); "
                                           "empty = built-in table"),
    "COLLECTIVE_COMPRESSION_BLOCK": (int, 256, "elements per absmax "
                                               "scale block of the "
                                               "int8 collective "
                                               "codec"),
    "COLLECTIVE_BUCKET_MB": (float, 4.0, "target gradient bucket size "
                                         "(MiB) for the bucketed "
                                         "overlap sync (collective/"
                                         "bucketer.py); ScalingConfig("
                                         "grad_bucket_mb=) overrides "
                                         "per trainer"),
    "STRAGGLER_DELAY": (str, "", "chaos spec: comma-separated "
                                 "'rank:seconds' — the named collective "
                                 "ranks sleep that long before every "
                                 "contribution (deterministic straggler "
                                 "injection, cpu backend)"),
    "SLICE_FAIL": (str, "", "chaos spec: comma-separated 'slice:when' — "
                            "'1:0.5' delays every rank of slice 1 by "
                            "0.5s per op (a whole-slice straggler); "
                            "'1:kill' / '1:kill@2' SIGKILLs every rank "
                            "of slice 1 (after 2s). The hierarchical "
                            "allreduce treats a killed slice as dead "
                            "(skipped in partial mode) and a delayed "
                            "slice as late"),
    "SLICE_FAULT_DOMAINS": (bool, True, "treat a slice as the unit of "
                                        "failure: a drain notice or "
                                        "unexpected death of any host "
                                        "of a slice drains the WHOLE "
                                        "slice, and the autoscaler "
                                        "provisions one replacement "
                                        "slice per draining slice "
                                        "instead of per node"),
    "COLLECTIVE_SKIP_DRAIN_THRESHOLD": (int, 10, "partial-collective "
                                                 "skips of one rank "
                                                 "within the sliding "
                                                 "window that escalate "
                                                 "it to the head as a "
                                                 "chronic straggler"),
    "COLLECTIVE_SKIP_WINDOW_S": (float, 60.0, "sliding window for the "
                                              "chronic-skip escalation "
                                              "threshold"),
    "COLLECTIVE_SKIP_DRAIN": (bool, True, "head drains a reported "
                                          "chronic straggler's node "
                                          "(drain-and-replace) instead "
                                          "of only flagging it"),
    "TRAIN_GOODPUT_ALERT_RATIO": (float, 0.5, "head warns (log + "
                                              "ray_tpu_train_goodput_"
                                              "alert gauge) when a "
                                              "job's stall+degraded "
                                              "fraction over the alert "
                                              "window exceeds this"),
    "TRAIN_GOODPUT_ALERT_WINDOW_S": (float, 60.0, "sliding window for "
                                                  "the goodput alert "
                                                  "ratio"),
    "TRACE": (bool, False, "enable span collection in every process"),
    "TRAIN_TELEMETRY": (bool, True, "train step-phase spans + goodput/"
                                    "MFU accounting (always-cheap; 0 "
                                    "makes step_span a pinned-budget "
                                    "no-op)"),
    "SERVE_TELEMETRY": (bool, True, "serve request-path spans (ingress/"
                                    "queue/prefill/decode) + TTFT/"
                                    "latency histograms + the head SLO "
                                    "ledger (always-cheap; 0 makes the "
                                    "per-request hooks pinned-budget "
                                    "no-ops)"),
    "SERVE_SLO_TTFT_S": (float, 2.0, "per-request time-to-first-token "
                                     "SLO target; streamed requests "
                                     "attain when TTFT is at or under "
                                     "it"),
    "SERVE_SLO_LATENCY_S": (float, 30.0, "per-request end-to-end "
                                         "latency SLO target (the "
                                         "attainment bound for unary "
                                         "requests, and a second bound "
                                         "for streams)"),
    "SERVE_SLO_TARGET": (float, 0.95, "required fraction of requests "
                                      "attaining their SLO over the "
                                      "window; below it the head warns "
                                      "and sets ray_tpu_serve_slo_"
                                      "alert"),
    "SERVE_SLO_WINDOW_S": (float, 60.0, "sliding window for serve SLO "
                                        "attainment and the burn-rate "
                                        "alert"),
    # --- serve control plane (autoscaling / drain / self-healing)
    "SERVE_AUTOSCALE": (bool, True, "controller policy loop consumes the "
                                    "serve signal plane (handle demand + "
                                    "head SLO ledger) and adjusts replica "
                                    "counts for deployments with an "
                                    "autoscaling_config; 0 freezes every "
                                    "target at its configured value"),
    "SERVE_AUTOSCALE_INTERVAL_S": (float, 1.0, "cadence of the "
                                               "controller's head serve-"
                                               "ledger poll (attainment "
                                               "+ request rate feeding "
                                               "scale decisions)"),
    "SERVE_AUTOSCALE_UP_COOLDOWN_S": (float, 0.0, "minimum seconds "
                                                  "between scale-UPs of "
                                                  "one deployment "
                                                  "(per-deployment "
                                                  "upscale_delay_s "
                                                  "raises it)"),
    "SERVE_AUTOSCALE_DOWN_COOLDOWN_S": (float, 2.0, "desired must stay "
                                                    "below target for "
                                                    "this long before a "
                                                    "scale-down (per-"
                                                    "deployment "
                                                    "downscale_delay_s "
                                                    "raises it); the "
                                                    "anti-flap window"),
    "SERVE_AUTOSCALE_HYSTERESIS": (float, 0.1, "dead-band fraction: a "
                                               "desired count within "
                                               "hysteresis*target of "
                                               "the current target is "
                                               "treated as equal, so "
                                               "demand noise cannot "
                                               "flap large "
                                               "deployments"),
    "SERVE_AUTOSCALE_SLO_BOOST": (bool, True, "scale one replica above "
                                              "the demand-derived count "
                                              "while the head reports "
                                              "the deployment's SLO "
                                              "alert ON (bounded by "
                                              "max_replicas)"),
    "SERVE_DRAIN_TIMEOUT_S": (float, 30.0, "scale-down drain bound: a "
                                           "retiring replica stops "
                                           "accepting, finishes in-"
                                           "flight requests up to this "
                                           "long, then is killed "
                                           "(DeploymentConfig."
                                           "drain_timeout_s overrides "
                                           "per deployment)"),
    "SERVE_RETRY_MAX": (int, 3, "router re-dispatch cap after typed "
                                "replica deaths for one request "
                                "(at-least-once; non-idempotent callers "
                                "opt out via retry_on_failure=False)"),
    "SERVE_RETRY_BACKOFF_S": (float, 0.05, "base of the router's "
                                           "exponential per-retry "
                                           "backoff after a replica "
                                           "death (doubles per retry, "
                                           "capped at 1s)"),
    "SERVE_BREAKER_FAILURES": (int, 3, "consecutive typed failures that "
                                       "OPEN a replica's circuit "
                                       "breaker (the router stops "
                                       "picking it)"),
    "SERVE_BREAKER_RESET_S": (float, 2.0, "seconds an open breaker "
                                          "waits before HALF-OPEN (one "
                                          "probe request; success "
                                          "closes, failure re-opens)"),
    "SERVE_UNAVAILABLE_TIMEOUT_S": (float, 5.0, "how long the router "
                                                "waits with NO routable "
                                                "replica (none known, "
                                                "or all dead/draining/"
                                                "breaker-open) before "
                                                "raising the typed "
                                                "NoReplicaAvailableError"
                                                " the proxy maps to 503 "
                                                "+ Retry-After; "
                                                "saturated-but-alive "
                                                "replicas keep queueing "
                                                "instead"),
    "LLM_PREFILL_DELAY": (float, 0.0, "chaos spec: sleep this long "
                                      "inside every LLM engine prefill "
                                      "admission (deterministic TTFT "
                                      "injection for serve-tracing "
                                      "tests)"),
    "MEM_TELEMETRY": (bool, True, "device/host memory sampling + "
                                  "subsystem byte registration + OOM "
                                  "forensics (always-cheap; 0 makes "
                                  "the per-step sample and track() "
                                  "pinned-budget no-ops)"),
    "MEM_HEADROOM_ALERT_FRACTION": (float, 0.1, "headroom alert "
                                                "threshold: warn (log "
                                                "+ ray_tpu_mem_"
                                                "headroom_alert) when "
                                                "free device memory "
                                                "drops below this "
                                                "fraction of "
                                                "capacity"),
    "MEM_OOM_REPORT_DIR": (str, "", "directory for persisted OOM "
                                    "forensics JSON reports (default: "
                                    "<tmpdir>/ray_tpu_mem)"),
    # --- compiled-program profiler
    "PROFILE": (bool, True, "compiled-program profiler plane: the "
                            "per-step capture hook + profile:step "
                            "reporting (always-cheap; 0 makes the "
                            "step hook a pinned-budget no-op and "
                            "ignores capture requests)"),
    "PROFILE_DIR": (str, "", "directory for jax_profile / capture "
                             "traces (default: <tmpdir>/ray_tpu_"
                             "profile)"),
    "PROFILE_CAPTURE_STEPS": (int, 3, "steps wrapped in one on-device "
                                      "trace per profile_capture "
                                      "request"),
    "PROFILE_REGRESSION_PCT": (float, 25.0, "relative drift (percent) "
                                            "of any decomposition "
                                            "category's share vs the "
                                            "journaled fingerprint "
                                            "that flips ray_tpu_"
                                            "profile_regression_alert "
                                            "ON for the job"),
    "FAKE_HBM_GB": (float, 0.0, "chaos spec: cap the memory sampler's "
                                "reported device capacity at this many "
                                "GiB (0 = off) so headroom alerts and "
                                "the OOM-forensics path are "
                                "deterministically drivable without "
                                "real HBM pressure; sampled usage "
                                "above the cap raises an injected "
                                "ResourceExhausted at step close"),
    "ADDRESS": (str, "", "default cluster address for init()"),
}

_overrides: dict[str, Any] = {}


def _coerce(name: str, raw: str) -> Any:
    typ = CONFIG_DEFS[name][0]
    if typ is bool:
        return raw not in ("", "0", "false", "False")
    return typ(raw)


def get(name: str) -> Any:
    """Resolved value of a knob (override → env → default)."""
    if name not in CONFIG_DEFS:
        raise KeyError(
            f"unknown config {name!r}; known: {sorted(CONFIG_DEFS)}"
        )
    if name in _overrides:
        return _overrides[name]
    raw = os.environ.get(f"RAY_TPU_{name}")
    if raw is not None:
        try:
            return _coerce(name, raw)
        except ValueError as e:
            # Fail LOUD: silently falling back to the default would let
            # an operator believe a malformed threshold applied.
            raise ValueError(
                f"malformed RAY_TPU_{name}={raw!r}: expected "
                f"{CONFIG_DEFS[name][0].__name__}"
            ) from e
    return CONFIG_DEFS[name][1]


def clear_system_config(*names: str) -> None:
    """Remove programmatic overrides AND their env exports (tests that
    set_system_config must clear both — popping only _overrides leaves
    the env var, which get() still resolves)."""
    for name in names:
        _overrides.pop(name, None)
        os.environ.pop(f"RAY_TPU_{name}", None)


def set_system_config(config: dict[str, Any]) -> None:
    """Programmatic overrides (reference: ray.init(_system_config=...)).
    Also exported to the environment so spawned workers inherit them."""
    unknown = set(config) - set(CONFIG_DEFS)
    if unknown:
        raise KeyError(
            f"unknown config {sorted(unknown)}; known: {sorted(CONFIG_DEFS)}"
        )
    # Coerce EVERYTHING before applying anything: a name or value error
    # mid-apply must not leave earlier overrides (and env exports)
    # behind.
    coerced: dict[str, Any] = {}
    for name, value in config.items():
        typ = CONFIG_DEFS[name][0]
        if isinstance(value, str):
            # Strings coerce with env semantics ("0"/"false" are falsy
            # for bool knobs — bool("0") would flip them ON).
            value = _coerce(name, value)
        elif not isinstance(value, typ):
            value = typ(value)
        coerced[name] = value
    for name, value in coerced.items():
        _overrides[name] = value
        os.environ[f"RAY_TPU_{name}"] = (
            ("1" if value else "0")
            if CONFIG_DEFS[name][0] is bool
            else str(value)
        )


def describe() -> dict[str, dict]:
    """Full registry with resolved values (surfaced by the CLI/state
    API the way the reference exposes GetInternalConfig)."""
    out = {}
    for name, (typ, default, doc) in CONFIG_DEFS.items():
        try:
            value = get(name)
        except ValueError as e:
            # The registry listing must render even with a malformed
            # env var — that is exactly when an operator needs it.
            value = f"<{e}>"
        out[name] = {
            "type": typ.__name__,
            "default": default,
            "value": value,
            "doc": doc,
            "env": f"RAY_TPU_{name}",
        }
    return out
