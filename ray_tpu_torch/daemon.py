"""Daemonized cluster processes behind `ray_tpu_torch.scripts start` /
`stop` (port of ray_tpu/daemon.py; reference: `ray start --head` /
`--address` scripts/scripts.py:682, which exec the gcs_server and raylet
binaries; here the head service and node manager are asyncio services
hosted by this module's entry point). The node's resources come from the
port's runtime/node.py ``detect_resources``: GPUs counted from
CUDA_VISIBLE_DEVICES or the /dev/nvidiaN files this process may open,
without creating a CUDA context; the node names its cards by the same
ids (``node_gpu_ids``) and binds each GPU lease to its own.

Layout of a session directory (one per host, default
<tmp>/ray_tpu_torch_cluster: the port's own, so that `stop` of one
package never signals the other's daemons):

    head.addr      advertised head address (written atomically when up)
    head.journal   durable head state (KV/actors/PGs) — enables head
                   restart with state intact (see runtime/head_storage)
    *.pid          one per daemonized process, consumed by `stop`
    logs/*.log     daemon stdout/stderr

`python -m ray_tpu_torch.daemon head|node ...` runs a process in the
foreground; the CLI (scripts.py) forks it into the background with
start_new_session and tracks the pid.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import json
import os
import signal
import sys
import tempfile

logger = logging.getLogger("ray_tpu_torch.daemon")

DEFAULT_SESSION_DIR = os.path.join(
    tempfile.gettempdir(), "ray_tpu_torch_cluster"
)


def _write_atomic(path: str, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.rename(tmp, path)


def _resources(args) -> dict:
    from ray_tpu_torch.runtime.node import detect_resources

    total = detect_resources()
    if args.num_cpus is not None:
        total["CPU"] = float(args.num_cpus)
    if args.resources:
        total.update(json.loads(args.resources))
    return total


async def _serve_until_signal(stoppables, node=None) -> None:
    """Run until SIGTERM/SIGINT, then stop services newest-first.

    With a local ``node``, SIGTERM is treated as a preemption notice
    (GCE delivers ~30s of ACPI-shutdown warning as SIGTERM): the node
    self-reports DRAINING to the head — so schedulers divert and train
    workers get their emergency-checkpoint window — and then keeps
    serving for RAY_TPU_DRAIN_SIGTERM_LINGER_S (default 0: notify and
    stop, which keeps `ray_tpu_torch stop` prompt). A second signal always
    cuts the linger short."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    if node is not None and not node.draining:
        from ray_tpu_torch._private import config

        try:
            await asyncio.wait_for(node.self_drain("sigterm"), 2.0)
        except Exception:  # noqa: BLE001 - head may already be gone
            logger.debug("sigterm self-drain notify failed", exc_info=True)
        linger = config.get("DRAIN_SIGTERM_LINGER_S")
        if linger > 0:
            stop.clear()
            try:
                await asyncio.wait_for(stop.wait(), linger)
            except asyncio.TimeoutError:
                pass
    for s in reversed(stoppables):
        try:
            await s.stop()
        except Exception:  # noqa: BLE001 - best-effort teardown
            logger.debug("daemon component stop failed", exc_info=True)


_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def resolve_token(
    session_dir: str,
    *,
    explicit: str | None = None,
    no_auth: bool = False,
    is_head: bool = False,
    host: str = "127.0.0.1",
    warn=print,
) -> str:
    """The ONE token-resolution rule, shared by the CLI and the daemon.

    Default-ON auth (reference: token auth
    authentication_token_validator.h:26): explicit flag > env/config >
    (head: generate; node: session-dir file). Returns "" only under
    --no-auth, warning loudly when that combines with a routable bind
    address (the RPC layer deserializes pickle between authenticated
    peers — an open port is code execution)."""
    import secrets

    from ray_tpu_torch._private import config

    token = explicit or config.get("AUTH_TOKEN")
    if no_auth:
        token = ""
    elif not token:
        # Reuse the session token if one exists — a crash-restarted
        # head must NOT rotate it, or every surviving node and driver
        # holding the old token is locked out.
        token_path = os.path.join(session_dir, "auth.token")
        if os.path.exists(token_path):
            token = open(token_path).read().strip()
        if not token and is_head:
            token = secrets.token_hex(16)
    if not token and host not in _LOOPBACK:
        warn(
            f"WARNING: binding {host} with auth disabled — any host "
            "with network reach gets code execution. Set "
            "RAY_TPU_AUTH_TOKEN or drop --no-auth."
        )
    return token


def _setup_security(args, session_dir: str, is_head: bool) -> str:
    """Resolve the auth token + TLS material and install them in config
    (set_system_config also exports to os.environ, which is how spawned
    workers inherit them). Returns the resolved token ("" = auth off)."""
    from ray_tpu_torch._private import config

    token_path = os.path.join(session_dir, "auth.token")
    token = resolve_token(
        session_dir,
        no_auth=getattr(args, "no_auth", False),
        is_head=is_head,
        host=args.host,
        warn=lambda msg: print(msg, flush=True),
    )
    overrides = {"AUTH_TOKEN": token}
    if is_head:
        if token:
            fd = os.open(
                token_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600
            )
            with os.fdopen(fd, "w") as f:
                f.write(token)
        else:
            # A stale token from a previous authed cluster would poison
            # joins and CLI connects to this no-auth one.
            try:
                os.unlink(token_path)
            except OSError:
                pass
    if getattr(args, "tls", False):
        # Operator-provided material (env/config) wins; otherwise the
        # session dir. Only the head may generate — every other host
        # must receive a COPY of both files (one shared cert is the
        # cluster's identity; clients pin it).
        cert = config.get("TLS_CERT") or os.path.join(session_dir, "tls.crt")
        key = config.get("TLS_KEY") or os.path.join(session_dir, "tls.key")
        if not (os.path.exists(cert) and os.path.exists(key)):
            if is_head:
                from ray_tpu_torch._private.tls_utils import generate_self_signed

                generate_self_signed(cert, key)
            else:
                raise SystemExit(
                    f"--tls: no cert/key at {cert} / {key}; copy "
                    "tls.crt AND tls.key from the head's session dir "
                    "(or set RAY_TPU_TLS_CERT / RAY_TPU_TLS_KEY)"
                )
        overrides["TLS_CERT"] = cert
        overrides["TLS_KEY"] = key
    elif config.get("TLS_CERT"):
        overrides["TLS_CERT"] = config.get("TLS_CERT")
        overrides["TLS_KEY"] = config.get("TLS_KEY")
    config.set_system_config(overrides)
    return token


async def _run_head(args) -> None:
    from ray_tpu_torch._private import config
    from ray_tpu_torch.runtime.head import HeadService
    from ray_tpu_torch.runtime.node import NodeManager
    from ray_tpu_torch.runtime.object_store import default_store_dir

    session_dir = args.session_dir
    os.makedirs(session_dir, exist_ok=True)
    token = _setup_security(args, session_dir, is_head=True)
    # HEAD_JOURNAL (including the documented 'off') wins over the
    # session default.
    journal = config.get("HEAD_JOURNAL") or os.path.join(
        session_dir, "head.journal"
    )
    head = HeadService(journal_path=journal)
    addr = await head.start(host=args.host, port=args.port)
    if config.get("HEAD_GC_FREEZE"):
        # Tail-latency discipline for the dedicated head process: after
        # boot + journal restore, move everything live so far into the
        # permanent generation (gen2 passes then scan only post-boot
        # garbage, not every module object) and raise gen0 so a
        # telemetry flood's allocation churn doesn't cascade collector
        # passes into the RPC dispatch path. Cyclic garbage still gets
        # collected — just on an amortized cadence.
        import gc

        gc.collect()
        gc.freeze()
        gc.set_threshold(50_000, 25, 25)
    nice_target = config.get("HEAD_NICE")
    if nice_target:
        # On a shared host the head competes with data-plane work for
        # CPU; when both are saturated, every control RPC waits a full
        # scheduler rotation behind its neighbours. Elevated priority
        # keeps the control plane responsive — best effort (negative
        # values need CAP_SYS_NICE).
        try:
            os.setpriority(os.PRIO_PROCESS, 0, nice_target)
        except OSError as e:
            logger.warning("HEAD_NICE=%s not applied: %s",
                           nice_target, e)
    # Workers this node spawns need the journal off (only the head
    # process owns it) but the cluster address on.
    config.set_system_config({"ADDRESS": addr})

    stoppables = [head]
    node = None
    if not args.head_only:
        node = NodeManager(
            head_addr=addr,
            store_dir=default_store_dir(f"cli-{os.getpid()}"),
            resources=_resources(args),
        )
        await node.start(host=args.host)
        stoppables.append(node)

    _write_atomic(os.path.join(session_dir, "head.addr"), addr)
    try:
        # Local artifact (environment/version info; the driver-side
        # /api/usage endpoint carries the live cluster view); the POST
        # fires only when the operator set RAY_TPU_USAGE_REPORT_URL.
        from ray_tpu_torch._private import usage

        usage.write_usage_file(session_dir)
        import threading

        threading.Thread(
            target=usage.report_if_enabled, daemon=True
        ).start()
    except Exception:  # noqa: BLE001 - observability must not block boot
        logger.debug("usage reporting setup failed", exc_info=True)
    # The daemon's stdout lands in a log file under the session dir —
    # never print the token itself here (the 0600 token file is the
    # secret's only resting place; the CLI prints the join command to
    # the operator's terminal).
    print(f"head up at {addr}", flush=True)
    tls_note = " --tls (copy tls.crt AND tls.key over first)" if getattr(
        args, "tls", False
    ) else ""
    env_prefix = "RAY_TPU_AUTH_TOKEN=<token> " if token else ""
    print(
        f"join from other hosts:  {env_prefix}python -m ray_tpu_torch.scripts "
        f"start --address {addr}{tls_note}",
        flush=True,
    )
    if token:
        print(
            f"auth token (the <token> above) is in "
            f"{session_dir}/auth.token",
            flush=True,
        )
    await _serve_until_signal(stoppables, node=node)


async def _run_node(args) -> None:
    from ray_tpu_torch.runtime.node import NodeManager
    from ray_tpu_torch.runtime.object_store import default_store_dir

    _setup_security(args, args.session_dir, is_head=False)
    node = NodeManager(
        head_addr=args.address,
        store_dir=default_store_dir(f"cli-{os.getpid()}"),
        resources=_resources(args),
    )
    addr = await node.start(host=args.host)
    print(f"node up at {addr} (head {args.address})", flush=True)
    await _serve_until_signal([node], node=node)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ray_tpu_torch.daemon")
    sub = p.add_subparsers(dest="role", required=True)
    for role in ("head", "node"):
        sp = sub.add_parser(role)
        sp.add_argument("--host", default="127.0.0.1")
        sp.add_argument("--num-cpus", type=float, default=None)
        sp.add_argument("--resources", default=None, help="JSON dict")
        sp.add_argument("--session-dir", default=DEFAULT_SESSION_DIR)
        sp.add_argument(
            "--no-auth",
            action="store_true",
            help="disable the connection token (loopback dev only)",
        )
        sp.add_argument(
            "--tls",
            action="store_true",
            help="encrypt cluster RPC (head generates a self-signed "
            "cert in the session dir; nodes need a copy of tls.crt)",
        )
        if role == "head":
            sp.add_argument("--port", type=int, default=0)
            sp.add_argument(
                "--head-only",
                action="store_true",
                help="run the head service without a local node",
            )
        else:
            sp.add_argument("--address", required=True)
    args = p.parse_args(argv)
    runner = _run_head if args.role == "head" else _run_node
    asyncio.run(runner(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
