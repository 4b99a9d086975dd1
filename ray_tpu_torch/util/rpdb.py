"""Remote pdb: debug live or crashed tasks over a TCP socket.

Reference: python/ray/util/rpdb.py — ``_RemotePdb`` serves a pdb
session on a listening socket (``ray debug`` / telnet attaches), with
``set_trace()`` for live breakpoints and post-mortem activation on
task failure behind RAY_DEBUG_POST_MORTEM. Same shape here:

- ``ray_tpu_torch.util.rpdb.set_trace()`` inside a task/actor method opens a
  loopback socket, announces the address on the worker's stdout (which
  the log pipeline streams to the driver), and blocks until a client
  attaches (``nc HOST PORT`` — plain pdb protocol, no special client).
- With ``RAY_TPU_POST_MORTEM=1``, a task that raises drops into the
  debugger at the failure frame BEFORE the error travels back to the
  owner; attach, inspect, ``c``/``q`` to release the task.

``RAY_TPU_RPDB_PORT`` pins the listening port (else an ephemeral one);
``RAY_TPU_RPDB_HOST`` the bind host (loopback by default — same
no-auth caveat as the node agent).
"""

from __future__ import annotations

import logging
import os
import pdb
import socket
import sys

logger = logging.getLogger("ray_tpu_torch.rpdb")


class _SocketFile:
    """File-ish adapter for pdb's stdin/stdout over one connection."""

    def __init__(self, conn: socket.socket):
        self._conn = conn
        self._rfile = conn.makefile("r", encoding="utf-8", newline="\n")

    def readline(self):
        line = self._rfile.readline()
        # telnet sends \r\n; pdb wants bare commands.
        return line.replace("\r\n", "\n").replace("\r", "\n")

    def write(self, data: str):
        try:
            self._conn.sendall(data.encode())
        except OSError:
            pass

    def flush(self):
        pass

    def close(self):
        try:
            self._rfile.close()
            self._conn.close()
        except OSError:
            pass

    @property
    def encoding(self):
        return "utf-8"


class RemotePdb(pdb.Pdb):
    """pdb bound to an accepted TCP connection instead of the tty."""

    def __init__(self, host: str | None = None, port: int | None = None):
        # tpulint: allow(TPU703 reason=the remote debugger must come up even when config machinery is the thing being debugged — env-only by design)
        host = host or os.environ.get("RAY_TPU_RPDB_HOST", "127.0.0.1")
        if port is None:
            # tpulint: allow(TPU703 reason=the remote debugger must come up even when config machinery is the thing being debugged — env-only by design)
            port = int(os.environ.get("RAY_TPU_RPDB_PORT", "0"))
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1)
        self.addr = self._listener.getsockname()[:2]
        # The announcement travels the worker-log pipeline to the
        # driver (reference: _cry() to stderr + the debugger poll loop).
        print(
            f"RAY_TPU_RPDB: waiting for debugger on "
            f"{self.addr[0]}:{self.addr[1]} — attach with "
            f"`nc {self.addr[0]} {self.addr[1]}` (pid={os.getpid()})",
            flush=True,
        )
        conn, _ = self._listener.accept()
        self._sock_file = _SocketFile(conn)
        super().__init__(
            stdin=self._sock_file, stdout=self._sock_file
        )
        self.use_rawinput = False
        self.prompt = "(ray_tpu_torch-pdb) "

    def _close(self):
        self._sock_file.close()
        try:
            self._listener.close()
        except OSError:
            pass

    # Release the socket when the session ends, however it ends.
    def do_continue(self, arg):
        result = super().do_continue(arg)
        self._close()
        return result

    do_c = do_cont = do_continue

    def do_quit(self, arg):
        result = super().do_quit(arg)
        self._close()
        return result

    do_q = do_exit = do_quit

    def do_EOF(self, arg):
        # Abrupt client disconnect (nc killed, network drop) lands
        # here: release the sockets or a pinned RAY_TPU_RPDB_PORT stays
        # bound (EADDRINUSE) for every later session in this worker.
        try:
            return super().do_EOF(arg)
        finally:
            self._close()


def set_trace(host: str | None = None, port: int | None = None):
    """Breakpoint inside a remote task/actor: blocks the task until a
    client attaches and continues."""
    debugger = RemotePdb(host=host, port=port)
    debugger.set_trace(sys._getframe().f_back)


def post_mortem(tb=None, host: str | None = None, port: int | None = None):
    """Debug a crashed frame; used by the worker's failure path when
    RAY_TPU_POST_MORTEM is set, callable directly too."""
    if tb is None:
        tb = sys.exc_info()[2]
    if tb is None:
        raise ValueError("no traceback to debug")
    debugger = RemotePdb(host=host, port=port)
    try:
        debugger.reset()
        debugger.interaction(None, tb)
    finally:
        debugger._close()


def _maybe_post_mortem(tb=None) -> bool:
    """Worker hook: drop into the debugger if post-mortem is enabled.
    Returns True if a session ran."""
    # tpulint: allow(TPU703 reason=the remote debugger must come up even when config machinery is the thing being debugged — env-only by design)
    if os.environ.get("RAY_TPU_POST_MORTEM", "") in ("", "0", "false"):
        return False
    try:
        post_mortem(tb)
        return True
    except Exception:  # noqa: BLE001 - debugging must not mask the error
        logger.warning(
            "post-mortem debugger failed to attach", exc_info=True
        )
        return False
