"""Shared distributed-protocol model for the TPU70x tier.

The control plane's wire contract is all convention: an RPC method
``m`` exists iff some server class defines ``async def _on_m(self,
conn, ...)``, and ``rpc.tolerant_kwargs`` silently DROPS any request
field the handler doesn't accept (deliberate version-skew tolerance).
That tolerance is exactly why drift is invisible at runtime — a typo'd
kwarg is not an error, it's a no-op. This module extracts the handler
signature table the static passes (TPU701) and the runtime contract
sanitizer (``sanitize.check_rpc_contract``) both validate against, so
the two views can never disagree about what the contract *is*.

A "handler" here is any (async) function named ``_on_<method>`` that
takes a parameter literally named ``conn`` — the dispatch shape of
``Head._handle``/``Node._handle``/``CoreWorker._handle``
(``getattr(self, f"_on_{method}")`` called with ``conn=conn, **kw``).
Callback-style ``_on_*`` functions without a ``conn`` parameter
(``_on_head_push``, ``_on_member_dead``, ...) are not RPC handlers and
are excluded by that same test.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from ray_tpu_torch._private.lint.core import iter_tree

#: kwargs consumed by the client transport (``Connection.call`` /
#: ``ReconnectingClient.call``) and never forwarded on the wire.
TRANSPORT_KWARGS = frozenset({"timeout", "retry"})


@dataclasses.dataclass
class HandlerSig:
    method: str
    params: set          # payload params (excluding self/conn)
    required: set        # params with no default
    varkw: bool          # handler takes **kwargs
    line: int = 0
    cls: str = ""
    path: str = ""


def _is_handler(node: ast.AST) -> bool:
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    if not node.name.startswith("_on_") or len(node.name) <= 4:
        return False
    names = {a.arg for a in node.args.args} | {
        a.arg for a in node.args.kwonlyargs}
    return "conn" in names


def handler_sig(node, cls: str = "", path: str = "") -> HandlerSig:
    """Signature model of one ``_on_<method>`` handler def."""
    args = node.args
    pos = [a.arg for a in args.args]
    n_defaults = len(args.defaults)
    required = set(pos[: len(pos) - n_defaults]) if n_defaults else set(pos)
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if d is None:
            required.add(a.arg)
    params = set(pos) | {a.arg for a in args.kwonlyargs}
    params -= {"self", "conn"}
    required -= {"self", "conn"}
    return HandlerSig(
        method=node.name[4:],
        params=params,
        required=required,
        varkw=args.kwarg is not None,
        line=node.lineno,
        cls=cls,
        path=path,
    )


def handler_signatures(tree: ast.Module, path: str = "") -> list[HandlerSig]:
    """All RPC handler signatures defined in one module."""
    out: list[HandlerSig] = []
    for node in iter_tree(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if _is_handler(item):
                    out.append(handler_sig(item, cls=node.name, path=path))
    return out


def merge_signatures(sigs) -> dict[str, HandlerSig]:
    """Method → merged contract across every server that handles it.

    When two servers handle the same method (``get_object`` lives on
    both node and core_worker) a call site cannot know which one it
    targets, so the merged contract is the permissive union: a kwarg is
    unknown only if NO handler accepts it, a param is required only if
    EVERY handler requires it.
    """
    merged: dict[str, HandlerSig] = {}
    for sig in sigs:
        cur = merged.get(sig.method)
        if cur is None:
            merged[sig.method] = HandlerSig(
                method=sig.method, params=set(sig.params),
                required=set(sig.required), varkw=sig.varkw,
                line=sig.line, cls=sig.cls, path=sig.path)
        else:
            cur.params |= sig.params
            cur.required &= sig.required
            cur.varkw = cur.varkw or sig.varkw
    return merged


def handler_signature_table(root: str | None = None) -> dict[str, dict]:
    """Method → ``{"params", "required", "varkw"}`` for the whole
    installed ``ray_tpu_torch`` package (or any tree rooted at ``root``).

    This is the table the runtime contract sanitizer validates
    ``Connection.call`` kwargs against — built from the same extraction
    the TPU701 static pass uses, parsed once and cached by the caller.
    Unparseable or unreadable files are skipped: a broken WIP module
    must degrade the sanitizer to fewer checks, never to a crash.
    """
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    sigs: list[HandlerSig] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            p = os.path.join(dirpath, fn)
            try:
                with open(p, encoding="utf-8") as f:
                    src = f.read()
                # Textual pre-filter: every handler definition contains
                # "_on_" literally, and only ~1/6 of the package does.
                # Every spawned worker with the sanitizer armed builds
                # this table once — skipping the parse for the rest
                # keeps that first RPC cheap.
                if "_on_" not in src:
                    continue
                tree = ast.parse(src, filename=p)
            except (OSError, SyntaxError, UnicodeDecodeError):
                continue
            sigs.extend(handler_signatures(tree, path=p))
    return {
        m: {"params": s.params, "required": s.required, "varkw": s.varkw}
        for m, s in merge_signatures(sigs).items()
    }


class FakeNode:
    """Line-only node stand-in for ``ctx.report`` at finalize time
    (protocol events outlive their AST nodes cheaply this way)."""

    __slots__ = ("lineno", "col_offset")

    def __init__(self, lineno: int, col: int = 0):
        self.lineno = lineno
        self.col_offset = col
