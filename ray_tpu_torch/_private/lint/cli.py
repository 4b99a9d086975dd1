"""`ray_tpu_torch lint` / `python -m ray_tpu_torch._private.lint` — CLI.

Exit codes: 0 clean (or everything baselined), 1 new violations,
2 usage/IO error. `--update-baseline` rewrites the baseline from the
current tree and always exits 0.

`--changed [REF]` (pre-commit mode) lints only the files in `git diff
REF` (default HEAD, plus untracked files) — but ANALYZES their
import-graph neighbors too, so the interprocedural rules
(TPU103/TPU202/TPU204) still see helpers and lock owners defined in
unchanged files, plus the protocol-anchor files (RPC handler modules,
`config.py`, the journal restore) so the TPU70x contract rules always
judge a changed caller against the real handler table. Only
violations in changed files are reported.

`--strict` additionally reports call sites the protocol tier cannot
resolve statically (dynamic RPC method names); `--knob-docs` renders
the CONFIG_DEFS registry as markdown and exits.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import time

from ray_tpu_torch._private.lint import baseline as baseline_mod
from ray_tpu_torch._private.lint import core

DEFAULT_BASELINE = "lint_baseline.json"

_IMPORT_RE = re.compile(
    r"^\s*(?:from\s+([\w\.]+)\s+import|import\s+([\w\.]+))", re.MULTILINE)


def _git(root: str, *args: str) -> list[str]:
    out = subprocess.run(
        ["git", "-C", root, *args],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return [ln for ln in out.stdout.splitlines() if ln.strip()]


def _changed_files(paths: list[str], ref: str) -> tuple[list[str], str]:
    """Absolute paths of changed+untracked .py files under ``paths``,
    plus the git root. Raises CalledProcessError outside a repo."""
    probe = os.path.abspath(paths[0])
    if os.path.isfile(probe):
        probe = os.path.dirname(probe)
    root = _git(probe, "rev-parse", "--show-toplevel")[0]
    rel = _git(root, "diff", "--name-only", ref, "--", "*.py")
    rel += _git(root, "ls-files", "--others", "--exclude-standard",
                "--", "*.py")
    roots = [os.path.abspath(p) for p in paths]
    out = []
    for r in rel:
        p = os.path.join(root, r)
        if not os.path.exists(p):
            continue  # deleted file
        ap = os.path.abspath(p)
        if any(ap == rt or ap.startswith(rt + os.sep) for rt in roots):
            out.append(ap)
    return sorted(set(out)), root


def _module_tail(path: str) -> str:
    base = os.path.basename(path)
    if base == "__init__.py":
        return os.path.basename(os.path.dirname(path))
    return base[:-3] if base.endswith(".py") else base


def _imported_tails(path: str) -> set[str]:
    try:
        with open(path, encoding="utf-8") as f:
            src = f.read()
    except OSError:
        return set()
    tails = set()
    for m in _IMPORT_RE.finditer(src):
        mod = m.group(1) or m.group(2)
        tails.add(mod.split(".")[-1])
    return tails


DEFAULT_CHANGED_HOPS = 3


def _expand_neighbors(changed: list[str], paths: list[str],
                      excludes, hops: int = DEFAULT_CHANGED_HOPS
                      ) -> list[str]:
    """changed ∪ up to ``hops`` import-graph hops in both directions —
    the files whose symbols the interprocedural passes must see to
    judge the changed ones (and vice versa).

    TRANSITIVE: a 2-hop helper chain
    ``caller → middle → issuer`` with an unchanged ``middle`` used to
    hide a TPU103/TPU601 from the pre-commit path, because one hop from
    ``caller`` never loaded ``issuer``'s definition. BFS over the
    undirected import graph, bounded (default 3 hops,
    ``--changed-hops=`` overrides) so one edit never degenerates into a
    full-tree analysis on a densely imported package."""
    tree = list(core.iter_python_files(paths, excludes=excludes))
    by_tail: dict[str, list[str]] = {}
    imports: dict[str, set[str]] = {}
    for f in tree:
        af = os.path.abspath(f)
        by_tail.setdefault(_module_tail(af), []).append(af)
        imports[af] = _imported_tails(af)
    out = set(changed)
    frontier = set(changed)
    for _ in range(max(0, hops)):
        if not frontier:
            break
        frontier_tails = {_module_tail(f) for f in frontier}
        nxt: set[str] = set()
        for f in tree:
            af = os.path.abspath(f)
            if af in out:
                continue
            # f imports a frontier module, or a frontier file imports f
            if imports[af] & frontier_tails:
                nxt.add(af)
                continue
            tail = _module_tail(af)
            if any(tail in imports[c] for c in frontier):
                nxt.add(af)
        out |= nxt
        frontier = nxt
    return sorted(out)


_HOOK_BODY = """\
#!/bin/sh
# tpulint pre-commit hook (installed by `ray_tpu_torch lint --install-hook`).
# Lints only the files changed vs HEAD, expanding import-graph
# neighbors — plus the protocol anchors (RPC handler modules,
# config.py, the journal restore) — so the interprocedural rules and
# the TPU70x distributed-protocol tier stay sound. Bypass a single
# commit with `git commit --no-verify`.
exec {python} -m ray_tpu_torch._private.lint {target} --changed
"""

# Files that DEFINE a distributed contract: RPC handler tables, the
# config registry, the journal replay. Always analyzed (never
# reported) in --changed mode — a changed caller must be judged
# against the real contract even when the defining file is far away
# in the import graph.
_ANCHOR_RE = re.compile(
    r"async def _on_\w+\(|CONFIG_DEFS\s*[:=]|def _restore_from_journal\(")


def _protocol_anchors(paths: list[str], excludes) -> set[str]:
    out: set[str] = set()
    for f in core.iter_python_files(paths, excludes=excludes):
        try:
            with open(f, encoding="utf-8") as fh:
                if _ANCHOR_RE.search(fh.read()):
                    out.add(os.path.abspath(f))
        except OSError:
            continue
    return out


def _install_hook(paths: list[str]) -> int:
    """Write .git/hooks/pre-commit running `lint --changed` over the
    first target path's repository."""
    probe = os.path.abspath(paths[0])
    if os.path.isfile(probe):
        probe = os.path.dirname(probe)
    try:
        root = _git(probe, "rev-parse", "--show-toplevel")[0]
    except (subprocess.CalledProcessError, OSError,
            subprocess.TimeoutExpired) as e:
        print(f"error: --install-hook needs a git repo: {e}",
              file=sys.stderr)
        return 2
    hooks_dir = os.path.join(root, ".git", "hooks")
    os.makedirs(hooks_dir, exist_ok=True)
    hook = os.path.join(hooks_dir, "pre-commit")
    if os.path.exists(hook):
        print(f"error: {hook} already exists — remove it first (or "
              "chain scripts/pre-commit.sample from it)",
              file=sys.stderr)
        return 2
    target = os.path.relpath(os.path.abspath(paths[0]), root)
    with open(hook, "w", encoding="utf-8") as f:
        f.write(_HOOK_BODY.format(python=sys.executable, target=target))
    os.chmod(hook, 0o755)
    print(f"installed {hook}: runs `lint {target} --changed` per commit")
    return 0


def knob_docs_markdown() -> str:
    """The CONFIG_DEFS registry rendered as a markdown table — the
    generator behind the "Config registry" table of README's port
    section (a ``###`` heading, so that the section runs on past it),
    kept here so docs and registry can never drift (TPU703's doc-drift
    sub-check closes the loop in the other direction)."""
    from ray_tpu_torch._private import config

    def esc(text: str) -> str:
        return str(text).replace("|", "\\|")

    lines = [
        "### Config registry (`ray_tpu_torch`)",
        "",
        "<!-- generated: python -m ray_tpu_torch._private.lint --knob-docs -->",
        "",
        "Every knob resolves override → `RAY_TPU_<NAME>` env var → "
        "default (see `ray_tpu_torch/_private/config.py`).",
        "",
        "| knob | type | default | doc |",
        "|---|---|---|---|",
    ]
    for name in sorted(config.CONFIG_DEFS):
        typ, default, doc = config.CONFIG_DEFS[name]
        lines.append(
            f"| `{name}` | {typ.__name__} | `{default!r}` | "
            f"{esc(' '.join(doc.split()))} |")
    return "\n".join(lines) + "\n"


def _find_default_baseline(paths: list[str]) -> str | None:
    """Look for lint_baseline.json next to / above the first target so
    `ray_tpu_torch lint ray_tpu_torch/` from the repo root just works."""
    probe = os.path.abspath(paths[0]) if paths else os.getcwd()
    if os.path.isfile(probe):
        probe = os.path.dirname(probe)
    for _ in range(6):
        cand = os.path.join(probe, DEFAULT_BASELINE)
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch lint",
        description="tpulint: ray_tpu_torch-specific static analysis "
                    "(collective divergence, lock discipline, exception "
                    "hygiene, metric/span hygiene, RPC reentrancy)",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files/directories to analyze (default: ray_tpu_torch "
                        "package next to this install)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help=f"baseline file (default: {DEFAULT_BASELINE} "
                        "found upward from the first path; 'off' "
                        "disables)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline from the current tree")
    p.add_argument("--select", default=None, metavar="RULES",
                   help="comma-separated rule ids/names to keep "
                        "(e.g. TPU301,lock-order)")
    p.add_argument("--relative-to", default=None,
                   help="report paths relative to this directory "
                        "(default: cwd)")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="REF",
                   help="lint only files changed vs REF (default "
                        "HEAD) plus untracked files; their "
                        "import-graph neighbors are analyzed (not "
                        "reported) so interprocedural rules stay "
                        "sound — the fast pre-commit path")
    p.add_argument("--changed-hops", type=int,
                   default=DEFAULT_CHANGED_HOPS, metavar="N",
                   help="import-graph hops to expand around changed "
                        f"files (default {DEFAULT_CHANGED_HOPS}): "
                        "helpers-of-helpers N levels deep stay "
                        "visible to the interprocedural rules")
    p.add_argument("--install-hook", action="store_true",
                   help="write .git/hooks/pre-commit running "
                        "`lint --changed` against the staged tree, "
                        "then exit")
    p.add_argument("--strict", action="store_true",
                   help="also report protocol call sites that cannot "
                        "be resolved statically (dynamic RPC method "
                        "names) — covered at runtime by the contract "
                        "sanitizer instead")
    p.add_argument("--knob-docs", action="store_true", dest="knob_docs",
                   help="render the CONFIG_DEFS registry (name, env "
                        "var, type, default, doc) as markdown and exit")
    args = p.parse_args(argv)

    if args.knob_docs:
        print(knob_docs_markdown(), end="")
        return 0

    paths = args.paths
    if not paths:
        # The package we live in — `ray_tpu_torch lint` bare lints the install.
        paths = [os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))]
    for path in paths:
        if not os.path.exists(path):
            print(f"error: no such path: {path}", file=sys.stderr)
            return 2

    if args.install_hook:
        return _install_hook(paths)

    rel = args.relative_to or os.getcwd()
    t0 = time.monotonic()
    report_only: set[str] | None = None
    n_changed = n_analyzed = None
    if args.changed is not None:
        try:
            changed, _git_root = _changed_files(paths, args.changed)
        except (subprocess.CalledProcessError, OSError,
                subprocess.TimeoutExpired) as e:
            print(f"error: --changed needs git: {e}", file=sys.stderr)
            return 2
        if not changed:
            print("tpulint: no changed .py files; nothing to lint",
                  file=sys.stderr)
            return 0
        analyze = _expand_neighbors(changed, paths,
                                    core.DEFAULT_EXCLUDES,
                                    hops=args.changed_hops)
        anchors = _protocol_anchors(paths, core.DEFAULT_EXCLUDES)
        analyze = sorted(set(analyze) | anchors)
        report_only = {os.path.abspath(c) for c in changed}
        n_changed, n_analyzed = len(changed), len(analyze)
        paths = analyze
    violations, errors = core.analyze_paths(paths, relative_to=rel,
                                            strict=args.strict)
    elapsed = time.monotonic() - t0

    if report_only is not None:
        violations = [
            v for v in violations
            if os.path.abspath(os.path.join(rel, v.path)) in report_only
        ]

    if args.select:
        keep = {t.strip() for t in args.select.split(",") if t.strip()}
        violations = [v for v in violations
                      if v.rule in keep or v.name in keep]

    baseline_path = args.baseline
    if baseline_path is None:
        baseline_path = _find_default_baseline(paths)
    elif baseline_path == "off":
        baseline_path = None

    if args.update_baseline:
        out_path = baseline_path or DEFAULT_BASELINE
        data = baseline_mod.make_baseline(violations)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {out_path}: {len(violations)} pinned violation(s) "
              f"across {len(data['entries'])} fingerprint(s)")
        return 0

    stale: list[str] = []
    reported = violations
    if baseline_path:
        try:
            base = baseline_mod.load_baseline(baseline_path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: cannot read baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
        reported, stale = baseline_mod.diff_against_baseline(
            violations, base)

    if args.as_json:
        out = {
            "violations": [v.to_dict() for v in reported],
            "total_found": len(violations),
            "baseline": baseline_path,
            "baselined": len(violations) - len(reported),
            "stale_baseline_entries": stale,
            "parse_errors": [
                {"path": p_, "error": e} for p_, e in errors],
            "elapsed_s": round(elapsed, 3),
        }
        if n_changed is not None:
            out["changed"] = {
                "ref": args.changed,
                "changed_files": n_changed,
                "analyzed_files": n_analyzed,
            }
        print(json.dumps(out, indent=2))
    else:
        for v in reported:
            print(v.format())
        for path_, err in errors:
            print(f"{path_}: parse error: {err}", file=sys.stderr)
        by_rule = collections.Counter(v.rule for v in reported)
        summary = ", ".join(
            f"{r}={n}" for r, n in sorted(by_rule.items())) or "none"
        pinned = len(violations) - len(reported)
        scope_note = ""
        if n_changed is not None:
            scope_note = (f" [--changed: {n_changed} changed, "
                          f"{n_analyzed} analyzed]")
        print(
            f"tpulint: {len(reported)} new violation(s) ({summary}); "
            f"{pinned} baselined; {elapsed:.2f}s{scope_note}",
            file=sys.stderr,
        )
        if stale:
            print(
                f"tpulint: {len(stale)} baseline entr"
                f"{'y is' if len(stale) == 1 else 'ies are'} stale "
                "(debt paid) — regenerate with --update-baseline to "
                "shrink the baseline",
                file=sys.stderr,
            )
    return 1 if reported else 0


if __name__ == "__main__":
    sys.exit(main())
