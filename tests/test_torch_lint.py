"""The port's tpulint (``ray_tpu_torch/_private/lint/``) and its runtime
contract sanitizer, held to the JAX package's.

Fixture tests pin exact rule ids and lines on the port's copies of the
known-bad snippets (``tests/lint_fixtures_torch/``, the JAX package's
``tests/lint_fixtures/`` in the port's names, without the jit fixtures),
and the parity test runs both linters on each shared fixture: a pass
that looks for a name the port spells differently goes inert, and a
clean tree then proves nothing. The tree gate runs the port's linter
over ``ray_tpu_torch/``: zero violations, no baseline, no parse error.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from ray_tpu._private.lint import analyze_file as jax_analyze_file
from ray_tpu._private.lint import protocol as jax_protocol
from ray_tpu_torch._private import sanitize
from ray_tpu_torch._private.lint import analyze_file, analyze_paths, analyze_source
from ray_tpu_torch._private.lint import protocol
from ray_tpu_torch._private.lint.cli import knob_docs_markdown
from ray_tpu_torch._private.lint.cli import main as lint_main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "lint_fixtures_torch")
JAX_FIXTURES = os.path.join(REPO_ROOT, "tests", "lint_fixtures")
PACKAGE = os.path.join(REPO_ROOT, "ray_tpu_torch")

# The JAX package's fixtures of the jit passes (TPU602-605), which the
# port does not have: it traces and compiles nothing.
JIT_FIXTURES = {"bad_donation.py", "bad_jit_divergence.py",
                "bad_jit_effects.py", "bad_recompile.py", "clean_jit.py"}
SHARED = sorted(f for f in os.listdir(JAX_FIXTURES)
                if f.endswith(".py") and f not in JIT_FIXTURES)

needs_git = pytest.mark.skipif(
    subprocess.run(["git", "--version"], capture_output=True).returncode
    != 0, reason="git unavailable")


def _hits(name):
    return [(v.rule, v.line)
            for v in analyze_file(os.path.join(FIXTURES, name))]


# --------------------------------------------------------------- fixtures
def test_fixture_collective():
    assert _hits("bad_collective.py") == [
        ("TPU101", 9), ("TPU101", 17), ("TPU102", 23)]


def test_fixture_locks():
    assert _hits("bad_locks.py") == [
        ("TPU201", 16), ("TPU201", 17), ("TPU203", 22), ("TPU202", 27)]


def test_fixture_except():
    # 49 is the pragma-without-reason site: an unexplained allow is inert.
    assert _hits("bad_except.py") == [
        ("TPU301", 11), ("TPU301", 18), ("TPU301", 49)]


def test_fixture_metrics():
    assert _hits("bad_metrics.py") == [
        ("TPU401", 12), ("TPU401", 14), ("TPU402", 19)]


def test_fixture_rpc():
    assert _hits("bad_rpc.py") == [("TPU501", 16)]


def test_fixture_rank_flow():
    assert _hits("bad_rank_flow.py") == [
        ("TPU103", 20), ("TPU103", 23), ("TPU103", 28)]


def test_fixture_handles():
    assert _hits("bad_handles.py") == [
        ("TPU104", 7), ("TPU104", 12), ("TPU104", 21)]


def test_fixture_async_locks():
    assert _hits("bad_async_locks.py") == [
        ("TPU203", 15), ("TPU203", 19), ("TPU203", 22)]


def test_fixture_lock_alias():
    vs = analyze_file(os.path.join(FIXTURES, "bad_lock_alias.py"))
    assert [(v.rule, v.line) for v in vs] == [("TPU204", 18)]
    assert "ALIASED" in vs[0].message


def test_fixture_lock_alias_keys():
    vs = analyze_file(os.path.join(FIXTURES, "bad_lock_alias_keys.py"))
    assert [(v.rule, v.line) for v in vs] == [("TPU204", 17)]
    assert '_locks["a"]' in vs[0].message
    assert '_locks["b"]' in vs[0].message


def test_fixture_pairing():
    assert _hits("bad_pairing.py") == [
        ("TPU404", 8), ("TPU404", 13), ("TPU404", 22)]


def test_fixture_labels():
    assert _hits("bad_labels.py") == [
        ("TPU403", 7), ("TPU403", 13), ("TPU403", 14), ("TPU403", 15),
        ("TPU403", 16), ("TPU403", 17)]


def test_clean_fixture_zero_findings():
    assert _hits("clean_interprocedural.py") == []


def test_fixture_host_sync():
    """TPU601 on the shared fixture with torch's verbs in place of
    jax's: torch.cuda.synchronize() in the step-span body, weak float()
    and .item() in compute spans, a helper reaching .cpu()."""
    vs = analyze_file(os.path.join(FIXTURES, "bad_host_sync.py"))
    assert [(v.rule, v.line) for v in vs] == [
        ("TPU601", 13), ("TPU601", 22), ("TPU601", 29), ("TPU601", 38)]
    assert "`synchronize`" in vs[0].message
    assert "_probe()" in vs[3].message


@pytest.mark.parametrize("line,kind", [
    (12, "`synchronize`"),     # torch.cuda.synchronize()
    (21, "`synchronize`"),     # Event.synchronize()
    (27, "`.cpu()`"),
    (33, "`.tolist()`"),
    (42, "_host_ids()"),       # a helper that reaches .tolist()
])
def test_fixture_host_sync_torch(line, kind):
    """Each of torch's host syncs fires once, on its own line; the
    fixture's quiet forms (.to("cpu"), float() outside a compute span,
    a checkpoint phase, a .cpu() after the span) stay silent."""
    vs = analyze_file(os.path.join(FIXTURES, "bad_host_sync_torch.py"))
    assert [(v.rule, v.line) for v in vs] == [
        ("TPU601", 12), ("TPU601", 21), ("TPU601", 27), ("TPU601", 33),
        ("TPU601", 42)]
    assert kind in next(v.message for v in vs if v.line == line)


def test_fixture_rpc_contract():
    assert _hits("bad_rpc_contract.py") == [
        ("TPU701", 18), ("TPU701", 19), ("TPU701", 20), ("TPU701", 21)]
    strict = analyze_file(
        os.path.join(FIXTURES, "bad_rpc_contract.py"), strict=True)
    assert [(v.rule, v.line) for v in strict] == [
        ("TPU701", 18), ("TPU701", 19), ("TPU701", 20), ("TPU701", 21),
        ("TPU701", 25)]
    assert "unresolvable" in strict[-1].message


def test_fixture_journal():
    vs = analyze_file(os.path.join(FIXTURES, "bad_journal.py"))
    assert [(v.rule, v.line) for v in vs] == [
        ("TPU702", 19), ("TPU702", 20), ("TPU702", 21), ("TPU702", 22)]
    assert "'value'" in vs[0].message
    assert "no replay branch" in vs[1].message
    assert "'ghost'" in vs[2].message
    assert "_snapshot" in vs[3].message


def test_fixture_knobs():
    vs = analyze_file(os.path.join(FIXTURES, "bad_knobs.py"))
    assert [(v.rule, v.line) for v in vs] == [
        ("TPU703", 12), ("TPU703", 26), ("TPU703", 27), ("TPU703", 28)]
    assert "GAMMA_DEAD" in vs[0].message and "never" in vs[0].message
    assert "BETA_RETRY" in vs[1].message
    assert "RAY_TPU_ALPHA_TIMEOUT_S" in vs[2].message


def test_fixture_pubsub():
    vs = analyze_file(os.path.join(FIXTURES, "bad_pubsub.py"))
    assert [(v.rule, v.line) for v in vs] == [
        ("TPU704", 13), ("TPU704", 20)]
    assert "batch" in vs[0].message
    assert "'metrcis'" in vs[1].message


def test_fixture_metric_schema():
    vs = analyze_file(os.path.join(FIXTURES, "bad_metric_schema.py"))
    assert [(v.rule, v.line) for v in vs] == [
        ("TPU705", 8), ("TPU705", 10)]
    assert "labels" in vs[0].message
    assert "Gauge" in vs[1].message and "Counter" in vs[1].message


def test_clean_protocol_zero_findings():
    assert _hits("clean_protocol.py") == []


@pytest.mark.parametrize("fixture", sorted(
    f for f in os.listdir(FIXTURES) if f.endswith(".py")))
def test_fixtures_parse_as_valid_python(fixture):
    import ast
    with open(os.path.join(FIXTURES, fixture), encoding="utf-8") as f:
        ast.parse(f.read())


# ----------------------------------------------------------------- parity
def test_fixture_set_is_the_jax_one_without_jit():
    ours = {f for f in os.listdir(FIXTURES) if f.endswith(".py")}
    assert ours == set(SHARED) | {"bad_host_sync_torch.py"}


@pytest.mark.parametrize("fixture", SHARED)
def test_fixture_parity_with_jax_linter(fixture):
    """The JAX linter on the JAX package's fixture and the port's on its
    copy report the same (rule, line) list, and neither list of a bad_*
    fixture is empty."""
    jax_hits = [(v.rule, v.line) for v in jax_analyze_file(
        os.path.join(JAX_FIXTURES, fixture))]
    assert _hits(fixture) == jax_hits
    if fixture.startswith("bad_"):
        assert jax_hits


def test_handler_tables_agree():
    """Both packages' RPC handler tables (the contract the sanitizer and
    TPU701 check against) agree on every handler. No difference is
    intended today: the port's runtime is a copy of the JAX package's."""
    ours = protocol.handler_signature_table()
    theirs = jax_protocol.handler_signature_table()
    intended: dict[str, str] = {}
    assert len(ours) > 50
    assert set(ours) == set(theirs)
    for method in sorted(set(ours) & set(theirs)):
        if method not in intended:
            assert ours[method] == theirs[method], method
    # The table is the port's own: built from ray_tpu_torch/.
    assert protocol.handler_signature_table(PACKAGE) == ours


# ------------------------------------------------------------- cross-file
def test_alias_through_helper_cross_file(tmp_path):
    (tmp_path / "flusher.py").write_text(
        "class Flusher:\n"
        "    def __init__(self, lk):\n"
        "        self._lk = lk\n"
        "    def flush(self):\n"
        "        with self._lk:\n"
        "            pass\n"
    )
    (tmp_path / "main.py").write_text(
        "import threading\n"
        "from flusher import Flusher\n"
        "_table_lock = threading.Lock()\n"
        "_flush_lock = threading.Lock()\n"
        "_f = Flusher(_flush_lock)\n"
        "def update():\n"
        "    with _table_lock:\n"
        "        _f.flush()\n"
    )
    violations, errors = analyze_paths([str(tmp_path)])
    assert not errors and violations == []
    (tmp_path / "rev.py").write_text(
        "from main import _table_lock, _flush_lock\n"
        "def reverse():\n"
        "    with _flush_lock:\n"
        "        with _table_lock:\n"
        "            pass\n"
    )
    violations, errors = analyze_paths([str(tmp_path)])
    assert not errors
    assert [v.rule for v in violations] == ["TPU204"]
    assert "_table_lock" in violations[0].message


def test_rank_flow_through_helper_cross_file(tmp_path):
    (tmp_path / "helpers.py").write_text(
        "from ray_tpu_torch import collective as col\n"
        "def sync_all(grads):\n"
        "    return col.allreduce(grads)\n"
    )
    (tmp_path / "caller.py").write_text(
        "from helpers import sync_all\n"
        "def step(rank, grads):\n"
        "    if rank == 0:\n"
        "        sync_all(grads)\n"
    )
    violations, errors = analyze_paths([str(tmp_path)])
    assert not errors
    assert [(v.rule, v.line) for v in violations] == [("TPU103", 4)]


def test_host_sync_through_helper_cross_file(tmp_path):
    """TPU601's closure crosses files: a helper module's .item() taints
    its caller's compute span."""
    (tmp_path / "probe.py").write_text(
        "def scalar(t):\n"
        "    return t.item()\n"
    )
    (tmp_path / "loop.py").write_text(
        "from probe import scalar\n"
        "def step(sp, t):\n"
        "    with sp.phase('compute'):\n"
        "        return scalar(t)\n"
    )
    violations, errors = analyze_paths([str(tmp_path)])
    assert not errors
    assert [(os.path.basename(v.path), v.rule, v.line)
            for v in violations] == [("loop.py", "TPU601", 4)]


def test_lock_order_cycle_cross_file(tmp_path):
    (tmp_path / "a.py").write_text(
        "import threading\n"
        "from b import flush\n"
        "_table_lock = threading.Lock()\n"
        "def update():\n"
        "    with _table_lock:\n"
        "        flush()\n"
    )
    (tmp_path / "b.py").write_text(
        "import threading\n"
        "_flush_lock = threading.Lock()\n"
        "def flush():\n"
        "    with _flush_lock:\n"
        "        pass\n"
    )
    violations, errors = analyze_paths([str(tmp_path)])
    assert not errors and violations == []
    (tmp_path / "c.py").write_text(
        "from b import _flush_lock\n"
        "from a import _table_lock\n"
        "def reverse():\n"
        "    with _flush_lock:\n"
        "        with _table_lock:\n"
        "            pass\n"
    )
    violations, _ = analyze_paths([str(tmp_path)])
    assert [v.rule for v in violations] == ["TPU202"]
    assert "a._table_lock" in violations[0].message
    assert "b._flush_lock" in violations[0].message


def test_rpc_contract_cross_file(tmp_path):
    (tmp_path / "server.py").write_text(
        "class Node:\n"
        "    async def _on_frob(self, conn, key, mode='fast'):\n"
        "        return key, mode\n"
    )
    (tmp_path / "caller.py").write_text(
        "async def go(conn):\n"
        "    await conn.call('frob', kee='x')\n"
    )
    violations, errors = analyze_paths([str(tmp_path)])
    assert not errors
    assert [(os.path.basename(v.path), v.rule) for v in violations] == [
        ("caller.py", "TPU701"), ("caller.py", "TPU701")]
    msgs = " ".join(v.message for v in violations)
    assert "'kee'" in msgs and "'key'" in msgs
    violations, _ = analyze_paths([str(tmp_path / "caller.py")])
    assert violations == []


def test_journal_cross_file(tmp_path):
    (tmp_path / "writer.py").write_text(
        "def record(head, k):\n"
        "    head._journal_append('kv', 'put', {'key': k})\n"
    )
    (tmp_path / "restorer.py").write_text(
        "class Head:\n"
        "    def _restore_from_journal(self, table, op, payload):\n"
        "        if table == 'kv':\n"
        "            if op == 'put':\n"
        "                self.kv[payload['key']] = payload['value']\n"
    )
    violations, errors = analyze_paths([str(tmp_path)])
    assert not errors
    assert [(os.path.basename(v.path), v.rule, v.line)
            for v in violations] == [("writer.py", "TPU702", 2)]
    assert "'value'" in violations[0].message
    violations, _ = analyze_paths([str(tmp_path / "writer.py")])
    assert violations == []


def test_journal_pass_sees_the_ports_head():
    """TPU702 binds the port's head: its append sites and its replay
    switch are both found, and they agree."""
    head = os.path.join(PACKAGE, "runtime", "head.py")
    src = open(head).read()
    assert "_journal_append(" in src and "_restore_from_journal" in src
    assert [v for v in analyze_file(head) if v.rule == "TPU702"] == []
    # The kv table's replay reading a key no append writes is caught.
    read = 'self.kv[payload["key"]] = payload["value"]'
    assert src.count(read) == 1
    broken = src.replace(read, read.replace('"value"', '"zz_value"'))
    hits = [v for v in analyze_source(broken, path=head)
            if v.rule == "TPU702"]
    assert hits and "zz_value" in hits[0].message, (
        "TPU702 inert on the port's head")


# ----------------------------------------------------------------- pragmas
def test_pragma_requires_reason():
    clean = (
        "def f():\n"
        "    try:\n"
        "        pass\n"
        "    # tpulint: allow(broad-except reason=testing)\n"
        "    except Exception:\n"
        "        pass\n"
    )
    assert analyze_source(clean) == []
    inert = clean.replace(" reason=testing", "")
    assert [v.rule for v in analyze_source(inert)] == ["TPU301"]


def test_pragma_accepts_rule_id():
    src = (
        "def f(t, sp):\n"
        "    with sp.phase('compute'):\n"
        "        # tpulint: allow(TPU601 reason=id form works too)\n"
        "        return t.cpu()\n"
    )
    assert analyze_source(src) == []
    assert [v.rule for v in analyze_source(
        src.replace(" reason=id form works too", ""))] == ["TPU601"]


def test_jit_rules_are_not_ported():
    from ray_tpu_torch._private.lint import core
    assert not {"TPU602", "TPU603", "TPU604", "TPU605"} & set(core.RULES)
    names = {m.__name__.rsplit(".", 1)[1] for m in core._passes()}
    assert len(names) == 16
    assert not any("jit" in n or n in ("pass_recompile", "pass_donation")
                   for n in names)
    # A jit body's logging call is no finding here.
    src = ("import jax, logging\n"
           "@jax.jit\n"
           "def f(x):\n"
           "    logging.info('traced')\n"
           "    return x\n")
    assert analyze_source(src) == []


# ------------------------------------------------------------ enforcement
def test_full_tree_clean_zero_baseline():
    """The gate: `python -m ray_tpu_torch._private.lint ray_tpu_torch
    --json` exits 0 with zero violations, zero baselined and no parse
    errors. No wall-clock floor: the seconds are printed."""
    assert not os.path.exists(os.path.join(REPO_ROOT, "lint_baseline.json"))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch._private.lint",
         "ray_tpu_torch", "--json"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    out = json.loads(proc.stdout)
    print(f"tpulint over ray_tpu_torch/: {out['elapsed_s']} s of analysis, "
          f"{time.monotonic() - t0:.2f} s in all")
    assert proc.returncode == 0, "\n".join(
        f"{v['path']}:{v['line']}: {v['rule']} {v['message']}"
        for v in out["violations"]) + proc.stderr
    assert out["violations"] == []
    assert out["baselined"] == 0
    assert out["baseline"] is None
    assert out["parse_errors"] == []


def test_scripts_lint_subcommand():
    """`python -m ray_tpu_torch.scripts lint` runs the linter before any
    cluster connection (the address points nowhere): rc 0 on a clean
    file, rc 1 with the rule on a bad one. (The tree gate above runs
    the same `main` over the whole package.)"""
    env = {**os.environ, "RAY_TPU_ADDRESS": "127.0.0.1:1"}
    ok = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "lint",
         os.path.join(FIXTURES, "clean_protocol.py")],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 new violation(s)" in ok.stderr
    bad = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts", "lint",
         os.path.join(FIXTURES, "bad_rpc.py"), "--select", "TPU501"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert bad.returncode == 1
    assert "TPU501" in bad.stdout


def test_json_schema_stable(capsys):
    rc = lint_main([
        os.path.join(FIXTURES, "bad_rpc.py"), "--baseline", "off",
        "--json", "--relative-to", REPO_ROOT,
    ])
    assert rc == 1
    out = json.loads(capsys.readouterr().out)
    assert set(out) >= {
        "violations", "total_found", "baseline", "baselined",
        "stale_baseline_entries", "parse_errors", "elapsed_s",
    }
    assert isinstance(out["total_found"], int)
    assert isinstance(out["elapsed_s"], (int, float))
    v = out["violations"][0]
    assert set(v) >= {"rule", "name", "path", "line", "col", "message",
                      "scope", "snippet", "fingerprint"}
    assert isinstance(v["line"], int)
    assert v["path"] == "tests/lint_fixtures_torch/bad_rpc.py"


def test_cli_select_and_json(capsys):
    rc = lint_main([
        os.path.join(FIXTURES, "bad_rpc.py"), "--baseline", "off",
        "--json", "--select", "rpc-reentrancy",
        "--relative-to", REPO_ROOT,
    ])
    assert rc == 1
    out = json.loads(capsys.readouterr().out)
    assert [v["rule"] for v in out["violations"]] == ["TPU501"]
    assert out["violations"][0]["line"] == 16


_BAD = (
    "def f():\n"
    "    try:\n"
    "        pass\n"
    "    except Exception:\n"
    "        pass\n"
)


def test_baseline_diff(tmp_path, capsys):
    tree = tmp_path / "pkg"
    tree.mkdir()
    (tree / "mod.py").write_text(_BAD)
    baseline = tmp_path / "base.json"
    rc = lint_main([str(tree), "--baseline", str(baseline),
                    "--update-baseline", "--relative-to", str(tmp_path)])
    assert rc == 0
    assert "ray_tpu_torch._private.lint" in json.loads(
        baseline.read_text())["note"]
    capsys.readouterr()
    rc = lint_main([str(tree), "--baseline", str(baseline),
                    "--relative-to", str(tmp_path)])
    assert rc == 0
    (tree / "mod2.py").write_text(_BAD.replace("f()", "g()"))
    rc = lint_main([str(tree), "--baseline", str(baseline),
                    "--relative-to", str(tmp_path), "--json"])
    assert rc == 1
    out = json.loads(capsys.readouterr().out)
    assert [v["path"] for v in out["violations"]] == ["pkg/mod2.py"]
    assert out["baselined"] == 1
    (tree / "mod.py").write_text("x = 1\n")
    (tree / "mod2.py").write_text("x = 2\n")
    rc = lint_main([str(tree), "--baseline", str(baseline),
                    "--relative-to", str(tmp_path), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert len(out["stale_baseline_entries"]) == 1


def test_baseline_fingerprint_survives_line_drift(tmp_path, capsys):
    tree = tmp_path / "pkg"
    tree.mkdir()
    (tree / "mod.py").write_text(_BAD)
    baseline = tmp_path / "base.json"
    lint_main([str(tree), "--baseline", str(baseline),
               "--update-baseline", "--relative-to", str(tmp_path)])
    capsys.readouterr()
    (tree / "mod.py").write_text("import os  # shifts lines\n\n" + _BAD)
    rc = lint_main([str(tree), "--baseline", str(baseline),
                    "--relative-to", str(tmp_path)])
    assert rc == 0


# ----------------------------------------------------------- --changed
def _git_repo(tmp_path):
    repo = tmp_path / "repo"
    pkg = repo / "pkg"
    pkg.mkdir(parents=True)

    def g(*args):
        subprocess.run(["git", "-C", str(repo), *args],
                       capture_output=True, check=True)

    g("init", "-q")
    g("config", "user.email", "t@t")
    g("config", "user.name", "t")
    return repo, pkg, g


@needs_git
def test_changed_mode_scopes_and_expands(tmp_path, capsys):
    repo, pkg, g = _git_repo(tmp_path)
    (pkg / "helpers.py").write_text(
        "from ray_tpu_torch import collective as col\n"
        "def sync_all(grads):\n"
        "    return col.allreduce(grads)\n"
        "def untouched_bug():\n"
        "    try:\n"
        "        pass\n"
        "    except Exception:\n"
        "        pass\n"
    )
    (pkg / "caller.py").write_text(
        "from helpers import sync_all\n"
        "def step(rank, grads):\n"
        "    return sync_all(grads)\n"
    )
    g("add", "-A")
    g("commit", "-qm", "seed")
    rc = lint_main([str(pkg), "--baseline", "off", "--changed",
                    "--relative-to", str(repo)])
    capsys.readouterr()
    assert rc == 0
    (pkg / "caller.py").write_text(
        "from helpers import sync_all\n"
        "def step(rank, grads):\n"
        "    if rank == 0:\n"
        "        sync_all(grads)\n"
    )
    rc = lint_main([str(pkg), "--baseline", "off", "--changed",
                    "--relative-to", str(repo), "--json"])
    assert rc == 1
    out = json.loads(capsys.readouterr().out)
    assert [v["rule"] for v in out["violations"]] == ["TPU103"]
    assert out["violations"][0]["path"].endswith("caller.py")
    assert out["changed"]["changed_files"] == 1
    assert out["changed"]["analyzed_files"] >= 2


@needs_git
def test_changed_transitive_neighbor_expansion(tmp_path, capsys):
    repo, pkg, g = _git_repo(tmp_path)
    (pkg / "issuer.py").write_text(
        "from ray_tpu_torch import collective as col\n"
        "def do_sync(g):\n"
        "    return col.allreduce(g)\n"
    )
    (pkg / "middle.py").write_text(
        "from issuer import do_sync\n"
        "def relay(g):\n"
        "    return do_sync(g)\n"
    )
    (pkg / "caller.py").write_text(
        "from middle import relay\n"
        "def step(rank, g):\n"
        "    return relay(g)\n"
    )
    g("add", "-A")
    g("commit", "-qm", "seed")
    (pkg / "caller.py").write_text(
        "from middle import relay\n"
        "def step(rank, g):\n"
        "    if rank == 0:\n"
        "        relay(g)\n"
    )
    rc = lint_main([str(pkg), "--baseline", "off", "--changed",
                    "--relative-to", str(repo), "--json"])
    assert rc == 1
    out = json.loads(capsys.readouterr().out)
    assert [v["rule"] for v in out["violations"]] == ["TPU103"]
    assert out["changed"]["analyzed_files"] == 3
    rc = lint_main([str(pkg), "--baseline", "off", "--changed",
                    "--changed-hops", "1", "--relative-to", str(repo),
                    "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["violations"] == []
    assert out["changed"]["analyzed_files"] == 2


@needs_git
def test_changed_mode_protocol_anchor_expansion(tmp_path, capsys):
    repo, pkg, g = _git_repo(tmp_path)
    (pkg / "server.py").write_text(
        "class Node:\n"
        "    async def _on_frob(self, conn, key):\n"
        "        return key\n"
    )
    (pkg / "caller.py").write_text(
        "async def go(conn):\n"
        "    await conn.call('frob', key='x')\n"
    )
    g("add", "-A")
    g("commit", "-qm", "seed")
    rc = lint_main([str(pkg), "--baseline", "off", "--changed",
                    "--relative-to", str(repo)])
    capsys.readouterr()
    assert rc == 0
    (pkg / "caller.py").write_text(
        "async def go(conn):\n"
        "    await conn.call('frob', kee='x')\n"
    )
    rc = lint_main([str(pkg), "--baseline", "off", "--changed",
                    "--relative-to", str(repo), "--json"])
    assert rc == 1
    out = json.loads(capsys.readouterr().out)
    assert [v["rule"] for v in out["violations"]] == ["TPU701", "TPU701"]
    assert all(v["path"].endswith("caller.py") for v in out["violations"])
    assert out["changed"]["changed_files"] == 1


@needs_git
def test_install_hook(tmp_path, capsys):
    """The hook runs the PORT's linter (`python -m
    ray_tpu_torch._private.lint <target> --changed`) and refuses to
    clobber an existing hook."""
    repo = tmp_path / "repo"
    pkg = repo / "pkg"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text("x = 1\n")
    subprocess.run(["git", "-C", str(repo), "init", "-q"],
                   capture_output=True, check=True)
    rc = lint_main([str(pkg), "--install-hook"])
    capsys.readouterr()
    assert rc == 0
    hook = repo / ".git" / "hooks" / "pre-commit"
    assert os.access(str(hook), os.X_OK)
    body = hook.read_text()
    assert "-m ray_tpu_torch._private.lint pkg --changed" in body
    assert "TPU70" in body
    rc = lint_main([str(pkg), "--install-hook"])
    capsys.readouterr()
    assert rc == 2


# ------------------------------------------------------------- knob docs
def test_knob_docs_cli(capsys):
    rc = lint_main(["--knob-docs"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("### Config registry (`ray_tpu_torch`)")
    assert "python -m ray_tpu_torch._private.lint --knob-docs" in out
    assert "| knob | type | default | doc |" in out
    from ray_tpu_torch._private import config
    for knob in config.CONFIG_DEFS:
        assert f"| `{knob}` |" in out


def test_readme_port_section_holds_the_generated_table():
    """README's section on the port carries --knob-docs' table as it is
    generated now, inside the section (a ### heading)."""
    from ray_tpu_torch._private.lint.pass_knobs import (
        PORT_SECTION, _readme_region)
    lines = open(os.path.join(REPO_ROOT, "README.md")).read().splitlines()
    start, end = _readme_region(lines)
    assert lines[start].startswith(PORT_SECTION)
    section = "\n".join(lines[start:end]) + "\n"
    assert knob_docs_markdown() in section


def test_readme_drift_reads_only_the_port_section(tmp_path):
    """TPU703's README check on a tree whose README has the port's
    section: an unknown knob there reports at its line; one outside it
    (the JAX package's part of the README) does not."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "config.py").write_text(
        "CONFIG_DEFS = {\n"
        "    'ALPHA': (int, 1, 'doc'),\n"
        "}\n"
    )
    (pkg / "user.py").write_text(
        "from pkg import config\n"
        "def f():\n"
        "    return config.get('ALPHA')\n"
    )
    (tmp_path / "README.md").write_text(
        "# x\n"
        "RAY_TPU_JAX_ONLY_KNOB is the JAX package's.\n"
        "## PyTorch + CUDA port (`ray_tpu_torch`)\n"
        "RAY_TPU_ALPHA is fine.\n"
        "RAY_TPU_GHOST is stale.\n"
        "## Next section\n"
        "RAY_TPU_OTHER_JAX_KNOB\n"
    )
    violations, errors = analyze_paths([str(pkg)])
    assert not errors
    readme = [(v.rule, v.line, v.message) for v in violations
              if v.scope == "<readme>"]
    assert [(r, n) for r, n, _ in readme] == [("TPU703", 5)]
    assert "RAY_TPU_GHOST" in readme[0][2]
    # Without the port's heading the whole README is read, as the JAX
    # package's linter reads it.
    text = (tmp_path / "README.md").read_text()
    (tmp_path / "README.md").write_text(
        text.replace("## PyTorch + CUDA port", "## Elsewhere"))
    violations, _ = analyze_paths([str(pkg)])
    assert [v.line for v in violations if v.scope == "<readme>"] == [
        2, 5, 7]


# -------------------------------------------------------------- sanitizer
def test_sanitizer_contract_table_is_the_ports(monkeypatch, caplog):
    """The repair: the port's sanitizer builds its contract table from
    the port's own protocol module (before it was ported the import
    failed, the table came back empty, and every method read as
    unknown). kv_put without its value warns of the missing parameter."""
    monkeypatch.setenv("RAY_TPU_SANITIZE", "1")
    monkeypatch.setattr(sanitize, "_contract_table", None)
    sanitize.reset()
    table = sanitize._handler_table()
    assert table == protocol.handler_signature_table()
    assert "kv_put" in table and "value" in table["kv_put"]["required"]
    with caplog.at_level("WARNING",
                         logger="ray_tpu_torch._private.sanitize"):
        sanitize.check_rpc_contract("kv_put", {"key": "k"})
    warned = [r.getMessage() for r in caplog.records
              if "rpc contract" in r.getMessage()]
    assert len(warned) == 1
    assert "omits required parameter(s) ['value']" in warned[0]
    assert "matches no" not in warned[0]


def test_sanitizer_rpc_contract_check(monkeypatch, caplog):
    monkeypatch.setenv("RAY_TPU_SANITIZE", "1")
    sanitize.reset()
    with caplog.at_level("WARNING",
                         logger="ray_tpu_torch._private.sanitize"):
        sanitize.check_rpc_contract("kv_put", {"key": "k"})
        sanitize.check_rpc_contract("kv_put", {"key": "k"})
        sanitize.check_rpc_contract("no_such_method", {})
        sanitize.check_rpc_contract("col_op:allreduce", {})  # dynamic ns
    assert sanitize.stats()["rpc_contract_misses"] == 3
    warned = [r.message for r in caplog.records
              if "rpc contract" in r.message]
    assert len(warned) == 2  # once per (method, kind)
    assert any("'value'" in m for m in warned)
    assert any("no_such_method" in m for m in warned)


def test_sanitizer_rpc_contract_over_live_connection(monkeypatch, caplog):
    import asyncio

    from ray_tpu_torch._private import rpc

    monkeypatch.setenv("RAY_TPU_SANITIZE", "1")
    sanitize.reset()

    async def go():
        async def handler(method, kw, conn):
            return {"ok": True}

        srv = rpc.Server(handler)
        port = await srv.start("127.0.0.1", 0)
        conn = await rpc.connect(f"127.0.0.1:{port}")
        reply = await conn.call("kv_put", key="a")  # missing 'value'
        assert reply == {"ok": True}
        await conn.close()
        await srv.stop()

    with caplog.at_level("WARNING",
                         logger="ray_tpu_torch._private.sanitize"):
        asyncio.run(go())
    assert sanitize.stats()["rpc_contract_misses"] == 1
    assert any("omits required parameter" in r.message
               for r in caplog.records)
