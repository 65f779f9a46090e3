"""The port's AST lints (``repro_torch.analysis.lint``, DESIGN.md §15).

Every registered lint must fire on its seeded violation fixture, the port
itself must be clean under the full set with no stale allowlist entry, and
the set of lints is the reference's (``repro.analysis.lint``).
"""
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import lint

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", lint.lint_names())
def test_lint_fires_on_its_fixture(name, tmp_path):
    entry = lint.get_lint(name)
    target = tmp_path / entry.fixture_path
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(entry.fixture)
    violations = lint.lint_file(target, tmp_path, lints=[entry])
    assert any(v.lint == name for v in violations), (
        f"{name} went silent on its own fixture")
    for v in violations:  # every violation self-locates
        assert v.line > 0 and v.source_line.strip()
        assert name in v.format()


def test_self_test_driver_passes(tmp_path):
    assert lint.self_test(tmp_path) == []


def test_port_is_lint_clean():
    violations, unused = lint.run(REPO_ROOT)
    assert violations == [], "\n".join(v.format() for v in violations)
    assert unused == [], (
        "stale allowlist entries: "
        + ", ".join(f"({e.lint}, {e.path}, {e.match!r})" for e in unused))
    targets = lint.default_targets(REPO_ROOT)
    assert targets and all("src/repro_torch/" in t.as_posix() for t in targets)


def test_lint_names_match_reference():
    assert lint.lint_names() == jlint.lint_names()
    assert len(lint.lint_names()) == 6


def test_registry_and_allowlist_errors(monkeypatch):
    monkeypatch.setattr(lint, "_LINTS", dict(lint._LINTS))
    with pytest.raises(ValueError, match="already registered"):
        @lint.register_lint("REPRO-L001", "dup", fixture="x = 1\n",
                            fixture_path="src/repro_torch/data/f.py")
        def dup(tree, rel, lines):
            return []
    with pytest.raises(ValueError, match="fixture"):
        @lint.register_lint("REPRO-L900", "no fixture", fixture="",
                            fixture_path="src/repro_torch/data/f.py")
        def bare(tree, rel, lines):
            return []
    with pytest.raises(ValueError, match="REPRO-L001"):
        lint.get_lint("REPRO-L999")
    for e in lint.ALLOWLIST:
        assert e.reason.strip(), f"({e.lint}, {e.path}) missing reason"
    with pytest.raises(ValueError, match="reason"):
        lint.AllowlistEntry(lint="REPRO-L001", path="x.py", match="y", reason=" ")


def _violations(tmp_path: Path, rel: str, source: str) -> list:
    target = tmp_path / rel
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(source)
    return lint.lint_file(target, tmp_path)


def test_lints_judge_the_ports_idiom(tmp_path):
    """What the rules leave alone and what they catch beyond the fixtures:
    an identity test, a host flag and an unannotated parameter are no
    tensor branch; a loop over a tensor's values is; a rank-1 fill on the
    synth path is fine and a rank-3 torch.zeros in varargs form is not;
    a torch.cat of the pools outside core/ is not linted."""
    clean = '''\
import torch


def _window_phases(spec, state: "TieredState", accesses: torch.Tensor,
                   use_gpac: bool, collect, lane):
    if state is None or isinstance(accesses, tuple):
        return state
    if use_gpac and lane:
        return state
    return state


def _synth_rows(n, device):
    return torch.full((n,), -1, dtype=torch.int32, device=device)
'''
    assert _violations(tmp_path, "src/repro_torch/core/engine.py", clean) == []
    caught = '''\
import torch


def _churn_window(spec, cs: "ChurnState", accesses: torch.Tensor | None):
    def inner(active: torch.Tensor):
        while active.any():
            active = active[1:]
    assert accesses.numel() > 0
    return cs


def _synth_buffer(g, w, k):
    return torch.zeros(g, w, k)
'''
    got = sorted((v.lint, v.line) for v in _violations(
        tmp_path, "src/repro_torch/core/engine.py", caught))
    assert got == [("REPRO-L001", 13), ("REPRO-L003", 6), ("REPRO-L003", 8)], got
    pools = '''\
import torch


def rows(state):
    return torch.cat([state.near_pool, state.far_pool])
'''
    assert _violations(tmp_path, "src/repro_torch/memory/rows.py", pools) == []
    assert [v.lint for v in _violations(
        tmp_path, "src/repro_torch/core/rows.py", pools)] == ["REPRO-L004"]


def test_command_line(tmp_path):
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"],
                         capture_output=True, text=True, cwd=REPO_ROOT, timeout=120,
                         env={"PYTHONPATH": str(REPO_ROOT / "src"), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert "0 violations, 0 stale allowlist entries" in res.stdout
    assert lint.main(["--self-test"], root=tmp_path) == 0
    # a tree with a violation, or with nothing to lint, exits 1
    bad = tmp_path / "bad"
    entry = lint.get_lint("REPRO-L002")
    assert _violations(bad, entry.fixture_path, entry.fixture)
    assert lint.main([], root=bad) == 1
    assert lint.main([], root=tmp_path / "empty") == 1
