"""The port's AST lints (port of ``repro.analysis.lint``, DESIGN.md §15).

Each lint encodes one architectural rule of the engine, in the port's
idiom (PyTorch tensors, a Python window loop, hand kernels behind a
registry):

* ``REPRO-L001`` -- no materialized ``[n_guests, n_windows, k]`` trace
  arrays on the synth path;
* ``REPRO-L002`` -- no string-``if`` policy/backend/workload/collector
  dispatch outside the registries;
* ``REPRO-L003`` -- no Python branching on a tensor inside the engine's
  per-window functions (a host sync every window, and §13's rule that idle
  lanes run the same arithmetic, not a branch);
* ``REPRO-L004`` -- no full-pool ``torch.cat`` in ``core/`` (the
  predicated dual-pool gather replaced it);
* ``REPRO-L005`` -- no numpy calls inside the engine's per-window
  functions (the window runs on the device);
* ``REPRO-L006`` -- no import of ``repro_torch.kernels.build``, the loader
  of the compiled kernel library, outside the kernels subpackage: core code
  dispatches through ``repro_torch.kernels.registry``, and each kernel's
  ``ops.py`` wrapper owns its raw kernel.

The lint registry follows the port's other registries (duplicates raise,
unknown names raise listing the live set). Every lint carries a seeded
violation *fixture*, a minimal source file that must trip it, so the
self-test proves that each lint fires. Deliberate exceptions go in
:data:`ALLOWLIST` with a reason; an allowlist entry that matches nothing
is itself an error.

Run it from the root of the repository::

    PYTHONPATH=src python -m repro_torch.analysis.lint [--list] [--self-test]

It exits 1 on a violation, on an unused allowlist entry, or (with
``--self-test``) on a fixture its lint does not catch.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import sys
import tempfile
from pathlib import Path
from typing import Callable, Iterable

# --------------------------------------------------------------------------
# violations, lint registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Violation:
    lint: str
    path: str  # repo-relative posix path
    line: int
    message: str
    source_line: str = ""

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.lint}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Lint:
    """One registered lint: ``fn(tree, rel_path, lines) -> Iterable[Violation]``.

    ``fixture`` is a minimal source snippet that MUST trip the lint when
    written at ``fixture_path`` (repo-relative) -- the self-test runs every
    fixture and fails if its lint stays silent.
    """

    name: str
    description: str
    fn: Callable
    fixture: str
    fixture_path: str


_LINTS: dict[str, Lint] = {}


def register_lint(name: str, description: str, fixture: str, fixture_path: str):
    """Decorator: register an AST lint. Duplicates raise."""

    def deco(fn: Callable) -> Callable:
        if name in _LINTS:
            raise ValueError(f"lint {name!r} already registered")
        if not fixture.strip() or not fixture_path:
            raise ValueError(f"lint {name!r} needs a violation fixture")
        _LINTS[name] = Lint(name, description, fn, fixture, fixture_path)
        return fn

    return deco


def get_lint(name: str) -> Lint:
    try:
        return _LINTS[name]
    except KeyError:
        raise ValueError(f"unknown lint {name!r} (have {lint_names()})") from None


def lint_names() -> tuple[str, ...]:
    return tuple(sorted(_LINTS))


def all_lints() -> tuple[Lint, ...]:
    return tuple(_LINTS[n] for n in lint_names())


# --------------------------------------------------------------------------
# allowlist: deliberate, reasoned exceptions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AllowlistEntry:
    """Suppresses violations of ``lint`` in ``path`` whose flagged source
    line contains ``match``. ``reason`` is mandatory and human-facing."""

    lint: str
    path: str  # repo-relative posix path
    match: str  # substring of the flagged source line
    reason: str

    def __post_init__(self):
        if not self.reason.strip():
            raise ValueError(
                f"allowlist entry ({self.lint}, {self.path}) needs a reason")


ALLOWLIST: tuple[AllowlistEntry, ...] = (
    AllowlistEntry(
        lint="REPRO-L002",
        path="src/repro_torch/core/engine.py",
        match='"tco" in collect',
        reason="membership test on the run's collect tuple: it gates an "
               "optional per-window metric input (the tier hit counts); the "
               "collector itself is registry-dispatched (run_collectors).",
    ),
    AllowlistEntry(
        lint="REPRO-L002",
        path="src/repro_torch/core/sharding.py",
        match='"tco" in collect',
        reason="same collect gating as engine.py: membership decides which "
               "extras ride the ownership merge and the host-partitioned "
               "exchange, not which implementation runs (collectors stay "
               "registry-dispatched).",
    ),
    AllowlistEntry(
        lint="REPRO-L002",
        path="src/repro_torch/core/sharding.py",
        match='"near_blocks" in collect',
        reason="collect gating for the host-partitioned near_blocks "
               "exchange payload; the registry-dispatched collector "
               "consumes the merged rows.",
    ),
    AllowlistEntry(
        lint="REPRO-L002",
        path="src/repro_torch/core/sharding.py",
        match='"snapshot" in collect',
        reason="collect gating: the snapshot collector needs the guest "
               "stats in the host-partitioned carry, so the carry's layout "
               "is chosen before the chunk runs.",
    ),
    AllowlistEntry(
        lint="REPRO-L002",
        path="src/repro_torch/core/sharding.py",
        match='backend == "nccl"',
        reason="the torch.distributed transport (NCCL: one rank per card, "
               "so the rank picks its card), not a registered policy, "
               "telemetry backend, workload or collector.",
    ),
    AllowlistEntry(
        lint="REPRO-L002",
        path="src/repro_torch/launch/multihost.py",
        match='backend == "nccl"',
        reason="the torch.distributed transport, as in core/sharding.py: "
               "an NCCL rank takes its own card before joining the group.",
    ),
    AllowlistEntry(
        lint="REPRO-L005",
        path="src/repro_torch/core/sharding.py",
        match="np.float32(1) / np.float32(cfg.n_near)",
        reason="a host constant made from the static config, once per "
               "group: the float32 reciprocal of n_near that the reference's "
               "jitted division by a constant multiplies by; no tensor "
               "leaves the device.",
    ),
    AllowlistEntry(
        lint="REPRO-L001",
        path="src/repro_torch/contracts/invariants.py",
        match="tr.synth_generate(ts, gid=3, device=dev)",
        reason="INV-SYNTH-DETERMINISM must materialize the same synthesized "
               "guest twice to assert bit-equality; the contract verifies "
               "the synth path rather than being on it.",
    ),
)


# --------------------------------------------------------------------------
# AST helpers
# --------------------------------------------------------------------------

PACKAGE = "src/repro_torch/"


def _call_name(node: ast.Call) -> str:
    """Dotted name of a call target: ``torch.cat``, ``pack_traces``."""
    parts = []
    t = node.func
    while isinstance(t, ast.Attribute):
        parts.append(t.attr)
        t = t.value
    if isinstance(t, ast.Name):
        parts.append(t.id)
        return ".".join(reversed(parts))
    return ""


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _attrs_in(node: ast.AST) -> set[str]:
    return {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def _functions(tree: ast.AST):
    """Every (fn_node, qualname_parts) in the module, nested included."""
    out = []

    def visit(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((child, stack + [child.name]))
                visit(child, stack + [child.name])
            else:
                visit(child, stack)

    visit(tree, [])
    return out


def _src(lines: list[str], lineno: int) -> str:
    return lines[lineno - 1].strip() if 0 < lineno <= len(lines) else ""


def _v(name: str, rel: str, lines: list[str], node: ast.AST, msg: str) -> Violation:
    return Violation(name, rel, node.lineno, msg, _src(lines, node.lineno))


# the engine's per-window functions (L003, L005): what runs once per window
# of a driver, and the functions nested in them
_WINDOW_FILES = ("src/repro_torch/core/engine.py", "src/repro_torch/core/sharding.py")
_WINDOW_FUNCS = (
    "_window", "_window_phases", "_churn_window", "_churn_phases",
    "merge_window", "window_phases", "churn_phases", "_host_sharded_group",
)


def _per_window(rel: str, tree: ast.AST):
    """(fn_node, name) of every module-level per-window function of
    ``rel``; a walk of its node covers the functions nested in it."""
    if rel not in _WINDOW_FILES:
        return []
    return [(fn, stack[0]) for fn, stack in _functions(tree)
            if len(stack) == 1 and (stack[0] in _WINDOW_FUNCS or "_chunk" in stack[0])]


# --------------------------------------------------------------------------
# REPRO-L001: no materialized trace arrays on the synth path
# --------------------------------------------------------------------------
_L001_BANNED_CALLS = {"guest_traces", "pack_traces", "synth_generate", "ArrayTrace"}
_L001_ALLOC = {"zeros", "full", "empty", "ones"}

_L001_FIXTURE = '''\
import numpy as np
import torch

from repro_torch.core import engine


def _synth_feed(spec, device):
    # BAD: the synth path exists so that these arrays never do
    traces = engine.guest_traces(spec, n_windows=8, accesses_per_window=64)
    buf = np.zeros((4, 8, 64), np.int32)
    dev = torch.empty(4, 8, 64, dtype=torch.int32, device=device)
    return traces, buf, dev
'''


def _alloc_rank(node: ast.Call) -> int:
    """The rank of a numpy / torch allocation's shape: the length of a
    tuple or list first argument, or, for ``torch.zeros/ones/empty(d0, d1,
    ...)``, the number of positional sizes (0 when unknown)."""
    if not node.args:
        return 0
    shape = node.args[0]
    if isinstance(shape, (ast.Tuple, ast.List)):
        return len(shape.elts)
    name = _call_name(node)
    if name.startswith("torch.") and not name.endswith(".full"):
        if any(isinstance(a, ast.Starred) for a in node.args):
            return 0
        return len(node.args)
    return 0


@register_lint(
    "REPRO-L001",
    "no materialized [n_guests, n_windows, k] trace arrays on the synth "
    "path (functions named *synth*): no guest_traces/pack_traces/"
    "synth_generate/ArrayTrace calls, no rank-3 numpy or torch allocation",
    _L001_FIXTURE,
    "src/repro_torch/core/engine.py",
)
def _lint_no_materialized_trace(tree, rel, lines) -> Iterable[Violation]:
    if not rel.startswith(PACKAGE):
        return []
    out = []
    for fn, stack in _functions(tree):
        if not any("synth" in part.lower() for part in stack):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _L001_BANNED_CALLS:
                out.append(_v(
                    "REPRO-L001", rel, lines, node,
                    f"{name}() inside synth-path function "
                    f"{'.'.join(stack)} materializes a host trace array"))
            elif leaf in _L001_ALLOC and name.split(".")[0] in ("np", "numpy", "torch"):
                rank = _alloc_rank(node)
                if rank >= 3:
                    out.append(_v(
                        "REPRO-L001", rel, lines, node,
                        f"rank-{rank} {name}() allocation inside "
                        f"synth-path function {'.'.join(stack)} -- the synth "
                        "path must stay O(n_local_guests * k) per window"))
    return out


# --------------------------------------------------------------------------
# REPRO-L002: no string-if dispatch outside the registries
# --------------------------------------------------------------------------
_L002_SUBJECTS = ("policy", "backend", "workload", "collect")

_L002_FIXTURE = '''\
def tick(cfg, state, policy):
    # BAD: this is what tiering.register_policy is for
    if policy == "memtierd":
        return state
    elif policy == "autonuma":
        return state
    raise ValueError(policy)
'''


@register_lint(
    "REPRO-L002",
    "no string-compare policy/telemetry/workload/collector dispatch "
    "outside the registries: register and look up by name instead",
    _L002_FIXTURE,
    "src/repro_torch/core/tiering.py",
)
def _lint_no_string_dispatch(tree, rel, lines) -> Iterable[Violation]:
    if not rel.startswith(PACKAGE):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        subj = [
            s for s in sides
            if isinstance(s, ast.Name)
            and any(t in s.id.lower() for t in _L002_SUBJECTS)
        ]
        strs = [
            s for s in sides
            if (isinstance(s, ast.Constant) and isinstance(s.value, str))
            or (isinstance(s, (ast.Tuple, ast.List, ast.Set)) and s.elts and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in s.elts))
        ]
        if subj and strs:
            out.append(_v(
                "REPRO-L002", rel, lines, node,
                f"string comparison against {subj[0].id!r} looks like "
                "name dispatch -- use the registries (§8/§12)"))
    return out


# --------------------------------------------------------------------------
# REPRO-L003: no Python branching on tensors in the per-window functions
# --------------------------------------------------------------------------
# annotations that make a parameter tensor-valued: a tensor, or a dataclass
# whose fields are tensors (reading one of them in a test reads the device)
_L003_TENSOR_TYPES = ("Tensor", "TieredState", "ChurnState")

_L003_FIXTURE = '''\
import torch


def _window(spec, state, accesses: torch.Tensor, epoch: int):
    # BAD: the branch reads the device every window, and an idle lane
    # must run the same arithmetic, not skip it
    if accesses.sum() > 0:
        epoch += 1
    return state, epoch
'''


def _tensor_params(fn: ast.FunctionDef) -> set[str]:
    """Parameters judged tensor-valued: those whose annotation names
    ``Tensor``, ``TieredState`` or ``ChurnState`` (``torch.Tensor``,
    ``torch.Tensor | None``, a string annotation alike). An unannotated
    parameter is not judged one, nor is a ``dict`` of tensors."""
    out = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = a.annotation
        if ann is None:
            continue
        text = ann.value if isinstance(ann, ast.Constant) else ast.unparse(ann)
        if any(t in str(text) for t in _L003_TENSOR_TYPES):
            out.add(a.arg)
    return out


def _reads_value(test: ast.AST, params: set[str]) -> set[str]:
    """The params a branch test reads, leaving out identity tests (``x is
    None``) and ``isinstance``, which read no value."""
    skip: set[int] = set()
    for node in ast.walk(test):
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            skip.update(id(n) for n in ast.walk(node))
        elif isinstance(node, ast.Call) and _call_name(node) == "isinstance":
            skip.update(id(n) for n in ast.walk(node))
    return {n.id for n in ast.walk(test)
            if isinstance(n, ast.Name) and n.id in params and id(n) not in skip}


@register_lint(
    "REPRO-L003",
    "no Python if/while/assert on a tensor-valued parameter inside the "
    "engine's per-window functions: use torch.where -- idle arithmetic "
    "must be the same arithmetic, and a branch syncs the host",
    _L003_FIXTURE,
    "src/repro_torch/core/engine.py",
)
def _lint_no_tensor_branch_per_window(tree, rel, lines) -> Iterable[Violation]:
    """The port has no ``lax.scan``: its window loop is Python, and the
    per-window functions (``_WINDOW_FUNCS`` in engine.py and sharding.py,
    ``*_chunk*``, and every function nested in them) take tensors. A
    parameter is judged a tensor by its annotation alone
    (:func:`_tensor_params`: one naming ``Tensor``, ``TieredState`` or
    ``ChurnState``); an ``if``, ``while`` or ``assert`` whose test reads
    one, other than by ``is`` / ``is not`` or ``isinstance``, is flagged."""
    out = []
    for fn, name in _per_window(rel, tree):
        # the tensor parameters of the function and of those nested in it
        params = set().union(*(
            _tensor_params(f) for f in ast.walk(fn)
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))))
        for stmt in ast.walk(fn):
            if not isinstance(stmt, (ast.If, ast.While, ast.Assert)):
                continue
            used = _reads_value(stmt.test, params)
            if used:
                out.append(_v(
                    "REPRO-L003", rel, lines, stmt,
                    f"Python {type(stmt).__name__.lower()} on tensor "
                    f"parameter(s) {sorted(used)} in {name}"))
    return out


# --------------------------------------------------------------------------
# REPRO-L004: no full-pool torch.cat in core/
# --------------------------------------------------------------------------
_L004_CALLS = ("torch.cat", "torch.concat", "torch.concatenate")

_L004_FIXTURE = '''\
import torch


def consolidate(cfg, state, batch):
    near = state.near_pool.view(-1, cfg.base_elems)
    far = state.far_pool.view(-1, cfg.base_elems)
    # BAD: an O(n_slots) copy of both pools on every call
    rows = torch.cat([near, far], dim=0)
    return rows
'''


@register_lint(
    "REPRO-L004",
    "no full-pool torch.cat in core/ (O(n_slots * hp_ratio) "
    "materialization every call): use the predicated dual-pool gather",
    _L004_FIXTURE,
    "src/repro_torch/core/consolidator.py",
)
def _lint_no_full_pool_concat(tree, rel, lines) -> Iterable[Violation]:
    if not rel.startswith(PACKAGE + "core/"):
        return []
    out = []
    for fn, stack in _functions(tree):
        # one-pass taint: names assigned from expressions touching *pool*
        tainted: set[str] = set()
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign):
                refs = _names_in(stmt.value) | _attrs_in(stmt.value)
                if any("pool" in r for r in refs) or (refs & tainted):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            tainted.add(tgt.id)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _call_name(node) not in _L004_CALLS:
                continue
            refs = set()
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                refs |= _names_in(arg) | _attrs_in(arg)
            if any("pool" in r for r in refs) or (refs & tainted):
                out.append(_v(
                    "REPRO-L004", rel, lines, node,
                    f"pool concatenate in core function {'.'.join(stack)} "
                    "materializes the full slot space"))
    return out


# --------------------------------------------------------------------------
# REPRO-L005: no numpy in the per-window functions
# --------------------------------------------------------------------------
_L005_FIXTURE = '''\
import numpy as np


def _window(spec, state, accesses, epoch):
    # BAD: a numpy call pulls the window's tensors to the host
    hist = np.bincount(accesses.cpu().numpy(), minlength=spec.cfg.n_logical)
    return state, hist
'''


@register_lint(
    "REPRO-L005",
    "no direct numpy calls inside the engine's per-window functions "
    "(_window/_window_phases/_churn_window/_churn_phases and sharding's "
    "window, churn and arbitration-group functions, *_chunk*): the window "
    "runs on the device",
    _L005_FIXTURE,
    "src/repro_torch/core/engine.py",
)
def _lint_no_numpy_per_window(tree, rel, lines) -> Iterable[Violation]:
    out = []
    for fn, fn_name in _per_window(rel, tree):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name.split(".")[0] in ("np", "numpy"):
                out.append(_v(
                    "REPRO-L005", rel, lines, node,
                    f"numpy call {name}() inside per-window function {fn_name}"))
    return out


# --------------------------------------------------------------------------
# REPRO-L006: no import of the kernel library's loader outside kernels/
# --------------------------------------------------------------------------
_L006_MODULE = "repro_torch.kernels.build"

_L006_FIXTURE = '''\
from repro_torch.kernels import build


def hot_subpages_per_hp(cfg, state, hot):
    # BAD: core code dispatches through repro_torch.kernels.registry; it
    # never calls into the compiled library itself
    return build.library().rt_hot_count(hot.data_ptr(), cfg.hp_ratio)
'''


@register_lint(
    "REPRO-L006",
    "no import of repro_torch.kernels.build (the compiled library's "
    "loader) outside the kernels subpackage: dispatch through "
    "repro_torch.kernels.registry (the ops.py wrappers own the raw kernels)",
    _L006_FIXTURE,
    "src/repro_torch/core/telemetry.py",
)
def _lint_no_raw_kernel_import(tree, rel, lines) -> Iterable[Violation]:
    if not rel.startswith(PACKAGE) or rel.startswith(PACKAGE + "kernels/"):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            bad = mod == _L006_MODULE or (
                mod == "repro_torch.kernels" and any(a.name == "build" for a in node.names))
        elif isinstance(node, ast.Import):
            bad = any(a.name == _L006_MODULE for a in node.names)
        else:
            continue
        if bad:
            out.append(_v(
                "REPRO-L006", rel, lines, node,
                "the kernel library's loader imported outside repro_torch.kernels "
                "-- dispatch through repro_torch.kernels.registry instead"))
    return out


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------


def lint_file(path: Path, root: Path, lints=None) -> list[Violation]:
    rel = path.relative_to(root).as_posix()
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [Violation("SYNTAX", rel, e.lineno or 0, str(e))]
    lines = source.splitlines()
    out: list[Violation] = []
    for lint in lints or all_lints():
        out.extend(lint.fn(tree, rel, lines))
    return out


def default_targets(root: Path) -> list[Path]:
    """The linted set: every file under src/repro_torch/."""
    return sorted((root / "src" / "repro_torch").rglob("*.py"))


def apply_allowlist(
    violations: list[Violation],
    allowlist: tuple[AllowlistEntry, ...] = ALLOWLIST,
) -> tuple[list[Violation], list[AllowlistEntry]]:
    """Returns (kept violations, UNUSED allowlist entries). Both must be
    empty for a clean run: stale allowlist entries are drift too."""
    used: set[int] = set()
    kept = []
    for v in violations:
        hit = None
        for i, e in enumerate(allowlist):
            if e.lint == v.lint and e.path == v.path and e.match in v.source_line:
                hit = i
                break
        if hit is None:
            kept.append(v)
        else:
            used.add(hit)
    unused = [e for i, e in enumerate(allowlist) if i not in used]
    return kept, unused


def run(root: Path, files: list[Path] | None = None):
    """Lint ``files`` (default: src/repro_torch/**) against the allowlist.

    Returns ``(violations, unused_allowlist_entries)``.
    """
    files = files if files is not None else default_targets(root)
    violations: list[Violation] = []
    for f in files:
        violations.extend(lint_file(f, root))
    return apply_allowlist(violations)


def self_test(tmp_root: Path) -> list[str]:
    """Write every lint's seeded violation fixture under ``tmp_root`` and
    verify the lint fires on it. Returns a list of failure messages."""
    failures = []
    for lint in all_lints():
        target = tmp_root / lint.fixture_path
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(lint.fixture)
        hits = [
            v for v in lint_file(target, tmp_root, lints=[lint])
            if v.lint == lint.name
        ]
        if not hits:
            failures.append(
                f"{lint.name}: seeded violation fixture at "
                f"{lint.fixture_path} did not trip the lint")
        target.unlink()
    return failures


def main(argv: list[str] | None = None, root: Path | None = None) -> int:
    """The command line: lint the tree under ``root`` (the current
    directory), list the lints, or run the self-test."""
    ap = argparse.ArgumentParser(description="The port's AST lints (DESIGN.md §15).")
    ap.add_argument("--list", action="store_true", help="list the registered lints")
    ap.add_argument("--self-test", action="store_true",
                    help="verify that every lint trips on its seeded violation fixture")
    args = ap.parse_args(argv)
    root = Path.cwd() if root is None else root

    if args.list:
        for entry in all_lints():
            print(f"{entry.name}: {entry.description}")
        return 0

    if args.self_test:
        with tempfile.TemporaryDirectory() as td:
            failures = self_test(Path(td))
        for f in failures:
            print(f"SELF-TEST FAIL {f}", file=sys.stderr)
        for entry in all_lints():
            if not any(f.startswith(entry.name + ":") for f in failures):
                print(f"{entry.name}: fixture caught")
        print(f"lint self-test: {len(all_lints())} lints, {len(failures)} silent")
        return 1 if failures else 0

    files = default_targets(root)
    if not files:
        print(f"no files under {root / 'src' / 'repro_torch'}; run from the "
              f"repository's root", file=sys.stderr)
        return 1
    violations, unused = run(root, files)
    for v in violations:
        print(v.format(), file=sys.stderr)
        if v.source_line:
            print(f"    {v.source_line}", file=sys.stderr)
    for e in unused:
        print(
            f"stale allowlist entry: ({e.lint}, {e.path}, {e.match!r}) "
            f"matched nothing -- remove it (reason was: {e.reason})",
            file=sys.stderr)
    print(f"linted {len(files)} files with {len(all_lints())} lints: "
          f"{len(violations)} violations, {len(unused)} stale allowlist entries")
    return 1 if (violations or unused) else 0


if __name__ == "__main__":
    sys.exit(main())
