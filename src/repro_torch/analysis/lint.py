"""AST lint for the port's hot-path and API hygiene invariants.

Port of ``repro.analysis.lint``, the same four rules run over
``src/repro_torch`` (``launch/analyze.py``).  The metric namespace is the
reference's ``repro.<subsystem>.<name>``, which the port's metrics keep so
that dashboards and the drift monitor join the two packages' series.
Each rule was born from a bug class the reference has already paid for
(or been one review away from):

``public-assert``
    Public ``src/`` API paths must raise ``ValueError`` on bad input, not
    ``assert``: asserts vanish under ``python -O`` and read as internal
    invariants, not argument validation.  A function is *private* when any
    enclosing scope name starts with a single underscore (dunders are
    public).

``metric-name``
    Metric names are a cross-cutting namespace; dashboards and the drift
    monitor join on them.  Literal names passed to ``.counter`` /
    ``.gauge`` / ``.histogram`` must match ``repro.<subsystem>.<name>``
    (lowercase, dot-separated, at least three segments).

``hot-path-alloc``
    The traced-disabled dispatch path (``if not ...enabled:`` branches)
    runs once per request even when observability is off; it must not
    allocate (displays, comprehensions, f-strings, lambdas, ``with``
    locks) or call anything beyond a small allowlist.

``bare-except``
    Bare ``except:`` is forbidden everywhere.  Broad handlers
    (``except Exception``/``BaseException``) in the serving and obs
    layers must either carry ``# noqa: BLE001`` on the clause line (a
    reviewed, deliberate swallow) or re-raise with a bare ``raise``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, List, Sequence, Tuple

#: Calls the traced-disabled dispatch path may make: publishing the
#: dispatch record is the one job that branch keeps when tracing is off
#: (``len`` rides along — allocation-free O(1) builtin).
HOT_PATH_ALLOWED_CALLS = frozenset({"_publish", "DispatchRecord", "len"})

#: Directories (relative to the lint root) whose broad excepts must be
#: explicitly reviewed (rule ``bare-except``, second half).
GUARDED_EXCEPT_DIRS = ("serve", "obs")

_METRIC_METHODS = frozenset({"counter", "gauge", "histogram"})
_METRIC_NAME_RE = re.compile(
    r"^repro\.[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One lint violation, pointing at a source line."""

    code: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.code}] {self.message}"


def _is_private_scope(scope_names: Sequence[str]) -> bool:
    """Private iff any enclosing function/class name is ``_name`` (single
    leading underscore); dunders like ``__init__`` count as public."""
    for name in scope_names:
        if name.startswith("_") and not (name.startswith("__")
                                         and name.endswith("__")):
            return True
    return False


def _call_name(node: ast.Call) -> str:
    """The terminal name a call resolves through (``f`` / ``obj.f`` → f)."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _is_disabled_guard(test: ast.expr) -> bool:
    """``not enabled`` / ``not <x>.enabled`` — the traced-off fast path."""
    if not (isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)):
        return False
    opnd = test.operand
    if isinstance(opnd, ast.Attribute) and opnd.attr == "enabled":
        return True
    return isinstance(opnd, ast.Name) and opnd.id == "enabled"


_ALLOC_NODES = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp,
                ast.Lambda, ast.JoinedStr, ast.List, ast.Set, ast.Dict)


def _hot_path_violations(body: Sequence[ast.stmt]
                         ) -> List[Tuple[int, str]]:
    """(line, what) for each allocation/lock/stray call under a guard."""
    out: List[Tuple[int, str]] = []
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                name = _call_name(node)
                if name not in HOT_PATH_ALLOWED_CALLS:
                    out.append((node.lineno, f"call to {name or '<expr>'}()"))
            elif isinstance(node, _ALLOC_NODES):
                kind = type(node).__name__
                out.append((node.lineno, f"allocation ({kind})"))
            elif isinstance(node, ast.With):
                out.append((node.lineno, "lock/context acquisition (with)"))
    return out


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, lines: Sequence[str], guarded: bool):
        self.path = path
        self.lines = lines
        self.guarded = guarded  # broad-except review required (serve/obs)
        self.scopes: List[str] = []
        self.findings: List[LintFinding] = []

    # -- scope tracking ----------------------------------------------------
    def _scoped(self, node) -> None:
        self.scopes.append(node.name)
        self.generic_visit(node)
        self.scopes.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _scoped

    # -- rule: public-assert ----------------------------------------------
    def visit_Assert(self, node: ast.Assert) -> None:
        if not _is_private_scope(self.scopes):
            where = ".".join(self.scopes) or "<module>"
            self.findings.append(LintFinding(
                "public-assert", self.path, node.lineno,
                f"assert on public path {where}: raise ValueError instead "
                f"(asserts vanish under -O)"))
        self.generic_visit(node)

    # -- rule: metric-name -------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_METHODS and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            name = node.args[0].value
            if not _METRIC_NAME_RE.match(name):
                self.findings.append(LintFinding(
                    "metric-name", self.path, node.lineno,
                    f"metric name {name!r} does not match "
                    f"repro.<subsystem>.<name>"))
        self.generic_visit(node)

    # -- rule: hot-path-alloc ----------------------------------------------
    def visit_If(self, node: ast.If) -> None:
        if _is_disabled_guard(node.test):
            for line, what in _hot_path_violations(node.body):
                self.findings.append(LintFinding(
                    "hot-path-alloc", self.path, line,
                    f"{what} in the traced-disabled fast path; only "
                    f"{sorted(HOT_PATH_ALLOWED_CALLS)} are allowed there"))
        self.generic_visit(node)

    # -- rule: bare-except -------------------------------------------------
    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self.findings.append(LintFinding(
                "bare-except", self.path, node.lineno,
                "bare 'except:' swallows KeyboardInterrupt/SystemExit; "
                "name the exception type"))
        elif self.guarded and self._is_broad(node.type):
            line = self.lines[node.lineno - 1] if (
                0 < node.lineno <= len(self.lines)) else ""
            noqa = "noqa" in line and "BLE001" in line
            reraises = any(isinstance(n, ast.Raise) and n.exc is None
                           for stmt in node.body for n in ast.walk(stmt))
            if not (noqa or reraises):
                self.findings.append(LintFinding(
                    "bare-except", self.path, node.lineno,
                    "broad except in a serving/obs hook must re-raise or "
                    "carry '# noqa: BLE001' with a justification"))
        self.generic_visit(node)

    @staticmethod
    def _is_broad(tp: ast.expr) -> bool:
        names = tp.elts if isinstance(tp, ast.Tuple) else [tp]
        return any(isinstance(n, ast.Name)
                   and n.id in ("Exception", "BaseException")
                   for n in names)


def lint_source(src: str, path: str = "<string>", *,
                guarded_except: bool = False) -> List[LintFinding]:
    """Lint one module's source text.  ``guarded_except`` applies the
    strict broad-except rule (serving/obs layers)."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintFinding("syntax-error", path, e.lineno or 0, str(e))]
    linter = _Linter(path, src.splitlines(), guarded_except)
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: (f.path, f.line, f.code))


def _iter_py(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if not d.startswith("__"))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def _needs_guard(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return any(d in parts for d in GUARDED_EXCEPT_DIRS)


def lint_paths(paths: Iterable[str] | str) -> List[LintFinding]:
    """Lint every ``.py`` file under the given paths (files or dirs)."""
    if isinstance(paths, str):
        paths = [paths]
    findings: List[LintFinding] = []
    for path in _iter_py(paths):
        with open(path, "r") as f:
            src = f.read()
        findings.extend(lint_source(src, path,
                                    guarded_except=_needs_guard(path)))
    return sorted(findings, key=lambda f: (f.path, f.line, f.code))
