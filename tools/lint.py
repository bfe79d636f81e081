#!/usr/bin/env python
"""Dependency-free linter (stdlib only) for gwen.

The reference ships a pre-commit stack (black/isort/pylint/flake8/mypy,
.pre-commit-config.yaml) that needs network-installed tools; this
environment is hermetic, so tools/ci.sh runs THIS checker locally while
.github/workflows/ci.yml runs ruff+mypy (configs checked in at ruff.toml /
mypy.ini) wherever pip is available.

Checks: syntax (compile), unused imports, **undefined names** (pyflakes
F821-style, via stdlib ``symtable`` scope analysis — zero false positives
on this repo), bare except, mutable default arguments, trailing whitespace,
tabs in indentation, lines > 100 columns, and `== None` / `!= None`
comparisons.

Usage: python tools/lint.py [paths...]   (default: gwen tests benchmarks
bench.py __graft_entry__.py)
"""

from __future__ import annotations

import ast
import builtins
import symtable
import sys
from pathlib import Path

MAX_COLS = 100

_IMPLICIT = {"__class__", "__module__", "__qualname__", "__doc__",
             "__file__", "__name__", "__path__", "__spec__"}


def undefined_names(src: str, path: Path) -> list[str]:
    """F821-style undefined-name detection via ``symtable``: a symbol that
    is referenced but never assigned/imported/bound-as-parameter in its
    scope resolves to module globals — if it is not a module-level
    definition or a builtin, it is a typo waiting for runtime."""
    try:
        st = symtable.symtable(src, str(path), "exec")
    except SyntaxError:
        return []  # reported by the ast pass
    module_defs = {s.get_name() for s in st.get_symbols()
                   if s.is_assigned() or s.is_imported()}
    problems: list[str] = []

    def walk(table: symtable.SymbolTable) -> None:
        for sym in table.get_symbols():
            name = sym.get_name()
            if (not sym.is_referenced() or sym.is_assigned()
                    or sym.is_imported() or sym.is_parameter()
                    or sym.is_free()):
                continue
            if (name in module_defs or hasattr(builtins, name)
                    or name in _IMPLICIT):
                continue
            problems.append(
                f"{path}:{table.get_lineno()}: undefined name {name!r} "
                f"(in {table.get_name()!r})"
            )
        for child in table.get_children():
            walk(child)

    walk(st)
    return problems


class ImportTracker(ast.NodeVisitor):
    def __init__(self) -> None:
        self.imported: dict[str, tuple[int, str]] = {}  # name -> (line, label)
        self.used: set[str] = set()

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            name = (a.asname or a.name).split(".")[0]
            self.imported[name] = (node.lineno, a.name)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "__future__":  # has effect without being "used"
            return
        for a in node.names:
            if a.name == "*":
                continue
            name = a.asname or a.name
            self.imported[name] = (node.lineno, f"{node.module}.{a.name}")

    def visit_Name(self, node: ast.Name) -> None:
        self.used.add(node.id)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self.generic_visit(node)


def lint_file(path: Path) -> list[str]:
    problems: list[str] = []
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [f"{path}:{e.lineno}: syntax error: {e.msg}"]

    problems.extend(undefined_names(src, path))

    # Unused imports (skip __init__.py — re-export surface — and names
    # referenced in __all__ or noqa'd lines).
    if path.name != "__init__.py":
        tracker = ImportTracker()
        tracker.visit(tree)
        noqa = {
            i + 1 for i, line in enumerate(src.splitlines()) if "noqa" in line
        }
        in_all = set()
        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign)
                    and any(getattr(t, "id", "") == "__all__" for t in node.targets)
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                in_all |= {
                    c.value for c in node.value.elts
                    if isinstance(c, ast.Constant) and isinstance(c.value, str)
                }
        for name, (line, label) in tracker.imported.items():
            if name not in tracker.used and name not in in_all and line not in noqa:
                problems.append(f"{path}:{line}: unused import {label!r}")

    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            problems.append(f"{path}:{node.lineno}: bare `except:`")
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for default in node.args.defaults + node.args.kw_defaults:
                if isinstance(default, (ast.List, ast.Dict, ast.Set, ast.Call)):
                    if isinstance(default, ast.Call):
                        fn = default.func
                        name = getattr(fn, "id", getattr(fn, "attr", ""))
                        # Immutable-producing calls are fine.
                        if name in ("frozenset", "tuple", "Path", "field",
                                    "partial", "dtype"):
                            continue
                    problems.append(
                        f"{path}:{default.lineno}: mutable default argument "
                        f"in {node.name}()"
                    )
        if isinstance(node, ast.Compare):
            for op, comp in zip(node.ops, node.comparators):
                if (isinstance(op, (ast.Eq, ast.NotEq))
                        and isinstance(comp, ast.Constant) and comp.value is None):
                    problems.append(
                        f"{path}:{node.lineno}: use `is None` / `is not None`"
                    )

    for i, line in enumerate(src.splitlines(), 1):
        if "noqa" in line:
            continue
        if line != line.rstrip():
            problems.append(f"{path}:{i}: trailing whitespace")
        stripped = line.lstrip(" ")
        if stripped.startswith("\t") or line.startswith("\t"):
            problems.append(f"{path}:{i}: tab in indentation")
        if len(line) > MAX_COLS:
            problems.append(f"{path}:{i}: line too long ({len(line)} > {MAX_COLS})")
    return problems


def main(argv: list[str]) -> int:
    targets = argv or ["gwen", "tests", "benchmarks", "bench.py",
                       "__graft_entry__.py"]
    files: list[Path] = []
    for t in targets:
        p = Path(t)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    all_problems: list[str] = []
    for f in files:
        all_problems.extend(lint_file(f))
    for p in all_problems:
        print(p)
    print(f"lint: {len(files)} files, {len(all_problems)} problem(s)")
    return 1 if all_problems else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
