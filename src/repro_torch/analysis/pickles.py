"""Picklable-task-contract pass (mirror of ``repro.analysis.pickles``).

Task functions can be handed to a cross-process transport
(:mod:`repro_torch.core.exec`), where they travel to the worker **by
reference** — ``module.qualname`` resolved in a fresh interpreter.  Two
shapes break that silently at the submit site furthest from the
definition:

- a ``@stage``-decorated function **nested inside another function**
  (its qualname contains ``<locals>`` and it typically closes over the
  enclosing frame), and
- a ``lambda`` passed as the task body (``fn=lambda ...`` in a
  ``TaskDescription`` / ``Stage``, or as the first argument of a
  ``.submit(...)`` call on something named like a transport).

Both are fine for strictly in-process execution — mark the definition
line (or the decorator line) with ``# noqa: PKL001`` to record that the
stage is deliberately pinned to the in-process transport.  Unmarked
occurrences are findings: they make the surrounding driver silently
un-portable to ``transport="subprocess"``.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Set

from repro_torch.analysis.findings import Finding, rel

_MARKER = "noqa: PKL001"
#: callables that consume a task body by keyword
_TASK_CTORS = {"TaskDescription", "Stage"}


def _is_stage_decorator(dec: ast.expr) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    if isinstance(target, ast.Name):
        return target.id == "stage"
    if isinstance(target, ast.Attribute):
        return target.attr == "stage"
    return False


def _marked(node: ast.stmt, marked_lines: Set[int]) -> bool:
    """Marker accepted anywhere from the first decorator through the
    first body line (black may move the comment around the def)."""
    first = min([node.lineno] + [d.lineno for d in
                                 getattr(node, "decorator_list", [])])
    last = node.body[0].lineno if getattr(node, "body", None) else node.lineno
    return any(ln in marked_lines for ln in range(first, last + 1))


class _Checker(ast.NodeVisitor):
    def __init__(self, label: str, marked_lines: Set[int]):
        self.label = label
        self.marked = marked_lines
        self.findings: List[Finding] = []
        self._depth = 0  # function nesting depth

    def _visit_fn(self, node) -> None:
        if (self._depth > 0
                and any(_is_stage_decorator(d) for d in node.decorator_list)
                and not _marked(node, self.marked)):
            self.findings.append(Finding(
                pass_name="pickles", rule="stage-nested",
                file=self.label, line=node.lineno, symbol=node.name,
                message=f"`@stage` function `{node.name}` is nested inside "
                        "another function; it cannot cross a subprocess "
                        "transport (qualname has <locals>) — move it to "
                        "module level, or mark the def `# noqa: PKL001` "
                        "if the driver pins the in-process transport",
            ))
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Call(self, node: ast.Call) -> None:
        target = node.func
        name = target.id if isinstance(target, ast.Name) else (
            target.attr if isinstance(target, ast.Attribute) else None)
        lam = None
        if name in _TASK_CTORS:
            for kw in node.keywords:
                if kw.arg == "fn" and isinstance(kw.value, ast.Lambda):
                    lam = kw.value
        elif (name == "submit" and isinstance(target, ast.Attribute)
                and node.args and isinstance(node.args[0], ast.Lambda)):
            lam = node.args[0]
        if lam is not None and lam.lineno not in self.marked \
                and node.lineno not in self.marked:
            self.findings.append(Finding(
                pass_name="pickles", rule="lambda-task",
                file=self.label, line=lam.lineno, symbol=name,
                message=f"lambda passed as a task body to `{name}`; "
                        "lambdas cannot travel to a subprocess worker — "
                        "use a module-level function, or mark the line "
                        "`# noqa: PKL001` for in-process-only call sites",
            ))
        self.generic_visit(node)


def check_file(path: Path, root: Path) -> List[Finding]:
    source = path.read_text()
    marked = {i for i, line in enumerate(source.splitlines(), start=1)
              if _MARKER in line}
    checker = _Checker(rel(path, root), marked)
    checker.visit(ast.parse(source, filename=str(path)))
    return checker.findings


def run(paths: List[Path], root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for p in sorted(paths):
        findings.extend(check_file(p, root))
    return findings
