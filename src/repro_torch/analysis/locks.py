"""Lock-discipline pass (mirror of ``repro.analysis.locks``).

Shared attributes are declared at their assignment site with an inline
comment::

    self._stats = {}  # guarded-by: _lock

(dataclass field lines work the same way).  Every subsequent read or
write of a declared attribute inside the class must then occur

- under ``with self.<lock>:`` (a ``threading.Condition`` counts — its
  context manager holds the underlying lock), or
- inside a method whose name ends in ``_locked``, or whose ``def`` line
  carries ``# caller-locked`` (the repo's convention for helpers that
  document "caller holds the lock"), or
- inside ``__init__``/``__post_init__`` (publication happens-before any
  cross-thread access).

Nested ``def``s reset the held-lock set — a closure handed to a thread,
callback list, or executor escapes the ``with`` block that created it.
``lambda``s inherit it: the repo uses them as immediate
``Condition.wait_for`` predicates that run under the lock.

``# lock-ok`` on an access line suppresses the finding (for accesses
that are safe for a reason the AST cannot see — e.g. reading a counter
for a log line where staleness is acceptable by design).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Set

from repro_torch.analysis.findings import Finding, rel

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_LOCK_OK = "# lock-ok"
_CALLER_LOCKED = "# caller-locked"
_EXEMPT_METHODS = {"__init__", "__post_init__"}


def _comment_maps(source: str):
    guarded: Dict[int, str] = {}
    lock_ok: Set[int] = set()
    caller_locked: Set[int] = set()
    for i, line in enumerate(source.splitlines(), start=1):
        m = _GUARDED_RE.search(line)
        if m:
            guarded[i] = m.group(1)
        if _LOCK_OK in line:
            lock_ok.add(i)
        if _CALLER_LOCKED in line:
            caller_locked.add(i)
    return guarded, lock_ok, caller_locked


def _self_attr(node: ast.expr):
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self"):
        return node.attr
    return None


class _ClassChecker(ast.NodeVisitor):
    """Walks one method body tracking the set of held self-locks."""

    def __init__(self, cls_name: str, guarded_attrs: Dict[str, str],
                 lock_ok: Set[int], file_label: str):
        self.cls_name = cls_name
        self.guarded_attrs = guarded_attrs          # attr -> lock name
        self.lock_names = set(guarded_attrs.values())
        self.lock_ok = lock_ok
        self.file_label = file_label
        self.findings: List[Finding] = []
        self._held: Set[str] = set()

    # -- scope handling -------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        added: Set[str] = set()
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in self.lock_names:
                added.add(attr)
            else:
                self.visit(item.context_expr)
        prev = self._held
        self._held = prev | added
        for stmt in node.body:
            self.visit(stmt)
        self._held = prev

    def _visit_nested(self, node, reset: bool) -> None:
        prev = self._held
        if reset:
            self._held = set()
        self.generic_visit(node)
        self._held = prev

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_nested(node, reset=node.lineno not in self.lock_ok)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._visit_nested(node, reset=node.lineno not in self.lock_ok)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # wait_for predicates run under the Condition's lock
        self._visit_nested(node, reset=False)

    # -- access detection -----------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None and attr in self.guarded_attrs:
            lock = self.guarded_attrs[attr]
            if lock not in self._held and node.lineno not in self.lock_ok:
                self.findings.append(Finding(
                    pass_name="locks", rule="guarded-attr",
                    file=self.file_label, line=node.lineno,
                    symbol=f"{self.cls_name}.{attr}",
                    message=f"access to `self.{attr}` (guarded-by: {lock}) "
                            f"without holding `self.{lock}`",
                ))
        self.generic_visit(node)


def _collect_guarded(cls: ast.ClassDef, guarded_lines: Dict[int, str]) -> Dict[str, str]:
    """attr name -> lock name, from declaration comments anywhere in the class."""
    out: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.AnnAssign):
            targets = [node.target]
        elif isinstance(node, ast.Assign):
            targets = node.targets
        else:
            continue
        lock = guarded_lines.get(node.lineno)
        if lock is None:
            continue
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                out[attr] = lock
            elif isinstance(t, ast.Name):      # dataclass field line
                out[t.id] = lock
    return out


def check_file(path: Path, root: Path, classes: Set[str] | None = None) -> List[Finding]:
    source = path.read_text()
    guarded_lines, lock_ok, caller_locked = _comment_maps(source)
    tree = ast.parse(source, filename=str(path))
    label = rel(path, root)
    findings: List[Finding] = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        if classes is not None and cls.name not in classes:
            continue
        guarded = _collect_guarded(cls, guarded_lines)
        if not guarded:
            continue
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if meth.name in _EXEMPT_METHODS or meth.name.endswith("_locked"):
                continue
            def_lines = range(meth.lineno, meth.body[0].lineno + 1)
            if any(ln in caller_locked for ln in def_lines):
                continue
            checker = _ClassChecker(cls.name, guarded, lock_ok, label)
            for stmt in meth.body:
                checker.visit(stmt)
            findings.extend(checker.findings)
    return findings


def run(paths: List[Path], root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for p in sorted(paths):
        findings.extend(check_file(p, root))
    return findings
