"""Broad-except lint (BLE001-equivalent, no ruff dependency; mirror of
``repro.analysis.excepts``).

Flags ``except:``, ``except Exception:`` and ``except BaseException:``
(alone or inside a tuple) unless the handler line carries
``# noqa: BLE001`` — the repo's marker for a deliberate isolation
boundary (task runner, service loop, observer fan-out).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.findings import Finding, rel

_BROAD = {"Exception", "BaseException"}


def _broad_name(node: Optional[ast.expr]) -> Optional[str]:
    if node is None:
        return "bare except"
    if isinstance(node, ast.Name) and node.id in _BROAD:
        return node.id
    if isinstance(node, ast.Attribute) and node.attr in _BROAD:
        return node.attr
    if isinstance(node, ast.Tuple):
        for elt in node.elts:
            name = _broad_name(elt)
            if name is not None:
                return name
    return None


def check_file(path: Path, root: Path) -> List[Finding]:
    source = path.read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        name = _broad_name(node.type)
        if name is None:
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        if "noqa: BLE001" in line:
            continue
        out.append(Finding(
            pass_name="excepts", rule="broad-except",
            file=rel(path, root), line=node.lineno,
            symbol=name,
            message=f"broad `except {name}` without `# noqa: BLE001` "
                    f"isolation-boundary marker",
        ))
    return out


def run(paths: List[Path], root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for p in sorted(paths):
        findings.extend(check_file(p, root))
    return findings
