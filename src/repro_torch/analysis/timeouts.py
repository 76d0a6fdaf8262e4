"""Unbounded-blocking lint (TMO001): blocking calls need timeouts (mirror
of ``repro.analysis.timeouts``).

Every hang the resilience layer guards against (a stalled worker, a
dropped RPC reply, a crashed engine holding waiters) turns into a
*deadlock* if the waiting side blocks forever.  This pass walks the
runtime files and flags blocking calls issued with **no timeout**:

- ``Condition.wait()`` / ``Event.wait()`` / ``Request.wait()`` /
  ``Task.wait()`` — any zero-argument ``.wait()``;
- ``Future.result()`` — zero-argument ``.result()``;
- ``Thread.join()`` / ``Process.join()`` — zero-argument ``.join()``
  (a ``str.join`` always takes its iterable, so it never matches);
- ``Channel.recv()`` / ``socket.recv`` — zero-argument ``.recv()``;
- ``ServiceControl.wait_for_work()`` — zero-argument;
- any of the above called with an explicit ``timeout=None``.

A deliberately unbounded wait (a worker's main RPC read loop, a parked
engine waiting for its restart signal) is annotated with
``# noqa: TMO001`` on the call line, mirroring the broad-except pass's
``# noqa: BLE001`` marker; everything else must pass a timeout so the
enclosing retry/deadline policy can actually fire.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.findings import Finding, rel

#: method names that block until an event that may never come
_BLOCKING = {"wait", "result", "join", "recv", "wait_for_work"}


def _timeout_of(call: ast.Call) -> Optional[ast.expr]:
    """The expression bounding the call, or None when unbounded.

    The blocking APIs above all take the timeout as their first
    positional argument or as ``timeout=``.
    """
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "timeout":
            return kw.value
    return None


def _is_none(node: Optional[ast.expr]) -> bool:
    return (node is None
            or (isinstance(node, ast.Constant) and node.value is None))


def check_file(path: Path, root: Path) -> List[Finding]:
    source = path.read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    out: List[Finding] = []
    # map every call to its enclosing function for a stable symbol
    parents: dict = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not isinstance(func, ast.Attribute) or func.attr not in _BLOCKING:
            continue
        if not _is_none(_timeout_of(node)):
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        if "noqa: TMO001" in line:
            continue
        scope = node
        while scope in parents and not isinstance(
                scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = parents[scope]
        fn_name = (scope.name if isinstance(
            scope, (ast.FunctionDef, ast.AsyncFunctionDef)) else "<module>")
        try:
            call_text = ast.unparse(func)
        except Exception:  # noqa: BLE001 — lint must not die on odd AST
            call_text = func.attr
        out.append(Finding(
            pass_name="timeouts", rule="unbounded-blocking",
            file=rel(path, root), line=node.lineno,
            symbol=f"{fn_name}:{call_text}",
            message=f"`{call_text}()` blocks with no timeout — pass one "
                    f"(or mark a deliberate unbounded wait with "
                    f"`# noqa: TMO001`)",
        ))
    return out


def run(paths: List[Path], root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for p in sorted(paths):
        findings.extend(check_file(p, root))
    return findings
