"""Finding records and the baseline diff protocol (mirror of
``repro.analysis.findings``).

A finding's *key* deliberately excludes the line number: edits above a
known (baselined) finding must not make it read as "new".  The committed
baseline is a JSON list of keys; the CLI exits dirty only when a finding's
key is absent from the baseline.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, List, Sequence, Set


@dataclass(frozen=True)
class Finding:
    pass_name: str   # locks | jit | kernels | excepts
    rule: str        # e.g. guarded-attr, host-sync, kernel-contract
    file: str        # repo-relative posix path ('' for matrix findings)
    line: int        # 1-based; 0 when not tied to a source line
    symbol: str      # Class.attr, function name, or config/layout key
    message: str

    def key(self) -> str:
        return f"{self.pass_name}:{self.rule}:{self.file}:{self.symbol}"

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.file else self.symbol
        return f"[{self.pass_name}/{self.rule}] {loc}: {self.symbol}: {self.message}"


@dataclass
class PassResult:
    name: str
    findings: List[Finding] = field(default_factory=list)
    stats: dict = field(default_factory=dict)


def load_baseline(path: Path) -> Set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("findings", []))


def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    keys = sorted({f.key() for f in findings})
    path.write_text(json.dumps({"findings": keys}, indent=2) + "\n")


def diff_against_baseline(
    findings: Sequence[Finding], baseline: Set[str]
) -> tuple[List[Finding], Set[str]]:
    """Returns (new findings, stale baseline keys)."""
    keys = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in baseline]
    stale = baseline - keys
    return new, stale


def rel(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()
