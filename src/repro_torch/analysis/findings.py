"""Finding records + the documented allowlist (``allowlist.toml``).

Counterpart of ``repro.analysis.findings``; the same catalog, records
and parser.

A :class:`Finding` is one analyzer hit: ``path:line:col``, the check ID,
the enclosing symbol (dotted function/class path — what the allowlist
matches on, so entries survive line-number drift), a message, and a fix
hint.

The allowlist is TOML next to this module: an array of ``[[allow]]``
tables, each requiring ``check`` + ``path`` + ``symbol`` + ``reason``.
``reason`` is mandatory — the CI gate (``--strict``) refuses entries
without one, and also refuses *stale* entries that no longer match any
finding (so the allowlist can only shrink-to-fit, never rot).

Python 3.10 has no ``tomllib``; :func:`load_allowlist` uses it when
available and otherwise falls back to a deliberately tiny parser for
exactly the subset the allowlist uses (``[[allow]]`` tables of string
key/values, comments, blank lines). Anything fancier is a parse error —
by design, so the file stays trivially reviewable.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

#: check-ID -> one-line description (the reference's catalog; a "traced"
#: value is a tensor of the run's data, the counterpart of a JAX tracer,
#: and the jit scope is the code a CUDA graph captures)
CHECKS: Dict[str, str] = {
    "CK101": "traced FamParams field flows into a compile key",
    "CK102": "unhashable value (array/list/dict/set) used as a static tag",
    "CK103": "non-frozen dataclass participates in compile keys",
    "TC201": "Python if/while/ternary on a traced value in the jit scope",
    "TC202": "bool()/assert/not/and/or on a traced value in the jit scope",
    "HS301": "scalar host sync (.item()/float()/int()) on a traced value",
    "HS302": "host materialization (np.asarray/.tolist()/.cpu()/.numpy()/"
             "nonzero/mask indexing/synchronize) on a traced value",
    "DT401": "wall-clock / stdlib-random use in a deterministic module",
    "DT402": "global-state or unseeded numpy/torch PRNG in a deterministic "
             "module",
    "DT403": "unsorted set iteration feeding trace/plan construction",
}


@dataclass(frozen=True)
class Finding:
    check: str
    path: str
    line: int
    col: int
    symbol: str          # dotted enclosing scope, e.g. "Cls.method" / "<module>"
    message: str
    hint: str = ""

    def format(self) -> str:
        s = f"{self.path}:{self.line}:{self.col}: {self.check} " \
            f"[{self.symbol}] {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


@dataclass(frozen=True)
class AllowEntry:
    check: str
    path: str            # suffix-matched against the finding's path
    symbol: str          # matches the qualname or its last component
    reason: str = ""

    def matches(self, f: Finding) -> bool:
        if self.check != f.check:
            return False
        norm = f.path.replace("\\", "/")
        if not norm.endswith(self.path):
            return False
        return self.symbol in (f.symbol, f.symbol.split(".")[-1])


@dataclass
class Allowlist:
    entries: List[AllowEntry] = field(default_factory=list)
    #: entries that matched at least one finding (stale detection)
    _used: set = field(default_factory=set)

    def allows(self, f: Finding) -> bool:
        for e in self.entries:
            if e.matches(f):
                self._used.add(e)
                return True
        return False

    def stale_entries(self) -> List[AllowEntry]:
        return [e for e in self.entries if e not in self._used]

    def unjustified_entries(self) -> List[AllowEntry]:
        return [e for e in self.entries if not e.reason.strip()]


DEFAULT_ALLOWLIST = Path(__file__).resolve().parent / "allowlist.toml"

_TABLE_RE = re.compile(r"^\[\[(\w+)\]\]$")
_KV_RE = re.compile(r'^(\w+)\s*=\s*"((?:[^"\\]|\\.)*)"$')


def _parse_toml_subset(text: str) -> List[Dict[str, str]]:
    """Parse the ``[[allow]]``-tables-of-strings subset (3.10 fallback)."""
    tables: List[Dict[str, str]] = []
    current: Optional[Dict[str, str]] = None
    for ln, raw in enumerate(text.splitlines(), 1):
        # strip comments, respecting '#' inside quoted values
        in_str = False
        line = raw
        for i, ch in enumerate(raw):
            if ch == '"' and (i == 0 or raw[i - 1] != "\\"):
                in_str = not in_str
            elif ch == "#" and not in_str:
                line = raw[:i]
                break
        line = line.strip()
        if not line:
            continue
        m = _TABLE_RE.match(line)
        if m:
            if m.group(1) != "allow":
                raise ValueError(f"allowlist line {ln}: unknown table "
                                 f"[[{m.group(1)}]] (only [[allow]])")
            current = {}
            tables.append(current)
            continue
        m = _KV_RE.match(line)
        if m:
            if current is None:
                raise ValueError(f"allowlist line {ln}: key/value outside "
                                 "an [[allow]] table")
            current[m.group(1)] = m.group(2).replace('\\"', '"')
            continue
        raise ValueError(
            f"allowlist line {ln}: unsupported syntax {line!r} (the "
            'allowlist is restricted to [[allow]] tables of key = "value")')
    return tables


def load_allowlist(path: Optional[Path] = None) -> Allowlist:
    path = Path(path) if path is not None else DEFAULT_ALLOWLIST
    if not path.exists():
        return Allowlist()
    text = path.read_text()
    try:
        import tomllib                              # Python >= 3.11
        tables = tomllib.loads(text).get("allow", [])
    except ModuleNotFoundError:
        tables = _parse_toml_subset(text)
    entries = []
    for i, t in enumerate(tables):
        missing = {"check", "path", "symbol"} - set(t)
        if missing:
            raise ValueError(f"allowlist entry {i}: missing {sorted(missing)}")
        if t["check"] not in CHECKS:
            raise ValueError(f"allowlist entry {i}: unknown check "
                             f"{t['check']!r} (known: {sorted(CHECKS)})")
        entries.append(AllowEntry(check=t["check"], path=t["path"],
                                  symbol=t["symbol"],
                                  reason=t.get("reason", "")))
    return Allowlist(entries=entries)


def sort_findings(findings: Sequence[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.check))
