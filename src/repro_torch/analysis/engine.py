"""Engine: file collection, noqa suppression, baseline bookkeeping.

The port's copy of ``repro.analysis.engine``, pointed at the port: the
package ``src/repro_torch/`` and ``chip_smoke.py`` are the sources, the
``tests/test_torch_*.py`` files the tests, and the baseline is the
package's own ``baseline.json`` (the root ``analysis_baseline.json`` is
the JAX package's). The engine is rule-agnostic: module rules
(``rules.MODULE_RULES``) see one parsed file at a time, project rules
(``crossref.PROJECT_RULES``) see the whole src + tests AST forest at once
(the parity-pin cross-reference and the kernel-fallback rule need more
than one file). Everything is stdlib-only by design: the linter runs
before any test dependency (torch included) is installed.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from collections import Counter
from pathlib import Path
from typing import Callable, Iterable, Optional, Sequence

__all__ = [
    "Finding", "ModuleInfo", "AnalysisResult", "analyze_repo",
    "default_root", "default_sources", "default_tests", "load_baseline",
    "write_baseline", "repo_is_clean", "BASELINE_PATH",
]

BASELINE_NAME = "baseline.json"
BASELINE_PATH = Path(__file__).with_name(BASELINE_NAME)

# trailing-comment suppression:  # repro_torch: noqa   or
# # repro_torch: noqa[SYNC001] (comma-separated ids allowed inside the
# brackets; the JAX package's "# repro: noqa" spelling is read too)
_NOQA_RE = re.compile(
    r"#\s*repro(?:_torch)?:\s*noqa(?:\[([A-Za-z0-9_,\s-]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""

    rule: str          # e.g. "DET001"
    path: str          # repo-relative posix path
    line: int          # 1-based
    message: str       # human sentence; line-number free (baseline stability)
    scope: str = ""    # enclosing def/class qualname ("" at module level)

    @property
    def fingerprint(self) -> str:
        """Line-number-independent identity used by the baseline: a finding
        keeps its fingerprint across unrelated edits that only shift lines."""
        return f"{self.rule}::{self.path}::{self.scope}::{self.message}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        scope = f" [{self.scope}]" if self.scope else ""
        return f"{loc}: {self.rule}{scope} {self.message}"


@dataclasses.dataclass
class ModuleInfo:
    """One parsed source file plus what rules need to inspect it."""

    path: Path         # absolute
    rel: str           # repo-relative posix path
    source: str
    lines: list[str]   # physical lines (for noqa + snippets)
    tree: ast.Module

    @property
    def docstring(self) -> str:
        return ast.get_docstring(self.tree) or ""

    def suppressed(self, finding: Finding) -> bool:
        if not (1 <= finding.line <= len(self.lines)):
            return False
        m = _NOQA_RE.search(self.lines[finding.line - 1])
        if not m:
            return False
        ids = m.group(1)
        if ids is None:               # blanket "# repro_torch: noqa"
            return True
        wanted = {s.strip() for s in ids.split(",") if s.strip()}
        return finding.rule in wanted


def default_root() -> Path:
    """Repo root: the directory holding ``src/`` (three levels up from this
    package). Falls back to the cwd when the layout is unexpected."""
    here = Path(__file__).resolve()
    try:
        root = here.parents[3]
    except IndexError:              # pragma: no cover - degenerate install
        return Path.cwd()
    return root if (root / "src" / "repro_torch").is_dir() else Path.cwd()


def default_sources(root: Path) -> list[Path]:
    """The port's sources: the package and, where present, the chip
    smoke at the root."""
    smoke = root / "chip_smoke.py"
    return [root / "src" / "repro_torch"] + ([smoke] if smoke.is_file()
                                              else [])


def default_tests(root: Path) -> list[Path]:
    """The port's test files, ``tests/test_torch_*.py``."""
    return sorted((root / "tests").glob("test_torch_*.py"))


def _iter_py(base: Path) -> Iterable[Path]:
    if base.is_file():
        yield base
        return
    if base.is_dir():
        yield from sorted(base.rglob("*.py"))


def load_modules(root: Path, bases: Sequence[Path]
                 ) -> tuple[list[ModuleInfo], list[Finding]]:
    """Parse every .py under ``bases``; syntax errors become ENG001 findings
    (a file the linter cannot read is itself a violation, not a crash)."""
    modules: list[ModuleInfo] = []
    errors: list[Finding] = []
    for base in bases:
        for path in _iter_py(base):
            rel = path.relative_to(root).as_posix()
            source = path.read_text(encoding="utf-8")
            try:
                tree = ast.parse(source, filename=str(path))
            except SyntaxError as e:
                errors.append(Finding("ENG001", rel, e.lineno or 1,
                                      f"file does not parse: {e.msg}"))
                continue
            modules.append(ModuleInfo(path=path, rel=rel, source=source,
                                      lines=source.splitlines(), tree=tree))
    return modules, errors


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def load_baseline(path: Path) -> dict[str, dict]:
    """fingerprint -> entry ({"fingerprint", "note", optional "count"})."""
    if not path.is_file():
        return {}
    data = json.loads(path.read_text(encoding="utf-8"))
    out: dict[str, dict] = {}
    for entry in data.get("findings", []):
        fp = entry["fingerprint"]
        prev = out.get(fp)
        if prev is None:
            out[fp] = dict(entry)
            out[fp].setdefault("count", 1)
        else:
            prev["count"] = prev.get("count", 1) + entry.get("count", 1)
    return out


def write_baseline(findings: Sequence[Finding], path: Path,
                   notes: Optional[dict[str, str]] = None) -> None:
    """Persist ``findings`` as the new baseline, carrying over any notes
    already recorded for surviving fingerprints."""
    old = load_baseline(path)
    counts = Counter(f.fingerprint for f in findings)
    entries = []
    for fp in sorted(counts):
        note = (notes or {}).get(fp) or old.get(fp, {}).get("note", "")
        entry: dict = {"fingerprint": fp, "note": note}
        if counts[fp] > 1:
            entry["count"] = counts[fp]
        entries.append(entry)
    payload = {
        "version": 1,
        "comment": ("Grandfathered repro_torch.analysis findings. Every "
                    "entry needs a 'note' justifying why it stays; remove "
                    "entries as the debt is paid down. CI fails on findings "
                    "NOT listed here."),
        "findings": entries,
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AnalysisResult:
    root: Path
    findings: list[Finding]            # all unsuppressed findings
    new: list[Finding]                 # not covered by the baseline
    baselined: list[Finding]           # covered (grandfathered)
    stale: list[str]                   # baseline fingerprints with no match

    @property
    def clean(self) -> bool:
        return not self.new

    def to_json(self) -> dict:
        return {
            "clean": self.clean,
            "counts": {"total": len(self.findings), "new": len(self.new),
                       "baselined": len(self.baselined),
                       "stale_baseline_entries": len(self.stale)},
            "new": [dataclasses.asdict(f) for f in self.new],
            "baselined": [dataclasses.asdict(f) for f in self.baselined],
            "stale": list(self.stale),
        }


def analyze_repo(root: Optional[Path] = None,
                 baseline_path: Optional[Path] = None,
                 src: Optional[Sequence[Path]] = None,
                 tests: Optional[Sequence[Path]] = None,
                 module_rules: Optional[Sequence[Callable]] = None,
                 project_rules: Optional[Sequence[Callable]] = None,
                 ) -> AnalysisResult:
    """Run every rule over the tree and split findings against the baseline.

    ``src``/``tests`` default to :func:`default_sources` and
    :func:`default_tests` under ``root``, the baseline to the package's
    ``baseline.json``. Module rules run on src modules only; project rules
    see both sides.
    """
    from .rules import MODULE_RULES          # local import: no cycle at init
    from .crossref import PROJECT_RULES

    root = (root or default_root()).resolve()
    src_bases = list(src) if src is not None else default_sources(root)
    test_bases = list(tests) if tests is not None else default_tests(root)
    module_rules = list(MODULE_RULES if module_rules is None else module_rules)
    project_rules = list(PROJECT_RULES if project_rules is None
                         else project_rules)

    src_modules, findings = load_modules(root, src_bases)
    test_modules, test_errors = load_modules(root, test_bases)
    findings.extend(test_errors)

    by_rel = {m.rel: m for m in src_modules + test_modules}
    for mod in src_modules:
        for rule in module_rules:
            findings.extend(rule(mod))
    for rule in project_rules:
        findings.extend(rule(src_modules, test_modules))

    findings = [f for f in findings
                if f.path not in by_rel or not by_rel[f.path].suppressed(f)]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    bpath = baseline_path or BASELINE_PATH
    baseline = load_baseline(bpath)
    budget = {fp: e.get("count", 1) for fp, e in baseline.items()}
    new: list[Finding] = []
    grandfathered: list[Finding] = []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
            grandfathered.append(f)
        else:
            new.append(f)
    matched = Counter(f.fingerprint for f in grandfathered)
    stale = sorted(fp for fp, e in baseline.items()
                   if matched[fp] < e.get("count", 1))
    return AnalysisResult(root=root, findings=findings, new=new,
                          baselined=grandfathered, stale=stale)


def repo_is_clean(root: Optional[Path] = None) -> bool:
    """True iff the tree has no non-baselined findings: a one-call probe
    for a harness to stamp beside its numbers."""
    try:
        return analyze_repo(root=root).clean
    except Exception:               # a broken linter must not fail a bench
        return False
