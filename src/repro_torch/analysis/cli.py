"""CLI for ``python -m repro_torch.analysis``.

Exit codes: 0 = no non-baselined findings; 1 = new findings (or, under
``--ci``, stale baseline entries — debt that was paid down must also be
removed from the baseline so it cannot silently regrow); 2 = usage error.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from .engine import BASELINE_PATH, analyze_repo, default_root, write_baseline
from .rules import RULE_CATALOG

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant linter for the PyTorch port "
                    "(determinism, import hygiene, cached probes, host "
                    "reads in graphed code, kernel dispatch, parity-pin "
                    "coverage).")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline path (default: {BASELINE_PATH.name} "
                         "beside this package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--ci", action="store_true",
                    help="CI gate: terse output; also fail on stale "
                         "baseline entries")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather every current finding into the "
                         "baseline (justify each entry's 'note' by hand)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULE_CATALOG):
            print(f"{rid:9s} {RULE_CATALOG[rid]}")
        return 0

    root = (args.root or default_root()).resolve()
    baseline = args.baseline or BASELINE_PATH
    result = analyze_repo(root=root, baseline_path=baseline)

    if args.write_baseline:
        write_baseline(result.findings, baseline)
        print(f"wrote {len(result.findings)} finding(s) to {baseline}")
        return 0

    if args.as_json:
        print(json.dumps(result.to_json(), indent=2))
    else:
        for f in result.new:
            print(f.render())
        if not args.ci:
            for f in result.baselined:
                print(f"{f.render()}  [baselined]")
        for fp in result.stale:
            print(f"stale baseline entry (no longer matches): {fp}",
                  file=sys.stderr)
        n_new, n_base = len(result.new), len(result.baselined)
        status = "clean" if result.clean else "FAIL"
        print(f"repro_torch.analysis: {status} - {n_new} new finding(s), "
              f"{n_base} baselined, {len(result.stale)} stale baseline "
              "entr(ies)")

    if result.new:
        return 1
    if args.ci and result.stale:
        return 1
    return 0
