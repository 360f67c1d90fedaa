"""AST-based invariant linter for the PyTorch port.

The port's own copy of the JAX package's linter (``repro.analysis``, which
scans ``src/repro/`` only), pointed at ``src/repro_torch/``,
``chip_smoke.py`` and ``tests/test_torch_*.py``. It keeps the JAX
package's determinism rules on the copied numpy planes, its cached-probe
rule and its parity-pin cross-reference, and replaces the JAX and Pallas
rules by the port's: no ``jax`` or ``repro`` import (IMP001), no host read
in graphed code (SYNC001), every kernel launch behind the per-call
dispatch (KRN001) and no ``try`` that falls back from a kernel to its
plain version (KRN002). Stdlib ``ast`` only: it runs before torch is
installed.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis          # human output
    PYTHONPATH=src python -m repro_torch.analysis --json   # machine output
    PYTHONPATH=src python -m repro_torch.analysis --ci     # gate: exit 1 on
                                                           # any finding not
                                                           # in the baseline
    PYTHONPATH=src python -m repro_torch.analysis --list-rules

Suppression: append ``# repro_torch: noqa[RULE-ID]`` (or a blanket
``# repro_torch: noqa``) to the offending line. Grandfathered findings
live in ``baseline.json`` beside this package, each with a one-line
reason (regenerate with ``--write-baseline``, then write the reasons); the
gate fails on findings *not* in the baseline and, under ``--ci``, on
stale entries.
"""
from __future__ import annotations

from .engine import (AnalysisResult, Finding, analyze_repo, default_root,
                     load_baseline, repo_is_clean, write_baseline)
from .rules import MODULE_RULES
from .crossref import PROJECT_RULES

__all__ = [
    "AnalysisResult",
    "Finding",
    "MODULE_RULES",
    "PROJECT_RULES",
    "analyze_repo",
    "default_root",
    "load_baseline",
    "repo_is_clean",
    "write_baseline",
]
