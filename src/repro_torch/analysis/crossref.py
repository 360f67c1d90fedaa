"""Project-wide rules: the parity-pin cross-reference and kernel fallbacks.

The JAX package's parity contract, held on the port's copies: "every
batched path is bit-identical to a retained sequential reference, and a
test pins the two together". That is a *cross-file* invariant — a public
``*_batch``/``solve_*`` symbol in ``core/`` or ``sim/`` is only trustworthy
if (a) its module also defines the sibling (``<name>_reference``, or for
``*_batch`` the de-batched original), and (b) at least one test file
(``tests/test_torch_*.py``) references *both* names, so the pin actually
exercises the pair. PAR001 flags a missing sibling, PAR002 a pair no test
ever co-references.

KRN002 is the port's kernel-dispatch rule (ROADMAP, "Kernel dispatch": a
CUDA tensor gets the kernel or an error, never the plain version): no
``try`` whose body reaches a kernel launch — ``_build.launch`` or a call
of a function of ``kernels/`` that launches — may have a handler that
runs a plain version (``*_plain``), returns or passes.
"""
from __future__ import annotations

import ast
from typing import Optional, Sequence

from .engine import Finding, ModuleInfo
from .rules import _Ctx, _call_name, _is_launch, launching_functions

__all__ = ["PROJECT_RULES", "parity_pairs", "rule_parity_pins",
           "rule_krn002_fallback"]

_PARITY_DIRS = ("src/repro_torch/core/", "src/repro_torch/sim/")
_KERNEL_DIR = "src/repro_torch/kernels/"


def _module_all(tree: ast.Module) -> Optional[set[str]]:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__" and \
                        isinstance(node.value, (ast.List, ast.Tuple)):
                    return {e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)}
    return None


def _is_batched_public(name: str, public: Optional[set[str]]) -> bool:
    if name.endswith("_reference") or name.startswith("_"):
        return False
    if public is not None and name not in public:
        return False
    return (name.endswith("_batch") or "_batch_" in name
            or name.startswith("solve_"))


def _sibling_candidates(name: str) -> list[str]:
    cands = [name + "_reference"]
    if "_batch" in name:
        debatched = name.replace("_batch", "", 1).replace("__", "_")
        debatched = debatched.rstrip("_") or name
        cands += [debatched + "_reference", debatched]
    return cands


def _identifiers(tree: ast.Module) -> set[str]:
    """Every Name id and Attribute attr in a module — the loosest notion of
    "this file mentions that symbol", which is exactly right for a test
    that may call ``rate_opt.solve_bruteforce_reference`` or import it."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    return out


def parity_pairs(src_modules: Sequence[ModuleInfo]
                 ) -> list[tuple[ModuleInfo, ast.FunctionDef, Optional[str]]]:
    """(module, batched def, sibling name or None) for every public
    ``*_batch``/``solve_*`` top-level function under core/ and sim/."""
    pairs = []
    for mod in src_modules:
        if not any(mod.rel.startswith(d) for d in _PARITY_DIRS):
            continue
        public = _module_all(mod.tree)
        top_defs = {n.name: n for n in mod.tree.body
                    if isinstance(n, ast.FunctionDef)}
        for name, fn in top_defs.items():
            if not _is_batched_public(name, public):
                continue
            sibling = next((c for c in _sibling_candidates(name)
                            if c in top_defs and c != name), None)
            pairs.append((mod, fn, sibling))
    return pairs


def rule_parity_pins(src_modules: Sequence[ModuleInfo],
                     test_modules: Sequence[ModuleInfo]) -> list[Finding]:
    test_ids = [(t.rel, _identifiers(t.tree)) for t in test_modules]
    out = []
    for mod, fn, sibling in parity_pairs(src_modules):
        if sibling is None:
            out.append(Finding(
                "PAR001", mod.rel, fn.lineno,
                f"public batched symbol `{fn.name}` has no *_reference "
                "sibling - retain the sequential original so tests can pin "
                "bit-identity", scope=fn.name))
            continue
        if not any(fn.name in ids and sibling in ids for _, ids in test_ids):
            out.append(Finding(
                "PAR002", mod.rel, fn.lineno,
                f"pair `{fn.name}` / `{sibling}` is never co-referenced by "
                "any test file - add a parity pin exercising both",
                scope=fn.name))
    return out


def _falls_back(handler: ast.ExceptHandler) -> str:
    """What a handler does that makes its ``try`` a fallback, or ""."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Call) and \
                (_call_name(node) or "").endswith("_plain"):
            return f"runs the plain version `{_call_name(node)}`"
        if isinstance(node, ast.Return):
            return "returns"
        if isinstance(node, ast.Pass):
            return "passes"
    return ""


def rule_krn002_fallback(src_modules: Sequence[ModuleInfo],
                         test_modules: Sequence[ModuleInfo]
                         ) -> list[Finding]:
    """No ``try`` that falls back from a kernel: its body reaches a launch
    (``_build.launch``, or a call of a function of ``kernels/`` that
    launches) and a handler runs a plain version, returns or passes."""
    del test_modules
    launching: set[str] = set()
    for mod in src_modules:
        if mod.rel.startswith(_KERNEL_DIR):
            launching |= launching_functions(mod.tree)
    out = []
    for mod in src_modules:
        ctx = _Ctx(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            reach = next((c for stmt in node.body for c in ast.walk(stmt)
                          if isinstance(c, ast.Call) and (
                              _is_launch(c) or _call_name(c) in launching)),
                         None)
            if reach is None:
                continue
            for handler in node.handlers:
                what = _falls_back(handler)
                if what:
                    out.append(ctx.finding(
                        "KRN002", handler,
                        f"`try` around the kernel call "
                        f"`{_call_name(reach)}` whose handler {what} - a "
                        "CUDA tensor gets the kernel or an error, never a "
                        "fallback"))
    return out


PROJECT_RULES = [rule_parity_pins, rule_krn002_fallback]
