"""Per-module AST rules of the port.

Each rule is a callable ``rule(mod: ModuleInfo) -> list[Finding]``. The
determinism rules (DET001-003) and the cached-probe rule (JIT001) are the
JAX package's (``repro.analysis.rules``), pointed at the port's copied
numpy planes and its torch probes; the JAX and Pallas rules are replaced
by the port's own:

* IMP001: ``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  ``repro`` (ROADMAP, "Import hygiene");
* SYNC001, the twin of JIT002: no host read (``.item()``, ``.tolist()``,
  ``.cpu()``, ``float`` / ``int`` of a tensor, ``np.asarray`` of one,
  ``torch.cuda.synchronize``) inside a function the port graphs — one
  handed to ``graphs.GraphedStep``, one a step builder (``make_*step*``)
  returns — or inside ``sim/batch.py:_train_family``'s round loop;
* KRN001, the twin of PAL001: a ``_build.launch`` stands behind
  ``_backend.use_kernel`` in the same wrapper (the function that launches
  asks it, or every function of its module that calls it does).

KRN002 (no ``try`` that falls back from a kernel) needs every module's
kernels at once and lives in ``crossref``.

Directory scopes: the determinism rules police the deterministic planes
(``sim/``, ``core/``, ``runtime/``, ``launch/``), KRN001 ``kernels/``; the
others run over every source file.
"""
from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

from .engine import Finding, ModuleInfo

__all__ = ["MODULE_RULES", "RULE_CATALOG", "launching_functions"]

_PKG = "src/repro_torch/"
_DETERMINISTIC_DIRS = ("sim", "core", "runtime", "launch")
_KERNEL_DIR = _PKG + "kernels/"

_WALL_CLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}
_RNG_ALLOWED = {"numpy.random.default_rng", "numpy.random.Generator",
                "numpy.random.SeedSequence", "numpy.random.BitGenerator",
                "numpy.random.Philox", "numpy.random.PCG64"}
# the live device state a cached function must not freeze (the port's
# twin of the JAX package's jax.devices / default_backend)
_BACKEND_STATE = {
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.get_device_capability", "torch.cuda.get_device_properties",
    "torch.cuda.get_device_name", "torch.cuda.current_device",
    "torch.cuda.is_initialized", "torch.backends.cuda.is_built",
}
_HOST_READ_METHODS = {"item", "tolist", "cpu"}
_FORBIDDEN_IMPORTS = ("jax", "jaxlib", "repro")
_SHAPE_RE = re.compile(r"shape|ndim|len\(|size|numel|dim\(")


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------

def _collect_aliases(tree: ast.Module) -> dict[str, str]:
    """Local name -> canonical dotted module path (``np`` -> ``numpy``,
    ``partial`` -> ``functools.partial``). Relative imports keep their bare
    module name: they never collide with the libraries the rules match
    on."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    aliases[head] = head
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _canonical(node: ast.AST, aliases: dict[str, str]) -> Optional[str]:
    """Canonical dotted name of a Name/Attribute chain, alias-resolved."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(aliases.get(node.id, node.id))
        return ".".join(reversed(parts))
    return None


def _scopes(tree: ast.Module) -> dict[int, str]:
    """id(node) -> dotted enclosing-scope name. A def/class node's own scope
    includes itself, so findings on a decorator read as that function's."""
    out: dict[int, str] = {}

    def visit(node: ast.AST, stack: list[str]) -> None:
        for child in ast.iter_child_nodes(node):
            s = stack
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                s = stack + [child.name]
            out[id(child)] = ".".join(s)
            visit(child, s)

    visit(tree, [])
    return out


class _Ctx:
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.aliases = _collect_aliases(mod.tree)
        self.scopes = _scopes(mod.tree)

    def canon(self, node: ast.AST) -> Optional[str]:
        return _canonical(node, self.aliases)

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, path=self.mod.rel,
                       line=getattr(node, "lineno", 1), message=message,
                       scope=self.scopes.get(id(node), ""))


def _in_deterministic_scope(mod: ModuleInfo) -> bool:
    return any(mod.rel.startswith(f"{_PKG}{d}/")
               for d in _DETERMINISTIC_DIRS)


def _walk_calls(tree: ast.AST) -> Iterable[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _call_name(call: ast.Call) -> Optional[str]:
    """The called name's last part: ``f`` of ``f(...)`` and of
    ``m.f(...)``."""
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _functions(tree: ast.AST) -> Iterable[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _dedupe(findings: list[Finding]) -> list[Finding]:
    seen: set[tuple] = set()
    out = []
    for f in findings:
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


# ---------------------------------------------------------------------------
# DET001 — wall-clock reads in deterministic planes
# ---------------------------------------------------------------------------

def rule_det001_wall_clock(mod: ModuleInfo) -> list[Finding]:
    """No ``time.time()`` (or any wall/monotonic-clock read) inside the
    deterministic planes: identical runs must produce identical event logs,
    so timing flows through an injectable ``clock`` callable (the pattern
    of ``runtime/fault.py``). Referencing ``time.perf_counter`` as an
    injectable *default* is fine; only direct calls are flagged."""
    if not _in_deterministic_scope(mod):
        return []
    ctx = _Ctx(mod)
    out = []
    for call in _walk_calls(mod.tree):
        name = ctx.canon(call.func)
        if name in _WALL_CLOCK:
            out.append(ctx.finding(
                "DET001", call,
                f"wall-clock read `{name}()` in a deterministic plane - "
                "inject a clock callable instead (see runtime/fault.py)"))
    return out


# ---------------------------------------------------------------------------
# DET002 — process-global RNG
# ---------------------------------------------------------------------------

def rule_det002_global_rng(mod: ModuleInfo) -> list[Finding]:
    """No process-global RNG in the deterministic planes: ``np.random.seed``
    / ``np.random.<draw>`` and stdlib ``random.*`` share hidden state across
    call sites, so two features drawing from them perturb each other's
    streams. Use ``np.random.default_rng(...)`` generators (a seeded
    ``torch.Generator`` is keyed and always fine)."""
    if not _in_deterministic_scope(mod):
        return []
    ctx = _Ctx(mod)
    out = []
    for call in _walk_calls(mod.tree):
        name = ctx.canon(call.func)
        if not name:
            continue
        if name.startswith("numpy.random.") and name not in _RNG_ALLOWED:
            out.append(ctx.finding(
                "DET002", call,
                f"process-global numpy RNG `{name}` - construct a local "
                "np.random.default_rng generator instead"))
        elif name.startswith("random.") and name.count(".") == 1:
            out.append(ctx.finding(
                "DET002", call,
                f"stdlib global RNG `{name}` - use a seeded "
                "np.random.default_rng generator instead"))
    return out


# ---------------------------------------------------------------------------
# DET003 — domain-separated rng seeds
# ---------------------------------------------------------------------------

def rule_det003_rng_domain(mod: ModuleInfo) -> list[Finding]:
    """Every ``np.random.default_rng`` call in the deterministic planes must
    pass a tuple seed with a domain tag — ``(seed, 0xFA17)`` style (the
    ``sim/faults.py`` idiom). A bare ``default_rng(seed)`` makes two features
    seeded from the same scalar share one stream, so adding a draw to one
    silently reshuffles the other; no argument at all means OS entropy."""
    if not _in_deterministic_scope(mod):
        return []
    ctx = _Ctx(mod)
    out = []
    for call in _walk_calls(mod.tree):
        if ctx.canon(call.func) != "numpy.random.default_rng":
            continue
        if not call.args and not call.keywords:
            out.append(ctx.finding(
                "DET003", call,
                "unseeded np.random.default_rng() draws OS entropy - pass a "
                "domain-tagged tuple seed like (seed, 0xFA17)"))
            continue
        arg = call.args[0] if call.args else call.keywords[0].value
        if not (isinstance(arg, ast.Tuple) and len(arg.elts) >= 2):
            out.append(ctx.finding(
                "DET003", call,
                "np.random.default_rng seeded without a domain tag - pass a "
                "tuple seed like (seed, 0xFA17) so streams are "
                "domain-separated"))
    return out


# ---------------------------------------------------------------------------
# JIT001 — functools caches over stateful functions
# ---------------------------------------------------------------------------

def _cache_decorators(fn: ast.FunctionDef, ctx: _Ctx) -> list[ast.AST]:
    out = []
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if ctx.canon(target) in ("functools.cache", "functools.lru_cache"):
            out.append(dec)
    return out


def _module_mutable_globals(tree: ast.Module) -> set[str]:
    """Module-level names bound to mutable containers (registries)."""
    mutable: set[str] = set()
    for node in tree.body:
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        is_mutable = isinstance(value, (ast.Dict, ast.List, ast.Set)) or (
            isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
            and value.func.id in ("dict", "list", "set"))
        if is_mutable:
            for t in targets:
                if isinstance(t, ast.Name):
                    mutable.add(t.id)
    return mutable


def rule_jit001_cached_state(mod: ModuleInfo) -> list[Finding]:
    """``functools.cache``/``lru_cache`` must not memoize functions that
    read the device probe or module-global mutable state: the cache freezes
    the first answer for the life of the process (a cached backend choice
    made before the accelerator was attached once froze the JAX package's
    kernels; ``kernels/_backend.py:use_kernel`` probes per call for this
    reason)."""
    ctx = _Ctx(mod)
    mutable_globals = _module_mutable_globals(mod.tree)
    out = []
    for node in _functions(mod.tree):
        decs = _cache_decorators(node, ctx)
        if not decs:
            continue
        reasons = []
        local_names = {a.arg for a in node.args.args
                       + node.args.posonlyargs + node.args.kwonlyargs}
        for inner in ast.walk(node):
            name = ctx.canon(inner) if isinstance(
                inner, (ast.Attribute, ast.Name)) else None
            if name in _BACKEND_STATE:
                reasons.append(f"reads live device state `{name}`")
            elif isinstance(inner, ast.Global):
                reasons.append("declares `global` names")
            elif (isinstance(inner, ast.Name)
                  and isinstance(inner.ctx, ast.Load)
                  and inner.id in mutable_globals
                  and inner.id not in local_names):
                reasons.append(
                    f"reads module-global mutable `{inner.id}`")
        if reasons:
            uniq = sorted(set(reasons))
            out.append(ctx.finding(
                "JIT001", decs[0],
                f"functools cache on `{node.name}` which {'; '.join(uniq)} - "
                "the cache freezes the first answer for the process "
                "lifetime; resolve per call instead"))
    return out


# ---------------------------------------------------------------------------
# IMP001 — the port imports neither jax nor the JAX package
# ---------------------------------------------------------------------------

def rule_imp001_foreign_import(mod: ModuleInfo) -> list[Finding]:
    """The port (``src/repro_torch/``) and ``chip_smoke.py`` run where no
    jax is installed: any import of ``jax`` or of the JAX package
    ``repro`` (even a module of it that imports no jax) breaks that, so
    the port keeps its own copy of what it needs. Relative imports and
    ``repro_torch`` are the port's own."""
    ctx = _Ctx(mod)
    out = []
    for node in ast.walk(mod.tree):
        names: list[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names = [node.module]
        for name in names:
            if name.split(".")[0] in _FORBIDDEN_IMPORTS:
                out.append(ctx.finding(
                    "IMP001", node,
                    f"imports `{name}` - the port imports neither jax nor "
                    "the JAX package; copy what it needs into repro_torch"))
    return out


# ---------------------------------------------------------------------------
# SYNC001 — host reads inside graphed code
# ---------------------------------------------------------------------------

def _returned_defs(fn: ast.FunctionDef) -> list[ast.FunctionDef]:
    """The nested defs a builder returns: ``return step`` or ``return
    Wrapper(step)`` for a ``def step`` inside it."""
    inner = {n.name: n for n in ast.walk(fn)
             if isinstance(n, ast.FunctionDef) and n is not fn}
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        value = node.value
        if isinstance(value, ast.Call) and value.args:
            value = value.args[0]
        if isinstance(value, ast.Name) and value.id in inner:
            out.append(inner[value.id])
    return out


def _graphed_functions(mod: ModuleInfo, ctx: _Ctx) -> dict[int, str]:
    """id(def or lambda) -> why it is graphed: handed to ``GraphedStep``
    (by name, as a lambda, or as the call of a builder of this module), or
    returned by a step builder (``make_*step*``)."""
    by_name: dict[str, ast.FunctionDef] = {}
    for node in _functions(mod.tree):
        by_name.setdefault(node.name, node)
    graphed: dict[int, str] = {}

    def mark(fn: ast.AST, why: str) -> None:
        if id(fn) in graphed:
            return
        graphed[id(fn)] = why
        for inner in ast.walk(fn):
            if inner is not fn and isinstance(inner, (ast.FunctionDef,
                                                      ast.Lambda)):
                graphed.setdefault(id(inner), why)

    for fn in _functions(mod.tree):
        if fn.name.startswith("make_") and "step" in fn.name:
            for inner in _returned_defs(fn):
                mark(inner, f"returned by the step builder `{fn.name}`")
    for call in _walk_calls(mod.tree):
        name = ctx.canon(call.func) or ""
        if name.rsplit(".", 1)[-1] != "GraphedStep" or not call.args:
            continue
        arg = call.args[0]
        if isinstance(arg, ast.Lambda):
            mark(arg, "handed to GraphedStep")
        elif isinstance(arg, ast.Name) and arg.id in by_name:
            mark(by_name[arg.id], "handed to GraphedStep")
        elif isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name) \
                and arg.func.id in by_name:
            for inner in _returned_defs(by_name[arg.func.id]):
                mark(inner, f"built by `{arg.func.id}` for GraphedStep")
    return graphed


def _round_loops(mod: ModuleInfo) -> list[tuple[ast.AST, str]]:
    """The loops of ``sim/batch.py:_train_family`` (its round loop)."""
    if not mod.rel.endswith(_PKG + "sim/batch.py"):
        return []
    return [(loop, "the round loop of `_train_family`")
            for fn in _functions(mod.tree) if fn.name == "_train_family"
            for loop in ast.walk(fn) if isinstance(loop, (ast.For,
                                                           ast.While))]


def _host_reads(mod: ModuleInfo, ctx: _Ctx, body: list,
                why: str) -> list[Finding]:
    out = []
    for stmt in body:
        for call in _walk_calls(stmt):
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _HOST_READ_METHODS \
                    and not call.args:
                out.append(ctx.finding(
                    "SYNC001", call,
                    f"`.{call.func.attr}()` host read inside graphed code "
                    f"({why})"))
                continue
            name = ctx.canon(call.func)
            if name in ("numpy.asarray", "numpy.array"):
                out.append(ctx.finding(
                    "SYNC001", call,
                    f"`{name}` reads a tensor back to the host inside "
                    f"graphed code ({why})"))
            elif name == "torch.cuda.synchronize":
                out.append(ctx.finding(
                    "SYNC001", call,
                    f"`torch.cuda.synchronize()` inside graphed code "
                    f"({why})"))
            elif (isinstance(call.func, ast.Name)
                  and call.func.id in ("float", "int")
                  and len(call.args) == 1
                  and not isinstance(call.args[0], ast.Constant)):
                seg = ast.get_source_segment(mod.source, call) or ""
                if not _SHAPE_RE.search(seg):
                    out.append(ctx.finding(
                        "SYNC001", call,
                        f"`{call.func.id}(...)` of a tensor reads it back "
                        f"to the host inside graphed code ({why})"))
    return out


def rule_sync001_host_read(mod: ModuleInfo) -> list[Finding]:
    """No host read inside code the port graphs: a CUDA graph captures
    device work only, so a ``.item()`` / ``.tolist()`` / ``.cpu()`` /
    ``float()`` / ``int()`` of a tensor, ``np.asarray`` of one or a
    ``torch.cuda.synchronize()`` in a graphed function fails the capture
    (or, eager, stalls every step on the host), and in the family round
    loop stalls every round. Shape arithmetic (``int(x.shape[0])``) is
    static and exempt."""
    ctx = _Ctx(mod)
    graphed = _graphed_functions(mod, ctx)
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.Lambda)) \
                and id(node) in graphed:
            body = node.body if isinstance(node.body, list) else [node.body]
            out += _host_reads(mod, ctx, body, graphed[id(node)])
    for loop, why in _round_loops(mod):
        out += _host_reads(mod, ctx, loop.body, why)
    return _dedupe(out)


# ---------------------------------------------------------------------------
# KRN001 — every launch behind the per-call dispatch
# ---------------------------------------------------------------------------

def _is_launch(call: ast.Call) -> bool:
    f = call.func
    return isinstance(f, ast.Attribute) and f.attr == "launch" and \
        isinstance(f.value, ast.Name) and f.value.id == "_build"


def launching_functions(tree: ast.Module) -> set[str]:
    """Names of the module's functions that launch a kernel: those calling
    ``_build.launch``, and those calling one of them, to a fixed point."""
    calls = {fn.name: {_call_name(c) for c in _walk_calls(fn)}
             for fn in _functions(tree)}
    launching = {fn.name for fn in _functions(tree)
                 if any(_is_launch(c) for c in _walk_calls(fn))}
    grew = True
    while grew:
        grew = False
        for name, called in calls.items():
            if name not in launching and called & launching:
                launching.add(name)
                grew = True
    return launching


def rule_krn001_launch_dispatch(mod: ModuleInfo) -> list[Finding]:
    """A ``_build.launch`` must stand behind ``_backend.use_kernel`` in the
    same wrapper: the function holding the launch asks ``use_kernel`` per
    call, or every function of its module that calls it does (to a
    wrapper). A launch no probe guards would hand a CPU tensor's pointer
    to the card, or reach a card below sm_90."""
    if not mod.rel.startswith(_KERNEL_DIR):
        return []
    ctx = _Ctx(mod)
    fns = {fn.name: fn for fn in _functions(mod.tree)}
    probes = {name for name, fn in fns.items()
              if any(_call_name(c) == "use_kernel" for c in _walk_calls(fn))}
    callers: dict[str, set[str]] = {name: set() for name in fns}
    for name, fn in fns.items():
        for c in _walk_calls(fn):
            callee = _call_name(c)
            if callee in callers and callee != name:
                callers[callee].add(name)

    def guarded(name: str, seen: frozenset) -> bool:
        if name in probes:
            return True
        up = callers.get(name, set()) - seen
        return bool(up) and all(guarded(c, seen | {name}) for c in up)

    out = []
    for name, fn in fns.items():
        for call in _walk_calls(fn):
            if _is_launch(call) and not guarded(name, frozenset()):
                out.append(ctx.finding(
                    "KRN001", call,
                    f"`_build.launch` in `{name}` with no "
                    "`_backend.use_kernel` before it in the wrapper - ask "
                    "the per-call dispatch first"))
    return _dedupe(out)


MODULE_RULES = [
    rule_det001_wall_clock,
    rule_det002_global_rng,
    rule_det003_rng_domain,
    rule_jit001_cached_state,
    rule_imp001_foreign_import,
    rule_sync001_host_read,
    rule_krn001_launch_dispatch,
]

RULE_CATALOG = {
    "DET001": "wall-clock read in a deterministic plane (inject a clock)",
    "DET002": "process-global RNG (np.random.* / stdlib random) in a "
              "deterministic plane",
    "DET003": "np.random.default_rng without a domain-tagged tuple seed",
    "JIT001": "functools.cache/lru_cache over the device probe or "
              "mutable module-global state",
    "IMP001": "jax or JAX-package (repro) import in the port or "
              "chip_smoke.py",
    "SYNC001": "host read (.item()/.tolist()/.cpu()/float()/int()/"
               "np.asarray/cuda.synchronize) inside graphed code or the "
               "family round loop",
    "KRN001": "_build.launch not behind _backend.use_kernel in its wrapper",
    "KRN002": "try around a kernel launch whose handler runs the plain "
              "version, returns or passes (a fallback)",
    "PAR001": "public *_batch/solve_* symbol with no *_reference sibling",
    "PAR002": "batched/reference pair never pinned together by any test",
    "ENG001": "file does not parse",
}
