"""The port's linter (``repro_torch.analysis``) and the parity pins it asks
for.

Each rule fires on a fixture tree and stays silent on its clean twin;
``# repro_torch: noqa`` and the baseline suppress as the JAX package's
linter does; ``--ci`` passes on this tree. The port's copied numpy
solvers are pinned bit-equal to their sequential references here, as
PAR002 requires of every batched / reference pair (the JAX package pins
its own in ``tests/test_vectorized.py`` and beside them).
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.analysis import analyze_repo, cli  # noqa: E402
from repro_torch.core import (access_opt, channel, rate_opt,  # noqa: E402
                              topology)
from repro_torch.core.sched_opt import (  # noqa: E402
    solve_schedule, solve_schedule_reference)

ROOT = Path(__file__).resolve().parents[1]
M_BITS = 698_880.0


def _lint(tmp_path, files: dict, tests: dict | None = None,
          baseline: dict | None = None):
    """The findings of a fixture tree: ``files`` {path under the root:
    source}, ``tests`` {name: source} under tests/."""
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    test_paths = []
    for name, text in (tests or {}).items():
        p = tmp_path / "tests" / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
        test_paths.append(p)
    bpath = tmp_path / "baseline.json"
    if baseline is not None:
        bpath.write_text(json.dumps(baseline))
    srcs = [tmp_path / "src" / "repro_torch"]
    if (tmp_path / "chip_smoke.py").exists():
        srcs.append(tmp_path / "chip_smoke.py")
    return analyze_repo(root=tmp_path, baseline_path=bpath, src=srcs,
                        tests=test_paths)


def _rules(result) -> list[str]:
    return sorted(f.rule for f in result.new)


# (rule, fixture files, clean twin files)
CASES = {
    "DET001": (
        {"src/repro_torch/sim/a.py": """
            import time
            def f():
                return time.perf_counter()
            """},
        {"src/repro_torch/sim/a.py": """
            import time
            def f(clock=None):
                clock = clock or time.perf_counter
                return clock()
            """}),
    "DET002": (
        {"src/repro_torch/core/a.py": """
            import numpy as np
            def f():
                return np.random.rand(3)
            """},
        {"src/repro_torch/core/a.py": """
            import numpy as np
            def f(seed):
                return np.random.default_rng((seed, 0xA)).random(3)
            """}),
    "DET003": (
        {"src/repro_torch/runtime/a.py": """
            import numpy as np
            def f(seed):
                return np.random.default_rng(seed)
            """},
        {"src/repro_torch/runtime/a.py": """
            import numpy as np
            def f(seed):
                return np.random.default_rng((seed, 0xFA17))
            """}),
    "JIT001": (
        {"src/repro_torch/kernels/a.py": """
            import functools
            import torch
            @functools.lru_cache(None)
            def on_card():
                return torch.cuda.get_device_capability(0) >= (9, 0)
            """},
        {"src/repro_torch/kernels/a.py": """
            import torch
            def on_card():
                return torch.cuda.get_device_capability(0) >= (9, 0)
            """}),
    "IMP001": (
        {"src/repro_torch/models/a.py": """
            import jax.numpy as jnp
            from repro.core import gossip
            """,
         "chip_smoke.py": """
            import repro
            """},
        {"src/repro_torch/models/a.py": """
            import torch
            from repro_torch.core import gossip
            from . import layers
            """,
         "chip_smoke.py": """
            import repro_torch
            """}),
    "SYNC001": (
        {"src/repro_torch/train/a.py": """
            import numpy as np
            import torch
            from ..graphs import GraphedStep
            def make_thing_step(fn):
                def step(x):
                    y = fn(x)
                    print(float(y.sum()), y.tolist())
                    return y
                return step
            def body(x):
                return np.asarray(x) + x.item()
            graphed = GraphedStep(body)
            def sync(x):
                torch.cuda.synchronize()
                return x
            g2 = GraphedStep(sync)
            """,
         "src/repro_torch/sim/batch.py": """
            def _train_family(step, w):
                out = []
                for r in range(w.shape[1]):
                    out.append(step(w).cpu())
                return out
            """},
        {"src/repro_torch/train/a.py": """
            import torch
            from ..graphs import GraphedStep
            def make_thing_step(fn):
                def step(x):
                    n = int(x.shape[0])
                    return fn(x) * n
                return step
            def body(x):
                return x + 1
            graphed = GraphedStep(body)
            def outside(x):
                return float(x.sum())
            """,
         "src/repro_torch/sim/batch.py": """
            def _train_family(step, w):
                out = []
                for r in range(w.shape[1]):
                    out.append(step(w))
                return [float(o.sum()) for o in out]
            """}),
    "KRN001": (
        {"src/repro_torch/kernels/k.py": """
            from . import _build
            from ._backend import use_kernel
            def _go(x):
                _build.launch("k", "k_f32", (), x.device, x.data_ptr())
            def wrapper(x):
                if not use_kernel(x.device):
                    return x
                _go(x)
            def unguarded(x):
                _go(x)
            """},
        {"src/repro_torch/kernels/k.py": """
            from . import _build
            from ._backend import use_kernel
            def _go(x):
                _build.launch("k", "k_f32", (), x.device, x.data_ptr())
            def wrapper(x):
                if not use_kernel(x.device):
                    return x
                _go(x)
            def other(x):
                return wrapper(x)
            """}),
    "KRN002": (
        {"src/repro_torch/kernels/k.py": """
            from . import _build
            from ._backend import use_kernel
            def k_plain(x):
                return x
            def k(x):
                if not use_kernel(x.device):
                    return k_plain(x)
                _build.launch("k", "k_f32", (), x.device, x.data_ptr())
                return x
            """,
         "src/repro_torch/models/m.py": """
            from ..kernels.k import k, k_plain
            def a(x):
                try:
                    return k(x)
                except RuntimeError:
                    return k_plain(x)
            def b(x):
                try:
                    k(x)
                except RuntimeError:
                    pass
            """},
        {"src/repro_torch/kernels/k.py": """
            from . import _build
            from ._backend import use_kernel
            def k_plain(x):
                return x
            def k(x):
                if not use_kernel(x.device):
                    return k_plain(x)
                _build.launch("k", "k_f32", (), x.device, x.data_ptr())
                return x
            """,
         "src/repro_torch/models/m.py": """
            from ..kernels.k import k
            def a(x):
                try:
                    return k(x)
                except RuntimeError as e:
                    raise RuntimeError("the kernel failed") from e
            def b(path):
                try:
                    return open(path).read()
                except OSError:
                    return None
            """}),
    "PAR001": (
        {"src/repro_torch/core/s.py": """
            __all__ = ["solve_fast"]
            def solve_fast(x):
                return x
            """},
        {"src/repro_torch/core/s.py": """
            __all__ = ["solve_fast", "solve_fast_reference"]
            def solve_fast(x):
                return x
            def solve_fast_reference(x):
                return x
            """}),
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fires_on_its_fixture_and_not_on_the_clean_twin(tmp_path, rule):
    bad, good = CASES[rule]
    pin = {"test_torch_pin.py": """
        from repro_torch.core import s
        assert s.solve_fast(1) == s.solve_fast_reference(1)
        """}
    found = _rules(_lint(tmp_path / "bad", bad, pin))
    assert rule in found, found
    clean = _rules(_lint(tmp_path / "good", good, pin))
    assert clean == [], clean


def test_sync001_and_krn002_name_each_site(tmp_path):
    bad = _lint(tmp_path, CASES["SYNC001"][0])
    sites = {(f.scope, f.message.split("`")[1]) for f in bad.new}
    assert sites == {("_train_family", ".cpu()"), ("body", "numpy.asarray"),
                     ("body", ".item()"),
                     ("make_thing_step.step", "float(...)"),
                     ("make_thing_step.step", ".tolist()"),
                     ("sync", "torch.cuda.synchronize()")}
    bad = _lint(tmp_path / "k", CASES["KRN002"][0])
    assert sorted((f.scope, f.rule) for f in bad.new) == [
        ("a", "KRN002"), ("b", "KRN002")]


def test_par002_needs_a_test_naming_both(tmp_path):
    files = CASES["PAR001"][1]
    alone = _lint(tmp_path / "a", files, {"test_torch_x.py": """
        from repro_torch.core import s
        assert s.solve_fast(1) == 1
        """})
    assert _rules(alone) == ["PAR002"]
    pinned = _lint(tmp_path / "b", files, {"test_torch_x.py": """
        from repro_torch.core import s
        assert s.solve_fast(1) == s.solve_fast_reference(1)
        """})
    assert _rules(pinned) == []


def test_noqa_and_baseline_suppress(tmp_path):
    bad = {"src/repro_torch/sim/a.py": """
        import time
        def f():
            return time.time()  # repro_torch: noqa[DET001]
        def g():
            return time.time()  # repro_torch: noqa
        def h():
            return time.time()  # repro_torch: noqa[DET002]
        def k():
            return time.monotonic()
        """}
    res = _lint(tmp_path / "a", bad)
    assert sorted(f.scope for f in res.new) == ["h", "k"]
    fp = next(f.fingerprint for f in res.new if f.scope == "k")
    res = _lint(tmp_path / "b", bad, baseline={"findings": [
        {"fingerprint": fp, "note": "a fixture's grandfathered read"}]})
    assert [f.scope for f in res.new] == ["h"]
    assert [f.scope for f in res.baselined] == ["k"] and not res.stale
    res = _lint(tmp_path / "c", {"src/repro_torch/sim/a.py": "x = 1\n"},
                baseline={"findings": [{"fingerprint": fp, "note": "gone"}]})
    assert res.clean and res.stale == [fp]


def test_ci_passes_on_the_tree_and_every_baselined_finding_has_a_reason(
        capsys):
    assert cli.main(["--ci"]) == 0
    assert "repro_torch.analysis: clean" in capsys.readouterr().out
    baseline = json.loads((ROOT / "src" / "repro_torch" / "analysis" /
                           "baseline.json").read_text())
    for entry in baseline["findings"]:
        assert entry["note"].strip(), entry["fingerprint"]


def test_ci_fails_on_a_new_finding(tmp_path):
    pkg = tmp_path / "src" / "repro_torch" / "sim"
    pkg.mkdir(parents=True)
    (pkg / "a.py").write_text("import jax\n")
    assert cli.main(["--ci", "--root", str(tmp_path), "--baseline",
                     str(tmp_path / "none.json")]) == 1


def test_lint_run_imports_neither_jax_nor_torch():
    """The linter is stdlib only: a lint run of the tree loads no jax
    and no torch."""
    code = textwrap.dedent("""
        import sys
        from repro_torch.analysis import cli
        assert cli.main(["--ci"]) == 0
        bad = [m for m in ("jax", "torch", "repro") if m in sys.modules]
        assert not bad, bad
        print("OK")
    """)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr


# ---------------------------------------------------------------------------
# Parity pins of the port's copied solvers (PAR002)
# ---------------------------------------------------------------------------

def _cap(n, seed, eps=4.0, margin=0.0):
    pos = channel.random_placement(n, 200.0, seed=seed)
    return channel.capacity_matrix(
        pos, channel.ChannelParams(path_loss_exp=eps,
                                   fading_margin_bps=margin))


@pytest.mark.parametrize("fast_fn,ref_fn", [
    (rate_opt.solve_bruteforce, rate_opt.solve_bruteforce_reference),
    (rate_opt.solve_common_rate, rate_opt.solve_common_rate_reference),
    (rate_opt.solve_k_nearest, rate_opt.solve_k_nearest_reference),
    (rate_opt.solve_greedy, rate_opt.solve_greedy_reference),
], ids=["bruteforce", "common_rate", "k_nearest", "greedy"])
@pytest.mark.parametrize("seed,n,eps,margin", [
    (0, 5, 4.0, 0.0), (3, 5, 5.0, 2e6)])
def test_rate_solvers_equal_their_references(fast_fn, ref_fn, seed, n, eps,
                                             margin):
    cap = _cap(n, seed, eps, margin)
    for lam_t in (0.25, 0.9, -1.0):
        fast, ref = fast_fn(cap, M_BITS, lam_t), ref_fn(cap, M_BITS, lam_t)
        np.testing.assert_array_equal(fast.rates_bps, ref.rates_bps)
        assert (fast.t_com_s, fast.lam, fast.feasible) == \
            (ref.t_com_s, ref.lam, ref.feasible)
        np.testing.assert_array_equal(fast.w, ref.w)


@pytest.mark.parametrize("seed", range(2))
def test_joint_and_access_solvers_equal_their_references(seed):
    cap = _cap(4 + seed, seed, 3.5 + 0.5 * seed)
    a = rate_opt.solve_joint(cap, M_BITS, 0.5)
    b = rate_opt.solve_joint_reference(cap, M_BITS, 0.5)
    assert (a.mode, a.wire_bits, a.t_com_s, a.lam, a.feasible) == \
        (b.mode, b.wire_bits, b.t_com_s, b.lam, b.feasible)
    np.testing.assert_array_equal(a.rates_bps, b.rates_bps)
    a = access_opt.solve_access(cap, M_BITS, 0.5)
    b = access_opt.solve_access_reference(cap, M_BITS, 0.5)
    np.testing.assert_array_equal(a.p, b.p)
    np.testing.assert_array_equal(a.rates_bps, b.rates_bps)
    assert (a.t_round_s, a.lam, a.feasible) == (b.t_round_s, b.lam,
                                                b.feasible)
    a = access_opt.solve_access_joint(cap, M_BITS, 0.5)
    b = access_opt.solve_access_joint_reference(cap, M_BITS, 0.5)
    assert (a.mode, a.wire_bits, a.t_round_s, a.lam) == \
        (b.mode, b.wire_bits, b.t_round_s, b.lam)
    np.testing.assert_array_equal(a.p, b.p)


@pytest.mark.parametrize("duty,fracs", [(0.5, None), (1.0, (0.2, 0.6, 1.0))])
def test_schedule_solver_equals_its_reference(duty, fracs):
    cap = _cap(5, 2, 4.0)
    fr = None if fracs is None else np.asarray(fracs)
    a = solve_schedule(cap, 1e6, fractions=fr, duty_cycle=duty)
    b = solve_schedule_reference(cap, 1e6, fractions=fr, duty_cycle=duty)
    np.testing.assert_array_equal(a.rates_bps, b.rates_bps)
    assert (a.tx_fraction, a.lam, a.slots, a.t_round_s, a.score_s,
            a.feasible) == (b.tx_fraction, b.lam, b.slots, b.t_round_s,
                            b.score_s, b.feasible)
    np.testing.assert_array_equal(a.w, b.w)


def _geo_w(n, seed, radius):
    pos = channel.random_placement(n, 200.0, seed=seed)
    a = (channel.pairwise_distances(pos) <= radius).astype(np.float64)
    np.fill_diagonal(a, 1.0)
    return topology.paper_w(a)


def test_topology_batches_equal_their_references():
    ws = np.stack([_geo_w(24, s, 45.0) for s in range(6)])
    assert (topology.connected_batch(ws)
            == topology.connected_batch_reference(ws)).all()
    ws = np.stack([_geo_w(32, s, 70.0) for s in range(4)])
    batch = topology.spectral_lambda_iter_batch(ws)
    assert (batch == np.array([topology.spectral_lambda_iter(w)
                               for w in ws])).all()
