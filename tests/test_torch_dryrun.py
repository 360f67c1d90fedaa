"""The one-card dry run (``launch/dryrun.py``) and the kernels' shape rules.

Held against the JAX package: every arch's parameters at full width (count
and bytes equal ``jax.eval_shape`` of the JAX ``build(cfg).init``), and the
cell list with its skip reasons (``cell_is_runnable``). On its own terms:
a data-free step launches no kernel and runs no plain version; each
wrapper's shape rule gives the plain version's shapes and dtypes; the peak
tracker is exact on a written-out sequence of allocations; a smoke dense
step's flops equal a count written out from its widths; ``--mesh single``
raises naming ROADMAP Queue 1 item 9. The card holds the peaks against
``torch.cuda.max_memory_allocated`` (``chip_smoke.py`` phase 24).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import (ARCHS, SHAPES, RunConfig,  # noqa: E402
                                 cell_is_runnable, get_config,
                                 reduce_for_smoke)
from repro_torch.core.dpsgd import _leaves  # noqa: E402
from repro_torch.core.gossip import ring_plan  # noqa: E402
from repro_torch.kernels import (flash_attention as fa,  # noqa: E402
                                 gossip_mix as gm, quantize as qz,
                                 rglru_scan as rg, rwkv6_scan as rw,
                                 trace_scan as ts, counted_wrappers)
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.train import param_bytes  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.layers import rounded_to  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PLAINS = [(m, n) for m in (fa, gm, qz, rg, rw) for n in dir(m)
          if n.endswith("_plain")]


@pytest.fixture
def no_plain(monkeypatch):
    """Every plain version raises, and the wrappers' counters are read
    before and after."""
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"{name} ran on data-free tensors")
        return f
    for mod, name in PLAINS:
        monkeypatch.setattr(mod, name, refuse(name))
    before = [w.launches for w in counted_wrappers()]
    yield
    assert [w.launches for w in counted_wrappers()] == before


def test_full_width_parameters_equal_the_jax_package():
    """Every arch's parameter count and bytes at its published widths,
    from data-free tensors, equal ``jax.eval_shape`` of the reference's
    init (nothing drawn on either side)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_config
    from repro.models import build as jax_build

    for arch in ARCHS:
        shapes = jax.eval_shape(jax_build(jax_config(arch)).init,
                                jax.random.key(0))
        leaves = jax.tree.leaves(shapes)
        want_n = sum(int(np.prod(x.shape)) for x in leaves)
        want_b = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                     for x in leaves)
        with FakeTensorMode():
            got = _leaves(build(get_config(arch), "cpu").init(
                torch.Generator()))
            got_n = sum(x.numel() for x in got)
        assert (got_n, param_bytes(get_config(arch))) == (want_n, want_b), \
            arch


def test_cells_and_skip_reasons_equal_the_jax_package():
    pytest.importorskip("jax")
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import cell_is_runnable as jax_runnable

    assert list(ARCHS) == list(JAX_ARCHS)
    assert list(SHAPES) == list(JAX_SHAPES)
    for arch in ARCHS:
        for shape in SHAPES:
            want = jax_runnable(JAX_ARCHS[arch], JAX_SHAPES[shape])
            assert cell_is_runnable(ARCHS[arch], SHAPES[shape]) == want
            if not want[0]:
                rec = dr.run_cell(arch, shape)
                assert (rec["status"], rec["reason"]) == ("skipped", want[1])


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "recurrentgemma-2b",
                                  "rwkv6-7b", "deepseek-v2-lite-16b",
                                  "seamless-m4t-large-v2"])
def test_data_free_steps_launch_nothing_and_run_no_plain_version(
        no_plain, arch):
    """Mode A and Mode B steps and a serve of every family at the smoke
    widths on data-free tensors (the fake device here is the CPU, as on
    any host without a card): the wrappers' counters do not move, no plain
    version runs, and the dry run's own log has each kernel."""
    cfg = reduce_for_smoke(get_config(arch))
    a = dr.train_cell(cfg, RunConfig(mode="allreduce", remat="none"),
                      batch=2, seq_len=32)
    b = dr.train_cell(cfg, RunConfig(mode="dpsgd", remat="full"), batch=4,
                      seq_len=32, nodes=2, plan=ring_plan(("data",), (2,), 1))
    s = dr.serve_cell(cfg, batch=2, prompt_len=24, max_len=32)
    fwd = {"rwkv6-7b": "rwkv6_scan"}.get(arch, "flash_attention")
    assert a["kernel_launches"][fwd] >= 1
    assert a["kernel_launches"][fwd + "_bwd"] >= 1
    assert b["kernel_launches"]["gossip_mix_rows"] >= 1
    # one launch a layer for every node (vmap folds them); under remat
    # "full" each checkpointed layer's forward once more
    assert a["kernel_launches"][fwd] < b["kernel_launches"][fwd] <= \
        2 * a["kernel_launches"][fwd]
    assert b["kernel_launches"][fwd + "_bwd"] == \
        a["kernel_launches"][fwd + "_bwd"]
    assert s["kernel_launches"][fwd] == a["kernel_launches"][fwd]
    for r in (a, b, s):
        assert r["peak_bytes"] >= r["params_bytes"] and r["graphed"] is False
        assert r["fake_device"] == "cpu"


def _fake(*tensors):
    """Data-free copies of real tensors (same shape, dtype and strides)."""
    return tuple(None if t is None else torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype) for t in tensors)


def _cases():
    g = torch.Generator().manual_seed(0)

    def r(*s, dt=torch.float32):
        return torch.randn(s, generator=g).to(dt)
    bf = torch.bfloat16
    q8 = torch.randint(-127, 128, (3, 4096), generator=g).to(torch.int8)
    sc = torch.rand(3, 2, generator=g) + 0.1
    live = torch.tensor([True, False, True])
    ab = torch.rand(2, 70, 12, generator=g)
    return [
        ("flash", lambda q, k, v: fa._forward(q, k, v, True, 0, True),
         (r(2, 40, 4, 16, dt=bf), r(2, 40, 2, 16, dt=bf),
          r(2, 40, 2, 16, dt=bf))),
        ("flash window", lambda q, k, v: fa.flash_attention(
            q, k, v, causal=True, window=8), (r(1, 33, 2, 8), r(1, 33, 1, 8),
                                              r(1, 33, 1, 8))),
        ("flash bwd", lambda q, k, v, o, lse, do: fa.flash_attention_bwd(
            q, k, v, o, lse, do), (r(2, 20, 4, 16), r(2, 20, 2, 16),
                                  r(2, 20, 2, 16), r(2, 20, 4, 16),
                                  r(2, 4, 20), r(2, 20, 4, 16))),
        ("rows", gm.gossip_mix_rows, (r(3, 3), r(3, 50, dt=bf))),
        ("q8 rows", gm.gossip_mix_q8_rows, (r(3), r(3, 3), r(3, 3000), q8,
                                             sc)),
        ("q8 w", gm.gossip_mix_q8_w, (r(3, 3), r(3, 3000), q8, sc)),
        ("int8 round", gm.gossip_mix_int8_round, (r(3, 3000), r(3, 3000),
                                                  r(3, 3), live)),
        ("quantize 256", lambda x: qz.quantize_int8(x, 256), (r(3, 700),)),
        ("quantize 2048", lambda x: qz.quantize_int8(x, 2048),
         (r(3, 700, dt=bf),)),
        ("dequantize", lambda q, s: qz.dequantize_int8(q, s, 2048, 3000,
                                                       torch.bfloat16),
         (q8, sc)),
        ("send", qz.quantize_int8_ef, (r(3, 3000), r(3, 3000), live)),
        ("rglru", rg.rglru_scan, (ab, r(2, 70, 12), r(2, 12))),
        ("rglru no h0", rg.rglru_scan, (ab, r(2, 70, 12))),
        ("rglru bwd", rg.rglru_scan_bwd, (ab, r(2, 70, 12), r(2, 70, 12),
                                          r(2, 12))),
        ("rwkv6", rw.rwkv6_scan, (r(2, 20, 2, 8), r(2, 20, 2, 8),
                                  r(2, 20, 2, 8), torch.rand(2, 20, 2, 8),
                                  r(2, 8), r(2, 2, 8, 8))),
        ("rwkv6 bwd", rw.rwkv6_scan_bwd,
         (r(2, 20, 2, 8), r(2, 20, 2, 8), r(2, 20, 2, 8),
          torch.rand(2, 20, 2, 8), r(2, 2, 8), r(2, 20, 2, 8), r(2, 2, 8, 8),
          r(2, 2, 8, 8))),
    ]


@pytest.mark.parametrize("name,fn,args", _cases(),
                         ids=[c[0] for c in _cases()])
def test_shape_rules_match_the_plain_versions(name, fn, args):
    """Each wrapper's shape rule (data-free inputs) gives the outputs'
    shapes and dtypes the plain version gives on the CPU, and notes one
    launch of its kernel with its cost."""
    want = fn(*args)
    before = [(w.dry_launches, w.dry_flops) for w in counted_wrappers()]
    with FakeTensorMode():
        got = fn(*_fake(*args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [None if x is None else (tuple(x.shape), x.dtype) for x in got] \
        == [None if x is None else (tuple(x.shape), x.dtype) for x in want]
    noted = [(w.dry_launches - n, w.dry_flops - f)
             for w, (n, f) in zip(counted_wrappers(), before)
             if w.dry_launches > n]
    assert sum(n for n, _ in noted) == (2 if name == "int8 round" else 1)
    assert all(f > 0 for _, f in noted)


def test_round_loop_has_no_shape_rule():
    with FakeTensorMode():
        x = torch.empty(4, dtype=torch.float64)
        with pytest.raises(RuntimeError, match="no shape rule"):
            ts.trace_decide(x, x, torch.empty(4, dtype=torch.int64),
                            bandwidth_hz=1e6)


def test_a_meta_tensor_still_raises():
    """Only fake tensors take the shape rule: another device type raises as
    before."""
    x = torch.empty(3, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device type"):
        gm.gossip_mix_rows(torch.empty(3, 3, device="meta"), x)


def test_peak_tracker_is_exact():
    with FakeTensorMode(), dr.PeakTracker("cpu") as t:
        a = torch.empty(1000)                # 4000 bytes -> 4096
        assert (t.now, t.peak) == (4096, 4096)
        b = torch.empty(10, dtype=torch.int8)    # 10 -> 512
        v = a.view(10, 100)                  # a view: no new storage
        a.add_(1.0)                          # in place: none either
        assert (t.now, t.peak) == (4608, 4608)
        del a
        assert t.now == 4608                 # the view holds the storage
        del v
        assert (t.now, t.peak) == (512, 4608)
        t.reset_peak()
        c = torch.empty(256)                 # 1024
        d = c * 2                            # 1024
        del c, d
        e = torch.zeros(0)                   # nothing
        assert (t.now, t.peak) == (512, 2560)
        del b, e
        assert t.now == 0
        cuda_like = torch.empty(1000, device="meta")   # another device type
        assert t.now == 0
        del cuda_like


def test_smoke_dense_flops_equal_a_count_from_the_widths():
    """stablelm-3b at the smoke widths (1 layer, d 64, 4 heads of 16, SwiGLU
    128, vocab 512, untied head), Mode A without remat over 2 x 32 tokens:
    each weight product 2 T d_in d_out forward and twice that backward; the
    flash forward 4 D and its backward 10 D a (query, key) pair of the
    causal band, for each sequence and head."""
    cfg = reduce_for_smoke(get_config("stablelm-3b"))
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings) == \
        (1, 64, 4, 4, 16, 128, 512, False)
    b, s = 2, 32
    t = b * s
    weights = 4 * 64 * 64 + 3 * 64 * 128 + 64 * 512
    pairs = s * (s + 1) // 2
    want_aten = 3 * 2 * t * weights
    want_kernels = (4 + 10) * 16 * pairs * b * 4
    r = dr.train_cell(cfg, RunConfig(mode="allreduce", remat="none"),
                      batch=b, seq_len=s)
    assert (r["flops_aten"], r["flops_kernels"]) == (want_aten, want_kernels)
    assert r["flops"] == 29_257_728


def test_microbatches_and_fit():
    """The fewest microbatches: at a capacity between two trials' peaks,
    the count whose trial fits and whose next smaller divisor's does not;
    none when even one sequence a microbatch does not fit."""
    cfg = reduce_for_smoke(get_config("qwen2-vl-2b"))
    run = RunConfig(mode="allreduce", remat="none")
    cell = dr.train_cell(cfg, run, batch=8, seq_len=32)
    m, tried = dr.fewest_microbatches(cfg, run, cell, batch=8, seq_len=32,
                                      nodes=1, plan=None,
                                      capacity=cell["peak_bytes"] - 1)
    assert m in (2, 4, 8) and tried[m] < cell["peak_bytes"]
    smaller = [k for k in (1, 2, 4, 8) if k < m]
    assert tried[1] == cell["peak_bytes"] and tried[smaller[-1]] > \
        cell["peak_bytes"] - 1
    none, _ = dr.fewest_microbatches(cfg, run, cell, batch=8, seq_len=32,
                                     nodes=1, plan=None, capacity=1)
    assert none is None


def test_mesh_single_raises_naming_item_5(tmp_path):
    """The pod meshes' raise names the item tensor parallelism moved to
    (Queue 1 item 9; item 5's fleet half is done)."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        dr.main(["--mesh", "single", "--arch", "qwen2-vl-2b", "--shape",
                 "train_4k", "--out", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        dr.run_cell("qwen2-vl-2b", "train_4k", "multi")


def test_cli_writes_a_cell_and_resumes(tmp_path, capsys):
    args = ["--arch", "qwen2.5-14b", "--shape", "long_500k", "--out",
            str(tmp_path)]
    assert dr.main(args) == 0
    path = tmp_path / "card" / "qwen2.5-14b__long_500k.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "skipped" and rec["mesh"] == "card"
    assert dr.main(args) == 0
    assert "[skip-existing]" in capsys.readouterr().out
    assert dr.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(ARCHS) * len(SHAPES)


def test_rounded_to_matches_torch():
    """The embedding scale rounded on the host (no tensor to read back
    under the dry run) equals torch's rounding through a tensor."""
    values = [d ** 0.5 for d in range(1, 4097)] + [1e-3, 3.3e4, 0.1]
    for dt in (torch.bfloat16, torch.float16, torch.float32, torch.float64):
        for v in values:
            assert rounded_to(v, dt) == torch.tensor(v, dtype=dt).item()


def test_dry_run_and_lint_import_no_jax():
    code = textwrap.dedent("""
        import sys
        from repro_torch.analysis import cli
        from repro_torch.configs import RunConfig
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell("qwen2-vl-2b", "long_500k")
        assert rec["status"] == "skipped"
        from repro_torch.configs import get_config, reduce_for_smoke
        r = dryrun.train_cell(reduce_for_smoke(get_config("qwen2-vl-2b")),
                              RunConfig(mode="allreduce"), batch=2,
                              seq_len=16)
        assert r["kernel_launches"]["flash_attention"] >= 1
        assert cli.main(["--ci"]) == 0
        bad = [m for m in ("jax", "jaxlib", "repro") if m in sys.modules]
        assert not bad, bad
        print("OK")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]
