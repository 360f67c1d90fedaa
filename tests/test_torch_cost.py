"""The kernels' cost model (``kernels/cost.py``) and the profiler summary
(``utils/profile.py``).

The cost model reproduces the Bound column of ``PERF.md`` §6 at the
table's shapes, to the digits the table prints (the numbers came from the
same functions inside ``chip_smoke.py``, which now imports them and keeps
no copy). The profiler summary's arithmetic (busy time as the union of
the operations' intervals, idle share, gaps, launches read from kernel
names) is held on hand-made traces; on the card ``chip_smoke.py`` phase 24
holds its launches against the wrappers' counters.
"""
import importlib.util
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import cost  # noqa: E402
from repro_torch.utils import profile  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BF16, FP32, FP64 = cost.BF16_FLOPS, cost.FP32_FLOPS, cost.FP64_FLOPS

# (row, cost function, its arguments, peak, the table's bound, its unit,
# the digits printed, what binds)
ROWS = [
    ("1", cost.rows_cost, (6, 6, 21_840, 4), FP32, 0.313, "us", 3, "bytes"),
    ("1 W256", cost.rows_cost, (256, 256, 21_840, 4), FP32, 42.73, "us", 2,
     "operations"),
    ("2", cost.q8_cost, (6, 6, 21_840), FP32, 0.352, "us", 3, "bytes"),
    ("3", cost.quantize_cost, (6, 21_840, 256, 4), FP32, 0.197, "us", 3,
     "bytes"),
    ("3 2048", cost.quantize_cost, (64, 1_048_576, 2048, 4), FP32, 100.20,
     "us", 2, "bytes"),
    ("3 256", cost.quantize_cost, (64, 1_048_576, 256, 4), FP32, 100.48,
     "us", 2, "bytes"),
    ("3'", cost.send_cost, (6, 21_840), FP32, 0.510, "us", 3, "bytes"),
    ("4", cost.dequantize_cost, (6, 21_840, 2048, 4), FP32, 0.196, "us", 3,
     "bytes"),
    ("5 bf16", cost.flash_cost, (4, 4096, 10, 1, 256, 2048, 2), BF16,
     0.2606, "ms", 4, "operations"),
    ("5 fp32", cost.flash_cost, (4, 4096, 10, 1, 256, 2048, 4), FP32,
     3.8469, "ms", 4, "operations"),
    ("5 qwen2-vl", cost.flash_cost, (16, 512, 12, 2, 128, 0, 2), BF16,
     0.0175, "ms", 4, "bytes"),
    ("5' MLA", cost.attn_cost, (4, 4096, 4096, 16, 192, 128, True, 2), BF16,
     0.3475, "ms", 4, "operations"),
    ("5' non-causal", cost.attn_cost, (4, 2048, 2048, 16, 64, 64, False, 2),
     BF16, 0.0695, "ms", 4, "operations"),
    ("5' causal", cost.attn_cost, (4, 2048, 2048, 16, 64, 64, True, 2),
     BF16, 0.0348, "ms", 4, "operations"),
    ("5b bf16", cost.bwd_cost, (24, 512, 512, 32, 32, 80, True, 0, 2), BF16,
     0.1507, "ms", 4, "bytes"),
    ("5b fp32", cost.bwd_cost, (24, 512, 512, 32, 32, 80, True, 0, 4), FP32,
     1.2043, "ms", 4, "operations"),
    ("5b qwen2-vl", cost.bwd_cost, (16, 512, 512, 12, 2, 128, True, 0, 2),
     BF16, 0.0352, "ms", 4, "bytes"),
    ("6", cost.rglru_cost, (4, 4096, 2560), FP32, 0.1503, "ms", 4, "bytes"),
    ("6 decode", cost.rglru_cost, (4, 1, 2560), FP32, 0.049, "us", 3,
     "bytes"),
    ("6b", cost.rglru_bwd_cost, (3, 512, 2560, False), FP32, 0.0235, "ms", 4,
     "bytes"),
    ("6b 4096", cost.rglru_bwd_cost, (4, 4096, 2560, True), FP32, 0.2504,
     "ms", 4, "bytes"),
    ("7", cost.rwkv_cost, (4, 4096, 64, 64), FP32, 0.4032, "ms", 4, "bytes"),
    ("7b", cost.rwkv_bwd_cost, (12, 512, 64, 64, False, True), FP32, 0.2706,
     "ms", 4, "bytes"),
    ("7b 4096", cost.rwkv_bwd_cost, (4, 4096, 64, 64, True, False), FP32,
     0.7250, "ms", 4, "bytes"),
    ("8", cost.trace_cost, (1024, 22, 30, True, 491_007_849), FP64, 0.1300,
     "ms", 4, "operations"),
]


@pytest.mark.parametrize("row,fn,args,peak,want,unit,digits,binds", ROWS,
                         ids=[r[0] for r in ROWS])
def test_cost_model_reproduces_the_bound_column(row, fn, args, peak, want,
                                                unit, digits, binds):
    ms, by = cost.bound(*fn(*args), peak)
    got = ms * 1e3 if unit == "us" else ms
    assert round(got, digits) == pytest.approx(want, abs=1e-12), (row, got)
    assert by == binds


@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal,window", [
    (2, 64, 64, 4, 2, 32, True, 0), (1, 300, 300, 8, 1, 64, True, 128),
    (2, 33, 100, 4, 4, 16, False, 0), (3, 100, 33, 2, 1, 8, True, 0)])
def test_flash_gqa_cost_counts_the_band(b, s, t, hq, hkv, d, causal, window):
    """The general forward's pairs are the band's, counted one by one; at
    causal S == T without lse it is the served row's ``flash_cost``."""
    pairs = sum(1 for i in range(s) for j in range(t)
                if (not causal or j <= i) and (not window or i - j < window))
    assert cost.band_pairs(s, t, causal, window) == pairs
    nbytes, flops = cost.flash_gqa_cost(b, s, t, hq, hkv, d, causal, window,
                                        2, lse=True)
    assert flops == 4.0 * d * pairs * b * hq
    assert nbytes == 2 * (2 * b * s * hq * d + 2 * b * t * hkv * d) \
        + 4 * b * hq * s
    if causal and s == t:
        assert cost.flash_gqa_cost(b, s, t, hq, hkv, d, True, window,
                                   2) == cost.flash_cost(b, s, hq, hkv, d,
                                                         window, 2)


def test_chip_smoke_keeps_no_copy_of_the_cost_model_or_profiler():
    spec = importlib.util.spec_from_file_location("chip_smoke_cost",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    own = {n for n in dir(cs) if not n.startswith("__")}
    moved = set(cost.__all__) | {"device_profile", "device_ms"}
    assert own & moved == set()
    text = (ROOT / "chip_smoke.py").read_text()
    assert "from repro_torch.kernels import cost" in text
    assert "from repro_torch.utils import profile as prof" in text


# ---------------------------------------------------------------------------
# The profiler summary
# ---------------------------------------------------------------------------

def test_summary_busy_idle_top_and_gaps():
    events = [("void flash_attention_bf16_kernel<64, true>(...)", 0.0, 100.0),
              ("ampere_bf16_gemm", 50.0, 170.0),    # overlaps the first
              ("elementwise_kernel", 400.0, 450.0),
              ("void flash_bwd_dq_bf16_kernel<128, 8>(...)", 450.0, 500.0),
              ("flash_bwd_dkdv_bf16_kernel", 500.0, 630.0),
              ("elementwise_kernel", 1000.0, 1010.0)]
    s = profile.summarize(events, wall_ms=2.0, top=2, gaps=2)
    assert s["busy_ms"] == pytest.approx(0.41)
    assert s["idle"] == pytest.approx(1 - 0.41 / 2.0)
    assert s["operations"] == 6
    assert [(n, round(ms, 6), c) for n, ms, c in s["top"]] == [
        ("flash_bwd_dkdv_bf16_kernel", 0.13, 1),
        ("ampere_bf16_gemm", 0.12, 1)]
    assert [round(g[0], 6) for g in s["gaps"]] == [0.37, 0.23]
    assert s["gaps"][0][1:] == ("flash_bwd_dkdv_bf16_kernel",
                                "elementwise_kernel")
    assert s["gaps"][1][1:] == ("ampere_bf16_gemm", "elementwise_kernel")
    assert s["launches"]["flash_attention"] == 1
    assert s["launches"]["flash_attention_bwd"] == 1     # the dq kernel
    assert profile.summarize([], None)["idle"] is None


def test_launches_read_whole_kernel_names():
    names = ["void quantize_int8_kernel<256, float>(float const*)",
             "void dequantize_int8_kernel<2048, float>(signed char const*)",
             "quantize_int8_ef_kernel", "rglru_scan_kernel_chained",
             "rglru_scan_kernel", "rwkv6_bwd_walk_kernel<64>",
             "rwkv6_bwd_chunk_kernel<64>", "rwkv6_bwd_du_kernel",
             "gossip_mix_q8_rows_kernel", "gossip_mix_rows_kernel<2, 2>",
             "Memset (Device)", "trace_scan_kernel<true>"]
    got = profile.kernel_launches(names)
    assert got == {"gossip_mix_rows": 1, "gossip_mix_q8_rows": 1,
                   "quantize_int8": 1, "dequantize_int8": 1,
                   "quantize_int8_ef": 1, "flash_attention": 0,
                   "flash_attention_bwd": 0, "rglru_scan": 2,
                   "rglru_scan_bwd": 0, "rwkv6_scan": 0,
                   "rwkv6_scan_bwd": 1, "round_scan": 1}


def test_every_counted_wrapper_has_its_kernels_named():
    """Each wrapper that counts launches names its kernels, each a kernel
    of the CUDA sources, and the summary's table is theirs."""
    from repro_torch.kernels import counted_wrappers

    source = "".join(p.read_text() for p in
                     (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"))
    for w in counted_wrappers():
        assert w.kernels, w.__name__
        for name in w.kernels:
            assert re.search(rf"\b{name}\b", source), name
    assert profile.KERNELS == {w.__name__: w.kernels
                               for w in counted_wrappers()}
