"""The CUDA kernels (gossip mix, flash attention in fp32 and on the
tensor cores in bf16, RG-LRU and RWKV-6 scans and their backward kernels,
int8 quantize / dequantize, the scan trace engine's round loop)
against their plain torch versions, the int8 round's send and receive
(also against the sequence of launches the round made before), and the
D-PSGD steps as CUDA graphs against their eager bodies, on an sm_90 card
(every test here skips without one).

Imports neither ``jax`` nor ``repro``, so it runs on a machine with only
PyTorch:  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_card.py

Tolerances follow tests/test_kernels.py: gossip fp32 1e-5, bf16 3e-2;
flash fp32 2e-5, bf16 3e-2; rglru 1e-4; rwkv6 5e-4. bf16 flash is also
held row by row, ||got - want|| <= 2^-6 ||want|| for each output row (one
query, one head), as chip_smoke.py holds it (the MLA and encoder-decoder
shapes against the plain version on the card, the others on the host): rows that attend to many keys
are far smaller than 3e-2, and losing one key of 2048 moves a row by ~0.022
of its norm. The int8 codec is
bit-equal: q, scales and the dequantized output ``torch.equal`` (finite
inputs). The round loop's delivered packets, retransmissions, mixing
matrices and counts are equal to the plain version's on the card and on
the CPU, its times within 1e-12 relative.
"""
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch

from repro_torch.core import compression as comp
from repro_torch.core.compression import quantize_int8_rows
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gossip_mix as gm, ops
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.kernels import trace_scan as ts

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def sm90():
    """A CUDA device of capability >= (9, 0), decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card (run python3 chip_smoke.py "
                    "or this file on the card)")
    dev = torch.device("cuda")
    if torch.cuda.get_device_capability(dev) < (9, 0):
        pytest.skip("needs compute capability >= (9, 0)")
    return dev


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _row_err(a, b):
    """max over rows of the last axis of ||a_r - b_r|| / ||b_r||."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30))
                 .max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 7, 21_840), (1, 9, 3 * 8192 + 5),
                                   (6, 6, 21_840), (6, 12, 21_840),
                                   (3, 5, 8195)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gossip_mix_rows_kernel_matches_plain(sm90, m, k, n, dtype):
    tdt = DTYPES[dtype]
    g = torch.Generator().manual_seed(m * k)
    bufs = torch.randn((k, n), generator=g).to(tdt)
    w = torch.softmax(torch.randn((m, k), generator=g), -1)
    before = gm.gossip_mix_rows.launches
    got = gm.gossip_mix_rows(w.to(sm90), bufs.to(sm90))
    torch.cuda.synchronize()
    assert gm.gossip_mix_rows.launches == before + 1
    assert got.dtype == tdt and got.device.type == "cuda"
    assert _err(got.cpu(), gm.gossip_mix_rows_plain(w, bufs)) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 6, 8, 9])
@pytest.mark.parametrize("k", [1, 6, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gossip_mix_rows_one_pass_and_grid_y_forms(sm90, m, k, dtype):
    """M <= 8 takes the one-pass kernel (every input byte read once), M = 9
    the grid-y form; both at ragged and aligned N, 1 to 21 843 lanes."""
    tdt = DTYPES[dtype]
    for n in (1, 3, 21_840, 21_843):
        g = torch.Generator().manual_seed(100 * m + 10 * k + n)
        bufs = torch.randn((k, n), generator=g).to(tdt)
        w = torch.softmax(torch.randn((m, k), generator=g), -1)
        got = gm.gossip_mix_rows(w.to(sm90), bufs.to(sm90))
        torch.cuda.synchronize()
        assert got.shape == (m, n) and got.dtype == tdt
        assert _err(got.cpu(), gm.gossip_mix_rows_plain(w, bufs)) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 5, 21_840), (6, 6, 21_840),
                                   (2, 3, 3 * 8192 + 5)])
def test_gossip_mix_q8_rows_kernel_matches_plain(sm90, m, k, n):
    g = torch.Generator().manual_seed(m * k)
    q, s = quantize_int8_rows(torch.randn((k, n), generator=g) * 4)
    x = torch.randn((m, n), generator=g)
    w = torch.softmax(torch.randn((m, k + 1), generator=g), -1)
    w_self, w_off = w[:, 0].contiguous(), w[:, 1:].contiguous()
    before = gm.gossip_mix_q8_rows.launches
    got = gm.gossip_mix_q8_rows(w_self.to(sm90), w_off.to(sm90), x.to(sm90),
                                q.to(sm90), s.to(sm90))
    torch.cuda.synchronize()
    assert gm.gossip_mix_q8_rows.launches == before + 1
    want = gm.gossip_mix_q8_rows_plain(w_self, w_off, x, q, s)
    assert _err(got.cpu(), want) < 1e-5


@pytest.mark.cuda
def test_gossip_mix_q8_value_errors_on_card(sm90):
    q = torch.zeros((2, 4096), dtype=torch.int8, device=sm90)
    before = gm.gossip_mix_q8_rows.launches
    with pytest.raises(ValueError, match="scale"):
        ops.gossip_mix_q8(torch.zeros(100, device=sm90), q,
                          torch.ones((2, 3), device=sm90),
                          torch.ones(3, device=sm90) / 3)
    with pytest.raises(ValueError, match="shorter"):
        ops.gossip_mix_q8(torch.zeros(9000, device=sm90), q,
                          torch.ones((2, 2), device=sm90),
                          torch.ones(3, device=sm90) / 3)
    assert gm.gossip_mix_q8_rows.launches == before


_FLASH_CASES = [
    (2, 33, 4, 2, 64, True, 0),       # ragged S
    (2, 80, 4, 1, 16, True, 32),      # MQA, band skips key tiles
    (1, 257, 4, 4, 128, True, 0),     # Hq == Hkv
    (1, 65, 4, 4, 80, True, 0),       # D below its tile (80 of 128)
    (2, 100, 4, 2, 64, False, 0),     # not causal
    (1, 300, 10, 1, 256, True, 100),  # the served heads, short window
]
# the bf16 (wgmma) kernel's tile edges: 128 query rows and 64 keys a block,
# so S = T of 1, 63, 129, 200 and 4097; windows 1, 33, 64, 100 and 2048;
# D of 16, 64, 80, 128 and 256; GQA groups 1, 2 and 10; causal off
_FLASH_BF16_EDGES = [
    (2, 1, 4, 2, 64, True, 0),
    (2, 63, 4, 4, 80, True, 33),
    (1, 129, 10, 1, 128, True, 1),
    (2, 200, 4, 2, 16, True, 64),
    (1, 200, 10, 1, 256, False, 100),
    (2, 129, 4, 2, 64, False, 0),
    (1, 63, 2, 1, 256, True, 2048),
    (1, 4097, 10, 1, 256, True, 2048),
    (1, 4097, 2, 2, 128, True, 0),
    (2, 200, 8, 4, 64, True, 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,hq,hkv,d,causal,window,dtype",
    [(*c, dt) for dt in DTYPES for c in _FLASH_CASES]
    + [(*c, "bfloat16") for c in _FLASH_BF16_EDGES]
    + [(2, 70, 4, 2, 20, True, 16, "float32")])   # fp32: any head_dim
def test_flash_attention_kernel_matches_plain(sm90, b, s, hq, hkv, d, causal,
                                              window, dtype):
    tdt = DTYPES[dtype]
    g = torch.Generator().manual_seed(s + d)
    q, k, v = (torch.randn((b, s, h, d), generator=g).to(tdt)
               for h in (hq, hkv, hkv))
    before = fa.flash_attention.launches
    got = ops.flash_attention_gqa(q.to(sm90), k.to(sm90), v.to(sm90),
                                  causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == tdt and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert _err(got.cpu(), want) < (2e-5 if dtype == "float32" else 3e-2)
    if dtype == "bfloat16":
        assert _row_err(got.cpu(), want) <= 2.0 ** -6


# the MLA and encoder-decoder shapes, through the entry the models call
# (ops pads a narrower v to q's D and cuts the output back): (B, S, T, H,
# D, Dv, causal). deepseek-v2-lite-16b's MLA (D 192 with v 128, 16 heads;
# the bf16 kernel's DP = 256 instance, its 4th 64-lane TMA box past D),
# seamless-m4t-large-v2's heads (16 of 64, MHA) causal and not, and cross
# attention with T != S both ways
_FLASH_NEW_SHAPES = [
    (1, 300, 300, 16, 192, 128, True),
    (4, 4096, 4096, 16, 192, 128, True),
    (2, 33, 100, 16, 64, 64, False),
    (2, 100, 33, 16, 64, 64, False),
    (1, 129, 700, 16, 64, 64, False),
    (4, 2048, 2048, 16, 64, 64, False),
    (2, 300, 300, 16, 64, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,d,dv,causal", _FLASH_NEW_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_at_mla_and_encdec_shapes(sm90, b, s, t, h, d,
                                                         dv, causal, dtype):
    tdt = DTYPES[dtype]
    g = torch.Generator(device=sm90).manual_seed(s + t + d)
    q, k = (torch.randn((b, n, h, d), generator=g, device=sm90).to(tdt)
            for n in (s, t))
    v = torch.randn((b, t, h, dv), generator=g, device=sm90).to(tdt)
    before = fa.flash_attention.launches
    got = ops.flash_attention_gqa(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == tdt and got.shape == (b, s, h, dv)
    want = fa.flash_attention_plain(
        q, k, torch.nn.functional.pad(v, (0, d - dv)), causal=causal
    )[..., :dv]
    assert _err(got, want) < (2e-5 if dtype == "float32" else 3e-2)
    if dtype == "bfloat16":
        assert _row_err(got, want) <= 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(320, "float32"), (20, "bfloat16"),
                                     (36, "bfloat16"), (250, "bfloat16")])
def test_flash_attention_kernel_refuses_wide_heads(sm90, d, dtype):
    """Either kernel refuses D > 256, the bf16 (TMA) one also D % 8 != 0:
    ValueError naming head_dim, and no launch (no fallback)."""
    q = torch.zeros((1, 8, 2, d), dtype=DTYPES[dtype], device=sm90)
    kv = q[:, :, :1]
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, kv, kv)
    assert fa.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,with_h0", [(4, 1, 2560, True),
                                           (2, 70, 100, True),
                                           (3, 37, 100, False),
                                           (2, 600, 256, True),
                                           # S across the chained scan's
                                           # 32-step chunks
                                           (2, 33, 2560, True),
                                           (3, 65, 300, False)])
def test_rglru_scan_kernel_matches_plain(sm90, b, s, d, with_h0):
    g = torch.Generator().manual_seed(s + d)
    a = torch.sigmoid(torch.randn((b, s, d), generator=g))
    x = torch.randn((b, s, d), generator=g)
    h0 = torch.randn((b, d), generator=g) if with_h0 else None
    before = rg.rglru_scan.launches
    got = ops.rglru(a.to(sm90), x.to(sm90),
                    None if h0 is None else h0.to(sm90))
    torch.cuda.synchronize()
    assert rg.rglru_scan.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, s, d)
    assert _err(got.cpu(), rg.rglru_scan_plain(a, x, h0)) < 1e-4


@pytest.mark.cuda
def test_rglru_scan_captured_in_a_graph_is_right_on_every_replay(sm90):
    """The chained scan's flags and ticket are zeroed by the call itself
    (a memset captured with the kernel), so a CUDA graph of one call gives
    the plain version's result on each replay, new inputs included."""
    g = torch.Generator().manual_seed(7)
    b, s, d = 2, 100, 256
    draw = lambda: (torch.sigmoid(torch.randn((b, s, d), generator=g)),  # noqa
                    torch.randn((b, s, d), generator=g),
                    torch.randn((b, d), generator=g))
    host = draw()
    a, x, h0 = (t.to(sm90) for t in host)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rg.rglru_scan(a, x, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rg.rglru_scan(a, x, h0)
    for replay in range(2):
        if replay:
            host = draw()
            for dev_t, new in zip((a, x, h0), host):
                dev_t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert _err(out.cpu(), rg.rglru_scan_plain(*host)) < 1e-4, replay


def _rkvw(b, s, h, d, seed):
    """r, k, v ~ N(0, 1), w = exp(-exp(N(0, 1) / 2)), u ~ N(0, 0.01) as
    tests/test_kernels.py:110-114 draws them, and a state ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((b, s, h, d), generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, s, h, d), generator=g) * 0.5))
    u = torch.randn((h, d), generator=g) * 0.1
    s0 = torch.randn((b, h, d, d), generator=g)
    return r, k, v, w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,with_s0", [
    (4, 256, 64, 64, True),      # the served heads, a shorter prompt
    (4, 256, 64, 64, False),
    (2, 1, 1, 64, True),         # one step (S = 1)
    (2, 33, 1, 32, True),        # ragged S
    (2, 33, 1, 16, False),
    (3, 40, 1, 8, True),         # the narrowest head
    (1, 50, 2, 128, True),       # the widest head
])
def test_rwkv6_scan_kernel_matches_plain(sm90, b, s, h, d, with_s0):
    r, k, v, w, u, s0 = _rkvw(b, s, h, d, seed=s + d)
    s0 = s0 if with_s0 else None
    before = rw.rwkv6_scan.launches
    y, st = ops.rwkv6(*(x.to(sm90) for x in (r, k, v, w, u)),
                      s0=None if s0 is None else s0.to(sm90))
    torch.cuda.synchronize()
    assert rw.rwkv6_scan.launches == before + 1
    assert y.shape == (b, s, h, d) and st.shape == (b, h, d, d)
    assert y.dtype == st.dtype == torch.float32
    # chunk 32, the model's: the chunked form's rounding grows with chunk
    want_y, want_s = rw.rwkv6_scan_plain(r, k, v, w, u, s0, 32)
    assert _err(y.cpu(), want_y) < 5e-4 and _err(st.cpu(), want_s) < 5e-4


def _rkvw_regime(b, s, h, d, regime, seed):
    """r, k, v ~ N(0, 1), u ~ N(0, 0.01), s0 ~ N(0, 1), and the decays of
    one regime: the served one, log w = -exp(U(0.5, 2) + N(0, 1)) (the
    1e-12 floor of w live), or a weak one, log w ~ -1e-3 with k scaled by
    sqrt(1 - w^2) so that the state keeps unit scale over its ~1000-step
    memory (the absolute bar was set for outputs of standard deviation
    ~8)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)) for _ in range(3))
    if regime == "served":
        lw = -np.exp(rng.uniform(0.5, 2.0, size=(b, s, h, d))
                     + rng.normal(size=(b, s, h, d)))
    else:
        lw = -1e-3 * np.exp(0.1 * rng.normal(size=(b, s, h, d)))
        k = k * np.sqrt(-np.expm1(2 * lw))
    u = rng.normal(size=(h, d)) * 0.1
    s0 = rng.normal(size=(b, h, d, d))
    return tuple(torch.from_numpy(x.astype(np.float32))
                 for x in (r, k, v, np.exp(lw), u, s0))


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["served", "weak"])
@pytest.mark.parametrize("b,s,h", [(2, 15, 4), (2, 17, 4), (1, 4097, 4)])
def test_rwkv6_scan_kernel_in_both_decay_regimes(sm90, regime, b, s, h):
    """S one short of the kernel's 16-step chunk, one past it, and a
    served prompt plus one, at the served head size, against the plain
    version (chunk 32) at 5e-4."""
    r, k, v, w, u, s0 = _rkvw_regime(b, s, h, 64, regime, seed=s)
    y, st = rw.rwkv6_scan(*(x.to(sm90) for x in (r, k, v, w, u, s0)))
    torch.cuda.synchronize()
    want_y, want_s = rw.rwkv6_scan_plain(r, k, v, w, u, s0, 32)
    assert _err(y.cpu(), want_y) < 5e-4 and _err(st.cpu(), want_s) < 5e-4


@pytest.mark.cuda
def test_rwkv6_scan_kernel_contracts(sm90):
    r, k, v, w, u, s0 = (x.to(sm90) for x in _rkvw(1, 4, 2, 16, seed=0))
    wide = [torch.ones((1, 2, 1, 136), device=sm90) for _ in range(4)]
    before = rw.rwkv6_scan.launches
    for args, match in (((r, k[:, :3], v, w, u), "one shape"),
                        ((r, k, v, w, u, s0.to(torch.bfloat16)), "float32"),
                        ((*wide, torch.ones((1, 136), device=sm90)),
                         "head size")):
        with pytest.raises(ValueError, match=match):
            rw.rwkv6_scan(*args)
    assert rw.rwkv6_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("block", [256, 2048])
@pytest.mark.parametrize("rows,length", [(6, 21_840), (6, 21_843), (5, 700),
                                         (1, 1), (16, 256), (3, 4096 + 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kernels_match_plain(sm90, block, rows, length, dtype):
    g = torch.Generator().manual_seed(rows * length + block)
    x = (torch.randn((rows, length), generator=g) * 3).to(DTYPES[dtype])
    before = (qz.quantize_int8.launches, qz.dequantize_int8.launches)
    q, s = qz.quantize_int8(x.to(sm90), block)
    outs = {odt: qz.dequantize_int8(q, s, block, length, DTYPES[odt])
            for odt in DTYPES}
    torch.cuda.synchronize()
    assert (qz.quantize_int8.launches, qz.dequantize_int8.launches) == \
        (before[0] + 1, before[1] + 2)
    qp, sp = qz.quantize_int8_plain(x, block)
    assert torch.equal(q.cpu(), qp) and torch.equal(s.cpu(), sp)
    for odt, got in outs.items():
        assert got.dtype == DTYPES[odt] and got.shape == (rows, length)
        assert torch.equal(got.cpu(), qz.dequantize_int8_plain(
            qp, sp, block, length, DTYPES[odt]))


@pytest.mark.cuda
def test_quantize_kernels_through_the_wire_codec_and_ops(sm90):
    """The wire codec (2048 lanes) and the TPU contract (256 lanes, ragged
    C) on the card launch the kernels and equal the CPU's plain results;
    the card's plain version on the same inputs agrees too."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((6, 21_840), generator=g) * 0.3
    before = (qz.quantize_int8.launches, qz.dequantize_int8.launches)
    q, s = comp.quantize_int8_rows(x.to(sm90))
    d = comp.dequantize_int8_rows(q, s, 21_840)
    qo, so = ops.quantize_int8(x[:5, :700].to(sm90))
    do = ops.dequantize_int8(qo, so)
    torch.cuda.synchronize()
    assert (qz.quantize_int8.launches, qz.dequantize_int8.launches) == \
        (before[0] + 2, before[1] + 2)
    qc, sc = comp.quantize_int8_rows(x)
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    assert torch.equal(d.cpu(), comp.dequantize_int8_rows(qc, sc, 21_840))
    qg, sg = qz.quantize_int8_plain(x.to(sm90), 2048)
    assert torch.equal(q, qg) and torch.equal(s, sg)
    qoc, soc = ops.quantize_int8(x[:5, :700])
    assert torch.equal(qo.cpu(), qoc) and torch.equal(so.cpu(), soc)
    assert torch.equal(do.cpu(), ops.dequantize_int8(qoc, soc))


@pytest.mark.cuda
def test_quantize_kernel_contracts(sm90):
    q = torch.zeros((2, 512), dtype=torch.int8, device=sm90)
    before = (qz.quantize_int8.launches, qz.dequantize_int8.launches)
    for call, match in (
            (lambda: qz.quantize_int8(torch.zeros(3, 5, device=sm90), 512),
             "scale block"),
            (lambda: qz.quantize_int8(torch.zeros(10, device=sm90)), "2-D"),
            (lambda: qz.quantize_int8(torch.zeros(2, 9, dtype=torch.float16,
                                                  device=sm90)),
             "float32 or bfloat16"),
            (lambda: qz.dequantize_int8(q, torch.ones(2, 3, device=sm90)),
             "one per block"),
            (lambda: qz.dequantize_int8(q.float(), torch.ones(2, 2,
                                                              device=sm90)),
             "int8"),
            (lambda: qz.dequantize_int8(q, torch.ones(2, 2, device=sm90),
                                        length=600), "fit")):
        with pytest.raises(ValueError, match=match):
            call()
    assert (qz.quantize_int8.launches, qz.dequantize_int8.launches) == before



# ---------------------------------------------------------------------------
# The int8 round: the send with error feedback, the receive with W whole
# ---------------------------------------------------------------------------

def _unfused_send(flat, res, live, ef):
    """The int8 round's send as the port ran it before the error-feedback
    entry: the kept codec wrappers plus torch ops."""
    carried = flat + res if ef else flat
    q, s = comp.quantize_int8_rows(carried)
    deq = comp.dequantize_int8_rows(q, s, carried.shape[1])
    new_res = carried - deq if ef else res
    return q, s, torch.where(live[:, None], new_res, torch.zeros(
        (), dtype=new_res.dtype, device=new_res.device))


def _send_inputs(rows, length, seed, dead):
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn((rows, length), generator=g) * 0.3
    res = torch.randn((rows, length), generator=g) * 1e-3
    live = torch.ones(rows, dtype=torch.bool)
    if dead:
        live[-1] = False
    return flat, res, live


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length", [(6, 21_840), (6, 21_843),
                                         (3, 2049), (1, 1)])
@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("dead", [False, True])
def test_quantize_int8_ef_kernel_matches_plain_and_unfused_sequence(
        sm90, rows, length, ef, dead):
    """q, the scales and new_res bit-equal to the plain version (on the
    CPU and on the card) and to the unfused sequence of launches."""
    flat, res, live = _send_inputs(rows, length, rows * length, dead)
    args = [t.to(sm90) for t in (flat, res, live)]
    before = (qz.quantize_int8_ef.launches, qz.quantize_int8.launches,
              qz.dequantize_int8.launches)
    got = qz.quantize_int8_ef(*args, ef)
    torch.cuda.synchronize()
    assert (qz.quantize_int8_ef.launches, qz.quantize_int8.launches,
            qz.dequantize_int8.launches) == (before[0] + 1, *before[1:])
    assert [t.shape for t in got] == [
        (rows, -(-length // 2048) * 2048), (rows, -(-length // 2048)),
        (rows, length)]
    for want in (qz.quantize_int8_ef_plain(flat, res, live, ef),
                 qz.quantize_int8_ef_plain(*args, ef),
                 _unfused_send(*args, ef)):
        assert all(a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
                   for a, b in zip(got, want))


def _near_half_integers(seed):
    """Rows whose lanes sit within a few ulps of (k + 1/2) * scale, the
    quotients where one reciprocal and the IEEE division can round apart:
    every block's max is 100, so scale = fl(100 / 127) is inexact. Then a
    row at magnitudes whose scale is subnormal (1e-37) and one of
    subnormal lanes (1e-43)."""
    rng = np.random.default_rng(seed)
    scale = np.float32(100) / np.float32(127)
    k = rng.integers(-127, 127, size=(3, 6144)).astype(np.float64)
    x = np.float32((k + 0.5) * np.float64(scale))
    steps = rng.integers(-3, 4, size=x.shape)
    for _ in range(3):
        up, down = steps > 0, steps < 0
        x = np.where(up, np.nextafter(x, np.float32(np.inf)),
                     np.where(down, np.nextafter(x, np.float32(-np.inf)), x))
        steps = steps - np.sign(steps)
    x[:, ::2048] = 100.0
    tiny = rng.normal(size=(2, 6144)).astype(np.float32)
    tiny[0] *= np.float32(1e-37)
    tiny[1] *= np.float32(1e-43)
    return torch.from_numpy(np.concatenate([x, tiny]).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("ef", [True, False])
def test_quantize_int8_ef_kernel_at_half_integers_and_tiny_scales(sm90, ef):
    """The send's one-reciprocal quotient must round as the IEEE division
    does where the two can differ, and take the division outright where
    the scale leaves the range of its proof (csrc/quantize.cu)."""
    flat = _near_half_integers(0)
    res = torch.zeros_like(flat) if ef else torch.randn(flat.shape)
    live = torch.ones(flat.shape[0], dtype=torch.bool)
    got = qz.quantize_int8_ef(*(t.to(sm90) for t in (flat, res, live)), ef)
    torch.cuda.synchronize()
    for want in (qz.quantize_int8_ef_plain(flat, res, live, ef),
                 _unfused_send(*(t.to(sm90) for t in (flat, res, live)), ef)):
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 6, 8, 9])
@pytest.mark.parametrize("n", [1, 8195, 21_840, 21_843])
def test_gossip_mix_q8_w_kernel_matches_plain(sm90, k, n):
    """The receive with W (K, K) taken whole, against its plain version at
    1e-5: K one short of a group of 8 payloads, a whole group and one past;
    aligned and ragged N."""
    g = torch.Generator().manual_seed(k * n)
    q, s = quantize_int8_rows(torch.randn((k, n), generator=g) * 4)
    x = torch.randn((k, n), generator=g)
    w = torch.softmax(torch.randn((k, k), generator=g), -1)
    before = gm.gossip_mix_q8_rows.launches
    got = gm.gossip_mix_q8_w(w.to(sm90), x.to(sm90), q.to(sm90), s.to(sm90))
    torch.cuda.synchronize()
    assert gm.gossip_mix_q8_rows.launches == before + 1
    assert got.shape == (k, n) and got.dtype == torch.float32
    assert _err(got.cpu(), gm.gossip_mix_q8_w_plain(w, x, q, s)) < 1e-5
    # the variant the round launches (W and self loaded ahead of the wait)
    early = gm.gossip_mix_q8_w(w.to(sm90), x.to(sm90), q.to(sm90),
                               s.to(sm90), after_send=True)
    torch.cuda.synchronize()
    assert torch.equal(early, got)
    # the same receive through the rows form (diag and W_off split)
    diag = torch.diagonal(w).contiguous()
    rows = gm.gossip_mix_q8_rows(diag.to(sm90), (w - torch.diag(diag)).to(
        sm90), x.to(sm90), q.to(sm90), s.to(sm90))
    torch.cuda.synchronize()
    assert torch.equal(rows, got)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 9])
@pytest.mark.parametrize("n", [100, 21_840, 3 * 8192 + 5])
def test_gossip_mix_q8_tpu_contract_on_the_new_body(sm90, k, n):
    """M = 1, weights = [w_self, w_off...] (the TPU kernel's signature)
    through the same kernel at stride 1, against the plain version."""
    g = torch.Generator().manual_seed(k + n)
    q, s = quantize_int8_rows(torch.randn((k, n), generator=g) * 4)
    x = torch.randn(n, generator=g)
    w = torch.softmax(torch.randn(k + 1, generator=g), -1)
    got = ops.gossip_mix_q8(x.to(sm90), q.to(sm90), s.to(sm90), w.to(sm90))
    torch.cuda.synchronize()
    want = gm.gossip_mix_q8_rows_plain(w[:1], w[None, 1:], x[None], q, s)[0]
    assert got.shape == (n,) and _err(got.cpu(), want) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 6, 8, 9])
@pytest.mark.parametrize("n", [21_840, 21_843])
def test_int8_round_receive_matches_plain(sm90, k, n):
    """The round's receive, launched right behind the send with W and flat
    loaded ahead of its wait, against the plain receive of the same q and
    scales at 1e-5 (one dead node); the residual bit-equal to the send's."""
    g = torch.Generator().manual_seed(k * n + 1)
    flat = (torch.randn((k, n), generator=g) * 0.3).to(sm90)
    res = (torch.randn((k, n), generator=g) * 1e-3).to(sm90)
    w = torch.softmax(torch.randn((k, k), generator=g), -1).to(sm90)
    live = torch.arange(k, device=sm90) != k - 1
    mixed, new_res = gm.gossip_mix_int8_round(flat, res, w, live)
    q, s, want_res = qz.quantize_int8_ef(flat, res, live)
    torch.cuda.synchronize()
    assert torch.equal(new_res, want_res)
    assert _err(mixed.cpu(), gm.gossip_mix_q8_w_plain(
        w.cpu(), flat.cpu(), q.cpu(), s.cpu())) < 1e-5


def _round(flat, res, w, live, ef=True):
    from repro_torch.core import dpsgd
    from repro_torch.core.compression import QuantConfig
    return dpsgd._compress_and_mix(flat, res, w, live, QuantConfig(
        mode="int8", error_feedback=ef))


@pytest.mark.cuda
@pytest.mark.parametrize("ef", [True, False])
def test_int8_round_captured_graph_matches_eager(sm90, ef):
    """The round (send, then receive) captured once into a CUDA graph and
    replayed twice, new inputs copied in before the second replay: each
    replay equal to the eager round on the same inputs (bit for bit: the
    same kernels), and to the CPU's plain versions (mixed 1e-5, new_res
    exact), and two launches a round."""
    n, length = 6, 21_840
    inputs = []
    for seed in (1, 2):
        flat, res, live = _send_inputs(n, length, seed, dead=True)
        w = torch.softmax(torch.randn((n, n), generator=torch.Generator()
                                      .manual_seed(seed)), -1)
        inputs.append((flat, res, w, live))
    static = [t.to(sm90) for t in inputs[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _round(*static, ef)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (qz.quantize_int8_ef.launches, gm.gossip_mix_q8_rows.launches)
    with torch.cuda.graph(graph, stream=side):
        out = _round(*static, ef)
    assert (qz.quantize_int8_ef.launches,
            gm.gossip_mix_q8_rows.launches) == (before[0] + 1, before[1] + 1)
    for cpu in inputs:
        for dst, src in zip(static, cpu):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        eager = _round(*[t.to(sm90) for t in cpu], ef)
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
        mixed, new_res = _round(*cpu, ef)
        assert _err(out[0].cpu(), mixed) < 1e-5
        assert torch.equal(out[1].cpu(), new_res)


@pytest.mark.cuda
def test_int8_round_kernel_contracts(sm90):
    """ValueErrors before any launch: the send's shapes, dtypes and mask,
    the receive's W and payloads, and the round's W, shapes and devices
    (neither kernel launched)."""
    f = torch.zeros((2, 300), device=sm90)
    live = torch.ones(2, dtype=torch.bool, device=sm90)
    q = torch.zeros((2, 2048), dtype=torch.int8, device=sm90)
    s = torch.ones((2, 1), device=sm90)
    before = (qz.quantize_int8_ef.launches, gm.gossip_mix_q8_rows.launches)
    for call, match in (
            (lambda: qz.quantize_int8_ef(f, f[:, :299], live), "one"),
            (lambda: qz.quantize_int8_ef(f.double(), f.double(), live),
             "float32"),
            (lambda: qz.quantize_int8_ef(f, f, live.float()), "bool"),
            (lambda: qz.quantize_int8_ef(f, f, live[:1]), "bool"),
            (lambda: gm.gossip_mix_q8_w(torch.ones((2, 3), device=sm90), f,
                                        q, s), "square"),
            (lambda: gm.gossip_mix_q8_w(torch.ones((2, 2), device=sm90), f,
                                        q, torch.ones((2, 2), device=sm90)),
             "scale"),
            (lambda: gm.gossip_mix_int8_round(
                f, f, torch.ones((2, 3), device=sm90), live), "square"),
            (lambda: gm.gossip_mix_int8_round(f, f[:, :299], torch.ones(
                (2, 2), device=sm90), live), "one"),
            (lambda: gm.gossip_mix_int8_round(f, f, torch.ones((2, 2)),
                                              live), "w is on"),
            (lambda: gm.gossip_mix_int8_round(f, f, torch.ones(
                (2, 2), device=sm90), live.cpu()), "live is on")):
        with pytest.raises(ValueError, match=match):
            call()
    assert (qz.quantize_int8_ef.launches,
            gm.gossip_mix_q8_rows.launches) == before


# ---------------------------------------------------------------------------
# The D-PSGD steps as CUDA graphs (repro_torch.graphs)
# ---------------------------------------------------------------------------

def _step_inputs(n, seed, device, b=8):
    """Distinct per-node CNN parameters, a batch and a row-stochastic W
    (numpy float64, as the simulator hands it over), made from a seed."""
    from repro_torch.core import dpsgd
    from repro_torch.models import cnn

    g = torch.Generator().manual_seed(seed)
    base = cnn.cnn_init(g, device="cpu")
    params = dpsgd._tree_map(
        lambda p: (p[None].repeat(n, *([1] * p.dim()))
                   + 0.01 * torch.randn((n, *p.shape), generator=g)
                   ).to(device), base)
    rng = np.random.default_rng(seed)
    batch = {"images": torch.from_numpy(rng.normal(
                 size=(n, b, 1, 28, 28)).astype(np.float32)).to(device),
             "labels": torch.from_numpy(rng.integers(
                 0, 10, size=(n, b)).astype(np.int32)).to(device)}
    w = rng.random((n, n)) + np.eye(n)
    return params, batch, w / w.sum(1, keepdims=True)


def _graph_cases():
    from repro_torch.core import dpsgd
    from repro_torch.core.compression import QuantConfig
    from repro_torch.models import cnn

    cfg, int8 = dpsgd.DPSGDConfig(eta=0.05), QuantConfig(mode="int8")
    return {
        "dense": (lambda: dpsgd.make_dpsgd_step(cnn.cnn_loss, cfg),
                  lambda *a: dpsgd.dpsgd_step(cnn.cnn_loss, *a, cfg)),
        "masked": (lambda: dpsgd.make_dpsgd_masked_step(cnn.cnn_loss, cfg),
                   lambda *a: dpsgd.dpsgd_masked_step(cnn.cnn_loss, *a, cfg)),
        "compressed": (
            lambda: dpsgd.make_dpsgd_compressed_step(cnn.cnn_loss, int8, cfg),
            lambda *a: dpsgd.dpsgd_masked_compressed_step(
                cnn.cnn_loss, *a, int8, cfg))}


def _flat(out):
    from repro_torch.core import dpsgd
    if isinstance(out, dict):
        return dpsgd._leaves(out)
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [out]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "masked", "compressed"])
def test_graphed_step_matches_eager_body_and_outputs_stay_put(sm90, kind):
    """Five graphed steps at n = 6, then five at n = 5 (a new signature,
    a second capture), each held against the eager body on the same
    inputs (losses 1e-4, parameters 1e-5, the int8 payload's rounding
    included); what step k returned is unchanged after step k + 1. W
    arrives as pageable numpy each step."""
    from repro_torch.core import dpsgd

    build, body = _graph_cases()[kind]
    step = build()
    for n in (6, 5):
        params, batch, w = _step_inputs(n, seed=n, device=sm90)
        live = np.arange(n) != 1
        res = dpsgd.zero_residuals(params)
        kept = []
        for k in range(5):
            args = (params, batch, w) + {
                "dense": (), "masked": (live,), "compressed": (live, res)}[kind]
            got, want = step(*args), body(*args)
            torch.cuda.synchronize()
            leaves, ref = _flat(got), _flat(want)
            assert len(leaves) == len(ref)
            for a, b_ in zip(leaves, ref):
                assert a.shape == b_.shape and a.dtype == b_.dtype
                assert _err(a, b_) <= 1e-5
            kept.append((got, [t.clone() for t in leaves]))
            params = got[0]
            res = got[1] if kind == "compressed" else res
            batch = {"images": batch["images"].flip(1),
                     "labels": batch["labels"].flip(1)}
        torch.cuda.synchronize()
        for got, copy in kept:
            assert all(torch.equal(a, c) for a, c in zip(_flat(got), copy))
    assert step.signatures == 2


@pytest.mark.cuda
def test_graphed_step_counts_one_capture_delta_per_replay(sm90):
    """The warm-up and the capture launch nothing that counts; each replay
    adds what the capture saw: one send (the error-feedback quantize) and
    one q8 receive per int8 round, and no quantize_int8 or dequantize."""
    build, _ = _graph_cases()["compressed"]
    from repro_torch.core import dpsgd

    step = build()
    params, batch, w = _step_inputs(6, seed=0, device=sm90)
    live = torch.ones(6, dtype=torch.bool, device=sm90)
    res = dpsgd.zero_residuals(params)
    counters = (qz.quantize_int8_ef, qz.quantize_int8, qz.dequantize_int8,
                gm.gossip_mix_q8_rows, gm.gossip_mix_rows)
    before = [f.launches for f in counters]
    step.prepare(params, batch, w, live, res)
    assert [f.launches for f in counters] == before
    for r in range(1, 4):
        params, res, _ = step(params, batch, w, live, res)
        assert [f.launches - b for f, b in zip(counters, before)] == \
            [r, 0, 0, r, 0]


@pytest.mark.cuda
def test_graphed_loop_with_the_host_ahead_matches_a_synchronised_loop(sm90):
    """Thirty graphed steps issued back to back, as train() issues them
    (indices uploaded without a sync, the host running ahead of the card),
    end bit-equal to the same steps synchronised one by one, with cuDNN
    held to deterministic algorithms: no step reads an input, a static
    buffer or an output that a later step has already overwritten."""
    from repro_torch.core import dpsgd
    from repro_torch.examples import wireless_dpsgd as ex
    from repro_torch.models import cnn

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        g = torch.Generator().manual_seed(7)
        data = ex.NodeData(torch.randn((6, 200, 1, 28, 28), generator=g).to(sm90),
                           torch.randint(0, 10, (6, 200), generator=g,
                                         dtype=torch.int32).to(sm90),
                           torch.zeros((1, 1, 28, 28), device=sm90),
                           torch.zeros((1,), dtype=torch.int32, device=sm90))
        w = torch.full((6, 6), 1 / 6, device=sm90)
        step = dpsgd.make_dpsgd_step(cnn.cnn_loss, dpsgd.DPSGDConfig(eta=0.05))
        runs = []
        for sync in (False, True):
            params = ex.init_params(6, device=sm90)
            rng = np.random.default_rng(0)
            losses = []
            for _ in range(30):
                idx = rng.integers(0, data.per_node, size=(6, ex.BATCH))
                params, loss = step(params, ex._batch(data, idx), w)
                losses.append(loss)
                if sync:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            runs.append(_flat(params) + losses)
        assert step.signatures == 1
        assert all(torch.equal(a, b) for a, b in zip(*runs))
    finally:
        torch.backends.cudnn.deterministic = deterministic


# ---------------------------------------------------------------------------
# Flash attention's backward kernel and the training path
# ---------------------------------------------------------------------------

# every served arch's attention shape, small in B and S: (B, S, T, Hq, Hkv,
# D, causal, window): recurrentgemma-2b / gemma-style windowed D 256 with 10
# q heads on 1 kv head, deepseek's MLA D 192, seamless's D 64 causal,
# bidirectional and cross (T != S), stablelm-3b's 32 heads of 80; then the
# edges of the bf16 kernel's 64-row tiles (and 128-row blocks): S and T of
# 63, 65 and 129 causal and not, T > S causal, windows on both sides of a
# tile, and phase 17's smoke widths (D 16). tests/test_torch_kernels.py
# holds the tensor-core path's rounding at those of D <= 128 on the CPU.
_BWD_SHAPES = [
    (1, 600, 600, 10, 1, 256, True, 256),
    (1, 300, 300, 16, 16, 192, True, 0),
    (2, 300, 300, 16, 16, 64, True, 0),
    (2, 300, 300, 16, 16, 64, False, 0),
    (2, 129, 700, 16, 16, 64, False, 0),
    (4, 200, 200, 32, 32, 80, True, 0),
    (2, 77, 77, 4, 2, 80, True, 0),
    (2, 63, 63, 4, 2, 64, True, 0),
    (2, 63, 63, 4, 2, 64, False, 0),
    (2, 65, 65, 4, 4, 80, True, 0),
    (2, 65, 65, 4, 4, 80, False, 0),
    (2, 129, 129, 4, 1, 128, True, 0),
    (2, 129, 129, 4, 1, 128, False, 0),
    (2, 65, 129, 4, 2, 64, True, 0),
    (2, 63, 200, 8, 8, 128, True, 0),
    (24, 32, 32, 4, 4, 16, True, 0),
    (2, 129, 129, 8, 4, 64, True, 33),
    (2, 200, 200, 4, 4, 128, False, 100),
]


def _bwd_inputs(b, s, t, hq, hkv, d, tdt, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((b, s, hq, d), generator=g, device=device).to(tdt)
             for _ in range(2))
    k, v = (torch.randn((b, t, hkv, d), generator=g, device=device).to(tdt)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal,window", _BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_matches_plain(sm90, b, s, t, hq, hkv, d,
                                                  causal, window, dtype):
    """dq, dk, dv of the backward kernel against its plain version summed
    in float64, on the same inputs (the forward kernel's out and lse): fp32
    2e-5, bf16 3e-2 and every row within 2^-6 of its norm; one launch a
    call."""
    tdt = DTYPES[dtype]
    q, k, v, do = _bwd_inputs(b, s, t, hq, hkv, d, tdt, sm90, s + t + d)
    o, lse = fa._forward(q, k, v, causal, window, True)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    # the plain version's formulas summed in float64 (the oracle)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        window=window, acc_dtype=torch.float64)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.shape == w_.shape and g_.dtype == tdt
        assert _err(g_, w_) < (2e-5 if dtype == "float32" else 3e-2)
        if dtype == "bfloat16":
            # dq of the first query under a causal mask (one live key) is 0
            # exactly: rounding noise on both sides, held by the absolute
            # bar only
            first = 1 if name == "dq" and causal else 0
            assert _row_err(g_[:, first:], w_[:, first:]) <= 2.0 ** -6


@pytest.mark.cuda
def test_flash_attention_at_qwen2_vl_training_shape(sm90):
    """Pod-mode training of qwen2-vl-2b (4 nodes x batch 4 folded into B,
    S 512, 12 q heads on 2 kv heads of 128, bf16, causal): the forward
    with lse and the backward (the (128, 8) wgmma instance, D split over
    the consumer warpgroups) against their plain versions at the bars
    above (the gradients: 3e-2 or one bf16 ulp, see below; every row
    2^-6), one launch each."""
    b, s, hq, hkv, d = 16, 512, 12, 2, 128
    q, k, v, do = _bwd_inputs(b, s, s, hq, hkv, d, torch.bfloat16, sm90, 27)
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    o, lse = fa._forward(q, k, v, True, 0, True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, causal=True,
                                          return_lse=True)
    assert _err(o, o_p) < 3e-2 and _row_err(o, o_p) <= 2.0 ** -6
    assert _err(lse, lse_p) < 1e-5
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                        acc_dtype=torch.float64)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.shape == w_.shape and g_.dtype == torch.bfloat16
        # GQA 6:1 sums 6 heads' 512 queries into a key's dk and dv, which
        # reach |x| of 4 to 13: there one bf16 ulp (2^-5 and up) exceeds
        # 3e-2, and an fp32 sum near a rounding midpoint lands one ulp from
        # the float64 oracle's rounding (0.03125 on dv on an H100).
        # Each element within 3e-2 or one ulp of its value, the larger.
        w64 = w_.double()
        ulp = torch.exp2(torch.floor(torch.log2(
            w64.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((g_.double() - w64).abs() <= ulp.clamp(min=3e-2)).all())
        first = 1 if name == "dq" else 0
        assert _row_err(g_[:, first:], w_[:, first:]) <= 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal,window",
                         [_BWD_SHAPES[i] for i in (0, 5, 7, 11, 14, 15, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_is_deterministic(sm90, b, s, t, hq, hkv,
                                                     d, causal, window,
                                                     dtype):
    """No atomics: two calls on the same inputs give bit-equal dq, dk and
    dv (each element summed by one thread in a fixed order)."""
    tdt = DTYPES[dtype]
    q, k, v, do = _bwd_inputs(b, s, t, hq, hkv, d, tdt, sm90, s + t + d)
    o, lse = fa._forward(q, k, v, causal, window, True)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    torch.empty(1 << 20, device=sm90).fill_(1.0)   # other work between
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_flash_attention_bwd_bf16_kernels_do_not_spill(sm90):
    """ptxas's report of the backward's library: every bf16 instance
    (the tensor-core dk / dv and dq kernels at (DP, KS) (64, 4), (80, 5)
    and (128, 8), and the CUDA-core delta, dk / dv and dq at DP 256) with
    0 spill bytes, and no wgmma serialised."""
    from repro_torch.kernels import _build

    _build.load("flash_attention_bwd")
    log = _build._target("flash_attention_bwd")[1].with_suffix(".log")
    text = log.read_text()
    entries = _build.ptxas_entries(text)
    bf16 = [(e, st + ld) for e, _, st, ld in entries
            if "bf16" in e or "bfloat16" in e]
    wgmma = [e for e, _ in bf16 if "dkdv_bf16" in e or "dq_bf16" in e]
    assert len(wgmma) == 6, wgmma
    assert len(bf16) == 9, bf16
    assert all(n == 0 for _, n in bf16), bf16
    assert "Performance Loss" not in text


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal,window", _BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_forward_lse_matches_logsumexp(sm90, b, s, t, hq, hkv,
                                                       d, causal, window,
                                                       dtype):
    """The lse the forward kernel writes for the backward: each query
    row's log-sum-exp of its scaled, masked scores, against
    torch.logsumexp over the plain scores in fp32 (1e-5); the output the
    same as without lse."""
    tdt = DTYPES[dtype]
    q, k, v, _ = _bwd_inputs(b, s, t, hq, hkv, d, tdt, sm90, s * d)
    o, lse = fa._forward(q, k, v, causal, window, True)
    torch.cuda.synchronize()
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    assert torch.equal(o, fa.flash_attention(q, k, v, causal=causal,
                                             window=window))
    qpos = torch.arange(s, device=sm90)[:, None]
    kpos = torch.arange(t, device=sm90)[None, :]
    live = torch.ones((s, t), dtype=torch.bool, device=sm90)
    if causal:
        live &= kpos <= qpos
    if window:
        live &= qpos - kpos < window
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float(
        ).repeat_interleave(hq // hkv, 2)) * d**-0.5
    want = torch.logsumexp(scores.masked_fill(~live, float("-inf")), -1)
    assert _err(lse, want) < 1e-5


@pytest.mark.cuda
def test_graphed_vmap_grad_through_flash_matches_eager(sm90):
    """The D-PSGD masked step of the stablelm-3b smoke model (vmap of
    grad_and_value over 3 nodes, through the flash Functions) as a CUDA
    graph: three replays against the eager body on the same inputs
    (losses 1e-4, parameters 1e-5), each replay one flash forward, one
    backward and one rows mix."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.models import build

    api = build(reduce_for_smoke(get_config("stablelm-3b")), sm90)
    cfg = dpsgd.DPSGDConfig(eta=0.05)
    step = dpsgd.make_dpsgd_masked_step(api.loss, cfg)
    params = dpsgd.replicate(api.init(torch.Generator().manual_seed(0)), 3)
    rng = np.random.default_rng(0)
    w = np.full((3, 3), 1 / 3)
    live = np.ones(3, bool)
    counters = (fa.flash_attention, fa.flash_attention_bwd, gm.gossip_mix_rows)
    for r in range(3):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, 512, (3, 2, 24)).astype(np.int32)).to(sm90)}
        before = [c.launches for c in counters]
        got = step(params, batch, w, live)
        if r > 0:       # the first call captures: its warm-ups do not count
            assert [c.launches - b_ for c, b_ in zip(counters, before)] == \
                [1, 1, 1]
        want = dpsgd.dpsgd_masked_step(api.loss, params, batch, w, live, cfg)
        torch.cuda.synchronize()
        assert _err(got[1], want[1]) <= 1e-4
        for a, b_ in zip(_flat(got[0]), _flat(want[0])):
            assert _err(a, b_) <= 1e-5
        params = got[0]
    assert step.signatures == 1


# ---------------------------------------------------------------------------
# The scans' backward kernels, against their plain versions summed in
# float64, at chip_smoke.py phase 3f's shapes
# ---------------------------------------------------------------------------

def _held(got, want, bar):
    """max |got - want| <= bar x max(1, max |want|) for every gradient."""
    for g, w_ in zip(got, want):
        assert (g is None) == (w_ is None)
        if g is not None:
            assert g.shape == w_.shape and g.dtype == torch.float32
            assert _err(g, w_) <= bar * max(1.0, float(w_.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,with_h0", [
    (6, 512, 2560, False), (4, 4096, 2560, True), (4, 1, 2560, True),
    (3, 32, 100, False), (2, 33, 2560, True), (3, 70, 300, True),
    (2, 300, 100, False), (3, 512, 2560, False), (3, 70, 101, True)])
def test_rglru_scan_bwd_kernel_matches_float64_plain(sm90, b, s, d, with_h0):
    gen = torch.Generator(device=sm90).manual_seed(s + d)
    a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=sm90))
    h0 = torch.randn((b, d), generator=gen, device=sm90) if with_h0 else None
    h = rg.rglru_scan(a, torch.randn((b, s, d), generator=gen, device=sm90),
                      h0)
    dh = torch.randn((b, s, d), generator=gen, device=sm90)
    before = rg.rglru_scan_bwd.launches
    got = rg.rglru_scan_bwd(a, h, dh, h0)
    again = rg.rglru_scan_bwd(a, h, dh, h0)
    torch.cuda.synchronize()
    assert rg.rglru_scan_bwd.launches == before + 2
    assert all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got, again))
    _held(got, rg.rglru_scan_bwd_plain(a, h, dh, h0,
                                       acc_dtype=torch.float64), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,states,u_rows,regime", [
    (12, 512, 64, 64, False, True, "test"),
    (12, 512, 64, 64, True, True, "served"),
    (4, 4096, 64, 64, True, False, "test"),
    (2, 37, 2, 64, False, False, "served"),
    (2, 45, 3, 32, True, True, "test"),
    (2, 33, 2, 128, True, False, "served"),
    (2, 40, 4, 16, False, True, "test"),
    (1, 17, 2, 8, True, True, "test"),
    (2, 63, 3, 64, True, True, "served"),
    (2, 65, 3, 64, True, True, "test"),
    (2, 129, 2, 64, True, True, "served")])
def test_rwkv6_scan_bwd_kernel_matches_float64_plain(sm90, b, s, h, d, states,
                                                     u_rows, regime):
    gen = torch.Generator(device=sm90).manual_seed(s + d)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=sm90)
    r, k, v, dy = (randn(b, s, h, d) for _ in range(4))
    if regime == "served":
        lw = -torch.exp(0.5 + 1.5 * torch.rand((b, s, h, d), generator=gen,
                                               device=sm90)
                        + randn(b, s, h, d))
    else:
        lw = -torch.exp(randn(b, s, h, d) * 0.5)
    w = torch.exp(lw)
    u = randn(b, h, d) * 0.1 if u_rows else randn(h, d) * 0.1
    s0, dsf = (randn(b, h, d, d), randn(b, h, d, d)) if states else (None,
                                                                      None)
    before = rw.rwkv6_scan_bwd.launches
    got = rw.rwkv6_scan_bwd(r, k, v, w, u, dy, s0, dsf)
    again = rw.rwkv6_scan_bwd(r, k, v, w, u, dy, s0, dsf)
    torch.cuda.synchronize()
    assert rw.rwkv6_scan_bwd.launches == before + 2
    assert all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got, again))
    _held(got, rw.rwkv6_scan_bwd_plain(r, k, v, w, u, dy, s0, dsf, 32,
                                       acc_dtype=torch.float64), 5e-4)


@pytest.mark.cuda
def test_scans_train_through_their_kernels_under_vmap_of_grad(sm90):
    """vmap(grad_and_value) over 3 nodes on the card, u a node's own: one
    forward and one backward launch of each scan for all nodes, and the
    gradients equal a loop over nodes (each its own launches) within the
    scans' bars."""
    gen = torch.Generator(device=sm90).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=sm90)
    a, x = torch.sigmoid(randn(3, 2, 70, 64)), randn(3, 2, 70, 64)
    r, k, v = (randn(3, 2, 40, 2, 16) for _ in range(3))
    w, u = torch.exp(-torch.exp(randn(3, 2, 40, 2, 16) * 0.5)), randn(3, 2, 16)

    def loss(a_, x_, r_, k_, v_, w_, u_):
        y, _ = rw.rwkv6_scan(r_, k_, v_, w_, u_)
        return (rg.rglru_scan(a_, x_) ** 2).sum() + (y ** 2).sum()
    counters = (rg.rglru_scan, rg.rglru_scan_bwd, rw.rwkv6_scan,
                rw.rwkv6_scan_bwd)
    before = [c.launches for c in counters]
    grads, losses = torch.func.vmap(torch.func.grad_and_value(
        loss, argnums=tuple(range(7))))(a, x, r, k, v, w, u)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1] * 4
    for i in range(3):
        g, l_ = torch.func.grad_and_value(loss, argnums=tuple(range(7)))(
            a[i], x[i], r[i], k[i], v[i], w[i], u[i])
        assert abs(float(l_ - losses[i])) <= 1e-4 * max(1.0, abs(float(l_)))
        for n, (gi, gv) in enumerate(zip(g, grads)):
            bar = 1e-4 if n < 2 else 5e-4
            assert _err(gi, gv[i]) <= bar * max(1.0, float(gi.abs().max()))


def _stablelm_one_layer_bits() -> float:
    """stablelm-3b cut to 1 layer (chip_smoke.py phase 16's model) in fp32
    wire bits, as ``sim.batch.transformer_adapter`` counts them, without
    drawing a parameter."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.core import dpsgd
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config("stablelm-3b"), n_layers=1)
    with FakeTensorMode():
        tree = transformer.init_params(cfg, torch.Generator(), "cpu")
    return float(sum(32 * x.numel() for x in dpsgd._leaves(tree)))


# past one tile: 10 000 packets (over the earlier whole-trace layout's cap
# of 8 640 at n = 6) and stablelm-3b's 1-layer cut (~329 000), 2 rounds
# each
TRACE_CASES = [("static", 6, {}), ("fading", 6, {}),
               ("fading", 64, {"degrade": "naive"}), ("fading", 256, {}),
               ("fading", 6, {"model_bits": 70 * 32768.0 - 100}),
               ("fading", 64, {"mac.max_retx_rounds": 0}),
               ("fading", 6, {"model_bits": 10_000 * 32768.0 - 100}),
               ("fading", 6, {"model_bits": "stablelm-3b, 1 layer"})]


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,kw", TRACE_CASES)
def test_trace_scan_kernel_matches_plain(sm90, name, n, kw):
    """One launch per trace; delivered, retx, w_eff and the counts (passes
    run, decodes decided) equal to the plain version's on the card and on
    the CPU, times within 1e-12 relative (the plain version's running sum
    is sequential on both devices, as the kernel's); the exact-path count
    is a small share of the decodes."""
    from repro_torch.sim import scenario, trace
    from repro_torch.sim.jit_trace import scan_inputs

    if isinstance(kw.get("model_bits"), str):
        kw = {"model_bits": _stablelm_one_layer_bits()}
    cfg = scenario.get_scenario(
        name, n_nodes=n, **({} if name == "static"
                            else {"fading.shadowing_sigma_db": 0.0}), **kw)
    arrays, args = scan_inputs(cfg, trace.WirelessSimulator(cfg))
    rounds = 2
    outs = []
    exact = torch.zeros(1, dtype=torch.int64, device=sm90)
    for dev in (sm90, sm90, torch.device("cpu")):
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        before = ts.round_scan.launches
        fn = ts.round_scan if not outs else ts.round_scan_plain
        extra = {} if outs else {"exact": exact}
        out = fn(*(torch.as_tensor(a, device=dev) for a in arrays),
                 n_rounds=rounds, counts=counts, **args, **extra)
        assert ts.round_scan.launches == before + (not outs)
        outs.append([x.cpu() for x in out] + [counts.cpu()])
    torch.cuda.synchronize()
    got = outs[0]
    for want in outs[1:]:
        for k in (0, 3, 4, 6):                # w_eff, delivered, retx, counts
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k
        for k in (1, 2, 5):                   # t_start, t_comm, t_end
            assert torch.allclose(got[k], want[k], rtol=1e-12, atol=0.0), k
    assert got[6][1] > 0
    assert 0 <= int(exact) <= max(10, int(got[6][1]) // 10_000)


@pytest.mark.cuda
def test_trace_scan_layout_matches_the_source(sm90):
    """``kernels.trace_scan._layout`` (the workspaces the wrapper
    allocates, ``smem_bytes``) equal to the compiled source's own
    (its host entry ``trace_scan_layout``), and bounded for every (n,
    P)."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.load("trace_scan").trace_scan_layout
    fn.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    fn.restype = None
    out = (ctypes.c_longlong * 4)()
    for n in (1, 6, 64, 256, 1024, 3276, 3277, 20_000, 30_000):
        for n_pkts in (1, 22, 64, 65, 70, 2048, 6600, 8641, 10_000, 329_000):
            fn(n, n_pkts, out)
            want = ts._layout(n, n_pkts)
            assert (int(out[0]), bool(out[1]), bool(out[2]), int(out[3])) \
                == want, (n, n_pkts)
            assert want[3] <= ts._SMEM_LIMIT


def _decide_cases(n):
    """(snr, rate) of every intended pair of ``fading`` at n nodes, and the
    bandwidth."""
    from repro_torch.sim import scenario, trace
    from repro_torch.sim.jit_trace import scan_inputs

    cfg = scenario.get_scenario("fading", n_nodes=n,
                                **{"fading.shadowing_sigma_db": 0.0})
    (rates, _, recv, chan, _), args = scan_inputs(
        cfg, trace.WirelessSimulator(cfg))
    i, j = np.nonzero(recv)
    return chan[i, j], rates[i], args["bandwidth_hz"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 64])
def test_trace_decide_filter_equals_exact_on_card(sm90, n):
    """The kernel's filtered decision equals its exact float64 code at m_lo
    - 1, m_lo, m_hi, m_hi + 1, inside the band and at uniform draws; the
    band's edges are where the path changes; outside the band the card's
    exact decision is the CPU's; the card's thresholds are the plain
    version's to one grid step."""
    snr, rate, bw = _decide_cases(n)
    k = len(snr)
    s, r = torch.from_numpy(snr).to(sm90), torch.from_numpy(rate).to(sm90)
    thr, *_ = ts.trace_decide(s, r, torch.zeros(k, dtype=torch.int64,
                                                 device=sm90),
                              bandwidth_hz=bw)
    thr = thr.cpu()
    want = ts.fade_thresholds_plain(torch.from_numpy(snr),
                                    torch.from_numpy(rate), bw)
    assert int((thr - want).abs().max()) <= 1
    lo, hi = thr[:, 0], thr[:, 1]
    gen = torch.Generator().manual_seed(n)
    cols = [lo - 1, lo, (lo + hi) // 2, hi, hi + 1,
            *torch.randint(0, 2**53, (64, k), generator=gen)]
    m = torch.stack(cols).clamp(0, 2**53 - 1)
    reps = m.shape[0]
    before = ts.trace_decide.launches
    thr2, filtered, exact, banded = (x.cpu() for x in ts.trace_decide(
        s.repeat(reps), r.repeat(reps), m.ravel().to(sm90), bandwidth_hz=bw))
    torch.cuda.synchronize()
    assert ts.trace_decide.launches == before + 1
    assert torch.equal(thr2, thr.repeat(reps, 1))
    assert torch.equal(filtered, exact)
    banded = banded.view(reps, k)
    assert not banded[[0, 4]].any() and banded[[1, 2, 3]].all()
    outside = ~banded.ravel()
    cpu = ts._exact_decode(m.ravel(), torch.from_numpy(snr).repeat(reps),
                           torch.from_numpy(rate).repeat(reps), bw)
    assert torch.equal(exact[outside], cpu[outside])


# ---------------------------------------------------------------------------
# The shape rules (data-free tensors: launch.dryrun) against the kernels
# ---------------------------------------------------------------------------

def _shape_rule_cases():
    bf, f32 = torch.bfloat16, torch.float32

    def r(*s, dt=f32, pos=False):
        x = torch.rand(s) + 0.1 if pos else torch.randn(s)
        return x.to(dt)
    q8 = torch.randint(-127, 128, (4, 4096)).to(torch.int8)
    sc = torch.rand(4, 2) + 0.1
    live = torch.tensor([True, False, True, True])
    return [
        ("flash bf16 lse", lambda q, k, v: fa._forward(q, k, v, True, 0,
                                                       True),
         (r(2, 96, 4, 64, dt=bf), r(2, 96, 2, 64, dt=bf),
          r(2, 96, 2, 64, dt=bf))),
        ("flash fp32 window", lambda q, k, v: fa.flash_attention(
            q, k, v, causal=True, window=16),
         (r(1, 70, 2, 24), r(1, 70, 1, 24), r(1, 70, 1, 24))),
        ("flash bwd bf16", lambda q, k, v, o, lse, do: fa.flash_attention_bwd(
            q, k, v, o, lse, do),
         (r(2, 80, 4, 64, dt=bf), r(2, 80, 2, 64, dt=bf),
          r(2, 80, 2, 64, dt=bf), r(2, 80, 4, 64, dt=bf), r(2, 4, 80),
          r(2, 80, 4, 64, dt=bf))),
        ("flash bwd fp32", lambda q, k, v, o, lse, do: fa.flash_attention_bwd(
            q, k, v, o, lse, do),
         (r(1, 40, 2, 16), r(1, 40, 2, 16), r(1, 40, 2, 16), r(1, 40, 2, 16),
          r(1, 2, 40), r(1, 40, 2, 16))),
        ("rows bf16", gm.gossip_mix_rows, (r(4, 4), r(4, 5000, dt=bf))),
        ("rows fp32 M != K", gm.gossip_mix_rows, (r(2, 4), r(4, 5000))),
        ("q8 rows", gm.gossip_mix_q8_rows, (r(4), r(4, 4), r(4, 4000), q8,
                                             sc)),
        ("q8 w", gm.gossip_mix_q8_w, (r(4, 4), r(4, 4000), q8, sc)),
        ("int8 round", gm.gossip_mix_int8_round, (r(4, 4000), r(4, 4000),
                                                  r(4, 4), live)),
        ("quantize 256", lambda x: qz.quantize_int8(x, 256), (r(4, 700),)),
        ("quantize 2048 bf16", lambda x: qz.quantize_int8(x, 2048),
         (r(4, 700, dt=bf),)),
        ("dequantize", lambda q, s: qz.dequantize_int8(q, s, 2048, 4000, bf),
         (q8, sc)),
        ("send", qz.quantize_int8_ef, (r(4, 4000), r(4, 4000), live)),
        ("rglru chained", rg.rglru_scan,
         (r(2, 100, 48, pos=True) * 0.5, r(2, 100, 48), r(2, 48))),
        ("rglru decode", rg.rglru_scan, (r(2, 1, 48, pos=True) * 0.5,
                                         r(2, 1, 48))),
        ("rglru bwd", rg.rglru_scan_bwd,
         (r(2, 100, 48, pos=True) * 0.5, r(2, 100, 48), r(2, 100, 48),
          r(2, 48))),
        ("rwkv6", rw.rwkv6_scan,
         (r(2, 40, 2, 64), r(2, 40, 2, 64), r(2, 40, 2, 64),
          r(2, 40, 2, 64, pos=True) * 0.5, r(2, 2, 64), r(2, 2, 64, 64))),
        ("rwkv6 bwd", rw.rwkv6_scan_bwd,
         (r(2, 40, 2, 64), r(2, 40, 2, 64), r(2, 40, 2, 64),
          r(2, 40, 2, 64, pos=True) * 0.5, r(2, 64), r(2, 40, 2, 64),
          r(2, 2, 64, 64), r(2, 2, 64, 64))),
    ]


def _record(fn, args, fake: bool):
    """Every operation ``fn(*args)`` dispatches, each with its outputs'
    (shape, dtype, strides): the outputs it makes and the scratch it
    allocates; and the call's own outputs. ``fake``: the same call on
    data-free tensors with the card as their fake device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def meta(t):
        return (tuple(t.shape), t.dtype, t.stride(), t.device.type)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            made = [meta(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            if made:        # not a query of metadata (a fake tensor's device)
                self.ops.append((str(func), made))
            return out

    if fake:
        with FakeTensorMode():
            xs = [torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                      device=x.device) for x in args]
            with Ops() as rec:
                out = fn(*xs)
    else:
        with Ops() as rec:
            out = fn(*args)
        torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    return rec.ops, [None if t is None else meta(t) for t in outs]


@pytest.mark.cuda
@pytest.mark.parametrize("name,fn,args", _shape_rule_cases(),
                         ids=[c[0] for c in _shape_rule_cases()])
def test_shape_rule_matches_the_kernel_on_the_card(sm90, name, fn, args):
    """On data-free tensors every wrapper runs its kernel path up to the
    launch: the same operations, so the same outputs and the same scratch
    (flash backward's fp32 rows, the scans' workspaces, the int8 round's
    payload) in shape, dtype and strides as the real call on the card,
    which launches where the shape rule notes a launch."""
    from repro_torch.kernels import counted_wrappers

    args = tuple(x.to(sm90) for x in args)
    before = [w.launches for w in counted_wrappers()]
    real_ops, real_out = _record(fn, args, fake=False)
    launched = [w.launches - n for w, n in zip(counted_wrappers(), before)]
    shaped = [w.dry_launches for w in counted_wrappers()]
    fake_ops, fake_out = _record(fn, args, fake=True)
    assert fake_out == real_out
    assert fake_ops == real_ops
    assert [w.dry_launches - n for w, n in
            zip(counted_wrappers(), shaped)] == launched
    assert sum(launched) >= 1
    assert [w.launches - n for w, n in zip(counted_wrappers(), before)] == \
        launched
