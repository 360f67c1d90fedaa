"""The CUDA kernels (gossip mix, flash attention in fp32 and on the
tensor cores in bf16, RG-LRU scan, RWKV-6 scan, int8 quantize / dequantize)
against their plain torch versions, and the D-PSGD steps as CUDA graphs
against their eager bodies, on an sm_90 card (every test here skips
without one).

Imports neither ``jax`` nor ``repro``, so it runs on a machine with only
PyTorch:  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_card.py

Tolerances follow tests/test_kernels.py: gossip fp32 1e-5, bf16 3e-2;
flash fp32 2e-5, bf16 3e-2; rglru 1e-4; rwkv6 5e-4. bf16 flash is also
held row by row, ||got - want|| <= 2^-6 ||want|| for each output row (one
query, one head), as chip_smoke.py holds it: rows that attend to many keys
are far smaller than 3e-2, and losing one key of 2048 moves a row by ~0.022
of its norm. The int8 codec is
bit-equal: q, scales and the dequantized output ``torch.equal`` (finite
inputs).
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
                                           (2, 600, 256, True)])
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
    adds what the capture saw: one quantize, one dequantize and one q8
    receive per int8 round."""
    build, _ = _graph_cases()["compressed"]
    from repro_torch.core import dpsgd

    step = build()
    params, batch, w = _step_inputs(6, seed=0, device=sm90)
    live = torch.ones(6, dtype=torch.bool, device=sm90)
    res = dpsgd.zero_residuals(params)
    counters = (qz.quantize_int8, qz.dequantize_int8, gm.gossip_mix_q8_rows,
                gm.gossip_mix_rows)
    before = [f.launches for f in counters]
    step.prepare(params, batch, w, live, res)
    assert [f.launches for f in counters] == before
    for r in range(1, 4):
        params, res, _ = step(params, batch, w, live, res)
        assert [f.launches - b for f, b in zip(counters, before)] == \
            [r, r, r, 0]


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
