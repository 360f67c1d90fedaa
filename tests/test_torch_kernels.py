"""The port's kernels (gossip mix, flash attention, RG-LRU scan, RWKV-6
scan): plain versions against the JAX package's Pallas kernels (interpret
mode, through ``repro.kernels.ops``) and oracles, the shape contracts and
the per-call dispatch. The CUDA kernels themselves are held against their
plain versions on the card, in test_torch_kernels_card.py.

Tolerances follow tests/test_kernels.py: gossip fp32 1e-5, bf16 3e-2;
flash fp32 2e-5, bf16 3e-2; rglru 1e-4; rwkv6 5e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch

from repro.core.compression import quantize_int8 as jax_quantize_int8
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.rglru import linear_recurrence as jax_linear_recurrence
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked
from repro_torch.kernels import _backend, _build, gossip_mix as gm, ops, ref
from repro_torch.kernels import flash_attention as fa, rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _inputs(k, n, seed=0):
    rng = np.random.default_rng(seed)
    bufs = rng.normal(size=(k, n)).astype(np.float32)
    w = rng.random(k).astype(np.float32)
    return bufs, w / w.sum()


def _q8_inputs(k, n, seed=0):
    """K int8 payloads in the ``core.compression`` wire layout, quantized
    by the JAX package (so both sides see the same q and scales)."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(k, n)).astype(np.float32) * 4
    q = np.stack([np.asarray(jax_quantize_int8(jnp.asarray(r))[0]) for r in raw])
    s = np.stack([np.asarray(jax_quantize_int8(jnp.asarray(r))[1]) for r in raw])
    self_buf = rng.normal(size=n).astype(np.float32)
    w = rng.random(k + 1).astype(np.float32)
    return self_buf, q, s, w / w.sum()


@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("n", [100, 8192, 21_840])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gossip_mix_plain_matches_pallas(k, n, dtype):
    tdt, jdt = DTYPES[dtype]
    bufs, w = _inputs(k, n)
    want = jops.gossip_mix(jnp.asarray(bufs).astype(jdt), jnp.asarray(w))
    got = ops.gossip_mix(torch.from_numpy(bufs).to(tdt), torch.from_numpy(w))
    assert got.dtype == tdt and got.shape == (n,)
    assert _err(got, want) < TOL[dtype]
    oracle = ref.gossip_mix_ref(torch.from_numpy(bufs).to(tdt),
                                torch.from_numpy(w))
    assert _err(oracle, jref.gossip_mix_ref(jnp.asarray(bufs).astype(jdt),
                                            jnp.asarray(w))) < TOL[dtype]


@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gossip_mix_rows_plain_matches_pallas_per_row(k, dtype):
    """Row m of the rows form is the TPU kernel with weights W[m]."""
    tdt, jdt = DTYPES[dtype]
    n = 21_840
    bufs, _ = _inputs(k, n, seed=k)
    w = np.random.default_rng(k).random((4, k)).astype(np.float32)
    got = gm.gossip_mix_rows(torch.from_numpy(w), torch.from_numpy(bufs).to(tdt))
    assert got.dtype == tdt and got.shape == (4, n)
    for m in range(4):
        want = jops.gossip_mix(jnp.asarray(bufs).astype(jdt), jnp.asarray(w[m]))
        assert _err(got[m], want) < TOL[dtype]


@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("n", [100, 8192, 21_840])
@pytest.mark.parametrize("self_dtype", ["float32", "bfloat16"])
def test_gossip_mix_q8_plain_matches_pallas(k, n, self_dtype):
    tdt, jdt = DTYPES[self_dtype]
    self_buf, q, s, w = _q8_inputs(k, n)
    want = jops.gossip_mix_q8(jnp.asarray(self_buf).astype(jdt),
                              jnp.asarray(q), jnp.asarray(s), jnp.asarray(w))
    args = (torch.from_numpy(self_buf).to(tdt), torch.from_numpy(q),
            torch.from_numpy(s), torch.from_numpy(w))
    got = ops.gossip_mix_q8(*args)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert _err(got, want) < 1e-5
    assert _err(ref.gossip_mix_q8_ref(*args), jref.gossip_mix_q8_ref(
        jnp.asarray(self_buf).astype(jdt), jnp.asarray(q), jnp.asarray(s),
        jnp.asarray(w))) < 1e-5


@pytest.mark.parametrize("k", [1, 3, 9])
def test_gossip_mix_q8_rows_plain_matches_pallas_per_row(k):
    """The D-PSGD receive: row m = the TPU kernel with self weight
    w_self[m] and payload weights W_off[m]."""
    n = 21_840
    _, q, s, _ = _q8_inputs(k, n, seed=k)
    rng = np.random.default_rng(k)
    x = rng.normal(size=(k, n)).astype(np.float32)
    w = rng.random((k, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    w_self = np.diag(w).copy()
    w_off = w - np.diag(w_self)
    got = gm.gossip_mix_q8_rows(torch.from_numpy(w_self), torch.from_numpy(w_off),
                                torch.from_numpy(x), torch.from_numpy(q),
                                torch.from_numpy(s))
    assert got.shape == (k, n) and got.dtype == torch.float32
    for m in range(k):
        wm = np.concatenate([w_self[m:m + 1], w_off[m]])
        want = jops.gossip_mix_q8(jnp.asarray(x[m]), jnp.asarray(q),
                                  jnp.asarray(s), jnp.asarray(wm))
        assert _err(got[m], want) < 1e-5


def test_gossip_mix_q8_value_errors():
    """The three contracts of repro/kernels/gossip_mix.py:143-153, raised
    before any launch."""
    q = torch.zeros((2, 4096), dtype=torch.int8)
    with pytest.raises(ValueError, match="weights"):
        ops.gossip_mix_q8(torch.zeros(100), q, torch.ones((2, 2)),
                          torch.ones(4) / 4)
    with pytest.raises(ValueError, match="scale"):
        ops.gossip_mix_q8(torch.zeros(100), q, torch.ones((2, 3)),
                          torch.ones(3) / 3)
    with pytest.raises(ValueError, match="shorter"):
        ops.gossip_mix_q8(torch.zeros(9000), q, torch.ones((2, 2)),
                          torch.ones(3) / 3)
    with pytest.raises(ValueError, match="weights"):
        gm.gossip_mix_q8_rows(torch.ones(3), torch.ones(3, 3),
                              torch.zeros(3, 100), q, torch.ones((2, 2)))
    with pytest.raises(ValueError, match="weights"):
        ops.gossip_mix(torch.zeros(3, 10), torch.ones(2))
    with pytest.raises(ValueError, match="bufs"):
        gm.gossip_mix_rows(torch.ones(2, 3), torch.zeros(2, 10))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gm.gossip_mix_rows(torch.ones(2, 2), torch.zeros(2, 10,
                                                          dtype=torch.float64))


def test_dispatch_cpu_takes_plain_version_and_counts_no_launch():
    gm.gossip_mix_rows.launches = gm.gossip_mix_q8_rows.launches = 0
    bufs, w = _inputs(3, 500)
    ops.gossip_mix(torch.from_numpy(bufs), torch.from_numpy(w))
    self_buf, q, s, wq = _q8_inputs(2, 500)
    ops.gossip_mix_q8(torch.from_numpy(self_buf), torch.from_numpy(q),
                      torch.from_numpy(s), torch.from_numpy(wq))
    assert gm.gossip_mix_rows.launches == 0
    assert gm.gossip_mix_q8_rows.launches == 0
    assert _backend.use_kernel(torch.device("cpu")) is False


def test_dispatch_probes_capability_per_call(monkeypatch):
    """Like test_kernels.py's interpret test: the probe follows the live
    device on every call, and a CUDA device below sm_90 raises."""
    cuda0 = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))
    assert _backend.use_kernel(cuda0) is True
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (8, 0))
    with pytest.raises(RuntimeError, match="capability"):
        _backend.use_kernel(cuda0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))
    assert _backend.use_kernel(cuda0) is True        # re-evaluated per call


def test_non_cpu_tensor_never_falls_back_to_plain():
    """A tensor off the CPU gets the kernel or an error; here a ``meta``
    tensor, which no kernel takes, must raise rather than run plain."""
    with pytest.raises(RuntimeError, match="device type"):
        gm.gossip_mix_rows(torch.ones(2, 2, device="meta"),
                           torch.ones(2, 10, device="meta"))
    with pytest.raises(RuntimeError, match="device type"):
        gm.gossip_mix_q8_rows(torch.ones(1, device="meta"),
                              torch.ones(1, 2, device="meta"),
                              torch.ones(1, 100, device="meta"),
                              torch.zeros(2, 2048, dtype=torch.int8,
                                          device="meta"),
                              torch.ones(2, 1, device="meta"))
    assert gm.gossip_mix_rows.launches == 0


def test_build_names_library_after_source_hash_and_needs_nvcc(monkeypatch,
                                                              tmp_path):
    src, so = _build._target("gossip_mix")
    assert src.name == "gossip_mix.cu" and src.exists()
    assert so.parent == _build.BUILD_DIR and so.name.startswith("gossip_mix-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("gossip_mix")
    assert not (tmp_path / "build").exists()


# ---------------------------------------------------------------------------
# Flash attention and the RG-LRU scan
# ---------------------------------------------------------------------------

FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32)
                 for h in (hq, hkv, hkv))


@pytest.mark.parametrize("s,hq,hkv,d", [
    (64, 4, 4, 32),    # MHA
    (80, 4, 2, 32),    # GQA, ragged seq
    (96, 8, 1, 16),    # MQA
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
def test_flash_attention_plain_matches_pallas(s, hq, hkv, d, causal, window):
    """The grid of tests/test_kernels.py:78-93: the plain version against
    the Pallas kernel (interpret mode) and both oracles."""
    q, k, v = _qkv(2, s, hq, hkv, d)
    want = jops.flash_attention_gqa(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, bq=32, bk=32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ops.flash_attention_gqa(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (2, s, hq, d) and got.dtype == torch.float32
    assert _err(got, want) < FLASH_TOL["float32"]
    oracle = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert _err(got, oracle) < FLASH_TOL["float32"]
    assert _err(oracle, jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window)) < FLASH_TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_dtypes(dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v = _qkv(1, 64, 2, 2, 32, seed=1)
    want = jops.flash_attention_gqa(*(jnp.asarray(x).astype(jdt)
                                      for x in (q, k, v)), bq=32, bk=32)
    got = ops.flash_attention_gqa(*(torch.from_numpy(x).to(tdt)
                                    for x in (q, k, v)))
    assert got.dtype == tdt
    assert _err(got, want) < FLASH_TOL[dtype]


def test_flash_attention_plain_skips_out_of_band_blocks_exactly():
    """A long sequence against a short window: the plain version's band
    (the kernel's) gives the full masked softmax, rows past the first
    plain block included."""
    q, k, v = _qkv(1, 600, 2, 1, 16, seed=2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = fa.flash_attention_plain(tq, tk, tv, causal=True, window=40)
    want = ref.flash_attention_ref(tq, tk, tv, causal=True, window=40)
    assert _err(got, want) < FLASH_TOL["float32"]


def test_flash_attention_positions_must_start_at_zero():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 1, 16))
    ops.flash_attention_gqa(q, k, v, positions=torch.arange(8))
    with pytest.raises(ValueError, match="arange"):
        ops.flash_attention_gqa(q, k, v, positions=torch.arange(8) + 3)


def test_flash_attention_contracts():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="Hq % Hkv"):
        fa.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="need q"):
        fa.flash_attention(q[0], k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.double(), k.double(), v.double())


@pytest.mark.parametrize("d,dtype,entry", [
    (20, torch.bfloat16, None), (36, torch.bfloat16, None),
    (320, torch.float32, None), (20, torch.float32, "flash_attention_f32"),
    (80, torch.bfloat16, "flash_attention_bf16"),
    (256, torch.bfloat16, "flash_attention_bf16")])
def test_flash_attention_kernel_path_head_dims(monkeypatch, d, dtype, entry):
    """On the kernel path (dispatch patched to the card's answer, the launch
    recorded instead of made): bf16 takes D % 8 == 0 up to 256 on the
    tensor-core entry, fp32 any D up to 256 on the CUDA-core one; any other
    head_dim raises ValueError naming it before any launch."""
    launched = []
    monkeypatch.setattr(fa, "use_kernel", lambda dev: True)
    monkeypatch.setattr(fa._build, "launch",
                        lambda name, e, *args: launched.append(e))
    q = torch.zeros((1, 8, 2, d), dtype=dtype)
    kv = torch.zeros((1, 8, 1, d), dtype=dtype)
    before = fa.flash_attention.launches
    if entry is None:
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(q, kv, kv)
        assert launched == [] and fa.flash_attention.launches == before
    else:
        fa.flash_attention(q, kv, kv)
        assert launched == [entry]
        assert fa.flash_attention.launches == before + 1


def test_flash_attention_bf16_kernel_path_needs_16_byte_alignment(
        monkeypatch):
    monkeypatch.setattr(fa, "use_kernel", lambda dev: True)
    monkeypatch.setattr(fa._build, "launch", lambda *args: pytest.fail(
        "launched a misaligned operand"))
    store = torch.zeros(2 * 8 * 64 + 1, dtype=torch.bfloat16)
    q = store[1:].view(1, 8, 2, 64)        # 2 bytes off 16-byte alignment
    kv = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(q, kv, kv)


def _ab(b, s, d, seed=0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.normal(size=(b, s, d))))
    return (a.astype(np.float32), rng.normal(size=(b, s, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32))


@pytest.mark.parametrize("s,d", [(64, 128), (100, 256), (32, 64), (1, 100)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_plain_matches_pallas_and_model(s, d, with_h0):
    """tests/test_kernels.py:127-147: the plain version against the Pallas
    kernel, the sequential oracle and the model's associative scan."""
    a, b, h0 = _ab(2, s, d, seed=s + d)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = ops.rglru(ta, tb, th0)
    assert got.shape == (2, s, d) and got.dtype == torch.float32
    assert _err(got, jops.rglru(jnp.asarray(a), jnp.asarray(b), jh0,
                                chunk=32)) < 1e-4
    jwant = jax_linear_recurrence(jnp.asarray(a), jnp.asarray(b), jh0)
    assert _err(got, jwant) < 1e-4
    oracle = ref.rglru_ref(ta, tb, th0)
    assert _err(got, oracle) < 1e-4
    assert _err(oracle, jref.rglru_ref(jnp.asarray(a), jnp.asarray(b),
                                       jh0)) < 1e-4


def test_rglru_contracts():
    a = torch.ones(2, 5, 8)
    with pytest.raises(ValueError, match="one shape"):
        rg.rglru_scan(a, torch.ones(2, 5, 7))
    with pytest.raises(ValueError, match="h0"):
        rg.rglru_scan(a, a, torch.ones(2, 7))


def _launch_counts():
    return (fa.flash_attention.launches, rg.rglru_scan.launches,
            rw.rwkv6_scan.launches)


def test_new_kernels_dispatch_cpu_to_plain_and_never_fall_back():
    fa.flash_attention.launches = rg.rglru_scan.launches = 0
    rw.rwkv6_scan.launches = 0
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 1, 16))
    ops.flash_attention_gqa(q, k, v)
    a, b, h0 = (torch.from_numpy(x) for x in _ab(1, 4, 8))
    ops.rglru(a, b, h0)
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in _rkvw(1, 4, 2, 8))
    ops.rwkv6(r, k, v, w, u, s0=s0)
    assert _launch_counts() == (0, 0, 0)
    meta = {"device": "meta"}
    with pytest.raises(RuntimeError, match="device type"):
        fa.flash_attention(torch.ones(1, 8, 2, 16, **meta),
                           torch.ones(1, 8, 1, 16, **meta),
                           torch.ones(1, 8, 1, 16, **meta))
    with pytest.raises(RuntimeError, match="device type"):
        rg.rglru_scan(torch.ones(1, 4, 8, **meta), torch.ones(1, 4, 8, **meta))
    with pytest.raises(RuntimeError, match="device type"):
        rw.rwkv6_scan(*(torch.ones(1, 4, 2, 8, **meta) for _ in range(4)),
                      torch.ones(2, 8, **meta))
    assert _launch_counts() == (0, 0, 0)


@pytest.mark.parametrize("kernel", ["flash", "rglru", "rwkv6"])
def test_new_kernels_raise_below_sm90(monkeypatch, kernel):
    """The wrappers' dispatch, asked about a CUDA device below (9, 0),
    raises before any launch (the probe is patched; the host tensors are
    never touched)."""
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (8, 0))
    cuda0 = torch.device("cuda", 0)
    before = _launch_counts()
    for mod in (fa, rg, rw):
        monkeypatch.setattr(mod, "use_kernel",
                            lambda dev: _backend.use_kernel(cuda0))
    with pytest.raises(RuntimeError, match="capability"):
        if kernel == "flash":
            q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 1, 16))
            fa.flash_attention(q, k, v)
        elif kernel == "rglru":
            a, b, _ = (torch.from_numpy(x) for x in _ab(1, 4, 8))
            rg.rglru_scan(a, b)
        else:
            r, k, v, w, u, _ = (torch.from_numpy(x)
                                for x in _rkvw(1, 4, 2, 8))
            rw.rwkv6_scan(r, k, v, w, u)
    assert _launch_counts() == before


def test_build_lists_every_source_and_names_each_library():
    assert _build.SOURCES == ("gossip_mix", "flash_attention", "rglru_scan",
                              "rwkv6_scan", "quantize")
    libs = set()
    for name in _build.SOURCES:
        src, so = _build._target(name)
        assert src.exists() and so.name.startswith(f"{name}-")
        libs.add(so.name)
    assert len(libs) == 5


# ---------------------------------------------------------------------------
# The RWKV-6 scan
# ---------------------------------------------------------------------------

RWKV_TOL = 5e-4     # tests/test_kernels.py:117-118


def _rkvw(b, s, h, d, seed=0):
    """Inputs drawn as tests/test_kernels.py:110-114 draws them, plus an
    initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(b, s, h, d)) * 0.5)).astype(np.float32)
    u = (rng.normal(size=(h, d)) * 0.1).astype(np.float32)
    s0 = rng.normal(size=(b, h, d, d)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("s,h,d,chunk", [(40, 2, 16, 16), (128, 4, 32, 32),
                                         (33, 1, 8, 16), (1, 2, 16, 16)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_plain_matches_pallas_and_oracles(s, h, d, chunk, with_s0):
    """tests/test_kernels.py:106-118's grid plus S = 1: the plain version
    against the Pallas kernel (interpret mode; it starts from zero, so with
    s0 the JAX model's chunked form stands in for it), the sequential
    oracle, and the JAX package's oracle."""
    r, k, v, w, u, s0 = _rkvw(2, s, h, d, seed=s + d)
    js0 = jnp.asarray(s0) if with_s0 else None
    ts0 = torch.from_numpy(s0) if with_s0 else None
    jargs = tuple(jnp.asarray(x) for x in (r, k, v, w, u))
    targs = tuple(torch.from_numpy(x) for x in (r, k, v, w, u))
    y, st = ops.rwkv6(*targs, chunk=chunk, s0=ts0)
    assert y.shape == (2, s, h, d) and y.dtype == torch.float32
    assert st.shape == (2, h, d, d) and st.dtype == torch.float32
    if with_s0:
        jy, jst = jax_wkv_chunked(*jargs, js0, chunk=chunk)
    else:
        jy, jst = jops.rwkv6(*jargs, chunk=chunk)
    assert _err(y, jy) < RWKV_TOL and _err(st, jst) < RWKV_TOL
    oy, ost = ref.rwkv6_ref(*targs, ts0)
    assert _err(y, oy) < RWKV_TOL and _err(st, ost) < RWKV_TOL
    jy, jst = jref.rwkv6_ref(*jargs, js0)
    assert _err(oy, jy) < RWKV_TOL and _err(ost, jst) < RWKV_TOL


@pytest.mark.parametrize("case", ["shapes", "u", "s0 shape", "s0 dtype",
                                  "wide head", "ragged head"])
def test_rwkv6_contracts(case):
    """The kernel's ValueError contracts, raised before any dispatch (so
    the same on the CPU as on the card)."""
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in _rkvw(1, 4, 2, 16))
    args, match = {
        "shapes": ((r, k[:, :3], v, w, u), "one shape"),
        "u": ((r, k, v, w, u[:1]), "u must be"),
        "s0 shape": ((r, k, v, w, u, s0[..., :8]), "s0 must be"),
        "s0 dtype": ((r, k, v, w, u, s0.to(torch.bfloat16)), "float32"),
        "wide head": ((*(torch.ones(1, 2, 1, 136) for _ in range(4)),
                       torch.ones(1, 136)), "head size"),
        "ragged head": ((*(torch.ones(1, 2, 1, 12) for _ in range(4)),
                         torch.ones(1, 12)), "head size"),
    }[case]
    before = rw.rwkv6_scan.launches
    with pytest.raises(ValueError, match=match):
        rw.rwkv6_scan(*args)
    assert rw.rwkv6_scan.launches == before


# ---------------------------------------------------------------------------
# No backward kernel yet: the kernel path refuses inputs that need a gradient
# ---------------------------------------------------------------------------

def _grad_cases():
    """(wrapper, its module, a call with the input named last requiring
    grad) for every kernel wrapper, at tiny shapes."""
    from repro_torch.kernels import quantize as qz
    q8 = torch.zeros((2, 2048), dtype=torch.int8)
    return {
        "gossip_mix_rows": (gm.gossip_mix_rows, gm, lambda g: gm.gossip_mix_rows(
            torch.ones(2, 3), torch.ones(3, 16, requires_grad=g))),
        "gossip_mix_q8_rows": (gm.gossip_mix_q8_rows, gm,
                               lambda g: gm.gossip_mix_q8_rows(
            torch.ones(2), torch.ones(2, 2), torch.ones(2, 16, requires_grad=g),
            q8, torch.ones(2, 1))),
        "quantize_int8": (qz.quantize_int8, qz, lambda g: qz.quantize_int8(
            torch.ones(2, 300, requires_grad=g), 256)),
        "dequantize_int8": (qz.dequantize_int8, qz, lambda g: qz.dequantize_int8(
            q8, torch.ones(2, 1, requires_grad=g), 2048)),
        "flash_attention": (fa.flash_attention, fa, lambda g: fa.flash_attention(
            torch.zeros(1, 8, 2, 16, requires_grad=g), torch.zeros(1, 8, 1, 16),
            torch.zeros(1, 8, 1, 16))),
        "rglru_scan": (rg.rglru_scan, rg, lambda g: rg.rglru_scan(
            torch.ones(1, 4, 8), torch.ones(1, 4, 8, requires_grad=g))),
        "rwkv6_scan": (rw.rwkv6_scan, rw, lambda g: rw.rwkv6_scan(
            *(torch.ones(1, 4, 2, 8) for _ in range(4)),
            torch.ones(2, 8, requires_grad=g))),
    }


@pytest.mark.parametrize("name", list(_grad_cases()))
def test_kernel_path_refuses_inputs_that_need_a_gradient(monkeypatch, name):
    """On the kernel path (dispatch patched to the card's answer, the
    launch recorded instead of made) a wrapper raises before any launch
    when autograd is on and an input requires grad: its output, filled
    through ctypes, would silently carry no grad_fn. Under no_grad, or
    with inputs that need none, it launches as before."""
    wrapper, mod, call = _grad_cases()[name]
    launched = []
    monkeypatch.setattr(mod, "use_kernel", lambda dev: True)
    monkeypatch.setattr(mod._build, "launch",
                        lambda name, e, *args: launched.append(e))
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    assert launched == [] and wrapper.launches == before
    with torch.no_grad():
        call(True)
    call(False)
    assert len(launched) == 2 and wrapper.launches == before + 2
