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
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

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


@pytest.mark.parametrize("k", [1, 3, 6, 9])
@pytest.mark.parametrize("n", [100, 21_840, 21_843])
def test_gossip_mix_q8_w_plain_matches_pallas_per_row(k, n):
    """The int8 round's receive with W (K, K) taken whole: row m is the
    Pallas kernel (interpret mode) with weights [W[m, m], W[m, 0..K-1]] and
    0 for the payload on the diagonal, at 1e-5."""
    _, q, s, _ = _q8_inputs(k, n, seed=k + n)
    rng = np.random.default_rng(k * n)
    x = rng.normal(size=(k, n)).astype(np.float32)
    w = rng.random((k, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    got = gm.gossip_mix_q8_w(torch.from_numpy(w), torch.from_numpy(x),
                             torch.from_numpy(q), torch.from_numpy(s))
    assert got.shape == (k, n) and got.dtype == torch.float32
    for m in range(k):
        wm = np.concatenate([w[m, m:m + 1], np.where(np.arange(k) == m, 0.0,
                                                     w[m]).astype(np.float32)])
        want = jops.gossip_mix_q8(jnp.asarray(x[m]), jnp.asarray(q),
                                  jnp.asarray(s), jnp.asarray(wm))
        assert _err(got[m], want) < 1e-5


def _record_launches(monkeypatch):
    """Patch the q8 and the send wrappers onto the kernel path and record
    each launch (entry, arguments) instead of making it."""
    from repro_torch.kernels import quantize as qz
    launched = []
    for mod in (gm, qz):
        monkeypatch.setattr(mod, "use_kernel", lambda dev: True)
    monkeypatch.setattr(gm._build, "launch",
                        lambda name, entry, types, dev, *a:
                        launched.append((entry, a)))
    return launched


def test_gossip_mix_q8_forms_pass_the_entry_their_weight_layout(monkeypatch):
    """On the kernel path (dispatch patched, launches recorded): W whole
    passes W as both weight pointers, the diagonal's stride n + 1, row
    stride n and the diagonal skipped; the rows form its two tensors at
    stride 1 and row stride K; the TPU signature (M = 1) the weights and
    the weights one element on. None asks for the loads ahead of the
    grid-dependency wait. Each counts one q8 launch."""
    launched = _record_launches(monkeypatch)
    before = gm.gossip_mix_q8_rows.launches
    k, n = 4, 3000
    _, q, s, wq = (torch.from_numpy(a) for a in _q8_inputs(k, n))
    x = torch.randn(k, n)
    w = torch.softmax(torch.randn(k, k), -1)
    gm.gossip_mix_q8_w(w, x, q, s)
    w_self, w_off = torch.diagonal(w).contiguous(), w.clone()
    gm.gossip_mix_q8_rows(w_self, w_off, x, q, s)
    gm.gossip_mix_q8(x[0], q, s, wq)
    assert [e for e, _ in launched] == ["gossip_mix_q8_rows"] * 3
    whole, rows, tpu = (a for _, a in launched)
    assert whole[:5] == (w.data_ptr(), k + 1, w.data_ptr(), k, 1)
    assert whole[5:7] == (x.data_ptr(), q.data_ptr())
    assert whole[9:] == (k, k, n, q.shape[1], 0)
    assert rows[:5] == (w_self.data_ptr(), 1, w_off.data_ptr(), k, 0)
    assert rows[-1] == 0
    assert tpu[0] == wq.data_ptr() and tpu[2] == wq.data_ptr() + 4
    assert tpu[4] == 0 and tpu[9:] == (1, k, n, q.shape[1], 0)
    assert gm.gossip_mix_q8_rows.launches == before + 3


def test_int8_round_launches_the_send_then_the_receive(monkeypatch):
    """The round on the kernel path: the send, then the receive on the
    send's own outputs with W whole, the loads ahead of the wait asked for
    and nothing launched between them; a W the round cannot take raises
    before either launch."""
    launched = _record_launches(monkeypatch)
    n, length = 5, 3000
    flat, res = torch.randn(n, length), torch.randn(n, length) * 1e-3
    live = torch.arange(n) != 2
    w = torch.softmax(torch.randn(n, n, dtype=torch.float64), -1)
    with pytest.raises(ValueError, match="square"):
        gm.gossip_mix_int8_round(flat, res, w[:, :4], live)
    with pytest.raises(ValueError, match="square"):
        gm.gossip_mix_int8_round(flat, res, w[:4, :4], live)
    assert launched == []
    mixed, new_res = gm.gossip_mix_int8_round(flat, res, w, live, False)
    (send, s_args), (recv, r_args) = launched
    assert (send, recv) == ("quantize_int8_ef_f32_b2048", "gossip_mix_q8_rows")
    assert s_args[0] == flat.data_ptr() and s_args[-3:] == (n, length, 0)
    q_ptr, scales_ptr, res_ptr = s_args[3:6]
    assert res_ptr == new_res.data_ptr()
    assert r_args[0] == r_args[2] and r_args[1] == n + 1 and r_args[3] == n
    assert r_args[5:8] == (flat.data_ptr(), q_ptr, scales_ptr)
    assert r_args[8] == mixed.data_ptr() and r_args[-1] == 1


def test_int8_round_checks_devices_before_the_send(monkeypatch):
    """On the kernel path, a W or live mask on another device than flat
    raises before the send launches (the receive would raise only after
    it)."""
    launched = _record_launches(monkeypatch)
    n, length = 3, 300
    flat, res = torch.randn(n, length), torch.zeros(n, length)
    live, w = torch.ones(n, dtype=torch.bool), torch.ones(n, n) / n
    with pytest.raises(ValueError, match="w is on meta"):
        gm.gossip_mix_int8_round(flat, res, w.to("meta"), live)
    with pytest.raises(ValueError, match="live is on meta"):
        gm.gossip_mix_int8_round(flat, res, w, live.to("meta"))
    assert launched == []


def test_gossip_mix_q8_w_contracts():
    """W must be square and match the payload count; the payload contract
    of the rows form; all before any launch."""
    q = torch.zeros((2, 2048), dtype=torch.int8)
    x, s = torch.zeros(2, 100), torch.ones(2, 1)
    before = gm.gossip_mix_q8_rows.launches
    with pytest.raises(ValueError, match="square"):
        gm.gossip_mix_q8_w(torch.ones(2, 3), x, q, s)
    with pytest.raises(ValueError, match="square"):
        gm.gossip_mix_q8_w(torch.ones(3, 3), torch.zeros(3, 100), q, s)
    with pytest.raises(ValueError, match="scale"):
        gm.gossip_mix_q8_w(torch.ones(2, 2), x, q, torch.ones(2, 2))
    with pytest.raises(ValueError, match="shorter"):
        gm.gossip_mix_q8_w(torch.ones(2, 2), torch.zeros(2, 3000), q, s)
    with pytest.raises(TypeError, match="int8"):
        gm.gossip_mix_q8_w(torch.ones(2, 2), x, q.float(), s)
    assert gm.gossip_mix_q8_rows.launches == before


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


@pytest.mark.parametrize("d,dtype,entry", [
    (16, torch.bfloat16, "flash_attention_bwd_bf16"),
    (80, torch.bfloat16, "flash_attention_bwd_bf16"),
    (256, torch.bfloat16, "flash_attention_bwd_bf16"),
    (20, torch.float32, "flash_attention_bwd_f32"),
    (20, torch.bfloat16, None), (320, torch.float32, None)])
def test_flash_attention_bwd_kernel_path_head_dims(monkeypatch, d, dtype,
                                                   entry):
    """On the kernel path (dispatch patched to the card's answer, the
    launch recorded instead of made) the backward takes the forward's head
    dims: one launch of its dtype's entry with (B, S, T, Hq, Hkv, D) after
    the ten pointers, or ValueError naming head_dim and no launch."""
    launched = []
    monkeypatch.setattr(fa, "use_kernel", lambda dev: True)
    monkeypatch.setattr(fa._build, "launch",
                        lambda name, e, argtypes, dev, *args:
                        launched.append((e, args)))
    q, o, do = (torch.zeros((2, 70, 4, d), dtype=dtype) for _ in range(3))
    k, v = (torch.zeros((2, 33, 2, d), dtype=dtype) for _ in range(2))
    lse = torch.zeros((2, 4, 70))
    before = fa.flash_attention_bwd.launches
    if entry is None:
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_bwd(q, k, v, o, lse, do)
        assert launched == [] and fa.flash_attention_bwd.launches == before
        return
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert [e for e, _ in launched] == [entry]
    assert launched[0][1][10:16] == (2, 70, 33, 4, 2, d)
    assert fa.flash_attention_bwd.launches == before + 1


@pytest.mark.parametrize("operand", ["q", "k", "v", "o", "do"])
def test_flash_attention_bwd_bf16_kernel_path_needs_16_byte_alignment(
        monkeypatch, operand):
    """The bf16 backward reads q, k, v and do through TMA and o and do with
    16-byte loads: any of them 2 bytes off alignment raises, no launch."""
    monkeypatch.setattr(fa, "use_kernel", lambda dev: True)
    monkeypatch.setattr(fa._build, "launch", lambda *args: pytest.fail(
        "launched a misaligned operand"))
    x = {n: torch.zeros((1, 8, 2 if n in ("k", "v") else 4, 64),
                        dtype=torch.bfloat16) for n in ("q", "k", "v", "o",
                                                        "do")}
    store = torch.zeros(x[operand].numel() + 1, dtype=torch.bfloat16)
    x[operand] = store[1:].view(x[operand].shape)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_bwd(x["q"], x["k"], x["v"], x["o"],
                               torch.zeros((1, 4, 8)), x["do"])


# The card tests' backward shapes that the bf16 tensor-core path takes (D <=
# 128; tests/test_torch_kernels_card.py _BWD_SHAPES): (B, S, T, Hq, Hkv, D,
# causal, window)
_BWD_TC_SHAPES = [
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


def _bwd_bf16_inputs(b, s, t, hq, hkv, d, causal, window):
    """bf16 q, k, v, do drawn with numpy, and the plain forward's o, lse."""
    rng = np.random.default_rng(s + t + d)
    q, do = (torch.from_numpy(rng.normal(size=(b, s, hq, d)).astype(
        np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, t, hkv, d)).astype(
        np.float32)).bfloat16() for _ in range(2))
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    return q, k, v, o, lse, do


def _bwd_tensor_core_arithmetic(q, k, v, o, lse, do, causal, window, terms):
    """The bf16 tensor-core backward's arithmetic, written out in torch:
    bf16 inputs read exactly, every sum in fp32 (delta, S, dP and the three
    D-side products), P = exp(S D^-1/2 - lse) and dS = P (dP - delta) in
    fp32; P and dS enter dv = P^T do, dk = D^-1/2 dS^T q and dq = D^-1/2
    dS k as ``terms`` bf16 numbers each (1: rounded to bf16; 2: the
    kernel's hi = bf16(x) plus lo = bf16(x - hi)); the gradients rounded to
    bf16 once."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    f32 = torch.float32
    qf = q.to(f32).reshape(b, s, hkv, g, d)
    dof = do.to(f32).reshape(b, s, hkv, g, d)
    kf, vf = k.to(f32), v.to(f32)
    delta = (dof * o.to(f32).reshape(b, s, hkv, g, d)).sum(-1)
    scores = torch.einsum("bshgd,bthd->bshgt", qf, kf) * d**-0.5
    live = fa._mask(0, s, 0, t, causal, window, q.device)
    p = torch.exp(scores - lse.permute(0, 2, 1).reshape(b, s, hkv, g)[
        ..., None]).masked_fill(~live[None, :, None, None, :], 0.0)
    dp = torch.einsum("bshgd,bthd->bshgt", dof, vf)
    ds = p * (dp - delta[..., None])

    def split(x):
        hi = x.bfloat16().float()
        return (hi,) if terms == 1 else (hi, (x - hi).bfloat16().float())
    dv = sum(torch.einsum("bshgt,bshgd->bthd", x, dof) for x in split(p))
    dk = sum(torch.einsum("bshgt,bshgd->bthd", x, qf) for x in split(ds))
    dq = sum(torch.einsum("bshgt,bthd->bshgd", x, kf) for x in split(ds))
    return (dq.reshape(b, s, hq, d).mul(d**-0.5).bfloat16(),
            dk.mul(d**-0.5).bfloat16(), dv.bfloat16())


def _bwd_errors(got, want, causal):
    """Per gradient: max |got - want| and the worst row's ||got - want|| /
    ||want|| (dq's first query under a causal mask, which has one live key
    and a gradient of 0 exactly, held by the absolute error only, as the
    card tests hold it)."""
    out = {}
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        first = 1 if name == "dq" and causal else 0
        a = g_[:, first:].double().flatten(0, -2)
        b = w_[:, first:].double().flatten(0, -2)
        out[name] = (float((g_.double() - w_.double()).abs().max()),
                     float(((a - b).norm(dim=-1) /
                            b.norm(dim=-1).clamp_min(1e-30)).max()))
    return out


@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal,window", _BWD_TC_SHAPES)
def test_flash_attention_bwd_tensor_core_rounding_meets_the_card_bars(
        b, s, t, hq, hkv, d, causal, window):
    """The bf16 kernel's rounding (P and dS as two bf16 terms before the
    three D-side products, every sum in fp32) against the plain version
    summed in float64, at the card tests' shapes and bars: every gradient
    within 3e-2 and every row within 2^-6 of its norm."""
    q, k, v, o, lse, do = _bwd_bf16_inputs(b, s, t, hq, hkv, d, causal,
                                           window)
    got = _bwd_tensor_core_arithmetic(q, k, v, o, lse, do, causal, window,
                                      terms=2)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        window=window,
                                        acc_dtype=torch.float64)
    for name, (e, re_) in _bwd_errors(got, want, causal).items():
        assert e < 3e-2, (name, e)
        assert re_ <= 2.0 ** -6, (name, re_)


@pytest.mark.parametrize("shape", [(2, 300, 300, 16, 16, 64, True, 0),
                                   (4, 200, 200, 32, 32, 80, True, 0)])
def test_flash_attention_bwd_one_bf16_rounding_of_p_misses_the_bar(shape):
    """Why the kernel splits P and dS into two bf16 terms: rounded once,
    P's error (2^-9 of each term) moves dv's fp32 sum enough to land a
    gradient of magnitude 4 to 8 on the next bf16 neighbour of the
    float64 oracle's rounding, 2^-5 = 0.03125 away, past the 3e-2 bar,
    while every row stays within 2^-6; with two terms the same gradients
    stay inside both bars (the test above)."""
    b, s, t, hq, hkv, d, causal, window = shape
    q, k, v, o, lse, do = _bwd_bf16_inputs(*shape)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        window=window,
                                        acc_dtype=torch.float64)
    once = _bwd_errors(_bwd_tensor_core_arithmetic(
        q, k, v, o, lse, do, causal, window, terms=1), want, causal)
    twice = _bwd_errors(_bwd_tensor_core_arithmetic(
        q, k, v, o, lse, do, causal, window, terms=2), want, causal)
    assert once["dv"][0] == 2.0 ** -5 and once["dv"][0] > 3e-2
    assert all(re_ <= 2.0 ** -6 for _, re_ in once.values())
    assert all(e < 3e-2 for e, _ in twice.values())
    assert max(e for e, _ in twice.values()) <= 2.0 ** -6


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
    assert _build.SOURCES == ("gossip_mix", "flash_attention",
                              "flash_attention_bwd", "rglru_scan",
                              "rglru_scan_bwd", "rwkv6_scan",
                              "rwkv6_scan_bwd", "quantize", "trace_scan")
    libs = set()
    for name in _build.SOURCES:
        src, so = _build._target(name)
        assert src.exists() and so.name.startswith(f"{name}-")
        libs.add(so.name)
    assert len(libs) == 9


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
# Kernels with no backward: the kernel path refuses inputs that need a
# gradient (flash attention and the two scans have backward kernels)
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
        "gossip_mix_q8_w": (gm.gossip_mix_q8_rows, gm,
                            lambda g: gm.gossip_mix_q8_w(
            torch.ones(2, 2), torch.ones(2, 16, requires_grad=g), q8,
            torch.ones(2, 1))),
        "gossip_mix_int8_round": (gm.gossip_mix_q8_rows, gm,
                                  lambda g: gm.gossip_mix_int8_round(
            torch.ones(2, 16), torch.ones(2, 16), torch.ones(2, 2,
                                                             requires_grad=g),
            torch.ones(2, dtype=torch.bool))),
        "quantize_int8": (qz.quantize_int8, qz, lambda g: qz.quantize_int8(
            torch.ones(2, 300, requires_grad=g), 256)),
        "quantize_int8_ef": (qz.quantize_int8_ef, qz,
                             lambda g: qz.quantize_int8_ef(
            torch.ones(2, 300), torch.ones(2, 300, requires_grad=g),
            torch.ones(2, dtype=torch.bool))),
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
    launch recorded instead of made) a wrapper whose kernel has no
    backward raises before any launch when autograd is on and an input
    requires grad: its output, filled through ctypes, would silently carry
    no grad_fn. Under no_grad, or with inputs that need none, it launches
    as before. flash_attention, rglru_scan and rwkv6_scan have backward
    kernels: a forward that needs a gradient launches the forward entry
    (flash's with an lse buffer), and ``.backward()`` launches the
    backward entry."""
    wrapper, mod, call = _grad_cases()[name]
    launched = []
    monkeypatch.setattr(mod, "use_kernel", lambda dev: True)
    monkeypatch.setattr(mod._build, "launch",
                        lambda name, e, *args: launched.append((e, args)))
    before = wrapper.launches
    backward = {"flash_attention": fa.flash_attention_bwd,
                "rglru_scan": rg.rglru_scan_bwd,
                "rwkv6_scan": rw.rwkv6_scan_bwd}.get(name)
    if backward is not None:
        entry = f"{name}_f32"
        bwd_before = backward.launches
        out = call(True)
        out = out[0] if isinstance(out, tuple) else out
        assert [e for e, _ in launched] == [entry] and out.grad_fn is not None
        if name == "flash_attention":
            # args: argtypes, device, then q, k, v, out, lse pointers
            assert launched[0][1][6] != 0
        out.sum().backward()
        assert [e for e, _ in launched] == [entry, f"{name}_bwd_f32"]
        assert backward.launches == bwd_before + 1
        with torch.no_grad():
            call(True)
        call(False)
        if name == "flash_attention":
            assert [args[6] for _, args in launched[2:]] == [0, 0]
        assert len(launched) == 4 and wrapper.launches == before + 3
        return
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    assert launched == [] and wrapper.launches == before
    with torch.no_grad():
        call(True)
    call(False)
    assert len(launched) == 2 and wrapper.launches == before + 2
