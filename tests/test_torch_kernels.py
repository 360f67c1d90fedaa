"""The port's gossip-mix kernels: plain versions against the JAX package's
Pallas kernels (interpret mode, through ``repro.kernels.ops``), the shape
contracts and the per-call dispatch. The CUDA kernels themselves are held
against their plain versions on the card, in test_torch_kernels_card.py.

Tolerances follow tests/test_kernels.py: fp32 1e-5, bf16 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import quantize_int8 as jax_quantize_int8
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _backend, _build, gossip_mix as gm, ops, ref

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
