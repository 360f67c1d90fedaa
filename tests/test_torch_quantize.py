"""The port's int8 quantize / dequantize kernels (kernels 3-4): the plain
versions against the JAX package's Pallas kernels (interpret mode, through
``repro.kernels.ops``, as tests/test_kernels.py runs them) and oracles, the
wire codec of ``core.compression``, the int8 round's send (quantize with
error feedback, ``quantize_int8_ef``) against the unfused sequence it
replaces and the JAX package's, the contracts and the per-call dispatch.
The CUDA kernels themselves are held against their plain versions on the
card, in test_torch_kernels_card.py.

Inputs are finite (the contract covers finite inputs only). Tolerances:
q ``torch.equal`` (ROADMAP: int8 payloads bit-equal), scales rtol 1e-6,
dequantized outputs equal; the round trip within half an int8 step of the
block's scale (tests/test_kernels.py:144).

At (6, 21 840) the Pallas kernels leave lanes 20 480 and up unwritten: C is
padded to 22 016 lanes, tiled by 4 096, and the grid ``c // bc`` drops the
last partial tile (``src/repro/kernels/quantize.py:51`` and ``:79``; ROADMAP
Queue 3). There the port is held against the Pallas kernels on the lanes
they write and against the JAX oracle ``quantize_int8_ref`` on every lane.
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import compression as tcomp
from repro_torch.kernels import _backend, ops, ref
from repro_torch.kernels import quantize as qz

SHAPES = [(8, 512), (5, 700), (16, 256), (6, 21_840)]
PALLAS_TILE = 256 * 16          # the Pallas kernels' lane tile


def _x(r, c, seed=0, scale=7.0):
    return (np.random.default_rng(seed).normal(size=(r, c)) * scale
            ).astype(np.float32)


def _pallas_lanes(c):
    """Lanes the Pallas kernels write for a C-lane input (see the module
    docstring): all of them unless the padded width overruns a whole
    number of 4096-lane tiles."""
    cp = -(-c // 256) * 256
    return cp if cp <= PALLAS_TILE else cp // PALLAS_TILE * PALLAS_TILE


@pytest.mark.parametrize("r,c", SHAPES)
def test_quantize_plain_matches_pallas_and_oracle(r, c):
    x = _x(r, c, seed=r + c)
    q, s = ops.quantize_int8(torch.from_numpy(x))
    assert q.shape == (r, c) and q.dtype == torch.int8
    assert s.shape == (r, -(-c // 256)) and s.dtype == torch.float32
    jq, js = jops.quantize_int8(jnp.asarray(x))
    lanes = min(_pallas_lanes(c), c)
    assert torch.equal(q[:, :lanes], torch.from_numpy(np.asarray(jq)[:, :lanes]))
    np.testing.assert_allclose(s[:, :-(-lanes // 256)].numpy(),
                               np.asarray(js)[:, :-(-lanes // 256)], rtol=1e-6)
    # every lane against the JAX oracle on the zero-padded input
    cp = s.shape[1] * 256
    xq, xs = jref.quantize_int8_ref(jnp.pad(jnp.asarray(x), ((0, 0), (0, cp - c))))
    assert torch.equal(q, torch.from_numpy(np.asarray(xq)[:, :c]))
    np.testing.assert_allclose(s.numpy(), np.asarray(xs), rtol=1e-6)


@pytest.mark.parametrize("r,c", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_plain_matches_pallas_and_oracle(r, c, dtype):
    x = _x(r, c, seed=3 * r + c)
    jq, js = jref.quantize_int8_ref(
        jnp.pad(jnp.asarray(x), ((0, 0), (0, -(-c // 256) * 256 - c))))
    jq = jq[:, :c]
    got = ops.dequantize_int8(torch.from_numpy(np.asarray(jq)),
                              torch.from_numpy(np.asarray(js)),
                              dtype=getattr(torch, dtype))
    assert got.shape == (r, c) and got.dtype == getattr(torch, dtype)
    want = jops.dequantize_int8(jq, js, dtype=getattr(jnp, dtype))
    lanes = min(_pallas_lanes(c), c)
    assert torch.equal(got[:, :lanes].float(),
                       torch.from_numpy(np.asarray(want, np.float32)[:, :lanes]))
    cp = js.shape[1] * 256
    oracle = jref.dequantize_int8_ref(jnp.pad(jq, ((0, 0), (0, cp - c))), js,
                                      dtype=getattr(jnp, dtype))[:, :c]
    assert torch.equal(got.float(),
                       torch.from_numpy(np.asarray(oracle, np.float32)))


@pytest.mark.parametrize("r,c", SHAPES)
def test_quantize_roundtrip(r, c):
    """tests/test_kernels.py:144's bound: the error is at most half an int8
    step of the per-block scale."""
    x = torch.from_numpy(_x(r, c))
    q, s = ops.quantize_int8(x)
    err = float((ops.dequantize_int8(q, s) - x).abs().max())
    assert err <= float(x.abs().max()) / 127.0 * 0.51 + 1e-6


@pytest.mark.parametrize("r,c", [(8, 512), (6, 21_840), (3, 4096)])
def test_port_oracles_match_jax_oracles(r, c):
    x = _x(r, c, seed=7)
    for block in (256, 2048):
        if c % block:
            continue
        q, s = ref.quantize_int8_ref(torch.from_numpy(x), block)
        jq, js = jref.quantize_int8_ref(jnp.asarray(x), block)
        assert torch.equal(q, torch.from_numpy(np.asarray(jq)))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
        for dtype in ("float32", "bfloat16"):
            d = ref.dequantize_int8_ref(q, s, block, getattr(torch, dtype))
            jd = jref.dequantize_int8_ref(jq, js, block, getattr(jnp, dtype))
            assert torch.equal(d.float(), torch.from_numpy(
                np.asarray(jd, np.float32)))


@pytest.mark.parametrize("rows,length", [(1, 1), (6, 21_840), (6, 21_843),
                                         (3, 2048), (4, 5000)])
def test_wire_codec_is_the_oracle_at_2048_lanes(rows, length):
    """``ref.quantize_int8_ref(x, block=2048)`` on the zero-padded message is
    ``core.compression.quantize_int8_rows`` (ragged lengths included), which
    is the JAX package's wire codec bit for bit."""
    x = torch.from_numpy(_x(rows, length, seed=length, scale=0.3))
    q, s = tcomp.quantize_int8_rows(x)
    lp = -(-length // 2048) * 2048
    rq, rs = ref.quantize_int8_ref(
        torch.cat([x, x.new_zeros((rows, lp - length))], 1), block=2048)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    jq, js = jcomp.quantize_int8_rows(jnp.asarray(x.numpy()))
    assert torch.equal(q, torch.from_numpy(np.asarray(jq)))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    d = tcomp.dequantize_int8_rows(q, s, length)
    assert torch.equal(d, ref.dequantize_int8_ref(q, s, 2048)[:, :length])
    assert torch.equal(d, torch.from_numpy(np.asarray(
        jcomp.dequantize_int8_rows(jq, js, length))))


def test_kernel_module_matches_oracle_in_both_formats():
    x = torch.from_numpy(_x(5, 4096 + 300, seed=11))
    for block in qz.BLOCKS:
        q, s = qz.quantize_int8(x, block)
        lp = s.shape[1] * block
        rq, rs = ref.quantize_int8_ref(
            torch.cat([x, x.new_zeros((5, lp - x.shape[1]))], 1), block)
        assert torch.equal(q, rq) and torch.equal(s, rs)
        assert torch.equal(q[:, x.shape[1]:], torch.zeros_like(q[:, x.shape[1]:]))
        for dtype in (torch.float32, torch.bfloat16):
            d = qz.dequantize_int8(q, s, block, x.shape[1], dtype)
            assert torch.equal(d, ref.dequantize_int8_ref(
                q, s, block, dtype)[:, :x.shape[1]])
        # a bf16 input quantizes its exact fp32 values
        xb = x.to(torch.bfloat16)
        assert all(torch.equal(a, b) for a, b in zip(
            qz.quantize_int8(xb, block), qz.quantize_int8(xb.float(), block)))


@pytest.mark.parametrize("call,match", [
    (lambda: qz.quantize_int8(torch.zeros(3, 5), 512), "scale block"),
    (lambda: qz.quantize_int8(torch.zeros(10), 256), "2-D"),
    (lambda: qz.quantize_int8(torch.zeros(2, 10, dtype=torch.float64), 256),
     "float32 or bfloat16"),
    (lambda: qz.dequantize_int8(torch.zeros(2, 512), torch.ones(2, 2)),
     "int8"),
    (lambda: qz.dequantize_int8(torch.zeros(2, 512, dtype=torch.int8),
                                torch.ones(2, 3)), "one per block"),
    (lambda: qz.dequantize_int8(torch.zeros(2, 512, dtype=torch.int8),
                                torch.ones(3, 2)), "one per block"),
    (lambda: qz.dequantize_int8(torch.zeros(2, 512, dtype=torch.int8),
                                torch.ones(2, 2), length=513), "fit"),
    (lambda: qz.dequantize_int8(torch.zeros(2, 512, dtype=torch.int8),
                                torch.ones(2, 2), dtype=torch.float16),
     "float32 or bfloat16"),
    (lambda: ops.dequantize_int8(torch.zeros(2, 700, dtype=torch.int8),
                                 torch.ones(2, 2)), "one per block"),
])
def test_contracts_raise_value_error(call, match):
    before = (qz.quantize_int8.launches, qz.dequantize_int8.launches)
    with pytest.raises(ValueError, match=match):
        call()
    assert (qz.quantize_int8.launches, qz.dequantize_int8.launches) == before


def test_dispatch_cpu_takes_plain_version_and_counts_no_launch():
    qz.quantize_int8.launches = qz.dequantize_int8.launches = 0
    x = torch.from_numpy(_x(6, 21_840))
    q, s = tcomp.quantize_int8_rows(x)
    tcomp.dequantize_int8_rows(q, s, 21_840)
    q, s = ops.quantize_int8(x)
    ops.dequantize_int8(q, s)
    assert (qz.quantize_int8.launches, qz.dequantize_int8.launches) == (0, 0)


def test_non_cpu_tensor_never_falls_back_to_plain():
    meta = {"device": "meta"}
    with pytest.raises(RuntimeError, match="device type"):
        qz.quantize_int8(torch.ones(2, 300, **meta), 256)
    with pytest.raises(RuntimeError, match="device type"):
        tcomp.quantize_int8_rows(torch.ones(2, 300, **meta))
    with pytest.raises(RuntimeError, match="device type"):
        tcomp.dequantize_int8_rows(torch.zeros(2, 2048, dtype=torch.int8,
                                               **meta),
                                   torch.ones(2, 1, **meta), 300)
    assert (qz.quantize_int8.launches, qz.dequantize_int8.launches) == (0, 0)


@pytest.mark.parametrize("which", ["quantize", "dequantize", "send"])
def test_raise_below_sm90(monkeypatch, which):
    """Asked about a CUDA device below (9, 0), the dispatch raises before
    any launch (the probe is patched; the host tensors are never touched)."""
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (8, 0))
    cuda0 = torch.device("cuda", 0)
    monkeypatch.setattr(qz, "use_kernel",
                        lambda dev: _backend.use_kernel(cuda0))
    counted = (qz.quantize_int8, qz.dequantize_int8, qz.quantize_int8_ef)
    before = [fn.launches for fn in counted]
    with pytest.raises(RuntimeError, match="capability"):
        if which == "quantize":
            qz.quantize_int8(torch.ones(2, 300), 2048)
        elif which == "send":
            qz.quantize_int8_ef(torch.ones(2, 300), torch.ones(2, 300),
                                torch.ones(2, dtype=torch.bool))
        else:
            qz.dequantize_int8(torch.zeros(2, 2048, dtype=torch.int8),
                               torch.ones(2, 1), 2048)
    assert [fn.launches for fn in counted] == before


# ---------------------------------------------------------------------------
# The int8 round's send: quantize with error feedback in one launch
# ---------------------------------------------------------------------------

def _send_inputs(rows, length, dead, seed=0):
    rng = np.random.default_rng(seed + rows * length)
    flat = torch.from_numpy((rng.normal(size=(rows, length)) * 0.3
                             ).astype(np.float32))
    res = torch.from_numpy((rng.normal(size=(rows, length)) * 1e-3
                            ).astype(np.float32))
    live = torch.ones(rows, dtype=torch.bool)
    if dead:
        live[rows // 2] = False
    return flat, res, live


def _unfused_send(flat, res, live, ef):
    """The round's send as the port computed it before the fused entry:
    the wire codec's quantize and dequantize, then the residual and the
    masking of dead rows, each its own operation."""
    carried = flat + res if ef else flat
    q, s = tcomp.quantize_int8_rows(carried)
    deq = tcomp.dequantize_int8_rows(q, s, carried.shape[1])
    new_res = carried - deq if ef else res
    new_res = torch.where(live[:, None], new_res,
                          torch.zeros((), dtype=new_res.dtype))
    return q, s, new_res


SEND_SHAPES = [(6, 21_840), (6, 21_843), (3, 2049), (1, 1), (4, 5000)]


@pytest.mark.parametrize("rows,length", SEND_SHAPES)
@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("dead", [False, True])
def test_send_plain_is_the_unfused_sequence_and_the_jax_packages(
        rows, length, ef, dead):
    """``quantize_int8_ef_plain`` (and the CPU dispatch of its wrapper)
    bit-equal to the unfused torch sequence, with
    ragged lengths, a dead node and error feedback on and off; q bit-equal
    to the JAX package's wire codec on the same carried buffer, the
    scales and the new residual equal to its sequence's
    (``repro.core.dpsgd``'s int8 branch)."""
    flat, res, live = _send_inputs(rows, length, dead)
    want = _unfused_send(flat, res, live, ef)
    for got in (qz.quantize_int8_ef_plain(flat, res, live, ef),
                qz.quantize_int8_ef(flat, res, live, ef)):
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))
    assert got[0].shape == (rows, -(-length // 2048) * 2048)
    assert got[1].shape == (rows, -(-length // 2048))
    assert got[2].shape == (rows, length)
    carried = jnp.asarray((flat + res if ef else flat).numpy())
    jq, js = jcomp.quantize_int8_rows(carried)
    jdeq = jcomp.dequantize_int8_rows(jq, js, length)
    jres = jnp.where(jnp.asarray(live.numpy())[:, None],
                     carried - jdeq if ef else jnp.asarray(res.numpy()), 0.0)
    assert torch.equal(got[0], torch.from_numpy(np.asarray(jq)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(js))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jres))


def test_send_zeroes_dead_rows_and_passes_res_without_feedback():
    flat, res, live = _send_inputs(4, 3000, dead=True)
    _, _, on = qz.quantize_int8_ef(flat, res, live, True)
    _, _, off = qz.quantize_int8_ef(flat, res, live, False)
    dead = ~live
    assert torch.equal(on[dead], torch.zeros_like(on[dead]))
    assert not torch.signbit(on[dead]).any()          # +0, as torch.where
    assert torch.equal(off[live], res[live])
    assert torch.equal(off[dead], torch.zeros_like(off[dead]))


@pytest.mark.parametrize("call,match", [
    (lambda f, l: qz.quantize_int8_ef(f, f[:, :-1], l), "one"),
    (lambda f, l: qz.quantize_int8_ef(f[0], f[0], l), "one"),
    (lambda f, l: qz.quantize_int8_ef(f.double(), f.double(), l), "float32"),
    (lambda f, l: qz.quantize_int8_ef(f, f.to(torch.bfloat16), l),
     "float32"),
    (lambda f, l: qz.quantize_int8_ef(f, f, l.float()), "bool"),
    (lambda f, l: qz.quantize_int8_ef(f, f, l[:1]), "bool"),
])
def test_send_contracts_raise_value_error(call, match):
    before = qz.quantize_int8_ef.launches
    with pytest.raises(ValueError, match=match):
        call(torch.zeros(3, 300), torch.ones(3, dtype=torch.bool))
    assert qz.quantize_int8_ef.launches == before


def test_send_on_the_kernel_path_passes_the_entry_its_operands(monkeypatch):
    """With the dispatch patched to the card's answer and the launch
    recorded, the wrapper allocates the wire format's outputs and hands the
    C entry rows, lanes and the feedback flag; a CPU tensor never counts a
    launch, and a tensor off the CPU never runs the plain version."""
    launched = []
    monkeypatch.setattr(qz, "use_kernel", lambda dev: True)
    monkeypatch.setattr(qz._build, "launch",
                        lambda name, entry, types, dev, *a:
                        launched.append((name, entry, a)))
    before = qz.quantize_int8_ef.launches
    flat, res, live = _send_inputs(3, 2049, dead=True)
    q, s, new_res = qz.quantize_int8_ef(flat, res, live, False)
    assert q.shape == (3, 4096) and q.dtype == torch.int8
    assert s.shape == (3, 2) and new_res.shape == (3, 2049)
    (name, entry, args), = launched
    assert (name, entry) == ("quantize", "quantize_int8_ef_f32_b2048")
    assert args[:6] == (flat.data_ptr(), res.data_ptr(), live.data_ptr(),
                        q.data_ptr(), s.data_ptr(), new_res.data_ptr())
    assert args[6:] == (3, 2049, 0)
    assert qz.quantize_int8_ef.launches == before + 1
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="device type"):
        qz.quantize_int8_ef(*(t.to("meta") for t in (flat, res, live)))
    qz.quantize_int8_ef(flat, res, live)
    assert qz.quantize_int8_ef.launches == before + 1
