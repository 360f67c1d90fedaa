"""The CUDA gossip-mix kernels against their plain torch versions, on an
sm_90 card (every test here skips without one).

Imports neither ``jax`` nor ``repro``, so it runs on a machine with only
PyTorch:  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_card.py

Tolerances follow tests/test_kernels.py: fp32 1e-5, bf16 3e-2.
"""
import pytest
import torch

from repro_torch.core.compression import quantize_int8_rows
from repro_torch.kernels import gossip_mix as gm, ops

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
