"""The port's numpy planes and int8 codec against the JAX package.

``repro_torch.core.{channel,topology,comm_model,bound,rate_opt}`` and
``repro_torch.data`` are copies of the reference's numpy code: on the same
inputs they must give exactly equal outputs. The compression accounting is
copied too (``==``); the int8 codec is torch and must give bit-equal q and
scales on the same input.
"""
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch

from repro.core import bound as r_bound
from repro.core import channel as r_channel
from repro.core import comm_model as r_comm
from repro.core import compression as r_comp
from repro.core import rate_opt as r_rate
from repro.core import topology as r_topo
from repro.data import synthetic as r_syn
from repro.models.cnn import MODEL_BITS
from repro_torch.core import bound as t_bound
from repro_torch.core import channel as t_channel
from repro_torch.core import comm_model as t_comm
from repro_torch.core import compression as t_comp
from repro_torch.core import rate_opt as t_rate
from repro_torch.core import topology as t_topo
from repro_torch.data import pipeline as t_pipe
from repro_torch.data import synthetic as t_syn
from repro_torch.models.cnn import MODEL_BITS as T_MODEL_BITS

PLACEMENTS = [(3.0, 0), (5.0, 0), (5.0, 1)]
LAMBDAS = [0.1, 0.3, 0.8]


def _caps(eps, seed):
    ref = r_channel.capacity_matrix(
        r_channel.random_placement(6, 200.0, seed=seed),
        r_channel.ChannelParams(path_loss_exp=eps))
    port = t_channel.capacity_matrix(
        t_channel.random_placement(6, 200.0, seed=seed),
        t_channel.ChannelParams(path_loss_exp=eps))
    return ref, port


def _same_solution(a, b):
    assert np.array_equal(a.rates_bps, b.rates_bps)
    assert a.lam == b.lam and a.t_com_s == b.t_com_s
    assert a.feasible == b.feasible
    assert np.array_equal(a.w, b.w)


@pytest.mark.parametrize("eps,seed", PLACEMENTS)
def test_channel_and_topology_copies_equal(eps, seed):
    ref, port = _caps(eps, seed)
    assert np.array_equal(ref, port)
    d = r_channel.pairwise_distances(r_channel.random_placement(6, seed=seed))
    p = r_channel.ChannelParams(path_loss_exp=eps)
    q = t_channel.ChannelParams(path_loss_exp=eps)
    assert np.array_equal(r_channel.snr_linear(d, p), t_channel.snr_linear(d, q))
    assert np.array_equal(r_channel.snr_from_capacity(ref, 1e6),
                          t_channel.snr_from_capacity(ref, 1e6))
    rng = np.random.default_rng(seed)
    rates = rng.choice(ref[np.isfinite(ref)], size=(16, 6))
    for rb in (False, True):
        a = r_topo.adjacency_from_rates_batch(ref, rates, reception_based=rb)
        assert np.array_equal(
            a, t_topo.adjacency_from_rates_batch(ref, rates,
                                                 reception_based=rb))
        assert np.array_equal(
            r_topo.adjacency_from_rates(ref, rates[0], reception_based=rb),
            t_topo.adjacency_from_rates(ref, rates[0], reception_based=rb))
        w = r_topo.paper_w(a)
        assert np.array_equal(w, t_topo.paper_w(a))
        assert np.array_equal(r_topo.spectral_lambda_batch(w),
                              t_topo.spectral_lambda_batch(w))
        assert np.array_equal(r_topo.spectral_lambda_iter_batch(w),
                              t_topo.spectral_lambda_iter_batch(w))
        assert np.array_equal(r_topo.connected_batch(w),
                              t_topo.connected_batch(w))
        assert r_topo.spectral_lambda(w[0]) == t_topo.spectral_lambda(w[0])
    ring = r_topo.ring_adjacency(6, 2)
    assert np.array_equal(ring, t_topo.ring_adjacency(6, 2))
    assert np.array_equal(r_topo.metropolis_w(ring), t_topo.metropolis_w(ring))
    assert np.array_equal(r_topo.torus_adjacency(2, 3),
                          t_topo.torus_adjacency(2, 3))
    assert list(r_topo.neighbor_shifts_ring(8, 2)) == \
        list(t_topo.neighbor_shifts_ring(8, 2))


@pytest.mark.parametrize("lam", LAMBDAS)
def test_comm_model_and_bound_copies_equal(lam):
    rates = np.array([7.8e6, 15e6, 18.6e6, 53.1e6, 49.6e6, 122e6])
    assert r_comm.tdm_time_s(MODEL_BITS, rates) == \
        t_comm.tdm_time_s(T_MODEL_BITS, rates)
    stack = np.stack([rates, rates[::-1] * lam])
    assert np.array_equal(r_comm.tdm_time_batch_s(MODEL_BITS, stack),
                          t_comm.tdm_time_batch_s(MODEL_BITS, stack))
    link_r, link_t = r_comm.LinkModel(), t_comm.LinkModel()
    assert r_comm.gossip_round_time_s(1e6, [1, -1], link_r) == \
        t_comm.gossip_round_time_s(1e6, [1, -1], link_t)
    assert r_comm.allreduce_time_s(1e6, 8, link_r) == \
        t_comm.allreduce_time_s(1e6, 8, link_t)
    bp_r, bp_t = r_bound.BoundParams(n=6), t_bound.BoundParams(n=6)
    for k in (10.0, 1e4, np.inf):
        assert r_bound.dpsgd_bound(bp_r, lam, k) == \
            t_bound.dpsgd_bound(bp_t, lam, k)
    assert r_bound.lambda_threshold(bp_r, 1e3) == \
        t_bound.lambda_threshold(bp_t, 1e3)
    assert r_bound.max_feasible_lambda(0.05, 1.0) == \
        t_bound.max_feasible_lambda(0.05, 1.0)


@pytest.mark.parametrize("eps,seed", PLACEMENTS)
@pytest.mark.parametrize("lam", LAMBDAS)
def test_rate_solvers_equal_reference(eps, seed, lam):
    """Every batched solver and its sequential ``*_reference`` returns the
    JAX package's rates, λ, t_com and W exactly."""
    ref, port = _caps(eps, seed)
    for method in ("auto", "bruteforce", "greedy", "greedy_reference",
                   "k_nearest", "k_nearest_reference", "common_rate",
                   "common_rate_reference"):
        _same_solution(r_rate.solve(ref, MODEL_BITS, lam, method=method),
                       t_rate.solve(port, T_MODEL_BITS, lam, method=method))
    for method in ("greedy", "k_nearest", "common_rate"):
        _same_solution(t_rate.solve(port, MODEL_BITS, lam, method=method),
                       t_rate.solve(port, MODEL_BITS, lam,
                                    method=method + "_reference"))
    j_ref = r_rate.solve_joint(ref, MODEL_BITS, lam)
    j_port = t_rate.solve_joint(port, MODEL_BITS, lam)
    _same_solution(j_ref, j_port)
    assert (j_ref.mode, j_ref.wire_bits) == (j_port.mode, j_port.wire_bits)


@pytest.mark.parametrize("eps,lam", [(5.0, 0.1), (5.0, 0.8), (3.0, 0.3)])
def test_bruteforce_reference_equals_batched(eps, lam):
    """Algorithm 2 verbatim (one eig per combo) against the batched brute
    force, both in the port (the batched one is pinned to the JAX package
    above)."""
    _, port = _caps(eps, 0)
    _same_solution(t_rate.solve(port, MODEL_BITS, lam, method="bruteforce"),
                   t_rate.solve(port, MODEL_BITS, lam,
                                method="bruteforce_reference"))


def test_rate_opt_torch_eig_backend_close_to_numpy():
    _, port = _caps(5.0, 0)
    rates = np.random.default_rng(0).choice(port[np.isfinite(port)],
                                            size=(64, 6))
    t_np, lam_np, _ = t_rate.evaluate_rates_batch(port, rates, MODEL_BITS, 0.3)
    t_t, lam_t, _ = t_rate.evaluate_rates_batch(port, rates, MODEL_BITS, 0.3,
                                                backend="torch")
    assert np.array_equal(t_np, t_t)
    np.testing.assert_allclose(lam_t, lam_np, rtol=0, atol=1e-9)
    sol = t_rate.solve_bruteforce(port, MODEL_BITS, 0.3, backend="torch")
    _same_solution(sol, t_rate.solve_bruteforce(port, MODEL_BITS, 0.3))


def test_eq3_static_anchor_matches_reference_simulator():
    """The port's Algorithm 2 charge ``sol.t_com_s * k`` against the JAX
    package's static wireless scenario over k rounds (the CI anchor)."""
    from repro.sim import DEFAULT_MODEL_BITS, WirelessSimulator, get_scenario

    _, port = _caps(5.0, 0)
    sol = t_rate.solve(port, DEFAULT_MODEL_BITS, 0.3)
    trace = WirelessSimulator(get_scenario("static", lambda_target=0.3)).run(10)
    ref = sol.t_com_s * 10
    assert abs(trace.total_comm_s - ref) / ref < 1e-9


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("granularity", ["message", "leaf"])
def test_compression_accounting_equal(mode, granularity):
    rc = r_comp.QuantConfig(mode=mode, granularity=granularity)
    tc = t_comp.QuantConfig(mode=mode, granularity=granularity)
    for n in (0, 1, 2047, 2048, 2049, 21_840, 10**6):
        assert r_comp.payload_bits(n, rc) == t_comp.payload_bits(n, tc)
        if n:
            assert r_comp.compression_ratio(rc, n) == \
                t_comp.compression_ratio(tc, n)
    shapes = [(10, 1, 5, 5), (10,), (20, 10, 5, 5), (20,), (320, 50), (50,),
              (50, 10), (10,)]
    assert r_comp.payload_bits_tree(shapes, rc) == \
        t_comp.payload_bits_tree(shapes, tc)
    assert r_rate.payload_wire_bits(MODEL_BITS, mode) == \
        t_rate.payload_wire_bits(MODEL_BITS, mode)
    assert r_comp.PAYLOAD_MODES == t_comp.PAYLOAD_MODES
    assert r_comp.GRANULARITIES == t_comp.GRANULARITIES
    with pytest.raises(ValueError, match="granularity"):
        t_comp.QuantConfig(granularity="tensor")
    with pytest.raises(ValueError):
        t_comp.payload_bits(-1, tc)


@pytest.mark.parametrize("rows,length", [(1, 100), (6, 21_840), (3, 4096),
                                         (2, 2049)])
def test_int8_codec_bit_equal(rows, length):
    """q bit-equal and scales rtol 1e-6 on the same input (both frameworks
    round half to even); exact halves are planted to exercise the tie."""
    x = np.random.default_rng(rows * length).normal(size=(rows, length)) * 3
    x = x.astype(np.float32)
    x[:, :1] = 0.0
    if length > 8:
        x[0, 1:4] = [127.5 / 127, -2.5 / 127, 0.5 / 127]  # ties after scaling
    q_r, s_r = r_comp.quantize_int8_rows(x)
    q_t, s_t = t_comp.quantize_int8_rows(torch.from_numpy(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert np.array_equal(np.asarray(q_r), q_t.numpy())
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_r), rtol=1e-6)
    d_r = r_comp.dequantize_int8_rows(q_r, s_r, length)
    d_t = t_comp.dequantize_int8_rows(q_t, s_t, length)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_r), rtol=1e-6,
                               atol=0)
    q1, s1, n1 = t_comp.quantize_int8(torch.from_numpy(x[0]))
    assert n1 == length and torch.equal(q1, q_t[0])
    assert torch.equal(t_comp.dequantize_int8(q1, s1, n1), d_t[0])


def test_int8_codec_shape_contract():
    q = torch.zeros((2, 4096), dtype=torch.int8)
    with pytest.raises(ValueError, match="whole"):
        t_comp.dequantize_int8_rows(q[:, :4000], torch.ones(2, 2), 100)
    with pytest.raises(ValueError, match="scale count"):
        t_comp.dequantize_int8_rows(q, torch.ones(2, 3), 100)
    with pytest.raises(ValueError, match="does not fit"):
        t_comp.dequantize_int8_rows(q, torch.ones(2, 2), 5000)
    with pytest.raises(ValueError, match="rows"):
        t_comp.dequantize_int8_rows(q, torch.ones(3, 2), 100)
    zeros_q, zeros_s = t_comp.quantize_int8_rows(torch.zeros(2, 10))
    assert torch.equal(zeros_s, torch.ones(2, 1))          # 0 -> scale 1
    assert not zeros_q.any()


def test_data_copies_equal():
    ref = r_syn.SyntheticFashion(n_train=240, n_test=60, seed=3)
    port = t_syn.SyntheticFashion(n_train=240, n_test=60, seed=3)
    for a in ("train_x", "train_y", "test_x", "test_y"):
        assert np.array_equal(getattr(ref, a), getattr(port, a))
    for (xr, yr), (xt, yt) in zip(
            r_syn.node_splits(ref.train_x, ref.train_y, 6, seed=1),
            t_syn.node_splits(port.train_x, port.train_y, 6, seed=1)):
        assert np.array_equal(xr, xt) and np.array_equal(yr, yt)
    gen_r = r_syn.token_stream(2, 16, 50, seed=4)
    gen_t = t_syn.token_stream(2, 16, 50, seed=4)
    for _ in range(3):
        assert np.array_equal(next(gen_r), next(gen_t))
    loader = t_pipe.ShardedLoader(
        lambda s: t_pipe.deterministic_lm_batch(s, 2, 8, 50), start_step=5)
    try:
        step, batch = next(loader)
    finally:
        loader.close()
    assert step == 5
    assert np.array_equal(batch["tokens"],
                          t_pipe.deterministic_lm_batch(5, 2, 8, 50)["tokens"])
