"""The D-PSGD step builders' CUDA graphs (``repro_torch.graphs``), on the
CPU.

On CPU inputs a built step is its eager body, bit for bit. The graph path
itself (static inputs, one capture per signature, fresh outputs, the launch
counters' per-replay delta) is rehearsed here with the CUDA graph faked: the
fake "replay" reruns the captured function on the static inputs and writes
the flat outputs in place, as a replay does, with the counters held still,
as a replay runs no Python. The real capture is held against the eager body
on the card (tests/test_torch_kernels_card.py).
"""
import contextlib

import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch

from repro_torch import graphs
from repro_torch.core import dpsgd as td
from repro_torch.core.compression import QuantConfig
from repro_torch.kernels import counted_wrappers, gossip_mix as gm
from repro_torch.models import cnn as tcnn

N, B = 6, 4


def _params(n=N, seed=0):
    """Distinct per-node parameters, so the mix does real work."""
    g = torch.Generator().manual_seed(seed)
    base = tcnn.cnn_init(g, device="cpu")
    return td._tree_map(lambda p: p[None].repeat(n, *([1] * p.dim()))
                        + 0.01 * torch.randn((n, *p.shape), generator=g),
                        base)


def _batch(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": torch.from_numpy(
                rng.normal(size=(n, B, 1, 28, 28)).astype(np.float32)),
            "labels": torch.from_numpy(
                rng.integers(0, 10, size=(n, B)).astype(np.int32))}


def _w(n=N, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)) + np.eye(n)
    return w / w.sum(1, keepdims=True)


CFG = td.DPSGDConfig(eta=0.05)
INT8 = QuantConfig(mode="int8")


def _builders():
    """(graphed step, eager body, extra arguments after (params, batch, w))
    per builder."""
    return {
        "dense": (td.make_dpsgd_step(tcnn.cnn_loss, CFG),
                  lambda *a: td.dpsgd_step(tcnn.cnn_loss, *a, CFG), ()),
        "masked": (td.make_dpsgd_masked_step(tcnn.cnn_loss, CFG),
                   lambda *a: td.dpsgd_masked_step(tcnn.cnn_loss, *a, CFG),
                   ("live",)),
        "compressed": (td.make_dpsgd_compressed_step(tcnn.cnn_loss, INT8, CFG),
                       lambda *a: td.dpsgd_masked_compressed_step(
                           tcnn.cnn_loss, *a, INT8, CFG),
                       ("live", "residuals")),
    }


def _args(kind, params, batch, w, state):
    extra = _builders()[kind][2]
    live = np.arange(params["fc1"]["b"].shape[0]) != 1     # node 1 is dead
    return (params, batch, w) + tuple(
        live if e == "live" else state for e in extra)


def _leaves(out):
    if isinstance(out, dict):
        return td._leaves(out)
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


@pytest.mark.parametrize("kind", ["dense", "masked", "compressed"])
def test_builders_return_graphed_steps_that_run_eager_on_the_cpu(kind):
    step, body, _ = _builders()[kind]
    assert isinstance(step, graphs.GraphedStep)
    params = _params()
    args = _args(kind, params, _batch(), _w(), td.zero_residuals(params))
    step.prepare(*args)
    assert step.signatures == 0                 # no graph on the CPU
    got, want = step(*args), body(*args)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))


@pytest.fixture
def fake_graphs(monkeypatch):
    """The graph path on the CPU: captures are recorded functions, replays
    rerun them into the captured flat outputs."""
    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            self.rerun()

    def record(graph, stream, fn):
        out = fn()

        def rerun():
            counts = [f.launches for f in counted_wrappers()]
            for dst, src in zip(out[0], fn()[0]):
                dst.copy_(src)
            for f, c in zip(counted_wrappers(), counts):
                f.launches = c
        graph.rerun = rerun
        return out

    monkeypatch.setattr(graphs, "_graphable", lambda device: True)
    monkeypatch.setattr(graphs, "_SIDE", {})
    monkeypatch.setattr(graphs, "_record", record)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


@pytest.mark.parametrize("kind", ["dense", "masked", "compressed"])
def test_graph_path_replays_the_eager_body_and_hands_out_fresh_outputs(
        fake_graphs, kind):
    """Five steps, then five more at n = 5 (a new signature): each step's
    output equals the eager body's on the same inputs, and what a step
    returned is unchanged after the next step."""
    step, body, extra = _builders()[kind]
    for n in (N, N - 1):
        params = _params(n, seed=n)
        state = td.zero_residuals(params)
        kept = []
        for k in range(5):
            args = _args(kind, params, _batch(n, seed=k), _w(n, seed=k),
                         state)
            got, want = step(*args), body(*args)
            assert all(torch.equal(a, b) for a, b in
                       zip(_leaves(got), _leaves(want)))
            kept.append((got, [t.clone() for t in _leaves(got)]))
            params = got[0]
            state = got[1] if kind == "compressed" else state
        for got, copy in kept:
            assert all(torch.equal(a, b) for a, b in zip(_leaves(got), copy))
    assert step.signatures == 2


def test_graph_path_takes_numpy_and_list_inputs(fake_graphs):
    """W and live may arrive as numpy or lists (the simulator's per-round
    W): they are copied into the graph's static buffers before each
    replay, and a new value is not a new signature."""
    step, body, _ = _builders()["masked"]
    params, batch = _params(), _batch()
    live = [True] * N
    for seed in range(3):
        w = _w(seed=seed)
        got = step(params, batch, w.tolist(), live)
        want = body(params, batch, w, live)
        assert all(torch.equal(a, b) for a, b in
                   zip(_leaves(got), _leaves(want)))
    assert step.signatures == 1


def test_graph_path_counts_one_capture_delta_per_replay(fake_graphs):
    """The warm-up runs and the capture do not count; each replay adds
    what the capture saw."""
    def body(x):
        gm.gossip_mix_rows.launches += 1
        return x * 2.0, {"y": x + 1.0}
    step = graphs.GraphedStep(body)
    x = torch.arange(6.0).reshape(2, 3)
    before = gm.gossip_mix_rows.launches
    step.prepare(x)
    assert gm.gossip_mix_rows.launches == before
    outs = [step(x + i) for i in range(3)]
    assert gm.gossip_mix_rows.launches == before + 3
    for i, (a, b) in enumerate(outs):
        assert torch.equal(a, (x + i) * 2.0)
        assert torch.equal(b["y"], x + i + 1.0)
