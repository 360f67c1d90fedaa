"""Collective bytes reckoned from the gossip plan (``utils/collectives.py``)
against the JAX package's compiled HLO.

The JAX side compiles, in one subprocess on a (4, 1) host mesh (as
``tests/test_dist.py`` fakes its devices), the Mode B train step of smoke
configs (its gossip: a collective-permute per leaf per round), the same
parameters mixed by ``core.gossip.gossip_mix_tree`` fused (one buffer per
dtype) and per leaf under ``shard_map``, an int8-compressed Mode B step,
and the Mode A step; ``repro.utils.hlo.collective_summary`` reads each.
The port reckons the same from its own parameter tree's shapes:
collective-permute result bytes are held equal exactly, all-reduce bytes
up to the step's scalar metrics (the loss's mean, at most 64 bytes).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores
pytest.importorskip("jax")

import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core.dpsgd import _leaves  # noqa: E402
from repro_torch.core.gossip import allreduce_plan, ring_plan  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.utils.collectives import (OPS, link_bytes,  # noqa: E402
                                           step_collectives, summarize)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("stablelm-3b", "qwen2-vl-2b")

_JAX_SIDE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import RunConfig, get_config, reduce_for_smoke
from repro.core.gossip import gossip_mix_tree, ring_plan
from repro.models import build
from repro.optim.schedule import constant_lr
from repro.train.step import init_train_state, make_train_step
from repro.utils.hlo import collective_summary
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
axt = getattr(jax.sharding, "AxisType", None)
kw = dict(axis_types=(axt.Auto,) * 2) if axt else {}
mesh = jax.make_mesh((4, 1), ("data", "model"), **kw)
plan = ring_plan(("data",), (4,), 1)
out = {}

def spec(tree, fn):
    return jax.tree.map(lambda l: jax.ShapeDtypeStruct(
        l.shape, l.dtype, sharding=NamedSharding(mesh, fn(l))), tree)

def summary(fn, *args):
    with mesh:
        txt = jax.jit(fn).lower(*args).compile().as_text()
    return collective_summary(txt, 4)

for arch in sys.argv[1:]:
    cfg = reduce_for_smoke(get_config(arch))
    api = build(cfg)
    for mode, comp in (("dpsgd", "none"), ("dpsgd", "int8"),
                       ("allreduce", "none")):
        run = RunConfig(mode=mode, optimizer="sgd", remat="none",
                        compression=comp)
        step = make_train_step(api, run, plan if mode == "dpsgd" else None,
                               constant_lr(0.01),
                               node_axes=("data",) if mode == "dpsgd"
                               else None)
        state = jax.eval_shape(
            lambda k: init_train_state(api, run, k, n_nodes=4),
            jax.random.key(0))
        nodes = mode == "dpsgd"
        st = spec(state, lambda l: P("data") if nodes and l.ndim else P())
        lead = (4, 2) if nodes else (8,)
        batch = {"tokens": jax.ShapeDtypeStruct(lead + (32,), jnp.int32)}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = jax.ShapeDtypeStruct(
                lead + (cfg.n_patches, cfg.d_model), jnp.dtype(cfg.dtype))
        batch = spec(batch, lambda l: P("data", *([None] * (l.ndim - 1))))
        out[f"{arch}/{mode}/{comp}"] = summary(step, st, batch)
    params = jax.eval_shape(
        lambda k: jax.tree.map(lambda l: jnp.broadcast_to(l, (4, *l.shape)),
                               api.init(k)), jax.random.key(0))
    ps = spec(params, lambda l: P("data"))
    for fused in (True, False):
        fn = shard_map(lambda t: gossip_mix_tree(t, plan, fused=fused),
                       mesh=mesh, in_specs=(P("data"),), out_specs=P("data"))
        out[f"{arch}/tree/{fused}"] = summary(fn, ps)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def hlo():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SIDE),
                          *ARCHS], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _node_leaves(arch: str) -> tuple[list, list]:
    """One node's parameter leaves (shape, dtype name), from the port's
    own tree, drawn on data-free tensors, and the tied ones among them
    (a tied embedding)."""
    cfg = reduce_for_smoke(get_config(arch))
    with FakeTensorMode():
        params = build(cfg, "cpu").init(torch.Generator())
        leaves = [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
                for x in _leaves(params)]
        emb = params["embed"]["embedding"]
        tied = [(tuple(emb.shape), str(emb.dtype).removeprefix("torch."))] \
            if cfg.tie_embeddings else []
        return leaves, tied


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what,mode,fused,comp", [
    ("dpsgd/none", "dpsgd", False, "none"),
    ("dpsgd/int8", "dpsgd", False, "int8"),
    ("tree/True", "dpsgd", True, "none"),
    ("tree/False", "dpsgd", False, "none")])
def test_collective_permute_bytes_equal_the_hlo(hlo, arch, what, mode,
                                                fused, comp):
    """Mode B's collective-permutes: the step's per-leaf gossip (the
    reference's step mixes leaf by leaf), its int8 payloads and scales, and
    ``gossip_mix_tree`` fused (one buffer per dtype) and per leaf."""
    want = hlo[f"{arch}/{what}"]["collective-permute"]
    got = step_collectives(_node_leaves(arch)[0], mode,
                           plan=ring_plan(("data",), (4,), 1), fused=fused,
                           compression=comp)["collectives"]
    assert got["collective-permute"]["result_bytes"] == want["result_bytes"]
    assert got["collective-permute"]["count"] == want["count"]
    assert got["collective-permute"]["link_bytes"] == want["link_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_allreduce_bytes_equal_the_hlo_up_to_the_metrics(hlo, arch):
    """Mode A's gradient all-reduce (XLA combines the leaves' into fewer
    ops: the bytes are held, not the count; qwen2-vl-2b's tied embedding
    reduced once for the lookup and once for the head), and the Mode B
    step's only all-reduce, the loss's mean."""
    leaves, tied = _node_leaves(arch)
    want = hlo[f"{arch}/allreduce/none"]["all-reduce"]["result_bytes"]
    got = step_collectives(leaves, "allreduce", n_nodes=4,
                           tied=tied)["collectives"]
    assert 0 <= want - got["all-reduce"]["result_bytes"] <= 64
    assert got["collective-permute"]["count"] == 0
    for what in ("dpsgd/none", "dpsgd/int8"):
        assert hlo[f"{arch}/{what}"]["all-reduce"]["result_bytes"] <= 64


def test_allreduce_plan_is_a_pmean_of_every_leaf():
    leaves = [((8, 4), "float32"), ((3,), "bfloat16"), ((), "float32")]
    got = step_collectives(leaves, "dpsgd", plan=allreduce_plan(
        ("data",), (4,)))["collectives"]
    assert got["all-reduce"] == {"count": 3, "result_bytes": 128 + 6 + 4,
                                 "link_bytes": 2 * 138 * 3 / 4}
    assert got["total_count"] == 3


def test_summary_split_and_link_formulas():
    """hlo.py's link formulas, and the split by loop depth: Mode A's
    all-reduce inside the microbatch loop when the step accumulates."""
    assert link_bytes("collective-permute", 100, 4) == 100.0
    assert link_bytes("all-gather", 100, 4) == 75.0
    assert link_bytes("reduce-scatter", 100, 4) == 300.0
    assert link_bytes("all-to-all", 100, 1) == 50.0     # g at least 2
    flat, split = summarize([("all-reduce", 40, 1), ("collective-permute",
                                                     8, 0)], 4)
    assert flat["total_count"] == 2 and set(OPS) <= set(flat)
    assert split["toplevel"]["collective-permute"]["count"] == 1
    assert split["loop_depth_1"]["all-reduce"]["result_bytes"] == 40
    assert split["in_loop"]["total_link_bytes"] == 60.0
    leaves = [((10,), "float32")]
    one = step_collectives(leaves, "allreduce", n_nodes=4)
    acc = step_collectives(leaves, "allreduce", n_nodes=4, microbatch=4)
    assert one["collectives_split"]["toplevel"]["total_count"] == 1
    assert acc["collectives_split"]["loop_depth_1"]["total_count"] == 1
    with pytest.raises(ValueError, match="plan"):
        step_collectives(leaves, "dpsgd")
