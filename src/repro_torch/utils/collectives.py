"""Collective bytes of a distributed step, reckoned from its gossip plan.

The torch counterpart of ``repro.utils.hlo``. The JAX package reads its
collectives from the compiled, partitioned HLO of a step; the port has no
HLO, so this module reckons the same summary from what decides it: the
gossip plan and the parameter buffers of one node. Per device (one node a
device, no tensor parallelism), each kind gets ``count``,
``result_bytes`` (the summed bytes of the ops' results) and
``link_bytes``, the modeled per-device link traffic of ``hlo.py``:

  collective-permute: result bytes        (one hop, send+recv overlap)
  all-gather:         result * (g-1)/g    (ring AG receives all but own shard)
  reduce-scatter:     operand ~= result*g, traffic result * (g-1)
  all-reduce:         2 * result * (g-1)/g (ring RS+AG)
  all-to-all:         result * (g-1)/g

with g the group: every node of the plan. What each step issues:

* Mode B (``dpsgd``), a gossip plan: one collective-permute a round for
  each buffer, the buffers grouped as ``core/gossip.py:gossip_mix_tree``
  groups them: one per dtype (``fused``, ``utils.tree.tree_to_buffers``)
  or one per leaf. With compressed messages (``bf16`` / ``int8``) each
  leaf is sent on its own, as the reference's ``train/step.py:
  _mix_leaf_compressed`` does: the bf16 message, or the int8 payload and
  its fp32 scales (one per last-dim row), each a collective-permute.
* Mode B, an ``allreduce`` plan: a pmean of every leaf, an all-reduce of
  its bytes.
* Mode A (``allreduce``): the gradient's all-reduce, every leaf's bytes in
  its dtype, once a step, or once a microbatch inside the accumulation
  loop (loop depth 1) when the step accumulates microbatches. A leaf used
  twice (a tied embedding: the lookup and the head) has its two partial
  gradients reduced each on its own, as the reference's compiled Mode A
  step reduces them, so its bytes count twice.

The step's scalar metrics (the loss's mean, a few bytes) are left out.
On one card the port mixes the nodes by the rows mix over ``plan_w`` and
sends nothing; over a fleet of one node a rank (``train.step``'s Mode B)
each rank sends these bytes (``core.gossip.exchange.sent_bytes``), and
they are what ``launch.dryrun`` reports.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = ["OPS", "link_bytes", "summarize", "step_collectives"]

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")

_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
          "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
          "bool": 1}


def link_bytes(op: str, result: float, group: int) -> float:
    """The modeled per-device link traffic of one ``op`` with ``result``
    bytes over a group of ``group`` devices (at least 2)."""
    g = max(group, 2)
    if op == "collective-permute":
        return float(result)
    if op == "all-reduce":
        return 2.0 * result * (g - 1) / g
    if op == "reduce-scatter":
        return float(result * (g - 1))
    return result * (g - 1) / g          # all-gather, all-to-all


def _bucket() -> dict:
    return {op: {"count": 0, "result_bytes": 0, "link_bytes": 0.0}
            for op in OPS}


def _totals(bucket: dict) -> dict:
    bucket["total_link_bytes"] = sum(
        v["link_bytes"] for v in bucket.values() if isinstance(v, dict))
    bucket["total_count"] = sum(
        v["count"] for v in bucket.values() if isinstance(v, dict))
    return bucket


def summarize(ops: Iterable[tuple[str, int, int]],
              group: int) -> tuple[dict, dict]:
    """(summary, split) of ``ops``, each (kind, result bytes, loop depth),
    in ``hlo.collective_summary``'s and ``collective_summary_split``'s
    forms: per kind {count, result_bytes, link_bytes} with the totals, and
    the same bucketed ``toplevel`` (depth 0), ``loop_depth_1``,
    ``loop_depth_2`` and ``in_loop`` (depth >= 1)."""
    flat = _bucket()
    split = {k: _bucket() for k in ("toplevel", "loop_depth_1",
                                    "loop_depth_2", "in_loop")}
    for op, rb, depth in ops:
        link = link_bytes(op, rb, group)
        keys = ["toplevel"] if depth == 0 else (
            ["loop_depth_1", "in_loop"] if depth == 1 else
            ["loop_depth_2", "in_loop"])
        for b in [flat] + [split[k] for k in keys]:
            b[op]["count"] += 1
            b[op]["result_bytes"] += rb
            b[op]["link_bytes"] += link
    return _totals(flat), {k: _totals(v) for k, v in split.items()}


def _leaf_bytes(shape: Sequence[int], dtype: str) -> int:
    return int(np.prod(shape, dtype=np.int64)) * _BYTES[dtype]


def step_collectives(leaves: Sequence[tuple[tuple, str]], mode: str,
                     plan=None, fused: bool = True,
                     compression: str = "none",
                     microbatch: int = 0,
                     n_nodes: Optional[int] = None,
                     tied: Sequence[tuple[tuple, str]] = ()) -> dict:
    """The collectives of one step of ``mode`` over one node's parameter
    leaves, each (shape, dtype name) in ``jax.tree``'s order: Mode B
    (``"dpsgd"``) by ``plan`` (a ``core.gossip.GossipPlan``), Mode A
    (``"allreduce"``) over ``n_nodes`` data-parallel replicas, ``tied``
    the leaves among them used twice. Returns {"collectives": summary,
    "collectives_split": split, "group": g}."""
    ops: list[tuple[str, int, int]] = []
    if mode == "allreduce":
        group = int(n_nodes or 1)
        depth = 1 if microbatch and microbatch > 1 else 0
        ops += [("all-reduce", _leaf_bytes(s, d), depth)
                for s, d in [*leaves, *tied]]
    elif mode == "dpsgd":
        if plan is None:
            raise ValueError("Mode B (dpsgd) needs a gossip plan")
        group = plan.n_nodes
        if plan.kind == "allreduce":
            ops += [("all-reduce", _leaf_bytes(s, d), 0) for s, d in leaves]
        elif compression != "none":
            for _ in plan.rounds:
                for shape, dtype in leaves:
                    if compression == "bf16":
                        ops.append(("collective-permute",
                                    _leaf_bytes(shape, "bfloat16"), 0))
                    elif compression == "int8":
                        rows = tuple(shape[:-1]) + (1,) if shape else ()
                        ops += [("collective-permute",
                                 _leaf_bytes(shape, "int8"), 0),
                                ("collective-permute",
                                 _leaf_bytes(rows, "float32"), 0)]
                    else:
                        raise ValueError(compression)
        else:
            if fused:
                groups: dict[str, int] = {}
                for shape, dtype in leaves:
                    groups[dtype] = groups.get(dtype, 0) + \
                        _leaf_bytes(shape, dtype)
                buffers = list(groups.values())
            else:
                buffers = [_leaf_bytes(s, d) for s, d in leaves]
            ops += [("collective-permute", rb, 0)
                    for _ in plan.rounds for rb in buffers]
    else:
        raise ValueError(mode)
    summary, split = summarize(ops, group)
    return {"collectives": summary, "collectives_split": split,
            "group": group}
