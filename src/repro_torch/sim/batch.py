"""Batched train-on-trace: Monte-Carlo D-PSGD training over precomputed
wireless traces.

The per-round driver (``trace.simulate_dpsgd_cnn``) interleaves the channel
plane and training: one simulator round, one step and one synchronisation
per mixing round. For Monte-Carlo sweeps over fading/mobility/churn seeds
the channel realization does not depend on the parameters at all, so this
module decouples the two:

1. ``trace.precompute_trace`` runs the simulator driver-less and emits
   fixed-shape arrays — stacked realized mixing matrices ``w_eff``
   (rounds, n, n), live-node masks, and simulated-time stamps.
2. ``train_on_trace`` consumes them in one round loop on the device
   (``core.dpsgd.dpsgd_masked_step`` per round: dead nodes keep identity W
   rows and zero gradient weight, so churn needs no reshape).
3. ``train_on_traces`` / ``train_cnn_on_traces`` run a whole (S,) family
   of traces per round: one accuracy-vs-simulated-time curve per trace.

The torch counterpart of ``repro.sim.batch``. The JAX package's
``lax.scan`` under ``vmap`` becomes a round loop whose body — the S
traces' masked (or compressed) steps one after another, the watchdog's
rollback and the first live node's snapshot — is one ``graphs.GraphedStep``:
on the card one CUDA graph replayed per round for the whole family, with
every gossip mix in the hand-written kernels (``gossip_mix_rows`` on
uncompressed rounds; the int8 round's send ``quantize_int8_ef`` and receive
``gossip_mix_q8`` on int8 rounds), S launches of each per round. The
traces are never mixed through one block-diagonal W: a poisoned trace
would leak NaN into the others through its zero weights (0 * NaN = NaN).
The loop reads nothing back from the device; the one synchronisation is
where ``train_model_on_traces`` brings the results to the host.

Over a fleet (``mesh=``, ``launch.mesh.make_fleet_mesh``): ``_shard_family``
lays the family out as the reference does — the node axis of the
parameters and batches over the fleet's ranks when it divides, whole on
every rank when not — and each round's mix by the trace's dense,
time-varying W gathers the node rows over the fleet (for int8, the send's
payloads and scales) and runs the rank's rows of W through row 1 or the
q8 receive (``core.dpsgd``'s ``group`` path). The first live node's
snapshot is summed over the ranks from its owner; losses, rollbacks and
the final parameters are gathered once at the end. A mesh with a
``model`` axis (tensor parallelism, every family) also
lays every leaf out by ``train.shardings.param_specs`` over it (the
reference's ``node_param_specs``) and runs the family's loss under
``models.tp.use``; the snapshots and the final parameters are gathered
whole over it. The compressed rounds quantize the whole message,
gathered over the model axis, so that their scale blocks are one
device's.

Parity: on any trace the loop realizes exactly the per-round driver's
update sequence (same batches, same W order), so per-round losses match
the driver to float tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import dpsgd
from ..core.compression import QuantConfig
from ..core.dpsgd import DPSGDConfig, _tree_map, node_axis_size
from ..core.gossip import all_gather_nodes
from ..device import resolve_device
from ..graphs import GraphedStep
from .scenario import ScenarioConfig, get_scenario
from .trace import (TraceBatch, TrainTrace, driver_batch_indices,
                    model_batch_tokens, precompute_traces)

__all__ = ["train_on_trace", "train_on_traces", "train_on_trace_reference",
           "ModelAdapter", "train_model_on_traces", "train_cnn_on_traces",
           "transformer_adapter"]

PyTree = Any

_NO_PAYLOAD = QuantConfig(mode="none")
EVAL_CHUNK = 8          # snapshots per vmapped evaluation call

# one graphed round body per (loss_fn, config, payload, snapshot, watchdog):
# repeated sweeps replay the graphs captured by the first, as the JAX
# package's calls hit one jit cache entry
_STEPS: dict = {}


def _nonfinite_rows(node_params: PyTree) -> torch.Tensor:
    """(n,) bool: nodes whose parameters contain any NaN/inf leaf entry.

    ``node_axis_size`` enforces the shape contract first: every leaf must
    lead with the same node axis. Before that check, a ragged tree (one
    leaf per node, or a transposed stack) would have silently OR-reduced
    the wrong axis and rolled back the wrong rows."""
    n = node_axis_size(node_params, "watchdog node_params")
    leaves = dpsgd._leaves(node_params)
    flags = torch.zeros(n, dtype=torch.bool, device=leaves[0].device)
    for p in leaves:
        flags = flags | ~torch.isfinite(p.reshape(n, -1)).all(dim=1)
    return flags


def _row_where(mask: torch.Tensor, a: PyTree, b: PyTree) -> PyTree:
    """Per-leaf ``where`` on the leading node axis (shape contract: every
    leaf of ``a``/``b`` leads with a node axis matching ``mask``)."""
    n = node_axis_size(a, "_row_where operands")
    if tuple(mask.shape) != (n,):
        raise ValueError(
            f"row mask has shape {tuple(mask.shape)} but the operands' node "
            f"axis is {n}")

    def _sel(x, y):
        return torch.where(mask.reshape(n, *([1] * (x.dim() - 1))), x, y)
    return _tree_map(_sel, a, b)


def _stack(trees: list) -> PyTree:
    """The trees stacked on a new leading axis; one tree as a view (a
    family of one trace holds no second copy of its node-stacked state)."""
    if len(trees) == 1:
        return _tree_map(lambda x: x[None], trees[0])
    return _tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _snapshot(x: torch.Tensor, row: torch.Tensor, fleet) -> torch.Tensor:
    """Row ``row`` (a (1,) global node index on the device) of the node
    axis; over a fleet (``(group, lo)``) the owner's row, summed over the
    ranks (the others add zeros)."""
    if fleet is None:
        return x.index_select(0, row)[0]
    group, lo = fleet
    b = x.shape[0]
    local = row - lo
    mine = (local >= 0) & (local < b)
    got = x.index_select(0, local.clamp(0, b - 1))[0]
    got = torch.where(mine, got, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    dist.all_reduce(got, op=dist.ReduceOp.SUM, group=group)
    return got


def _family_body(loss_fn, config, payload, collect_node0, watchdog,
                 fleet=None, shards=None):
    """One round of an (S,) family: each trace's step in turn (its own W,
    mask, batch and residuals), then the watchdog's rollback to the
    round's input rows and the snapshot of row ``first[s]``. Outputs are
    stacked on the family axis. ``fleet`` (group, lo): the parameters,
    batch and mask are the rank's block of nodes from row lo, W whole.
    ``shards`` (``(model, specs)``, ``_shard_model``): the leaves are the
    rank's shards over the model axis; a compressed round quantizes the
    whole leaves (gathered over it, the shard taken back after), so its
    scale blocks are one device's, and a row the watchdog finds bad on
    any rank of the axis rolls back on all of them."""
    from ..models import tp

    compressed = payload.mode != "none"
    group = None if fleet is None else fleet[0]
    model, whole = tp.ONE, None
    if shards is not None:
        from ..train.shardings import gather_model, shard_model

        model, specs = shards
        whole = (lambda t: gather_model(t, specs, model, dst=None),
                 lambda t: shard_model(t, specs, model))

    def body(params, res, batch, w, active, first):
        out: dict = {"params": [], "losses": [], "res": [], "node0": [],
                     "rollbacks": []}
        for s in range(w.shape[0]):
            p = _tree_map(lambda x: x[s], params)
            b = _tree_map(lambda x: x[s], batch)
            if compressed:
                new_p, new_r, losses = dpsgd.dpsgd_masked_compressed_step(
                    loss_fn, p, b, w[s], active[s],
                    _tree_map(lambda x: x[s], res), payload, config, group,
                    whole)
            else:
                new_p, losses = dpsgd.dpsgd_masked_step(
                    loss_fn, p, b, w[s], active[s], config, group)
            if watchdog:
                bad = _nonfinite_rows(new_p)
                if model.active:
                    bad = tp.all_max(bad.to(torch.uint8), model).bool()
                new_p = _row_where(bad, p, new_p)
                if compressed:
                    new_r = _row_where(bad, dpsgd.zero_residuals(new_r),
                                       new_r)
                out["rollbacks"].append(bad)
            if collect_node0:
                row = first[s].reshape(1)
                out["node0"].append(_tree_map(
                    lambda x: _snapshot(x, row, fleet), new_p))
            out["params"].append(new_p)
            out["losses"].append(losses)
            if compressed:
                out["res"].append(new_r)
        return {k: _stack(v) for k, v in out.items() if v}
    return body


class _EagerStep:
    """A round body run eagerly, with ``GraphedStep``'s ``stage``
    interface."""

    def __init__(self, body: Callable):
        self._body = body

    def stage(self, *args) -> Callable:
        return lambda: self._body(*args)


def _family_step(loss_fn, config, payload, collect_node0,
                 watchdog, fleet=None):
    """The family's round body: graphed, or eager for a family sharded
    over a fleet (``fleet`` given): its round, the all-gathers and the
    snapshot's all_reduce inside, hung under CUDA graph capture on four
    H100s, so a layout over ranks runs eager, on the card and the CPU."""
    key = (loss_fn, config, payload, collect_node0, watchdog, fleet)
    if fleet is not None:
        return _EagerStep(_family_body(*key))
    step = _STEPS.get(key)
    if step is None:
        step = _STEPS[key] = GraphedStep(_family_body(*key))
    return step


def _shard_family(params0: PyTree, batches: PyTree, fleet, n: int):
    """Lay the (S,)-batched family out on the fleet, as the reference's
    ``_shard_family`` lays it on a mesh: node parameters (S, n, ...) and
    batch leaves (S, rounds, n, ...) keep the rank's block of the node
    axis when n divides over the fleet (``train.shardings.
    node_param_specs`` with the Monte-Carlo axis in front), each a tensor
    of its own; else every rank keeps the whole axis."""
    if not fleet.sharded(n):
        return params0, batches
    lo, hi = fleet.block(n)
    params0 = _tree_map(lambda x: x[:, lo:hi].clone(), params0)
    batches = _tree_map(lambda x: x[:, :, lo:hi].clone()
                        if x.dim() >= 3 and x.shape[2] == n else x, batches)
    return params0, batches


def _model_specs(tree: PyTree, size: int):
    """``param_specs`` of ``tree`` over a model axis of ``size`` (aligned
    to the trailing dims: the family and node axes in front pass
    through). A tree none of whose leaves the specs split (a model
    without tensor parallelism: the CNN, or no tensors at all) raises: it
    is never replicated silently."""
    from ..train.shardings import param_specs, spec_leaves

    leaves = dpsgd._leaves(tree)
    specs = param_specs(tree, size) if all(
        hasattr(x, "ndim") for x in leaves) else None
    if specs is None or not any("model" in sp for sp in spec_leaves(specs)):
        raise NotImplementedError(
            f"a 'model' axis of {size} over a tree no leaf of which "
            "tensor parallelism splits: such a model (the CNN) has no "
            "tensor-parallel layout, and is never replicated silently")
    return specs


def _shard_model(params0: PyTree, model):
    """(params, (model, specs)): every leaf's shard over ``model`` by
    ``_model_specs``; (params0, None) for an axis of one."""
    if not model.active:
        return params0, None
    from ..train.shardings import shard_model

    specs = _model_specs(params0, model.size)
    return shard_model(params0, specs, model), (model, specs)


def _laid_out(owned: list, batches: PyTree, mesh, n: int):
    """(owned, batches, fleet, shards): the family laid out on ``mesh``'s
    fleet (``_shard_family``) and model axis (``_shard_model``), or as it
    is for no mesh."""
    if mesh is None:
        return owned, batches, None, None
    from ..models import tp
    from ..train.shardings import fleet_of

    fleet = fleet_of(mesh)
    params0, batches = _shard_family(owned.pop(), batches, fleet, n)
    params0, shards = _shard_model(params0, tp.model_of(mesh))
    return [params0], batches, fleet, shards


def _train_family(loss_fn, owned, w_seq, live_seq, batch_seq, config,
                  collect_node0, payload, active_seq, watchdog,
                  what: str = "train_on_trace", fleet=None, shards=None):
    """The round loop over an (S,) family: ``owned`` a list holding the
    initial parameters, leaves (S, n, ...), which the loop pops, so that
    it holds their only reference and drops them once the first round's
    graph has taken them in (callers keep none: a node-stacked copy of
    recurrentgemma-2b's 3-layer cut is 10.2 GiB);
    ``w_seq`` (S, rounds, n, n), masks (S, rounds, n), batch leaves
    (S, rounds, n, ...). Everything moves to the parameters' device once;
    each round replays the family's graphed body on slices of it, with no
    read back to the host. Each output leaf of a round is a tensor of its
    own (``GraphedStep``), so the kept losses, snapshots and rollbacks
    hold nothing else of their round. ``collect_node0`` True keeps every
    round's snapshot, a collection of round indices only those rounds'.

    ``fleet`` (a ``train.shardings.Fleet``): the parameters and batches
    are the rank's block of the node axis (``_shard_family``), the masks
    and W whole; the losses, rollbacks and final parameters come back
    whole; the rounds then run eager (``_family_step``). ``shards``
    (``(model, specs)``, ``_shard_model``): every leaf is the rank's shard
    over the model axis, the rounds run under ``models.tp.use(model)``
    (eager), and the snapshots and final parameters come back whole."""
    from ..models import tp

    model = tp.ONE if shards is None else shards[0]
    if payload.mode == "auto":
        raise ValueError(
            f"{what} needs a concrete payload mode; \"auto\" is "
            "resolved by the joint planner at simulation time — train with "
            "the mode the plan actually picked")
    compressed = payload.mode != "none"
    params = owned.pop()
    dev = dpsgd._device_of(params)
    w = torch.as_tensor(w_seq, dtype=torch.float32, device=dev)
    live = torch.as_tensor(live_seq, dtype=torch.bool, device=dev)
    # crashed-but-alive nodes (fault plane) skip their gradient; without a
    # fault plane the two masks coincide
    grad_mask = live if active_seq is None else torch.as_tensor(
        active_seq, dtype=torch.bool, device=dev)
    n = w.shape[-1]
    sharded = fleet is not None and fleet.sharded(n)
    body_fleet = None
    if sharded:
        lo, hi = fleet.block(n)
        grad_mask = grad_mask[:, :, lo:hi]
        body_fleet = (fleet.group, lo)
    batch = _tree_map(lambda x: torch.as_tensor(x, device=dev), batch_seq)
    # first live row per round (original-id order), computed on the device
    first = live.to(torch.int32).argmax(-1) if collect_node0 else None
    key = (loss_fn, config, payload, bool(collect_node0), watchdog,
           body_fleet)
    # a family over a model axis runs eager too (its capture is not tried)
    step = _EagerStep(_family_body(*key, shards=shards)) if model.active \
        else _family_step(*key)

    res = dpsgd.zero_residuals(params) if compressed else None
    losses, node0, rollbacks = [], [], []
    for r in range(w.shape[1]):
        run = step.stage(params, res, _tree_map(lambda x: x[:, r], batch),
                         w[:, r], grad_mask[:, r],
                         None if first is None else first[:, r])
        # the graph's static inputs hold them now: no second copy of the
        # parameters lives while the round makes the next
        params = res = None
        with tp.use(model):
            out = run()
        params, res = out["params"], out.get("res")
        losses.append(out["losses"])
        if collect_node0 and (collect_node0 is True or r in collect_node0):
            node0.append(out["node0"])
        if watchdog:
            rollbacks.append(out["rollbacks"])
    losses = torch.stack(losses, 1)
    rollbacks = torch.stack(rollbacks, 1) if watchdog else None
    if sharded:
        params = _tree_map(
            lambda x: all_gather_nodes(x, n, fleet.group, dim=1), params)
        losses = all_gather_nodes(losses, n, fleet.group, dim=2)
        if watchdog:
            rollbacks = all_gather_nodes(rollbacks, n, fleet.group, dim=2)
    if model.active:
        from ..train.shardings import gather_model

        params = gather_model(params, shards[1], model, dst=None)
        node0 = [gather_model(t, shards[1], model, dst=None) for t in node0]
    outs = (params, losses)
    if collect_node0:
        outs += (_tree_map(lambda *xs: torch.stack(xs, 1), *node0),)
    if watchdog:
        outs += (rollbacks,)
    return outs


def train_on_trace(
    loss_fn: Callable[[PyTree, PyTree], Any],
    node_params: PyTree,
    w_seq,
    live_seq,
    batch_seq: PyTree,
    config: DPSGDConfig = DPSGDConfig(),
    collect_node0: bool = False,
    payload: QuantConfig = _NO_PAYLOAD,
    active_seq=None,
    watchdog: bool = False,
    mesh=None,
):
    """Train over one precomputed trace, one graphed round body per round.

    ``w_seq`` (rounds, n, n) and ``live_seq`` (rounds, n) come from a
    ``TrainTrace``; ``batch_seq`` leaves carry (rounds, n, ...) per-round
    per-node minibatches (dead rows may hold arbitrary filler — their
    gradients are masked off). Arrays may be numpy or tensors; they move
    to the device of ``node_params`` once. Returns ``(final_params,
    losses)`` with ``losses`` (rounds, n) raw per-node losses (mask with
    ``live_seq`` before aggregating), plus per-round snapshots of the first
    live node's parameters when ``collect_node0`` (for post-hoc accuracy
    curves), as tensors on that device: every round's for True, or only
    the rounds of a collection of round indices. The snapshot stack costs
    O(rounds kept x |node params|) device memory.

    ``payload`` selects the gossip compression of
    ``core.dpsgd.dpsgd_masked_compressed_step``: with a quantized mode the
    loop carries per-node error-feedback residuals (zero-initialized,
    masked for dead nodes) alongside the parameters; ``mode="none"`` (the
    default) runs the exact ``dpsgd_masked_step`` body unchanged.

    ``active_seq`` (rounds, n), when given, is the gradient mask instead of
    ``live_seq`` — the fault plane's "live but crashed this round" nodes
    keep stale parameters (identity W rows) without taking a local step,
    while ``live_seq`` still decides whose parameters the ``collect_node0``
    snapshot tracks (the first *churn*-live node, matching the per-round
    driver's row 0 regardless of transient crashes).

    ``watchdog`` arms a per-node convergence guard: after each round, any
    node whose parameters picked up a NaN/inf rolls back to its last
    finite parameters (error-feedback residuals reset to zero on rollback
    so poisoned quantization error cannot re-infect it). Returns one extra
    (rounds, n) bool array of rollback events as the last output.

    ``mesh`` (a fleet mesh, ``launch.mesh.make_fleet_mesh``): every rank
    passes the whole inputs and gets the whole outputs back; the rounds
    run with the node axis over the fleet (``_shard_family``).
    """
    one = lambda x: torch.as_tensor(x)[None]              # noqa: E731
    owned, batches, fleet, shards = _laid_out(
        [_tree_map(lambda p: p[None], node_params)],
        _tree_map(one, batch_seq), mesh, int(np.shape(w_seq)[-1]))
    outs = _train_family(
        loss_fn, owned, one(w_seq), one(live_seq), batches, config,
        collect_node0, payload,
        None if active_seq is None else one(active_seq), watchdog,
        fleet=fleet, shards=shards)
    # (final, losses[, node0_snaps][, rollbacks]) — extras in that order
    return tuple(_tree_map(lambda x: x[0], o) for o in outs)


def train_on_traces(
    loss_fn: Callable[[PyTree, PyTree], Any],
    node_params: PyTree,
    w_seq,
    live_seq,
    batch_seq: PyTree,
    config: DPSGDConfig = DPSGDConfig(),
    collect_node0: bool = False,
    params_batched: bool = False,
    payload: QuantConfig = _NO_PAYLOAD,
    active_seq=None,
    watchdog: bool = False,
    mesh=None,
):
    """``train_on_trace`` over a leading Monte-Carlo axis.

    Every array gains a leading (S,) axis (``TraceBatch`` layout). With
    ``params_batched`` the initial parameters carry the axis too (per-seed
    inits); otherwise one init is shared by every trace. One graphed round
    body steps all S traces, each on its own state, so each round is one
    graph replay for the whole family; every output gains the (S,) axis.
    ``mesh`` as for ``train_on_trace``.
    """
    s = int(np.shape(w_seq)[0])
    owned = [node_params if params_batched else _tree_map(
        lambda p: p[None].expand(s, *p.shape).clone(), node_params)]
    del node_params     # the round loop drops them once its graph has them
    owned, batch_seq, fleet, shards = _laid_out(owned, batch_seq, mesh,
                                                int(np.shape(w_seq)[-1]))
    return _train_family(loss_fn, owned, w_seq, live_seq, batch_seq,
                         config, collect_node0, payload, active_seq,
                         watchdog, what="train_on_traces", fleet=fleet,
                         shards=shards)


def train_on_trace_reference(
    loss_fn: Callable[[PyTree, PyTree], Any],
    node_params: PyTree,
    w_seq,
    live_seq,
    batch_seq: PyTree,
    config: DPSGDConfig = DPSGDConfig(),
    payload: QuantConfig = _NO_PAYLOAD,
    active_seq=None,
):
    """Per-round reference for ``train_on_trace``: a host-side loop calling
    one built D-PSGD step per round (``dpsgd.make_dpsgd_masked_step`` /
    ``make_dpsgd_compressed_step``, a CUDA graph each on the card) and
    reading each round's losses back — exactly the update sequence the
    round loop realizes, kept as the parity oracle for any model (the
    CNN's analogue is ``trace.simulate_dpsgd_cnn``, which also runs the
    channel plane live). Same inputs as ``train_on_trace``; returns
    ``(final_params, losses)`` with ``losses`` (rounds, n) raw per-node
    numpy. No watchdog/snapshot variants — use ``train_on_trace``."""
    if payload.mode == "auto":
        raise ValueError(
            "train_on_trace_reference needs a concrete payload mode")
    compressed = payload.mode != "none"
    dev = dpsgd._device_of(node_params)
    if compressed:
        step = dpsgd.make_dpsgd_compressed_step(loss_fn, payload, config)
        res = dpsgd.zero_residuals(node_params)
    else:
        step = dpsgd.make_dpsgd_masked_step(loss_fn, config)
    w_seq = np.asarray(w_seq)
    grad_mask = np.asarray(live_seq if active_seq is None else active_seq)
    params, losses = node_params, []
    for r in range(w_seq.shape[0]):
        b = _tree_map(lambda x, r=r: torch.as_tensor(x[r], device=dev),
                      batch_seq)
        w = torch.as_tensor(w_seq[r], dtype=torch.float32, device=dev)
        act = torch.as_tensor(grad_mask[r], device=dev)
        if compressed:
            params, res, l = step(params, b, w, act, res)
        else:
            params, l = step(params, b, w, act)
        losses.append(l.detach().cpu().numpy())
    return params, np.stack(losses)


def _driver_batches(cfg: ScenarioConfig, tr: TrainTrace, shard_x: np.ndarray,
                    shard_y: np.ndarray, batch: int):
    """Per-round minibatch tensors replaying exactly the per-round driver's
    sampling (``trace.driver_batch_indices`` is the shared contract):
    compacted row k maps to the k-th live original id. Dead rows repeat
    their shard's row 0 (inert filler)."""
    n, rounds = tr.n_nodes, tr.n_rounds
    if shard_x.shape[0] != n or shard_y.shape[0] != n:
        # shards are indexed by original node id below; a shard stack of
        # any other width would silently feed node i node j's data
        raise ValueError(
            f"data shards cover {shard_x.shape[0]} nodes "
            f"(labels: {shard_y.shape[0]}) but the trace has {n}")
    per_node = shard_x.shape[1]
    imgs = np.empty((rounds, n, batch, *shard_x.shape[2:]), shard_x.dtype)
    labs = np.empty((rounds, n, batch), shard_y.dtype)
    imgs[:] = shard_x[None, :, 0, None]
    labs[:] = shard_y[None, :, 0, None]
    for r in range(rounds):
        ids = np.flatnonzero(tr.live[r])
        idx = driver_batch_indices(cfg.seed, r, ids.size, per_node, batch)
        for k, i in enumerate(ids):
            imgs[r, i] = shard_x[i, idx[k]]
            labs[r, i] = shard_y[i, idx[k]]
    return imgs, labs


def _cnn_loss(p, b):
    """Module-level loss, so repeated ``train_cnn_on_traces`` calls key the
    same graphed round body (a per-call lambda would capture anew every
    sweep)."""
    from ..models import cnn
    return cnn.cnn_loss(p, b)


@dataclasses.dataclass(frozen=True)
class ModelAdapter:
    """What ``train_model_on_traces`` needs to train *any* tree model on a
    wireless trace — the training plane is model-agnostic; all model
    specifics live behind these callables:

    * ``init_params(seed) -> params`` — one node's parameter tree.
    * ``loss_fn(params, batch) -> scalar`` — vmapped over the node axis by
      the D-PSGD step. Must be a **stable callable object** (module-level
      function or a closure built once): it keys the graphed round body,
      so a fresh lambda per call would capture anew every sweep.
    * ``batch_fn(cfg, trace) -> tree`` of (rounds, n_nodes, ...) numpy
      arrays — per-round per-node minibatches replaying the shared
      sampling contract (``trace.driver_batch_indices``); dead rows may
      hold inert filler.
    * ``eval_fn(params) -> scalar`` (optional) — one node's eval metric,
      vmapped over chunks of snapshots; None skips the accuracy curve.
    * ``model_bits`` — fp32 wire bits of one message; scenario configs are
      snapped to it so Eq. 3 charges the airtime of *this* model.
    * ``param_shapes`` — leaf shapes as a tuple of tuples, forwarded to
      ``ScenarioConfig.model_shapes`` so per-leaf payload framing charges
      exact wire bits; empty () keeps the config's flat accounting (the
      CNN instance does, preserving every flat-accounting trace
      bit-for-bit).
    """
    name: str
    init_params: Callable[[int], PyTree]
    loss_fn: Callable[[PyTree, PyTree], Any]
    batch_fn: Callable[[ScenarioConfig, TrainTrace], PyTree]
    eval_fn: Optional[Callable[[PyTree], Any]] = None
    model_bits: float = 0.0
    param_shapes: tuple = ()


def _cnn_adapter(shard_x: np.ndarray, shard_y: np.ndarray, batch: int,
                 test_x, test_y, device) -> ModelAdapter:
    """The paper's CNN as a ``ModelAdapter`` (data shards baked in; the
    test set moves to ``device`` once)."""
    from ..models import cnn

    dev = resolve_device(device)
    test_x = torch.as_tensor(test_x, device=dev)
    test_y = torch.as_tensor(test_y, device=dev)

    def init_params(seed: int) -> PyTree:
        # the driver's init (trace.simulate_dpsgd_cnn): a family of one
        # starts where the driver starts
        return cnn.cnn_init(torch.Generator().manual_seed(seed), dev)

    def batch_fn(cfg: ScenarioConfig, tr: TrainTrace) -> PyTree:
        imgs, labs = _driver_batches(cfg, tr, shard_x, shard_y, batch)
        return {"images": imgs, "labels": labs}

    def eval_fn(p: PyTree):
        return cnn.cnn_accuracy(p, test_x, test_y)

    return ModelAdapter(
        name="cnn", init_params=init_params, loss_fn=_cnn_loss,
        batch_fn=batch_fn, eval_fn=eval_fn,
        model_bits=float(cnn.MODEL_BITS), param_shapes=())


def _host_token_batches(cfg: ScenarioConfig, tr: TrainTrace, batch: int,
                        seq_len: int, vocab: int) -> np.ndarray:
    """Host-side per-round LM minibatch tensors, the token analogue of
    ``_driver_batches``: compacted row k of ``trace.model_batch_tokens``
    scatters to the k-th live original node id; dead rows stay zero-filled
    (inert — their gradient weight is zero under the masked step)."""
    toks = np.zeros((tr.n_rounds, tr.n_nodes, batch, seq_len), np.int32)
    for r in range(tr.n_rounds):
        ids = np.flatnonzero(tr.live[r])
        toks[r, ids] = model_batch_tokens(
            cfg.seed, r, ids.size, batch, seq_len, vocab)
    return toks


def transformer_adapter(arch="stablelm-3b", batch: int = 4,
                        seq_len: int = 32, eval_batch: int = 8,
                        device: str | torch.device = "cuda") -> ModelAdapter:
    """A real transformer as a ``ModelAdapter``: ``arch`` by name is the
    smoke-reduced config from ``configs/`` (a ``ModelConfig`` is taken as
    it is), built through ``models.api.build`` on ``device``, trained on
    the deterministic structured token stream
    (``trace.model_batch_tokens``) and evaluated by next-token accuracy on
    a held-out ``token_stream`` batch. ``param_shapes`` carries the
    parameter tree's leaf shapes in the JAX package's leaf order, so
    scenario configs charge the exact per-leaf wire framing. Inits draw
    from a CPU generator seeded per trace (the same weights on every
    device); attention's gradient is the flash backward kernel on the card
    and its plain version on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs import get_config
    from ..configs.base import reduce_for_smoke
    from ..data.synthetic import token_stream
    from ..models import transformer
    from ..models.api import build

    mcfg = reduce_for_smoke(get_config(arch)) if isinstance(arch, str) \
        else arch
    if mcfg.is_encdec:
        raise ValueError(
            "transformer_adapter drives the decoder-only lm batch layout; "
            f"config {mcfg.name!r} is encoder-decoder")
    dev = resolve_device(device)
    api = build(mcfg, dev)

    def init_params(seed: int) -> PyTree:
        return api.init(torch.Generator().manual_seed(seed))

    # the leaf shapes without drawing a parameter (jax.eval_shape's role)
    with FakeTensorMode():
        shapes = transformer.init_params(mcfg, torch.Generator(), "cpu")
    leaf_shapes = tuple(tuple(int(d) for d in leaf.shape)
                        for leaf in dpsgd._leaves(shapes))
    # fp32 wire lanes (the payload accounting's base dtype), whatever the
    # in-memory param dtype — matches ScenarioConfig.model_shapes validation
    model_bits = float(sum(
        32 * int(np.prod(s, dtype=np.int64)) for s in leaf_shapes))

    def loss_fn(p: PyTree, b: PyTree):
        return api.loss(p, b)

    def batch_fn(cfg: ScenarioConfig, tr: TrainTrace) -> PyTree:
        return {"tokens": _host_token_batches(cfg, tr, batch, seq_len,
                                              mcfg.vocab_size)}

    eval_tokens = torch.as_tensor(next(token_stream(
        eval_batch, seq_len, mcfg.vocab_size, seed=1)), device=dev)

    def eval_fn(p: PyTree):
        # full-sequence logits (api.prefill only returns the last position)
        logits = transformer.apply(mcfg, p, eval_tokens)
        pred = torch.argmax(logits[:, :-1], dim=-1)
        return (pred == eval_tokens[:, 1:]).to(torch.float32).mean()

    return ModelAdapter(
        name=mcfg.name, init_params=init_params, loss_fn=loss_fn,
        batch_fn=batch_fn, eval_fn=eval_fn, model_bits=model_bits,
        param_shapes=leaf_shapes)


def _evaluate(eval_fn: Callable, snaps: PyTree, chunk: int) -> torch.Tensor:
    """``eval_fn`` over the leading axis of ``snaps``, ``chunk`` snapshots
    per vmapped call: the activations of a whole family's snapshots at
    once (the paper's 10 000 test images: ~230 MB a snapshot for conv1's
    output alone) would not fit on the card."""
    count = dpsgd._leaves(snaps)[0].shape[0]
    vm = torch.func.vmap(eval_fn)
    return torch.cat([
        vm(_tree_map(lambda p, i=i: p[i:i + chunk], snaps))
        for i in range(0, count, chunk)])


def _family_inputs(adapter: ModelAdapter, cfgs: list, traces: TraceBatch,
                   n_nodes: int, dev: torch.device):
    """Per-seed initial node parameters (S, n, ...) and the batch tree
    (S, rounds, n, ...) on ``dev``."""
    built = [adapter.batch_fn(c, t) for c, t in zip(cfgs, traces.traces)]
    batches = _tree_map(lambda *xs: torch.from_numpy(np.stack(xs)).to(dev),
                        *built)
    params0 = _stack([dpsgd.replicate(
        _tree_map(lambda p: torch.as_tensor(p).to(dev),
                  adapter.init_params(c.seed)), n_nodes) for c in cfgs])
    return params0, batches


def train_model_on_traces(
    adapter: ModelAdapter,
    configs: Sequence,
    n_rounds: int,
    eta: float = 0.05,
    trace_batch: Optional[TraceBatch] = None,
    engine: str = "event",
    mesh=None,
    device: str | torch.device = "cuda",
) -> tuple[TraceBatch, dict]:
    """Train any ``ModelAdapter`` over a family of precomputed channel
    realizations, one graph replay per round for the family — the
    tree-general core that ``train_cnn_on_traces`` wraps for the paper's
    CNN.

    ``configs`` is a sequence of ``ScenarioConfig``/names sharing
    ``n_nodes``, ``eval_every_rounds``, ``payload``, and ``watchdog``;
    each config's ``model_bits`` (and ``model_shapes``, when the adapter
    declares ``param_shapes``) is snapped to the adapter's model so the
    comm plane charges this model's airtime. Pass ``trace_batch`` to
    reuse already-precomputed traces — they must have been realized under
    the snapped configs (provenance-checked).

    Training runs on ``device`` (``"cuda"`` unless the caller asks for the
    CPU), and so does the scan engine when ``engine`` picks it; the
    snapshots are evaluated ``EVAL_CHUNK`` at a time. ``mesh`` (a
    ``launch.mesh.make_fleet_mesh`` of this rank's world) lays the
    family's node axis over the fleet (``_shard_family``: sharded when it
    divides, else whole on every rank) and, with a 'model' axis, every
    leaf over it (``_shard_model``: tensor parallelism, every family);
    every rank gets the whole results.

    Returns ``(traces, out)`` like ``train_cnn_on_traces``: masked mean
    ``losses`` (S, rounds), eval-round metrics ``acc`` (S, E) with
    simulated-time stamps ``t_acc_s`` (None when the adapter has no
    ``eval_fn``), ``curves``, per-trace compacted ``final_params``, and
    watchdog ``rollbacks``."""
    from ..checkpoint.ckpt import compact_nodes
    from ..launch.mesh import tp_size

    dev = resolve_device(device)
    cfgs = [get_scenario(c) if isinstance(c, str) else c for c in configs]
    if not cfgs:
        raise ValueError("train_model_on_traces needs at least one config")
    if mesh is not None and tp_size(mesh) > 1:
        # a model without tensor parallelism refuses before the traces;
        # heads that do not divide over the axis refuse in the loss
        # (models.transformer.check_tp)
        _model_specs(adapter.init_params(cfgs[0].seed), tp_size(mesh))
    n_nodes = cfgs[0].n_nodes
    eval_every = cfgs[0].eval_every_rounds
    payload = cfgs[0].payload
    watchdog = cfgs[0].watchdog
    for c in cfgs:
        if c.n_nodes != n_nodes or c.eval_every_rounds != eval_every:
            raise ValueError("configs must share n_nodes/eval_every_rounds")
        if c.payload != payload:
            # one round body serves the whole family; the quantization
            # mode is baked into it, so mixed-payload families must split
            raise ValueError("configs must share the payload QuantConfig")
        if c.watchdog != watchdog:
            # like payload: the rollback guard changes the round body
            raise ValueError("configs must share the watchdog setting")
    if adapter.model_bits:
        snap = {}
        if adapter.param_shapes:
            snap["model_shapes"] = adapter.param_shapes
        cfgs = [c if (abs(c.model_bits - adapter.model_bits) <= 0.5
                      and (not adapter.param_shapes
                           or c.model_shapes == adapter.param_shapes))
                else c.replace(model_bits=float(adapter.model_bits), **snap)
                for c in cfgs]

    traces = (trace_batch if trace_batch is not None
              else precompute_traces(cfgs, n_rounds, engine=engine,
                                     device=dev))
    if (traces.n_traces != len(cfgs) or traces.n_rounds != n_rounds
            or traces.n_nodes != n_nodes):
        raise ValueError(
            f"trace batch shape ({traces.n_traces}, {traces.n_rounds}, "
            f"{traces.n_nodes}) does not match ({len(cfgs)}, {n_rounds}, "
            f"{n_nodes})")
    for c, t in zip(cfgs, traces.traces):
        # provenance, not just shape: a trace realized under any other
        # config (seed, churn rate, fading, solver, model_bits, ...) would
        # silently pair foreign W sequences and time stamps with this
        # config's minibatch stream
        if t.cfg != c:
            raise ValueError(
                f"trace realized under {t.cfg} cannot train config {c}")

    eval_rounds = [r for r in range(n_rounds)
                   if (r + 1) % eval_every == 0 or r + 1 == n_rounds]
    inputs = list(_family_inputs(adapter, cfgs, traces, n_nodes, dev))
    batches = inputs.pop()
    # the initial parameters handed over with no reference kept here (the
    # round loop drops them once its graph has them), and only the
    # evaluated rounds' snapshots kept (a snapshot is a whole replica: 3.4
    # GiB for recurrentgemma-2b's 3-layer cut)
    out_arrays = train_on_traces(
        adapter.loss_fn, inputs.pop(), traces.w_eff, traces.live, batches,
        DPSGDConfig(eta=eta), collect_node0=tuple(eval_rounds),
        params_batched=True, payload=payload, active_seq=traces.active,
        watchdog=watchdog, mesh=mesh)
    if watchdog:
        finals, losses, snaps, rollbacks = out_arrays
    else:
        finals, losses, snaps = out_arrays
        rollbacks = None

    s_count = traces.n_traces
    if adapter.eval_fn is not None:
        sel = _tree_map(lambda p: p.reshape(
            (s_count * len(eval_rounds),) + tuple(p.shape[2:])), snaps)
        accs = _evaluate(adapter.eval_fn, sel, EVAL_CHUNK)
    # the loop's one synchronisation: results to the host
    live = traces.live                                    # (S, rounds, n)
    raw = losses.detach().cpu().numpy().astype(np.float64)  # (S, rounds, n)
    # where, not multiply: dead-row filler may legally produce NaN losses
    masked = np.where(live, raw, 0.0)
    mean_losses = masked.sum(-1) / live.sum(-1)           # masked driver mean
    if adapter.eval_fn is not None:
        accs = accs.detach().cpu().numpy().astype(np.float64).reshape(
            s_count, len(eval_rounds))
        t_acc = traces.t_end_s[:, eval_rounds]
        curves = [list(zip(t_acc[s].tolist(), accs[s].tolist()))
                  for s in range(s_count)]
    else:
        accs, t_acc, curves = None, None, None
    final_params = [
        compact_nodes(_tree_map(lambda p, s=s: p[s], finals), live[s, -1])
        for s in range(s_count)]
    return traces, {
        "losses": mean_losses,
        "acc": accs,
        "t_acc_s": t_acc,
        "eval_rounds": eval_rounds,
        "curves": curves,
        "final_params": final_params,
        # (S, rounds, n) bool watchdog rollback events, None when disarmed
        "rollbacks": (rollbacks.cpu().numpy() if rollbacks is not None
                      else None),
    }


def train_cnn_on_traces(
    configs: Sequence,
    epochs: int = 2,
    batch: int = 25,
    eta: float = 0.05,
    n_train: int = 1200,
    n_test: int = 300,
    ds=None,
    trace_batch: Optional[TraceBatch] = None,
    engine: str = "event",
    device: str | torch.device = "cuda",
) -> tuple[TraceBatch, dict]:
    """The batched counterpart of ``trace.simulate_dpsgd_cnn``: train the
    paper's CNN over a family of precomputed channel realizations, one
    graph replay per round for the whole family on ``device``.

    ``configs`` is a sequence of ``ScenarioConfig``/names — typically one
    scenario at several seeds (a fading Monte-Carlo sweep). All must share
    ``n_nodes`` and ``eval_every_rounds``. Pass ``trace_batch`` to reuse
    already-precomputed traces (it must have ``epochs * iters_per_epoch``
    rounds). ``engine`` is forwarded to ``precompute_traces`` with
    ``device`` — ``"scan"``/``"auto"`` realize eligible traces in the
    round-loop kernel (``sim.jit_trace``), so channel plane *and* training
    both run on the card at large n.

    Returns ``(traces, out)`` where ``out`` has per-trace masked mean
    ``losses`` (S, rounds), eval-round accuracies ``acc`` (S, E) with their
    simulated-time stamps ``t_acc_s`` (S, E), ``curves`` (list of
    accuracy-vs-simulated-time point lists, the driver's
    ``SimTrace.accuracy_curve`` analogue), and ``final_params`` (per-trace
    node-stacked params compacted to the surviving nodes).

    This is the CNN instance of ``train_model_on_traces`` (data shards,
    loss, and accuracy eval packaged by ``_cnn_adapter``); the adapter
    keeps ``param_shapes=()`` so configs and traces stay bit-identical to
    the flat accounting.
    """
    from ..data import SyntheticFashion, node_splits

    dev = resolve_device(device)
    cfgs = [get_scenario(c) if isinstance(c, str) else c for c in configs]
    if not cfgs:
        raise ValueError("train_cnn_on_traces needs at least one config")
    n_nodes = cfgs[0].n_nodes

    ds = ds or SyntheticFashion(n_train=n_train, n_test=n_test, seed=0)
    shards = node_splits(ds.train_x, ds.train_y, n_nodes, seed=0)
    shard_x = np.stack([x for x, _ in shards])
    shard_y = np.stack([y for _, y in shards])
    per_node = shard_x.shape[1]
    iters_per_epoch = max(per_node // batch, 1)
    n_rounds = iters_per_epoch * epochs

    adapter = _cnn_adapter(shard_x, shard_y, batch, ds.test_x[:n_test],
                           ds.test_y[:n_test], dev)
    return train_model_on_traces(
        adapter, cfgs, n_rounds, eta=eta, trace_batch=trace_batch,
        engine=engine, device=dev)
