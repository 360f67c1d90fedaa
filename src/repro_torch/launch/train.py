"""End-to-end pod-mode trainer, on one device or over a fleet of ranks.

The torch counterpart of ``repro.launch.train``: the density controller
picks the gossip plan (Eq. 8), then Mode A (``--mode allreduce``) or Mode B
(``--mode dpsgd``, every node's state on a leading node axis) trains on
deterministic token batches, with checkpoints, resume and a fault drill.

Examples:
  # D-PSGD LM training, 4 nodes on the card:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-2b \\
      --smoke --nodes 4 --steps 100 --lambda-target 0.8

  # on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke

  # 4 nodes over a fleet of 2 ranks (gloo on the CPU; NCCL, one card a
  # rank, with --device cuda):
  PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \\
      -m repro_torch.launch.train --device cpu --smoke --nodes 4

  # 2 nodes, each over a 'model' axis of 2 ranks (tensor parallelism):
  PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \
      -m repro_torch.launch.train --device cpu --smoke --nodes 2 --tp 2

  # fully-synchronized baseline (Mode A):
  ... --mode allreduce

  # fault-tolerance drill: kill node 2 at step 40, elastic-restart:
  ... --fail-at 40 --fail-node 2

  # Mode A at full width on the card, the step eager (no CUDA graph):
  ... --arch qwen2-vl-2b --mode allreduce --seq-len 512 --eager

Checkpoints land in --ckpt-dir every --ckpt-every steps (atomic, digest
verified, the JAX package's format); restart resumes from the latest
complete step and the SAME data stream position (deterministic batches).

Run under torchrun (``python -m torch.distributed.run --nproc_per_node
F``), the world of F ranks is the reference's node axis ("data"): each
rank holds ``nodes / F`` nodes (``nodes % F == 0``) and its nodes' batch
rows, every rank computes the controller's plan and the batches, rank 0
gathers the node axis into its host memory, leaf by leaf, to write a
checkpoint (the same files one process writes) and scatters it to resume
or after the fault drill, and only rank 0 logs. Mode A splits the global batch over the ranks and all-reduces the
gradients. With ``--tp T`` the world of W ranks is the reference's
(data, model) mesh, ``make_fleet_mesh(W // T, T)``: each node (Mode B)
or the one replica (Mode A; ``--nodes 1`` is pure tensor parallelism)
runs over the T ranks of a ``model`` axis, every leaf the rank's shard
of the JAX package's ``param_specs`` (drawn layer by layer and sharded as
drawn: the whole model is never on one card), every family (attention
heads that do not divide over the axis run the q head split:
``models.attention.head_layout``). A
checkpoint gathers every leaf over ``model`` and then the fleet to rank
0's host (the JAX package's global arrays, the same files one process
writes) and scatters it back to resume or after the fault drill; the
tensor-parallel step, its regions' all-reduces inside, is captured and
replays bit-equal to eager (chip_smoke.py phase 26 (b)); a step through
split RG-LRU channels runs eager (``transformer.tp_runs_eager``: its
capture hung on four H100s). On the card the step is a
``graphs.GraphedStep`` (the counterpart
of ``jax.jit``; staging its inputs lets the loop drop its own copy of the
state, the counterpart of ``donate_argnums``) unless ``graphed=False``
(``--eager``) asks for the eager step: a graph keeps its static inputs,
its pool and the fresh outputs, three copies of the state, which a
full-width state may not fit. The eager step consumes its state (its
``donate``): the optimizer writes into the state's tensors.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..checkpoint.ckpt import reshape_nodes
from ..configs import RunConfig, get_config, reduce_for_smoke
from ..core.density_controller import choose_plan
from ..core.dpsgd import _leaves, _tree_map
from ..data.pipeline import deterministic_lm_batch
from ..device import resolve_device
from ..graphs import GraphedStep
from ..models import build, tp as _tp
from ..models.transformer import check_tp, tp_runs_eager
from ..models.layers import torch_dtype
from ..optim.schedule import constant_lr
from ..runtime.fault import ElasticController
from ..train import shardings as shr
from ..train.step import (init_train_state, make_train_step,
                          reshape_batch_for_nodes)

__all__ = ["main", "train_loop", "param_bytes", "stub_embeds",
           "model_specs", "shard_cast", "state_specs"]


def _mesh(nodes: int, tp: int, node_mode: bool = True):
    """The reference's (data, model) mesh: the started world as a
    (fleet, tp) mesh, the node axis over its fleet ranks, each node over
    ``tp`` ranks of the model axis; None without a world (one process,
    the node axis whole on its device)."""
    from .mesh import make_fleet_mesh

    if nodes < 1 or tp < 1:
        raise ValueError(f"nodes and tp must be >= 1, got {nodes}, {tp}")
    if not (dist.is_available() and dist.is_initialized()):
        if tp > 1:
            raise ValueError(
                f"tp={tp} needs a world of ranks: {nodes} x {tp} = "
                f"{nodes * tp} ranks, one a device (python -m "
                f"torch.distributed.run --nproc_per_node {nodes * tp} ...)")
        return None
    world = dist.get_world_size()
    if world % tp:
        raise ValueError(
            f"a 'model' axis of {tp} does not divide the world's {world} "
            "ranks")
    fleet = world // tp
    if node_mode and nodes % fleet:
        raise ValueError(
            f"{nodes} nodes do not divide over a fleet of {fleet} ranks")
    return make_fleet_mesh(fleet, tp)


def model_specs(cfg, size: int):
    """``train.shardings.param_specs`` of ``cfg``'s parameters over a model
    axis of ``size``, from their shapes alone (fake tensors: nothing is
    drawn)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return shr.param_specs(build(cfg, "cpu").init(torch.Generator()),
                               size, cfg.kv_dim)


def shard_cast(cfg, model: "_tp.Model"):
    """A ``cast`` for ``api.init`` that keeps this rank's shard of each
    piece as it is drawn (``train.shardings.param_specs`` of the piece:
    the rules read leaf and parent names only)."""
    def cast(piece: dict) -> dict:
        return shr.shard_model(
            piece, shr.param_specs(piece, model.size, cfg.kv_dim), model)
    return cast


def state_specs(state: dict, pspecs) -> dict:
    """One spec a leaf of a train state: the parameters' for the
    parameters, the residual and the optimizer's moments, replicated
    (``P()``) for the counters."""
    out: dict = {}
    for k, v in state.items():
        if k in ("params", "residual"):
            out[k] = pspecs
        elif k == "opt":
            out[k] = {kk: pspecs if kk in ("m", "v") else shr.P()
                      for kk in v}
        else:
            out[k] = shr.P()
    return out


def param_bytes(cfg) -> int:
    """Bytes of one replica's parameters, counted from their shapes
    without drawing a weight (fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        leaves = _leaves(build(cfg, "cpu").init(torch.Generator()))
        return sum(x.numel() * x.element_size() for x in leaves)


def stub_embeds(seed: int, k: int, shape: tuple, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """The vision / audio stubs' embeddings of step ``k``: normal draws
    from a host ``torch.Generator`` seeded by (seed, k), so every device
    trains on the same batch, as the token batches (the reference draws
    them from ``jax.random``; the streams differ)."""
    mixed = int(np.random.SeedSequence([seed, k]).generate_state(1)[0])
    gen = torch.Generator().manual_seed(mixed)
    return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)


def _batch(cfg, run: RunConfig, k: int, global_batch: int, seq_len: int,
           device: torch.device) -> dict:
    host = deterministic_lm_batch(k, global_batch, seq_len, cfg.vocab_size,
                                  seed=run.seed)
    batch = {kk: torch.from_numpy(v).to(device) for kk, v in host.items()}
    dt = torch_dtype(cfg.dtype)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = stub_embeds(
            run.seed, k, (global_batch, cfg.n_patches, cfg.d_model), dt,
            device)
    if cfg.is_encdec:
        half = seq_len // 2
        batch = {"tokens": batch["tokens"][:, :half],
                 "src_embeds": stub_embeds(
                     run.seed, k, (global_batch, half, cfg.d_model), dt,
                     device)}
    return batch


def _log(fleet: shr.Fleet, msg: str) -> None:
    if fleet.index == 0 and (not dist.is_initialized()
                             or dist.get_rank() == 0):
        print(msg, flush=True)


def _take_rows(batch: dict, lo: int, hi: int) -> dict:
    return _tree_map(lambda x: x[lo:hi], batch)


def train_loop(cfg, run: RunConfig, *, nodes: int, tp: int, steps: int,
               batch_per_node: int, seq_len: int, ckpt_dir: str | None,
               ckpt_every: int = 50, fail_at: int = -1, fail_node: int = 0,
               log_every: int = 10, resume: bool = False,
               clock: Callable[[], float] | None = None,
               device: str | torch.device = "cuda",
               graphed: bool = True) -> dict:
    # injectable wall timer (runtime/fault.py pattern): the logged `wall_s`
    # column is deterministic when a test stubs `clock`
    clock = clock or time.perf_counter
    node_mode = run.mode == "dpsgd"
    # heads that do not divide over the axis refuse before any work
    check_tp(cfg, _tp.Model(size=tp))
    mesh = _mesh(nodes, tp, node_mode)
    fleet = shr.fleet_of(mesh)
    model = _tp.model_of(mesh)
    if cfg.frontend == "vision" and seq_len <= cfg.n_patches:
        raise ValueError(
            f"seq_len {seq_len} must exceed the vision stub's {cfg.n_patches}"
            " patch positions (the first n_patches positions take the patch "
            "embeddings; the loss needs token positions after them)")
    dev = resolve_device(device)
    api = build(cfg, dev, model=model if model.active else None)
    global_batch = batch_per_node * nodes
    # this rank's nodes (Mode B) or its share of the batch (Mode A)
    lo, hi = fleet.block(nodes)
    sharded = fleet.sharded(nodes) and node_mode

    # --- Eq. 8: density controller picks the gossip plan -------------------
    pbytes = param_bytes(cfg)
    plan = None
    if node_mode:
        choice = choose_plan(("data",), (nodes,), run.lambda_target,
                             bytes_per_rank=pbytes / tp, eta=run.eta)
        plan = choice.plan
        _log(fleet, f"[plan] {choice}")

    pspecs = model_specs(cfg, tp) if model.active else None
    # a tensor-parallel step through split RG-LRU channels hung under
    # CUDA graph capture on four H100s: it runs eager
    graphed = graphed and not tp_runs_eager(cfg, model)
    # the eager step consumes its state, as the JAX trainer donates it
    step_fn = make_train_step(api, run, plan, constant_lr(run.eta),
                              group=fleet.group,
                              model=model if model.active else None,
                              specs=pspecs, donate=not graphed)
    # every node starts from the same x_0: each rank draws it from the
    # seed (under tensor parallelism, keeping its shard as drawn)
    state = init_train_state(
        api, run, torch.Generator(device=dev).manual_seed(run.seed),
        n_nodes=hi - lo,
        cast=shard_cast(cfg, model) if model.active else None)
    sspecs = state_specs(state, pspecs) if model.active else None
    nodes_axis = nodes if sharded else 1

    def gathered(state):
        """The whole state on rank 0's host (None elsewhere)."""
        if model.active:
            return shr.gather_state(state, sspecs, fleet, model,
                                    nodes_axis)
        return shr.gather_nodes(state, fleet, nodes) if sharded else state

    first = fleet.index == 0 and model.index == 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir and first else None
    start = 0
    if resume and ckpt_dir:
        found = [None, None]
        if mgr:
            try:
                # the file's shapes, on the host: rank 0 scatters them
                found = list(mgr.restore_latest(_tree_map(
                    lambda x: x.new_empty(0, device="cpu"), state)))
            except FileNotFoundError:
                pass
        if model.active:
            flag = [found[1]]
            dist.broadcast_object_list(flag, src=0)
            found[1] = flag[0]
        elif fleet.size > 1:
            flag = [found[1]]
            dist.broadcast_object_list(flag, src=fleet.global_rank(0),
                                       group=fleet.group)
            found[1] = flag[0]
        if found[1] is not None:
            start = found[1]
            # a replicated state (Mode A) is broadcast whole: an axis of 1
            if model.active:
                state = shr.scatter_state(found[0], state, sspecs, fleet,
                                          model, nodes_axis)
            else:
                state = shr.scatter_nodes(found[0], state, fleet,
                                          nodes_axis)
            _log(fleet, f"[resume] step {start}")
        del found

    elastic = ElasticController(nodes, run.lambda_target, mode="pod",
                                axis_names=("data",),
                                bytes_per_rank=pbytes / tp)

    graph_step = GraphedStep(step_fn) if graphed else None
    metrics_log: list[dict] = []
    t_wall = clock()

    k = start
    while k < steps:
        batch = _batch(cfg, run, k, global_batch, seq_len, dev)
        if node_mode:
            batch = _take_rows(reshape_batch_for_nodes(batch, nodes), lo, hi)
        elif fleet.size > 1:
            share = global_batch // fleet.size
            batch = _take_rows(batch, fleet.index * share,
                               (fleet.index + 1) * share)
        if graph_step is not None:
            # the graph's static inputs hold the state: drop ours first
            replay = graph_step.stage(state, batch)
            del state
            state, metrics = replay()
        else:
            state, metrics = step_fn(state, batch)
        k += 1

        if fail_at == k and node_mode:
            _log(fleet, f"[fault] node {fail_node} dies at step {k}")
            elastic.fail(k, [fail_node])
            full = gathered(state)
            state_host = None if full is None else _tree_map(
                lambda x: x.cpu(), full)
            del full
            survivors = elastic.survivors()
            if state_host is not None:
                state_host = reshape_nodes(state_host, survivors, nodes)
            new_plan = elastic.replan()
            _log(fleet, f"[fault] replanned: {new_plan}")
            if model.active:
                state = shr.scatter_state(state_host, state, sspecs, fleet,
                                          model, nodes_axis)
            elif sharded:
                state = shr.scatter_nodes(state_host, state, fleet, nodes)
            else:
                del state
                state = _tree_map(lambda x: x.to(dev), state_host)
            del state_host

        if k % log_every == 0 or k == steps:
            loss = float(metrics["loss"])
            dt = clock() - t_wall
            metrics_log.append({"step": k, "loss": loss, "wall_s": dt})
            _log(fleet, f"step {k:5d} loss {loss:.4f} wall {dt:7.1f}s")
        if ckpt_dir and k % ckpt_every == 0:
            full = gathered(state)
            if mgr:
                mgr.save(k, full)
            del full
    if mgr:
        mgr.wait()
    return {"final_loss": metrics_log[-1]["loss"] if metrics_log else None,
            "log": metrics_log}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-vl-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--mode", choices=["dpsgd", "allreduce"], default="dpsgd")
    ap.add_argument("--lambda-target", type=float, default=0.8)
    ap.add_argument("--eta", type=float, default=0.01)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--fail-node", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="run the step eagerly, not as a CUDA graph (a "
                         "graph holds three copies of the state: "
                         "qwen2-vl-2b's full-width state does not fit)")
    args = ap.parse_args(argv)
    # under torchrun every rank starts its place in the world first
    in_world = "WORLD_SIZE" in os.environ
    device = args.device
    if in_world:
        from .mesh import init_world
        device = init_world(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    run = RunConfig(mode=args.mode, lambda_target=args.lambda_target,
                    eta=args.eta, optimizer=args.optimizer,
                    compression=args.compression, remat="none")
    out = train_loop(cfg, run, nodes=args.nodes, tp=args.tp, steps=args.steps,
                     batch_per_node=args.batch_per_node, seq_len=args.seq_len,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     fail_at=args.fail_at, fail_node=args.fail_node,
                     resume=args.resume, device=device,
                     graphed=not args.eager)
    if not in_world or dist.get_rank() == 0:
        print(f"final loss: {out['final_loss']}")
    if in_world:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
