"""Pod-mode D-PSGD over a (fleet, model) world: each node's model split
over a 'model' axis (tensor parallelism), int8 gossip between the nodes
over the fleet, fault-free, the gemma3-12b smoke config.

The torch counterpart of ``examples/pod_gossip_train.py`` (4 nodes x TP 2
on 8 host devices there). Where the JAX script counts the
collective-permutes and int8 tensors in its compiled program, this one
prints what a step moves and launches on a rank: the P2P bytes of the
gossip (``core.gossip.exchange.sent_bytes``) and each kernel wrapper's
launches.

Run (one rank a device; gloo on the CPU, NCCL one card a rank):
  PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 8 \\
      -m repro_torch.examples.pod_gossip_train --device cpu
  ... --nproc_per_node 4 -m repro_torch.examples.pod_gossip_train \\
      --nodes 2 --tp 2 --steps 3
"""
from __future__ import annotations

import argparse
import os
from dataclasses import replace
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import RunConfig, get_config, reduce_for_smoke
from ..convert import shards_from_numpy
from ..core import dpsgd
from ..core.comm_model import LinkModel
from ..core.density_controller import choose_plan
from ..core.gossip import exchange, ring_plan
from ..kernels import counted_wrappers
from ..launch.mesh import init_world, make_fleet_mesh
from ..launch.train import model_specs, shard_cast
from ..models import build, tp
from ..optim import make_optimizer
from ..optim.schedule import constant_lr
from ..train import shardings as shr
from ..train.step import init_train_state, make_train_step

ARCH = "gemma3-12b"
BATCH, SEQ = 4, 64


def make_plan(nodes: int, lambda_target: float, log: Callable = print):
    """The JAX script's plan: the controller's choice on slow inter-node
    links (a sparse gossip wins, as in the paper's high path-loss regime),
    else ring-1 forced for the demo."""
    choice = choose_plan(("pod", "data"), (2, nodes // 2), lambda_target,
                         bytes_per_rank=1e6,
                         link=LinkModel(dci_penalty=16.0))
    log(f"plan: {choice}")
    if choice.plan.kind == "gossip":
        return replace(choice.plan, axis_names=("data",),
                       node_shape=(nodes,))
    plan = ring_plan(("data",), (nodes,), 1)
    log(f"(forcing {plan.name} for the demo)")
    return plan


def _state_from(init: dict, api, run: RunConfig, specs, model, lo: int,
                hi: int, device) -> dict:
    """A Mode B state whose every node starts from ``init`` (one replica's
    numpy tree), this rank's nodes and shards."""
    params = dpsgd.replicate(shards_from_numpy(init, specs, model, device),
                             hi - lo)
    opt = make_optimizer(run.optimizer, momentum=run.momentum,
                         weight_decay=run.weight_decay)
    state = {"step": torch.zeros((), dtype=torch.int32, device=device),
             "params": params, "opt": opt.init(params)}
    if run.compression != "none":
        state["residual"] = dpsgd._tree_map(torch.zeros_like, params)
    return state


def run(nodes: int = 4, tp_size: int = 2, steps: int = 30,
        device: str | torch.device = "cuda", init: Optional[dict] = None,
        batches: Optional[list] = None, log_every: int = 10,
        log: Callable = print, alone: bool = False) -> dict:
    """Train in a started world of ``fleet * tp_size`` ranks (``fleet``
    dividing ``nodes``); every rank calls it. ``init`` (one replica's
    numpy parameters) and ``batches`` (per step, (nodes, 4, 64) int32
    tokens) replace the seeded draws. ``alone``: every node whole on this
    process's device, no world (the run a world's is held against).
    Returns the per-step losses and, for the first step, the P2P bytes
    sent and the launches by kernel."""
    mesh = None
    if not alone:
        world = dist.get_world_size()
        mesh = make_fleet_mesh(world // tp_size, tp_size)
    fleet, model = shr.fleet_of(mesh), tp.model_of(mesh)
    lo, hi = fleet.block(nodes)
    dev = torch.device(device)
    cfg = reduce_for_smoke(get_config(ARCH))
    api = build(cfg, dev, model=model if model.active else None)
    runc = RunConfig(mode="dpsgd", optimizer="adamw", eta=1e-3,
                     lambda_target=0.9, compression="int8", remat="none")
    plan = make_plan(nodes, runc.lambda_target, log)
    specs = model_specs(cfg, model.size)
    step = make_train_step(api, runc, plan, constant_lr(1e-3),
                           node_axes=("data",), group=fleet.group,
                           model=model if model.active else None,
                           specs=specs)
    if init is None:
        state = init_train_state(
            api, runc, torch.Generator(device=dev).manual_seed(0),
            n_nodes=hi - lo,
            cast=shard_cast(cfg, model) if model.active else None)
    else:
        state = _state_from(init, api, runc, specs, model, lo, hi, dev)

    def tokens(k):
        if batches is not None:
            return torch.from_numpy(np.asarray(batches[k], np.int32))
        gen = torch.Generator().manual_seed(k)
        return torch.randint(0, cfg.vocab_size, (nodes, BATCH, SEQ),
                             generator=gen, dtype=torch.int32)

    losses, first = [], {}
    for k in range(steps):
        sent = exchange.sent_bytes
        counts = {w.__name__: w.launches for w in counted_wrappers()}
        state, m = step(state, {"tokens": tokens(k)[lo:hi].to(dev)})
        losses.append(float(m["loss"]))
        if k == 0:
            first = {"p2p_bytes": exchange.sent_bytes - sent,
                     "launches": {w.__name__: w.launches
                                  - counts[w.__name__]
                                  for w in counted_wrappers()
                                  if w.launches > counts[w.__name__]}}
            rank = dist.get_rank() if dist.is_initialized() else 0
            log(f"a step on rank {rank}: P2P bytes "
                f"{first['p2p_bytes']} (int8 gossip payloads and fp32 row "
                f"scales), launches {first['launches']}")
        if k % log_every == 0:
            log(f"step {k:3d} loss {losses[-1]:.4f}")
    log(f"final loss {losses[-1]:.4f}")
    return {"losses": losses, "plan": plan.name, **first}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        need = args.nodes * args.tp
        raise SystemExit(f"run under torchrun, {need} ranks: python -m "
                         f"torch.distributed.run --nproc_per_node {need} "
                         "-m repro_torch.examples.pod_gossip_train")
    device = init_world(args.device)
    rank0 = dist.get_rank() == 0
    try:
        run(args.nodes, args.tp, args.steps, device,
            log=print if rank0 else (lambda *_: None))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
