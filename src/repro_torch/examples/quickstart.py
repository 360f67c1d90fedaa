"""Quickstart: network-density-controlled D-PSGD in ~60 lines.

The torch counterpart of ``examples/quickstart.py``: trains a tiny LM with
4 decentralized nodes, letting the density controller pick the gossip
topology for a lambda target (paper Eq. 8), then compares against the
fully-synchronized baseline. Prints the same lines as the JAX example.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..configs import RunConfig, get_config, reduce_for_smoke
from ..core.density_controller import choose_plan
from ..data.synthetic import token_stream
from ..device import resolve_device
from ..graphs import GraphedStep
from ..models import build
from ..optim.schedule import constant_lr
from ..train.step import (init_train_state, make_train_step,
                          reshape_batch_for_nodes)

N_NODES = 4
STEPS = 40


def train(mode: str, lambda_target: float = 0.9,
          device: str | torch.device = "cuda") -> float:
    dev = resolve_device(device)
    cfg = reduce_for_smoke(get_config("stablelm-3b"))
    api = build(cfg, dev)
    run = RunConfig(mode=mode, optimizer="adamw", eta=1e-3,
                    lambda_target=lambda_target, remat="none")

    plan = None
    if mode == "dpsgd":
        # Eq. 8: cheapest gossip schedule with lambda <= target
        choice = choose_plan(("data",), (N_NODES,), lambda_target,
                             bytes_per_rank=1e6)
        plan = choice.plan
        print(f"  density controller chose: {choice}")

    step = GraphedStep(make_train_step(api, run, plan, constant_lr(1e-3)))
    state = init_train_state(api, run,
                             torch.Generator(device=dev).manual_seed(0),
                             n_nodes=N_NODES)
    gen = token_stream(8, 64, cfg.vocab_size, seed=0)
    loss = None
    for k in range(STEPS):
        batch = {"tokens": torch.from_numpy(next(gen)).to(dev)}
        if mode == "dpsgd":
            batch = reshape_batch_for_nodes(batch, N_NODES)
        replay = step.stage(state, batch)
        del state
        state, metrics = replay()
        loss = float(metrics["loss"])
        if k % 10 == 0:
            print(f"  step {k:3d}  loss {loss:.4f}")
    return loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("== D-PSGD (network-density-controlled gossip) ==")
    l_dpsgd = train("dpsgd", device=args.device)
    print("== fully-synchronized baseline (all-reduce) ==")
    l_sync = train("allreduce", device=args.device)
    print(f"final losses: dpsgd={l_dpsgd:.4f} allreduce={l_sync:.4f} "
          f"(both must learn; dpsgd trades a little consensus error for "
          f"cheaper communication)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
