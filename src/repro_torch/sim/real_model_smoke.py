"""Sharded real-model train-on-trace smoke — runnable as a module.

    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \
        -m repro_torch.sim.real_model_smoke --json --device cpu

The torch counterpart of ``repro.sim.real_model_smoke``, run with one
process a rank (torchrun; gloo on the CPU, NCCL one card a rank on the
card). It builds the smoke-reduced transformer
(``sim.batch.transformer_adapter``), realizes a fading trace, and runs
train-on-trace three ways:

1. the per-round reference loop (``train_on_trace_reference``) — the oracle;
2. the round loop with the node axis laid over a
   ``launch.mesh.make_fleet_mesh`` (``sim.batch._shard_family``) and each
   node's tensors over its ``model`` axis (tensor parallelism,
   ``sim.batch._shard_model``), asserting the final parameters actually
   span >= 2 ranks;
3. the full ``train_model_on_traces`` driver on the same mesh.

All three must agree to the parity bound (<=1e-5 on final params and
per-round losses). Exit code 0 + a JSON report on stdout (rank 0) when
they do. ``devices_spanned`` counts the ranks holding a part of the
parameters: a block of the node axis, times the model axis's ranks when
the specs split a leaf over it (each rank its own device: a card under
NCCL, a process on the host under gloo). The defaults are the JAX
package's: a fleet of 2 by a model axis of 2, a world of 4 ranks.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def run(arch: str = "stablelm-3b", scenario: str = "fading", rounds: int = 4,
        fleet: int = 2, model: int = 2, batch: int = 2, seq_len: int = 16,
        eta: float = 0.05, tol: float = 1e-5,
        device: str = "cuda") -> dict:
    """Run the smoke in a started world of at least ``fleet * model``
    ranks (``launch.mesh.init_world``); every rank calls it and gets the
    report dict (key ``ok``). The sharded round loops run eager (a sharded
    family refuses a CUDA graph, ``sim.batch``)."""
    import numpy as np
    import torch

    from ..checkpoint.ckpt import compact_nodes
    from ..core import dpsgd
    from ..core.dpsgd import DPSGDConfig, _leaves
    from ..launch.mesh import make_fleet_mesh
    from ..models import tp
    from ..train.shardings import fleet_of
    from .batch import (train_model_on_traces, train_on_trace,
                        train_on_trace_reference, transformer_adapter)
    from .scenario import get_scenario
    from .trace import precompute_traces

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    adapter = transformer_adapter(arch, batch=batch, seq_len=seq_len,
                                  device=dev)
    cfg = get_scenario(scenario, model_bits=adapter.model_bits,
                       model_shapes=adapter.param_shapes,
                       eval_every_rounds=rounds)
    tb = precompute_traces([cfg], rounds, device=dev)
    tr = tb.traces[0]
    batches = adapter.batch_fn(cfg, tr)
    params0 = dpsgd.replicate(
        dpsgd._tree_map(lambda p: torch.as_tensor(p).to(dev),
                        adapter.init_params(cfg.seed)), cfg.n_nodes)
    config = DPSGDConfig(eta=eta)

    def diff(a, b) -> float:
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(_leaves(a), _leaves(b)))

    # 1. per-round reference (the whole node axis, a host loop)
    ref_final, ref_losses = train_on_trace_reference(
        adapter.loss_fn, params0, tr.w_eff, tr.live, batches, config,
        payload=cfg.payload, active_seq=tr.active)
    ref_losses = np.asarray(ref_losses, dtype=np.float64)

    # 2. the round loop with the node axis over 'fleet', tensors over
    # 'model'
    mesh = make_fleet_mesh(fleet, model)
    place = fleet_of(mesh)
    final, losses = train_on_trace(
        adapter.loss_fn, params0, tr.w_eff, tr.live, batches, config,
        payload=cfg.payload, active_seq=tr.active, mesh=mesh)
    spanned = ((place.size if place.sharded(cfg.n_nodes) else 1)
               * tp.model_of(mesh).size)
    param_diff = diff(final, ref_final)
    loss_diff = float(np.max(np.abs(
        losses.detach().cpu().numpy().astype(np.float64) - ref_losses)))

    # 3. the full driver on the same mesh vs the reference's masked means
    _, out = train_model_on_traces(
        adapter, [cfg], rounds, eta=eta, trace_batch=tb, mesh=mesh,
        device=dev)
    ref_mean = (np.where(tr.live, ref_losses, 0.0).sum(-1)
                / tr.live.sum(-1))
    driver_loss_diff = float(np.max(np.abs(out["losses"][0] - ref_mean)))
    driver_param_diff = diff(out["final_params"][0],
                             compact_nodes(ref_final, tr.live[-1]))

    report = {
        "arch": adapter.name,
        "scenario": scenario,
        "rounds": rounds,
        "n_nodes": cfg.n_nodes,
        "mesh": {"fleet": fleet, "model": model},
        "devices_visible": int(torch.distributed.get_world_size()),
        "devices_spanned": spanned,
        "model_bits": adapter.model_bits,
        "wire_bits": cfg.wire_bits(),
        "parity": {
            "sharded_vs_reference_params": param_diff,
            "sharded_vs_reference_losses": loss_diff,
            "driver_vs_reference_losses": driver_loss_diff,
            "driver_vs_reference_params": driver_param_diff,
            "tol": tol,
        },
        "final_loss": float(out["losses"][0][-1]),
        "eval_metric": (float(out["acc"][0][-1])
                        if out["acc"] is not None else None),
    }
    report["ok"] = bool(
        spanned >= 2
        and param_diff <= tol and loss_diff <= tol
        and driver_loss_diff <= tol and driver_param_diff <= tol)
    return report


def main(argv=None) -> int:
    import torch.distributed as dist

    from ..launch.mesh import init_world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--scenario", default="fading")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--fleet", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON on stdout")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        need = args.fleet * args.model
        raise SystemExit(f"run under torchrun, {need} ranks: python -m "
                         f"torch.distributed.run --nproc_per_node {need} "
                         "-m repro_torch.sim.real_model_smoke")
    device = init_world(args.device)
    try:
        report = run(arch=args.arch, scenario=args.scenario,
                     rounds=args.rounds, fleet=args.fleet,
                     model=args.model, batch=args.batch,
                     seq_len=args.seq_len, device=str(device))
    finally:
        dist.destroy_process_group()
    if int(os.environ["RANK"]) == 0:
        if args.json:
            print(json.dumps(report))
        else:
            status = "OK" if report["ok"] else "FAIL"
            print(f"[real_model_smoke] {status}: {report['arch']} on "
                  f"{report['scenario']}, {report['devices_spanned']} "
                  f"ranks, parity {report['parity']}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
