"""The paper, end to end, on the port: wireless D-PSGD with rate
optimization (Algorithms 1 + 2).

Places n nodes in a 200x200 m area, builds the channel-capacity matrix
(Eq. 2), solves Eq. 8 for the transmission rates at λ targets 0.1 and 0.8
(Algorithm 2 brute force), trains the paper's 21 840-parameter CNN with
D-PSGD (Algorithm 1 / Eq. 5) on a synthetic Fashion-MNIST surrogate, and
reports runtime = measured compute + Eq. 3 communication time — the
tradeoff of Fig. 3. The gossip mix of every step runs in the hand-written
CUDA kernel on the card.

The same five steps as ``examples/wireless_dpsgd.py`` of the JAX package,
with the same placement, rate solution and numpy batch indices.

Run:  PYTHONPATH=src python -m repro_torch.examples.wireless_dpsgd \\
          [--device cuda] [--eps 5.0]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..core import channel, dpsgd, rate_opt
from ..core.bound import BoundParams, dpsgd_bound
from ..core.dpsgd import DPSGDConfig
from ..data import SyntheticFashion, node_splits
from ..device import resolve_device
from ..models import cnn

__all__ = ["BATCH", "NodeData", "place", "load_data", "init_params",
           "train", "run_target", "main"]

BATCH = 25          # per-node minibatch (paper §IV-A)
LAMBDA_TARGETS = (0.1, 0.8)


@dataclasses.dataclass
class NodeData:
    """Per-node training splits and the test set, on one device."""

    x: torch.Tensor       # (n, per_node, 1, 28, 28) fp32
    y: torch.Tensor       # (n, per_node) int32
    test_x: torch.Tensor  # (n_test, 1, 28, 28)
    test_y: torch.Tensor  # (n_test,)

    @property
    def per_node(self) -> int:
        return self.x.shape[1]


def place(n_nodes: int = 6, eps: float = 5.0, seed: int = 0) -> np.ndarray:
    """Step 1: random placement in 200x200 m and the Eq. 2 capacities."""
    pos = channel.random_placement(n_nodes, 200.0, seed=seed)
    return channel.capacity_matrix(
        pos, channel.ChannelParams(path_loss_exp=eps))


def load_data(n_nodes: int = 6, n_train: int = 1200, n_test: int = 300,
              seed: int = 0, device: str | torch.device = "cuda") -> NodeData:
    """The synthetic set, split iid across nodes, moved to ``device`` once
    (each step then gathers its minibatch on the device)."""
    dev = resolve_device(device)
    ds = SyntheticFashion(n_train=n_train, n_test=n_test, seed=seed)
    splits = node_splits(ds.train_x, ds.train_y, n_nodes, seed=seed)
    return NodeData(
        x=torch.from_numpy(np.stack([s[0] for s in splits])).to(dev),
        y=torch.from_numpy(np.stack([s[1] for s in splits])).to(dev),
        test_x=torch.from_numpy(ds.test_x).to(dev),
        test_y=torch.from_numpy(ds.test_y).to(dev))


def init_params(n_nodes: int, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """x_0 drawn from a seeded generator, replicated on every node."""
    gen = torch.Generator().manual_seed(seed)
    return dpsgd.replicate(cnn.cnn_init(gen, device=device), n_nodes)


def _batch(data: NodeData, idx: np.ndarray) -> dict:
    """Node i's minibatch is ``split_i[idx[i]]``, gathered on the device.
    The indices go up without waiting for the device (CUDA stages a
    pageable source before the call returns), so on a card the host draws
    the next batch while a step runs."""
    dev = data.x.device
    idx_t = torch.from_numpy(idx).to(dev, non_blocking=True)
    rows = torch.arange(idx.shape[0], device=dev)[:, None]
    return {"images": data.x[rows, idx_t], "labels": data.y[rows, idx_t]}


def train(params: dict, data: NodeData, w: np.ndarray, steps: int,
          eta: float = 0.05, seed: int = 0) -> tuple[dict, torch.Tensor, float]:
    """Step 4: ``steps`` D-PSGD iterations with mixing matrix ``w``.
    Minibatch indices come from ``np.random.default_rng(seed)`` exactly as
    in the JAX example. Returns (params, per-step losses (steps, n), the
    compute seconds up to the device's last result). On the card the step
    is a CUDA graph, captured before the clock starts (as ``jax.jit``
    compiles the JAX example's step before its first result)."""
    step = dpsgd.make_dpsgd_step(cnn.cnn_loss, DPSGDConfig(eta=eta))
    n = data.x.shape[0]
    w_t = torch.as_tensor(w, dtype=torch.float32, device=data.x.device)
    step.prepare(params, _batch(data, np.zeros((n, BATCH), np.int64)), w_t)
    rng = np.random.default_rng(seed)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        idx = rng.integers(0, data.per_node, size=(n, BATCH))
        params, loss = step(params, _batch(data, idx), w_t)
        losses.append(loss)
    out = torch.stack(losses) if losses else torch.empty(0, n)
    if data.x.is_cuda:
        torch.cuda.synchronize(data.x.device)
    return params, out, time.perf_counter() - t0


def run_target(cap: np.ndarray, lam_t: float, data: NodeData, steps: int,
               eta: float = 0.05, seed: int = 0, verbose: bool = True) -> dict:
    """Steps 2-5 for one λ target: Algorithm 2, then D-PSGD from a fresh
    x_0, then node-1 test accuracy and runtime = compute + Eq. 3."""
    n = cap.shape[0]
    sol = rate_opt.solve(cap, cnn.MODEL_BITS, lam_t)
    if verbose:
        print(f"\n2) Algorithm 2: min t_com s.t. lambda <= {lam_t}")
        print(f"   rates [Mbps]: {np.round(sol.rates_bps / 1e6, 2)}")
        print(f"   lambda={sol.lam:.3f}, t_com={sol.t_com_s * 1e3:.1f} ms/share")
        print(f"   Eq.7 bound (K->inf): "
              f"{dpsgd_bound(BoundParams(n=n), sol.lam, np.inf):.4f}")
        print("3) Algorithm 1: D-PSGD training")
    params = init_params(n, seed=seed, device=data.x.device)
    params, losses, t_compute = train(params, data, sol.w, steps, eta=eta,
                                      seed=seed)
    node1 = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in params.items()}
    acc = float(cnn.cnn_accuracy(node1, data.test_x, data.test_y))
    t_com = sol.t_com_s * steps
    if verbose:
        print(f"   node-1 accuracy {acc:.3f} | compute {t_compute:.3f}s + "
              f"comm {t_com:.1f}s = runtime {t_compute + t_com:.1f}s "
              f"| {steps / t_compute:.1f} steps/s")
    return {"lambda_target": lam_t, "sol": sol, "params": params,
            "losses": losses, "steps": steps, "accuracy": acc,
            "t_compute_s": t_compute, "t_com_s": t_com}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no quiet fallback")
    ap.add_argument("--eps", type=float, default=5.0, help="path loss exponent")
    ap.add_argument("--nodes", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print(f"1) placing {args.nodes} nodes, path-loss eps={args.eps} "
          f"(device {device})")
    cap = place(args.nodes, args.eps)
    data = load_data(args.nodes, 1200, 300, device=device)
    steps = args.epochs * (data.per_node // BATCH)
    return [run_target(cap, lam_t, data, steps) for lam_t in LAMBDA_TARGETS]


if __name__ == "__main__":
    main()
