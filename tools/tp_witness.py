#!/usr/bin/env python3
"""Two witnesses for tensor-parallel training on four cards.

1. Where the scans' tensor-parallel gradients part from one card. For the
   smoke configs of rwkv6-7b and recurrentgemma-2b at tp 2 and 4, the
   gradient of the loss is taken on a (fleet, model) world and on each
   rank's card alone, twice: once through the scan kernels, once with the
   scans and their backward forced to float64 (the exact recurrence
   forward, the plain backward in float64) on both sides. Printed for each:
   the largest gradient difference between tp and the card alone, and
   between the kernels and float64 on each side, each beside max |g|; and
   tp against the card alone with every weight product formed in float64
   and rounded (the scans as they are), so that a shard's products are the
   whole's bit for bit.
   Before that, the scan kernels on a rank's slice of heads / channels (a
   strided view, as a shard's projection gives one) against the same
   kernels on the whole tensors, sliced after, and two calls on the whole
   tensors against each other: bit-equal or not.
2. Whether a tensor-parallel step whose regions all-gather captures as a
   CUDA graph. The smoke Mode B step (2 nodes x tp 2, ring-1) of
   recurrentgemma-2b and of rwkv6-7b, none and int8, plain SGD: the
   eager step twice and the graph's replay, bit-equal or not. Then
   recurrentgemma-2b's Mode B at its published widths and depth (26
   layers), none, SGD, 4 x 512 tokens a node, eager and as a CUDA graph
   (chip_smoke.py's ``rank_tp_steps``).

Each witness is one torchrun world of four ranks with a time limit; rank 0
prints its lines and the results go to ``--out`` as JSON.

``--rounding FILE`` (no world, on ``--device``) takes the gradient of each
smoke config alone on those parameters twice: with the port's fp32
products, and with the products of one group of weights (all of them, or
one kind) formed in float64 and rounded to fp32, a change of at most an
ulp or so in each product; it prints the largest gradient difference, as
a measure of how far rounding alone moves the gradient, and whether a
column shard's products equal the whole product's columns bit for bit.

``--save-smoke FILE`` (one card) writes the smoke parameters the card draws
for the first witness, with the card-alone loss and gradient through the
kernels, to an npz; ``--device cpu --only gaps --params FILE`` then runs
the first witness on a gloo world of four processes on those parameters
(the scans' plain versions in place of the kernels) and adds the largest
difference of the CPU's gradient alone from the card's.

Run from the repository root on a host with four cards:
    python3 tools/tp_witness.py [--out results/tp_witness.json]
                                [--only slices,gaps,capture,full]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

ARCHS = ("rwkv6-7b", "recurrentgemma-2b")
WORLD_S = {"slices": 180, "gaps": 180, "capture": 180, "full": 300}


# ---------------------------------------------------------------------------
# float64 scans, for the witness only: the port's wrappers launch the
# kernels on a CUDA tensor; here they are swapped out, on both sides of a
# comparison, for the exact recurrences in float64
# ---------------------------------------------------------------------------

def _rwkv6_forward64(r, k, v, w, u, s0, chunk):
    import torch

    from repro_torch.kernels import rwkv6_scan as rw

    b, s, h, d = r.shape
    f = torch.float64
    rr, kk, vv = (x.to(f) for x in (r, k, v))
    ww = torch.clamp(w.to(f), min=rw.FLOOR_W)
    uu = u.to(f)[None] if u.dim() == 2 else u.to(f)          # (B|1, H, D)
    state = torch.zeros((b, h, d, d), dtype=f, device=r.device) \
        if s0 is None else s0.to(f)
    y = torch.empty_like(rr)
    for t in range(s):
        kv = kk[:, t, :, :, None] * vv[:, t, :, None, :]
        y[:, t] = torch.einsum("bhd,bhde->bhe", rr[:, t],
                               state + uu[..., None] * kv)
        state = ww[:, t, :, :, None] * state + kv
    return y.to(r.dtype), state.to(torch.float32)


def _rwkv6_backward64(r, k, v, w, u, dy, s0=None, ds_final=None, chunk=64):
    import torch

    from repro_torch.kernels import rwkv6_scan as rw

    dr, dk, dv, dw, du, ds0 = rw.rwkv6_scan_bwd_plain(
        r, k, v, w, u, dy, s0, ds_final, chunk, acc_dtype=torch.float64)
    return dr, dk, dv, dw, du.to(torch.float32), \
        None if ds0 is None else ds0.to(torch.float32)


def _rglru_forward64(a, b, h0):
    import torch

    f = torch.float64
    aa, bb = a.to(f), b.to(f).clone()
    if h0 is not None:
        bb[:, 0] += aa[:, 0] * h0.to(f)
    h = torch.zeros_like(aa[:, 0])
    out = torch.empty_like(aa)
    for t in range(a.shape[1]):
        h = aa[:, t] * h + bb[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def _rglru_backward64(a, h, dh, h0=None):
    import torch

    from repro_torch.kernels import rglru_scan as rg

    return rg.rglru_scan_bwd_plain(a, h, dh, h0, acc_dtype=torch.float64)


@contextlib.contextmanager
def scans(mode: str):
    """``"kernel"``: the port as it is; ``"float64"``: both scans and
    their backward through the float64 recurrences above; ``"float64
    products"``: the scans as they are, every weight product rounded from
    float64 (``chip_smoke.float64_products``, which 27 (b) shares)."""
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    if mode == "kernel":
        yield
        return
    if mode == "float64 products":
        with cs.float64_products():
            yield
        return
    saved = rw._forward, rw.rwkv6_scan_bwd, rg._forward, rg.rglru_scan_bwd
    rw._forward, rw.rwkv6_scan_bwd = _rwkv6_forward64, _rwkv6_backward64
    rg._forward, rg.rglru_scan_bwd = _rglru_forward64, _rglru_backward64
    try:
        yield
    finally:
        rw._forward, rw.rwkv6_scan_bwd, rg._forward, rg.rglru_scan_bwd = \
            saved


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _equal(torch, xs, ys) -> bool:
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(xs, ys))


def rank_slices(torch, dev) -> dict:
    """The scans and their backward on rank 1's heads / channels of the
    published shard shapes, as strided views, against the whole call
    sliced; and two whole calls against each other."""
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw

    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    out = {}
    b, s, h, d = cs.TPF_BATCH, cs.TPF_SEQ, 64, 64
    r, k, v, dy = (rnd(b, s, h, d) for _ in range(4))
    w = torch.exp(-torch.exp(0.5 * rnd(b, s, h, d)))
    u = 0.1 * rnd(h, d)
    whole = (*rw.rwkv6_scan(r, k, v, w, u), *rw.rwkv6_scan_bwd(
        r, k, v, w, u, dy)[:5])
    again = (*rw.rwkv6_scan(r, k, v, w, u), *rw.rwkv6_scan_bwd(
        r, k, v, w, u, dy)[:5])
    res = {"repeat_bit_equal": _equal(torch, whole, again)}
    for size in (2, 4):
        lo, hi = h // size, 2 * h // size
        part = (*rw.rwkv6_scan(r[:, :, lo:hi], k[:, :, lo:hi],
                               v[:, :, lo:hi], w[:, :, lo:hi], u[lo:hi]),
                *rw.rwkv6_scan_bwd(r[:, :, lo:hi], k[:, :, lo:hi],
                                   v[:, :, lo:hi], w[:, :, lo:hi], u[lo:hi],
                                   dy[:, :, lo:hi])[:5])
        cut = (whole[0][:, :, lo:hi], whole[1][:, lo:hi],
               *(x[:, :, lo:hi] for x in whole[2:6]), whole[6][:, lo:hi])
        res[f"tp {size}"] = {
            "bit_equal": _equal(torch, part, cut),
            "max_abs": max(float((x - y).abs().max())
                           for x, y in zip(part, cut))}
    out["rwkv6 (4, 512, 64, 64)"] = res
    dr = 2560
    a = torch.sigmoid(rnd(b, s, dr) + 2.0)
    x, dh = rnd(b, s, dr), rnd(b, s, dr)
    hh = rg.rglru_scan(a, x)
    whole = (hh, *rg.rglru_scan_bwd(a, hh, dh)[:2])
    h2 = rg.rglru_scan(a, x)
    again = (h2, *rg.rglru_scan_bwd(a, h2, dh)[:2])
    res = {"repeat_bit_equal": _equal(torch, whole, again)}
    for size in (2, 4):
        lo, hi = dr // size, 2 * dr // size
        hp = rg.rglru_scan(a[..., lo:hi], x[..., lo:hi])
        part = (hp, *rg.rglru_scan_bwd(a[..., lo:hi], hp,
                                       dh[..., lo:hi])[:2])
        cut = tuple(y[..., lo:hi] for y in whole)
        res[f"tp {size}"] = {
            "bit_equal": _equal(torch, part, cut),
            "max_abs": max(float((p - c).abs().max())
                           for p, c in zip(part, cut))}
    out["rglru (4, 512, 2560)"] = res
    cs.rank_print(f"witness slices: {json.dumps(out)}")
    return out


def save_smoke(path: Path, device: str = "cuda") -> None:
    """Each arch's smoke parameters as ``rank_gaps`` draws them on a card,
    the batch's loss and the card-alone gradient through the kernels, to
    ``path`` (npz, leaves in ``jax.tree`` order)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.launch import train as lt
    from repro_torch.models import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    run = cs._pod_run("allreduce")
    arrays = {}
    for arch in ARCHS:
        cfg = reduce_for_smoke(get_config(arch))
        full = build(cfg, dev).init(
            torch.Generator(device=dev).manual_seed(27))
        batch = lt._batch(cfg, run, 0, cs.POD_LOCK_BATCH, cs.POD_LOCK_SEQ,
                          dev)
        g, loss = torch.func.grad_and_value(
            lambda p: build(cfg, dev).loss(p, batch))(full)
        for i, (x, gx) in enumerate(zip(dpsgd._leaves(full),
                                        dpsgd._leaves(g))):
            arrays[f"{arch}/p{i}"] = x.cpu().numpy()
            arrays[f"{arch}/g{i}"] = gx.cpu().numpy()
        arrays[f"{arch}/loss"] = np.array(float(loss))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    print(f"wrote {path}: {', '.join(ARCHS)}")


def rounding(path: Path, device: str) -> dict:
    """The smoke gradients alone on the parameters of ``path``: fp32
    products against products rounded from float64, by weight group."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.launch import train as lt
    from repro_torch.models import build, remat
    from repro_torch.train import shardings as shr

    dev = torch.device(device)
    saved = np.load(path)
    real = remat._matmul
    out = {}
    for arch in ARCHS:
        cfg = reduce_for_smoke(get_config(arch))
        d, v = cfg.d_model, cfg.vocab_size
        groups = {"all": lambda w: True,
                  "the head (d, V)": lambda w: w.shape[-2:] == (d, v)}
        if cfg.rwkv is not None:
            lora, ff = cfg.rwkv.decay_lora, cfg.rwkv.d_ff or cfg.d_ff
            groups.update({
                "the decay LoRA (d, lora), (lora, d)":
                    lambda w: w.shape[-2:] in ((d, lora), (lora, d)),
                "the (d, d) projections": lambda w: w.shape[-2:] == (d, d),
                "the channel mix's (d, ff), (ff, d)":
                    lambda w: w.shape[-2:] in ((d, ff), (ff, d))})
        full = build(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
        full = dpsgd._unflatten(full, [
            torch.from_numpy(saved[f"{arch}/p{i}"]).to(dev)
            for i in range(len(dpsgd._leaves(full)))])
        batch = lt._batch(cfg, cs._pod_run("allreduce"), 0,
                          cs.POD_LOCK_BATCH, cs.POD_LOCK_SEQ, dev)
        paths = ["/".join(map(str, p)) for p, _ in shr._with_path(full)]

        def grads():
            g, _ = torch.func.grad_and_value(
                lambda p: build(cfg, dev).loss(p, batch))(full)
            return dpsgd._leaves(g)

        base = grads()
        res = {}
        for name, chosen in groups.items():
            def matmul(x, w, chosen=chosen):
                if not chosen(w):
                    return real(x, w)
                return real(x.double(), w.double()).to(x.dtype)
            remat._matmul = matmul
            try:
                got = grads()
            finally:
                remat._matmul = real
            res[name] = max((float((a - b).abs().max()), n)
                            for n, a, b in zip(paths, base, got))
        # a column shard's products against the whole product's columns,
        # at the smoke's (d, d) shape and the batch's rows
        x = torch.randn(cs.POD_LOCK_BATCH * cs.POD_LOCK_SEQ, d, device=dev)
        w = torch.randn(d, d, device=dev)
        whole = real(x, w)
        res["column shards bit-equal to the whole product's columns"] = {
            size: all(torch.equal(
                real(x, w[:, i * (d // size):(i + 1) * (d // size)]
                     .contiguous()),
                whole[:, i * (d // size):(i + 1) * (d // size)])
                for i in range(size)) for size in (2, 4)}
        out[arch] = res
        print(f"witness rounding {arch} (the largest gradient difference "
              f"and its leaf, fp32 products against products rounded from "
              f"float64, by group): {json.dumps(res)}", flush=True)
    return out


def rank_gaps(torch, dev, params=None) -> dict:
    """The smoke configs' gradients at tp 2 and 4 against the card alone,
    through the kernels and through float64 scans; on ``params`` (an npz
    of ``save_smoke``) where given, then also the gradient alone against
    the one saved with them."""
    import numpy as np

    from repro_torch.core import dpsgd

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.launch.train import model_specs
    from repro_torch.models import build, tp
    from repro_torch.train import shardings as shr

    meshes = {2: make_fleet_mesh(2, 2), 4: make_fleet_mesh(1, 4)}
    run = cs._pod_run("allreduce")
    out = {}
    for arch in ARCHS:
        cfg = reduce_for_smoke(get_config(arch))
        full = build(cfg, dev).init(
            torch.Generator(device=dev).manual_seed(27))
        saved = None
        if params is not None:
            saved = np.load(params)
            full = dpsgd._unflatten(full, [
                torch.from_numpy(saved[f"{arch}/p{i}"]).to(dev)
                for i in range(len(dpsgd._leaves(full)))])
        batch = lt._batch(cfg, run, 0, cs.POD_LOCK_BATCH, cs.POD_LOCK_SEQ,
                          dev)
        grads = {}
        for mode in ("kernel", "float64", "float64 products"):
            with scans(mode):
                g1, l1 = torch.func.grad_and_value(
                    lambda p: build(cfg, dev).loss(p, batch))(full)
                grads[mode, 1] = ([x for _, x in shr._with_path(g1)],
                                  float(l1))
                for size, mesh in meshes.items():
                    model = tp.model_of(mesh)
                    specs = model_specs(cfg, size)
                    api = build(cfg, dev, model=model)
                    local = shr.shard_model(full, specs, model)
                    g, loss = torch.func.grad_and_value(
                        lambda p: api.loss(p, batch))(local)
                    whole = shr.gather_model(g, specs, model, dst=None)
                    grads[mode, size] = (
                        [x for _, x in shr._with_path(whole)], float(loss))
        paths = ["/".join(map(str, p)) for p, _ in shr._with_path(full)]

        def gap(one, two):
            """(the largest |difference| of any leaf, its leaf, max |g|
            there, the loss difference)."""
            (xs, la), (ys, lb) = grads[one], grads[two]
            worst = max(((float((x - y).abs().max()), n,
                          float(y.abs().max()))
                         for n, x, y in zip(paths, xs, ys)),
                        key=lambda t: t[0] / max(1.0, t[2]))
            return [worst[0], worst[1], worst[2], abs(la - lb)]

        res = {}
        for size in meshes:
            res[f"tp {size}"] = {
                "tp vs alone, kernels": gap(("kernel", size), ("kernel", 1)),
                "tp vs alone, float64": gap(("float64", size),
                                            ("float64", 1)),
                "tp vs alone, float64 products": gap(
                    ("float64 products", size), ("float64 products", 1)),
                "alone, kernels vs float64": gap(("kernel", 1),
                                                 ("float64", 1)),
                "tp, kernels vs float64": gap(("kernel", size),
                                              ("float64", size))}
        if saved is not None:
            xs, la = grads["kernel", 1]
            res["alone vs the saved gradient"] = max(
                (float((x - torch.from_numpy(saved[f"{arch}/g{i}"])
                        .to(dev)).abs().max()), n)
                for i, (n, x) in enumerate(zip(paths, xs))) + (
                abs(la - float(saved[f"{arch}/loss"])),)
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, res)
        out[arch] = ranks
        cs.rank_print(f"witness gaps {arch} ([max |diff|, leaf, max |g| "
                      f"there, loss diff]; rank 0's, every rank the same: "
                      f"{all(x == ranks[0] for x in ranks)}): "
                      f"{json.dumps(ranks[0])}")
    return out


def rank_capture(torch, dev) -> dict:
    """The smoke Mode B step of each arch (2 nodes x tp 2, ring-1, SGD)
    eager twice and as a CUDA graph's replay."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import dpsgd
    from repro_torch.core.gossip import ring_plan
    from repro_torch.graphs import GraphedStep
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.launch.train import model_specs, shard_cast
    from repro_torch.models import build, tp
    from repro_torch.optim.schedule import constant_lr
    from repro_torch.train import shardings as shr
    from repro_torch.train import step as ts

    mesh = make_fleet_mesh(2, 2)
    model, fleet = tp.model_of(mesh), shr.fleet_of(mesh)
    plan = ring_plan(("data",), (cs.TPF_NODES,), 1)
    lo, hi = fleet.block(cs.TPF_NODES)
    out = {}
    for arch in ARCHS:
        smoke = reduce_for_smoke(get_config(arch))
        for comp in ("none", "int8"):
            run = cs._pod_run("dpsgd", optimizer="sgd",
                              eta=cs.TPF_ETA["sgd"], compression=comp)
            api = build(smoke, dev, model=model)
            step_fn = ts.make_train_step(
                api, run, plan, constant_lr(run.eta), group=fleet.group,
                model=model, specs=model_specs(smoke, model.size))
            state = ts.init_train_state(
                api, run, torch.Generator(device=dev).manual_seed(1),
                n_nodes=hi - lo, cast=shard_cast(smoke, model))
            batch = dpsgd._tree_map(lambda b: b[lo:hi], cs.pod_batch(
                torch, smoke, 0, cs.TPF_NODES, cs.POD_LOCK_BATCH,
                cs.POD_LOCK_SEQ, "dpsgd"))
            c0 = cs.tp_collectives()
            e1, m1 = step_fn(state, batch)
            c1 = cs.tp_collectives()
            e2, m2 = step_fn(state, batch)
            got, mg = GraphedStep(step_fn)(state, batch)
            torch.cuda.synchronize()
            leaves = list(zip(dpsgd._leaves(e1), dpsgd._leaves(e2),
                              dpsgd._leaves(got)))
            res = {
                "eager_repeat_bit_equal": all(
                    torch.equal(a, b) for a, b, _ in leaves)
                and torch.equal(m1["loss"], m2["loss"]),
                "graph_bit_equal": all(
                    torch.equal(a, c) for a, _, c in leaves)
                and torch.equal(m1["loss"], mg["loss"]),
                "graph_max_abs": max(float((a - c).abs().max())
                                     for a, _, c in leaves),
                "all_gathers": c1["all_gather"][0] - c0["all_gather"][0]}
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, res)
            out[f"{arch} {comp}"] = ranks
            cs.rank_print(f"witness capture {arch} smoke Mode B {comp} "
                          f"(per rank): {json.dumps(ranks)}")
            del state, e1, e2, got, step_fn
    return out


def rank_full(torch, dev) -> dict:
    """recurrentgemma-2b's Mode B at its published widths and depth, 2
    nodes x tp 2, ring-1 none, SGD, eager and as a CUDA graph."""
    from repro_torch.configs import get_config
    from repro_torch.core.gossip import ring_plan
    from repro_torch.launch.mesh import make_fleet_mesh

    cfg = get_config("recurrentgemma-2b")
    plan = ring_plan(("data",), (cs.TPF_NODES,), 1)
    res = cs.rank_tp_steps(
        torch, f"recurrentgemma-2b Mode B at published widths and depth "
        f"({cfg.n_layers} layers), {cs.TPF_NODES} nodes x TP 2, ring-1 "
        f"none, sgd, {cs.TPF_BATCH} x {cs.TPF_SEQ} tokens a node", cfg,
        cs._pod_run("dpsgd", optimizer="sgd", eta=cs.TPF_ETA["sgd"]),
        plan, make_fleet_mesh(2, 2), cs.TPF_NODES, cs.TPF_BATCH, cs.TPF_SEQ,
        cs.TPF_NODES * cs.TPF_BATCH * cs.TPF_SEQ, graphed=True,
        label="witness", replicated=True)
    return {k: v for k, v in res.items() if k != "top"}


ROLES = {"slices": rank_slices, "gaps": rank_gaps, "capture": rank_capture,
         "full": rank_full}


def rank_main(role: str, device: str, params=None) -> None:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world

    dev = init_world(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    result = ROLES[role](torch, dev, *([params] if params else []))
    cs.rank_print(f"FLEET {json.dumps(result)}")
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results/tp_witness.json")
    ap.add_argument("--only", default=",".join(ROLES))
    ap.add_argument("--device", default="cuda",
                    help="cpu: a gloo world of four processes, slices and "
                         "gaps only (the scans' plain versions)")
    ap.add_argument("--save-smoke", type=Path)
    ap.add_argument("--rounding", type=Path)
    ap.add_argument("--params", help="an npz of --save-smoke (gaps only)")
    ap.add_argument("--role", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.role:
        rank_main(args.role, args.device, args.params)
        return
    if args.rounding:
        out = ROOT / args.out
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"rounding": rounding(
            args.rounding.resolve(), args.device)}, indent=1))
        return
    if args.save_smoke:
        save_smoke(args.save_smoke.resolve(), args.device)
        return
    import torch

    if args.device == "cuda":
        if torch.cuda.device_count() < 4:
            sys.exit(f"needs four cards, {torch.cuda.device_count()} "
                     "visible")
        from repro_torch.kernels import _build

        _build.build()
    results = {}
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    for role in args.only.split(","):
        text = cs.torchrun(4, [str(Path(__file__).resolve()), "--role",
                               role, "--device", args.device,
                               *(["--params", str(Path(args.params)
                                                  .resolve())]
                                 if args.params else [])],
                           f"witness {role}", timeout=WORLD_S[role])
        print("\n".join(ln for ln in text.splitlines()
                        if ln.startswith("witness")), flush=True)
        results[role] = cs.fleet_result(text, f"witness {role}")
        out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
