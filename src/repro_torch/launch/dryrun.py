"""One-card dry run: every (arch x shape) cell evaluated on data-free
tensors, its peak bytes, flops, kernel launches and collective bytes.

The torch counterpart of ``repro.launch.dryrun``. The JAX package lowers
and compiles each cell on placeholder devices and reads XLA's memory and
cost analyses; the port has no compiler to ask, so it runs the cell's
step itself on tensors that hold no data: ``FakeTensorMode``, with the
card (``cuda:0``) as the fake device where a card is present and the CPU
elsewhere (the CPU build of torch has no CUDA device guard for autograd to
use); the numbers do not depend on which (``chip_smoke.py`` phase 24 runs
both). Nothing is allocated and no weight is drawn, so ``--all`` runs on
a host without a card. Every hand-written kernel's wrapper answers a
data-free tensor with its shape rule (``kernels._backend.data_free``): the
kernel's outputs and scratch, no launch and no plain version, the launch
counted with its cost (``kernels.cost``) on the wrapper.

What a cell records, besides status, reason and error as the reference:

* ``params_bytes``, ``opt_bytes``, ``residual_bytes`` of the train state
  (the serving weights for serve cells) and the batch's bytes;
* ``peak_bytes``: the most bytes of device storage alive at once during
  one step, tracked op by op (:class:`PeakTracker`; each storage rounded up
  to the 512-byte blocks of the card's allocator), the state and batch
  included, and ``end_bytes`` still alive once the step has returned and
  the old state is dropped. ``torch.cuda.max_memory_allocated`` is the
  card's counterpart (phase 24 holds them within 10 %). The step runs
  eagerly: a ``graphs.GraphedStep`` cannot capture fake tensors, so the
  cell says ``"graphed": false`` and the graph pool's copies of the state
  are not in its peak;
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  aten products plus, for each kernel launch, ``kernels.cost``'s at its
  shapes (``flops_aten``, ``flops_kernels``), and ``kernel_launches`` by
  kernel (the wrappers' ``.launches`` names);
* ``collectives`` / ``collectives_split``: ``utils.collectives`` of the
  distributed step over ``--nodes`` nodes (on one card nothing is sent);
* ``fits`` against ``capacity_bytes`` (the card's
  ``torch.cuda.get_device_properties`` on the card, else
  :data:`H100_BYTES`), and for train cells ``fewest_microbatches``: the
  fewest whole microbatches of the replica's batch whose step fits (None
  if none does), each count tried as a step of two microbatches of its
  size (every microbatch of a step is alike), plus the batch's bytes.

Train cells run ``train/step.py:make_train_step``: Mode A for ``--mode
allreduce``, Mode B with ``--nodes`` nodes on one device for ``dpsgd``
(the plan from the density controller, or ``--topology``). Serve cells
run ``launch/serve.py``'s weights (cast as drawn) and one decode step: a
``prefill`` shape prefills a prompt of its length first (the cache one
longer), a ``decode`` shape decodes the last position of a cache of its
length, made whole, as the reference's decode cell does. An
encoder-decoder's S positions are S / 2 source frames and S / 2 target
tokens.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-vl-2b \\
      --shape train_4k --mode allreduce --microbatch 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Each cell writes ``<out>/card/<arch>__<shape>[tag].json`` (resumable:
existing files are skipped unless --force). ``--mesh single`` and
``multi`` (the reference's pod meshes, with tensor parallelism over their
'model' axis) wait for ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import tree_leaves

from ..configs import ARCHS, SHAPES, RunConfig, cell_is_runnable, get_config
from ..core.comm_model import LinkModel
from ..core.density_controller import (candidate_plans, choose_plan,
                                       evaluate_plan)
from ..core.dpsgd import _leaves
from ..kernels import counted_wrappers
from ..models import build, encdec, tp, transformer
from ..models.layers import torch_dtype
from ..optim.schedule import constant_lr
from ..train.step import (init_train_state, make_train_step,
                          reshape_batch_for_nodes)
from ..utils.collectives import step_collectives
from .serve import init_serving_params
from .train import param_bytes

__all__ = ["PeakTracker", "train_cell", "serve_cell",
           "fewest_microbatches", "check_mesh", "run_cell", "main",
           "H100_BYTES", "ALLOC_BLOCK"]

# The card's memory as torch sees it on an H100 80GB HBM3, 700 W
# (torch.cuda.get_device_properties(0).total_memory, read by
# chip_smoke.py phase 24; nvidia-smi --query-gpu=memory.total reads
# 81559 MiB on the same card), used where no card is present.
H100_BYTES = 85_017_493_504
ALLOC_BLOCK = 512      # the CUDA caching allocator's block granularity


class PeakTracker(torch.utils._python_dispatch.TorchDispatchMode):
    """Bytes of device storage alive, tracked op by op: every storage an
    operation's outputs hold that is new on ``device_type`` is counted
    (rounded up to ``ALLOC_BLOCK``) until it is freed (a weak reference's
    finalizer); ``now`` is the bytes alive, ``peak`` the most since the
    last :meth:`reset_peak`. Storages made before the mode was entered are
    not seen."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.live: dict[int, int] = {}
        self.now = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def note(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
        self.live[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def reset_peak(self) -> None:
        self.peak = self.now

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and \
                    t.device.type == self.device_type:
                self.note(t)
        return out


def _fake_device() -> torch.device:
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")


def _capacity() -> tuple[int, str]:
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return int(props.total_memory), \
            f"torch.cuda.get_device_properties(0) ({props.name})"
    return H100_BYTES, "H100_BYTES (H100 80GB HBM3)"


@contextlib.contextmanager
def _evaluating(device: torch.device):
    """A fake mode on ``device``'s type with the peak tracker and the flop
    counter: yields (tracker, flops)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode(allow_non_fake_inputs=True), \
            PeakTracker(device.type) as tracker, \
            FlopCounterMode(display=False) as flops:
        yield tracker, flops


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree)) \
        if tree is not None else 0


def _shaped() -> list[tuple[int, float]]:
    """Each counted wrapper's shape-rule launches and flops so far."""
    return [(w.dry_launches, w.dry_flops) for w in counted_wrappers()]


def _kernels(before: list[tuple[int, float]]) -> dict:
    """The shape rules' launches by wrapper and their flops since
    ``before`` (:func:`_shaped`)."""
    launches: dict[str, int] = {}
    kflops = 0.0
    for w, (n, f) in zip(counted_wrappers(), before):
        if w.dry_launches > n:
            launches[w.__name__] = w.dry_launches - n
            kflops += w.dry_flops - f
    return {"kernel_launches": launches, "flops_kernels": kflops}


def _batch(cfg, b: int, s: int, device: torch.device) -> dict:
    """A batch of ``b`` sequences as ``launch.train`` makes it (int32
    tokens; the vision or audio stub's embeddings), data-free."""
    dt = torch_dtype(cfg.dtype)
    if cfg.is_encdec:
        half = s // 2
        return {"tokens": torch.zeros((b, half), dtype=torch.int32,
                                      device=device),
                "src_embeds": torch.empty((b, half, cfg.d_model), dtype=dt,
                                          device=device)}
    batch = {"tokens": torch.zeros((b, s), dtype=torch.int32, device=device)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.empty((b, cfg.n_patches, cfg.d_model),
                                            dtype=dt, device=device)
    return batch


def _plan(cfg, run: RunConfig, nodes: int) -> tuple[Any, dict]:
    """The gossip plan of a Mode B cell, as ``launch.train`` (or the
    reference's dry run for an explicit ``--topology``) picks it."""
    pbytes = param_bytes(cfg)
    if run.topology == "auto":
        choice = choose_plan(("data",), (nodes,), run.lambda_target,
                             bytes_per_rank=pbytes, eta=run.eta)
        plan = choice.plan
        return plan, {"name": plan.name, "lam": choice.lam,
                      "degree": plan.degree, "t_com_model_s": choice.t_com_s}
    cands = candidate_plans(("data",), (nodes,), include_onepeer=True)
    named = {p.name: p for p in cands}
    named.update({p.name.split("-")[0]: p for p in cands
                  if p.name.startswith("onepeer")})
    plan = named[run.topology]
    lam, t = evaluate_plan(plan, pbytes, LinkModel())
    return plan, {"name": plan.name, "lam": lam, "degree": plan.degree,
                  "t_com_model_s": t, "override": True}


def train_cell(cfg, run: RunConfig, *, batch: int, seq_len: int,
               nodes: int = 1, plan=None,
               device: Optional[torch.device] = None) -> dict:
    """One step of ``make_train_step`` on data-free tensors: Mode A over a
    batch of ``batch`` sequences, Mode B over ``nodes`` nodes of ``batch /
    nodes`` each (``plan`` the gossip plan). Returns the bytes, peak,
    flops, launches and collectives (no fit)."""
    device = device or _fake_device()
    dpsgd = run.mode == "dpsgd"
    if dpsgd and plan is None:
        raise ValueError("Mode B (dpsgd) needs a gossip plan")
    with _evaluating(device) as (tracker, flops):
        api = build(cfg, device)
        state = init_train_state(api, run, torch.Generator(device=device),
                                 n_nodes=nodes if dpsgd else 1)
        data = _batch(cfg, batch, seq_len, device)
        if dpsgd:
            data = reshape_batch_for_nodes(data, nodes)
        step = make_train_step(api, run, plan, constant_lr(run.eta))
        node_leaves = [(tuple(x.shape[1:] if dpsgd else x.shape),
                        str(x.dtype).removeprefix("torch."))
                       for x in _leaves(state["params"])]
        emb = state["params"]["embed"]["embedding"]
        tied = [(tuple(emb.shape), str(emb.dtype).removeprefix("torch."))] \
            if cfg.tie_embeddings and not dpsgd else []
        out = {"params_bytes": _bytes(state["params"]),
               "opt_bytes": _bytes(state["opt"]),
               "residual_bytes": _bytes(state.get("residual")),
               "batch_bytes": _bytes(data)}
        shaped0 = _shaped()
        aten0 = flops.get_total_flops()
        tracker.reset_peak()
        base = tracker.now
        new_state, metrics = step(state, data)
        out["peak_bytes"] = tracker.peak
        del state, new_state, metrics
        out["end_bytes"] = tracker.now
        out["base_bytes"] = base
        out["flops_aten"] = float(flops.get_total_flops() - aten0)
    out.update(_kernels(shaped0))
    out["flops"] = out["flops_aten"] + out["flops_kernels"]
    out.update(step_collectives(
        node_leaves, run.mode, plan=plan, fused=run.fused_gossip,
        compression=run.compression, microbatch=run.microbatch,
        n_nodes=nodes, tied=tied))
    out["graphed"] = False
    out["fake_device"] = str(device)
    return out


def serve_cell(cfg, *, batch: int, prompt_len: int, max_len: int,
               prefill: bool = True,
               device: Optional[torch.device] = None) -> dict:
    """``launch.serve``'s weights (each layer cast as drawn), then on
    data-free tensors a prefill of ``batch`` prompts of ``prompt_len``
    tokens into caches of ``max_len`` and one decode step; without
    ``prefill`` the caches are made whole (``init_cache``; an
    encoder-decoder's cross K/V as long) and the step decodes position
    ``prompt_len`` against them. The peak runs from the first weight
    drawn, as a serve's does."""
    device = device or _fake_device()
    shaped0 = _shaped()
    with _evaluating(device) as (tracker, flops):
        api = build(cfg, device)
        params = init_serving_params(api, torch.Generator(device=device))
        out = {"params_bytes": _bytes(params), "opt_bytes": 0,
               "residual_bytes": 0}
        inputs = _batch(cfg, batch, (2 if cfg.is_encdec else 1) * prompt_len,
                        device) if prefill else {}
        out["batch_bytes"] = _bytes(inputs)
        if prefill:
            logits, cache = api.prefill(params, inputs, max_len=max_len)
        elif cfg.is_encdec:
            cache = encdec.init_dec_cache(cfg, batch, max_len, max_len,
                                          device=device)
        else:
            cache = transformer.init_cache(cfg, batch, max_len, device=device)
        out["cache_bytes"] = _bytes(cache)
        token = torch.zeros((batch,), dtype=torch.int64, device=device)
        logits, cache = api.decode_step(params, token, cache, prompt_len)
        out["peak_bytes"] = tracker.peak
        out["base_bytes"] = 0
        del logits, cache, inputs
        out["end_bytes"] = tracker.now
        out["flops_aten"] = float(flops.get_total_flops())
    out.update(_kernels(shaped0))
    out["flops"] = out["flops_aten"] + out["flops_kernels"]
    out["graphed"] = False
    out["fake_device"] = str(device)
    return out


def _divisors(n: int) -> list[int]:
    return [m for m in range(1, n + 1) if n % m == 0]


def fewest_microbatches(cfg, run: RunConfig, cell: dict, *, batch: int,
                        seq_len: int, nodes: int, plan, capacity: int,
                        device: Optional[torch.device] = None
                        ) -> tuple[Optional[int], dict]:
    """The fewest whole microbatches of the replica's batch whose step
    fits ``capacity``, found by bisection over the divisors; a count m is
    tried as a step of two microbatches of its size (one for m = 1),
    every microbatch of a step being alike, its peak raised by the bytes
    of the batch the trial leaves out. ``cell`` is :func:`train_cell`'s
    record of the step at the run's own microbatch count, which is the
    trial where that count is 1 or 2. Returns (m or None, {m: peak
    bytes tried})."""
    per = batch // nodes if run.mode == "dpsgd" else batch
    replicas = nodes if run.mode == "dpsgd" else 1
    tried: dict[int, int] = {}

    def peak(m: int) -> int:
        if m not in tried:
            if m == max(run.microbatch, 1) and m <= 2:
                tried[m] = cell["peak_bytes"]
            else:
                k = 1 if m == 1 else 2
                r = train_cell(cfg, dataclasses.replace(run, microbatch=k),
                               batch=k * (per // m) * replicas,
                               seq_len=seq_len, nodes=nodes, plan=plan,
                               device=device)
                tried[m] = r["peak_bytes"] + cell["batch_bytes"] \
                    - r["batch_bytes"]
        return tried[m]

    cands = _divisors(per)
    if peak(cands[-1]) > capacity:
        return None, tried
    lo, hi = 0, len(cands) - 1          # cands[hi] fits
    while lo < hi:
        mid = (lo + hi) // 2
        if peak(cands[mid]) <= capacity:
            hi = mid
        else:
            lo = mid + 1
    return cands[hi], tried


def check_mesh(kind: str) -> None:
    """Raise unless ``kind`` is the one card the port's dry run has."""
    if kind != "card":
        raise NotImplementedError(
            f"--mesh {kind}: the reference's pod meshes run on several "
            f"devices, which waits for {tp.SERVE_ITEM}; the port's dry "
            "run has one card (--mesh card)")


def run_cell(arch: str, shape_name: str, mesh_kind: str = "card",
             mode: str = "dpsgd", run: Optional[RunConfig] = None,
             nodes: int = 4,
             clock: Optional[Callable[[], float]] = None) -> dict:
    """One cell's record. ``clock`` is injectable (runtime/fault.py
    pattern); the default is monotonic."""
    clock = clock or time.perf_counter
    check_mesh(mesh_kind)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    result: dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "mode": mode,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    ok, reason = cell_is_runnable(cfg, shape)
    if not ok:
        result["status"] = "skipped"
        result["reason"] = reason
        return result
    run = run or RunConfig(mode=mode)
    t0 = clock()
    try:
        capacity, origin = _capacity()
        if shape.kind == "train":
            plan = None
            if run.mode == "dpsgd":
                plan, result["plan"] = _plan(cfg, run, nodes)
            result["nodes"] = nodes if run.mode == "dpsgd" else 1
            res = train_cell(cfg, run, batch=shape.global_batch,
                             seq_len=shape.seq_len, nodes=nodes, plan=plan)
            result.update(res)
            m, tried = fewest_microbatches(
                cfg, run, res, batch=shape.global_batch,
                seq_len=shape.seq_len, nodes=nodes, plan=plan,
                capacity=capacity)
            result["fewest_microbatches"] = m
            result["microbatch_peaks"] = {str(k): v
                                          for k, v in tried.items()}
        else:
            # an encoder-decoder's S positions are S / 2 source frames and
            # S / 2 target tokens, as the reference maps them
            s = shape.seq_len // 2 if cfg.is_encdec else shape.seq_len
            prefill = shape.kind == "prefill"
            prompt, max_len = (s, s + 1) if prefill else (s - 1, s)
            result.update(serve_cell(cfg, batch=shape.global_batch,
                                     prompt_len=prompt, max_len=max_len,
                                     prefill=prefill))
        result["capacity_bytes"] = capacity
        result["capacity_origin"] = origin
        result["fits"] = result["peak_bytes"] <= capacity
        result["seconds"] = round(clock() - t0, 2)
        result["status"] = "ok"
    except Exception as e:
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cells():
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"],
                    default="card")
    ap.add_argument("--mode", choices=["dpsgd", "allreduce"], default="dpsgd")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--topology", default="auto")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--no-fused-gossip", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--nodes", type=int, default=4,
                    help="Mode B nodes on the card (chip_smoke phase 22's 4)")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    args = ap.parse_args(argv)
    run_cfg = RunConfig(mode=args.mode, topology=args.topology,
                        remat=args.remat, compression=args.compression,
                        fused_gossip=not args.no_fused_gossip,
                        microbatch=args.microbatch)

    if args.list:
        for arch, shape in _cells():
            ok, reason = cell_is_runnable(get_config(arch), SHAPES[shape])
            print(f"{arch:28s} {shape:12s} "
                  f"{'RUN' if ok else 'SKIP: ' + reason}")
        return 0
    check_mesh(args.mesh)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = list(_cells()) if args.all else [(args.arch, args.shape)]
    failures = 0
    outdir = os.path.join(args.out, "card")
    os.makedirs(outdir, exist_ok=True)
    for arch, shape in cells:
        tag = "" if args.mode == "dpsgd" else f"__{args.mode}"
        if args.tag:
            tag += f"__{args.tag}"
        path = os.path.join(outdir, f"{arch}__{shape}{tag}.json")
        if os.path.exists(path) and not args.force:
            print(f"[skip-existing] {path}", flush=True)
            continue
        print(f"[dryrun] {arch} x {shape} on card ({args.mode})", flush=True)
        res = run_cell(arch, shape, "card", mode=args.mode, run=run_cfg,
                       nodes=args.nodes)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        status = res["status"]
        msg = res.get("error", "")[:200] if status == "error" else \
            res.get("reason", "") if status == "skipped" else \
            (f"peak {res['peak_bytes'] / 2**30:.3f} GiB fits {res['fits']} "
             f"flops {res['flops']:.3g} in {res['seconds']}s")
        print(f"  -> {status} {msg}", flush=True)
        failures += status == "error"
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
