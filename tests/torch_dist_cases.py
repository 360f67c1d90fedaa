"""One rank of the gloo worlds that ``tests/test_torch_dist*.py`` start.

    python tests/torch_dist_cases.py <world_name> <rank> <world_size> <dir>

(worlds: ``four``, ``two``, ``tp`` for ``tests/test_torch_tp.py`` and
``tpf`` for ``tests/test_torch_tp_families.py``)

Each rank joins the world through a ``FileStore`` under ``<dir>`` (no TCP
port, so worlds of parallel test workers never collide), reads
``<dir>/inputs.pkl`` (numpy inputs the test module drew), runs every case
of ``<world_name>`` and writes ``<dir>/rank<r>.pkl``: a dict of numpy
results, each case's outputs gathered whole. Only the port is imported
here (``repro_torch``, never ``jax`` or ``repro``): the last case of each
world records what ``sys.modules`` holds.
"""
from __future__ import annotations

import os
import pickle
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression as t_comp
from repro_torch.core import dpsgd
from repro_torch.core import gossip as t_gossip
from repro_torch.launch.mesh import init_world, make_fleet_mesh
from repro_torch.models import build
from repro_torch.models import tp as t_tp
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import shardings as shr
from repro_torch.train import step as t_step


def _np(tree):
    return dpsgd._tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _plan(spec):
    kind, names, shape, arg = spec
    if kind == "ring":
        return t_gossip.ring_plan(names, shape, arg)
    if kind == "torus":
        return t_gossip.torus_plan(names, shape)
    if kind == "hypercube":
        return t_gossip.hypercube_plan(names, shape)
    if kind == "onepeer":
        return t_gossip.onepeer_plan(names, shape, phase=arg)
    return t_gossip.allreduce_plan(names, shape)


def _block(x: np.ndarray, fleet: shr.Fleet) -> torch.Tensor:
    lo, hi = fleet.block(x.shape[0])
    return torch.from_numpy(np.ascontiguousarray(x[lo:hi]))


def _whole(x: torch.Tensor, fleet: shr.Fleet, n: int) -> np.ndarray:
    return shr.gather_nodes({"x": x}, fleet, n, dst=None)["x"].numpy()


# ---------------------------------------------------------------------------
# The world of four: gossip, compressed gossip, Mode B
# ---------------------------------------------------------------------------

def gossip_cases(inp: dict, fleet: shr.Fleet) -> dict:
    """Every plan through ``gossip_mix_array`` and ``gossip_mix_tree``
    (fused and per leaf) on the world's fleet."""
    out = {}
    for key, spec in inp["plans"].items():
        plan = _plan(spec)
        x = inp["x"][plan.n_nodes]
        out[("array", key)] = _whole(t_gossip.gossip_mix_array(
            _block(x, fleet), plan, fleet.group), fleet, plan.n_nodes)
        if key in inp["bf16_plans"]:
            mixed = t_gossip.gossip_mix_array(
                _block(x, fleet).to(torch.bfloat16), plan, fleet.group)
            out[("array_bf16", key)] = _whole(
                mixed.to(torch.float32), fleet, plan.n_nodes)
        tree = {k: _block(v, fleet) for k, v in inp["tree"][
            plan.n_nodes].items()}
        for fused in (True, False):
            mixed = t_gossip.gossip_mix_tree(tree, plan, fleet.group,
                                             fused=fused)
            out[("tree", key, fused)] = {
                k: _whole(v, fleet, plan.n_nodes) for k, v in mixed.items()}
    return out


def compressed_cases(inp: dict, fleet: shr.Fleet) -> dict:
    out = {}
    for key, (spec, mode, ef) in inp["compressed"].items():
        plan = _plan(spec)
        n = plan.n_nodes
        cfg = t_comp.QuantConfig(mode=mode, error_feedback=ef)
        x, res = inp["cx"][n], inp["cres"][n]
        mixed, new_res = t_comp.compressed_gossip_mix_array(
            _block(x, fleet), _block(res, fleet), plan, cfg, fleet.group)
        bufs, ress = t_comp.compressed_gossip_mix_buffers(
            {"float32": _block(x, fleet)}, {"float32": _block(res, fleet)},
            plan, cfg, fleet.group)
        assert torch.equal(bufs["float32"], mixed)
        assert torch.equal(ress["float32"], new_res)
        out[key] = (_whole(mixed, fleet, n), _whole(new_res, fleet, n))
    return out


def gather_cases(inp: dict, fleet: shr.Fleet) -> dict:
    """``gather_nodes`` to fleet index 0 (what a checkpoint writes), to
    every rank, and ``scatter_nodes`` back from index 0."""
    tree = {k: _block(v, fleet) for k, v in inp["tree"][8].items()}
    tree["step"] = torch.tensor(3)
    to_zero = shr.gather_nodes(tree, fleet, 8)
    every = shr.gather_nodes(tree, fleet, 8, dst=None)
    back = shr.scatter_nodes(to_zero, tree, fleet, 8)
    return {"to_zero": None if to_zero is None else (
                _np(to_zero), sorted({x.device.type for x in
                                      dpsgd._leaves(to_zero)})),
            "every": _np(every),
            "back": all(torch.equal(a, b) for a, b in zip(
                dpsgd._leaves(back), dpsgd._leaves(tree)))}


def mode_b_cases(inp: dict, groups: dict, rank: int) -> dict:
    """Mode B steps from the given full states: the fleet's step (its
    gathered new state and loss) and, on rank 0, the one-process step."""
    out = {}
    for key, case in inp["mode_b"].items():
        cfg = reduce_for_smoke(get_config(case["arch"]))
        run = RunConfig(**case["run"])
        plan = _plan(case["plan"])
        api = build(cfg, "cpu")
        for layout, group in groups.items():
            if group is dist.GroupMember.NON_GROUP_MEMBER:
                continue
            fleet = shr.fleet_of_group(group)
            fn = t_step.make_train_step(api, run, plan,
                                        constant_lr(run.eta), group=group)
            one = t_step.make_train_step(api, run, plan,
                                         constant_lr(run.eta))
            got = []
            for state_np, batch_np in case["steps"]:
                state = params_from_numpy(state_np, "cpu")
                batch = params_from_numpy(batch_np, "cpu")
                new, metrics = fn(shr.shard_nodes(state, fleet, plan.n_nodes),
                                  shr.shard_nodes(batch, fleet, plan.n_nodes))
                whole = shr.gather_nodes(new, fleet, plan.n_nodes, dst=None)
                item = {"state": _np(whole), "loss": float(metrics["loss"])}
                if rank == 0 and layout == "4x1":
                    ref, ref_metrics = one(state, batch)
                    item["one"] = {"state": _np(ref),
                                   "loss": float(ref_metrics["loss"])}
                got.append(item)
            out[(key, layout)] = got
    return out


def mesh_cases() -> dict:
    """The builders over the world of four: a (2, 2) host mesh's names and
    sizes; the refusals of a mesh larger than the world."""
    from repro_torch.launch import mesh as lm

    host = lm.make_host_mesh(2, 2)
    out = {"host": (tuple(host.mesh_dim_names), lm.replica_axes(host),
                    lm.tp_size(host), tuple(host.mesh.shape))}
    for name, build_ in (("fleet 3x2", lambda: lm.make_fleet_mesh(3, 2)),
                         ("production", lm.make_production_mesh),
                         ("multi-pod", lambda: lm.make_production_mesh(
                             multi_pod=True))):
        try:
            build_()
            out[name] = None
        except ValueError as exc:       # the refusal the test reads
            out[name] = str(exc)
    return out


def world_four(inp: dict, rank: int) -> dict:
    mesh = make_fleet_mesh(4, 1)
    fleet = shr.fleet_of(mesh)
    pair = dist.new_group([0, 1])
    out = {"fleet": (fleet.size, fleet.index, fleet.ranks),
           "mesh": mesh_cases()}
    out["gossip"] = gossip_cases(inp, fleet)
    out["compressed"] = compressed_cases(inp, fleet)
    out["gather"] = gather_cases(inp, fleet)
    out["mode_b"] = mode_b_cases(inp, {"4x1": fleet.group, "2x2": pair},
                                 rank)
    return out


# ---------------------------------------------------------------------------
# The world of two: the trainer, train-on-trace, the real-model smoke
# ---------------------------------------------------------------------------

def _train(inp: dict, ckpt: str, steps: int, resume: bool,
           run: dict | None = None) -> dict:
    from repro_torch.launch import train as t_train

    cfg = reduce_for_smoke(get_config(inp["train"]["arch"]))
    run = RunConfig(**(run or inp["train"]["run"]))
    ticks = iter(range(1000))
    return t_train.train_loop(
        cfg, run, nodes=inp["train"]["nodes"], tp=1, steps=steps,
        batch_per_node=2, seq_len=16, ckpt_dir=ckpt,
        ckpt_every=inp["train"]["ckpt_every"],
        fail_at=inp["train"]["fail_at"], fail_node=1, log_every=1,
        resume=resume, clock=lambda: float(next(ticks)), device="cpu")


def world_two(inp: dict, rank: int, root: str) -> dict:
    from repro_torch.sim import batch as t_batch
    from repro_torch.sim import real_model_smoke
    from repro_torch.sim.scenario import get_scenario
    from repro_torch.sim.trace import precompute_traces

    out: dict = {}
    ckpt = os.path.join(root, "ckpt_fleet")
    first = _train(inp, ckpt, inp["train"]["steps"], False)
    again = _train(inp, ckpt, inp["train"]["steps"] + 2, True)
    out["train"] = (first["log"], again["log"])
    out["mode_a"] = _train(inp, None, 3, False, inp["mode_a"])["log"]

    mesh = make_fleet_mesh(2, 1)
    adapter = t_batch.transformer_adapter("stablelm-3b", batch=2,
                                          seq_len=16, device="cpu")
    for name in inp["families"]:
        cfg = get_scenario(name, model_bits=adapter.model_bits,
                           model_shapes=adapter.param_shapes,
                           eval_every_rounds=2)
        tb = precompute_traces([cfg], 3, device="cpu")
        got = {}
        for label, m in (("fleet", mesh), ("one", None)):
            _, res = t_batch.train_model_on_traces(
                adapter, [cfg], 3, eta=0.05, trace_batch=tb, mesh=m,
                device="cpu")
            got[label] = {"losses": res["losses"], "acc": res["acc"],
                          "final": _np(res["final_params"][0])}
        out[("family", name)] = got
    out["smoke"] = real_model_smoke.run(fleet=2, model=1, device="cpu",
                                        rounds=3)

    # a two-rank gossip_mix_tree, then what the port imported
    plan = t_gossip.ring_plan(("data",), (4,), 1)
    fleet = shr.fleet_of(mesh)
    tree = {k: _block(v, fleet) for k, v in inp["tree"].items()}
    out["hygiene_tree"] = {k: _whole(v, fleet, 4) for k, v in
                           t_gossip.gossip_mix_tree(tree, plan,
                                                    fleet.group).items()}
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax.")
                            or m == "repro" or m.startswith("repro."))
    return out


# ---------------------------------------------------------------------------
# The world of four as (fleet 2, model 2) and (1, 4): tensor parallelism
# ---------------------------------------------------------------------------

def _tp_cfg(case: dict):
    import dataclasses

    cfg = reduce_for_smoke(get_config(case["arch"]))
    return dataclasses.replace(cfg, **case.get("replace", {}))


def _tp_batch(case: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in case["batch"].items()}


def _logits(cfg, params, batch, model):
    """The teacher-forced logits (the rank's vocab block where the vocab
    splits over ``model``)."""
    from repro_torch.models import encdec, transformer

    if cfg.is_encdec:
        return encdec.apply(cfg, params, batch["src_embeds"],
                            batch["tokens"], model=model)
    return transformer.apply(cfg, params, batch["tokens"],
                             patch_embeds=batch.get("patch_embeds"),
                             model=model)


def tp_model_cases(inp: dict, meshes: dict, one: bool = False) -> dict:
    """Per (config, tp): the shards' shapes and their round trip, the loss,
    the gathered logits and gradients, and remat full / dots against none
    under tensor parallelism (bit-equality). ``one``: also the port's own
    one-device loss and gradients (``"one"``)."""
    out = {}
    for key, case in inp["models"].items():
        cfg = _tp_cfg(case)
        full = params_from_numpy(case["params"], "cpu")
        batch = _tp_batch(case)
        alone = None
        if one:
            g, loss = torch.func.grad_and_value(
                lambda p: build(cfg, "cpu").loss(p, batch))(full)
            alone = {"loss": float(loss), "grads": _np(g)}
        for size, mesh in meshes.items():
            model = t_tp.model_of(mesh)
            specs = shr.param_specs(case["params"], size, cfg.kv_dim)
            local = shr.shard_model(full, specs, model)
            back = shr.gather_model(local, specs, model, dst=None)
            api = build(cfg, "cpu", model=model)
            got = {"shapes": [tuple(x.shape) for x in dpsgd._leaves(local)],
                   "round_trip": all(torch.equal(a, b) for a, b in zip(
                       dpsgd._leaves(back), dpsgd._leaves(full)))}
            grads = {}
            for remat in ("none", "full", "dots"):
                g, loss = torch.func.grad_and_value(
                    lambda p: api.loss(p, batch, remat=remat))(local)
                grads[remat] = (g, loss)
            g, loss = grads["none"]
            got["remat_equal"] = {
                r: bool(torch.equal(grads[r][1], loss) and all(
                    torch.equal(a, b) for a, b in zip(
                        dpsgd._leaves(grads[r][0]), dpsgd._leaves(g))))
                for r in ("full", "dots")}
            logits = _logits(cfg, local, batch, model)
            if model.splits(cfg.vocab_size):
                logits = t_tp.gather(logits, model)
            got["loss"] = float(loss)
            got["logits"] = logits.detach().numpy()
            got["grads"] = _np(shr.gather_model(g, specs, model, dst=None))
            got["one"] = alone
            out[(key, size)] = got
    return out


def tp_mode_a_cases(inp: dict, mesh) -> dict:
    """Mode A (AdamW with a gradient clip) over (fleet 2, model 2), each
    step from the JAX state: the fleet splits the batch and averages the
    gradients, each replica over its model axis; the clip's norm sums
    the split leaves over the model group. The gathered new state and
    the rank's own replicated leaves."""
    from repro_torch.launch.train import state_specs
    from repro_torch.optim import make_optimizer

    case = inp["tp"]["mode_a"]
    cfg = _tp_cfg(case)
    model, fleet = t_tp.model_of(mesh), shr.fleet_of(mesh)
    specs = shr.param_specs(case["steps"][0][0]["params"], model.size,
                            cfg.kv_dim)
    run = RunConfig(**case["run"])
    api = build(cfg, "cpu", model=model)
    opt = make_optimizer(run.optimizer, grad_clip=case["clip"], model=model,
                         sharded=["model" in sp
                                  for sp in shr.spec_leaves(specs)])
    out = []
    for state_np, batch_np in case["steps"]:
        sspecs = state_specs(state_np, specs)
        state = shr.shard_model(params_from_numpy(state_np, "cpu"), sspecs,
                                model)
        batch = params_from_numpy(batch_np, "cpu")
        share = batch["tokens"].shape[0] // fleet.size
        batch = dpsgd._tree_map(lambda x: x[fleet.index * share:
                                            (fleet.index + 1) * share],
                                batch)
        grads, loss = torch.func.grad_and_value(
            lambda p: api.loss(p, batch))(state["params"])
        grads = dpsgd._tree_map(
            lambda g: t_step._fleet_mean(g, fleet.group), grads)
        params, new_opt = opt.update(grads, state["opt"], state["params"],
                                     constant_lr(run.eta)(state["step"]))
        new = {**state, "params": params, "opt": new_opt,
               "step": state["step"] + 1}
        whole = shr.gather_model(new, sspecs, model, dst=None)
        out.append({"state": _np(whole),
                    "loss": float(t_step._fleet_mean(loss, fleet.group)),
                    "replicated": _replicated(new["params"], specs)})
    return out


def _replicated(params, specs) -> list:
    """The rank's leaves its specs leave whole over the model axis."""
    return [x.detach().numpy() for x, sp in
            zip(dpsgd._leaves(params), shr.spec_leaves(specs))
            if "model" not in sp]


def tp_mode_b_cases(inp: dict, mesh) -> dict:
    """Mode B over (fleet 2, model 2), none and int8, each step from the
    JAX state: the gathered new state, the loss, the rank's replicated
    leaves; and the int8 message's scales on the shards against a
    one-process quantization of the same carried values."""
    out = {}
    model, fleet = t_tp.model_of(mesh), shr.fleet_of(mesh)
    for key, case in inp["tp"]["mode_b"].items():
        cfg = _tp_cfg(case)
        run = RunConfig(**case["run"])
        plan = _plan(case["plan"])
        n = plan.n_nodes
        specs = shr.param_specs(case["steps"][0][0]["params"], model.size,
                                cfg.kv_dim)
        from repro_torch.launch.train import state_specs

        step = t_step.make_train_step(build(cfg, "cpu", model=model), run,
                                      plan, constant_lr(run.eta),
                                      group=fleet.group, model=model,
                                      specs=specs)
        got = []
        for state_np, batch_np in case["steps"]:
            sspecs = state_specs(state_np, specs)
            state = shr.shard_nodes(shr.shard_model(
                params_from_numpy(state_np, "cpu"), sspecs, model), fleet, n)
            batch = shr.shard_nodes(params_from_numpy(batch_np, "cpu"),
                                    fleet, n)
            new, metrics = step(state, batch)
            whole = shr.gather_nodes(
                shr.gather_model(new, sspecs, model, dst=None), fleet, n,
                dst=None)
            item = {"state": _np(whole), "loss": float(metrics["loss"]),
                    "replicated": _replicated(new["params"], specs)}
            if run.compression == "int8":
                item["scales_equal"] = _scales_equal(
                    state, params_from_numpy(state_np, "cpu"), specs, model,
                    fleet, n)
            got.append(item)
        out[key] = got
    return out


def _scales_equal(state, whole_np, specs, model, fleet, n) -> bool:
    """The int8 row scales of the carried values (x + e) on the rank's
    shards, bit-equal to the one-process quantization's rows of the same
    values."""
    lo, hi = fleet.block(n)
    same = True
    for x, e, wx, we, sp in zip(
            dpsgd._leaves(state["params"]), dpsgd._leaves(state["residual"]),
            dpsgd._leaves(whole_np["params"]),
            dpsgd._leaves(whole_np["residual"]), shr.spec_leaves(specs)):
        d = shr.model_dim(sp, x.dim())
        split = model if d is not None and d == x.dim() - 1 else None
        _, scale = t_step._quantize_rowwise_int8(
            x + e, split if split is not None else t_tp.ONE)
        _, want = t_step._quantize_rowwise_int8((wx + we)[lo:hi])
        if d is not None and d != x.dim() - 1:
            want = want.chunk(model.size, dim=d)[model.index]
        same = same and torch.equal(scale, want)
    return same


def _wait_for(path: str, timeout: float = 600.0) -> dict:
    """The pickle at ``path`` once it exists (written whole by a rename)."""
    import time

    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} within {timeout:g} s")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def tp_mode_a_trainer(inp: dict, root: str) -> dict:
    """``train_loop --nodes 1 --tp 2 --mode allreduce`` over the (2, 2)
    world (two replicas, each over a model axis of 2) with a checkpoint:
    its log, and how many leaves this rank gathered over the model axis
    (the replicated state is saved from fleet index 0's axis alone: the
    other fleet index gathers none onto its devices)."""
    from repro_torch.launch import train as t_train

    case = inp["tp"]["trainer_a"]
    cfg = reduce_for_smoke(get_config(case["arch"]))
    calls = [0]
    real = shr._gather_leaf_model

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    ticks = iter(range(1000))
    shr._gather_leaf_model = counted
    try:
        log = t_train.train_loop(
            cfg, RunConfig(**case["run"]), nodes=1, tp=2,
            steps=case["steps"], batch_per_node=case["batch"],
            seq_len=16, ckpt_dir=os.path.join(root, "ckpt_tp_a"),
            ckpt_every=case["steps"], log_every=1,
            clock=lambda: float(next(ticks)), device="cpu")["log"]
    finally:
        shr._gather_leaf_model = real
    return {"log": log, "model_gathers": calls[0]}


def world_tp(inp: dict, rank: int, root: str) -> dict:
    from repro_torch.examples import pod_gossip_train
    from repro_torch.launch import train as t_train
    from repro_torch.sim import real_model_smoke

    two = make_fleet_mesh(2, 2)
    four = make_fleet_mesh(1, 4)
    out = {"place": (shr.fleet_of(two).index, t_tp.model_of(two).index)}
    out["models"] = tp_model_cases(inp["tp"], {2: two, 4: four})
    out["smoke"] = real_model_smoke.run(fleet=2, model=2, device="cpu",
                                        rounds=3)
    # the compressed_int8 family over (2, 2) against the one-device
    # reference loop: the int8 blocks are the whole leaves'
    out["smoke_int8"] = real_model_smoke.run(
        fleet=2, model=2, scenario="compressed_int8", device="cpu",
        rounds=3)
    out["trainer_a"] = tp_mode_a_trainer(inp, root)
    train = inp["tp"]["train"]
    cfg = reduce_for_smoke(get_config(train["arch"]))
    ckpt = os.path.join(root, "ckpt_tp")
    logs = []
    for resume in (False, True):
        if resume:      # resume from the checkpoint before the last
            if rank == 0:
                import shutil

                shutil.rmtree(os.path.join(ckpt, f"step_{train['steps']:08d}"))
            dist.barrier()
        ticks = iter(range(1000))
        logs.append(t_train.train_loop(
            cfg, RunConfig(**train["run"]), nodes=2, tp=2,
            steps=train["steps"],
            batch_per_node=2, seq_len=16, ckpt_dir=ckpt,
            ckpt_every=train["ckpt_every"], fail_at=train["fail_at"],
            fail_node=1, log_every=1, resume=resume,
            clock=lambda: float(next(ticks)), device="cpu")["log"])
    out["train"] = logs
    twin = inp["tp"]["twin"]
    out["twin"] = pod_gossip_train.run(
        nodes=2, tp_size=2, steps=len(twin["batches"]), device="cpu",
        init=twin["init"], batches=twin["batches"], log=lambda *_: None)
    out["twin_alone"] = pod_gossip_train.run(
        nodes=2, tp_size=1, steps=len(twin["batches"]), device="cpu",
        init=twin["init"], batches=twin["batches"], log=lambda *_: None,
        alone=True)
    # the JAX steps' states, which the test module writes once its jitted
    # steps have run (while the cases above ran)
    inp["tp"].update(_wait_for(os.path.join(root, "steps.pkl")))
    out["mode_a"] = tp_mode_a_cases(inp, two)
    out["mode_b"] = tp_mode_b_cases(inp, two)
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax.")
                            or m == "repro" or m.startswith("repro."))
    return out


# ---------------------------------------------------------------------------
# The world of four again: tensor parallelism of the MoE, MLA, recurrent
# and encoder-decoder families
# ---------------------------------------------------------------------------

# the wrappers' plain versions, by module: a CPU tensor's kernel calls
_PLAIN = {"flash_attention": ("flash_attention_plain",
                              "flash_attention_bwd_plain"),
          "rglru_scan": ("rglru_scan_plain", "rglru_scan_bwd_plain"),
          "rwkv6_scan": ("rwkv6_scan_plain", "rwkv6_scan_bwd_plain")}


def _counting_plain() -> tuple[dict, list]:
    """Count every call of the kernels' plain versions (the calls a CUDA
    tensor would launch a kernel for); returns (counts, undo list)."""
    import importlib

    counts, undo = {}, []
    for mod_name, names in _PLAIN.items():
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        for name in names:
            real = getattr(mod, name)
            counts[name] = 0

            def counted(*a, _real=real, _name=name, **kw):
                counts[_name] += 1
                return _real(*a, **kw)
            setattr(mod, name, counted)
            undo.append((mod, name, real))
    return counts, undo


def tpf_axis_of_one(inp: dict, mesh) -> dict:
    """Each family on a model axis of one (a real group of one rank, the
    (4, 1) mesh): loss and gradients through the tensor-parallel code
    bit-equal to the one-device code's, with the same kernel calls."""
    model = t_tp.model_of(mesh)
    out = {}
    for key, case in inp["models"].items():
        cfg = _tp_cfg(case)
        full = params_from_numpy(case["params"], "cpu")
        batch = _tp_batch(case)
        got = []
        for api in (build(cfg, "cpu"), build(cfg, "cpu", model=model)):
            counts, undo = _counting_plain()
            try:
                g, loss = torch.func.grad_and_value(
                    lambda p: api.loss(p, batch))(full)
            finally:
                for mod, name, real in undo:
                    setattr(mod, name, real)
            got.append((g, loss, counts))
        (g1, l1, c1), (g2, l2, c2) = got
        out[key] = {"group_size": model.size,
                    "bit_equal": bool(torch.equal(l1, l2) and all(
                        torch.equal(a, b) for a, b in zip(
                            dpsgd._leaves(g1), dpsgd._leaves(g2)))),
                    "calls": (c1, c2)}
    return out


def tpf_int8_layouts(inp: dict, mesh) -> dict:
    """Mode B's rowwise int8 on node-stacked shards of every family's
    leaves (``ew_*`` led by 'model', ``w_ai`` split in the middle, 1-D
    ``('model',)`` leaves, row-split matrices): each leaf's scales on the
    rank, its row max over the model group where ``_model_flags`` says its
    last dim is split, bit-equal to a one-process quantization's rows of
    the rank's slice."""
    model = t_tp.model_of(mesh)
    out = {}
    for key, case in inp["models"].items():
        cfg = _tp_cfg(case)
        full = dpsgd.replicate(params_from_numpy(case["params"], "cpu"), 2)
        full = dpsgd._tree_map(
            lambda x: x * torch.tensor([[1.0], [1.5]]).reshape(
                2, *[1] * (x.dim() - 1)), full)
        specs = shr.param_specs(case["params"], model.size, cfg.kv_dim)
        local = shr.shard_model(full, specs, model)
        _, rows = t_step._model_flags(specs, model)
        same = []
        for x, w, sp, m in zip(dpsgd._leaves(local), dpsgd._leaves(full),
                               shr.spec_leaves(specs), rows):
            q, scale = t_step._quantize_rowwise_int8(x, m)
            wq, want = t_step._quantize_rowwise_int8(w)
            d = shr.model_dim(sp, x.dim())
            if d is not None:
                wq = wq.chunk(model.size, dim=d)[model.index]
                if d != x.dim() - 1:
                    want = want.chunk(model.size, dim=d)[model.index]
            same.append(bool(torch.equal(scale, want)
                             and torch.equal(q, wq)))
        out[key] = same
    return out


def tpf_trainer(inp: dict, root: str) -> dict:
    """``train_loop --nodes 2 --tp 2`` on the rwkv6 smoke config with a
    checkpoint (Mode B, momentum SGD: linear in the gradient), graphed by
    default: its log, and whether it chose the graph (a step through
    split RG-LRU channels alone runs eager; on the CPU a graph's step
    runs eager inside it)."""
    from repro_torch.launch import train as t_train

    case = inp["trainer"]
    ticks = iter(range(1000))
    real = t_train.GraphedStep
    made = []

    def graphed(step_fn):
        made.append(1)
        return real(step_fn)

    t_train.GraphedStep = graphed
    try:
        log = t_train.train_loop(
            reduce_for_smoke(get_config(case["arch"])),
            RunConfig(**case["run"]), nodes=2, tp=2, steps=case["steps"],
            batch_per_node=2, seq_len=16,
            ckpt_dir=os.path.join(root, "ckpt_tpf"),
            ckpt_every=case["steps"], log_every=1,
            clock=lambda: float(next(ticks)), device="cpu")["log"]
    finally:
        t_train.GraphedStep = real
    return {"log": log, "graphed": bool(made)}


def world_tpf(inp: dict, rank: int, root: str) -> dict:
    from repro_torch.sim import real_model_smoke

    two = make_fleet_mesh(2, 2)
    four = make_fleet_mesh(1, 4)
    alone = make_fleet_mesh(4, 1)
    tpf = inp["tpf"]
    out = {"place": (shr.fleet_of(two).index, t_tp.model_of(two).index)}
    out["models"] = tp_model_cases(tpf, {2: two, 4: four}, one=True)
    out["axis_one"] = tpf_axis_of_one(tpf, alone)
    out["int8"] = {size: tpf_int8_layouts(tpf, mesh)
                   for size, mesh in ((2, two), (4, four))}
    out["smoke"] = {arch: real_model_smoke.run(
        arch=arch, fleet=2, model=2, device="cpu", rounds=2)
        for arch in tpf["smoke_archs"]}
    out["trainer"] = tpf_trainer(tpf, root)
    # the JAX steps' states, which the test module writes once its jitted
    # steps have run
    tpf.update(_wait_for(os.path.join(root, "steps.pkl")))
    out["mode_a"] = tp_mode_a_cases({"tp": tpf}, two)
    out["mode_b"] = tp_mode_b_cases({"tp": tpf}, two)
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax.")
                            or m == "repro" or m.startswith("repro."))
    return out


def main(argv) -> int:
    name, rank, world, root = argv[1], int(argv[2]), int(argv[3]), argv[4]
    torch.manual_seed(0)
    init_world("cpu", init_method=f"file://{os.path.join(root, 'store')}",
               rank=rank, world_size=world)
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    worlds = {"four": lambda: world_four(inp, rank),
              "two": lambda: world_two(inp, rank, root),
              "tp": lambda: world_tp(inp, rank, root),
              "tpf": lambda: world_tpf(inp, rank, root)}
    out = worlds[name]()
    dist.barrier()
    dist.destroy_process_group()
    fd, tmp = tempfile.mkstemp(dir=root)
    with os.fdopen(fd, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(root, f"rank{rank}.pkl"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
