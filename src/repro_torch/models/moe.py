"""Mixture-of-Experts MLP: token-choice top-k routing, shared experts,
capacity-bounded sort-based dispatch.

The torch counterpart of ``repro.models.moe``, the same arithmetic:

* the router in fp32, softmax, top-k with ties toward the lower expert
  index (``lax.top_k``'s rule; ``torch.topk`` promises no order among ties
  on CUDA, so the top k come from a stable descending sort), gates
  renormalized over the k;
* per batch row, the (token, slot) pairs sorted stably by expert (the
  JAX package's ``argsort`` is stable: the later positions of an expert's
  group are the ones past its capacity ``cap`` and dropped), dropped pairs
  sent to one sink row past the buffer's ``E * B * cap`` rows;
* the expert SwiGLU as one batched product over experts (outside any
  kernel, as in the JAX package);
* the combine: each token's k expert outputs, gated, summed in a fixed
  order, ascending expert index, from zero. That is the order in which the
  JAX package's ``.at[token].add`` meets them (its updates come in the
  stable sort's order), and it needs no atomics, so a bf16 serve repeats
  itself on the card (``index_add_`` there sums in a run-dependent order).

The JAX package's per-row ``vmap`` becomes a batch axis: the dispatch
buffer is laid out expert-major, (E, B * cap, d), so the expert products
are one ``bmm`` each with no transpose. ``_wsc`` (a sharding hint, a
no-op off-mesh) has no counterpart.

Under tensor parallelism the experts split over the ``model`` axis
(``moe_apply``). The sum then runs in another order: each rank combines
its own experts' outputs in ascending expert order from zero, adds the
shared experts' partial sum, and the ranks' sums are added by the
all-reduce; one device adds all k outputs in ascending order and then the
shared experts' whole output. The terms are the same, their roundings
differ.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from . import tp
from .layers import dense_init, mlp, mlp_init, mlp_local, normal, torch_dtype
from .remat import product

__all__ = ["moe_init", "moe_route", "moe_apply", "combine",
           "moe_active_params", "capacity"]


def moe_init(gen: torch.Generator, cfg: ModelConfig, mcfg: MoEConfig,
             device: torch.device) -> dict:
    e, d, f = mcfg.n_experts, cfg.d_model, mcfg.d_ff_expert
    pd = cfg.param_dtype
    p = {
        "router": dense_init(gen, d, e, device, dtype=pd),
        "ew_gate": normal(gen, (e, d, f), device, d**-0.5, pd),
        "ew_up": normal(gen, (e, d, f), device, d**-0.5, pd),
        "ew_down": normal(gen, (e, f, d), device, f**-0.5, pd),
    }
    if mcfg.n_shared:
        p["shared"] = mlp_init(gen, d, f * mcfg.n_shared, "swiglu", device,
                               pd)
    return p


def capacity(s: int, mcfg: MoEConfig) -> int:
    """Slots per expert and batch row (the JAX package's ``moe.py:93``);
    the floor lets short rows (decode steps) run drop-free."""
    e, k = mcfg.n_experts, mcfg.top_k
    return max(int(s * k * mcfg.capacity_factor / e), min(s, 64), k)


def moe_route(p: dict, x: torch.Tensor, cfg: ModelConfig,
              mcfg: MoEConfig) -> dict:
    """The routing of x (B, S, d): ``expert`` and ``gate`` (B, S, k) in
    ``lax.top_k``'s order (descending probability, ties to the lower
    index), and ``keep`` (B, S, k): False for a (token, expert) pair past
    its expert's capacity in its row, which the combine drops. ``slot``
    (B, S, k) is the pair's row of the expert-major buffer (E * B * cap
    rows, the sink row last)."""
    dt = torch_dtype(cfg.dtype)
    b, s, _ = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    cap = capacity(s, mcfg)
    logits = product(x, p["router"]["w"].to(dt)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    probs_sorted, order = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate, expert = probs_sorted[..., :k], order[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # per row: the (token, slot) pairs sorted stably by expert; a pair's
    # position within its expert's group decides whether it fits
    flat = expert.reshape(b, s * k)
    sorted_e, perm = torch.sort(flat, dim=-1, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(s * k, device=x.device) - first
    pos = torch.empty_like(pos_sorted).scatter_(1, perm, pos_sorted)
    keep = pos < cap
    rows = torch.arange(b, device=x.device)[:, None]
    slot = torch.where(keep, (flat * b + rows) * cap + pos, e * b * cap)
    return {"expert": expert, "gate": gate, "keep": keep.reshape(b, s, k),
            "slot": slot.reshape(b, s, k), "cap": cap}


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, mcfg: MoEConfig,
              model: tp.Model = tp.ONE) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).

    ``model`` (tensor parallelism) with the experts split over it
    (``ew_*`` the rank's ``E / size`` experts): the routing runs whole and
    identical on every rank (the router replicated, the capacity and the
    stable sorts over all E experts: the same drops as on one device);
    the rank fills and runs only its experts' block of the expert-major
    buffer (every other pair goes to the sink row) and combines its
    experts' outputs; x and the router enter by ``tp.copy_in`` (the gates
    multiply only the rank's experts, so their gradients are partial).
    The shared experts, column / row split, add their partial sum to the
    combine's, and one ``tp.reduce_out`` sums both over the ranks."""
    dt = torch_dtype(cfg.dtype)
    b, s, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    split = model.splits(e)
    xs = tp.copy_in(x, model) if split else x
    router = {n: tp.copy_in(w, model) for n, w in p["router"].items()} \
        if split else p["router"]
    r = moe_route({"router": router}, xs, cfg, mcfg)
    cap = r["cap"]
    lo, hi = model.block(e) if split else (0, e)
    if split:       # the rank's experts' pairs; every other to the sink
        mine = r["keep"] & (r["expert"] >= lo) & (r["expert"] < hi)
        r = {**r, "keep": mine,
             "slot": torch.where(mine, r["slot"] - lo * b * cap,
                                 (hi - lo) * b * cap)}

    # dispatch: every kept pair's token row into its slot; dropped pairs
    # all land on the sink row, which is cut off
    slot = r["slot"].reshape(-1)
    src = xs.to(dt).repeat_interleave(k, dim=1).reshape(-1, d)
    buf = x.new_zeros(((hi - lo) * b * cap + 1, d), dtype=dt)
    buf[slot] = src
    xe = buf[:-1].view(hi - lo, b * cap, d)
    del src, buf

    # per-expert SwiGLU, batched over experts (each buffer dropped as soon
    # as the next is made: at cap = S, fp32, they are GBs each)
    h = F.silu(product(xe, p["ew_gate"].to(dt))) \
        * product(xe, p["ew_up"].to(dt))
    del xe
    ye = product(h, p["ew_down"].to(dt)).view((hi - lo) * b * cap, d)
    del h
    y = combine(ye, r)

    f = mcfg.d_ff_expert * mcfg.n_shared
    if split and "shared" in p and model.splits(f):
        y = y + mlp_local(p["shared"], xs.to(dt), "swiglu", dt)
        return tp.reduce_out(y, model)
    if split:
        y = tp.reduce_out(y, model)
    if "shared" in p:
        y = y + mlp(p["shared"], x.to(dt), "swiglu", dt, model, f)
    return y


def combine(ye: torch.Tensor, r: dict) -> torch.Tensor:
    """The experts' outputs ``ye`` (E * B * cap, d), in the buffer's rows,
    back to (B, S, d): each token's k outputs, gated (zero where dropped),
    summed from zero in ascending expert order, one rounding to ye's dtype
    per addition: the JAX package's scatter-add order on the host."""
    b, s, k = r["slot"].shape
    d = ye.shape[-1]
    ye = torch.cat([ye, ye.new_zeros((1, d))])            # the sink row
    w = (r["gate"] * r["keep"]).to(ye.dtype)
    picked = ye[r["slot"]] * w[..., None]                 # (b, s, k, d)
    by_expert = torch.argsort(r["expert"], dim=-1)
    picked = torch.gather(picked, 2,
                          by_expert[..., None].expand(-1, -1, -1, d))
    y = torch.zeros((b, s, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        y = y + picked[:, :, j]
    return y


def moe_active_params(cfg: ModelConfig, mcfg: MoEConfig) -> int:
    """Per-layer active (per-token) MoE params: top-k + shared experts."""
    per_expert = 3 * cfg.d_model * mcfg.d_ff_expert
    return per_expert * (mcfg.top_k + mcfg.n_shared)
