"""Parameter / activation partition specs and the node axis over ranks.

The torch counterpart of ``repro.train.shardings``. Rules are keyed by
parameter *names* (the dict keys in the model trees) and give the spec of
the TRAILING dims; extra leading dims (pattern-unit stacking, the D-PSGD
node axis) are padded with None / the node axes by the callers. GQA with
kv_heads < TP keeps the KV projections replicated (Megatron's GQA rule);
serving caches shard kv-heads when divisible, else head_dim
(``cache_specs``). A spec is a ``P``, a tuple of entries, equal entry for
entry to the JAX package's ``PartitionSpec``.

Both axes are executed. The node axis: ``Fleet`` is a rank's place on the
mesh's node axis, ``shard_nodes`` takes its block of every node-stacked
leaf (the node entry of ``node_param_specs``: sharded when the node count
divides over the fleet, else replicated), ``gather_nodes`` and
``scatter_nodes`` move the whole axis to and from one rank's host memory
(checkpoints, the fault drill), one leaf at a time. The ``model`` axis
(tensor parallelism, ``models.tp``): ``shard_model`` takes a rank's
slice of every leaf by its spec (the spec's entries aligned to the leaf's
trailing dims, so node and family axes in front pass through),
``gather_model`` is its inverse, and ``gather_state`` / ``scatter_state``
compose the two axes: over ``model`` to the model axis's first rank,
then over the node axis to the host of the world's first rank, leaf by
leaf, never the whole state on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.dpsgd import _leaves, _unflatten
from ..core.gossip import all_gather_nodes
from ..models import tp as _tp

PyTree = Any

__all__ = ["P", "param_specs", "cache_specs", "batch_specs", "prepend_axes",
           "node_param_specs", "spec_leaves", "Fleet", "fleet_of",
           "fleet_of_group", "shard_nodes", "gather_nodes", "scatter_nodes",
           "model_dim", "shard_model", "gather_model", "gather_state",
           "scatter_state", "cache_layout", "shard_caches", "gather_caches"]


class P(tuple):
    """A partition spec: one entry a dim (None, an axis name, or a tuple
    of axis names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# trailing-dim rules: name -> tuple over trailing dims ('model' | None)
_W_RULES: dict[str, tuple] = {
    "embedding": ("model", None),
    "lm_head": (None, "model"),
    # attention
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None),
    # mlp
    "w_up": (None, "model"), "w_gate": (None, "model"), "w_down": ("model", None),
    # moe
    "router": (None, None),
    "ew_gate": ("model", None, None), "ew_up": ("model", None, None),
    "ew_down": ("model", None, None),
    "shared": None,  # handled by nested w_up/w_gate/w_down
    # mla
    "wkv_a": (None, None), "w_uk": (None, "model"), "w_uv": (None, "model"),
    # rglru
    "w_x": (None, "model"), "conv_w": (None, "model"),
    "w_ai": (None, "model", None), "b_ai": ("model", None), "lam": ("model",),
    "w_out": ("model", None),
    # rwkv
    "w_r": (None, "model"), "w_k": (None, "model"), "w_v": (None, "model"),
    "w_g": (None, "model"), "w_o": ("model", None),
    "w0": ("model",), "u": ("model",), "ln_scale": ("model",),
    "w_lora_a": (None, None), "w_lora_b": (None, "model"),
    "cw_r": (None, "model"), "cw_k": (None, "model"), "cw_v": ("model", None),
}

# GQA KV-replication: these stay replicated when kv_heads < tp
_KV_NAMES = {"wk", "wv"}


def _with_path(tree: PyTree, path: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) in ``jax.tree``'s order: dict keys sorted, list and
    tuple items in order; a path holds the keys and indices on the way."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _with_path(item, path + (i,))
    else:
        yield path, tree


def _map_with_path(fn, tree: PyTree) -> PyTree:
    return _unflatten(tree, [fn(p, x) for p, x in _with_path(tree)])


def _spec_for_path(path: tuple, leaf, tp: int, kv_dim: Optional[int]) -> P:
    names = [n for n in path if isinstance(n, str)]
    leaf_name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""

    rule: Optional[tuple] = None
    if leaf_name in _W_RULES and _W_RULES[leaf_name] is not None:
        rule = _W_RULES[leaf_name]
        owner = leaf_name
    elif leaf_name == "w" and parent in _W_RULES and _W_RULES[parent] is not None:
        rule = _W_RULES[parent]
        owner = parent
    elif leaf_name == "b" and parent in _W_RULES and _W_RULES[parent] is not None:
        rule = (_W_RULES[parent][-1],)
        owner = parent
    else:
        owner = ""

    if rule is None:
        return P(*([None] * leaf.ndim))

    # GQA: replicate KV projections when kv heads don't divide over TP
    if owner in _KV_NAMES and kv_dim is not None and kv_dim % tp != 0:
        rule = tuple(None for _ in rule)

    # drop 'model' anywhere the dim isn't divisible (e.g. tiny smoke configs)
    dims = leaf.shape[leaf.ndim - len(rule):]
    rule = tuple(("model" if (r == "model" and d % tp == 0) else None)
                 for r, d in zip(rule, dims))
    pad = leaf.ndim - len(rule)
    return P(*([None] * pad + list(rule)))


def param_specs(params: PyTree, tp: int, kv_dim: Optional[int] = None) -> PyTree:
    """The spec tree matching ``params`` (TP over 'model' only)."""
    return _map_with_path(
        lambda path, leaf: _spec_for_path(path, leaf, tp, kv_dim), params)


def cache_specs(caches: PyTree, tp: int, batch_axes: Sequence[str],
                global_batch: int, n_batch_shards: int) -> PyTree:
    """Serving cache specs. Leaves are (B, L, H, D) K/V, (B, L, R) latent,
    (B, ...) recurrent states, or (L,) position tags. Batch shards over
    ``batch_axes`` when divisible; the widest trailing dim divisible by tp
    takes 'model'."""
    baxes = tuple(batch_axes)

    def spec(path, leaf):
        names = [n for n in path if isinstance(n, str)]
        leaf_name = names[-1] if names else ""
        if leaf.ndim == 0:
            return P()
        # position tags (L,) replicate
        if leaf_name == "pos":
            return P(*([None] * leaf.ndim))
        dims = list(leaf.shape)
        # the batch dim is the first dim equal to global_batch (caches may
        # carry a leading repeats dim)
        out: list = [None] * leaf.ndim
        b_idx = dims.index(global_batch) if global_batch in dims else -1
        if b_idx >= 0 and global_batch % n_batch_shards == 0 and n_batch_shards > 1:
            out[b_idx] = baxes if len(baxes) > 1 else baxes[0]
        # model-shard one trailing dim (prefer heads over head_dim)
        for cand in range(max(b_idx + 1, leaf.ndim - 2), leaf.ndim):
            if out[cand] is None and dims[cand] % tp == 0 and dims[cand] >= tp:
                out[cand] = "model"
                break
        return P(*out)

    return _map_with_path(spec, caches)


def batch_specs(batch: PyTree, batch_axes: Sequence[str], global_batch: int,
                n_shards: int) -> PyTree:
    """Input batch specs: shard dim 0 (batch) over batch_axes if divisible."""
    baxes = tuple(batch_axes)
    first = baxes if len(baxes) > 1 else baxes[0]

    def spec(_, leaf):
        if leaf.ndim == 0:
            return P()
        if global_batch % n_shards == 0 and n_shards > 1:
            return P(*([first] + [None] * (leaf.ndim - 1)))
        return P(*([None] * leaf.ndim))

    return _map_with_path(spec, batch)


def prepend_axes(specs: PyTree, axes) -> PyTree:
    """Prepend a (node) axis entry to every spec in the tree."""
    if isinstance(specs, P):
        return P(axes, *specs)
    if isinstance(specs, dict):
        return {k: prepend_axes(v, axes) for k, v in specs.items()}
    return type(specs)(prepend_axes(s, axes) for s in specs)


def _mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of anything with
    ``axis_names`` and a ``shape`` mapping (the JAX meshes' interface)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {a: int(mesh.size(i)) for i, a in enumerate(names)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def node_param_specs(params: PyTree, mesh,
                     kv_dim: Optional[int] = None) -> PyTree:
    """Specs for **node-stacked** parameters: every leaf carries the D-PSGD
    node axis first (``(n_nodes, *shape)``, the ``dpsgd.replicate``
    layout), sharded over every mesh axis except ``'model'`` (the fleet
    axes) when ``n_nodes`` divides the fleet (else replicated, as the TP
    rules drop 'model' on non-divisible dims); the trailing dims follow
    ``param_specs``. Reads only the mesh's axis names and sizes."""
    axes = _mesh_axes(mesh)
    tp = axes.get("model", 1)
    node_axes = tuple(a for a in axes if a != "model")
    fleet = 1
    for a in node_axes:
        fleet *= axes[a]
    node_entry = node_axes if len(node_axes) > 1 else (
        node_axes[0] if node_axes else None)

    def spec(path, leaf):
        if leaf.ndim == 0:
            raise ValueError(
                f"node-stacked leaf at {path!r} is a scalar; every leaf must "
                "lead with the (n_nodes, ...) axis")
        entries = list(_spec_for_path(path, leaf, tp, kv_dim))
        if node_entry is not None and fleet > 1 and leaf.shape[0] % fleet == 0:
            entries[0] = node_entry
        return P(*entries)

    return _map_with_path(spec, params)


def spec_leaves(specs: PyTree) -> list:
    """The specs of a spec tree in ``jax.tree``'s leaf order (a ``P`` is
    a leaf, not a tuple to walk)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for item in specs for s in spec_leaves(item)]


# ---------------------------------------------------------------------------
# The node axis over the fleet's ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Fleet:
    """A rank's place on the mesh's node axis: ``group`` the process group
    of that axis (None: a fleet of one), ``size`` its ranks, ``index``
    this rank's place, ``ranks`` the global ranks in fleet order."""
    group: Any
    size: int
    index: int
    ranks: tuple

    def sharded(self, n_nodes: int) -> bool:
        """Whether ``n_nodes`` spread over the fleet (else every rank holds
        the whole node axis, as ``node_param_specs`` replicates it)."""
        return self.size > 1 and n_nodes % self.size == 0

    def block(self, n_nodes: int) -> tuple[int, int]:
        """[lo, hi) of the node rows this rank holds."""
        if not self.sharded(n_nodes):
            return 0, n_nodes
        b = n_nodes // self.size
        return self.index * b, (self.index + 1) * b

    def global_rank(self, index: int) -> int:
        return self.ranks[index]


def fleet_of_group(group) -> Fleet:
    """The ``Fleet`` of this rank on a process group's ranks, in the
    group's order (None: a fleet of one)."""
    if group is None:
        return Fleet(None, 1, 0, (0,))
    return Fleet(group, dist.get_world_size(group), dist.get_rank(group),
                 tuple(dist.get_process_group_ranks(group)))


def fleet_of(mesh=None) -> Fleet:
    """The ``Fleet`` of this rank on ``mesh``'s one node axis (the
    ``fleet`` dim of ``launch.mesh.make_fleet_mesh``, or ``data``); None
    is a fleet of one."""
    if mesh is None:
        return Fleet(None, 1, 0, (0,))
    names = tuple(mesh.mesh_dim_names)
    node_axes = [a for a in names if a != "model"]
    if len(node_axes) != 1:
        raise NotImplementedError(
            f"the node axis over several mesh dims {node_axes} is not "
            "executed; use a (fleet, model) mesh")
    return fleet_of_group(mesh.get_group(node_axes[0]))


def shard_nodes(tree: PyTree, fleet: Fleet, n_nodes: int) -> PyTree:
    """This rank's block of every node-stacked leaf (leading dim
    ``n_nodes``), each a tensor of its own; 0-d leaves and a replicated
    node axis are kept whole."""
    if not fleet.sharded(n_nodes):
        return tree
    lo, hi = fleet.block(n_nodes)

    def take(x):
        if x.dim() == 0:
            return x
        if x.shape[0] != n_nodes:
            raise ValueError(f"leaf {tuple(x.shape)} does not lead with the "
                             f"{n_nodes}-node axis")
        return x[lo:hi].clone()
    return _unflatten(tree, [take(x) for x in _leaves(tree)])


def gather_nodes(tree: PyTree, fleet: Fleet, n_nodes: int,
                 dst: Optional[int] = 0) -> Optional[PyTree]:
    """The whole node axis of every block-leading leaf: on fleet index
    ``dst``, on the host (None if this rank is another), or on every
    rank's device for ``dst=None`` (``core.gossip.all_gather_nodes``).
    Gathered to ``dst`` leaf by leaf, each leaf's device buffer freed once
    it is on the host, so the card holds at most one leaf's whole axis
    beside the rank's state (a checkpoint of a model's full node axis
    would not fit one card). A collective: every rank of the fleet calls
    it."""
    if not fleet.sharded(n_nodes):
        return tree if dst is None or fleet.index == dst else None
    mine = dst is None or fleet.index == dst
    out = [_gather_leaf_nodes(x, fleet, n_nodes, dst) for x in _leaves(tree)]
    return _unflatten(tree, out) if mine else None


def _gather_leaf_nodes(x: torch.Tensor, fleet: Fleet, n_nodes: int,
                       dst: Optional[int]) -> Optional[torch.Tensor]:
    """One leaf of ``gather_nodes`` (the node axis sharded)."""
    mine = dst is None or fleet.index == dst
    if x.dim() == 0:
        return x if dst is None else (x.cpu() if mine else None)
    if dst is None:
        return all_gather_nodes(x, n_nodes, fleet.group)
    full = x.new_empty((n_nodes, *x.shape[1:])) if mine else None
    parts = list(full.chunk(fleet.size)) if mine else None
    dist.gather(x.contiguous(), parts, dst=fleet.global_rank(dst),
                group=fleet.group)
    return full.cpu() if mine else None


def scatter_nodes(full: Optional[PyTree], like: PyTree, fleet: Fleet,
                  n_nodes: int, src: int = 0) -> PyTree:
    """Inverse of ``gather_nodes``: ``full`` (the whole node axis, on fleet
    index ``src``; ignored elsewhere) scattered into blocks shaped and
    placed as ``like``'s leaves; 0-d and replicated leaves are broadcast.
    A collective: every rank of the fleet calls it."""
    if fleet.size == 1:
        return _unflatten(like, [x.to(ref.device) for x, ref in
                                 zip(_leaves(full), _leaves(like))])
    mine = fleet.index == src
    src_leaves = _leaves(full) if mine else [None] * len(_leaves(like))
    return _unflatten(like, [
        _scatter_leaf_nodes(x, torch.empty_like(ref), fleet, n_nodes, src)
        for x, ref in zip(src_leaves, _leaves(like))])


def _scatter_leaf_nodes(x: Optional[torch.Tensor], got: torch.Tensor,
                        fleet: Fleet, n_nodes: int,
                        src: int) -> torch.Tensor:
    """One leaf of ``scatter_nodes``: ``x`` (the whole leaf, on fleet index
    ``src``) into ``got``, this rank's block."""
    mine = fleet.index == src
    if fleet.size == 1:
        return got.copy_(x)
    if got.dim() == 0 or not fleet.sharded(n_nodes):
        if mine:
            got.copy_(x)
        dist.broadcast(got, src=fleet.global_rank(src), group=fleet.group)
    else:
        parts = None
        if mine:
            x = x.to(got.device)
            parts = [c.contiguous() for c in x.chunk(fleet.size)]
        dist.scatter(got, parts, src=fleet.global_rank(src),
                     group=fleet.group)
        del parts
    return got


# ---------------------------------------------------------------------------
# The model axis (tensor parallelism) and both axes together
# ---------------------------------------------------------------------------

def model_dim(spec: P, ndim: int) -> Optional[int]:
    """The dim of an ``ndim``-d leaf that ``spec`` (aligned to its trailing
    dims) shards over ``'model'``, or None."""
    for i, entry in enumerate(reversed(tuple(spec))):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names:
            return ndim - 1 - i
    return None


def shard_model(tree: PyTree, specs: PyTree, model) -> PyTree:
    """This rank's slice of every leaf by its spec (``param_specs``; its
    entries aligned to the leaf's trailing dims), each a tensor of its
    own; a replicated leaf is kept whole (the same tensor)."""
    if not model.active:
        return tree
    out = []
    for x, spec in zip(_leaves(tree), spec_leaves(specs)):
        d = model_dim(spec, x.dim())
        out.append(x if d is None else
                   x.chunk(model.size, dim=d)[model.index].clone())
    return _unflatten(tree, out)


def _gather_leaf_model(x: torch.Tensor, d: Optional[int], model,
                       dst: Optional[int]) -> Optional[torch.Tensor]:
    """One leaf whole over ``model``: on index ``dst``'s device (None
    elsewhere), or on every rank's for ``dst=None``."""
    if d is None or not model.active:
        return x if dst is None or model.index == dst else None
    mine = dst is None or model.index == dst
    parts = [torch.empty_like(x) for _ in range(model.size)] if mine \
        else None
    if dst is None:
        dist.all_gather(parts, x.contiguous(), group=model.group)
    else:
        dist.gather(x.contiguous(), parts,
                    dst=dist.get_global_rank(model.group, dst),
                    group=model.group)
    return torch.cat(parts, dim=d) if mine else None


def gather_model(tree: PyTree, specs: PyTree, model,
                 dst: Optional[int] = 0) -> Optional[PyTree]:
    """The inverse of ``shard_model``: every leaf whole on model index
    ``dst``'s host (None elsewhere), leaf by leaf, or on every rank's
    device for ``dst=None``. A collective over the model group."""
    if not model.active:
        return tree
    mine = dst is None or model.index == dst
    out = []
    for x, spec in zip(_leaves(tree), spec_leaves(specs)):
        y = _gather_leaf_model(x, model_dim(spec, x.dim()), model, dst)
        out.append(None if y is None else (y if dst is None else y.cpu()))
        del y
    return _unflatten(tree, out) if mine else None


def gather_state(tree: PyTree, specs: PyTree, fleet: Fleet, model,
                 n_nodes: int) -> Optional[PyTree]:
    """Every leaf whole over both axes on the host of the rank at fleet
    index 0 and model index 0 (None elsewhere): over ``model`` to the
    model axis's first rank, then over the fleet among those (the node
    axis as ``gather_nodes``), one leaf at a time. ``specs`` one spec a
    leaf (its entries aligned to the leaf's trailing dims). A node axis
    the fleet does not shard is whole on fleet index 0's model axis: the
    other fleet indices gather nothing."""
    mine = model.index == 0 and fleet.index == 0
    if not fleet.sharded(n_nodes) and fleet.index != 0:
        return None
    out = []
    for x, spec in zip(_leaves(tree), spec_leaves(specs)):
        y = _gather_leaf_model(x, model_dim(spec, x.dim()), model, 0)
        if y is not None:
            y = (_gather_leaf_nodes(y, fleet, n_nodes, 0)
                 if fleet.sharded(n_nodes) else y.cpu())
        out.append(y)
        del y
    return _unflatten(tree, out) if mine else None


def scatter_state(full: Optional[PyTree], like: PyTree, specs: PyTree,
                  fleet: Fleet, model, n_nodes: int) -> PyTree:
    """The inverse of ``gather_state``: ``full`` (on the host of fleet
    index 0, model index 0; ignored elsewhere) into tensors shaped and
    placed as ``like``'s leaves, leaf by leaf: over the fleet among the
    model axes' first ranks, then over each model axis."""
    refs = _leaves(like)
    src = _leaves(full) if model.index == 0 and fleet.index == 0 \
        else [None] * len(refs)
    out = []
    for x, ref, spec in zip(src, refs, spec_leaves(specs)):
        d = model_dim(spec, ref.dim())
        whole = list(ref.shape)
        if d is not None and model.active:
            whole[d] *= model.size
        y = None
        if model.index == 0:
            y = _scatter_leaf_nodes(
                x, ref.new_empty(whole), fleet, n_nodes, 0)
        if not model.active:
            out.append(y)
            continue
        got = torch.empty_like(ref)
        root = dist.get_global_rank(model.group, 0)
        if d is None:
            if model.index == 0:
                got.copy_(y)
            dist.broadcast(got, src=root, group=model.group)
        else:
            parts = None if y is None else [
                c.contiguous() for c in y.chunk(model.size, dim=d)]
            dist.scatter(got, parts, src=root, group=model.group)
            del parts
        out.append(got)
        del y
    return _unflatten(like, out)


# ---------------------------------------------------------------------------
# Serving caches over the model axis
# ---------------------------------------------------------------------------

def cache_layout(cfg, model) -> dict:
    """The port's serving cache layout on ``model``: {leaf name: (dim
    counted from the end, lo, hi)} of the rank's block of each leaf whole,
    or None for a leaf every rank holds whole. Where it differs from the
    JAX ``cache_specs``:

    * K/V hold the kv heads the rank's q heads read
      (``attention.head_layout``): with fewer kv heads than ranks a kv head
      is held whole by every rank that reads it (qwen2-vl-2b's 2 at tp 4:
      ranks 0 and 1 hold head 0), and under a q head split (heads that do
      not divide) every rank holds them all, where ``cache_specs`` splits
      the head_dim;
    * MLA's latent cache (``c_kv``, ``k_rope``) is whole on every rank
      (each rank makes it from the replicated ``wkv_a``), where
      ``cache_specs`` splits its trailing dim;
    * RWKV-6's token shifts (``shift_tm``, ``shift_cm``) are whole
      (residual-stream vectors), where ``cache_specs`` splits d_model.

    The RG-LRU's ``conv`` and ``h`` take the rank's channels and RWKV-6's
    ``wkv`` its heads, as both reckon them; position tags are whole."""
    from ..models import attention, rwkv6

    out: dict = {n: None for n in ("pos", "c_kv", "k_rope", "shift_tm",
                                   "shift_cm", "k", "v", "conv", "h",
                                   "wkv")}
    heads = attention.head_layout(cfg, model)
    if heads.hkv != cfg.n_kv_heads:
        out["k"] = out["v"] = (2, heads.k0, heads.k0 + heads.hkv)
    if cfg.rglru is not None and model.splits(cfg.rglru.d_rnn):
        lo, hi = model.block(cfg.rglru.d_rnn)
        out["conv"], out["h"] = (1, lo, hi), (1, lo, hi)
    if cfg.rwkv is not None and "rwkv" in cfg.pattern:
        axis = rwkv6.axis_of(cfg, cfg.rwkv, model)
        if axis.active:
            lo, hi = axis.block(cfg.d_model // cfg.rwkv.head_size)
            out["wkv"] = (3, lo, hi)
    return out


def _cache_leaf_name(path: tuple) -> str:
    return [n for n in path if isinstance(n, str)][-1]


def shard_caches(tree: PyTree, cfg, model) -> PyTree:
    """This rank's shard of every leaf of a whole serving cache
    (``cache_layout``), each a tensor of its own; a whole leaf is kept."""
    layout = cache_layout(cfg, model)

    def take(path, x):
        block = layout[_cache_leaf_name(path)]
        if block is None:
            return x
        dim, lo, hi = block
        return x.narrow(x.dim() - dim, lo, hi - lo).clone()
    return _map_with_path(take, tree)


def gather_caches(tree: PyTree, cfg, model) -> PyTree:
    """The inverse of ``shard_caches``: every leaf whole on every rank
    (each rank's block placed by its ``cache_layout``; blocks that several
    ranks hold are theirs alike). A collective over the model group."""
    if not model.active:
        return tree
    layouts = [cache_layout(cfg, _tp.Model(model.group, model.size, r))
               for r in range(model.size)]

    def whole(path, x):
        name = _cache_leaf_name(path)
        if layouts[model.index][name] is None:
            return x
        parts = [torch.empty_like(x) for _ in range(model.size)]
        dist.all_gather(parts, x.contiguous(), group=model.group)
        dim = layouts[0][name][0]
        n = max(lay[name][2] for lay in layouts)
        out = x.new_empty((*x.shape[:x.dim() - dim], n,
                           *x.shape[x.dim() - dim + 1:]))
        for lay, part in zip(layouts, parts):
            _, lo, hi = lay[name]
            out.narrow(x.dim() - dim, lo, hi - lo).copy_(part)
        return out
    return _map_with_path(whole, tree)
