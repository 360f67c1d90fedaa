"""Tensor parallelism over the ``model`` mesh axis: Megatron's regions.

The JAX package runs tensor parallelism (TP) by GSPMD: the parameters carry
the ``model`` entries of ``train.shardings.param_specs`` and XLA inserts
the collectives. The port places them by hand, as Megatron does, through
four regions, each an ``autograd.Function`` with ``setup_context`` and a
``vmap`` rule (one collective over the batched tensor, its mapped dim kept),
so that they run under ``torch.func.grad_and_value``, Mode B's ``vmap`` over
the node axis and remat's recompute:

* :func:`copy_in`: identity forward, all-reduce backward (the replicated
  input of a column-parallel product, or a replicated weight read by the
  rank's part of the work: its gradient is partial on each rank);
* :func:`reduce_out`: all-reduce forward, identity backward (the partial
  sums of a row-parallel product, the vocab-parallel embedding's rows);
* :func:`gather`: all-gather forward along the last dim, reduce-scatter
  backward (a weight whose shard splits a head, gathered whole before use);
* :func:`all_max`: all-reduce max, not differentiated (the stable shift of
  the vocab-parallel softmax, the int8 message's row max).

Each backward is the opposite region, itself a Function, so a backward
pulled with ``create_graph`` (remat's recompute) records collectives too.
A region's collectives run in program order; every rank of the group runs
the same program, so they pair up.

:class:`Model` is a rank's place on the ``model`` axis (group, size,
index). A group of one makes every region an identity and the model code
takes exactly its one-device path. :func:`use` scopes a ``Model`` the way
``with mesh:`` scopes a JAX mesh: the model functions take an explicit
``model`` or, without one, the innermost :func:`use`'s (the
train-on-trace loop runs an adapter's loss under it).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["Model", "ONE", "model_of_group", "model_of", "use", "current",
           "resolve", "copy_in", "reduce_out", "gather", "all_max",
           "SERVE_ITEM", "COLLECTIVES"]

# what tensor parallelism still waits for (serving caches over the axis, a
# q head split over ranks, the dry run's pod meshes), named by every
# refusal
SERVE_ITEM = "ROADMAP Queue 1 item 9"


@dataclasses.dataclass(frozen=True)
class Model:
    """A rank's place on the ``model`` axis: ``group`` the axis's process
    group (None: an axis of one), ``size`` its ranks, ``index`` this
    rank's place."""
    group: Any = None
    size: int = 1
    index: int = 0

    @property
    def active(self) -> bool:
        return self.size > 1

    def splits(self, dim: int) -> bool:
        """Whether a dim of ``dim`` is sharded over the axis: the spec
        rules' divisibility test (``train.shardings``)."""
        return self.size > 1 and dim % self.size == 0

    def block(self, dim: int) -> tuple[int, int]:
        """[lo, hi) of this rank's shard of a dim of ``dim``."""
        if not self.splits(dim):
            return 0, dim
        b = dim // self.size
        return self.index * b, (self.index + 1) * b


ONE = Model()


def model_of_group(group) -> Model:
    """The ``Model`` of this rank on a process group (None: one rank)."""
    if group is None:
        return ONE
    return Model(group, dist.get_world_size(group), dist.get_rank(group))


def model_of(mesh) -> Model:
    """The ``Model`` of this rank on ``mesh``'s ``model`` dim (a mesh
    without one, or None, is an axis of one)."""
    if mesh is None or "model" not in tuple(mesh.mesh_dim_names):
        return ONE
    return model_of_group(mesh.get_group("model"))


_CURRENT = [ONE]


@contextlib.contextmanager
def use(model: Model):
    """Run the block with ``model`` as the current axis."""
    _CURRENT.append(model or ONE)
    try:
        yield
    finally:
        _CURRENT.pop()


def current() -> Model:
    return _CURRENT[-1]


def resolve(model) -> Model:
    """An explicit ``model``, else the current one."""
    return current() if model is None else model


# the regions' collectives: [calls, bytes of their results] (an
# all-reduce's tensor, an all-gather's whole output), read a step at a
# time by chip_smoke.py's phase 26
COLLECTIVES = {"all_reduce": [0, 0], "all_gather": [0, 0]}


def _count(kind: str, x: torch.Tensor) -> None:
    COLLECTIVES[kind][0] += 1
    COLLECTIVES[kind][1] += x.numel() * x.element_size()


def _reduced(x: torch.Tensor, model: Model, op) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=model.group)
    _count("all_reduce", y)
    return y


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(x, model):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.model = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceOut.apply(g, ctx.model), None

    @staticmethod
    def vmap(info, in_dims, x, model):
        return _CopyIn.apply(x, model), in_dims[0]


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(x, model):
        return _reduced(x, model, dist.ReduceOp.SUM)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.model = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _CopyIn.apply(g, ctx.model), None

    @staticmethod
    def vmap(info, in_dims, x, model):
        return _ReduceOut.apply(x, model), in_dims[0]


def _gathered(x: torch.Tensor, model: Model) -> torch.Tensor:
    """The shards' concatenation along the last dim: one all-gather into
    one buffer, the shards end to end along dim 0 (the form gloo takes),
    then moved to the last dim."""
    x = x.contiguous()
    flat = torch.empty((model.size * x.shape[0], *x.shape[1:]),
                       dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(flat, x, group=model.group)
    out = flat.view(model.size, *x.shape).movedim(0, -2).reshape(
        *x.shape[:-1], model.size * x.shape[-1])
    _count("all_gather", out)
    return out


def _scattered(x: torch.Tensor, model: Model) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's shard of the last dim
    (an all-reduce and a slice: gloo has no reduce-scatter)."""
    total = _reduced(x, model, dist.ReduceOp.SUM)
    lo, hi = model.block(x.shape[-1])
    return total[..., lo:hi].contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, model):
        return _gathered(x, model)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.model = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.model), None

    @staticmethod
    def vmap(info, in_dims, x, model):
        x = x if in_dims[0] is None else x.movedim(in_dims[0], 0)
        return _Gather.apply(x, model), None if in_dims[0] is None else 0


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(x, model):
        return _scattered(x, model)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.model = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.model), None

    @staticmethod
    def vmap(info, in_dims, x, model):
        x = x if in_dims[0] is None else x.movedim(in_dims[0], 0)
        return _ReduceScatter.apply(x, model), \
            None if in_dims[0] is None else 0


class _AllMax(torch.autograd.Function):
    @staticmethod
    def forward(x, model):
        return _reduced(x, model, dist.ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, model):
        return _AllMax.apply(x, model), in_dims[0]


def copy_in(x: torch.Tensor, model: Model) -> torch.Tensor:
    """Identity forward, all-reduce (sum) of the gradient backward."""
    return _CopyIn.apply(x, model) if model.active else x


def reduce_out(x: torch.Tensor, model: Model) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward."""
    return _ReduceOut.apply(x, model) if model.active else x


def gather(x: torch.Tensor, model: Model) -> torch.Tensor:
    """The rank's shard of the last dim gathered whole forward; the
    gradient summed over the ranks and sliced back to the shard."""
    return _Gather.apply(x, model) if model.active else x


def all_max(x: torch.Tensor, model: Model) -> torch.Tensor:
    """The elementwise max over the ranks, not differentiated (an axis of
    one: ``x`` as it is)."""
    if not model.active:
        return x
    return _AllMax.apply(x.detach(), model)
