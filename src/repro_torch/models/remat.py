"""Activation checkpointing (remat) under ``torch.func``.

The torch counterpart of the JAX package's ``jax.checkpoint`` around a
pattern unit (``repro.models.transformer._run_stack``'s ``unit_body``) and
around each encoder-decoder layer (``repro.models.encdec._scan_stack``):

* ``"none"``: the unit runs as it is; autograd keeps every activation.
* ``"full"`` (``jax.checkpoint``): the forward keeps only the unit's tensor
  inputs (its input activation and its parameter slices); the backward
  runs the unit again under ``torch.func.vjp`` and differentiates that.
* ``"dots"`` (``jax.checkpoint_policies.checkpoint_dots``, which keeps the
  output of every ``dot_general``): the forward also keeps the output of
  every product with a weight matrix (:func:`product`: q / k / v / o, the
  MLPs, MLA's projections, the MoE router and experts, RG-LRU's and
  RWKV-6's projections) and of every kernel call (flash attention's out
  and lse, the two scans' outputs). The recompute takes those from the
  forward and recomputes the rest: norms, rotary, activations, gates and
  residual adds.

PyTorch's own activation checkpoint does not run under
``torch.func.grad`` (its saved-tensor hooks and its reentrant form are
both refused there), so the checkpoint is an ``autograd.Function`` of its
own, :class:`_Checkpoint`,
with ``setup_context`` and a generated ``vmap`` rule: it runs under
``grad``, ``grad_and_value``, ``vjp`` and Mode B's ``vmap`` over the node
axis. Its non-tensor arguments (the unit's function with its config,
kinds and flags) are closed over, not saved. Its backward is one more
Function, :class:`_Recompute`, which autograd records in place of the
recompute; a second derivative through a checkpointed unit reaches it
and raises, where ``jax.checkpoint`` has one.

How "dots" keeps an output: the forward runs the unit with a tape on
which every product and kernel call appends its output; the tape is
returned beside the unit's output (non-differentiable), so the generated
``vmap`` rule and ``save_for_backward`` carry it like any saved tensor.
In the recompute each call takes its output from the tape in the same
order, through a small Function whose backward forms the call's
gradients from its recomputed inputs: :class:`_KeptProduct` (dx = dy w^T,
dw = x^T dy, the formulas and operand layouts of autograd's own matmul
backward) and :class:`_Kept` (the kernel's own Function's
``setup_context`` and ``backward``: flash's backward kernel from the kept
out and lse, each scan's backward kernel). The running tape is
``kernels._backend.tape``, which the kernel wrappers' one dispatch
(``_backend.call``) reads.

Why the values equal the reference's: the unit is a deterministic
function of its inputs (the MoE routing included: a stable sort and a
combine in a fixed order), so the recompute, or a kept output, is bit for
bit what the forward computed, and the gradients are those of the same
operations. The JAX package reaches the same gradients up to XLA's
rounding (remat there may change what it fuses); the port's "full" is
bit-equal to "none", its "dots" equal to rounding in the products'
gradient formulas (tests/test_torch_remat.py says where).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch

from ..kernels import _backend

__all__ = ["POLICIES", "checkpoint", "product"]

POLICIES = ("none", "full", "dots")


class _Tape:
    """The outputs a "dots" checkpoint keeps, in call order: appended while
    the forward records, taken back in the same order by the recompute."""

    def __init__(self, kept=None):
        self.recording = kept is None
        self.kept = [] if kept is None else list(kept)
        self.at = 0

    def take(self, n: int) -> list:
        out = self.kept[self.at:self.at + n]
        if len(out) != n:
            raise RuntimeError("remat: the recompute asked for more kept "
                               "outputs than the forward kept")
        self.at += n
        return out

    def kernel(self, cls, n_out: int, *args):
        """The kernel Function ``cls`` on ``args`` (``n_out`` tensor
        outputs): recorded, or its kept outputs in the recompute."""
        if self.recording:
            out = cls.apply(*args)
            self.kept.extend((out,) if n_out == 1 else out)
            return out
        kept = self.take(n_out)
        return _Kept.apply(cls, len(args), *args, *kept)


@contextlib.contextmanager
def _running(tape):
    """Products and kernel calls go through ``tape`` (None: straight
    through) until the block ends (``kernels._backend.tape``)."""
    outer, _backend.tape = _backend.tape, tape
    try:
        yield
    finally:
        _backend.tape = outer


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) folded to (N, d) against w (d, f) in one ``mm``, or
    (E, N, d) against (E, d, f) in one ``bmm``: one decomposition whether
    or not autograd records (``torch.matmul`` folds x only when w
    requires grad or x's leading dims are contiguous, else it runs a
    ``bmm``, whose sums may round differently)."""
    if w.dim() == 2:
        d, f = w.shape
        return x.reshape(-1, d).mm(w).reshape(*x.shape[:-1], f)
    return torch.bmm(x, w)


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, x (..., d) against a weight matrix w (d, f), or a batch
    of them (E, N, d) @ (E, d, f) (the MoE experts): a product a "dots"
    checkpoint keeps. Outside one, the product as it is."""
    tape = _backend.tape
    if tape is None:
        return _matmul(x, w)
    if tape.recording:
        y = _matmul(x, w)
        tape.kept.append(y)
        return y
    return _KeptProduct.apply(x, w, tape.take(1)[0])


def _product_grads(x, w, dy, need_x: bool, need_w: bool):
    """The gradients of :func:`_matmul` as autograd's ``mm`` and ``bmm``
    backward forms them (row-major operands)."""
    dx = dw = None
    if w.dim() == 2:
        d, f = w.shape
        if need_x:
            dx = dy.reshape(-1, f).mm(w.t()).reshape(x.shape)
        if need_w:
            dw = x.reshape(-1, d).t().mm(dy.reshape(-1, f))
    else:
        if need_x:
            dx = dy.bmm(w.transpose(1, 2))
        if need_w:
            dw = x.transpose(1, 2).bmm(dy)
    return dx, dw


class _KeptProduct(torch.autograd.Function):
    """``x @ w`` in a "dots" recompute: the forward's kept output ``y``,
    with the product's gradients from the recomputed x and w."""

    @staticmethod
    def forward(x, w, y):
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _product_grads(x, w, dy, *ctx.needs_input_grad[:2])
        return dx, dw, None

    @staticmethod
    def vmap(info, in_dims, x, w, y):
        return y, in_dims[2]


class _Kept(torch.autograd.Function):
    """A kernel Function ``cls`` in a "dots" recompute: its kept outputs,
    with ``cls``'s own ``setup_context`` and ``backward`` (its backward
    kernel) on the recomputed inputs and the kept outputs."""

    @staticmethod
    def forward(cls, n, *xs):
        # views: ``cls.setup_context`` may save an output (flash's out),
        # and an input returned as it is cannot be saved
        kept = tuple(x.view_as(x) for x in xs[n:])
        return kept[0] if len(kept) == 1 else kept

    @staticmethod
    def setup_context(ctx, inputs, output):
        cls, n = inputs[0], inputs[1]
        cls.setup_context(ctx, inputs[2:2 + n], output)
        ctx.kept_cls, ctx.kept_n = cls, len(inputs) - 2 - n

    @staticmethod
    def backward(ctx, *grads):
        g = ctx.kept_cls.backward(ctx, *grads)
        g = g if isinstance(g, tuple) else (g,)
        return (None, None, *g, *(None,) * ctx.kept_n)

    @staticmethod
    def vmap(info, in_dims, cls, n, *xs):
        kept = tuple(x.view_as(x) for x in xs[n:])
        dims = in_dims[2 + n:]
        return (kept[0], dims[0]) if len(kept) == 1 else (kept, tuple(dims))


def _flatten(tree, out: list):
    """The tensors of nested dicts / lists / tuples in order, and a
    function rebuilding the tree from such a list (None and non-tensor
    leaves kept as they are)."""
    if isinstance(tree, dict):
        parts = [_flatten(v, out) for v in tree.values()]
        keys = list(tree)
        return lambda it: {k: p(it) for k, p in zip(keys, parts)}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, out) for v in tree]
        kind = type(tree)
        return lambda it: kind(p(it) for p in parts)
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return lambda it: next(it)
    return lambda it: tree


class _Checkpoint(torch.autograd.Function):
    """``fn(*rebuild(leaves))`` keeping ``leaves`` (and, under "dots", the
    tape); its backward recomputes ``fn`` under ``torch.func.vjp``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, rebuild, policy, *leaves):
        tape = _Tape() if policy == "dots" else None
        with _running(tape):
            out = fn(*rebuild(iter(leaves)))
        return (out, *tape.kept) if tape is not None else (out,)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, rebuild, policy, *leaves = inputs
        kept = output[1:]
        ctx.mark_non_differentiable(*kept)
        ctx.save_for_backward(*leaves, *kept)
        ctx.fn, ctx.rebuild, ctx.policy = fn, rebuild, policy
        ctx.n_leaves = len(leaves)

    @staticmethod
    def backward(ctx, dout, *_):
        saved = ctx.saved_tensors
        # differentiated: the floating leaves (not positions)
        diff = tuple(i for i, t in enumerate(saved[:ctx.n_leaves])
                     if t.is_floating_point())
        pulled = _Recompute.apply(ctx.fn, ctx.rebuild, ctx.policy,
                                  ctx.n_leaves, diff, dout, *saved)
        grads: list = [None] * ctx.n_leaves
        for i, g in zip(diff, pulled):
            grads[i] = g
        return (None, None, None, *grads)


class _Recompute(torch.autograd.Function):
    """The gradients of a checkpointed unit with respect to its leaves
    ``diff``: ``fn`` run again under ``torch.func.vjp`` and pulled with
    ``dout``. ``saved`` is the unit's leaves, then the kept outputs of a
    "dots" forward. A Function so that autograd records this call and not
    the recompute: ``torch.func.grad`` pulls with create_graph, and the
    recompute's history would keep every unit's activations alive until
    the whole backward ends (1.41 GiB a unit for qwen2-vl-2b at 16 x 512
    tokens on an H100). Its own backward, a second derivative through the
    unit, raises (as flash's backward does) rather than let the unit's
    gradients pass as constants."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, rebuild, policy, n_leaves, diff, dout, *saved):
        leaves, kept = saved[:n_leaves], saved[n_leaves:]
        tape = _Tape(kept) if policy == "dots" else None

        def again(*xs):
            args = list(leaves)
            for i, x in zip(diff, xs):
                args[i] = x
            with _running(tape):
                return fn(*rebuild(iter(args)))
        # The recompute runs under no_grad: only the vjp's own level
        # records it. It is pulled with create_graph, as torch.func.grad
        # pulls everything else (some backward formulas, silu's among
        # them, take another kernel without it and round otherwise), so
        # the gradients are bit-equal to remat "none"'s.
        with torch.no_grad():
            _, pull = torch.func.vjp(again, *(leaves[i] for i in diff))
        if tape is not None and tape.at != len(kept):
            raise RuntimeError("remat: the recompute took fewer kept outputs "
                               "than the forward kept")
        return tuple(pull(dout, retain_graph=False, create_graph=True))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("remat: a checkpointed unit has no double "
                           "backward")


def checkpoint(fn: Callable[..., torch.Tensor], *args: Any,
               policy: str = "full") -> torch.Tensor:
    """``fn(*args)`` -> one tensor, under the remat ``policy``: "none"
    runs it as it is, "full" and "dots" through :class:`_Checkpoint`.
    ``args`` are tensors, None or nested dicts / lists / tuples of them
    (a unit's activation, parameter slices and positions): every tensor
    ``fn`` reads comes in through them, since a tensor made inside a
    ``torch.func`` transform and closed over breaks the generated
    ``vmap`` rule. What else it needs (config, kinds, flags) it closes
    over. Only the floating tensors are differentiated, and once: a
    second derivative through the unit raises."""
    if policy == "none":
        return fn(*args)
    if policy not in POLICIES:
        raise ValueError(f"remat must be one of {POLICIES}, got {policy!r}")
    leaves: list = []
    rebuild = _flatten(args, leaves)
    return _Checkpoint.apply(fn, rebuild, policy, *leaves)[0]
