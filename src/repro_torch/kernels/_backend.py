"""Per-call kernel dispatch for every kernel module of the port.

The counterpart of ``repro.kernels._backend._default_interpret``: a wrapper
asks :func:`use_kernel` with its input's device on every call.

* a CPU tensor takes the kernel's plain torch version;
* a CUDA tensor on a device of compute capability >= (9, 0) launches the
  hand-written kernel (built for ``sm_90a``);
* any other device raises — there is no fallback from a CUDA tensor to the
  plain version.

A tensor that holds no data (a ``FakeTensor``, :func:`data_free`: the dry
run, ``launch.dryrun``, evaluates the model in ``FakeTensorMode`` with the
card as its fake device) takes neither: the wrapper runs its kernel path
up to the launch — the same checks, and the same outputs and scratch
allocated with the kernel's shapes, dtypes and strides — and, in place of
the launch, counts it with its cost at the launch's shapes on the wrapper
(:func:`shaped`). It launches nothing, counts nothing in ``.launches``
and runs no plain version: the plain versions allocate what the kernels
do not (plain flash attention its (S x T) scores), so a dry run through
them would misstate the peak. The data-free test is a type check of the
operand, made per call like the probe.

The capability is probed per call and never cached, so a device attached or
swapped after the first call is seen by the next one (a cached probe froze
the JAX package's first answer for the life of the process). The probe is
kept cheap instead: a ``torch.device`` the caller passes is used as it is,
and the capability is asked by device index.

A kernel fills its output through ctypes, so on a card the output would
silently carry no ``grad_fn``. Flash attention and the RG-LRU and RWKV-6
scans have backward kernels: whenever autograd or a ``torch.func``
transform is in play (:func:`traced`) their wrappers go through autograd
Functions, whose ``vmap`` rules fold the mapped axis into the batch
(:func:`fold`, :func:`unfold`). The gossip mixes and the int8 codec have
none and refuse, before any launch, inputs that would need a gradient
(:func:`refuse_grad`). The plain versions on the CPU stay
differentiable.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["use_kernel", "require_operands", "refuse_grad", "traced",
           "call", "fold", "unfold", "data_free", "counted", "shaped",
           "MIN_CAPABILITY", "tape"]

MIN_CAPABILITY = (9, 0)

# The tape of the "dots" checkpoint (``models.remat``) that records or
# recomputes a unit now, else None (:func:`call` reads it).
tape = None


def data_free(*xs) -> bool:
    """True when an operand holds no data (a ``FakeTensor``, or one that a
    ``torch.func`` transform wraps): the wrapper then runs its shape rule.
    ``None`` is an absent operand."""
    for x in xs:
        while x is not None and \
                torch._C._functorch.is_functorch_wrapped_tensor(x):
            x = torch._C._functorch.get_unwrapped(x)
        if isinstance(x, FakeTensor):
            return True
    return False


def counted(wrapper, *kernels: str) -> None:
    """Give a kernel wrapper its counters: ``.launches`` its real
    launches, ``.dry_launches`` and ``.dry_flops`` the launches its shape
    rule stood for and their flops (:func:`shaped`), and ``.kernels`` the
    CUDA kernels of which one call launches exactly one (the profiler
    counts the wrapper's launches by these names; its memsets, pre-passes
    and second kernels are not counted)."""
    wrapper.launches = wrapper.dry_launches = 0
    wrapper.dry_flops = 0.0
    wrapper.kernels = kernels


def shaped(wrapper, work: tuple[float, float]) -> None:
    """A shape rule's stand-in for one launch of ``wrapper``'s kernel (a
    :func:`counted` wrapper): counted in ``.dry_launches``, its flops of
    ``work`` (bytes, flops at the launch's shapes, ``kernels.cost``)
    added to ``.dry_flops``."""
    wrapper.dry_launches += 1
    wrapper.dry_flops += work[1]


def use_kernel(device: torch.device) -> bool:
    """True: launch the CUDA kernel. False: run the plain version (CPU).
    Raises for a CUDA device below sm_90 and for any other device type."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise RuntimeError(
            f"no kernel for device type {device.type!r}; the port runs on "
            "CUDA (sm_90) or, with plain torch, on the CPU")
    cap = tuple(torch.cuda.get_device_capability(device.index))
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"CUDA device {device} has compute capability {cap}; the "
            f"kernels are built for sm_90a and need >= {MIN_CAPABILITY}")
    return True


def require_operands(device: torch.device, **tensors) -> None:
    """Raise unless every tensor lies on ``device`` and is contiguous: what
    a kernel's C entry assumes of the pointers it is given. ``None`` is an
    absent optional operand (a null pointer) and passes."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")


def refuse_grad(kernel: str, **tensors) -> None:
    """Raise before any launch when autograd is on and an input requires a
    gradient: ``kernel`` has no backward, and its output, filled through
    ctypes, would carry none. ``None`` is an absent operand and passes."""
    if not torch.is_grad_enabled():
        return
    needs = [name for name, t in tensors.items()
             if t is not None and t.requires_grad]
    if needs:
        raise RuntimeError(
            f"{kernel} has no backward kernel (the gossip mixes and the int8 "
            f"codec have none): {', '.join(needs)} requires grad. Run it "
            "under torch.no_grad() or on detached inputs (the plain version "
            "on the CPU is differentiable)")


def traced(*xs) -> bool:
    """Autograd records this call, or a ``torch.func`` transform (vmap,
    grad) wraps an input: the kernels, which fill their outputs through
    ctypes, are then reached through the autograd Functions. ``None`` is
    an absent operand."""
    xs = [x for x in xs if x is not None]
    if any(torch._C._functorch.is_functorch_wrapped_tensor(x) for x in xs):
        return True
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def call(cls, n_out: int, *args):
    """A kernel wrapper's call of its autograd Function ``cls`` (``n_out``
    tensor outputs) on ``args``: inside a "dots" checkpoint through its
    :data:`tape` (which keeps the outputs, or hands back the kept ones in
    the recompute), else ``cls.apply`` when :func:`traced`. None when
    neither: the wrapper then runs its forward directly."""
    if tape is not None:
        return tape.kernel(cls, n_out, *args)
    if traced(*(a for a in args if isinstance(a, torch.Tensor))):
        return cls.apply(*args)
    return None


def fold(x, dim, n: int):
    """A vmapped operand with its mapped axis (``dim``, or None: shared by
    every map index) folded into the leading batch axis: (n * B, ...).
    ``None`` (an absent operand) stays None."""
    if x is None:
        return None
    x = x.unsqueeze(0).expand(n, *x.shape) if dim is None \
        else x.movedim(dim, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()


def unfold(x, n: int):
    """The inverse of :func:`fold` on an output: (n * B, ...) -> (n, B,
    ...); ``None`` stays None."""
    if x is None:
        return None
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])
