"""Per-call kernel dispatch for every kernel module of the port.

The counterpart of ``repro.kernels._backend._default_interpret``: a wrapper
asks :func:`use_kernel` with its input's device on every call.

* a CPU tensor takes the kernel's plain torch version;
* a CUDA tensor on a device of compute capability >= (9, 0) launches the
  hand-written kernel (built for ``sm_90a``);
* any other device raises — there is no fallback from a CUDA tensor to the
  plain version.

The capability is probed per call and never cached, so a device attached or
swapped after the first call is seen by the next one (a cached probe froze
the JAX package's first answer for the life of the process). The probe is
kept cheap instead: a ``torch.device`` the caller passes is used as it is,
and the capability is asked by device index.

A wrapper whose kernel has no backward refuses, before any launch, inputs
that would need a gradient (:func:`refuse_grad`): a kernel fills its output
through ctypes, so on a card the output would silently carry no
``grad_fn``. The plain versions on the CPU stay differentiable.
"""
from __future__ import annotations

import torch

__all__ = ["use_kernel", "require_operands", "refuse_grad",
           "MIN_CAPABILITY"]

MIN_CAPABILITY = (9, 0)


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
            f"{kernel} has no backward kernel yet: {', '.join(needs)} "
            "requires grad. Run it under torch.no_grad() or on detached "
            "inputs (the plain version on the CPU is differentiable)")
