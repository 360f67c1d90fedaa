"""Shared model primitives: inits, norms, MLPs, RoPE, embeddings.

The torch counterpart of ``repro.models.layers``, in its layout:

* params are nested dicts of tensors; dense weights are (d_in, d_out);
* weights are stored in ``param_dtype`` and cast to the compute dtype at
  use (a no-op when the caller has cast them once already, as
  ``launch.serve.generate`` does);
* inits draw from a ``torch.Generator`` on the generator's device.
  ``jax.random`` streams are not reproduced: parity tests carry the JAX
  package's parameters across with ``convert.params_from_numpy``.
"""
from __future__ import annotations

import struct
from typing import Optional

import torch
import torch.nn.functional as F

from . import tp
from .remat import product

__all__ = ["torch_dtype", "normal", "dense_init", "dense", "norm_init",
           "norm", "mlp_init", "mlp", "mlp_local", "embed_init", "embed_rows",
           "rope", "cross_entropy", "vocab_cross_entropy"]


def rounded_to(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` as ``torch.tensor(value, dtype=
    dtype).item()`` rounds it (to float32, then to nearest even), reckoned
    on the host: no tensor is made, so it holds under a dry run's
    ``FakeTensorMode`` too, where a tensor has no value to read back."""
    f32 = struct.unpack("<f", struct.pack("<f", value))[0]
    if dtype == torch.float64:
        return float(value)
    if dtype == torch.float32:
        return f32
    if dtype == torch.float16:
        return struct.unpack("<e", struct.pack("<e", f32))[0]
    if dtype == torch.bfloat16:
        bits = struct.unpack("<I", struct.pack("<f", f32))[0]
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return struct.unpack("<f", struct.pack("<I", bits))[0]
    raise ValueError(f"no host rounding to {dtype}")


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (the configs' names) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def normal(gen: torch.Generator, shape, device: torch.device,
           scale: float = 1.0, dtype: str = "float32") -> torch.Tensor:
    """N(0, scale^2) drawn in fp32 on the generator's device, moved to
    ``device`` and cast to ``dtype`` (the JAX inits' order)."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device) * scale
    return x.to(device=device, dtype=torch_dtype(dtype))


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               device: torch.device, *, bias: bool = False,
               dtype: str = "float32", scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else d_in**-0.5
    p = {"w": normal(gen, (d_in, d_out), device, scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch_dtype(dtype), device=device)
    return p


def dense(p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    dt = torch_dtype(compute_dtype)
    y = product(x, p["w"].to(dt))
    if "b" in p:
        y = y + p["b"].to(dt)
    return y


def norm_init(dim: int, kind: str, device: torch.device,
              dtype: str = "float32") -> dict:
    p = {"scale": torch.ones((dim,), dtype=torch_dtype(dtype), device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch_dtype(dtype),
                                device=device)
    return p


def norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """RMSNorm / LayerNorm with fp32 statistics, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    if kind == "rmsnorm":
        y = x32 * torch.rsqrt(torch.mean(x32**2, dim=-1, keepdim=True) + 1e-6)
    elif kind == "layernorm":
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + 1e-5)
    else:
        raise ValueError(kind)
    y = y * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs: swiglu | geglu | gelu | relu2 (nemotron squared-ReLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             device: torch.device, dtype: str = "float32") -> dict:
    p = {"w_up": dense_init(gen, d_model, d_ff, device, dtype=dtype),
         "w_down": dense_init(gen, d_ff, d_model, device, dtype=dtype)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d_model, d_ff, device, dtype=dtype)
    return p


def mlp(p: dict, x: torch.Tensor, kind: str, compute_dtype,
        model: tp.Model = tp.ONE, d_ff: int = 0) -> torch.Tensor:
    """The MLP; under tensor parallelism (``model`` active and ``d_ff``,
    the full width, dividing over it) ``w_up`` / ``w_gate`` are the rank's
    columns and ``w_down`` its rows: x enters by ``tp.copy_in`` and the
    partial sums leave by ``tp.reduce_out``. A width that does not divide
    is replicated and runs whole on every rank."""
    if not model.splits(d_ff):
        return mlp_local(p, x, kind, compute_dtype)
    return tp.reduce_out(mlp_local(p, tp.copy_in(x, model), kind,
                                   compute_dtype), model)


def mlp_local(p: dict, x: torch.Tensor, kind: str,
              compute_dtype) -> torch.Tensor:
    """The MLP on the weights as they are, no region: on the rank's
    columns / rows, its partial sum (the MoE layer adds the shared
    experts' to its experts' before one ``tp.reduce_out``)."""
    # jax.nn.gelu defaults to the tanh approximation; F.gelu to the exact
    # erf form, so the approximation is named here.
    up = dense(p["w_up"], x, compute_dtype)
    if kind == "swiglu":
        h = F.silu(dense(p["w_gate"], x, compute_dtype)) * up
    elif kind == "geglu":
        h = F.gelu(dense(p["w_gate"], x, compute_dtype),
                   approximate="tanh") * up
    elif kind == "gelu":
        h = F.gelu(up, approximate="tanh")
    elif kind == "relu2":
        h = torch.square(F.relu(up))
    else:
        raise ValueError(kind)
    return dense(p["w_down"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Embedding / RoPE / loss
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               device: torch.device, dtype: str = "float32") -> dict:
    return {"embedding": normal(gen, (vocab, d_model), device,
                                d_model**-0.5, dtype)}


def embed_rows(table: torch.Tensor, tokens: torch.Tensor,
               model: tp.Model = tp.ONE, vocab: int = 0) -> torch.Tensor:
    """``table[tokens]``; under tensor parallelism with the vocab (``vocab``
    rows in all) split over ``model``, ``table`` is the rank's rows: a
    token outside them gives a zero row and the rows are summed over the
    ranks (``tp.reduce_out``: one nonzero term, exact)."""
    if not model.splits(vocab):
        return table[tokens]
    lo, hi = model.block(vocab)
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = table[local.clamp(0, hi - lo - 1)]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return tp.reduce_out(rows, model)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the trailing head_dim; ``positions`` broadcasts
    against x's leading dims (..., S, H, D). ``fraction`` < 1 rotates only
    the first ``fraction * D`` channels (stablelm-style partial rotary)."""
    d = x.shape[-1]
    d_rot = int(d * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    half = d_rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    ang = ang[..., None, :]  # broadcast over heads (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = xr[..., :half].to(torch.float32)
    x2 = xr[..., half:].to(torch.float32)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), xp], dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy; logits upcast to fp32 (..., S, V)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    return _mean_nll(nll, mask)


def _mean_nll(nll: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        model: tp.Model,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cross_entropy`` of vocab-parallel logits: ``logits`` (..., S,
    V / size) are the rank's block of the vocab. The max over the vocab
    (the stable shift, not differentiated) and the sum of exponentials are
    reduced over the ranks, and the gold logit comes from the rank that
    holds it (the others add zero)."""
    logits = logits.to(torch.float32)
    width = logits.shape[-1]
    lo = model.index * width
    shift = tp.all_max(torch.amax(logits, dim=-1), model)
    total = tp.reduce_out(
        torch.sum(torch.exp(logits - shift[..., None]), dim=-1), model)
    logz = torch.log(total) + shift
    local = labels.long() - lo
    inside = (local >= 0) & (local < width)
    gold = torch.gather(logits, -1, local.clamp(0, width - 1)[..., None])
    gold = torch.where(inside, gold[..., 0],
                       torch.zeros((), dtype=logits.dtype,
                                   device=logits.device))
    return _mean_nll(logz - tp.reduce_out(gold, model), mask)
