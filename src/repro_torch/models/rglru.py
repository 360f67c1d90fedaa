"""Griffin recurrent block: temporal conv + RG-LRU gated linear recurrence.

The torch counterpart of ``repro.models.rglru``:

Block(x):
    gate  = gelu(W_gate x)                        (d_rnn)
    u     = causal_conv1d(W_x x, width)           (d_rnn)
    h     = RG-LRU(u)                             (d_rnn)
    y     = W_out (h * gate)                      (d_model)

RG-LRU (Real-Gated LRU, De et al. 2024):
    r_t = sigmoid(W_a u_t + b_a)
    i_t = sigmoid(W_i u_t + b_i)
    log a_t = -c * r_t * softplus(Lambda)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The projections, the conv, the fused gate einsum and the gate math are
plain torch; only the recurrence runs in a kernel
(``kernels.ops.rglru``), in prefill (S = prompt) and decode (S = 1) alike,
where the JAX package runs ``linear_recurrence``'s associative scan.
State: {conv: (B, width-1, d_rnn), h: (B, d_rnn) fp32}.

Under tensor parallelism (``model``, d_rnn dividing over it) the block
runs on the rank's channels: ``w_x`` / ``w_gate`` are its columns (x
enters by ``tp.copy_in``), ``conv_w``, ``b_ai`` and ``lam`` its channels,
``w_ai`` its output channels of the fused gates, whose product needs u
whole (``tp.gather``: its backward sums the ranks' partial gradients and
keeps the rank's slice), the recurrence runs on (B, S, d_rnn / size), and
``w_out``'s rows leave by ``tp.reduce_out``. Serving keeps the state on
the rank's channels: conv (B, width-1, d_rnn / size), h (B, d_rnn / size);
prefill runs the scan's chained path on the shard, decode its S = 1 path.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, RGLRUConfig
from ..kernels import ops
from . import tp
from .layers import dense, dense_init, normal, torch_dtype
from .remat import product

__all__ = ["rglru_init", "init_rglru_state", "rglru_apply",
           "linear_recurrence"]


def rglru_init(gen: torch.Generator, cfg: ModelConfig, r: RGLRUConfig,
               device: torch.device) -> dict:
    d, dr, pd = cfg.d_model, r.d_rnn, cfg.param_dtype
    lam = 1.0 + 4.0 * torch.rand((dr,), generator=gen, device=gen.device)
    return {
        "w_x": dense_init(gen, d, dr, device, dtype=pd),
        "w_gate": dense_init(gen, d, dr, device, dtype=pd),
        "conv_w": normal(gen, (r.conv_width, dr), device,
                         r.conv_width**-0.5, pd),
        "w_ai": normal(gen, (dr, dr, 2), device, dr**-0.5, pd),
        "b_ai": torch.zeros((dr, 2), dtype=torch_dtype(pd), device=device),
        "lam": lam.to(device=device, dtype=torch_dtype(pd)),
        "w_out": dense_init(gen, dr, d, device, dtype=pd),
    }


def init_rglru_state(cfg: ModelConfig, r: RGLRUConfig, batch: int, dtype,
                     device: torch.device, model: tp.Model = tp.ONE) -> dict:
    """The state on the rank's channels (d_rnn / size where it splits)."""
    lo, hi = model.block(r.d_rnn)
    return {
        "conv": torch.zeros((batch, r.conv_width - 1, hi - lo), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, hi - lo), dtype=torch.float32,
                         device=device),
    }


def linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                      h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 (time): the RG-LRU scan
    kernel on the card, its plain version on the CPU.

    a, b: (B, S, D). Returns h (B, S, D). h0: (B, D) initial state."""
    return ops.rglru(a, b, h0)


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv along time. u (B,S,D), w (width,D)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], width - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    out = torch.zeros_like(u)
    for i in range(width):
        out = out + up[:, i: i + u.shape[1]] * w[width - 1 - i][None, None, :]
    return out


def rglru_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                r: RGLRUConfig, state: Optional[dict] = None,
                return_state: bool = False, model: tp.Model = tp.ONE
                ) -> tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d_model). If ``state`` is given (decode / resume), the
    conv and recurrence continue from it; the new state is returned when
    ``return_state``. ``model``: the rank's channels (a d_rnn that does
    not divide over the axis is replicated and runs whole)."""
    dt = torch_dtype(cfg.dtype)
    b, s, _ = x.shape
    if not model.splits(r.d_rnn):
        model = tp.ONE
    x = tp.copy_in(x, model)
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(dense(p["w_gate"], x, dt), approximate="tanh")
    u_pre = dense(p["w_x"], x, dt)
    conv_state = state["conv"] if state is not None else None
    u = _causal_conv(u_pre, p["conv_w"].to(dt), conv_state)

    # fused gates in compute dtype, sigmoid in fp32 (on the rank's output
    # channels, from every channel of u)
    w_ai = p["w_ai"].to(dt)
    ai = product(tp.gather(u, model),
                 w_ai.reshape(w_ai.shape[0], -1)).reshape(
        b, s, *w_ai.shape[1:]) + p["b_ai"].to(dt)[None, None]
    rg = torch.sigmoid(ai[..., 0].to(torch.float32))
    ig = torch.sigmoid(ai[..., 1].to(torch.float32))
    log_a = -r.c * rg * F.softplus(p["lam"].to(torch.float32))[None, None, :]
    a = torch.exp(log_a)
    binp = torch.sqrt(torch.clamp(1.0 - a**2, min=1e-12)) \
        * (ig * u.to(torch.float32))

    h0 = state["h"] if state is not None else None
    h = linear_recurrence(a, binp, h0)

    y = tp.reduce_out(dense(p["w_out"], h.to(dt) * gate, dt), model)
    new_state = None
    if return_state:
        prev = (conv_state.to(dt) if conv_state is not None
                else torch.zeros((b, r.conv_width - 1, u_pre.shape[-1]),
                                 dtype=dt, device=x.device))
        tail = torch.cat([prev, u_pre.to(dt)], dim=1)[:, -(r.conv_width - 1):]
        new_state = {"conv": tail, "h": h[:, -1].to(torch.float32)}
    return y, new_state
