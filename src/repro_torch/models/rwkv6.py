"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

The torch counterpart of ``repro.models.rwkv6``. Time-mix (per head,
head_size D):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state S in R^{DxD})
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with the data-dependent per-channel decay
    w_t = exp(-exp(w0 + tanh(x_w A1) A2))        in (0, 1).

Token-shift mixing uses static lerp weights (mu_*), the JAX package's
documented simplification of the full Finch recipe. Prefill (and
teacher-forced ``apply``) runs the WKV recurrence in a kernel
(``kernels.ops.rwkv6``: the chunked form on the card's tensor cores, the
chunked plain version on the CPU); decode is the exact single-step recurrence
``wkv_step`` in plain torch, as in the JAX package.

Channel-mix:  k = relu(W_k x_k)^2; out = sigmoid(W_r x_r) * (W_v k).
State: {shift_tm, shift_cm: (B, d_model) in the compute dtype,
wkv: (B, H, D, D) fp32}.

Under tensor parallelism (``model``) both halves run on the rank's heads
and channels (``axis_of``). Time-mix: x and each replicated leaf read
inside the rank's work (the ``mu_*`` lerp weights and ``w_lora_a``) enter
by ``tp.copy_in``, so their gradients come out whole on every rank (one
all-reduce of x and one of each small leaf, where lerping first and
copying the five mixed inputs in would all-reduce five activations);
``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` / ``w_lora_b`` are the rank's
columns, ``w0``, ``u`` and ``ln_scale`` its channels, the scan runs on
(B, S, H / size, D), the per-head group norm stays on the rank (a head
is never split) and ``w_o``'s rows leave by ``tp.reduce_out``.
Channel-mix: ``cw_k`` and ``cw_r`` are the rank's columns, ``cw_v`` its
rows; the receptance is gathered whole (``tp.gather``) so that the
sigmoid gate multiplies the value's partial sum before one
``tp.reduce_out``: forward an all-gather of (B, S, d) and an all-reduce of
(B, S, d), backward the gather's reduce-scatter and the all-reduce of
x's and the lerp weights' gradients.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, RWKVConfig
from ..kernels import ops
from . import tp
from .layers import dense, dense_init, normal, torch_dtype
from .remat import product

__all__ = ["rwkv_init", "init_rwkv_state", "rwkv_time_mix",
           "rwkv_channel_mix", "wkv_chunked", "wkv_step", "axis_of"]


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, r: RWKVConfig,
              device: torch.device) -> dict:
    d, pd = cfg.d_model, cfg.param_dtype
    d_ff = r.d_ff or cfg.d_ff

    def uniform(lo, hi):
        x = lo + (hi - lo) * torch.rand((d,), generator=gen, device=gen.device)
        return x.to(device=device, dtype=torch_dtype(pd))

    def mu():
        return uniform(0.0, 1.0)

    return {
        # time-mix
        "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_w": mu(), "mu_g": mu(),
        "w_r": dense_init(gen, d, d, device, dtype=pd),
        "w_k": dense_init(gen, d, d, device, dtype=pd),
        "w_v": dense_init(gen, d, d, device, dtype=pd),
        "w_g": dense_init(gen, d, d, device, dtype=pd),
        "w_o": dense_init(gen, d, d, device, dtype=pd),
        "w0": uniform(0.5, 2.0),
        "w_lora_a": normal(gen, (d, r.decay_lora), device, d**-0.5, pd),
        "w_lora_b": normal(gen, (r.decay_lora, d), device,
                           r.decay_lora**-0.5, pd),
        "u": normal(gen, (d,), device, 0.1, pd),
        "ln_scale": torch.ones((d,), dtype=torch_dtype(pd), device=device),
        # channel-mix
        "cmu_r": mu(), "cmu_k": mu(),
        "cw_r": dense_init(gen, d, d, device, dtype=pd),
        "cw_k": dense_init(gen, d, d_ff, device, dtype=pd),
        "cw_v": dense_init(gen, d_ff, d, device, dtype=pd),
    }


def init_rwkv_state(cfg: ModelConfig, r: RWKVConfig, batch: int, dtype,
                    device: torch.device) -> dict:
    h = cfg.d_model // r.head_size
    return {
        "shift_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "wkv": torch.zeros((batch, h, r.head_size, r.head_size),
                           dtype=torch.float32, device=device),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Previous token per position; ``prev`` (B, d) seeds position 0 (cast
    to x's dtype)."""
    prev_col = torch.zeros_like(x[:, :1]) if prev is None \
        else prev[:, None, :].to(x.dtype)
    return torch.cat([prev_col, x[:, :-1]], dim=1)


def wkv_step(s: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, w: torch.Tensor, u: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact one-token update. s (B,H,D,D); r,k,v,w (B,H,D); u (H,D).
    Returns (new_state, y (B,H,D))."""
    kv = k[..., :, None] * v[..., None, :]                    # (B,H,D,D)
    y = torch.einsum("bhd,bhde->bhe", r, s + u[None, :, :, None] * kv)
    return w[..., :, None] * s + kv, y


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                s0: Optional[torch.Tensor] = None, chunk: int = 32
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """WKV over a sequence. r,k,v,w: (B,S,H,D) fp32; u: (H,D); s0
    (B,H,D,D) fp32 or None. Returns (y, s_final): the rwkv6 scan kernel on
    the card, its plain version (the JAX model's chunked algorithm, chunk
    ``chunk``) on the CPU."""
    return ops.rwkv6(r, k, v, w, u, chunk, s0=s0)


def axis_of(cfg: ModelConfig, r: RWKVConfig, model: tp.Model,
            state: Optional[dict] = None,
            return_state: bool = False) -> tp.Model:
    """The axis a layer runs over: ``model`` when d_model and d_ff divide
    over it (the specs split every matrix), ``tp.ONE`` when neither does
    (every leaf replicated, the layer whole on each rank). A head split
    over ranks, a split of one width only, and a state under an active
    axis wait for ROADMAP Queue 1 item 9."""
    d, d_ff = cfg.d_model, r.d_ff or cfg.d_ff
    if not (model.splits(d) or model.splits(d_ff)):
        return tp.ONE
    heads = d // r.head_size
    if not (model.splits(d) and model.splits(d_ff)) or heads % model.size:
        raise NotImplementedError(
            f"RWKV-6 with {heads} heads (d {d}, d_ff {d_ff}) over a 'model' "
            f"axis of {model.size}: a split of heads or of one width only "
            f"waits for {tp.SERVE_ITEM}")
    if state is not None or return_state:
        raise NotImplementedError(
            "tensor parallelism runs RWKV-6's train path; its state waits "
            f"for {tp.SERVE_ITEM}")
    return model


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  r: RWKVConfig, *, state: Optional[dict] = None,
                  return_state: bool = False, chunk: int = 32,
                  model: tp.Model = tp.ONE
                  ) -> tuple[torch.Tensor, Optional[dict]]:
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32
    model = axis_of(cfg, r, model, state, return_state)
    b, s, d = x.shape
    d //= model.size            # the rank's channels
    h = d // r.head_size
    x = tp.copy_in(x, model)
    prev = state["shift_tm"] if state is not None else None
    xs = _token_shift(x, prev)

    def mixed(mu):
        return x + (xs - x) * tp.copy_in(mu, model).to(dt)[None, None, :]

    rr = dense(p["w_r"], mixed(p["mu_r"]), dt)
    kk = dense(p["w_k"], mixed(p["mu_k"]), dt)
    vv = dense(p["w_v"], mixed(p["mu_v"]), dt)
    gg = dense(p["w_g"], mixed(p["mu_g"]), dt)
    # the decay LoRA, w0, u and ln_scale are read in fp32 (serving keeps
    # those leaves fp32: launch.serve._FP32_LEAVES)
    xw = mixed(p["mu_w"]).to(f32)
    dec_in = product(torch.tanh(product(
        xw, tp.copy_in(p["w_lora_a"], model).to(f32))),
        p["w_lora_b"].to(f32))
    w = torch.exp(-torch.exp(p["w0"].to(f32)[None, None] + dec_in))

    shp = (b, s, h, r.head_size)
    r4 = rr.to(f32).reshape(shp)
    k4 = kk.to(f32).reshape(shp)
    v4 = vv.to(f32).reshape(shp)
    w4 = w.reshape(shp)
    u2 = p["u"].to(f32).reshape(h, r.head_size)

    s0 = state["wkv"] if state is not None else None
    if s == 1 and state is not None:
        s_new, y4 = wkv_step(s0, r4[:, 0], k4[:, 0], v4[:, 0], w4[:, 0], u2)
        y = y4[:, None]
    else:
        y, s_new = wkv_chunked(r4, k4, v4, w4, u2, s0, chunk=chunk)

    # group-norm over each head (population variance, as jnp.var), then gate
    y32 = y.to(f32)
    mu_ = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    y32 = (y32 - mu_) * torch.rsqrt(var + 1e-5)
    y32 = y32.reshape(b, s, d) * p["ln_scale"].to(f32)[None, None]
    out = dense(p["w_o"], y32.to(dt) * F.silu(gg), dt)

    new_state = None
    if return_state:
        new_state = {"shift_tm": x[:, -1].to(dt), "wkv": s_new}
    return tp.reduce_out(out, model), new_state


def rwkv_channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     r: RWKVConfig, *, state: Optional[dict] = None,
                     return_state: bool = False, model: tp.Model = tp.ONE
                     ) -> tuple[torch.Tensor, Optional[dict]]:
    dt = torch_dtype(cfg.dtype)
    model = axis_of(cfg, r, model, state, return_state)
    x = tp.copy_in(x, model)
    prev = state["shift_cm"] if state is not None else None
    xs = _token_shift(x, prev)

    def mixed(mu):
        return x + (xs - x) * tp.copy_in(mu, model).to(dt)[None, None, :]

    kk = torch.square(F.relu(dense(p["cw_k"], mixed(p["cmu_k"]), dt)))
    rr = tp.gather(dense(p["cw_r"], mixed(p["cmu_r"]), dt), model)
    out = torch.sigmoid(rr) * dense(p["cw_v"], kk, dt)
    new_state = {"shift_cm": x[:, -1].to(dt)} if return_state else None
    return tp.reduce_out(out, model), new_state
