"""Torch models of the two redesigned scan kernels, on the CPU.

``csrc/rwkv6_scan.cu`` and ``csrc/rglru_scan.cu`` run only on the card.
Each algorithm is modelled here in plain fp32 torch, step for step as the
kernel takes it, and held against the port's plain version and against the
JAX package (the Pallas kernel in interpret mode, or ``ref.rwkv6_ref`` /
``ref.rglru_ref``):

* ``wkv_subblocked``: the chunked WKV form. Per chunk (16 steps in the
  kernel) in sub-blocks (8): r against the state decayed from the chunk's
  start, k into the state decayed to its end; a query against the keys of
  an earlier sub-block through factors referenced at the boundaries
  between them; pairs inside one sub-block pairwise, with products of w.
  Every factor is a product of w' = max(w, 1e-12) <= 1, i.e. e^{sum lw}
  of decays lw = log w' <= 0 between two points of the chunk: nothing
  overflows, and no factor is a difference of two long sums.
* ``rglru_chained``: time chunks of 32 steps, each chunk's aggregate (A, B)
  published first and its end value h once known; a chunk takes its
  carry-in by looking back over its predecessors, composing aggregates
  until it meets an end value (or h0 before the first chunk).

and the two backward kernels, ``csrc/rglru_scan_bwd.cu`` and
``csrc/rwkv6_scan_bwd.cu``, held against their plain versions summed in
float64 (the card's oracles):

* ``rglru_bwd_chained``: the same chained scan run backwards in time over
  the coefficient a shifted by one step, each carry-in composed from a
  fixed reach of aggregates onto an end value.
* ``rwkv6_bwd_walks``: the exact recurrences, three walks per (b, h): S
  forward (dr, du; S saved before every 8 steps), G backward (dk, ds0,
  and dw = sum_e G_t S_{t-1} with S_{t-1} rebuilt from its checkpoint),
  G^T backward (dv).

Tolerances as tests/test_kernels.py: rwkv6 5e-4, rglru 1e-4 (absolute;
the backward ones of max(1, max |oracle|)).
Two decay regimes for rwkv6, drawn with numpy from a seed: the served one,
log w = -exp(U(0.5, 2) + N(0, 1)) (models/rwkv6.py's w0 with the LoRA's
spread), where the 1e-12 floor of w is live; and a weak one, log w ~ -1e-3
(a memory of ~1000 steps), with k scaled by sqrt(1 - w^2) so that the
state keeps the unit scale it has at the served decays (the bar is
absolute and was set for outputs of standard deviation ~8).
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.rglru_scan import rglru_scan_plain
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain

RWKV_TOL, RGLRU_TOL = 5e-4, 1e-4


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


# ---------------------------------------------------------------------------
# RWKV-6: the chunked form in sub-blocks
# ---------------------------------------------------------------------------

def _excl_cumprod(x, dim):
    """prod_{j<t} x_j along ``dim`` (1 at t = 0), as a running product."""
    ones = torch.ones_like(x.narrow(dim, 0, 1))
    return torch.cumprod(torch.cat([ones, x.narrow(dim, 0, x.shape[dim] - 1)],
                                   dim), dim)


def _excl_revprod(x, dim):
    """prod_{j>t} x_j along ``dim`` (1 at the end)."""
    return torch.flip(_excl_cumprod(torch.flip(x, [dim]), dim), [dim])


def wkv_subblocked(r, k, v, w, u, s0=None, chunk=16, sub=8):
    """The kernel's algorithm in fp32: r, k, v, w (B, S, H, D), u (H, D),
    s0 (B, H, D, D) | None -> (y, s_final). Per chunk of ``chunk`` steps
    (the last one masked: w' = 1, r = k = v = 0), with w' = max(w, 1e-12):
      inter     y_t += (r_t prod_{j<t} w'_j) . S
      across    att_ti = (r_t prod_{a(t)<=j<t} w'_j)
                         . (k_i prod_{i<j<=e(i)} w'_j prod_{e(i)<j<a(t)} w'_j)
                for i in an earlier sub-block (a: a sub-block's first step,
                e: its last),
      diagonal  att_ti = sum_d r_td k_id prod_{i<j<t} w'_jd, i < t in one
                sub-block,
      bonus     att_tt = r_t . (u k_t),
      intra     y_t += sum_i att_ti v_i,
      state     S <- diag(prod w') S + (k_i prod_{j>i} w'_j)^T v."""
    f32 = torch.float32
    r, k, v, w = (x.to(f32) for x in (r, k, v, w))
    u = u.to(f32)
    b, s, h, d = r.shape
    nsb = chunk // sub
    state = torch.zeros((b, h, d, d), dtype=f32) if s0 is None \
        else s0.to(f32).clone()
    ys = []
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        pad = (0, 0, 0, 0, 0, chunk - n)
        rc, kc, vc = (torch.nn.functional.pad(x[:, c0:c0 + n], pad)
                      for x in (r, k, v))
        wp = torch.nn.functional.pad(torch.clamp(w[:, c0:c0 + n], min=1e-12),
                                     pad, value=1.0)
        rin = rc * _excl_cumprod(wp, 1)
        khat = kc * _excl_revprod(wp, 1)
        y = torch.einsum("bthd,bhde->bthe", rin, state)
        blk = lambda x: x.reshape(b, nsb, sub, h, d)           # noqa: E731
        wb, rb, kb = blk(wp), blk(rc), blk(kc)
        qa = rb * _excl_cumprod(wb, 2)          # r_t from its block's start
        ke = kb * _excl_revprod(wb, 2)          # k_i to its block's end
        g = torch.prod(wb, 2)                   # (B, nsb, H, D)
        att = torch.zeros((b, h, chunk, chunk), dtype=f32)
        for tb in range(nsb):
            rows = slice(tb * sub, (tb + 1) * sub)
            for ib in range(tb):
                gap = torch.prod(g[:, ib + 1:tb], 1)           # (B, H, D)
                att[:, :, rows, ib * sub:(ib + 1) * sub] = torch.einsum(
                    "bthd,bihd->bhti", qa[:, tb], ke[:, ib] * gap[:, None])
            for t in range(sub):
                q = rb[:, tb, t]
                for i in range(t - 1, -1, -1):
                    att[:, :, tb * sub + t, tb * sub + i] = (
                        q * kb[:, tb, i]).sum(-1)
                    q = q * wb[:, tb, i]
                att[:, :, tb * sub + t, tb * sub + t] = (
                    rb[:, tb, t] * u * kb[:, tb, t]).sum(-1)
        y = y + torch.einsum("bhti,bihe->bthe", att, vc)
        state = torch.prod(wp, 1)[..., None] * state + torch.einsum(
            "bihd,bihe->bhde", khat, vc)
        ys.append(y[:, :n])
    return torch.cat(ys, 1), state


def _rwkv_inputs(b, s, h, d, regime, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, d)) for _ in range(3))
    if regime == "served":
        lw = -np.exp(rng.uniform(0.5, 2.0, size=(b, s, h, d))
                     + rng.normal(size=(b, s, h, d)))
    else:
        lw = -1e-3 * np.exp(0.1 * rng.normal(size=(b, s, h, d)))
        k = k * np.sqrt(-np.expm1(2 * lw))
    w = np.exp(lw)
    u = rng.normal(size=(h, d)) * 0.1
    s0 = rng.normal(size=(b, h, d, d))
    return tuple(x.astype(np.float32) for x in (r, k, v, w, u, s0))


def test_served_regime_reaches_the_floor_of_w():
    """The served draw puts some w below 1e-12, where the kernel's (and
    the TPU kernel's) floor of w takes over, and decays per step down to
    the floor's log, -27.6: a product over 4 such steps is e^-110, which
    exp(+) of any factor referenced inside the span would overflow."""
    w = _rwkv_inputs(1, 64, 2, 16, "served", seed=0)[3]
    assert (w < 1e-12).mean() > 0 and w.max() < 1


@pytest.mark.parametrize("regime", ["served", "weak"])
@pytest.mark.parametrize("s,h,d,chunk,sub", [
    (1, 2, 16, 16, 8), (15, 1, 8, 16, 8), (17, 2, 16, 16, 8),
    (70, 1, 32, 16, 8), (64, 1, 64, 16, 8),       # the kernel's blocking
    (33, 2, 16, 32, 16), (97, 2, 16, 64, 16),     # longer chunks, 16-blocks
])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_subblocked_model_matches_plain_and_oracles(regime, s, h, d,
                                                          chunk, sub,
                                                          with_s0):
    """The kernel's algorithm against the plain version (chunk 32, the
    model's), the port's sequential oracle, and the JAX package: the
    Pallas kernel in interpret mode from a zero state, the JAX oracle
    ``ref.rwkv6_ref`` with s0."""
    r, k, v, w, u, s0 = _rwkv_inputs(2, s, h, d, regime, seed=s * 7 + d)
    t = [torch.from_numpy(x) for x in (r, k, v, w, u)]
    ts0 = torch.from_numpy(s0) if with_s0 else None
    y, st = wkv_subblocked(*t, ts0, chunk=chunk, sub=sub)
    assert y.shape == (2, s, h, d) and st.shape == (2, h, d, d)
    py, pst = rwkv6_scan_plain(*t, ts0, 32)
    assert _err(y, py) < RWKV_TOL and _err(st, pst) < RWKV_TOL
    oy, ost = ref.rwkv6_ref(*t, ts0)
    assert _err(y, oy) < RWKV_TOL and _err(st, ost) < RWKV_TOL
    j = [jnp.asarray(x) for x in (r, k, v, w, u)]
    if with_s0:
        jy, jst = jref.rwkv6_ref(*j, jnp.asarray(s0))
    else:
        jy, jst = jops.rwkv6(*j, chunk=16)
    assert _err(y, jy) < RWKV_TOL and _err(st, jst) < RWKV_TOL


# ---------------------------------------------------------------------------
# RG-LRU: the chained scan over time chunks
# ---------------------------------------------------------------------------

def rglru_chained(a, b, h0=None, chunk=32, published=lambda p: True):
    """The kernel's chained scan in fp32: a, b (B, S, D), h0 (B, D) | None
    -> h (B, S, D). Chunks are taken in order; chunk c publishes its
    aggregate (A = prod a, B = the scan from 0) and, once it has run, its
    end value. A chunk's carry-in looks back over chunks c - 1, c - 2, ..:
    ``published(p)`` says whether chunk p's end value is already out when
    the look-back reaches it (else only its aggregate, which is composed:
    the map from p's start to c's start is (A_acc A_p, A_acc B_p + B_acc));
    before the first chunk the carry is h0. The chunk then walks
    h_t = a_t h_{t-1} + b_t from its carry-in."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    bsz, s, d = a32.shape
    n = -(-s // chunk)
    start = torch.zeros((bsz, d)) if h0 is None else h0.to(torch.float32)
    out = torch.empty_like(a32)
    agg, ends = [], []
    for c in range(n):
        span = slice(c * chunk, (c + 1) * chunk)
        ac, bc = a32[:, span], b32[:, span]
        ca, cb = torch.ones((bsz, d)), torch.zeros((bsz, d))
        for i in range(ac.shape[1]):
            cb = ac[:, i] * cb + bc[:, i]
            ca = ca * ac[:, i]
        agg.append((ca, cb))
        acc_a, acc_b = torch.ones((bsz, d)), torch.zeros((bsz, d))
        p = c - 1
        while True:
            if p < 0:
                h = acc_a * start + acc_b
                break
            if published(p):
                h = acc_a * ends[p] + acc_b
                break
            acc_b = acc_a * agg[p][1] + acc_b
            acc_a = acc_a * agg[p][0]
            p -= 1
        for i in range(ac.shape[1]):
            h = ac[:, i] * h + bc[:, i]
            out[:, c * chunk + i] = h
        ends.append(h)
    return out.to(a.dtype)


def _rglru_inputs(b, s, d, seed, with_h0=True):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.normal(size=(b, s, d))))
    x = rng.normal(size=(b, s, d))
    h0 = rng.normal(size=(b, d)) if with_h0 else None
    return tuple(None if z is None else torch.from_numpy(z.astype(np.float32))
                 for z in (a, x, h0))


@pytest.mark.parametrize("s", [1, 31, 32, 33, 65, 200])
@pytest.mark.parametrize("lookback", ["ends", "aggregates", "every_third"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_chained_model_matches_plain_and_oracles(s, lookback, with_h0):
    """The chained scan against the plain loop, the port's oracle, and the
    JAX package (the Pallas kernel in interpret mode, ``ref.rglru_ref``),
    with the look-back meeting end values at once, composing every
    aggregate back to h0, or composing up to two aggregates before an end
    value: S straddles the 32-step chunks."""
    a, x, h0 = _rglru_inputs(2, s, 40, seed=s, with_h0=with_h0)
    published = {"ends": lambda p: True, "aggregates": lambda p: False,
                 "every_third": lambda p: p % 3 == 2}[lookback]
    got = rglru_chained(a, x, h0, published=published)
    assert got.shape == (2, s, 40)
    assert _err(got, rglru_scan_plain(a, x, h0)) < RGLRU_TOL
    assert _err(got, ref.rglru_ref(a, x, h0)) < RGLRU_TOL
    ja, jx = jnp.asarray(a.numpy()), jnp.asarray(x.numpy())
    jh0 = None if h0 is None else jnp.asarray(h0.numpy())
    assert _err(got, jops.rglru(ja, jx, jh0)) < RGLRU_TOL
    assert _err(got, jref.rglru_ref(ja, jx, jh0)) < RGLRU_TOL


def test_rglru_workspace_covers_every_chunk_record():
    """The wrapper's workspace for the chained scan: a ticket, and per
    (batch, 128-channel tile, 32-step chunk) record a flag and 128 floats
    each of A, B and the end value; none for S <= 32, which the
    one-thread-per-channel kernel takes (decode: one launch, no memset)."""
    from repro_torch.kernels import rglru_scan as rg
    assert rg.workspace_bytes(4, 1, 2560) == 0
    assert rg.workspace_bytes(4, 32, 2560) == 0
    recs = 4 * 20 * 128
    assert rg.workspace_bytes(4, 4096, 2560) == 16 + 4 * recs + 12 * recs * 128
    assert rg.workspace_bytes(2, 33, 100) == 16 + 4 * 4 + 12 * 4 * 128


# ---------------------------------------------------------------------------
# The backward kernels
# ---------------------------------------------------------------------------

def _held(got, want, bar):
    """max |got - want| <= bar x max(1, max |want|), per gradient."""
    for g, w_ in zip(got, want):
        assert (g is None) == (w_ is None)
        if g is not None:
            scale = max(1.0, float(w_.abs().max()))
            assert _err(g, w_) <= bar * scale


def rglru_bwd_chained(a, h, dh, h0=None, chunk=32, reach=8):
    """The backward kernel's chained scan in fp32: g_t = dh_t + a_{t+1}
    g_{t+1} over chunks taken latest first. A chunk's aggregate maps its
    carry-in g_{t1+1} to g_{t0}; its carry-in composes the aggregates of
    the next ``reach`` - 1 later chunks onto the end value of the
    ``reach``-th (or onto g_S = 0 near the last chunk). Then db = g,
    da_t = g_t h_{t-1} (h0 or 0 before the first step), dh0 = a_0 g_0."""
    a32, h32, g32 = (x.to(torch.float32) for x in (a, h, dh))
    bsz, s, d = a32.shape
    n = -(-s // chunk)
    coef = torch.cat([a32[:, 1:], torch.zeros((bsz, 1, d))], 1)
    g_all = torch.empty_like(a32)
    agg, ends = {}, {}
    for rev in range(n):
        c = n - 1 - rev
        span = slice(c * chunk, min((c + 1) * chunk, s))
        cc, gc = coef[:, span], g32[:, span]
        ca, cb = torch.ones((bsz, d)), torch.zeros((bsz, d))
        for i in range(cc.shape[1] - 1, -1, -1):
            cb = cc[:, i] * cb + gc[:, i]
            ca = ca * cc[:, i]
        agg[rev] = (ca, cb)
        acc_a, acc_b = torch.ones((bsz, d)), torch.zeros((bsz, d))
        for p in range(rev - 1, max(rev - reach, -1), -1):
            acc_b = acc_a * agg[p][1] + acc_b
            acc_a = acc_a * agg[p][0]
        g = acc_a * ends[rev - reach] + acc_b if rev >= reach else acc_b
        for i in range(cc.shape[1] - 1, -1, -1):
            g = cc[:, i] * g + gc[:, i]
            g_all[:, c * chunk + i] = g
        ends[rev] = g
    hprev = torch.cat([torch.zeros((bsz, 1, d)) if h0 is None
                       else h0.to(torch.float32)[:, None], h32[:, :-1]], 1)
    dh0 = None if h0 is None else a32[:, 0] * g_all[:, 0]
    return g_all * hprev, g_all, dh0


@pytest.mark.parametrize("s", [1, 31, 33, 65, 300])
@pytest.mark.parametrize("reach", [1, 8])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_bwd_chained_model_matches_the_float64_oracle(s, reach,
                                                            with_h0):
    """The backward's chained scan (S over one to ten chunks: the look-back
    at a reach of 8 meets the last chunk and end values alike) against
    rglru_scan_bwd_plain summed in float64, and the fp32 plain version
    against autograd through the forward's plain loop."""
    from repro_torch.kernels import rglru_scan as rg
    a, x, h0 = _rglru_inputs(2, s, 40, seed=s + reach, with_h0=with_h0)
    dh = torch.from_numpy(np.random.default_rng(s).normal(
        size=(2, s, 40)).astype(np.float32))
    h = rglru_scan_plain(a, x, h0)
    want = rg.rglru_scan_bwd_plain(a, h, dh, h0, acc_dtype=torch.float64)
    _held(rglru_bwd_chained(a, h, dh, h0, reach=reach), want, RGLRU_TOL)
    leaves = [t.clone().requires_grad_() for t in (a, x, h0)
              if t is not None]
    out = rglru_scan_plain(*leaves, *([None] if h0 is None else []))
    auto = torch.autograd.grad(out, leaves, dh)
    got = rg.rglru_scan_bwd_plain(a, h, dh, h0)
    _held([g for g in got if g is not None], auto, 1e-5)


def rwkv6_bwd_walks(r, k, v, w, u, dy, s0=None, ds_final=None, ck=8):
    """The backward kernel's three walks in fp32, per (b, h) all at once.
    Walk 1 carries S forward (dr_t = S_{t-1} dy_t + c_t u k_t, c_t =
    dy_t . v_t; du += c_t r_t k_t), saving S before every ``ck`` steps;
    walk 2 carries G backward from ds_final (dk_t = G_t v_t + c_t u r_t,
    dw_t = sum_e G_t S_{t-1} with S_{t-1} the checkpoint advanced t mod
    ``ck`` steps, 0 where w < 1e-12; ds0 = G_{-1}); walk 3 carries G^T
    (dv_t = G_t^T k_t + (r_t . u k_t) dy_t). u is (H, D) or per row."""
    f = torch.float32
    r, k, v, w, dy = (x.to(f) for x in (r, k, v, w, dy))
    b, s, h, d = r.shape
    uu = (u[None] if u.dim() == 2 else u).to(f)
    wf = torch.clamp(w, min=1e-12)
    st = torch.zeros((b, h, d, d)) if s0 is None else s0.to(f).clone()
    ckpts, dr = {}, torch.empty_like(r)
    du = torch.zeros((b, h, d))
    for t in range(s):
        if t % ck == 0:
            ckpts[t // ck] = st.clone()
        c = (v[:, t] * dy[:, t]).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhde,bhe->bhd", st, dy[:, t]) \
            + uu * k[:, t] * c
        du += r[:, t] * k[:, t] * c
        st = wf[:, t, ..., None] * st + k[:, t, ..., None] * v[:, t, :, None]
    g = torch.zeros((b, h, d, d)) if ds_final is None else ds_final.clone()
    dk, dw, dv = (torch.empty_like(r) for _ in range(3))
    for t in range(s - 1, -1, -1):
        sp = ckpts[t // ck].clone()
        for m in range(t // ck * ck, t):
            sp = wf[:, m, ..., None] * sp \
                + k[:, m, ..., None] * v[:, m, :, None]
        c = (v[:, t] * dy[:, t]).sum(-1, keepdim=True)
        dk[:, t] = torch.einsum("bhde,bhe->bhd", g, v[:, t]) \
            + uu * r[:, t] * c
        dw[:, t] = torch.where(w[:, t] >= 1e-12, (g * sp).sum(-1), 0.0)
        bonus = (r[:, t] * uu * k[:, t]).sum(-1, keepdim=True)
        dv[:, t] = torch.einsum("bhde,bhd->bhe", g, k[:, t]) \
            + bonus * dy[:, t]
        g = wf[:, t, ..., None] * g + r[:, t, ..., None] * dy[:, t, :, None]
    return dr, dk, dv, dw, du, None if s0 is None else g


@pytest.mark.parametrize("regime", ["served", "weak"])
@pytest.mark.parametrize("s", [1, 8, 9, 37])
@pytest.mark.parametrize("states", [False, True])
def test_rwkv6_bwd_walks_match_the_float64_oracle(regime, s, states):
    """The backward's three walks (S one past, at and across its 8-step
    checkpoints; s0 and ds_final given or not; u per batch row with the
    states) against rwkv6_scan_bwd_plain in float64, 5e-4 of each
    gradient's largest |value|; so is the fp32 plain version. In the
    served regime some w sit near the 1e-12 floor: dw is a product of G
    and S in both, divided by nothing."""
    from repro_torch.kernels import rwkv6_scan as rw
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in _rwkv_inputs(
        2, s, 2, 16, regime, seed=s))
    rng = np.random.default_rng(s + 1)
    dy = torch.from_numpy(rng.normal(size=r.shape).astype(np.float32))
    dsf = torch.from_numpy(rng.normal(size=s0.shape).astype(np.float32)) \
        if states else None
    if states:
        u = u[None] * torch.tensor([1.0, -0.5])[:, None, None]
    s0 = s0 if states else None
    want = rw.rwkv6_scan_bwd_plain(r, k, v, w, u, dy, s0, dsf, chunk=16,
                                   acc_dtype=torch.float64)
    _held(rwkv6_bwd_walks(r, k, v, w, u, dy, s0, dsf), want, RWKV_TOL)
    _held(rw.rwkv6_scan_bwd_plain(r, k, v, w, u, dy, s0, dsf, chunk=16),
          want, RWKV_TOL)
