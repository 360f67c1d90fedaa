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
  the coefficient a shifted by one step, each chunk's aggregate composed
  from four 8-step segments', each carry-in composed from a fixed reach of
  aggregates onto an end value.
* ``rwkv6_bwd_chunked``: the forward's chunked form run backwards, as its
  three launches take it: the walks save S before and G after every
  64-step group; per group, its 16-step chunks forward (S rebuilt; dr,
  dw's y and z terms, du's part) and backward (G; dv, dk, dw's
  rowsum(G o S) and x terms), the sums over pairs split at the chunk's
  midpoint into a quadrant through referenced factors and pairwise
  halves; du summed over the groups.

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
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

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
    """The wrapper's workspace for the chained scans: a ticket, and per
    (batch, 128-channel tile, 32-step chunk) record a flag and 128 floats
    each of A, B and the end value, the flags padded to 16 bytes so that
    the backward's float4 slots after them are aligned; none for S <= 32,
    which the one-thread-per-channel kernels take (decode: one launch, no
    memset)."""
    from repro_torch.kernels import rglru_scan as rg
    assert rg.workspace_bytes(4, 1, 2560) == 0
    assert rg.workspace_bytes(4, 32, 2560) == 0
    recs = 4 * 20 * 128
    assert rg.workspace_bytes(4, 4096, 2560) == 16 + 4 * recs + 12 * recs * 128
    assert rg.workspace_bytes(2, 33, 100) == 16 + 4 * 4 + 12 * 4 * 128
    recs = 3 * 3 * 3                                  # (3, 70, 300): 27
    assert rg.workspace_bytes(3, 70, 300) == 16 + 112 + 12 * recs * 128


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


def rglru_bwd_chained(a, h, dh, h0=None, chunk=32, reach=8, seg=8):
    """The backward kernel's chained scan in fp32: g_t = dh_t + a_{t+1}
    g_{t+1} over chunks taken latest first. A chunk's aggregate maps its
    carry-in g_{t1+1} to g_{t0}: its ``seg``-step segments' aggregates
    (each from its end down to its start) composed latest first. Its
    carry-in composes the aggregates of the next ``reach`` - 1 later
    chunks onto the end value of the ``reach``-th (or onto g_S = 0 near the
    last chunk); each segment walks from the carry-in composed with the
    later segments' aggregates. Then db = g, da_t = g_t h_{t-1} (h0 or 0
    before the first step), dh0 = a_0 g_0."""
    a32, h32, g32 = (x.to(torch.float32) for x in (a, h, dh))
    bsz, s, d = a32.shape
    n = -(-s // chunk)
    coef = torch.cat([a32[:, 1:], torch.zeros((bsz, 1, d))], 1)
    g_all = torch.empty_like(a32)
    agg, ends = {}, {}
    for rev in range(n):
        c = n - 1 - rev
        # steps past S pass g through: coefficient 1, dh 0
        cc = torch.ones((bsz, chunk, d))
        gc = torch.zeros((bsz, chunk, d))
        m = min(chunk, s - c * chunk)
        cc[:, :m], gc[:, :m] = coef[:, c * chunk:c * chunk + m], \
            g32[:, c * chunk:c * chunk + m]
        segs = []
        for q in range(chunk // seg):
            sa, sb = torch.ones((bsz, d)), torch.zeros((bsz, d))
            for i in range(seg * q + seg - 1, seg * q - 1, -1):
                sb = cc[:, i] * sb + gc[:, i]
                sa = sa * cc[:, i]
            segs.append((sa, sb))
        ca, cb = torch.ones((bsz, d)), torch.zeros((bsz, d))
        offsets = {}
        for q in range(chunk // seg - 1, -1, -1):
            offsets[q] = (ca, cb)
            cb = segs[q][0] * cb + segs[q][1]
            ca = ca * segs[q][0]
        agg[rev] = (ca, cb)
        acc_a, acc_b = torch.ones((bsz, d)), torch.zeros((bsz, d))
        for p in range(rev - 1, max(rev - reach, -1), -1):
            acc_b = acc_a * agg[p][1] + acc_b
            acc_a = acc_a * agg[p][0]
        g_in = acc_a * ends[rev - reach] + acc_b if rev >= reach else acc_b
        for q in range(chunk // seg):
            g = offsets[q][0] * g_in + offsets[q][1]
            for i in range(seg * q + seg - 1, seg * q - 1, -1):
                g = cc[:, i] * g + gc[:, i]
                if i < m:
                    g_all[:, c * chunk + i] = g
            if q == 0:
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


def rwkv6_bwd_chunked(r, k, v, w, u, dy, s0=None, ds_final=None, chunk=16,
                      group=4):
    """The backward kernel's chunked form in fp32, per (b, h) all at once,
    as its three launches take it. Chunks of ``chunk`` steps (w' =
    max(w, 1e-12); a ragged last chunk masked: w' = 1, r = k = v = dy = 0),
    halves of chunk / 2 for the quadrants, ``group`` chunks a workspace
    interval. Within a chunk P_{<t}, P_{>t} are the prefix and suffix
    products of w', P_(i,t) = prod_{i<j<t} w'_j, A_t = prod_{t<j<h} w'_j
    and B_t = prod_{h<=j<t} w'_j (h the midpoint), Khat_t = k_t P_{>t},
    Rin_t = r_t P_{<t}, Kq = k A, Rq = r B, M = dY V^T, c_t = M_tt.

    1. The walks: S forward from s0, saved before every group's first
       chunk (S <- diag(prod w') S + Khat^T V); G backward from ds_final,
       saved after every group's last chunk (G <- diag(prod w') G +
       Rin^T dY); ds0 = G before the first chunk.
    2. Per group, from its S and G: forward over its chunks (S kept for
       each chunk and advanced), dr_t = P_{<t} (S dy_t) + B_t (M Kq)_t
       (t >= h) + sum_{i<t, same half} M_ti k_i P_(i,t) + c_t u k_t;
       dw's terms P_{<t} y_t (y_{t-1} = w'_t y_t + r_t (S dy_t)) and
       sum_{t'>t} P_(t,t') r_t' z_t(t') (z_{t+1}(t') = w'_t z_t(t') + k_t
       M_t't) for i < t < t' in one half, and across the midpoint B_t
       sum_{t'>t} P_(t,t') r_t' (M Kq)_t' (t >= h); du's part sum_t c_t
       r_t k_t. Then backward over them (G
       carried): att = Rq Kq^T across the halves, pairwise within them,
       r_t . (u k_t) on the diagonal; dv_t = G^T Khat_t + sum_{t'>=t}
       att_t't dy_t'; dk_t = P_{>t} (G v_t) + A_t (M^T Rq)_t (t < h) +
       sum_{t'>t, same half} M_t't r_t' P_(t,t') + c_t u r_t; dw's terms
       P_{<t} P_{>t} rowsum(G o S), P_{>t} x_t (x_{t+1} = w'_t x_t +
       k_t (G v_t)) and, across the midpoint, A_t sum_{i<t} P_(i,t) k_i
       (M^T Rq)_i (t < h); dw = 0 where w < 1e-12.
    3. du: the groups' parts summed in order.
    No factor divides by w. u is (H, D) or per row (B, H, D)."""
    f = torch.float32
    b, s, h, d = r.shape
    uu = (u[None] if u.dim() == 2 else u).to(f)                # (1|B, H, D)
    n = -(-s // chunk)
    pad = (0, 0, 0, 0, 0, n * chunk - s)
    F = torch.nn.functional

    def chunked(x, value=0.0):     # (B, S, H, D) -> (B, H, n, C, D)
        x = F.pad(x.to(f), pad, value=value)
        return x.reshape(b, n, chunk, h, d).permute(0, 3, 1, 2, 4)
    rc, kc, vc, gc = (chunked(x) for x in (r, k, v, dy))
    wc = chunked(torch.clamp(w.to(f), min=1e-12), 1.0)
    live = chunked(w.to(f)) >= 1e-12
    half = chunk // 2
    pin, pout = _excl_cumprod(wc, 3), _excl_revprod(wc, 3)
    dec = torch.prod(wc, 3)                                     # (B,H,n,D)
    fa = torch.cat([_excl_revprod(wc[..., :half, :], 3),
                    torch.ones_like(wc[..., half:, :])], 3)     # A_t, t < h
    fb = torch.cat([torch.ones_like(wc[..., :half, :]),
                    _excl_cumprod(wc[..., half:, :], 3)], 3)    # B_t, t >= h
    khat, rin = kc * pout, rc * pin
    kq, rq = kc * fa, rc * fb
    mm = torch.einsum("bhnte,bhnie->bhnti", gc, vc)             # M = dY V^T
    eye = torch.eye(chunk, dtype=torch.bool)

    # 1. the walks
    st = torch.zeros((b, h, d, d)) if s0 is None else s0.to(f).clone()
    gs = torch.zeros((b, h, d, d)) if ds_final is None \
        else ds_final.to(f).clone()
    ngroups = -(-n // group)
    ck_s, ck_g = [None] * ngroups, [None] * ngroups
    for c in range(n):
        if c % group == 0:
            ck_s[c // group] = st
        st = dec[:, :, c, :, None] * st + torch.einsum(
            "bhtd,bhte->bhde", khat[:, :, c], vc[:, :, c])
    for c in range(n - 1, -1, -1):
        if c == min((c // group + 1) * group, n) - 1:
            ck_g[c // group] = gs
        gs = dec[:, :, c, :, None] * gs + torch.einsum(
            "bhtd,bhte->bhde", rin[:, :, c], gc[:, :, c])
    ds0 = None if s0 is None else gs

    # 2. per group
    grads = [torch.zeros_like(rc) for _ in range(4)]            # dr dk dv dw
    du_parts = []
    for gi in range(ngroups):
        cs = range(gi * group, min((gi + 1) * group, n))
        st, kept, du = ck_s[gi], {}, torch.zeros((b, h, d))
        for c in cs:                                  # forward: S
            wv, rr, kk = wc[:, :, c], rc[:, :, c], kc[:, :, c]
            m = mm[:, :, c]
            sdy = torch.einsum("bhde,bhte->bhtd", st, gc[:, :, c])
            drq = torch.einsum("bhti,bhid->bhtd", m[..., half:, :half],
                               kq[:, :, c, :half])
            cdot = m[..., eye]                                  # (B,H,C)
            dr, t3, t4 = (torch.zeros_like(rr) for _ in range(3))
            for t in range(chunk):
                hs = t // half * half
                acc = torch.zeros((b, h, d))
                for i in range(hs, t):          # Horner: P_(i,t)
                    acc = acc * wv[:, :, i] + m[:, :, t, i, None] * kk[:, :, i]
                dr[:, :, t] = pin[:, :, c, t] * sdy[:, :, t] + acc \
                    + cdot[:, :, t, None] * uu * kk[:, :, t]
                if t >= half:
                    dr[:, :, t] += fb[:, :, c, t] * drq[:, :, t - half]
            y = torch.zeros((b, h, d))
            for t in range(chunk - 1, -1, -1):
                t3[:, :, t] = pin[:, :, c, t] * y
                y = wv[:, :, t] * y + rr[:, :, t] * sdy[:, :, t]
            # z inside each half; across the midpoint (i < 8 <= t') the
            # term is B_t sum_{t'>t} P_(t,t') r_t' (M (k A))_t' for t >= 8
            # here, A_t sum_{i<t} P_(i,t) k_i (M^T (r B))_i for t < 8 in
            # the backward pass
            z = torch.zeros((b, h, chunk, d))
            for t in range(chunk):
                he = (t // half + 1) * half
                acc = torch.zeros((b, h, d))
                for t2 in range(he - 1, t, -1):         # Horner: P_(t,t')
                    acc = acc * wv[:, :, t2] + rr[:, :, t2] * z[:, :, t2]
                t4[:, :, t] = acc
                z[:, :, t + 1:he] = wv[:, :, t, None] * z[:, :, t + 1:he] \
                    + kk[:, :, t, None] * m[:, :, t + 1:he, t, None]
            eta = torch.zeros((b, h, d))
            for t in range(chunk - 1, half - 1, -1):
                t4[:, :, t] += fb[:, :, c, t] * eta
                eta = wv[:, :, t] * eta + rr[:, :, t] * drq[:, :, t - half]
            grads[0][:, :, c] = dr
            grads[3][:, :, c] = t3 + t4
            du = du + (cdot[..., None] * rr * kk).sum(2)
            kept[c] = st
            st = dec[:, :, c, :, None] * st + torch.einsum(
                "bhtd,bhte->bhde", khat[:, :, c], vc[:, :, c])
        du_parts.append(du)
        gs = ck_g[gi]
        for c in reversed(cs):                        # backward: G
            wv, rr, kk = wc[:, :, c], rc[:, :, c], kc[:, :, c]
            m = mm[:, :, c]
            gv = torch.einsum("bhde,bhte->bhtd", gs, vc[:, :, c])
            att = torch.zeros((b, h, chunk, chunk))
            att[..., half:, :half] = torch.einsum(
                "bhtd,bhid->bhti", rq[:, :, c, half:], kq[:, :, c, :half])
            for t2 in range(chunk):
                hs = t2 // half * half
                q = rr[:, :, t2]
                for i in range(t2 - 1, hs - 1, -1):
                    att[:, :, t2, i] = (q * kk[:, :, i]).sum(-1)
                    q = q * wv[:, :, i]
                att[:, :, t2, t2] = (rr[:, :, t2] * uu * kk[:, :, t2]).sum(-1)
            dkq = torch.einsum("bhti,bhtd->bhid", m[..., half:, :half],
                               rq[:, :, c, half:])
            cdot = m[..., eye]
            grads[2][:, :, c] = torch.einsum(
                "bhtd,bhde->bhte", khat[:, :, c], gs) + torch.einsum(
                "bhst,bhse->bhte", att, gc[:, :, c])
            dk, t2v = torch.zeros_like(rr), torch.zeros_like(rr)
            for t in range(chunk):
                he = (t // half + 1) * half
                acc = torch.zeros((b, h, d))
                for t2 in range(he - 1, t, -1):         # Horner: P_(t,t')
                    acc = acc * wv[:, :, t2] + m[:, :, t2, t, None] \
                        * rr[:, :, t2]
                dk[:, :, t] = pout[:, :, c, t] * gv[:, :, t] + acc \
                    + cdot[:, :, t, None] * uu * rr[:, :, t]
                if t < half:
                    dk[:, :, t] += fa[:, :, c, t] * dkq[:, :, t]
            x = torch.zeros((b, h, d))
            for t in range(chunk):
                t2v[:, :, t] = pout[:, :, c, t] * x
                x = wv[:, :, t] * x + kk[:, :, t] * gv[:, :, t]
            xi = torch.zeros((b, h, d))
            for t in range(half):
                t2v[:, :, t] += fa[:, :, c, t] * xi
                xi = wv[:, :, t] * xi + kk[:, :, t] * dkq[:, :, t]
            zsum = (gs * kept[c]).sum(-1)                       # (B,H,D)
            t1 = pin[:, :, c] * pout[:, :, c] * zsum[:, :, None]
            dw = grads[3][:, :, c] + t1 + t2v
            grads[1][:, :, c] = dk
            grads[3][:, :, c] = torch.where(live[:, :, c], dw, 0.0)
            gs = dec[:, :, c, :, None] * gs + torch.einsum(
                "bhtd,bhte->bhde", rin[:, :, c], gc[:, :, c])

    # 3. du, the groups' parts in order
    du = du_parts[0]
    for part in du_parts[1:]:
        du = du + part
    out = [x.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, d)[:, :s]
           for x in grads]
    return (*out, du, ds0)


@pytest.mark.parametrize("regime", ["served", "weak"])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 63, 64, 65, 130])
@pytest.mark.parametrize("states", [False, True])
def test_rwkv6_bwd_chunked_matches_the_float64_oracle(regime, s, states):
    """The backward's chunked form (S across its 16-step chunks, 8-step
    halves and 64-step workspace groups; s0 and ds_final given or not; u
    per batch row with the states) against rwkv6_scan_bwd_plain in
    float64, 5e-4 of each gradient's largest |value|; so is the fp32
    plain version. In the served regime some w sit at the 1e-12 floor:
    dw is a product of G and S in both, no factor divided by w. In the
    weak regime also against jax.grad of the JAX model's wkv_chunked
    (whose fp32 dw divides by w, so the served regime is left out)."""
    import jax

    from repro.models import rwkv6 as r_rwkv6
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
    got = rwkv6_bwd_chunked(r, k, v, w, u, dy, s0, dsf)
    assert [tuple(x.shape) for x in got[:5]] == [tuple(r.shape)] * 4 + [
        (2, 2, 16)] and (got[5] is None) == (s0 is None)
    want = rw.rwkv6_scan_bwd_plain(r, k, v, w, u, dy, s0, dsf, chunk=16,
                                   acc_dtype=torch.float64)
    _held(got, want, RWKV_TOL)
    _held(rw.rwkv6_scan_bwd_plain(r, k, v, w, u, dy, s0, dsf, chunk=16),
          want, RWKV_TOL)
    if regime != "weak":
        return
    for row in range(2):           # u is a row's own: one jax.grad a row
        sl = slice(row, row + 1)
        ur = u[row] if u.dim() == 3 else u

        def jloss(*a):
            y, s_fin = r_rwkv6.wkv_chunked(*a[:5], a[5] if states else None,
                                           chunk=32)
            out = jnp.sum(y * jnp.asarray(dy[sl].numpy()))
            return out + (jnp.sum(s_fin * jnp.asarray(dsf[sl].numpy()))
                          if states else 0.0)
        args = [x[sl] for x in (r, k, v, w)] + [ur] + (
            [s0[sl]] if states else [])
        jgrads = jax.grad(jloss, argnums=tuple(range(len(args))))(
            *(jnp.asarray(x.numpy()) for x in args))
        mine = [g[sl] for g in got[:4]] + [got[4][row]] + (
            [got[5][sl]] if states else [])
        _held(mine, [torch.from_numpy(np.asarray(j, np.float64))
                     for j in jgrads], RWKV_TOL)


def test_rwkv6_bwd_workspace_holds_a_state_and_a_gradient_a_group():
    """The backward's workspace: per (b, h) and group of four 16-step
    chunks (one chunk at D > 64), the state before the group and its
    gradient after it, (DP, DP) fp32 each, and the group's part of du, DP
    fp32 (DP: D rounded up to 16, 32, 64 or 128)."""
    from repro_torch.kernels import rwkv6_scan as rw
    assert (rw.BWD_CHUNK, rw.BWD_GROUP) == (16, 4)
    # rwkv6-7b's training shape, 3 nodes x batch 4: 8 groups of 64 steps
    assert rw.bwd_workspace_bytes(12, 512, 64, 64) == \
        4 * 12 * 64 * 8 * 64 * 129
    assert rw.bwd_workspace_bytes(1, 1, 1, 8) == 4 * 16 * 33
    assert rw.bwd_workspace_bytes(2, 65, 3, 64) == 4 * 6 * 2 * 64 * 129
    assert rw.bwd_workspace_bytes(2, 64, 3, 64) == 4 * 6 * 1 * 64 * 129
    assert rw.bwd_workspace_bytes(2, 33, 2, 128) == 4 * 4 * 3 * 128 * 257
