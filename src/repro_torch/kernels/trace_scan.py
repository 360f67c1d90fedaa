"""The scan trace engine's round loop as one hand-written CUDA kernel.

The torch counterpart of the compiled program that
``repro.sim.jit_trace._round_scan`` builds: every TDM round of a trace,
transmitter by transmitter, broadcast pass by pass, in float64. It
replaces no Pallas kernel: the JAX package compiles the round loop as one
``lax.scan`` (outer over rounds, inner over transmitters, passes
unrolled), and here that scan is the kernel of ``csrc/trace_scan.cu``.

* ``round_scan(rates, sizes, recv, chan, planned_w, *, ...)`` -> ``(w_eff,
  t_start, t_comm, delivered, retx, t_end)``: on a CPU tensor the plain
  version, on a CUDA tensor one launch of the kernel (or an error; no
  fallback), then ``w_eff`` assembled from ``delivered`` by torch on the
  same device (``assemble_w``). Launches count in
  ``round_scan.launches``; ``counts=`` gathers the transmitter passes run
  and the decodes decided, the work a bound is counted from; ``exact=``
  the decodes the kernel decided on its exact float64 path (the band of
  its integer filter).
* ``round_scan_plain`` is the plain torch version: the reference's
  arithmetic op for op, a Python loop over rounds, transmitters and
  passes. The one liberty, taken by the kernel too: the clock advances by
  the last element of the packets' running sum (the reference adds
  ``d.sum()``, which may associate differently in the last bits). The
  running sum is taken in packet order on the host whatever the device,
  so the plain version gives the same launch times on the card as on the
  CPU.
* ``fade_thresholds_plain`` and ``trace_decide`` (kernel entry
  ``trace_decide``; plain version ``trace_decide_plain``): the kernel's
  integer filter of a fading decode. Each pair's threshold u* on the
  uniform becomes ``(m_lo, m_hi)`` on the grid of m = h >> 11 (a relative
  band of ``BAND`` around u*); m < m_lo fails, m > m_hi decodes, and only
  an m in between runs the exact formula. ``trace_decide`` evaluates both
  paths, for the tests.
* ``smem_bytes(n, n_pkts)`` is a launch's shared memory, bounded for
  every (n, P): the packets are tiled and, past one tile, the need words
  live in a device workspace (``_layout``, mirroring the source's).
* ``_mix64``, ``_uniforms`` and ``_rayleigh_gains`` are the stateless
  splitmix64 Rayleigh gains on int64 tensors (torch has no uint64 shift
  on the CPU): every right shift is masked to make it logical, the
  constants are written as their two's-complement values, and the
  wrapping multiplies give the uint64 bits.

Every division is by a tensor: CUDA's ``tensor / python_scalar``
multiplies by the reciprocal, one bit off IEEE division, and
``floor(t / coherence_s)`` would then land in another coherence block.

Neither entry has a shape rule: the round loop is on no path the dry run
(``launch.dryrun``) evaluates, and its work depends on the data (the
passes and decodes a trace needs), so a data-free tensor (a
``FakeTensor``) raises here before any launch rather than stand for one.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._backend import counted, data_free, require_operands, use_kernel

__all__ = ["round_scan", "round_scan_plain", "assemble_w", "smem_bytes",
           "fade_thresholds_plain", "trace_decide", "trace_decide_plain"]

_U64 = 1 << 64
_SMEM_LIMIT = 227 * 1024       # dynamic shared memory a block may take
# csrc/trace_scan.cu's constants
BAND = 1e-9                    # the filter's relative half-width around u*
MIN_X = 1e-4                   # smallest 2^(rate / B) - 1 it is sound at
_LAST_M = (1 << 53) - 1
_SINGLE_BUDGET = 160 * 1024    # one tile, all in shared memory, up to this
_TILE_WORDS = 32               # else 2048 packets a tile
_STAGE_MAX = 64 * 1024         # receivers staged while 20 n bytes fit


def _s64(x: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    x &= _U64 - 1
    return x - _U64 if x >= 1 << 63 else x


_GOLDEN = _s64(0x9E3779B97F4A7C15)
_M1 = _s64(0xBF58476D1CE4E5B9)
_M2 = _s64(0x94D049BB133111EB)


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes (``>>`` is arithmetic)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (Steele et al.) on int64 lanes holding uint64
    bits."""
    z = z + _GOLDEN
    z = (z ^ _shr(z, 30)) * _M1
    z = (z ^ _shr(z, 27)) * _M2
    return z ^ _shr(z, 31)


def _uniforms(seed: int, blocks: torch.Tensor, i: int,
              n: int) -> torch.Tensor:
    """(P, n) float64 uniforms in [0, 1) of transmitter ``i``'s packets:
    one hash per (coherence block, unordered pair). ``blocks`` (P,)
    int64."""
    j = torch.arange(n, device=blocks.device)
    pair = j.clamp(max=i) * n + j.clamp(min=i)
    b = _mix64(_mix64(blocks) ^ _s64(seed))
    h = _mix64(b[:, None] ^ pair[None, :])
    return _shr(h, 11).to(torch.float64) * 2.0 ** -53   # exact: h >> 11 < 2^53


def _rayleigh_gains(seed: int, blocks: torch.Tensor, i: int,
                    n: int) -> torch.Tensor:
    """(P, n) Exp(1) power gains of transmitter ``i``'s packets, as the
    reference's ``_rayleigh_gains``: the channel is reciprocal and
    block-fading, keyed by a hash instead of a sequential stream."""
    return -torch.log1p(-_uniforms(seed, blocks, i, n))


def assemble_w(delivered: torch.Tensor, planned_w: torch.Tensor,
               degrade: str) -> torch.Tensor:
    """(R, n, n) float64 mixing matrices of the rounds: node j takes node
    i's model where i's broadcast reached it (``delivered[r, i, j]``), and
    its own; ``renorm`` divides each row by its sum, ``naive`` keeps the
    planned weights of what arrived."""
    n = delivered.shape[-1]
    idx = torch.arange(n, device=delivered.device)
    a = delivered.transpose(1, 2).contiguous().to(torch.float64)
    a[:, idx, idx] = 1.0
    if degrade == "renorm":
        return a / a.sum(2, keepdim=True)
    return planned_w * a


def round_scan_plain(rates, sizes, recv, chan, planned_w, *, n_pkts: int,
                     passes: int, fading_on: bool, coherence_s: float,
                     bandwidth_hz: float, overhead_s: float,
                     compute_s: float, degrade: str, seed: int,
                     n_rounds: int, counts=None):
    """Plain torch version of the kernel: ``repro.sim.jit_trace``'s round
    loop in float64 on the tensors' device. ``counts``, a (2,) int64
    tensor, gains the transmitter passes that sent a packet and the
    (packet, intended receiver) decodes those passes had to decide."""
    dev = rates.device
    n = rates.shape[0]
    f64 = dict(dtype=torch.float64, device=dev)
    zero, one = torch.zeros((), **f64), torch.ones((), **f64)
    coh = torch.tensor(coherence_s, **f64)
    bw = torch.tensor(bandwidth_hz, **f64)
    active = torch.isfinite(rates) & (rates > 0)
    durs = sizes[None, :] / torch.where(active, rates, one)[:, None] \
        + overhead_s                                             # (n, P)
    all_sent = torch.ones(n_pkts, dtype=torch.bool, device=dev)
    clock = zero
    t_start = torch.empty(n_rounds, **f64)
    t_comm = torch.empty(n_rounds, **f64)
    retx = torch.zeros(n_rounds, dtype=torch.int64, device=dev)
    delivered = torch.empty((n_rounds, n, n), dtype=torch.bool, device=dev)
    for r in range(n_rounds):
        t_start[r] = clock
        round_start = clock
        for i in range(n):
            need = recv[i][None, :].expand(n_pkts, n)
            for p in range(passes):
                send = (all_sent if p == 0 else need.any(1)) & active[i]
                d = torch.where(send, durs[i], zero)
                # in packet order on the host on every device: a CUDA
                # cumsum is a parallel scan, and at ~329 000 packets its
                # other association moves a launch time across a
                # coherence block, and with it a decode
                cs = torch.cumsum(d.cpu(), 0).to(dev)
                if counts is not None:
                    counts[0] += send.any()
                    counts[1] += (need & send[:, None]).sum()
                if fading_on:
                    t_tx = clock + (cs - d)                      # launch times
                    blocks = torch.floor(t_tx / coh).to(torch.int64)
                    g = _rayleigh_gains(seed, blocks, i, n)
                    cap = bandwidth_hz * torch.log2(
                        1.0 + chan[i][None, :] * g / bw)
                    ok = cap >= rates[i]
                else:
                    ok = chan[i][None, :]
                need = need & ~(ok & send[:, None])
                if p > 0:
                    retx[r] += send.sum()
                clock = clock + cs[-1]
            delivered[r, i] = recv[i] & ~need.any(0)
        t_comm[r] = clock - round_start
        clock = clock + compute_s
    w_eff = assemble_w(delivered, planned_w, degrade)
    return w_eff, t_start, t_comm, delivered, retx, clock


_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
         ctypes.c_uint64, ctypes.c_int) + (ctypes.c_void_p,) * 11


def _layout(n: int, n_pkts: int) -> tuple[int, bool, bool, int]:
    """csrc/trace_scan.cu's ``layout``: (words of 64 packets a tile, need
    words and send masks in the device workspace, receiver lists and
    thresholds staged in shared memory, shared bytes). One tile holds
    every packet, need word and send mask in shared memory while that fits
    ``_SINGLE_BUDGET``; past it the packets go ``_TILE_WORDS`` words a
    tile, the need words (W, n) and the two send masks (2, W) to the
    workspace."""
    words = (n_pkts + 63) // 64
    staged = 20 * n <= _STAGE_MAX
    stage = 20 * n if staged else 0
    single = stage + 8 * n * words + 16 * words + 1672 * words + 16
    if single <= _SINGLE_BUDGET:
        return words, False, staged, single
    tile = min(words, _TILE_WORDS)
    return tile, True, staged, stage + 1672 * tile + 16


def smem_bytes(n: int, n_pkts: int) -> int:
    """Dynamic shared memory of one launch (csrc/trace_scan.cu's layout):
    per staged receiver its index and thresholds; per packet of a tile its
    duration, launch time and block hash; per word of a tile the warps'
    partial send masks and the tile's send word; on one tile also the need
    words and send masks. At most ~117 KB past one tile, whatever P is."""
    return _layout(n, n_pkts)[3]


def fade_thresholds_plain(snr: torch.Tensor, rate: torch.Tensor,
                          bandwidth_hz: float) -> torch.Tensor:
    """(..., 2) int64 ``(m_lo, m_hi)`` of each (mean SNR, rate): u* =
    -expm1(-g*), g* = B (2^(rate / B) - 1) / snr the gain at which the
    capacity meets the rate, and m_lo = floor(u* (1 - BAND) 2^53), m_hi =
    ceil(u* (1 + BAND) 2^53), clipped to [0, 2^53). The whole range where
    snr <= 0, 2^(rate / B) - 1 < MIN_X or a value is not finite: every
    decode of such a pair exact. csrc/trace_scan.cu's ``fade_threshold``
    in the same operations (its expm1 may differ by an ulp: any threshold
    this close is as sound)."""
    bw = torch.tensor(bandwidth_hz, dtype=torch.float64, device=snr.device)
    x = torch.expm1(rate / bw * math.log(2.0))
    g = bw * x / snr
    u = -torch.expm1(-g)
    lo = torch.floor(u * (1.0 - BAND) * 2.0 ** 53)
    hi = torch.ceil(u * (1.0 + BAND) * 2.0 ** 53)
    ok = ((snr > 0) & torch.isfinite(snr) & (x >= MIN_X) & torch.isfinite(x)
          & torch.isfinite(g) & torch.isfinite(lo) & torch.isfinite(hi))
    lo = torch.where(ok, lo.clamp(min=0.0), 0.0)
    hi = torch.where(ok, hi.clamp(max=float(_LAST_M)), float(_LAST_M))
    return torch.stack([lo, hi], -1).to(torch.int64)


def _exact_decode(m: torch.Tensor, snr: torch.Tensor, rate: torch.Tensor,
                  bandwidth_hz: float) -> torch.Tensor:
    """The exact decision at m = h >> 11, as round_scan_plain decides."""
    bw = torch.tensor(bandwidth_hz, dtype=torch.float64, device=m.device)
    g = -torch.log1p(-(m.to(torch.float64) * 2.0 ** -53))
    return bandwidth_hz * torch.log2(1.0 + snr * g / bw) >= rate


def trace_decide_plain(snr, rate, m, *, bandwidth_hz: float):
    """Plain version of ``trace_decide``."""
    thr = fade_thresholds_plain(snr, rate, bandwidth_hz)
    exact = _exact_decode(m, snr, rate, bandwidth_hz)
    banded = (m >= thr[..., 0]) & (m <= thr[..., 1])
    filtered = torch.where(banded, exact, m > thr[..., 1])
    return thr, filtered, exact, banded


_DECIDE_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_double, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def _refuse_data_free(entry: str, *xs) -> None:
    if data_free(*xs):
        raise RuntimeError(
            f"{entry} has no shape rule: the round loop's work depends on "
            "its data, and no dry-run path reaches it")


def trace_decide(snr, rate, m, *, bandwidth_hz: float):
    """The round loop's fading decision on (N,) float64 ``snr`` (mean SNR)
    and ``rate``, (N,) int64 ``m`` in [0, 2^53): ``(thr (N, 2) int64,
    filtered, exact, banded)``, the bools (N,) the filter's decision (the
    two compares, the exact formula inside the band), the exact formula's,
    and whether m fell in the band. The kernel's own ``decide`` on a CUDA
    tensor (one launch, counted in ``trace_decide.launches``), the plain
    version on the CPU. Only tests call it: random hashes almost never
    reach the band."""
    n = snr.shape[0] if snr.dim() == 1 else -1
    for name, t, dtype in (("snr", snr, torch.float64),
                           ("rate", rate, torch.float64),
                           ("m", m, torch.int64)):
        if tuple(t.shape) != (n,) or t.dtype != dtype:
            raise ValueError(f"{name} must be ({n},) {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    device = snr.device
    _refuse_data_free("trace_decide", snr, rate, m)
    if not use_kernel(device):
        return trace_decide_plain(snr, rate, m, bandwidth_hz=bandwidth_hz)
    require_operands(device, snr=snr, rate=rate, m=m)
    thr = torch.empty((n, 2), dtype=torch.int64, device=device)
    filtered, exact, banded = (torch.empty(n, dtype=torch.bool,
                                           device=device) for _ in range(3))
    _build.launch("trace_scan", "trace_decide", _DECIDE_ARGS, device,
                  snr.data_ptr(), rate.data_ptr(), m.data_ptr(), n,
                  bandwidth_hz, thr.data_ptr(), filtered.data_ptr(),
                  exact.data_ptr(), banded.data_ptr())
    trace_decide.launches += 1
    return thr, filtered, exact, banded


trace_decide.launches = 0


def round_scan(rates, sizes, recv, chan, planned_w, *, n_pkts: int,
               passes: int, fading_on: bool, coherence_s: float,
               bandwidth_hz: float, overhead_s: float, compute_s: float,
               degrade: str, seed: int, n_rounds: int, counts=None,
               exact=None):
    """One trace's TDM rounds: rates (n,), sizes (P,), planned_w (n, n)
    float64, recv (n, n) bool, chan (n, n) float64 mean SNR under fading
    (``fading_on``) else the bool decode table. Returns ``(w_eff (R, n, n)
    float64, t_start (R,), t_comm (R,) float64, delivered (R, n, n) bool,
    retx (R,) int64, t_end () float64)`` on the inputs' device. Kernel on
    an sm_90 card, plain version on the CPU. ``exact``, a (1,) int64
    tensor, gains the decodes the kernel decided on its exact path; the
    plain version has no filter and leaves it as it is."""
    n = rates.shape[0] if rates.dim() == 1 else -1
    want = {"rates": (rates, (n,), torch.float64),
            "sizes": (sizes, (n_pkts,), torch.float64),
            "recv": (recv, (n, n), torch.bool),
            "chan": (chan, (n, n),
                     torch.float64 if fading_on else torch.bool),
            "planned_w": (planned_w, (n, n), torch.float64)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if n_pkts < 1 or passes < 1 or n_rounds < 0:
        raise ValueError(f"need n_pkts >= 1, passes >= 1, n_rounds >= 0; "
                         f"got {n_pkts}, {passes}, {n_rounds}")
    if degrade not in ("renorm", "naive"):
        raise ValueError(f"degrade must be 'renorm' or 'naive', got "
                         f"{degrade!r}")
    if counts is not None and (counts.shape != (2,)
                               or counts.dtype != torch.int64):
        raise ValueError("counts must be a (2,) int64 tensor")
    if exact is not None and (exact.shape != (1,)
                              or exact.dtype != torch.int64):
        raise ValueError("exact must be a (1,) int64 tensor")
    device = rates.device
    kw = dict(n_pkts=n_pkts, passes=passes, fading_on=fading_on,
              coherence_s=coherence_s, bandwidth_hz=bandwidth_hz,
              overhead_s=overhead_s, compute_s=compute_s, degrade=degrade,
              seed=seed, n_rounds=n_rounds, counts=counts)
    _refuse_data_free("round_scan", rates, sizes, recv, chan, planned_w,
                      counts, exact)
    if not use_kernel(device):
        return round_scan_plain(rates, sizes, recv, chan, planned_w, **kw)
    require_operands(device, rates=rates, sizes=sizes, recv=recv, chan=chan,
                     counts=counts, exact=exact)
    if planned_w.device != device:          # read by torch, not the kernel
        raise ValueError(f"planned_w is on {planned_w.device}, expected "
                         f"{device}")
    f64 = dict(dtype=torch.float64, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    delivered = torch.zeros((n_rounds, n, n), dtype=torch.bool, device=device)
    t_start = torch.empty(n_rounds, **f64)
    t_comm = torch.empty(n_rounds, **f64)
    retx = torch.empty(n_rounds, **i64)
    t_end = torch.empty((), **f64)
    # scratch: receiver lists, thresholds, and past one tile the need
    # words (W, n) and the two send masks (2, W)
    lists = torch.empty((n, n + 1), dtype=torch.int32, device=device)
    thr = torch.empty((n, n, 2), **i64)
    words = (n_pkts + 63) // 64
    tiled = _layout(n, n_pkts)[1]
    need_ws = torch.empty((words, n), **i64) if tiled else None
    send_ws = torch.empty((2, words), **i64) if tiled else None

    def ptr(t):
        return None if t is None else t.data_ptr()
    _build.launch(
        "trace_scan", "trace_scan", _ARGS, device, rates.data_ptr(),
        sizes.data_ptr(), recv.data_ptr(), chan.data_ptr(), int(fading_on),
        n, n_pkts, passes, coherence_s, bandwidth_hz, overhead_s, compute_s,
        seed % _U64, n_rounds, delivered.data_ptr(), t_start.data_ptr(),
        t_comm.data_ptr(), retx.data_ptr(), t_end.data_ptr(),
        lists.data_ptr(), thr.data_ptr(), ptr(need_ws), ptr(send_ws),
        ptr(counts), ptr(exact))
    round_scan.launches += 1
    return (assemble_w(delivered, planned_w, degrade), t_start, t_comm,
            delivered, retx, t_end)


counted(round_scan, "trace_scan_kernel")

