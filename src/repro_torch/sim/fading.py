"""Time-varying channel: Rayleigh block fading + AR(1) log-normal shadowing.

Layers per-slot small-scale fading and temporally-correlated shadowing on top
of ``core.channel``'s log-distance path-loss mean, turning the frozen
capacity matrix into a time series ``C_ij(t)``:

    gamma_ij(t) = gamma_pl(d_ij) * |h_ij(t)|^2 * 10^(S_ij(t)/10)
    C_ij(t)     = B log2(1 + gamma_ij(t)/B)                       (Eq. 2)

* ``|h|^2 ~ Exp(1)`` — Rayleigh power gain, redrawn each coherence block,
  symmetric (reciprocal channel).
* ``S`` — shadowing in dB, Gauss-Markov AR(1) across coherence blocks with
  stationary std ``shadowing_sigma_db`` (Gudmundson-style correlation).

Block fading: time is cut into coherence blocks of ``coherence_s`` seconds;
realizations are constant within a block and drawn deterministically from
``(seed, block index)`` so any two runs (and any two nodes replaying the
trace) see the identical channel. With ``fading=None`` the channel is
exactly ``channel.capacity_matrix`` — the margin-reduced static matrix the
rate optimizer sees — which is what makes the static scenario reproduce
Eq. 3 bit-for-bit.

Two RNG schemes (``FadingParams.rng_scheme``):

* ``"chunked"`` (default) — realizations for ``block_chunk`` consecutive
  blocks are drawn in one vectorized call from an rng seeded per *chunk*,
  so a whole TDM pass costs a couple of generator constructions instead of
  two per block; the AR(1) shadowing walk advances through the chunk with
  (n, n) fused multiply-adds. Feeds the batched ``capacity_at_times`` fast
  path used by the vectorized MAC.
* ``"per_block"`` — the original one-rng-per-block scheme, retained as the
  pinned pre-vectorization generator (``benchmarks/bench_sim.py`` uses it
  as the honest "before" comparator). Realizations differ numerically from
  ``"chunked"`` but are identical in distribution.

Both schemes are deterministic: the scalar ``capacity_at`` is a one-element
slice of ``capacity_at_times``, so the per-packet and per-block-batch MAC
paths see bit-identical channels.

Note the asymmetry that creates the outage/goodput tradeoff: the *solver*
always plans on the margin-reduced mean (``mean_capacity``), while the MAC
tests transmissions against the *instantaneous* ``capacity_at``. A larger
``fading_margin_bps`` buys headroom (fewer outages) at lower rate — the
static knob of §II-B become an actual risk dial.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..core import channel

__all__ = ["FadingParams", "FadingChannel"]

_CHUNK_CACHE_MAX = 4   # chunks kept per process; sim time is monotone, so
                       # only the most recent chunk or two are ever re-hit

_TRIU_CACHE: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _triu_cached(n: int) -> tuple[np.ndarray, np.ndarray]:
    hit = _TRIU_CACHE.get(n)
    if hit is None:
        hit = _TRIU_CACHE[n] = np.triu_indices(n, 1)
    return hit


@dataclasses.dataclass(frozen=True)
class FadingParams:
    """Small-scale + shadowing process constants."""

    rayleigh: bool = True              # Exp(1) power gain per block
    shadowing_sigma_db: float = 0.0    # stationary shadowing std [dB]; 0 = off
    shadowing_corr: float = 0.9        # AR(1) coefficient between blocks
    coherence_s: float = 0.05          # block length [s]
    seed: int = 0
    rng_scheme: str = "chunked"        # "chunked" | "per_block" (legacy)
    block_chunk: int = 256             # blocks drawn per rng call (chunked)

    def __post_init__(self):
        if self.rng_scheme not in ("chunked", "per_block"):
            raise ValueError(
                f"rng_scheme must be 'chunked' or 'per_block', "
                f"got {self.rng_scheme!r}")


class FadingChannel:
    """Deterministic ``C_ij(t)`` generator over a (possibly moving) node set."""

    def __init__(self, params: channel.ChannelParams,
                 fading: Optional[FadingParams] = None):
        self.params = params
        self.fading = fading
        # chunked-scheme caches/state
        self._ray_chunks: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._innov_chunks: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._shadow_chunks: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._shadow_chunk_last: Optional[int] = None
        self._shadow_prev: Optional[np.ndarray] = None
        self._chunk_n: int = -1
        self._gamma_cache: Optional[tuple[bytes, np.ndarray]] = None
        self._static_cache: Optional[tuple[bytes, np.ndarray]] = None
        self._cap_chunks: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._ok_chunks: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._cap_chunk_key: Optional[bytes] = None
        # AR(1) shadowing state (per-block legacy scheme)
        self._shadow_block: int = -1
        self._shadow_db: Optional[np.ndarray] = None

    # -- planning view -------------------------------------------------------
    def mean_capacity(self, positions: np.ndarray) -> np.ndarray:
        """Margin-reduced path-loss capacity — the matrix Algorithm 2 plans
        on (identical to the repo's original static model)."""
        return channel.capacity_matrix(positions, self.params)

    # -- instantaneous view --------------------------------------------------
    def block_indices(self, ts: np.ndarray) -> np.ndarray:
        """Coherence-block index per timestamp (vectorized)."""
        ts = np.asarray(ts, dtype=np.float64)
        if self.fading is None:
            return np.zeros(ts.shape, dtype=np.int64)
        return np.floor(ts / self.fading.coherence_s).astype(np.int64)

    def block_index(self, t: float) -> int:
        if self.fading is None:
            return 0
        return int(np.floor(t / self.fading.coherence_s))

    def capacity_at_times(self, positions: np.ndarray,
                          ts: np.ndarray) -> np.ndarray:
        """Instantaneous capacities for a batch of timestamps -> (B, n, n).

        Path loss is computed once for the batch; fading realizations are
        produced per distinct coherence block. Timestamps must be
        non-decreasing across calls for the AR(1) shadowing walk (the sim
        clock is monotone, so every caller satisfies this for free).
        """
        ts = np.asarray(ts, dtype=np.float64)
        if self.fading is None:
            cap = self._static_capacity(positions)
            return np.broadcast_to(cap, (ts.size,) + cap.shape)
        key, gamma, n = self._gamma(positions)
        if not ts.size:
            return np.empty((0, n, n))
        blocks = self.block_indices(ts)
        if self.fading.rng_scheme == "per_block":
            ub, inv = np.unique(blocks, return_inverse=True)
            gains = self._gains_for_blocks(ub, n)
            cap = self.params.bandwidth_hz * np.log2(
                1.0 + gamma[None] * gains / self.params.bandwidth_hz)
            cap[:, np.arange(n), np.arange(n)] = np.inf
            return cap[inv]
        # chunked scheme: serve from whole-chunk capacity arrays — one
        # log2/gain materialization per ~block_chunk blocks, pure indexing
        # per call (the per-pass fast path of the vectorized MAC).
        return self._gather_chunks(
            blocks, lambda c: self._capacity_chunk(c, n, gamma, key))

    def decode_ok_at_times(self, positions: np.ndarray, ts: np.ndarray,
                           i: int, rate: float) -> np.ndarray:
        """Fused decode mask: ``capacity_at_times(ts)[:, i, :] >= rate`` as a
        (len(ts), n) bool array, served from per-(node, rate, chunk) decode
        tables so a whole TDM pass costs one gather. Bit-identical to slicing
        the batched capacities (it *is* that comparison, amortized)."""
        if self.fading is None:
            ok = self._static_capacity(positions)[i] >= rate
            return np.broadcast_to(ok, (np.asarray(ts).size,) + ok.shape)
        key, gamma, n = self._gamma(positions)
        if not np.asarray(ts).size:
            return np.empty((0, n), dtype=bool)
        blocks = self.block_indices(ts)
        if self.fading.rng_scheme == "per_block":
            return self.capacity_at_times(positions, ts)[:, i, :] >= rate
        return self._gather_chunks(
            blocks, lambda c: self._ok_chunk(c, n, gamma, key, i, rate))

    def _gather_chunks(self, blocks: np.ndarray, fetch) -> np.ndarray:
        """Gather per-block rows from whole-chunk tables: ``fetch(c)`` must
        return the (block_chunk, ...) table for chunk ``c``."""
        kk = self.fading.block_chunk
        cs = blocks // kk
        c0 = int(cs[0])
        if cs[-1] == c0:                 # common case: one chunk per pass
            return fetch(c0)[blocks - c0 * kk]
        bounds = np.concatenate(
            ([0], np.flatnonzero(np.diff(cs)) + 1, [blocks.size]))
        return np.concatenate([
            fetch(int(cs[s]))[blocks[s:e] - int(cs[s]) * kk]
            for s, e in zip(bounds[:-1], bounds[1:])])

    def _check_gamma_key(self, gamma_key: bytes) -> None:
        """Placement changed => every derived capacity/decode table is stale."""
        if self._cap_chunk_key != gamma_key:
            self._cap_chunks.clear()
            self._ok_chunks.clear()
            self._cap_chunk_key = gamma_key

    def _check_n(self, n: int) -> None:
        """Churn resized the node set => restart every realization stream."""
        if n != self._chunk_n:
            self._ray_chunks.clear()
            self._innov_chunks.clear()
            self._restart_shadow()
            self._chunk_n = n

    def _restart_shadow(self) -> None:
        """Restarting the AR(1) stream invalidates every capacity/decode
        table derived from the old stream along with the shadow chunks."""
        self._shadow_chunks.clear()
        self._shadow_chunk_last = None
        self._cap_chunks.clear()
        self._ok_chunks.clear()

    def _ok_chunk(self, c: int, n: int, gamma: np.ndarray, gamma_key: bytes,
                  i: int, rate: float) -> np.ndarray:
        """(K, n) decode table for transmitter ``i`` at ``rate`` over one
        chunk of blocks, cached alongside the capacity chunks."""
        self._check_gamma_key(gamma_key)
        ck = (c, i, float(rate))
        hit = self._ok_chunks.get(ck)
        if hit is not None:
            return hit
        ok = self._capacity_chunk(c, n, gamma, gamma_key)[:, i, :] >= rate
        self._ok_chunks[ck] = ok
        while len(self._ok_chunks) > 4 * _CHUNK_CACHE_MAX:
            self._ok_chunks.popitem(last=False)
        return ok

    def _gamma(self, positions: np.ndarray) -> tuple[bytes, np.ndarray, int]:
        """Mean linear SNR for the current placement, cached per positions
        (frozen for a whole round by the simulator)."""
        key = positions.tobytes()
        if self._gamma_cache is not None and self._gamma_cache[0] == key:
            gamma = self._gamma_cache[1]
        else:
            d = channel.pairwise_distances(positions)
            gamma = channel.snr_linear(np.where(d > 0, d, 1.0), self.params)
            self._gamma_cache = (key, gamma)
        return key, gamma, gamma.shape[0]

    def _static_capacity(self, positions: np.ndarray) -> np.ndarray:
        """Fading-off capacity matrix, cached per placement (treat as
        read-only; ``mean_capacity`` stays a fresh copy for callers that
        keep or modify the planning matrix)."""
        key = positions.tobytes()
        if self._static_cache is not None and self._static_cache[0] == key:
            return self._static_cache[1]
        cap = channel.capacity_matrix(positions, self.params)
        self._static_cache = (key, cap)
        return cap

    def _capacity_chunk(self, c: int, n: int, gamma: np.ndarray,
                        gamma_key: bytes) -> np.ndarray:
        """Instantaneous capacities for the whole chunk of blocks -> (K, n, n),
        cached per (chunk, placement)."""
        self._check_gamma_key(gamma_key)
        hit = self._cap_chunks.get(c)
        if hit is not None:
            return hit
        gains = self._gains_chunk(c, n)
        cap = self.params.bandwidth_hz * np.log2(
            1.0 + gamma[None] * gains / self.params.bandwidth_hz)
        cap[:, np.arange(n), np.arange(n)] = np.inf
        self._cap_chunks[c] = cap
        while len(self._cap_chunks) > _CHUNK_CACHE_MAX:
            self._cap_chunks.popitem(last=False)
        return cap

    def _gains_chunk(self, c: int, n: int) -> np.ndarray:
        """Linear power gains for the whole chunk of blocks -> (K, n, n)."""
        f = self.fading
        self._check_n(n)
        gains = np.ones((f.block_chunk, n, n))
        if f.rayleigh:
            gains = gains * self._chunk(self._ray_chunks, 0, c, n,
                                        "exponential")
        if f.shadowing_sigma_db > 0.0:
            gains *= 10.0 ** (self._shadow_chunk_get(c, n) / 10.0)
        return gains

    def capacity_at(self, positions: np.ndarray, t: float) -> np.ndarray:
        """Instantaneous (n, n) capacity at simulated time ``t``.

        Without fading this is exactly the static planning matrix; with
        fading the *raw* (un-margined) path-loss mean is modulated by the
        block realizations — the margin lives in the plan, the fades live
        here.
        """
        if self.fading is None:
            return channel.capacity_matrix(positions, self.params)
        return self.capacity_at_times(
            positions, np.asarray([t], dtype=np.float64))[0]

    # -- block realizations --------------------------------------------------
    def _gains_for_blocks(self, ub: np.ndarray, n: int) -> np.ndarray:
        """Symmetric (U, n, n) linear power gains for sorted unique blocks."""
        f = self.fading
        assert f is not None
        self._check_n(n)
        gains = np.ones((ub.size, n, n))
        if f.rayleigh:
            gains *= self._rayleigh_for_blocks(ub, n)
        if f.shadowing_sigma_db > 0.0:
            gains *= 10.0 ** (self._shadow_for_blocks(ub, n) / 10.0)
        return gains

    @staticmethod
    def _symmetrize(a: np.ndarray, n: int) -> np.ndarray:
        iu = _triu_cached(n)
        a[..., iu[1], iu[0]] = a[..., iu[0], iu[1]]  # reciprocal channel
        return a

    def _chunk(self, cache: "OrderedDict[int, np.ndarray]", stream: int,
               c: int, n: int, draw: str) -> np.ndarray:
        """One chunk of per-block realizations, (block_chunk, n, n)."""
        hit = cache.get(c)
        if hit is not None:
            cache.move_to_end(c)
            return hit
        f = self.fading
        # c+1 keeps the third entropy word nonzero: SeedSequence drops
        # trailing zeros, which would alias chunk 0 onto the legacy
        # per-block streams (seed, 2b) / (seed, 2b+1).
        rng = np.random.default_rng((f.seed, stream, c + 1))
        if draw == "exponential":
            a = rng.exponential(1.0, size=(f.block_chunk, n, n))
        else:
            a = rng.normal(0.0, 1.0, size=(f.block_chunk, n, n))
        a = self._symmetrize(a, n)
        if draw == "normal":
            a[:, np.arange(n), np.arange(n)] = 0.0
        cache[c] = a
        while len(cache) > _CHUNK_CACHE_MAX:
            cache.popitem(last=False)
        return a

    def _rayleigh_for_blocks(self, ub: np.ndarray, n: int) -> np.ndarray:
        f = self.fading
        if f.rng_scheme == "per_block":
            out = np.empty((ub.size, n, n))
            for k, b in enumerate(ub):
                rng = np.random.default_rng((f.seed, 2 * int(b)))
                out[k] = self._symmetrize(
                    rng.exponential(1.0, size=(n, n)), n)
            return out
        k = f.block_chunk
        out = np.empty((ub.size, n, n))
        for c in np.unique(ub // k):
            chunk = self._chunk(self._ray_chunks, 0, int(c), n, "exponential")
            sel = (ub // k) == c
            out[sel] = chunk[ub[sel] - c * k]
        return out

    def _shadow_chunk(self, c: int, n: int, restart: bool) -> np.ndarray:
        """AR(1) shadowing [dB] for the whole chunk of blocks
        [c*K, (c+1)*K), computed in one vectorized pass.

        ``restart=False`` continues from the cached terminal state of chunk
        ``c - 1``:  S_{cK+m} = corr^{m+1} S_prev + scale * sum_j corr^{m-j} z_j.
        ``restart=True`` starts the process at stationarity on the chunk's
        first block. Always chunk-granular, so the values are independent of
        how callers batch their (monotone) queries — the per-packet and
        per-pass MAC paths see bit-identical shadowing.
        """
        f = self.fading
        kk = f.block_chunk
        sigma, corr = f.shadowing_sigma_db, f.shadowing_corr
        scale = sigma * np.sqrt(1 - corr**2)
        z = self._chunk(self._innov_chunks, 1, c, n, "normal")
        out = np.empty((kk, n, n))
        if corr <= 1e-3 or (kk - 1) * np.log10(1.0 / corr) > 280.0:
            # corr^-j would overflow float64 across the chunk — with corr
            # this small the process is (nearly) white anyway; walk the
            # recurrence directly.
            s = sigma * z[0] if restart else corr * self._shadow_prev + scale * z[0]
            out[0] = s
            for m in range(1, kk):
                s = corr * s + scale * z[m]
                out[m] = s
        elif restart:
            out[0] = sigma * z[0]
            powers = corr ** np.arange(1, kk)
            inv = corr ** -np.arange(1, kk, dtype=np.float64)
            csum = np.cumsum(z[1:] * inv[:, None, None], axis=0)
            out[1:] = powers[:, None, None] * (out[0] + scale * csum)
        else:
            powers = corr ** np.arange(1, kk + 1)       # corr^{m+1}
            mpow = corr ** np.arange(kk)                # corr^{m}
            inv = corr ** -np.arange(kk, dtype=np.float64)
            csum = np.cumsum(z * inv[:, None, None], axis=0)
            out = (powers[:, None, None] * self._shadow_prev
                   + scale * mpow[:, None, None] * csum)
        self._shadow_prev = out[-1]
        self._shadow_chunk_last = c
        self._shadow_chunks[c] = out
        while len(self._shadow_chunks) > _CHUNK_CACHE_MAX:
            self._shadow_chunks.popitem(last=False)
        return out

    def _shadow_chunk_get(self, c: int, n: int) -> np.ndarray:
        """Shadowing chunk ``c``, materializing every chunk up to it in
        ascending order (blocks are monotone because the sim clock is); a
        backward jump past the cache window restarts the process at
        stationarity (mirroring the legacy scheme's restart-on-rewind)."""
        if (self._shadow_chunk_last is not None
                and c <= self._shadow_chunk_last
                and c not in self._shadow_chunks):
            self._restart_shadow()
        hit = self._shadow_chunks.get(c)
        if hit is not None:
            return hit
        if self._shadow_chunk_last is None:
            return self._shadow_chunk(c, n, restart=True)
        for cc in range(self._shadow_chunk_last + 1, c + 1):
            self._shadow_chunk(cc, n, restart=False)
        return self._shadow_chunks[c]

    def _shadow_for_blocks(self, ub: np.ndarray, n: int) -> np.ndarray:
        """AR(1) shadowing [dB] for sorted unique blocks (per-block legacy
        walk, or gathered from the chunk cache)."""
        f = self.fading
        if f.rng_scheme == "per_block":
            return np.stack([self._shadow(int(b), n) for b in ub])
        kk = f.block_chunk
        cs = ub // kk
        out = np.empty((ub.size, n, n))
        for c in np.unique(cs):
            c = int(c)
            chunk = self._shadow_chunk_get(c, n)
            sel = cs == c
            out[sel] = chunk[ub[sel] - c * kk]
        return out

    def _shadow(self, block: int, n: int) -> np.ndarray:
        """Legacy per-block AR(1) shadowing [dB] (``rng_scheme="per_block"``),
        advanced sequentially one rng per block."""
        f = self.fading
        assert f is not None

        def draw(b: int, scale: float) -> np.ndarray:
            rng = np.random.default_rng((f.seed, 2 * b + 1))
            s = rng.normal(0.0, scale, size=(n, n))
            s = self._symmetrize(s, n)
            np.fill_diagonal(s, 0.0)
            return s

        if (self._shadow_db is None or self._shadow_db.shape[0] != n
                or block < self._shadow_block):
            self._shadow_block = block
            self._shadow_db = draw(block, f.shadowing_sigma_db)
        while self._shadow_block < block:
            self._shadow_block += 1
            innov = draw(self._shadow_block,
                         f.shadowing_sigma_db * np.sqrt(1 - f.shadowing_corr**2))
            self._shadow_db = f.shadowing_corr * self._shadow_db + innov
        return self._shadow_db
