"""Deterministic synthetic datasets.

* ``SyntheticFashion`` — a Fashion-MNIST-shaped surrogate (60k/10k, 10
  classes, 1x28x28) since the real set is unavailable offline (DESIGN.md §2):
  class templates are fixed random low-frequency patterns; samples =
  template + noise + random shift, so the classes are learnable but not
  trivially separable (a linear probe gets ~60-70%, a CNN >90%).
* ``token_stream`` — seeded infinite LM token batches.
* ``node_splits`` — the paper's iid equal split across n nodes (§IV-A).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticFashion", "synthetic_images", "node_splits", "token_stream"]


def _templates(rng: np.random.Generator, n_classes: int = 10) -> np.ndarray:
    """Low-frequency class templates via random 7x7 upsampled to 28x28."""
    base = rng.normal(size=(n_classes, 7, 7))
    up = np.kron(base, np.ones((4, 4)))  # nearest-neighbor 4x upsample
    return up.astype(np.float32)


def synthetic_images(n: int, seed: int, n_classes: int = 10,
                     noise: float = 0.8) -> tuple[np.ndarray, np.ndarray]:
    """(images (n,1,28,28) float32 in [0,1]-ish, labels (n,))."""
    rng = np.random.default_rng(seed)
    tmpl = _templates(np.random.default_rng(1234), n_classes)
    labels = rng.integers(0, n_classes, size=n)
    imgs = tmpl[labels]
    # per-sample random circular shift (keeps classes non-trivial)
    sx = rng.integers(-3, 4, size=n)
    sy = rng.integers(-3, 4, size=n)
    out = np.empty((n, 28, 28), np.float32)
    for i in range(n):  # cheap at our sizes; done once, cached by caller
        out[i] = np.roll(np.roll(imgs[i], sx[i], axis=0), sy[i], axis=1)
    out += rng.normal(scale=noise, size=out.shape).astype(np.float32)
    out = (out - out.mean()) / (out.std() + 1e-6)
    return out[:, None, :, :], labels.astype(np.int32)


@dataclasses.dataclass
class SyntheticFashion:
    """60k train / 10k test surrogate with the paper's shapes."""

    n_train: int = 60_000
    n_test: int = 10_000
    seed: int = 0

    def __post_init__(self):
        self.train_x, self.train_y = synthetic_images(self.n_train, self.seed)
        self.test_x, self.test_y = synthetic_images(self.n_test, self.seed + 1)


def node_splits(x: np.ndarray, y: np.ndarray, n_nodes: int,
                seed: int = 0) -> list[tuple[np.ndarray, np.ndarray]]:
    """Shuffle then split equally across nodes (paper §IV-A: iid 10k/node)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(x))
    x, y = x[order], y[order]
    per = len(x) // n_nodes
    return [(x[i * per:(i + 1) * per], y[i * per:(i + 1) * per])
            for i in range(n_nodes)]


def token_stream(batch: int, seq_len: int, vocab: int, seed: int = 0):
    """Infinite deterministic LM batches: (batch, seq_len) int32.

    A Markov-ish structured stream (mixture of repeated n-grams + noise) so
    that next-token loss is reducible below log(vocab)."""
    rng = np.random.default_rng(seed)
    ngrams = rng.integers(0, vocab, size=(64, 8))
    while True:
        out = np.empty((batch, seq_len), np.int64)
        for b in range(batch):
            toks: list[np.ndarray] = []
            total = 0
            while total < seq_len:
                if rng.random() < 0.7:
                    g = ngrams[rng.integers(0, len(ngrams))]
                else:
                    g = rng.integers(0, vocab, size=8)
                toks.append(g)
                total += len(g)
            out[b] = np.concatenate(toks)[:seq_len]
        yield out.astype(np.int32)
