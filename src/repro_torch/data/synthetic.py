"""Offline synthetic datasets (the port's copy of
``repro.data.synthetic``).

1. ``digits`` — an MNIST stand-in: 28x28 grey images of 10 procedural
   stroke-based digit prototypes with random shift, amplitude jitter and
   noise (:func:`make_digits`), the paper's 784-300-10 MLP's data.
2. ``tokens`` — a synthetic language-model stream with Markov structure
   (:func:`make_token_stream`, :func:`batch_tokens`).

numpy only, draw for draw the reference's code, so the port trains on the
reference's digits and batches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Digit prototypes: 7-segment-style strokes on a 28x28 canvas.
# ---------------------------------------------------------------------------

# Segments: (row0, col0, row1, col1) in a 28x28 frame.
_SEGS = {
    "top": (4, 8, 4, 20), "mid": (14, 8, 14, 20), "bot": (24, 8, 24, 20),
    "tl": (4, 8, 14, 8), "tr": (4, 20, 14, 20),
    "bl": (14, 8, 24, 8), "br": (14, 20, 24, 20),
    "diag": (4, 20, 24, 8),
}
_DIGIT_SEGS = {
    0: ["top", "bot", "tl", "tr", "bl", "br"],
    1: ["tr", "br"],
    2: ["top", "mid", "bot", "tr", "bl"],
    3: ["top", "mid", "bot", "tr", "br"],
    4: ["mid", "tl", "tr", "br"],
    5: ["top", "mid", "bot", "tl", "br"],
    6: ["top", "mid", "bot", "tl", "bl", "br"],
    7: ["top", "tr", "br", "diag"],
    8: ["top", "mid", "bot", "tl", "tr", "bl", "br"],
    9: ["top", "mid", "bot", "tl", "tr", "br"],
}


def _draw_segment(img: np.ndarray, seg: Tuple[int, int, int, int],
                  thick: float = 1.6) -> None:
    r0, c0, r1, c1 = seg
    n = 40
    rr = np.linspace(r0, r1, n)
    cc = np.linspace(c0, c1, n)
    ys, xs = np.mgrid[0:28, 0:28]
    for r, c in zip(rr, cc):
        img[:] = np.maximum(img, np.exp(-((ys - r) ** 2 + (xs - c) ** 2)
                                        / (2 * thick ** 2)))


def digit_prototypes() -> np.ndarray:
    protos = np.zeros((10, 28, 28), dtype=np.float32)
    for d, segs in _DIGIT_SEGS.items():
        for s in segs:
            _draw_segment(protos[d], _SEGS[s])
    return protos


_PROTO_CACHE: np.ndarray | None = None


def make_digits(n: int, seed: int = 0,
                noise: float = 0.25, max_shift: int = 3
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Return (images (n, 784) float32 in [0,1], labels (n,) int32)."""
    global _PROTO_CACHE
    if _PROTO_CACHE is None:
        _PROTO_CACHE = digit_prototypes()
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = _PROTO_CACHE[labels].copy()
    # Random shifts.
    sr = rng.integers(-max_shift, max_shift + 1, size=n)
    sc = rng.integers(-max_shift, max_shift + 1, size=n)
    for i in range(n):
        imgs[i] = np.roll(np.roll(imgs[i], sr[i], axis=0), sc[i], axis=1)
    # Amplitude jitter + additive noise.
    amp = rng.uniform(0.7, 1.0, size=(n, 1, 1)).astype(np.float32)
    imgs = imgs * amp + noise * rng.standard_normal(imgs.shape).astype(
        np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    return imgs.reshape(n, 784), labels


# ---------------------------------------------------------------------------
# Synthetic token stream with Markov structure.
# ---------------------------------------------------------------------------


def make_token_stream(n_tokens: int, vocab: int, seed: int = 0,
                      order_noise: float = 0.15) -> np.ndarray:
    """Markov-chain token stream: mostly-deterministic transitions.

    Cross-entropy of the true process ≈ H(order_noise) + order_noise*log(V),
    so a model that learns the table approaches a known loss floor.
    """
    rng = np.random.default_rng(seed)
    table = rng.integers(0, vocab, size=vocab)
    toks = np.empty(n_tokens, dtype=np.int32)
    toks[0] = rng.integers(0, vocab)
    noise_mask = rng.random(n_tokens) < order_noise
    randoms = rng.integers(0, vocab, size=n_tokens)
    for i in range(1, n_tokens):
        toks[i] = randoms[i] if noise_mask[i] else table[toks[i - 1]]
    return toks


def batch_tokens(stream: np.ndarray, batch: int, seq: int, step: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministically slice (inputs, targets) for a given step index."""
    span = batch * (seq + 1)
    start = (step * span) % max(1, len(stream) - span - 1)
    window = stream[start:start + span].reshape(batch, seq + 1)
    return window[:, :-1], window[:, 1:]
