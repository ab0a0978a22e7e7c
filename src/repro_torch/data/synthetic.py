"""Synthetic token stream with Markov structure (the port's copy of
``repro.data.synthetic.make_token_stream`` / ``batch_tokens``).

numpy only, draw for draw the reference's code, so the port trains on the
reference's batches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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
